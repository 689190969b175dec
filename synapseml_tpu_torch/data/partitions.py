"""Executor partition-iterator protocol — the Spark/Arrow data-plane seam.

Counterpart of ``synapseml_tpu/data/partitions.py``. The reference's
training topology is ``df.rdd.barrier().mapPartitions``: each Spark
executor task streams its partition's rows into the native dataset, then
every task fits as one ring
(ref: lightgbm/src/main/scala/com/microsoft/ml/spark/lightgbm/LightGBMBase.scala:482-486,
DatasetAggregator.scala:69-180 for the per-task chunked ingest). An
executor task (a pyspark ``mapPartitions`` closure co-located on a GPU
host, a Ray actor, or a plain process, one a card) drives

    agg = PartitionAggregator(feature_cols=[...], label_col="y")
    for batch in partition_iter:          # pyarrow RecordBatch / Table,
        agg.add(batch)                    # pandas DataFrame, dict, Table
    booster = fit_partitions(params, [agg.batches...]) # or fit_aggregated

Batch types are told apart by duck typing: neither pandas nor pyarrow is
imported here, and a machine without them streams dicts and Tables.

Per-process aggregation builds ONE contiguous feature matrix (so the
host->device copy is a single placement, not a row loop); multi-process
jobs join the process group via :mod:`synapseml_tpu_torch.parallel.
distributed` (``rendezvous=...`` or ambient ``SYNAPSEML_*`` env). By
default a multi-process fit is ROW-SHARDED: each rank bins its own rows
locally and only a capped bin-boundary sample plus per-split histograms
cross the network (the reference's ``tree_learner=data_parallel``
property — rows never leave their partition). ``row_sharded=False``
keeps the gather fallback for small data.
"""
from __future__ import annotations

import time
from typing import Any, Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np

from synapseml_tpu_torch import device as device_policy
from synapseml_tpu_torch.data.table import Table
from synapseml_tpu_torch.gbdt import boosting
from synapseml_tpu_torch.parallel import distributed


def _as_table(batch: Any) -> Table:
    """Normalize one record batch to a Table (whose constructor validates
    equal column lengths) — one normalization path, shared with the rest
    of the data plane."""
    if isinstance(batch, Table):
        return batch
    if isinstance(batch, dict):
        return Table(batch)
    if getattr(batch, "column_names", None) is not None:
        return Table.from_arrow(batch)  # pyarrow RecordBatch / Table
    if getattr(batch, "columns", None) is not None:
        return Table.from_pandas(batch)  # pandas DataFrame
    raise TypeError(
        f"unsupported record-batch type {type(batch).__name__}: expected "
        "pyarrow RecordBatch/Table, pandas DataFrame, Table, or dict")


class PartitionAggregator:
    """Streams an executor's record batches into contiguous columns.

    The chunked-then-coalesced ingest the reference does natively
    (DatasetAggregator's chunked arrays): ``add`` appends cheap references;
    ``to_arrays`` concatenates ONCE into the (x, y, weight) the trainer
    wants — no per-row marshalling.
    """

    def __init__(self, feature_cols: Sequence[str],
                 label_col: str = "label",
                 weight_col: Optional[str] = None,
                 group_col: Optional[str] = None):
        """``group_col``: ranking query-group ids (LightGBMRanker's
        groupCol) — rows of one group must arrive in one executor's
        stream, as in the reference's group-aligned partitioning."""
        self.feature_cols = list(feature_cols)
        self.label_col = label_col
        self.weight_col = weight_col
        self.group_col = group_col
        self._chunks: List[Dict[str, np.ndarray]] = []
        self.num_rows = 0

    def _needed(self) -> List[str]:
        need = self.feature_cols + [self.label_col]
        if self.weight_col is not None:
            need.append(self.weight_col)
        if self.group_col is not None:
            need.append(self.group_col)
        return need

    def _concat_col(self, col: str, dtype) -> np.ndarray:
        if not self._chunks:
            return np.zeros(0, dtype)
        return np.concatenate([np.asarray(c[col], dtype)
                               for c in self._chunks])

    def group_array(self) -> Optional[np.ndarray]:
        """Query-group ids at their native integer width — a float64
        round trip would merge distinct ids above 2**53."""
        if self.group_col is None:
            return None
        return self._concat_col(self.group_col, np.int64)

    def add(self, batch: Any) -> "PartitionAggregator":
        t = _as_table(batch)  # Table validates equal column lengths
        missing = [c for c in self._needed() if c not in t]
        if missing:
            raise KeyError(f"record batch lacks columns {missing} "
                           f"(has: {sorted(t.columns)})")
        # keep ONLY the columns the fit reads: a wide partition must not
        # pin its unused columns in executor memory until to_arrays
        self._chunks.append({c: t[c] for c in self._needed()})
        self.num_rows += t.num_rows
        return self

    def to_arrays(self) -> Tuple[np.ndarray, np.ndarray,
                                 Optional[np.ndarray]]:
        """Concatenate once into (x, y, weight). An executor with no rows
        (empty Spark partitions are routine) yields (0, F)-shaped arrays
        so a multi-process job's other ranks aren't left hanging in the
        gather collective."""
        f = len(self.feature_cols)
        if not self._chunks:
            return (np.zeros((0, f)), np.zeros(0),
                    np.zeros(0) if self.weight_col is not None else None)
        x = np.concatenate([
            np.column_stack([np.asarray(c[fc], np.float64)
                             for fc in self.feature_cols])
            for c in self._chunks]) if f else np.zeros((self.num_rows, 0))
        y = self._concat_col(self.label_col, np.float64)
        w = None
        if self.weight_col is not None:
            w = self._concat_col(self.weight_col, np.float64)
        return x, y, w


def _join(rendezvous: Optional[Dict[str, Any]], device: str) -> None:
    """Join the job's process group: through the driver rendezvous where
    ``rendezvous`` is given, else from the ambient ``SYNAPSEML_*`` env."""
    if rendezvous is None:
        distributed.initialize(device=device)
        return
    local = rendezvous.get("local_device")
    distributed.rendezvous_and_initialize(
        rendezvous["driver_host"], int(rendezvous["driver_port"]),
        my_host=rendezvous.get("my_host"),
        rank_hint=int(rendezvous.get("rank_hint", -1)),
        coordinator_port=int(rendezvous.get("coordinator_port", 26570)),
        backend=rendezvous.get("backend"),
        local_device_ids=None if local is None else [int(local)],
        device=device)


def fit_aggregated(params, agg: PartitionAggregator, mesh=None,
                   rendezvous: Optional[Dict[str, Any]] = None,
                   row_sharded: Any = "auto",
                   stats_out: Optional[Dict[str, Any]] = None,
                   **train_kw):
    """Fit this process's aggregated rows, joining a multi-process group
    first. ``train_kw`` goes to the trainer; its ``device`` defaults to
    the card (``"cuda"``), and the CPU is taken only with
    ``device="cpu"``.

    ``rendezvous``: ``{"driver_host":..., "driver_port":..., "my_host":...,
    "rank_hint":..., "coordinator_port":..., "backend":...,
    "local_device":...}`` wires the process into the driver rendezvous and
    a ``torch.distributed`` group (parallel/distributed.py) — the
    replacement of the reference's NetworkInit TCP ring. ``backend``
    defaults to NCCL on the card; ranks that share one card pass
    ``"gloo"``. Without it, the ambient ``SYNAPSEML_*`` env (if any) is
    used.

    ``row_sharded``: ``"auto"`` (default) — multi-process jobs keep every
    rank's rows local and exchange only a capped bin sample plus
    per-split histograms (:func:`~synapseml_tpu_torch.gbdt.boosting.
    train_row_sharded` — the reference's ``tree_learner=data_parallel``
    scaling property, rows never leave their partition). ``False`` forces
    the gather fallback: every rank's rows cross the network once and
    replicate on every rank — O(total rows) per-rank memory, only
    sensible for small data. ``True`` forces row-sharded even
    single-process (a world of one rank).

    ``stats_out`` gets the route taken (``path``: ``"row_sharded"``,
    ``"gather"`` or ``"single_process"``), the row counts, and the host
    seconds of the join (``rendezvous_s``) and of the concatenation
    (``aggregate_s``).
    """
    device = train_kw.setdefault("device", device_policy.DEFAULT_DEVICE)
    device_policy.resolve(device)   # no card: raise before the peers wait
    start = time.perf_counter()
    _join(rendezvous, device)
    rendezvous_s = time.perf_counter() - start

    # validate the group forms BEFORE the O(n) concat (and before peers
    # start waiting on this rank's collectives)
    direct_group = train_kw.pop("group", None)
    if direct_group is not None and agg.group_col is not None:
        raise TypeError(
            "pass query groups either via group_col (streamed with "
            "the batches) or via group=, not both")
    start = time.perf_counter()
    x, y, w = agg.to_arrays()
    group = agg.group_array()
    aggregate_s = time.perf_counter() - start
    if direct_group is not None:
        group = np.asarray(direct_group)
        if group.shape[0] != x.shape[0]:
            # a short array would silently mis-pair tail rows after the
            # multi-process padding round trip — fail loudly instead
            raise ValueError(
                f"group length {group.shape[0]} != row count {x.shape[0]}")
    if stats_out is not None:
        stats_out.update(rendezvous_s=rendezvous_s, aggregate_s=aggregate_s)
    multi = distributed.process_count() > 1
    use_rs = row_sharded is True or (row_sharded == "auto" and multi)
    if use_rs and row_sharded == "auto":
        # a mesh the row-sharded layout can't honor keeps the gather path;
        # row_sharded=True lets train_row_sharded raise the precise error
        use_rs = boosting.row_sharded_mesh_ok(mesh)
    if use_rs:
        return boosting.train_row_sharded(
            params, x, y, weight=w, group=group, mesh=mesh,
            stats_out=stats_out, **train_kw)
    if stats_out is not None:
        # every routing outcome reports where it went and what it held,
        # so a caller asserting the accounting never reads an empty dict
        stats_out.update(path="gather" if multi else "single_process",
                         n_local=int(x.shape[0]))
    if multi:
        # gather fallback: every rank materializes the global dataset
        # (per-rank memory O(total rows) — small data only)
        gather = distributed.host_allgather_rows
        x = gather(np.asarray(x, np.float64))
        y = gather(np.asarray(y, np.float64))
        if w is not None:
            w = gather(np.asarray(w, np.float64))
        if group is not None:
            # ranks commonly number queries locally (0..N each), so raw
            # ids would collide across ranks and lambdarank would pair
            # rows of unrelated queries: relabel into disjoint per-rank
            # ranges first (groups must not SPAN ranks — same contract
            # as the reference's group-aligned partitioning). Applies to
            # both the group_col stream and a direct group= array.
            uniq, inv = np.unique(group, return_inverse=True)
            counts = gather(np.asarray([len(uniq)], np.int64))
            offset = int(counts[:distributed.process_index()].sum())
            group = gather((inv + offset).astype(np.int64))
        if mesh is None:
            mesh = distributed.global_mesh()
    if x.shape[0] == 0:
        raise ValueError("no rows to fit: every partition stream was empty")
    return boosting.train(params, x, y, weight=w, group=group, mesh=mesh,
                          **train_kw)


def fit_partitions(params, partitions: Iterable[Any],
                   feature_cols: Sequence[str], label_col: str = "label",
                   weight_col: Optional[str] = None,
                   group_col: Optional[str] = None, mesh=None,
                   rendezvous: Optional[Dict[str, Any]] = None,
                   row_sharded: Any = "auto",
                   stats_out: Optional[Dict[str, Any]] = None,
                   **train_kw):
    """One-call form: stream ``partitions`` (an iterator of record
    batches — THIS executor's partitions) through a
    :class:`PartitionAggregator` and fit. See :func:`fit_aggregated`;
    ``aggregate_s`` in ``stats_out`` includes the streaming."""
    start = time.perf_counter()
    agg = PartitionAggregator(feature_cols, label_col, weight_col,
                              group_col)
    for batch in partitions:
        agg.add(batch)
    stream_s = time.perf_counter() - start
    booster = fit_aggregated(params, agg, mesh=mesh, rendezvous=rendezvous,
                             row_sharded=row_sharded, stats_out=stats_out,
                             **train_kw)
    if stats_out is not None:
        stats_out["aggregate_s"] += stream_s
    return booster

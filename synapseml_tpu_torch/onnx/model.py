"""ONNXModel transformer: batched inference over an imported ONNX graph.

The counterpart of the reference package's ``onnx/model.py`` (itself the
rebuild of SynapseML's ONNXModel, ref: deep-learning/src/main/scala/com/
microsoft/ml/spark/onnx/ONNXModel.scala:422-684). The graph is lowered once
to torch ops (:mod:`synapseml_tpu_torch.onnx.importer`), bound to the device
once (``ImportedGraph.bind``: weights cast and moved, BatchNorm folded) and
run through the :class:`~synapseml_tpu_torch.runtime.executor.BatchedExecutor`
— bucketed batches staged in pinned memory, one host-to-card copy a batch on
the executor's own stream, optional bf16 compute. Softmax/argmax
post-processing columns mirror the reference (:519-562), and feed/fetch
dicts mirror ``setFeedDict``/``setFetchDict``.

:meth:`ONNXModel.warmup` captures every mini-batch bucket's forward as a
CUDA graph before traffic (``BatchedExecutor.warmup``); with
``compile_cache_dir`` each bucket's record is kept in the executable store
under a content hash of the model bytes and config, so a changed model
misses (runtime/compile_cache.py).

``devices`` runs each mini-batch bucket data-parallel over a device list
(the executor's shard and round-robin layouts); the executor binds the
weights once a distinct device of the list.

Two measured lanes (runtime/autotune.py): ``compute_dtype="auto"``
resolves to the ``onnx_compute_dtype`` lane's float32-vs-bfloat16 verdict
for the model's content and batch bucket (:func:`routed_compute_dtype`),
and :meth:`ONNXModel.preferred_wire` is the ``onnx_hostfeed_wire`` lane's
verdict on which side of the host-to-card copy dequantizes uint8 pixels.

Not ported yet, each under its ROADMAP Queue 1 item:
``tensor_parallel``/``partition_rules`` and ``partition_coverage`` (4),
``decode_scheduler`` (3). Setting one of those Params raises
``NotImplementedError`` when the model runs; none runs quietly on one
device.
"""
from __future__ import annotations

import os
import threading
from collections import deque
from typing import Any, Dict, Iterable, Iterator, List, Optional

import numpy as np
import torch

from synapseml_tpu_torch import device as device_policy
from synapseml_tpu_torch.core.param import ComplexParam, Param
from synapseml_tpu_torch.core.pipeline import Transformer
from synapseml_tpu_torch.data.table import Table
from synapseml_tpu_torch.onnx import proto as _proto
from synapseml_tpu_torch.onnx.importer import ImportedGraph, import_model
from synapseml_tpu_torch.runtime import autotune
from synapseml_tpu_torch.runtime import compile_cache as _cc
from synapseml_tpu_torch.runtime.executor import (BatchedExecutor,
                                                  PerDevice,
                                                  resolve_devices)

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
           "float16": torch.float16}


# -- autotuned lanes ------------------------------------------------------
#
# Lane "onnx_compute_dtype": compute_dtype="auto" resolves to a MEASURED
# float32-vs-bfloat16 verdict per (model content, batch bucket, device).
# Params are cast once at executor build (never per batch); the bf16
# candidate casts floating inputs on the device inside the timed call so
# the verdict prices the full formulation, and the float32 candidate runs
# in IEEE float32 (every graph run is inside importer._ieee_float32).
# Verification is reference-relative: 5% of the float32 output's largest
# |value| absorbs bf16 rounding drift through a deep stack while still
# failing a broken cast.

def _dtype_probe_args(g, token, batch, dev):
    rng = np.random.default_rng(0)
    bp = max(1, min(int(batch), 8))
    args = []
    for name in g.input_names:
        want, shape = g.input_info.get(name, (None, None))
        row = list(shape)[1:] if shape is not None else None
        if row is None or any(not isinstance(d, int) or d <= 0
                              for d in row):
            # crash semantics: dynamic inputs fall back to the float32
            # reference, memoized in-process only
            raise ValueError(
                f"graph input {name!r} has dynamic non-batch dims {shape}")
        dt = np.dtype(want) if want is not None else np.dtype(np.float32)
        if np.issubdtype(dt, np.floating):
            a = rng.standard_normal((bp, *row)).astype(dt)
        else:
            a = rng.integers(0, 2, (bp, *row)).astype(dt)
        args.append(torch.from_numpy(a).to(dev))
    return tuple(args)


def _dtype_candidate(cast):
    def make(rargs, args):
        g, dev = rargs[0], rargs[3]
        fn = g.bind(cast_dtype=cast, device=dev)
        if cast is None:
            return autotune.aot(fn, *args)

        def run(*a):
            return fn(*[x.to(cast) if x.is_floating_point() else x
                        for x in a])
        return autotune.aot(run, *args)
    return make


def _dtype_verify(got, want):
    gs = got if isinstance(got, tuple) else (got,)
    ws = want if isinstance(want, tuple) else (want,)
    if len(gs) != len(ws):
        return False
    for g_, w_ in zip(gs, ws):
        if tuple(g_.shape) != tuple(w_.shape):
            return False
        if np.issubdtype(np.asarray(w_).dtype, np.floating):
            g64 = np.asarray(g_, np.float64)
            w64 = np.asarray(w_, np.float64)
            if not w64.size:
                continue
            span = max(1e-6, float(np.max(np.abs(w64))))
            if float(np.max(np.abs(g64 - w64))) > 0.05 * span:
                return False
        elif not np.array_equal(np.asarray(g_), np.asarray(w_)):
            return False
    return True


_DTYPE_LANE = autotune.register_lane(
    "onnx_compute_dtype",
    key_fn=lambda g, token, batch, dev: (
        autotune.key_prefix("onnx_dtype", dev)
        + f"|{token}|b{autotune.pow2(int(batch), 1, 4096)}"),
    candidates={"float32": _dtype_candidate(None),
                "bfloat16": _dtype_candidate(torch.bfloat16)},
    verify_fn=_dtype_verify,
    reference="float32",
    args_fn=_dtype_probe_args,
    groups=("resnet50", "resnet50_fast"),
)


def routed_compute_dtype(graph, payload, batch: int,
                         device=device_policy.DEFAULT_DEVICE) -> str:
    """Measured compute-dtype verdict ("float32" | "bfloat16") for this
    graph at this batch bucket on ``device`` — what
    ``compute_dtype="auto"`` resolves to. Persisted like every lane
    verdict."""
    token = _cc.content_hash(payload or b"", len(graph._nodes),
                             tuple(graph.output_names))[:12]
    return _DTYPE_LANE.route(graph, token, int(batch),
                             device_policy.resolve(device))


# Lane "onnx_hostfeed_wire": which side of the host-to-card copy
# dequantizes uint8 pixels. The uint8 wire (1 byte a pixel + the on-card
# (x - mean) * scale) is the reference; the float wire (host dequant, the
# compute dtype over the wire) can win where the copy is not the
# bottleneck. Candidates move REAL bytes: the uint8 leg copies the pinned
# uint8 rows to the card and dequantizes there, the float leg dequantizes
# on the host and copies the compute dtype; both legs' results stay on
# the card (best_of waits for them there).

def _wire_uint8(rargs, args):
    mean, scale, _row, _b, compute, dev = rargs
    tgt = _DTYPES[compute]
    m = torch.as_tensor(mean, device=dev).to(tgt)
    s = torch.as_tensor(scale, device=dev).to(tgt)

    def run(u8):
        return (u8.to(dev, non_blocking=True).to(tgt) - m) * s
    return autotune.aot(run, *args)


def _wire_float(rargs, args):
    mean, scale, _row, _b, compute, dev = rargs
    tgt = _DTYPES[compute]

    def run(u8):
        v = (u8.numpy().astype(np.float32) - mean) * scale
        return torch.from_numpy(v).to(tgt).to(dev)
    return autotune.aot(run, *args)


def _wire_verify(got, want):
    g64 = np.asarray(got, np.float64)
    w64 = np.asarray(want, np.float64)
    if g64.shape != w64.shape:
        return False
    span = max(1e-6, float(np.max(np.abs(w64))))
    return float(np.max(np.abs(g64 - w64))) <= 0.02 * span


def _wire_key(mean, scale, row, b, compute, dev):
    import hashlib
    tok = hashlib.sha1(np.asarray(mean, np.float32).tobytes()
                       + np.asarray(scale, np.float32).tobytes()
                       ).hexdigest()[:8]
    return (autotune.key_prefix("onnx_wire", dev)
            + f"|{tok}|r{'x'.join(str(d) for d in row)}"
            + f"|b{autotune.pow2(int(b), 1, 4096)}|{compute}")


def _wire_args(mean, scale, row, b, compute, dev):
    u8 = torch.from_numpy(np.random.default_rng(0).integers(
        0, 256, (max(1, min(int(b), 32)), *row), dtype=np.uint8))
    return (u8.pin_memory() if dev.type == "cuda" else u8,)


_WIRE_LANE = autotune.register_lane(
    "onnx_hostfeed_wire",
    key_fn=_wire_key,
    candidates={"uint8": _wire_uint8, "float": _wire_float},
    verify_fn=_wire_verify,
    reference="uint8",
    args_fn=_wire_args,
    groups=("resnet50", "resnet50_fast"),
)


def _is_float(dtype) -> bool:
    """A graph input's declared dtype is floating (bfloat16 included)."""
    if dtype is None:
        return False
    dtype = np.dtype(dtype)
    return dtype.name == "bfloat16" or np.issubdtype(dtype, np.floating)


def _host_column(value) -> np.ndarray:
    """An executor output as a column: floats as float32 numpy (a bfloat16
    leaf comes back as a CPU tensor, numpy having no bfloat16)."""
    if isinstance(value, torch.Tensor):
        value = value.detach().cpu()
        return (value.float() if value.is_floating_point() else value).numpy()
    value = np.asarray(value)
    return value.astype(np.float32) if np.issubdtype(
        value.dtype, np.floating) else value


class ONNXModel(Transformer):
    """Runs a (user-supplied) ONNX graph as a pipeline transformer.

    Parameters mirror the reference's surface: ``model_payload`` (the raw
    ``.onnx`` bytes), ``feed_dict`` mapping graph input name -> table column,
    ``fetch_dict`` mapping output column -> graph output name, minibatch size,
    and optional ``softmax_output_col`` / ``argmax_output_col`` post-columns.
    ``transform(table, device="cuda")`` runs on the card and raises without
    CUDA; ``device="cpu"`` runs the same path on the CPU.
    """

    model_payload = ComplexParam("raw .onnx protobuf bytes")
    feed_dict = Param("graph input name -> input column", default=None)
    fetch_dict = Param("output column -> graph output name", default=None)
    mini_batch_size = Param("max rows per device batch", default=128)
    compute_dtype = Param(
        "device compute dtype: float32|bfloat16|float16, or 'auto' for "
        "the autotuner's measured f32-vs-bf16 verdict (routed per model "
        "content + batch bucket + device, persisted — runtime/autotune.py "
        "lane 'onnx_compute_dtype')",
        default="float32")
    softmax_output_col = Param("column for softmax of first output", default=None)
    argmax_output_col = Param("column for argmax of first output", default=None)
    input_norm = Param(
        "graph input name -> {'mean':..., 'scale':...} applied ON DEVICE "
        "after casting an integer feed to the compute dtype: the wire "
        "carries uint8 pixels (1 byte/px vs 2 for bf16) and the fused "
        "(x - mean) * scale runs on the card", default=None)
    devices = Param(
        "data-parallel device spec: None (one device), 'all', an int N "
        "(the first N CUDA devices) or a device sequence, which may repeat "
        "a device (each entry is a slot) — each mini-batch bucket is "
        "sharded over the slots, or run whole on the next one, by the "
        "executor (runtime/executor.py)", default=None)
    tensor_parallel = Param(
        "tensor-parallel ways of the reference; only 1 is ported",
        default=1)
    partition_rules = Param(
        "the reference's per-model partition-rule overrides for "
        "tensor_parallel > 1; not ported", default=None)
    compile_cache_dir = Param(
        "directory of the executable store warmup() records each bucket's "
        "warm program in (default: the SYNAPSEML_COMPILE_CACHE env var)",
        default=None)

    def __init__(self, model_path: Optional[str] = None,
                 model_bytes: Optional[bytes] = None, **kw):
        super().__init__(**kw)
        if model_path is not None:
            # keep the user's bytes verbatim (re-encoding through the
            # mini-schema would drop fields it doesn't model, e.g.
            # metadata_props) — re-encode ONLY when external-data
            # sidecars had to be inlined to make the payload
            # self-contained for transformer save/load
            with open(model_path, "rb") as fh:
                raw = fh.read()
            model = _proto.decode("ModelProto", raw)
            if model.graph is not None and _proto.resolve_external_data(
                    model, os.path.dirname(os.path.abspath(model_path))) > 0:
                model_bytes = _proto.encode(model)
            else:
                model_bytes = raw
        if model_bytes is not None:
            self.set(model_payload=bytes(model_bytes))
        self._graph_cache = None
        self._executor_cache: Dict[Any, BatchedExecutor] = {}

    # -- graph access ---------------------------------------------------
    @property
    def graph(self) -> ImportedGraph:
        payload = self.model_payload
        if payload is None:
            raise ValueError("ONNXModel has no model_payload set")
        cache = self.__dict__.get("_graph_cache")
        # payload identity via `is` with the object retained in the cache
        # tuple: set(model_payload=...) must not keep serving the previous
        # graph, and holding the reference rules out CPython id reuse
        if cache is not None and cache[0] is payload:
            return cache[1]
        with self._build_lock():
            # re-read under the lock: racing first calls import one graph,
            # so their executors share one key
            cache = self.__dict__.get("_graph_cache")
            if cache is not None and cache[0] is payload:
                return cache[1]
            g = import_model(payload)
            self.__dict__["_graph_cache"] = (payload, g)
            return g

    def _build_lock(self) -> "threading.RLock":
        """The model's lock over its graph import and executor builds
        (``dict.setdefault`` hands racing first callers the same one).
        Re-entrant: a build reads :attr:`graph`."""
        return self.__dict__.setdefault("_executor_lock", threading.RLock())

    def model_metadata(self) -> Dict[str, Any]:
        g = self.graph
        return {
            "inputs": {n: g.input_info.get(n) for n in g.input_names},
            "outputs": list(g.output_names),
            "n_nodes": len(g._nodes),
            "param_bytes": g.param_bytes(),
            "opset": g.opset,
        }

    def _post_copy(self, src):
        super()._post_copy(src)
        self._graph_cache = None
        self._executor_cache = {}

    # -- execution ------------------------------------------------------
    def _resolve_feeds(self, table: Table) -> List[np.ndarray]:
        g = self.graph
        feed = self.feed_dict or {}
        arrays = []
        for name in g.input_names:
            col = feed.get(name, name)
            if col not in table:
                raise KeyError(
                    f"graph input {name!r}: column {col!r} not in table "
                    f"(columns: {table.columns})")
            arr = np.asarray(table[col])
            if arr.dtype == object:
                arr = np.stack([np.asarray(v) for v in arr])
            want_dtype, _ = g.input_info.get(name, (None, None))
            if want_dtype is not None and np.issubdtype(np.dtype(want_dtype),
                                                        np.integer):
                arr = arr.astype(want_dtype)
            arrays.append(arr)
        return arrays

    def _refuse_unported(self, cd) -> int:
        """The Params whose machinery is not ported raise, naming the
        ROADMAP item that ports it."""
        if cd not in _DTYPES:
            raise ValueError(f"compute_dtype {cd!r} (expected one of "
                             f"{sorted(_DTYPES)})")
        tp = int(self.tensor_parallel or 1)
        if tp < 1:
            raise ValueError(f"tensor_parallel must be >= 1, got {tp}")
        if tp > 1 or self.partition_rules:
            raise NotImplementedError(
                "tensor_parallel > 1 and partition_rules are not ported "
                "yet: ROADMAP Queue 1 item 4")
        return tp

    def _executor(self, device=device_policy.DEFAULT_DEVICE
                  ) -> BatchedExecutor:
        cache = self.__dict__.setdefault("_executor_cache", {})
        g = self.graph
        # graph identity in the key: subclasses (CNTKModel cut_layers) can
        # swap the graph under us; a stale executor would run the old one
        norm = self.input_norm or {}
        unknown = set(norm) - set(g.input_names)
        if unknown:
            raise KeyError(
                f"input_norm names {sorted(unknown)} are not graph inputs "
                f"(inputs: {list(g.input_names)})")
        for name, spec in norm.items():
            bad = set(spec) - {"mean", "scale"}
            if bad:
                raise KeyError(
                    f"input_norm[{name!r}]: unknown keys {sorted(bad)} "
                    "(supported: 'mean', 'scale')")
            want, _ = g.input_info.get(name, (None, None))
            if want is not None and np.issubdtype(np.dtype(want), np.integer):
                raise TypeError(
                    f"input_norm[{name!r}]: graph declares an integer "
                    f"input ({np.dtype(want).name}) — normalizing token "
                    "ids is almost certainly a misconfiguration")
        # canonical, content-based key: dict order must not rebuild,
        # array-valued mean/scale must not collide via summarized repr
        norm_key = tuple(
            (name, tuple(sorted(
                (k, np.asarray(v).tobytes(), np.asarray(v).shape)
                for k, v in spec.items())))
            for name, spec in sorted(norm.items()))
        cd = self.compute_dtype
        dev = device_policy.resolve(device)
        if cd == "auto":
            # the measured verdict (probed once a content, batch and
            # device class, then a table hit); the resolved dtype keys the
            # executor cache, so a verdict flip cannot serve stale weights
            cd = routed_compute_dtype(g, self.model_payload,
                                      self.mini_batch_size, dev)
        tp = self._refuse_unported(cd)
        devs = resolve_devices(self.devices)
        if devs is not None and any(d.type != dev.type for d in devs):
            raise ValueError(
                f"devices={self.devices!r} name {[str(d) for d in devs]}, "
                f"but this call runs on {dev.type!r}")
        key = (id(g), self.mini_batch_size, cd, norm_key, dev,
               self.compile_cache_dir, tp, devs)
        hit = cache.get(key)
        if hit is not None:  # the steady path takes no lock
            return hit
        # concurrent first calls (scorer threads sharing one model) build
        # ONE executor: the check, the build and the insert under the
        # model's lock — each extra build would bind its own device copy
        # of the weights and keep its threads for as long as it is held
        with self._build_lock():
            if key not in cache:
                dtype = _DTYPES[cd]
                compute = None if cd == "float32" else dtype

                # Integer feeds bound for float graph inputs are cast (and
                # optionally normalized) ON DEVICE: the host->device wire then
                # carries 1-byte uint8 pixels instead of 2-byte bf16. Mirrors
                # the reference's marshalling stage, where ORT converts on the
                # accelerator side of PCIe (ref: ONNXModel.scala:357-402).
                names = list(g.input_names)
                info = g.input_info
                tgt = dtype if compute is not None else torch.float32

                def placed(d):
                    # the one-time cast and move: params land on the
                    # device in the compute dtype here, never per batch,
                    # BatchNorm folded
                    return g.bind(cast_dtype=compute, device=d), {
                        name: tuple(
                            torch.as_tensor(np.asarray(spec.get(k, v)),
                                            device=d).to(tgt)
                            for k, v in (("mean", 0.0), ("scale", 1.0)))
                        for name, spec in norm.items()}

                def apply_fn(bound, *args, _names=names, _tgt=tgt):
                    # the forward and stats bound on this slot's device
                    forward, stats = bound
                    staged = []
                    for name, a in zip(_names, args):
                        spec = stats.get(name)
                        if not a.is_floating_point():
                            want, _ = info.get(name, (None, None))
                            if spec is not None or _is_float(want):
                                a = a.to(_tgt)
                        if spec is not None:
                            a = (a - spec[0]) * spec[1]
                        staged.append(a)
                    return forward(*staged)
                # each executor pins a device copy of the weights: evict the
                # ones built for graphs that are no longer current (payload or
                # cut_layers swaps), and cap live-graph configs (a batch-size
                # sweep must not accumulate unbounded weight copies)
                for stale in [kk for kk in cache if kk[0] != id(g)]:
                    del cache[stale]
                while len(cache) >= 4:
                    cache.pop(next(iter(cache)))
                # content hash over graph+weights config: the store key's
                # ingredient that misses on changed model bytes. The graph's
                # node count + outputs disambiguate truncated subgraphs
                # sharing a payload
                cache_key = _cc.content_hash(
                    self.model_payload or b"", len(g._nodes),
                    tuple(g.output_names), cd, norm_key)
                cache[key] = BatchedExecutor(
                    apply_fn, device=None if devs else dev, devices=devs,
                    bound_args=(PerDevice(placed),),
                    compute_dtype=compute, max_bucket=self.mini_batch_size,
                    cache_key=cache_key, cache_dir=self.compile_cache_dir)
            return cache[key]

    def preferred_wire(self, input_name: str,
                       batch: Optional[int] = None,
                       device=device_policy.DEFAULT_DEVICE) -> str:
        """Routed hostfeed wire for ``input_name``: "uint8" (ship raw
        pixels, dequantize on the card via ``input_norm`` — the
        reference) or "float" (dequantize on the host, ship the compute
        dtype). A measured verdict from the "onnx_hostfeed_wire" lane,
        persisted per (norm content, row shape, batch bucket, compute
        dtype, device); "float" unconditionally when the input has no
        ``input_norm`` spec (there is no uint8 wire without one)."""
        g = self.graph
        norm = (self.input_norm or {}).get(input_name)
        if norm is None:
            return "float"
        _want, shape = g.input_info.get(input_name, (None, None))
        row = list(shape)[1:] if shape is not None else None
        if row is None or any(not isinstance(d, int) or d <= 0
                              for d in row):
            return "uint8"
        b = int(batch or self.mini_batch_size)
        dev = device_policy.resolve(device)
        compute = self.compute_dtype
        if compute == "auto":
            compute = routed_compute_dtype(g, self.model_payload, b, dev)
        mean = np.asarray(norm.get("mean", 0.0), np.float32)
        scale = np.asarray(norm.get("scale", 1.0), np.float32)
        return _WIRE_LANE.route(mean, scale, tuple(int(d) for d in row),
                                b, compute, dev)

    def warmup(self, buckets=None, example_feeds=None,
               device=device_policy.DEFAULT_DEVICE):
        """Capture every mini-batch bucket's forward as a CUDA graph
        BEFORE traffic arrives (on the CPU, warm the eager forward of each
        bucket), recording each in the executable store when
        ``compile_cache_dir`` is set; transform then replays one graph a
        bucket (``BatchedExecutor.warmup``; the reference ships prebuilt
        engines in its jars, ONNXModel.scala:173-193).

        Input shapes/dtypes come from the graph's declared inputs; pass
        ``example_feeds`` (graph input name -> example array with a batch
        dim) for inputs with dynamic non-batch dims or a different wire
        dtype (e.g. the uint8-pixel wire under ``input_norm``). Returns a
        :class:`~synapseml_tpu_torch.runtime.compile_cache.WarmupReport`."""
        g = self.graph
        example_feeds = example_feeds or {}
        args = []
        for name in g.input_names:
            if name in example_feeds:
                a = np.asarray(example_feeds[name])
                args.append((tuple(a.shape[1:]), a.dtype))
                continue
            want_dtype, shape = g.input_info.get(name, (None, None))
            row = list(shape)[1:] if shape is not None else None
            if row is None or any(not isinstance(d, int) or d <= 0
                                  for d in row):
                raise ValueError(
                    f"graph input {name!r} has dynamic non-batch dims "
                    f"{shape}: pass example_feeds[{name!r}] with the "
                    "concrete serving shape")
            args.append((tuple(int(d) for d in row),
                         np.dtype(want_dtype) if want_dtype is not None
                         else np.dtype(np.float32)))
        return self._executor(device).warmup(args, buckets=buckets)

    def _transform(self, table: Table, device) -> Table:
        # ride the executor's shared submit/drain pipeline: concurrent
        # _transform callers overlap their host staging, H2D, compute and
        # D2H instead of each serializing a private dispatch->fetch loop
        feeds = self._resolve_feeds(table)
        # keep a strong ref across result(): a concurrent config change
        # may evict this executor from the cache, and the pipeline holds
        # it only weakly — dropping it mid-flight would fail the future
        ex = self._executor(device)
        outs = ex.submit(*feeds).result()
        return self._attach_outputs(table, outs)

    def transform_stream(self, tables: Iterable[Table],
                         device=device_policy.DEFAULT_DEVICE
                         ) -> Iterator[Table]:
        """Score an iterable of tables with ``pipeline_depth`` mini-batches
        in flight, yielding transformed tables in order — batch k+1's host
        staging and H2D copy overlap batch k's compute and D2H fetch
        (the cross-call counterpart of the reference's IOBinding overlap,
        ref: ONNXModel.scala:357-402)."""
        ex = self._executor(device)
        pending: "deque" = deque()
        for table in tables:
            pending.append((table, ex.submit(*self._resolve_feeds(table))))
            while len(pending) > ex.pipeline_depth:
                t, fut = pending.popleft()
                yield self._attach_outputs(t, fut.result())
        while pending:
            t, fut = pending.popleft()
            yield self._attach_outputs(t, fut.result())

    def _attach_outputs(self, table: Table, outs) -> Table:
        g = self.graph
        fetch = self.fetch_dict or {n: n for n in g.output_names}
        by_name = dict(zip(g.output_names, outs))
        new_cols: Dict[str, np.ndarray] = {}
        for col, out_name in fetch.items():
            if out_name not in by_name:
                raise KeyError(f"fetch_dict: no graph output {out_name!r}")
            new_cols[col] = _host_column(by_name[out_name])
        first = _host_column(outs[0])
        if self.softmax_output_col:
            x = first.astype(np.float64)
            x = x - x.max(axis=-1, keepdims=True)
            e = np.exp(x)
            new_cols[self.softmax_output_col] = (
                e / e.sum(axis=-1, keepdims=True)).astype(np.float32)
        if self.argmax_output_col:
            new_cols[self.argmax_output_col] = first.argmax(axis=-1).astype(np.int64)
        return table.with_columns(new_cols)

    def _load_extra(self, path: str):
        self._graph_cache = None
        self._executor_cache = {}

"""Multi-process bootstrap: driver rendezvous, then a ``torch.distributed``
process group.

Counterpart of ``synapseml_tpu/parallel/distributed.py``, itself the
rebuild of the reference's driver-rendezvous control plane
(ref: lightgbm/src/main/scala/com/microsoft/ml/spark/lightgbm/LightGBMBase.scala:394-432
``createDriverNodesThread`` — driver ServerSocket collects each task's
``host:port``, broadcasts the full node list; TrainUtils.scala:236-295
``getNetworkInitNodes``/``networkInit`` with exponential-backoff retries).
:class:`WorkerInfo`, :class:`DriverRendezvous` and :func:`announce` are
copied: the same wire format (one JSON line each way), rank order and
timeouts.

The roster seeds ``torch.distributed.init_process_group`` where the
reference calls ``jax.distributed.initialize``: roster[0] hosts the TCP
store at ``coordinator_port``, and every later collective runs over the
group (``parallel/collectives.py``), NCCL between cards, gloo on the CPU
and for ranks that share one card (NCCL refuses two ranks on one
device). The rendezvous runs once a job; per-iteration traffic never
touches these sockets.

The reference's ``shard_map`` shim (``:25-70``) is not copied: it exists
only to run on either side of a JAX API move.

Typical multi-process flow (one process per card):
    reply = rendezvous_and_initialize(driver_host, driver_port)  # every rank
    group = global_mesh()                                         # world group
Single-process use: :func:`initialize` is a no-op returning ``False``
when a default group already exists or for one process without a
coordinator.
"""
from __future__ import annotations

import dataclasses
import datetime
import json
import os
import socket
import threading
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from synapseml_tpu_torch import device as device_policy
from synapseml_tpu_torch.parallel import collectives
from synapseml_tpu_torch.utils.fault import retry_with_backoff

_COORD_PORT_DEFAULT = 12421  # near the reference's DefaultLocalListenPort
INIT_TIMEOUT_S = 300.0       # jax.distributed.initialize's own default


@dataclasses.dataclass(frozen=True)
class WorkerInfo:
    """One process's identity in the rendezvous roster."""
    host: str
    rank_hint: int = -1

    def to_json(self) -> str:
        return json.dumps({"host": self.host, "rank_hint": self.rank_hint})

    @staticmethod
    def from_json(s: str) -> "WorkerInfo":
        d = json.loads(s)
        return WorkerInfo(host=d["host"], rank_hint=d.get("rank_hint", -1))


class DriverRendezvous:
    """Driver-side roster collector (createDriverNodesThread analogue).

    Accepts ``num_workers`` connections; each worker sends one JSON line
    (its :class:`WorkerInfo`), the driver replies to every worker with the
    full ordered roster plus the worker's assigned process index.
    """

    def __init__(self, num_workers: int, host: str = "0.0.0.0",
                 port: int = 0, timeout: float = 120.0):
        self.num_workers = num_workers
        self.timeout = timeout
        self._srv = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._srv.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._srv.bind((host, port))
        self._srv.listen(num_workers)
        self.port = self._srv.getsockname()[1]
        self._thread: Optional[threading.Thread] = None
        self.roster: List[WorkerInfo] = []
        self.error: Optional[BaseException] = None

    def run(self):
        """Block until all workers announced and were answered."""
        conns = []
        self._srv.settimeout(self.timeout)
        try:
            while len(conns) < self.num_workers:
                conn, _ = self._srv.accept()
                # per-connection deadline: a connected-but-silent worker
                # must not hang the whole rendezvous
                conn.settimeout(self.timeout)
                line = conn.makefile("r").readline()
                conns.append((conn, WorkerInfo.from_json(line)))
            # deterministic order: by rank hint, then host, then arrival
            order = sorted(range(len(conns)),
                           key=lambda i: (conns[i][1].rank_hint,
                                          conns[i][1].host, i))
            self.roster = [conns[i][1] for i in order]
            ranks = {i: r for r, i in enumerate(order)}
            payload_base = [dataclasses.asdict(w) for w in self.roster]
            for i, (conn, _) in enumerate(conns):
                msg = json.dumps({"roster": payload_base,
                                  "process_id": ranks[i]}) + "\n"
                conn.sendall(msg.encode())
        except Exception as e:
            self.error = e  # surfaced via wait()
        except BaseException as e:
            # record for wait(), then re-raise: an interrupt must
            # terminate the collector thread, not vanish into self.error
            self.error = e
            raise
        finally:
            for conn, _ in conns:
                conn.close()
            self._srv.close()

    def start(self) -> "DriverRendezvous":
        # a one-shot collector, not a serving loop: errors are recorded
        # above and re-raised by wait()
        self._thread = threading.Thread(target=self.run, daemon=True)
        self._thread.start()
        return self

    def wait(self):
        """Join the collector; raises if rendezvous failed or is incomplete
        (a silent empty roster must not look like success)."""
        if self._thread is not None:
            # run() legitimately takes up to one timeout per worker (accept
            # + readline each reset the clock); joining for less would
            # declare failure while the thread later hands out ranks
            self._thread.join(self.timeout * (self.num_workers + 1))
        if self.error is not None:
            raise RuntimeError(
                f"rendezvous failed after collecting "
                f"{len(self.roster)}/{self.num_workers} workers"
            ) from self.error
        if len(self.roster) != self.num_workers:
            raise RuntimeError(
                f"rendezvous incomplete: {len(self.roster)}/"
                f"{self.num_workers} workers announced")


def announce(driver_host: str, driver_port: int, info: WorkerInfo,
             timeout: float = 120.0) -> Dict:
    """Worker side (getNetworkInitNodes analogue): send identity, receive
    ``{"roster": [...], "process_id": int}``. Retries with backoff — the
    driver may not be listening yet (TrainUtils.scala:279-295)."""

    def attempt():
        with socket.create_connection((driver_host, driver_port),
                                      timeout=timeout) as s:
            s.sendall((info.to_json() + "\n").encode())
            data = s.makefile("r").readline()
            return json.loads(data)

    # ~2-minute ladder: worker pods routinely start before the driver binds
    # its port (ref: TrainUtils.networkInit's long retry window)
    return retry_with_backoff(
        attempt,
        backoffs_ms=(100, 500, 1000, 2000, 5000, 10000, 15000, 30000, 60000),
        retryable=(ConnectionError, OSError, json.JSONDecodeError))


def initialize(coordinator_address: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None,
               local_device_ids: Optional[Sequence[int]] = None,
               backend: Optional[str] = None,
               timeout: float = INIT_TIMEOUT_S,
               device: str = device_policy.DEFAULT_DEVICE) -> bool:
    """Join the job's default ``torch.distributed`` process group.

    Falls back to the ``SYNAPSEML_COORDINATOR`` (``host:port`` of the TCP
    store) / ``SYNAPSEML_NUM_PROCESSES`` / ``SYNAPSEML_PROCESS_ID``
    environment. No-op (returns False) for a one-process job without a
    coordinator, or when a default group exists already (initialized
    outside this module: adopted, not retried into a permanent error).
    Otherwise ends in ``init_process_group(init_method="tcp://...",
    world_size, rank, timeout)``, retried with backoff, mirroring the
    reference's networkInit ladder.

    ``backend``: ``None`` is NCCL for a CUDA ``device`` and gloo for the
    CPU; ranks that share one card pass ``"gloo"``. A backend that fails
    raises; none is swapped for another. ``local_device_ids=[i]`` selects
    this rank's card (``torch.cuda.set_device(i)``): one rank is one
    device. ``timeout`` (seconds) bounds the join and every collective of
    the group.
    """
    if dist.is_initialized():
        return False
    coordinator_address = coordinator_address or os.environ.get(
        "SYNAPSEML_COORDINATOR")
    num_processes = num_processes if num_processes is not None else int(
        os.environ.get("SYNAPSEML_NUM_PROCESSES", "1"))
    process_id = process_id if process_id is not None else int(
        os.environ.get("SYNAPSEML_PROCESS_ID", "0"))
    if num_processes <= 1 and coordinator_address is None:
        return False
    if coordinator_address is None:
        raise ValueError(
            f"{num_processes} processes need a coordinator address "
            "(host:port of rank 0's store; SYNAPSEML_COORDINATOR)")
    if local_device_ids is not None and len(local_device_ids) != 1:
        raise ValueError(f"local_device_ids={list(local_device_ids)}: a "
                         "rank of the port is one device")
    if backend is None:
        cuda = device_policy.resolve(device).type == "cuda"
        backend = "nccl" if cuda else "gloo"
    if local_device_ids is not None:
        torch.cuda.set_device(int(local_device_ids[0]))

    def attempt():
        dist.init_process_group(
            backend, init_method=f"tcp://{coordinator_address}",
            world_size=num_processes, rank=process_id,
            timeout=datetime.timedelta(seconds=timeout))
        return True

    retry_with_backoff(attempt, backoffs_ms=(500, 1000, 5000, 10000))
    return True


def initialize_from_roster(reply: Dict,
                           coordinator_port: int = _COORD_PORT_DEFAULT,
                           **init_kw) -> bool:
    """Turn a rendezvous reply into a process-group join: roster[0] hosts
    the TCP store. ``init_kw``: :func:`initialize`'s ``local_device_ids``,
    ``backend``, ``timeout`` and ``device``."""
    roster = reply["roster"]
    return initialize(
        coordinator_address=f"{roster[0]['host']}:{coordinator_port}",
        num_processes=len(roster),
        process_id=int(reply["process_id"]), **init_kw)


def rendezvous_and_initialize(driver_host: str, driver_port: int,
                              my_host: Optional[str] = None,
                              rank_hint: int = -1,
                              coordinator_port: int = _COORD_PORT_DEFAULT,
                              **init_kw) -> Dict:
    """One-call worker bootstrap: announce to the driver, then join the
    process group with the agreed roster. Returns the reply dict."""
    info = WorkerInfo(host=my_host or socket.gethostname(),
                      rank_hint=rank_hint)
    reply = announce(driver_host, driver_port, info)
    initialize_from_roster(reply, coordinator_port, **init_kw)
    return reply


def process_count() -> int:
    """Processes in the job (``jax.process_count()``): 1 without a group."""
    return dist.get_world_size() if dist.is_initialized() else 1


def process_index() -> int:
    """This process's rank in the job (``jax.process_index()``)."""
    return dist.get_rank() if dist.is_initialized() else 0


def global_mesh(want: Optional[Dict[str, int]] = None):
    """The job's one-axis data-parallel mesh: the world group (one rank a
    device), or ``collectives.ALONE`` in a process without a group.
    ``want`` may only ask for ``{"dp": world size}``."""
    world = process_count()
    if want is not None and dict(want) != {"dp": world}:
        raise ValueError(
            f"mesh {want} cannot be formed: the port's mesh is one 'dp' "
            f"axis over the job's {world} ranks")
    return collectives.check_group(None)


def host_allgather_rows(a: np.ndarray) -> np.ndarray:
    """Bit-exact gather of every process's row block (ragged first dim,
    any dtype: 8-byte values ride as their bytes), concatenated in process
    order (``collectives.gather_rows`` over the world group, on the card
    for an NCCL group). Single-process: returns ``a`` unchanged."""
    a = np.ascontiguousarray(a)
    if process_count() == 1:
        return a
    nccl = dist.get_backend() == "nccl"
    dev = torch.device("cuda", torch.cuda.current_device()) if nccl else None
    return collectives.gather_rows(a, dist.group.WORLD, dev)

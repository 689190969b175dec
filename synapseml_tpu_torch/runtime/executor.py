"""Batched-inference executor: the device runtime of the port.

The counterpart of the reference package's ``runtime/executor.py``, on one
device. It runs ``fn(*bound_args, *batch)`` over row batches:

- **Shape bucketing**: batches are padded up to power-of-two buckets
  (``round_up_pow2``, capped by ``max_bucket``), so an arbitrary row
  stream meets a few shapes, and the padding is sliced off the outputs.
- **dtype coercion**: host columns are coerced once (f64→f32, i64→i32,
  u64→u32; floating columns to ``compute_dtype``) while they are copied
  into a staging buffer — no per-row marshalling loop.
- **Async submit/dispatch/drain pipeline**: every call rides a
  per-executor pipeline of (a) a bounded pool of staging workers that
  coerce and pad each chunk into a **pinned** host buffer, (b) one ordered
  dispatch thread that starts the ``non_blocking`` host-to-card copy on
  the executor's copy-in stream, runs ``fn`` under
  ``torch.inference_mode()`` on its compute stream once the copy's event
  has passed, and starts the card-to-host copy of each output into
  pinned memory on its copy-out stream, then records an event and moves
  on — so batch k+1's copy in runs while batch k computes — and (c) one
  drain thread, the only place the pipeline waits for the card: it waits
  on that event, slices the padding off and resolves the future.
  :meth:`submit` returns a future, :meth:`stream` pipelines an iterable
  with ``pipeline_depth`` batches in flight, ``__call__`` is submit +
  result.

Supervision: a pipeline thread that dies fails every in-flight future with
:class:`~synapseml_tpu_torch.runtime.faults.PipelineBrokenError`, never a
hang, and the next :meth:`submit` starts a fresh pipeline.

**Warm programs** (:meth:`BatchedExecutor.warmup`): the reference
AOT-compiles every bucket's XLA program before traffic. Here a bucket's
warm program is a **CUDA graph** captured per (bucket, staged signature),
with static input tensors in the staged dtype and the static output leaves
it returns; a dispatch copies the staged batch into the static inputs and
replays the graph — the whole forward in one launch. On the CPU the warm
program is the eager ``fn`` bound to that signature, warmed by one run on
zeros, so the CPU sees the same ladder, statuses, hits and sentinel. The
table of warm programs (``_aot``), its hit counter and the recompile
sentinel (``executor_recompiles_total{reason=}``) are the reference's; the
persistent store keeps each signature's record (runtime/compile_cache.py).

**Data parallelism** (``devices=``, :func:`resolve_devices`): each entry
of the device list is a *slot* with its own compute, copy-in and copy-out
streams, its own warm graphs, static inputs and graph pool, and its own
dispatch counter. A bucket that the slot count divides is **sharded**:
slot ``i`` copies rows ``i*k:(i+1)*k`` of the staged bucket in on its
copy-in stream and replays its graph of the ``k``-row signature on its
compute stream, and the outputs are reassembled in row order (the port's
counterpart of the reference's one GSPMD-sharded call, counted once under
the mesh label ``dp{n}``). Any other bucket lands whole on the next slot,
round robin. A list may repeat a device: slots on one card share its
replica of the bound args (a :class:`PerDevice` arg made once a device)
and nothing else, so the layouts run on one card and, over
``["cpu"] * n``, on the CPU.

**The H2D lane** (lane ``executor_h2d``, runtime/autotune.py): whether a
multi-argument bucket's staged host columns cross to the card one copy a
column (``per_arg``, the reference) or ``coalesced`` — one pinned staging
buffer a dtype group, one copy on the slot's copy-in stream, views out. A
measured verdict keyed by the bucket's staged signature and the card,
probed in :meth:`BatchedExecutor.warmup` only; the dispatch path reads the
persisted verdict through a per-executor memo and never probes. Never
used under the shard layout.

The reference donates a bucket's input buffers to XLA; PyTorch has no
donation, and its caching allocator reuses a bucket's device blocks from
one batch to the next, so there is no ``donate`` parameter and the
sentinel's ``donation_mask`` series stays at 0. Tensor parallelism and the
cost model's records are not ported yet (ROADMAP Queue 1 items 4 and 6).
"""
from __future__ import annotations

import atexit
import contextlib
import math
import os
import queue as _queue
import threading
import time
import weakref
from collections import deque
from concurrent.futures import Future, InvalidStateError
from typing import (Any, Callable, Dict, Iterable, Iterator, List, Optional,
                    Sequence, Tuple, Union)

import numpy as np
import torch

from synapseml_tpu_torch import device as device_policy
from synapseml_tpu_torch.runtime import blackbox as _bb
from synapseml_tpu_torch.runtime import compile_cache as _cc
from synapseml_tpu_torch.runtime import faults as _flt
from synapseml_tpu_torch.runtime import telemetry as _tm
from synapseml_tpu_torch.runtime.faults import PipelineBrokenError

# module-level metric handles, resolved once. Stage semantics are the
# reference's: "stage" is the host coerce+pad into the staging buffer,
# "dispatch" the host cost of starting H2D + compute + D2H, "compute"
# dispatch-end -> drain-pickup (overlap-inclusive: the tightest bound the
# host can observe without waiting for the card on the hot path),
# "drain" the wait on the batch's event plus the slicing
_M_SUBMIT = _tm.counter("executor_submit_total")
_M_STAGE_S = _tm.histogram("executor_stage_seconds")
_M_DISPATCH_S = _tm.histogram("executor_dispatch_seconds")
_M_COMPUTE_S = _tm.histogram("executor_compute_seconds")
_M_DRAIN_S = _tm.histogram("executor_drain_seconds")
_M_PIPE_RESTARTS = _tm.counter("executor_pipeline_restarts_total")
_M_AOT_HIT = _tm.counter("executor_aot_hits_total")
_M_AOT_MISS = _tm.counter("executor_aot_misses_total")
_M_AOT_RETIRED = _tm.counter("executor_aot_retired_total")
# card tensors moved between two devices by the data-parallel layouts (a
# caller's input or a device_outputs leaf on another slot's card); 0
# while every slot names one card
_M_XDEV = _tm.counter("executor_cross_device_copies_total")

# -- recompile sentinel ------------------------------------------------------
# After warmup() has warmed the executor's full signature set, an eager
# first run of a signature on the dispatch path is an INCIDENT — a mystery
# latency spike with a name. Reasons: "shape_drift" (a signature outside
# the warmed set — usually an unwarmed bucket or feature-width change),
# "arity" (a call arity warmup never saw), "donation_mask" (the
# reference's: same shapes, another donation annotation; the port does
# not donate, so the series stays 0), "cache_skew" (a warm program retired
# after its replay raised). Handles resolved at import so the series exist
# (at 0) on every scrape.
RECOMPILE_REASONS = ("shape_drift", "arity", "donation_mask",
                     "cache_skew")
_M_RECOMPILE = {r: _tm.counter("executor_recompiles_total", reason=r)
                for r in RECOMPILE_REASONS}
# warm-program build time by phase: "warmup" = captures off the serving
# path, "dispatch" = a signature's first eager run ON the dispatch path
# (post-warmup these are exactly the recompiles above), "deserialize" =
# the capture and check of a store-loaded signature (compile_cache.py)
_M_COMPILE_WARM_S = _tm.histogram("executor_compile_seconds",
                                  phase="warmup")
_M_COMPILE_DISP_S = _tm.histogram("executor_compile_seconds",
                                  phase="dispatch")

# fault-injection points (runtime/faults.py), resolved once at import:
# fire() is a single attribute test when nothing is armed. The
# thread_kill points sit at the pipeline-loop tops OUTSIDE every per-unit
# handler, so an armed kill terminates the THREAD, never just one batch.
_F_STAGING = _flt.point("staging")
_F_H2D = _flt.point("h2d")
_F_COMPUTE = _flt.point("compute")
_F_DRAIN = _flt.point("drain")
_F_LAT_DISPATCH = _flt.point("latency", "dispatch")
_F_KILL_STAGE = _flt.point("thread_kill", "stage")
_F_KILL_DISPATCH = _flt.point("thread_kill", "dispatch")
_F_KILL_DRAIN = _flt.point("thread_kill", "drain")


def round_up_pow2(n: int, minimum: int = 8) -> int:
    if n <= minimum:
        return minimum
    return 1 << math.ceil(math.log2(n))


_COERCE = {
    np.dtype(np.float64): np.float32,
    np.dtype(np.int64): np.int32,
    np.dtype(np.uint64): np.uint32,
}
_TORCH_COERCE = {torch.float64: torch.float32, torch.int64: torch.int32,
                 torch.uint64: torch.uint32}
_DTYPE_NAMES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
                "float16": torch.float16, "float64": torch.float64}


def _torch_dtype(dt) -> Optional[torch.dtype]:
    """A compute dtype given as a torch dtype, a name or a numpy dtype."""
    if dt is None or isinstance(dt, torch.dtype):
        return dt
    name = _cc.dtype_name(dt)
    if name not in _DTYPE_NAMES:
        raise ValueError(f"compute_dtype {dt!r} is not a float dtype "
                         f"({', '.join(_DTYPE_NAMES)})")
    return _DTYPE_NAMES[name]


def _host_source(a) -> torch.Tensor:
    """A host column as a CPU tensor after the reference's coercions
    (f64→f32, i64→i32, u64→u32), sharing the caller's memory where it can."""
    if isinstance(a, torch.Tensor):
        t = a.detach().cpu()
        return t.to(_TORCH_COERCE[t.dtype]) if t.dtype in _TORCH_COERCE \
            else t
    arr = np.ascontiguousarray(np.asarray(a))
    if arr.dtype in _COERCE:
        arr = arr.astype(_COERCE[arr.dtype])
    elif not arr.flags.writeable:
        arr = arr.copy()  # torch.from_numpy refuses to share read-only memory
    return torch.from_numpy(arr)


def coerce_host_array(arr, compute_dtype: Any = None) -> torch.Tensor:
    """Coerce a host column (f64→f32, i64→i32, u64→u32; floating columns
    to ``compute_dtype``), as the reference's ``coerce_host_array`` does.
    Returns a CPU tensor: numpy has no bfloat16, and torch's float→bf16
    cast rounds to nearest even, as the reference's ``astype`` does."""
    t = _host_source(arr)
    dt = _torch_dtype(compute_dtype)
    if dt is not None and t.is_floating_point():
        t = t.to(dt)
    return t


def resolve_devices(spec) -> Optional[Tuple[torch.device, ...]]:
    """Normalize a user-facing device spec to a tuple of ``torch.device``s.

    ``None`` -> None (one device); ``"all"`` -> every visible CUDA device
    (raises without CUDA, as every entry point does: never the CPU); an
    int ``n`` -> the first n CUDA devices; a sequence of devices (or
    names) passes through. A sequence may repeat a device: each position
    is a slot of its own (the reference's JAX mesh cannot repeat one).
    Raises on anything else, so a typo'd spec fails at construction, not
    as a quiet one-device run."""
    if spec is None:
        return None
    if isinstance(spec, bool):
        # devices=True would satisfy the int branch and resolve to ONE
        # device — the opposite of what the caller meant
        raise ValueError("devices=True/False is ambiguous — use 'all', "
                         "an int, or a device sequence")
    if isinstance(spec, str):
        if spec != "all":
            raise ValueError(
                f"devices spec {spec!r} not understood (use None, 'all', "
                "an int, or a sequence of torch devices)")
        device_policy.resolve("cuda")
        return tuple(torch.device("cuda", i)
                     for i in range(torch.cuda.device_count()))
    if isinstance(spec, int):
        count = local_device_count()
        if not 0 < spec <= count:
            raise ValueError(
                f"devices={spec} but {count} CUDA devices exist")
        return tuple(torch.device("cuda", i) for i in range(spec))
    devs = []
    for d in spec:
        dev = device_policy.resolve(d)
        if dev.type == "cuda" and dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
        devs.append(dev)
    if not devs:
        raise ValueError("devices sequence is empty")
    if len({d.type for d in devs}) > 1:
        raise ValueError(f"devices {devs} mix the CPU and CUDA devices")
    return tuple(devs)


def _leaves(out) -> list:
    """The leaves of an output tree in the reference's order (``jax``'s
    pytree: tuples and lists in order, dicts by sorted key)."""
    if isinstance(out, (tuple, list)):
        return [leaf for o in out for leaf in _leaves(o)]
    if isinstance(out, dict):
        return [leaf for k in sorted(out) for leaf in _leaves(out[k])]
    return [out]


class PerDevice:
    """A bound arg made by ``make(device)`` once a distinct device of an
    executor's slots, where moving a tensor tree is not enough: a graph
    bound to a device (``ImportedGraph.bind``) closes over its weights
    there. Slots on one device share what it made."""

    __slots__ = ("make",)

    def __init__(self, make: Callable[[torch.device], Any]):
        self.make = make


def _to_device(tree, dev: torch.device):
    if isinstance(tree, PerDevice):
        return tree.make(dev)
    if isinstance(tree, (tuple, list)):
        return type(tree)(_to_device(t, dev) for t in tree)
    if isinstance(tree, dict):
        return {k: _to_device(v, dev) for k, v in tree.items()}
    if isinstance(tree, torch.Tensor):
        return tree.to(dev)
    if isinstance(tree, np.ndarray):
        return torch.from_numpy(np.ascontiguousarray(tree)).to(dev)
    return tree


def _concat(parts: list):
    if isinstance(parts[0], torch.Tensor):
        return torch.cat(parts)
    return np.concatenate(parts)


def _check_rows(pieces: list, rows: int):
    """A sharded bucket's slices of one output leaf each carry ``rows``
    rows on axis 0, or they cannot be joined in row order."""
    for p in pieces:
        if np.ndim(p) == 0 or len(p) != rows:
            raise ValueError(
                "a sharded bucket's outputs must carry its batch axis: a "
                f"slot of {rows} rows returned a leaf of shape "
                f"{tuple(np.shape(p))} — batch-align it in-graph, or use "
                "a slot count that does not divide the bucket (round "
                "robin runs whole buckets)")


def _join_rows(parts: List[list], rows: int) -> list:
    """The output leaves of a sharded bucket, ``parts`` being each slot's
    leaves in slot order: every leaf joined in row order (a tensor on the
    first slot's device, anything else as numpy)."""
    return [_join_leaf([p[j] for p in parts], rows)
            for j in range(len(parts[0]))]


def _join_leaf(pieces: list, rows: int):
    """One output leaf of a sharded bucket from its slots' pieces."""
    _check_rows(pieces, rows)
    if all(isinstance(p, torch.Tensor) for p in pieces):
        dev = pieces[0].device
        return torch.cat([p.to(dev) for p in pieces])
    return np.concatenate([np.asarray(p) for p in pieces])


def _column_sig(col) -> tuple:
    """The (shape, dtype name) of one staged column of a bucket."""
    if isinstance(col, _Rows):
        host = col.batch.host
        return ((col.stop - col.start,) + tuple(host.shape[1:]),
                _cc.dtype_name(host.dtype))
    return tuple(col.shape), _cc.dtype_name(col.dtype)


_SHUTDOWN = object()


class ExecutorFuture:
    """Future-like handle for one :meth:`BatchedExecutor.submit`.

    Resolves to the exact tuple ``__call__`` returns. Assembly (gathering
    per-bucket chunks, concatenating) happens in the *waiter's* thread, so
    the pipeline's drain thread never blocks on host-side concatenation of
    someone else's result.
    """

    __slots__ = ("_chunks",)

    def __init__(self, chunk_futs: Sequence[Future]):
        self._chunks = list(chunk_futs)

    def result(self, timeout: Optional[float] = None):
        """Block until every chunk lands; ``timeout`` is ONE overall
        monotonic deadline across all chunks — waiting n_chunks slow
        chunks can never stretch the total wait past ``timeout``."""
        deadline = None if timeout is None \
            else time.monotonic() + timeout
        outs = [f.result(
            None if deadline is None
            else max(0.0, deadline - time.monotonic()))
            for f in self._chunks]
        if len(outs) == 1:
            return outs[0]
        return tuple(_concat([o[i] for o in outs])
                     for i in range(len(outs[0])))

    def done(self) -> bool:
        return all(f.done() for f in self._chunks)

    def exception(self, timeout: Optional[float] = None):
        """First chunk error, or None; ``timeout`` is one overall
        deadline, same as :meth:`result`."""
        deadline = None if timeout is None \
            else time.monotonic() + timeout
        for f in self._chunks:
            exc = f.exception(
                None if deadline is None
                else max(0.0, deadline - time.monotonic()))
            if exc is not None:
                return exc
        return None

    def add_done_callback(self, fn: Callable[["ExecutorFuture"], None]):
        """Invoke ``fn(self)`` once the LAST chunk completes."""
        remaining = [len(self._chunks)]
        lock = threading.Lock()

        def _one(_f):
            with lock:
                remaining[0] -= 1
                if remaining[0]:
                    return
            fn(self)

        for f in self._chunks:
            f.add_done_callback(_one)


class _PinnedPool:
    """Pinned host staging buffers, kept per (shape, dtype). A buffer comes
    back only after the event that follows its host-to-card copy has
    completed (:meth:`BatchedExecutor._fetch` gives it back after waiting
    on the batch's event), so a copy in flight never reads rows being
    overwritten. ``take`` allocates when none is free: holders are bounded
    by the staging window plus the batches in flight, which is also the
    cap kept per signature."""

    def __init__(self, cap: int):
        self._cap = cap
        self._free: Dict[tuple, List[torch.Tensor]] = {}
        self._lock = threading.Lock()

    def take(self, shape: Tuple[int, ...], dtype: torch.dtype) -> torch.Tensor:
        with self._lock:
            free = self._free.get((shape, dtype))
            if free:
                return free.pop()
        return torch.empty(shape, dtype=dtype, pin_memory=True)

    def give(self, buf: torch.Tensor):
        with self._lock:
            free = self._free.setdefault((tuple(buf.shape), buf.dtype), [])
            if len(free) < self._cap:
                free.append(buf)


class _HostBatch:
    """Rows of one input staged on the host for ONE host-to-card copy,
    shared by the chunks sliced from it (``transfer_batches`` groups
    several buckets into one). ``device`` is set by the dispatch thread's
    copy; the staging buffer goes back to the pool once the last of its
    ``users`` chunks has drained."""

    __slots__ = ("host", "device", "ready", "users", "pool")

    def __init__(self, host: torch.Tensor, users: int,
                 pool: Optional[_PinnedPool]):
        self.host = host
        self.device: Optional[torch.Tensor] = None
        # recorded on the copy-in stream after the copy (None on the CPU)
        self.ready: Optional[torch.cuda.Event] = None
        self.users = users
        self.pool = pool

    def release(self):
        self.users -= 1  # drain thread only
        if self.users == 0 and self.pool is not None:
            self.pool.give(self.host)


class _Rows:
    """Rows ``start:stop`` of a :class:`_HostBatch`: one chunk's share of
    a staged input."""

    __slots__ = ("batch", "start", "stop")

    def __init__(self, batch: _HostBatch, start: int, stop: int):
        self.batch = batch
        self.start = start
        self.stop = stop


class _Flight:
    """One dispatched batch: its output leaves (pinned host copies in
    flight, or card tensors for ``device_outputs``), the events recorded
    after its last copies, one a slot it ran on (none on the CPU), and the
    staged inputs it holds."""

    __slots__ = ("leaves", "events", "leases")

    def __init__(self, leaves: list, events: list,
                 leases: List[_HostBatch]):
        self.leaves = leaves
        self.events = events
        self.leases = leases


class _Slot:
    """One entry of the executor's device list (or its pinned device): the
    device, the compute, copy-in and copy-out streams the dispatch thread
    issues a batch's work for it on, and the state of its warm graphs —
    their memory pool, capture stream, replay lock and ``released``, the
    event after the last batch's copies out of its graphs' static
    outputs. Slots on one card share no stream, graph, static buffer or
    pool, so two of them may replay at once."""

    __slots__ = ("index", "device", "streams", "pool", "capture_stream",
                 "replay_lock", "released")

    def __init__(self, index: int, device: torch.device):
        self.index = index
        self.device = device
        self.streams = (tuple(torch.cuda.Stream(device) for _ in range(3))
                        if device.type == "cuda" else (None, None, None))
        self.pool = None
        self.capture_stream: Optional[torch.cuda.Stream] = None
        self.replay_lock = threading.Lock()
        self.released: Optional[torch.cuda.Event] = None

    @property
    def compute(self) -> Optional[torch.cuda.Stream]:
        return self.streams[0]

    def on_compute(self):
        """Issue on this slot's compute stream (and its device)."""
        if self.streams[0] is None:
            return contextlib.nullcontext()
        return torch.cuda.stream(self.streams[0])

    def join(self):
        """Wait until every stream of the slot has run dry."""
        for s in self.streams:
            if s is not None:
                s.synchronize()


class _Warm:
    """One warm program of the AOT table, on one slot. On the card: a CUDA
    graph, its static inputs (zero-filled at capture, in the staged dtype)
    and its static output leaves. On the CPU ``graph`` is None and the
    eager ``fn`` runs bound to the signature."""

    __slots__ = ("slot", "graph", "inputs", "outputs")

    def __init__(self, slot: _Slot,
                 graph: Optional["torch.cuda.CUDAGraph"] = None,
                 inputs: Sequence[torch.Tensor] = (),
                 outputs: Sequence[Any] = ()):
        self.slot = slot
        self.graph = graph
        self.inputs = list(inputs)
        self.outputs = list(outputs)


class _Unit:
    """One staging unit: a callable producing 1+ dispatch-ready chunks.

    A plain chunk stages one bucket; a super-chunk (``transfer_batches``)
    stages one grouped host-to-card copy that fans out into several bucket
    dispatches on card-side slices.
    """

    __slots__ = ("stage", "futs", "staged", "error", "ready", "ex",
                 "spans", "after")

    def __init__(self, n_chunks: int,
                 spans: Optional[Tuple["_tm.Span", ...]] = None):
        self.stage: Callable[[], List[tuple]] = None  # set by _plan
        self.futs = [Future() for _ in range(n_chunks)]
        self.staged: Optional[List[tuple]] = None
        self.error: Optional[BaseException] = None
        self.ready = threading.Event()
        # strong ref while work is pending: 'fut = ex.submit(x); del ex;
        # fut.result()' must complete, not die to a mid-flight GC. The
        # ref is dropped as each stage finishes, so an IDLE executor is
        # still collectable (and its threads reaped via the finalizer).
        self.ex: Optional["BatchedExecutor"] = None
        # trace spans of the requests riding this unit (the submitting
        # thread's ambient context); read by the pipeline threads
        self.spans = spans
        # an event on the submitting thread's stream, recorded when the
        # call passed card tensors: the executor's stream waits on it
        # before reading them
        self.after: Optional[torch.cuda.Event] = None


class _PipelineState:
    """Shared queues/threads of one executor's pipeline.

    Lives OUTSIDE the executor so worker threads can hold it strongly
    while holding the executor itself only weakly — a dropped executor is
    then garbage-collected and its threads reaped via ``weakref.finalize``
    instead of leaking a parked thread set.
    """

    __slots__ = ("stage_q", "dispatch_q", "inflight_q", "depth_sem",
                 "stage_slots", "lock", "closed", "broken", "pending",
                 "threads", "slots", "__weakref__")

    def __init__(self, depth: int, stage_workers: int,
                 slots: Sequence[_Slot] = ()):
        self.stage_q: "_queue.Queue" = _queue.Queue()
        self.dispatch_q: "_queue.Queue" = _queue.Queue()
        # unbounded queue + explicit semaphore: "in flight" counts
        # dispatched-but-unfetched batches exactly
        self.inflight_q: "_queue.Queue" = _queue.Queue()
        self.depth_sem = threading.Semaphore(depth)
        # backpressure on submit: at most depth + workers staging units
        # may be pending host-side
        self.stage_slots = threading.Semaphore(depth + stage_workers)
        self.lock = threading.Lock()
        self.closed = False
        # supervision: set (under lock) to the PipelineBrokenError when a
        # pipeline thread dies unexpectedly
        self.broken: Optional["PipelineBrokenError"] = None
        # every submitted-but-unresolved chunk Future, so a dying thread
        # can fail ALL in-flight work wherever it sits in the pipeline
        self.pending: set = set()
        self.threads: List[threading.Thread] = []
        # the executor's slots: the dispatch thread issues on their
        # streams, the supervisor joins them after a break
        self.slots = tuple(slots)


def _untrack_future(state: _PipelineState, fut: Future):
    """Done-callback: a resolved chunk future leaves the supervision
    registry (runs on whichever thread resolved it)."""
    with state.lock:
        state.pending.discard(fut)


def _acquire_or_broken(sem: threading.Semaphore,
                       state: _PipelineState) -> bool:
    """Acquire ``sem``, polling the supervisor's broken flag: a dead drain
    thread (its releases gone with it) must never park the dispatch thread
    forever. False = the pipeline broke while waiting. Re-checks
    ``broken`` after a successful acquire: the permit may be the wake-up
    one :func:`_break_pipeline` released, and it goes back so the cascade
    keeps waking other waiters."""
    while True:
        if sem.acquire(timeout=0.2):
            if state.broken is not None:
                sem.release()
                return False
            return True
        if state.broken is not None:
            return False


def _fut_resolve(fut: Future, result=None, error: Optional[BaseException] = None):
    """Resolve a chunk future, tolerating one already failed by
    :func:`_break_pipeline`."""
    try:
        if error is not None:
            fut.set_exception(error)
        else:
            fut.set_result(result)
    except InvalidStateError:
        pass


def _stage_worker(state: _PipelineState):
    while True:
        unit = state.stage_q.get()
        if unit is _SHUTDOWN:
            state.stage_q.put(_SHUTDOWN)  # propagate to sibling workers
            return
        # kill point AFTER the get, OUTSIDE the per-unit handler: the
        # armed kill dies with a unit in hand
        _F_KILL_STAGE.fire()
        t0 = time.monotonic()
        killed = False
        try:
            with _tm.trace_annotation("synapseml/executor/stage"):
                _F_STAGING.fire()
                unit.staged = unit.stage()
        except Exception as e:  # noqa: BLE001 - delivered via futures
            # Exception, not BaseException: a kill (ThreadKilled) must
            # escape to the supervisor and terminate the THREAD
            unit.error = e
        except BaseException:
            # dying with the unit in hand: leave ready UNSET, so the
            # dispatch thread's bounded ready-poll sees state.broken
            killed = True
            raise
        finally:
            unit.stage = None  # drop array refs promptly
            dt = time.monotonic() - t0
            _M_STAGE_S.observe(dt)
            if unit.spans:
                for sp in unit.spans:
                    sp.note("stage", dt)
            if not killed:
                unit.ready.set()


def _dispatch_loop(state: _PipelineState):
    home = state.slots[0]
    if home.compute is not None:
        # once for this thread: its kernels go to the first slot's
        # compute stream unless a slot's own stream is named
        torch.cuda.set_device(home.device)
        torch.cuda.set_stream(home.compute)
    while True:
        unit = state.dispatch_q.get()
        if unit is _SHUTDOWN:
            state.inflight_q.put(_SHUTDOWN)
            return
        _F_KILL_DISPATCH.fire()
        # bounded wait: a stage worker that DIED holding this unit never
        # sets ready
        while not unit.ready.wait(0.2):
            if state.broken is not None:
                break
        try:
            if state.broken is not None:
                continue
            if unit.error is not None:
                for f in unit.futs:
                    _fut_resolve(f, error=unit.error)
                continue
            if unit.after is not None:
                for slot in state.slots:
                    slot.compute.wait_event(unit.after)
            ex = unit.ex
            for (arrays, n, bucket), fut in zip(unit.staged, unit.futs):
                if not _acquire_or_broken(state.depth_sem, state):
                    break  # broke while waiting; futures already failed
                t0 = time.monotonic()
                try:
                    # instance-attribute lookup: tests (and tracing
                    # wrappers) may patch ex._dispatch per instance
                    with _tm.trace_annotation(
                            "synapseml/executor/dispatch"):
                        out, n, bucket = ex._dispatch(arrays, n, bucket)
                except Exception as e:  # noqa: BLE001
                    state.depth_sem.release()
                    _fut_resolve(fut, error=e)
                    continue
                t1 = time.monotonic()
                _M_DISPATCH_S.observe(t1 - t0)
                state.inflight_q.put(
                    (out, n, bucket, fut, ex, unit.spans, t1))
            del ex
        finally:
            unit.staged = None
            unit.ex = None
            state.stage_slots.release()
            del unit


def _drain_loop(state: _PipelineState):
    while True:
        rec = state.inflight_q.get()
        if rec is _SHUTDOWN:
            return
        _F_KILL_DRAIN.fire()
        out, n, bucket, fut, ex, spans, t_disp = rec
        del rec
        t0 = time.monotonic()
        try:
            err: Optional[BaseException] = None
            try:
                with _tm.trace_annotation("synapseml/executor/drain"):
                    _F_DRAIN.fire()
                    res = ex._fetch(out, n, bucket)
            except Exception as e:  # noqa: BLE001
                err = e
            t1 = time.monotonic()
            # span notes land BEFORE the future resolves
            _M_COMPUTE_S.observe(t0 - t_disp)
            _M_DRAIN_S.observe(t1 - t0)
            if spans:
                for sp in spans:
                    sp.note("compute", t0 - t_disp)
                    sp.note("drain", t1 - t0)
            if err is not None:
                _fut_resolve(fut, error=err)
            else:
                _fut_resolve(fut, res)
        finally:
            state.depth_sem.release()
            del ex, out, fut, spans


def _shutdown_pipeline(state: _PipelineState):
    """Idempotent: wake every pipeline thread with sentinels. Pending
    units already queued ahead of the sentinels still complete."""
    with state.lock:
        if state.closed:
            return
        state.closed = True
    state.stage_q.put(_SHUTDOWN)
    state.dispatch_q.put(_SHUTDOWN)


def _break_pipeline(state: _PipelineState, exc: BaseException):
    """Supervision: a pipeline thread died unexpectedly. Fail EVERY
    in-flight future with a descriptive :class:`PipelineBrokenError`,
    mark the state broken so the owning executor's next submit builds a
    fresh pipeline, and wake the surviving threads so they exit."""
    err = PipelineBrokenError(
        f"executor pipeline thread "
        f"{threading.current_thread().name!r} died: {exc!r}; all "
        "in-flight work failed — the pipeline restarts on the next "
        "submit")
    err.__cause__ = exc
    with state.lock:
        if state.broken is not None:
            return  # a sibling thread already broke the pipeline
        state.broken = err
        state.closed = True
        pending = list(state.pending)
        state.pending.clear()
    _M_PIPE_RESTARTS.inc()
    # incident trigger (runtime/blackbox.py): the break lands in the
    # flight-recorder ring and — debounced — snapshots ring + gauges +
    # thread stacks to the dump dir, so "which thread died holding how
    # much in flight" survives the restart. Runs on the dying thread,
    # no locks held, and never raises back into supervision.
    _bb.trigger("pipeline_break",
                thread=threading.current_thread().name,
                n_inflight=len(pending), error=repr(exc)[:200])
    for fut in pending:
        try:
            fut.set_exception(err)
        except InvalidStateError:
            pass  # resolved in the race window
    # sentinels for every loop; surviving threads drain to them and exit
    state.stage_q.put(_SHUTDOWN)
    state.dispatch_q.put(_SHUTDOWN)
    state.inflight_q.put(_SHUTDOWN)
    # wake anything parked on backpressure: ONE extra permit cascades
    state.stage_slots.release()
    state.depth_sem.release()
    _reap_broken_pipeline(state)


def _reap_broken_pipeline(state: _PipelineState):
    """Post-break cleanup, run on the dying thread: wait for the surviving
    loops to drain to their sentinels, then empty the dead queues —
    stranded in-flight records would otherwise pin card outputs and the
    executor for the life of the process — then re-put the sentinels, so
    a straggler that outlived the join timeout still exits, and join
    every slot's streams."""
    me = threading.current_thread()
    for t in state.threads:
        if t is not me:
            t.join(timeout=5)
    for q in (state.stage_q, state.dispatch_q, state.inflight_q):
        while True:
            try:
                q.get_nowait()
            except _queue.Empty:
                break
    state.stage_q.put(_SHUTDOWN)
    state.dispatch_q.put(_SHUTDOWN)
    state.inflight_q.put(_SHUTDOWN)
    # the stranded batches' copies and graph replays are still queued on
    # the slots' streams: let every slot's streams run dry before the
    # staging buffers and events they use are dropped. A break often
    # comes from a sticky CUDA error, which the join raises again: it is
    # recorded, never raised out of supervision
    for slot in state.slots:
        try:
            slot.join()
        except Exception as e:  # noqa: BLE001 - supervision boundary
            _bb.record("pipeline_reap_join_failed", level="error",
                       slot=slot.index, device=str(slot.device),
                       error=repr(e)[:200])


def _pipeline_thread(target, state: _PipelineState):
    """Thread entry for every pipeline loop: an escaped exception —
    including an injected :class:`~synapseml_tpu_torch.runtime.faults.ThreadKilled`
    — breaks the pipeline instead of dying silently with every in-flight
    future deadlocked."""
    try:
        target(state)
    except BaseException as e:  # noqa: BLE001 - supervision boundary
        _break_pipeline(state, e)


# pipelines still running at interpreter shutdown are drained while
# threading still works
_LIVE_PIPELINES: "weakref.WeakSet[_PipelineState]" = weakref.WeakSet()

# pipeline-depth gauges, sampled at snapshot time (never the hot path)
_tm.gauge_fn(
    "executor_inflight_batches",
    lambda: sum(s.inflight_q.qsize() for s in list(_LIVE_PIPELINES)))
_tm.gauge_fn(
    "executor_staging_queue_depth",
    lambda: sum(s.stage_q.qsize() for s in list(_LIVE_PIPELINES)))


@atexit.register
def _shutdown_all_pipelines():
    states = list(_LIVE_PIPELINES)
    for state in states:
        _shutdown_pipeline(state)
    for state in states:
        for t in state.threads:
            t.join(timeout=10)


class BatchedExecutor:
    """Runs ``fn(*bound_args, *arrays) -> arrays`` over row batches padded
    to shape buckets.

    ``fn`` must treat axis 0 of every batch argument as the batch axis; it
    receives tensors on ``device`` and returns a tensor, or a tuple, list
    or dict of them. The executor pads the batch to a bucket, runs ``fn``
    and slices the padding off the outputs. Host outputs come back as
    numpy arrays, except bfloat16 leaves, which numpy cannot hold: those
    are CPU ``torch.bfloat16`` tensors.

    - :meth:`submit` — returns an :class:`ExecutorFuture`.
    - :meth:`stream` — generator over an iterable of inputs, yielding
      results in order with ``pipeline_depth`` batches in flight.
    - ``__call__`` — submit + result.
    """

    def __init__(
        self,
        fn: Callable[..., Any],
        device: Union[str, torch.device, None] = None,
        compute_dtype: Any = None,
        min_bucket: int = 8,
        max_bucket: Optional[int] = None,
        static_batch: Optional[int] = None,
        bound_args: Tuple[Any, ...] = (),
        pipeline_depth: Optional[int] = None,
        transfer_batches: Union[int, str, None] = None,
        stage_workers: int = 2,
        device_outputs: Optional[Sequence[int]] = None,
        cache_key: Optional[str] = None,
        cache_dir: Optional[str] = None,
        devices: Union[None, str, int, Sequence[Any]] = None,
    ):
        """``device`` is "cuda" by default and raises without CUDA; the
        CPU runs only when asked for (``device="cpu"``).

        ``devices`` turns on data parallelism: ``"all"``, an int, or a
        device sequence (:func:`resolve_devices`), exclusive with
        ``device``. Each entry is a slot (see the module docstring): a
        bucket the slot count divides is sharded over the slots, any other
        lands whole on the next slot, round robin. A one-entry list is the
        pinned one-device path. ``pipeline_depth`` then defaults to the
        slot count + 1, so every slot can hold a round-robin bucket while
        the oldest drains.

        ``bound_args`` are prepended to every call unpadded — use for a
        weights tree (dicts, tuples, lists of arrays or tensors) or a
        :class:`PerDevice`: it goes to the device once, here, shared by
        every bucket; a slot on another device gets its own replica at its
        first use, and slots on one device share it. Construction
        then waits for the caller's current stream, so the bound args and
        anything the caller placed on the card before (weights ``fn``
        closes over) are ready for the executor's streams.

        ``compute_dtype`` (a torch dtype or "bfloat16", "float16",
        "float32") is the dtype floating host columns are staged in; the
        cast happens on the host while the chunk is copied into its
        staging buffer, so a bf16 batch crosses to the card at 2 bytes a
        value. A caller's card tensor is cast on the card.

        ``transfer_batches`` groups that many buckets into ONE host-to-card
        copy (compute then runs per bucket on card-side slices);
        ``"auto"`` sizes the group to ~32 MB per copy. Default 1. Over
        several slots the group shares one staging buffer and each bucket
        copies its own rows in on its slot's stream.

        ``stage_workers`` bounds the host-staging pool: that many batches'
        coerce+pad host work can proceed concurrently with dispatch and
        fetch of earlier batches.

        ``device_outputs`` lists output-leaf indices (position in the
        flattened output tree) that stay on the card: they resolve as
        card tensors, row-sliced lazily, ready to be fed back into the
        next ``submit`` (a sharded bucket's slices are joined in row order
        on the first slot's device). The drain still waits for the batch's
        events, so a resolved future means the leaf is computed. Such a
        leaf is marked used on the card's default stream
        (``record_stream``), so the caching allocator does not hand its
        block to the executor's stream while a caller's kernel on the
        default stream still reads it.

        ``cache_dir`` (default: the ``SYNAPSEML_COMPILE_CACHE`` env var)
        together with ``cache_key``, the caller's content hash over
        graph/weights config, enables the store that :meth:`warmup`
        records each warmed signature into, so a restarted process knows
        its warm programs reproduce the persisted ones
        (runtime/compile_cache.py). Any miss, skew or corrupt entry
        silently degrades to a fresh capture."""
        devs = resolve_devices(devices)
        if devs is not None and device is not None:
            raise ValueError("pass either device= or devices=, not both")
        if devs is not None and len(devs) == 1:
            device, devs = devs[0], None
        if devs is None:
            dev = device_policy.resolve(
                device_policy.DEFAULT_DEVICE if device is None else device)
            if dev.type == "cuda" and dev.index is None:
                dev = torch.device("cuda", torch.cuda.current_device())
        else:
            dev = devs[0]
        # the pinned device, or the first slot's: the bound args, the
        # store and the joined device_outputs live there
        self._device = dev
        self._devices = devs
        self._cuda = dev.type == "cuda"
        self._compute_dtype = _torch_dtype(compute_dtype)
        self._min_bucket = min_bucket
        self._max_bucket = max_bucket
        self._static_batch = static_batch
        if pipeline_depth is None:
            pipeline_depth = 2 if devs is None else len(devs) + 1
        self._depth = max(1, int(pipeline_depth))
        self._stage_workers = max(1, int(stage_workers))
        self._fn = fn
        self._bound = tuple(_to_device(b, dev) for b in bound_args)
        # what makes a PerDevice arg on another device (None: a tree the
        # first replica is copied from)
        self._makers = tuple(b if isinstance(b, PerDevice) else None
                             for b in bound_args)
        if self._cuda:
            torch.cuda.current_stream(dev).synchronize()
        if transfer_batches is None:
            transfer_batches = 1
        elif transfer_batches != "auto":
            transfer_batches = max(1, int(transfer_batches))
        self._transfer_batches = transfer_batches
        self._device_outputs = (frozenset(int(i) for i in device_outputs)
                                if device_outputs is not None
                                else frozenset())
        # holders of a staging buffer: the staging window (depth +
        # workers units) plus the batches in flight (depth)
        self._pool = (_PinnedPool(2 * self._depth + self._stage_workers)
                      if self._cuda else None)
        self._slots = tuple(_Slot(i, d)
                            for i, d in enumerate(devs or (dev,)))
        self._pipeline: Optional[_PipelineState] = None
        self._pipeline_init_lock = threading.Lock()
        # user-initiated close(): permanent, unlike a supervision break
        self._closed = False
        self._finalizer = None
        # dispatch counters: one series a round-robin slot, and one for
        # the pinned device or, over slots, the mesh label a sharded
        # bucket counts under once — the series sum to the batches. A
        # slot's label is "<device>#<slot>", so slots on one card differ
        if devs is not None:
            self._mesh_label = f"dp{len(devs)}"
            self._m_disp_rr = tuple(
                _tm.counter("executor_dispatch_total", device=f"{d}#{i}")
                for i, d in enumerate(devs))
        else:
            self._mesh_label = str(dev)
            self._m_disp_rr = ()
        self._m_disp_one = _tm.counter("executor_dispatch_total",
                                       device=self._mesh_label)
        self._m_bucket: Dict[int, _tm.Counter] = {}
        # -- the store and the warm programs --------------------------------
        resolved_dir = cache_dir if cache_dir is not None \
            else _cc.default_cache_dir()
        self._cache_key = cache_key
        self._store: Optional[_cc.ExecutableStore] = None
        if resolved_dir:
            _cc.enable_persistent_cache(resolved_dir)
            if cache_key:
                self._store = _cc.ExecutableStore(
                    os.path.join(resolved_dir, "executables"), device=dev)
        # _tables_lock guards the tables below: warmup() writes them on
        # the caller's thread, _dispatch reads and retires on the dispatch
        # thread. Slow work (capture, a run on zeros, a replica's copy)
        # happens OUTSIDE it.
        self._tables_lock = threading.Lock()
        # one replica of the bound args a distinct device of the slots
        # (lazy), and the round-robin cursor
        self._bound_rr: Dict[torch.device, tuple] = {dev: self._bound}
        self._rr_next = 0
        # warm programs from warmup(), keyed by (staged input signature of
        # the bucket, layout, slot index)
        self._aot: Dict[tuple, _Warm] = {}
        self._aot_hits = 0
        # recompile-sentinel state: warmup() flips _warmed and records
        # the call arities it warmed; _lazy_seen holds every (signature,
        # layout, slot) the eager path has already run (only FIRST runs
        # are timed and counted)
        self._warmed = False
        self._warm_arities: set = set()
        self._lazy_seen: set = set()
        # the H2D lane's verdict a host-column signature, read from the
        # lane's table on first sight (dispatch never probes)
        self._h2d_choice: Dict[tuple, str] = {}
        # CUDA graphs: one memory pool a slot, shared by the slot's
        # buckets' graphs. A graph captured later may hold its static
        # outputs in blocks that an earlier graph's capture used for
        # temporaries, so replaying ANY graph of the pool may overwrite
        # ANY graph's static outputs. Sharing is therefore safe only
        # while every graph's static outputs stay alive (the table holds
        # them), the slot's replays run on its one compute stream, and
        # each replay waits for the slot's ``released`` event. Two slots
        # replaying at once never share a pool, a graph or a static
        # buffer. A slot's replay lock keeps a capture (and its check
        # replay and digest copy) from interleaving with a replay call.

    @property
    def pipeline_depth(self) -> int:
        return self._depth

    @property
    def device(self) -> torch.device:
        """The pinned device, or the first slot's under ``devices=``."""
        return self._device

    @property
    def devices(self) -> Optional[Tuple[torch.device, ...]]:
        return self._devices

    @property
    def n_devices(self) -> int:
        return len(self._devices) if self._devices is not None else 1

    def _bucket(self, n: int) -> int:
        if self._static_batch is not None:
            return self._static_batch
        b = round_up_pow2(n, self._min_bucket)
        if self._max_bucket is not None:
            b = min(b, self._max_bucket)
        return b

    # -- data-parallel layout --------------------------------------------
    def _layout(self, bucket: int) -> str:
        """The layout of one bucket: ``"single"`` without ``devices``;
        ``"shard"`` when the bucket splits evenly over the slots (each
        slot runs ``bucket / n`` rows); ``"rr"`` otherwise (the whole
        bucket on the next slot, round robin)."""
        if self._devices is None:
            return "single"
        return "shard" if bucket % len(self._devices) == 0 else "rr"

    def _bound_for_device(self, dev: torch.device) -> tuple:
        """The bound args on ``dev``: one replica a distinct device, made
        at its first use. The copy runs outside the lock; a racing
        warmup/dispatch pair may both copy, ``setdefault`` crowns one
        winner so every caller shares the same tensors."""
        with self._tables_lock:
            got = self._bound_rr.get(dev)
        if got is None:
            got = tuple(_to_device(m or b, dev)
                        for b, m in zip(self._bound, self._makers))
            if dev.type == "cuda":
                torch.cuda.current_stream(dev).synchronize()
            with self._tables_lock:
                got = self._bound_rr.setdefault(dev, got)
        return got

    # -- pipeline plumbing ----------------------------------------------
    def _ensure_pipeline(self) -> _PipelineState:
        state = self._pipeline
        if state is not None and state.broken is None:
            return state
        with self._pipeline_init_lock:
            state = self._pipeline
            if (state is not None and state.broken is not None
                    and not self._closed):
                # supervision restart: the broken state already failed
                # its in-flight futures and its threads are exiting.
                # Detach the superseded finalizer: it would otherwise hold
                # the dead state for the life of the executor
                if self._finalizer is not None:
                    self._finalizer.detach()
                self._pipeline = state = None
            if state is None:
                state = _PipelineState(self._depth, self._stage_workers,
                                       self._slots)
                threads = [threading.Thread(
                    target=_pipeline_thread, args=(_stage_worker, state),
                    name=f"executor-stage-{i}", daemon=True)
                    for i in range(self._stage_workers)]
                threads.append(threading.Thread(
                    target=_pipeline_thread, args=(_dispatch_loop, state),
                    name="executor-dispatch", daemon=True))
                threads.append(threading.Thread(
                    target=_pipeline_thread, args=(_drain_loop, state),
                    name="executor-drain", daemon=True))
                state.threads = threads
                _LIVE_PIPELINES.add(state)
                for t in threads:
                    t.start()
                self._pipeline = state
                # reap the threads when the executor is dropped without
                # an explicit close()
                self._finalizer = weakref.finalize(
                    self, _shutdown_pipeline, state)
        return state

    def close(self, wait: bool = True):
        """Shut the pipeline down. Batches already submitted complete
        (their futures resolve); later :meth:`submit` calls raise.
        Idempotent; ``wait=True`` joins the pipeline threads."""
        with self._pipeline_init_lock:
            # _ensure_pipeline must never rebuild a broken pipeline after
            # (or while) close() marks the executor permanently closed
            self._closed = True
        state = self._pipeline
        if state is None:
            with self._pipeline_init_lock:
                # never-started pipeline: mark closed so submit refuses
                if self._pipeline is None:
                    self._pipeline = state = _PipelineState(
                        self._depth, self._stage_workers)
                    state.closed = True
                    return
                state = self._pipeline
        _shutdown_pipeline(state)
        if wait:
            for t in state.threads:
                t.join(timeout=60)

    def _on_device(self, a) -> bool:
        """A caller's tensor already on the executor's device type (padded
        and cast there); anything else is a host column."""
        return isinstance(a, torch.Tensor) and \
            a.device.type == self._device.type

    def _resolve_transfer_batches(self, host_arrays, bucket: int) -> int:
        tb = self._transfer_batches
        if tb != "auto":
            return tb
        # group buckets up to ~32MB per copy, by the staged row bytes
        row_bytes = 0
        for a in host_arrays:
            t = a if isinstance(a, torch.Tensor) else None
            shape = a.shape if hasattr(a, "shape") else np.shape(a)
            if t is not None:
                floating, itemsize = t.is_floating_point(), t.element_size()
            else:
                dt = np.asarray(a).dtype if not hasattr(a, "dtype") \
                    else np.dtype(a.dtype)
                floating = np.issubdtype(dt, np.floating)
                itemsize = min(dt.itemsize, 4)
            if floating and self._compute_dtype is not None:
                itemsize = self._compute_dtype.itemsize
            row_bytes += int(np.prod(shape[1:], dtype=np.int64)) * itemsize
        return max(1, (32 << 20) // max(1, bucket * row_bytes))

    def _stage_host(self, a, rows: int, users: int = 1) -> _HostBatch:
        """Coerce one host column into a staging buffer of ``rows`` rows
        (zero padding after the column's own), cast to the compute dtype
        on the way: pinned and from the pool on the card, a fresh tensor
        on the CPU (there ``fn``'s outputs may be views of it)."""
        src = _host_source(a)
        dt = (self._compute_dtype
              if self._compute_dtype is not None and src.is_floating_point()
              else src.dtype)
        shape = (max(rows, len(src)),) + tuple(src.shape[1:])
        buf = (self._pool.take(shape, dt) if self._pool is not None
               else torch.empty(shape, dtype=dt))
        buf[:len(src)].copy_(src)
        if len(src) < shape[0]:
            buf[len(src):].zero_()
        return _HostBatch(buf, users, self._pool)

    def _stage_host_chunk(self, arrays, n: int, bucket: int) -> list:
        """Host-side staging (the work the pool does off the dispatch
        thread): coerce + bucket-pad host inputs. Card-resident inputs
        pass through untouched, for ``_dispatch`` to pad and cast on the
        card."""
        staged = []
        for a in arrays:
            if self._on_device(a):
                staged.append(a)
                continue
            # never re-pad a padded tail
            rows = bucket if n < bucket and len(a) < bucket else len(a)
            hb = self._stage_host(a, rows)
            staged.append(_Rows(hb, 0, len(hb.host)))
        return staged

    def _stage_superchunk(self, host_arrays, sc_start: int, sc_stop: int,
                          bucket: int) -> List[tuple]:
        """super-chunk: ONE coerce+pad into one staging buffer an input,
        copied to the card by the first of its chunks' dispatches, then
        per-bucket compute on card-side slices."""
        sc_n = sc_stop - sc_start
        rows = -(-sc_n // bucket) * bucket
        starts = range(0, sc_n, bucket)
        columns = []
        for a in host_arrays:
            sl = a[sc_start:sc_stop]
            columns.append(sl if self._on_device(sl)
                           else self._stage_host(sl, rows, len(starts)))
        return [([c[b:b + bucket] if isinstance(c, torch.Tensor)
                  else _Rows(c, b, b + bucket) for c in columns],
                 min(bucket, sc_n - b), bucket)
                for b in starts]

    def _plan(self, host_arrays, n: int, bucket: int,
              spans: Optional[tuple] = None) -> List[_Unit]:
        """Split one logical call into ordered staging units."""
        if n == 0:
            # run one padded batch to learn output structure; slice to empty
            unit = _Unit(1, spans)
            unit.ex = self
            arrays = list(host_arrays)
            unit.stage = lambda: [(self._stage_host_chunk(arrays, 0, bucket),
                                   0, bucket)]
            return [unit]
        units: List[_Unit] = []
        tb = self._resolve_transfer_batches(host_arrays, bucket)
        super_rows = bucket * tb
        for sc_start in range(0, n, super_rows):
            sc_stop = min(sc_start + super_rows, n)
            sc_n = sc_stop - sc_start
            if tb == 1 or sc_n <= bucket:
                unit = _Unit(1, spans)
                unit.stage = (
                    lambda s=sc_start, e=sc_stop, m=sc_n:
                    [(self._stage_host_chunk(
                        [a[s:e] for a in host_arrays], m, bucket),
                      m, bucket)])
            else:
                unit = _Unit(-(-sc_n // bucket), spans)
                unit.stage = (
                    lambda s=sc_start, e=sc_stop:
                    self._stage_superchunk(host_arrays, s, e, bucket))
            unit.ex = self
            units.append(unit)
        return units

    # -- public API -----------------------------------------------------
    def submit(self, *host_arrays) -> ExecutorFuture:
        """Enqueue one logical batch; returns a future resolving to the
        same tuple ``__call__`` returns. Safe to call from any number of
        threads concurrently. Blocks only when the staging window
        (``pipeline_depth + stage_workers`` units) is full.

        Inputs are numpy arrays (or anything ``np.asarray`` takes), CPU
        tensors, or tensors on the executor's card. Staging reads them
        asynchronously: do not mutate them until the future resolves."""
        state = self._ensure_pipeline()
        _M_SUBMIT.inc()
        n = len(host_arrays[0])
        bucket = self._bucket(max(n, 1))
        spans = _tm.current_spans()
        after = None
        if self._cuda and any(self._on_device(a) for a in host_arrays):
            after = torch.cuda.Event()
            after.record(torch.cuda.current_stream(self._device))
        units = self._plan(host_arrays, n, bucket, spans)
        futs: List[Future] = []
        for unit in units:
            unit.after = after
            # slot acquisition happens OUTSIDE the lock: a large
            # multi-unit submission waiting for the pipeline to drain
            # must not convoy other callers' submits behind it
            state.stage_slots.acquire()
            with state.lock:
                if state.closed:
                    state.stage_slots.release()
                    if state.broken is not None and not self._closed:
                        # the narrow window between a thread dying and
                        # supervision swapping the pipeline
                        raise PipelineBrokenError(
                            "submitted during the pipeline-restart "
                            f"window: {state.broken}") from state.broken
                    raise RuntimeError("executor pipeline is closed")
                state.stage_q.put(unit)
                state.dispatch_q.put(unit)
                state.pending.update(unit.futs)
            for f in unit.futs:
                f.add_done_callback(
                    lambda f, s=state: _untrack_future(s, f))
            futs.extend(unit.futs)
        return ExecutorFuture(futs)

    def stream(self, items: Iterable) -> Iterator[tuple]:
        """Pipeline an iterable of inputs; yield result tuples in order.

        Each item is a tuple/list of arrays (or a single array).
        ``pipeline_depth`` items stay in flight, and the iterable is
        advanced lazily so a generator's per-item host work overlaps the
        card's."""
        pending: deque = deque()
        for item in items:
            arrays = tuple(item) if isinstance(item, (tuple, list)) \
                else (item,)
            pending.append(self.submit(*arrays))
            while len(pending) > self._depth:
                yield pending.popleft().result()
        while pending:
            yield pending.popleft().result()

    def __call__(self, *host_arrays) -> tuple:
        return self.submit(*host_arrays).result()

    # -- warm programs: warmup, the AOT table, the recompile sentinel -----
    def _bucket_ladder(self) -> List[int]:
        """Every bucket size this executor can route a batch to: the
        pow2 ladder from ``min_bucket`` up to the (possibly non-pow2)
        ``max_bucket`` cap, or the single static batch."""
        if self._static_batch is not None:
            return [self._static_batch]
        if self._max_bucket is None:
            raise ValueError(
                "warmup(buckets=None) needs a bounded executor "
                "(max_bucket= or static_batch=) to derive the bucket "
                "ladder — pass buckets= explicitly")
        top = self._bucket(self._max_bucket)
        out: List[int] = []
        b = self._min_bucket
        while b < top:
            out.append(b)
            b <<= 1
        out.append(top)
        return out

    def _mesh_shape(self) -> Tuple[int, ...]:
        """Folded into every store key: the slot count, so a 4-slot and
        an 8-slot warmup under one ``cache_key`` miss each other."""
        return (1,) if self._devices is None else (len(self._devices),)

    def _device_kind(self) -> str:
        if self._cuda:
            return torch.cuda.get_device_name(self._device)
        return "cpu"

    def _staged_dtype(self, dt: Any, device_rules: bool = False
                      ) -> torch.dtype:
        """The dtype staging hands ``_dispatch`` for an input of dtype
        ``dt``: the host coercions of :func:`coerce_host_array` (f64→f32,
        i64→i32, u64→u32), or with ``device_rules`` those of
        :meth:`_stage_device_array` (none); floating inputs then take the
        compute dtype."""
        td = getattr(torch, _cc.dtype_name(dt), None)
        if not isinstance(td, torch.dtype):
            raise TypeError(f"no torch dtype for {dt!r}")
        if not device_rules:
            td = _TORCH_COERCE.get(td, td)
        if self._compute_dtype is not None and td.is_floating_point:
            td = self._compute_dtype
        return td

    def warmup(self, args_like: Sequence[Any],
               buckets: Optional[Sequence[int]] = None) -> "_cc.WarmupReport":
        """Warm every bucket signature this executor will serve, on every
        slot, so no caller ever lands on a cold program — the reference's
        AOT precompile, rebuilt for the card as one CUDA graph a bucket
        and slot.

        ``args_like``: one entry per batch argument — an example array or
        tensor (leading dim = batch, any size; only ``shape[1:]`` and its
        dtype are read, a tensor on the executor's device under the card
        rules) or a ``(row_shape, dtype)`` pair. ``buckets`` defaults to
        the executor's full bucket ladder.

        Each target gets one report entry: a bucket of the ``"single"``
        layout, a sharded bucket (``"shard"``: one graph of ``bucket / n``
        rows on each slot, their outputs joined in row order), or a
        round-robin bucket on one slot (``"rr{i}"``: one graph of the
        whole bucket). Each graph is captured after one eager run on the
        slot's capture stream, then replayed once on zero-filled inputs;
        with a configured store (``cache_dir`` + ``cache_key``) the
        target's digest is checked against the persisted record
        (``loaded``) or persisted (``compiled``). Never raises for cache or
        capture problems — a target that fails serves eagerly, and the
        returned :class:`~synapseml_tpu_torch.runtime.compile_cache.WarmupReport`
        records each target's disposition (warm / loaded / compiled /
        error). From here on, an eager first run on the dispatch path is
        a counted recompile."""
        report = _cc.WarmupReport()
        specs: List[Tuple[Tuple[int, ...], torch.dtype]] = []
        for a in args_like:
            if hasattr(a, "shape") and hasattr(a, "dtype"):
                specs.append((tuple(a.shape)[1:], self._staged_dtype(
                    a.dtype, device_rules=self._on_device(a))))
            else:
                row, dt = a
                specs.append((tuple(int(d) for d in row),
                              self._staged_dtype(dt)))
        buckets = (self._bucket_ladder() if buckets is None
                   else sorted({int(b) for b in buckets}))
        for bucket in buckets:
            layout = self._layout(bucket)
            sig = tuple(((bucket,) + row, _cc.dtype_name(dt))
                        for row, dt in specs)
            if len(sig) > 1 and layout != "shard":
                # probe the H2D staging formulation for this signature
                # NOW — warmup is the pay-once moment; _dispatch only ever
                # reads the persisted verdict
                _h2d_lane().route(sig, self._slots[0].device)
            if layout == "shard":
                k = bucket // len(self._slots)
                targets = [("shard", self._slots,
                            tuple(((k,) + row, _cc.dtype_name(dt))
                                  for row, dt in specs))]
            elif layout == "rr":
                targets = [(f"rr{s.index}", (s,), sig) for s in self._slots]
            else:
                targets = [("single", self._slots, sig)]
            for store_layout, slots, slot_sig in targets:
                keys = [(sig, layout, s.index) for s in slots]
                entry: Dict[str, Any] = {"bucket": bucket,
                                         "layout": store_layout, "sig": sig}
                report.entries.append(entry)
                with self._tables_lock:
                    warm = all(key in self._aot for key in keys)
                if warm:
                    entry["status"] = "warm"
                    self._note_warm_sig(sig)
                    continue
                try:
                    skey = record = None
                    if self._store is not None:
                        skey = _cc.executable_key(
                            self._cache_key, bucket=bucket, sig=sig,
                            layout=store_layout,
                            mesh_shape=self._mesh_shape(),
                            device_kind=self._device_kind(),
                            fingerprint=self._store.fingerprint())
                        record = self._store.load(skey)
                    t0 = time.monotonic()
                    captured = [self._capture(slot_sig, s) for s in slots]
                    leaves = (captured[0][1] if len(captured) == 1
                              else _join_rows([c[1] for c in captured],
                                              bucket // len(captured)))
                    fresh = _cc.signature_record(sig, leaves,
                                                 _cc.output_digest(leaves))
                    seconds = time.monotonic() - t0
                    loaded = (record is not None
                              and self._store.matches(skey, record, fresh))
                    (_cc._M_DESER_S if loaded
                     else _M_COMPILE_WARM_S).observe(seconds)
                    with self._tables_lock:
                        for key, (program, _) in zip(keys, captured):
                            self._aot[key] = program
                    entry["status"] = "loaded" if loaded else "compiled"
                    entry["seconds"] = seconds
                    self._note_warm_sig(sig)
                    if skey is not None and not loaded:
                        entry["persisted"] = self._store.save(skey, fresh)
                except Exception as e:  # noqa: BLE001 - degrade to eager
                    entry["status"] = "error"
                    report.errors.append(
                        f"bucket={bucket} {store_layout}: {e!r}")
        # verdicts may have landed above: drop any dispatch-path H2D memo
        # taken before they did. The sentinel arms HERE: from now on an
        # eager first run on the dispatch path is a counted, classified
        # recompile incident
        with self._tables_lock:
            self._h2d_choice = {}
            self._warmed = True
        return report

    def _h2d_choice_for(self, hkey: tuple) -> str:
        """Dispatch-path verdict for one host-column signature: memoized
        per executor, filled from the lane's persisted table (a lookup
        only — a missing verdict serves ``per_arg``, it never probes under
        a live dispatch)."""
        got = self._h2d_choice.get(hkey)
        if got is None:
            got = _h2d_lane().cached(hkey, self._slots[0].device) \
                or "per_arg"
            with self._tables_lock:
                self._h2d_choice[hkey] = got
        return got

    def _coalesced_in(self, host: List[torch.Tensor], slot: _Slot,
                      leases: List["_HostBatch"]) -> List[torch.Tensor]:
        """The ``coalesced`` H2D formulation of one bucket's host columns
        on ``slot``: :func:`_coalesced_put` on the slot's copy-in stream,
        its staging buffers leased to the batch (back to the pool once it
        drains), the compute stream waiting for the copies."""
        if not self._cuda:
            return _coalesced_put(host, slot.device)[0]
        copy_in = slot.streams[1]
        with torch.cuda.stream(copy_in):
            views, held = _coalesced_put(host, slot.device, self._pool.take)
            ready = torch.cuda.Event()
            ready.record(copy_in)
        leases.extend(_HostBatch(buf, 1, self._pool) for buf in held)
        slot.compute.wait_event(ready)
        for v in views:
            v.record_stream(slot.compute)
        return views

    def _capture(self, sig: tuple, slot: _Slot) -> Tuple[_Warm, list]:
        """Build the warm program of one signature on one slot; returns it
        and the output leaves of its run on zero-filled inputs.

        On the card: zero-filled static inputs, one eager run on the
        slot's capture stream (lazy initialisation, cuDNN and cuBLAS plans
        and workspaces happen outside the capture), the capture into the
        slot's pool (``thread_local``: the dispatch thread may be issuing
        meanwhile), then one replay on the slot's compute stream, after
        whatever is queued there and after the slot's last batch's copies
        out of static outputs. The leaves returned are clones of that
        replay's outputs, taken on the compute stream before any later
        replay can overwrite them. The forward enters ``_ieee_float32``
        while it is captured, so a float32 graph keeps TF32 off in every
        replay whatever the flags are then."""
        shapes = [(shape, getattr(torch, name)) for shape, name in sig]
        bound = self._bound_for_device(slot.device)
        if not self._cuda:
            with torch.inference_mode():
                inputs = [torch.zeros(s, dtype=d) for s, d in shapes]
                leaves = _leaves(self._fn(*bound, *inputs))
            return _Warm(slot), leaves
        dev = slot.device
        with torch.cuda.device(dev), torch.inference_mode():
            side = slot.capture_stream
            if side is None:
                side = slot.capture_stream = torch.cuda.Stream(dev)
            inputs = [torch.zeros(s, dtype=d, device=dev) for s, d in shapes]
            side.wait_stream(torch.cuda.current_stream(dev))
            with torch.cuda.stream(side):
                self._fn(*bound, *inputs)
            graph = torch.cuda.CUDAGraph()
            with slot.replay_lock:
                if slot.pool is None:
                    slot.pool = torch.cuda.graph_pool_handle()
                try:
                    with torch.cuda.graph(
                            graph, pool=slot.pool, stream=side,
                            capture_error_mode="thread_local"):
                        out = self._fn(*bound, *inputs)
                except BaseException:
                    # a failed capture may leave its stream unusable
                    slot.capture_stream = None
                    raise
                statics = _leaves(out)
                compute = slot.compute
                compute.wait_stream(side)
                if slot.released is not None:
                    compute.wait_event(slot.released)
                with torch.cuda.stream(compute):
                    graph.replay()
                    leaves = [leaf.clone() if isinstance(leaf, torch.Tensor)
                              else leaf for leaf in statics]
                done = torch.cuda.Event()
                done.record(compute)
            done.synchronize()
        return _Warm(slot, graph, inputs, statics), leaves

    def _replay(self, warm: _Warm, padded: List[torch.Tensor]) -> list:
        """Run a warm program on one staged batch (or a slot's rows of
        it); returns its output leaves. On the card: after the slot's last
        batch's copies out of static outputs (``released``, whichever of
        the slot's graphs that batch replayed), copy the rows into the
        static inputs on the current stream (card to card) and replay."""
        slot = warm.slot
        if warm.graph is None:
            return _leaves(self._fn(*self._bound_for_device(slot.device),
                                    *padded))
        stream = torch.cuda.current_stream()
        if slot.released is not None:
            stream.wait_event(slot.released)
        for static, a in zip(warm.inputs, padded):
            static.copy_(a)
        with slot.replay_lock:
            warm.graph.replay()
        return list(warm.outputs)

    def _note_warm_sig(self, sig: tuple):
        """Record one warmed signature for the recompile sentinel's
        post-warmup classification (shape vs arity drift)."""
        with self._tables_lock:
            self._warm_arities.add(len(sig))

    def _classify_recompile(self, sig: tuple, retired: bool) -> str:
        """Why is the dispatch path running a cold signature after
        warmup? Called with ``_tables_lock`` held. ``donation_mask``
        cannot fire: the port does not donate."""
        if retired:
            return "cache_skew"
        if self._warm_arities and len(sig) not in self._warm_arities:
            return "arity"
        return "shape_drift"

    # -- pipeline stages (overridable/patchable per instance) ------------
    def _stage_device_array(self, a: torch.Tensor,
                            target_rows: int) -> torch.Tensor:
        """Pad/cast a caller's card tensor on the card (the dispatch
        thread's stream). The tensor is marked used on that stream, so
        the caching allocator keeps its block until the stream is past
        it."""
        if self._cuda:
            a.record_stream(torch.cuda.current_stream())
        if len(a) != target_rows:
            a = torch.cat([a, a.new_zeros(
                (target_rows - len(a),) + tuple(a.shape[1:]))])
        if (self._compute_dtype is not None and a.is_floating_point()
                and a.dtype != self._compute_dtype):
            a = a.to(self._compute_dtype)
        return a

    def _dispatch(self, arrays, n: int, bucket: int):
        """Start the host-to-card copy of the staged inputs on the copy-in
        stream (card-resident ones are padded and cast on the card), run
        ``fn`` on the compute stream after the copy's event, start the
        card-to-host copy of each host output into pinned memory on the
        copy-out stream after the compute's event, then record an event;
        returns without waiting for the card. A tensor made on one stream
        and read on another is marked used there (``record_stream``), so
        the caching allocator does not reuse its block early. Raw host
        arrays (not staged by the pool) are staged here.

        Under ``devices=`` the streams are the slots': a sharded bucket
        runs slot ``i``'s rows on slot ``i`` (copy in, replay, copy out,
        one event a slot) and is joined in row order; a round-robin bucket
        runs whole on the next slot. Either way this method stays ordered
        and non-blocking, so submission order, depth backpressure and
        :meth:`stream`'s order are untouched."""
        _F_LAT_DISPATCH.fire()
        layout = self._layout(bucket)
        if layout == "rr":
            with self._tables_lock:
                i = self._rr_next % len(self._slots)
                self._rr_next += 1
            self._m_disp_rr[i].inc()
            parts = [(self._slots[i], 0, bucket)]
        else:
            self._m_disp_one.inc()
            k = bucket // len(self._slots)
            parts = [(s, s.index * k, k) for s in self._slots]
        mc = self._m_bucket.get(bucket)
        if mc is None:  # first batch at this bucket: register the series
            mc = self._m_bucket.setdefault(bucket, _tm.counter(
                "executor_bucket_total", bucket=str(bucket)))
        mc.inc()
        _F_H2D.fire()
        columns: list = []
        leases: List[_HostBatch] = []
        for a in arrays:
            if not isinstance(a, _Rows):
                if self._on_device(a):
                    columns.append(self._stage_device_array(a, bucket))
                    continue
                rows = bucket if n < bucket and len(a) < bucket else len(a)
                hb = self._stage_host(a, rows)
                a = _Rows(hb, 0, len(hb.host))
            columns.append(a)
            leases.append(a.batch)
        _F_COMPUTE.fire()
        sig = tuple(_column_sig(c) for c in columns)
        home = self._slots[0]
        # a caller's card tensor was padded and cast on the first slot's
        # stream: the other slots wait for it there
        padded_on_home = None
        if self._cuda and len(self._slots) > 1 and any(
                isinstance(c, torch.Tensor) for c in columns):
            padded_on_home = torch.cuda.Event()
            padded_on_home.record(home.compute)
        ran = []
        outcomes = set()
        # the routed H2D formulation (lane "executor_h2d"): its verdict is
        # read from the memo / the persisted table — NEVER probed here;
        # warmup() is where the probe runs
        coalesced = {}
        host_idx = [i for i, c in enumerate(columns) if isinstance(c, _Rows)]
        if len(host_idx) > 1 and layout != "shard":
            host = [columns[i].batch.host[columns[i].start:
                                          columns[i].start + bucket]
                    for i in host_idx]
            hkey = tuple((tuple(h.shape), _cc.dtype_name(h.dtype))
                         for h in host)
            if self._h2d_choice_for(hkey) == "coalesced":
                coalesced = dict(zip(host_idx, self._coalesced_in(
                    host, parts[0][0], leases)))
        with torch.inference_mode():
            for slot, start, rows in parts:
                with slot.on_compute():
                    if padded_on_home is not None and slot is not home:
                        slot.compute.wait_event(padded_on_home)
                    padded = [coalesced[i] if i in coalesced
                              else self._slot_rows(c, slot, start, rows)
                              for i, c in enumerate(columns)]
                    leaves, warm, outcome = self._run_slot(
                        sig, layout, slot, padded, bucket)
                ran.append((slot, start, rows, leaves, warm))
                outcomes.add(outcome)
            if outcomes == {"hit"}:
                with self._tables_lock:
                    self._aot_hits += 1
                _M_AOT_HIT.inc()
            elif "miss" in outcomes:
                _M_AOT_MISS.inc()
            if not self._cuda:
                leaves = (ran[0][3] if len(ran) == 1 else
                          _join_rows([r[3] for r in ran], ran[0][2]))
                return _Flight(leaves, [], leases), n, bucket
            return self._copy_out(ran, bucket, leases), n, bucket

    def _slot_rows(self, col, slot: _Slot, start: int, rows: int):
        """Rows ``start:start + rows`` of one staged column, on the slot's
        device, ready on its compute stream (the current stream). A staged
        host column crosses on the slot's copy-in stream: with one slot
        the whole staging buffer once (the chunks of a ``transfer_batches``
        group share that copy), over several slots each slot only its own
        rows. A card column is sliced, and moved (counted) only when the
        slot is on another card."""
        if isinstance(col, _Rows):
            hb = col.batch
            lo = col.start + start
            if not self._cuda:
                return hb.host[lo:lo + rows]
            copy_in = slot.streams[1]
            if self._devices is None:
                if hb.device is None:
                    with torch.cuda.stream(copy_in):
                        hb.device = hb.host.to(slot.device,
                                               non_blocking=True)
                        hb.ready = torch.cuda.Event()
                        hb.ready.record(copy_in)
                    hb.device.record_stream(slot.compute)
                slot.compute.wait_event(hb.ready)
                return hb.device[lo:lo + rows]
            with torch.cuda.stream(copy_in):
                mine = hb.host[lo:lo + rows].to(slot.device,
                                                non_blocking=True)
                ready = torch.cuda.Event()
                ready.record(copy_in)
            mine.record_stream(slot.compute)
            slot.compute.wait_event(ready)
            return mine
        mine = col if rows == len(col) else col[start:start + rows]
        if mine.device != slot.device:
            _M_XDEV.inc()
            return mine.to(slot.device, non_blocking=True)
        if self._cuda and slot is not self._slots[0]:
            mine.record_stream(slot.compute)
        return mine

    def _run_slot(self, sig: tuple, layout: str, slot: _Slot,
                  padded: List[torch.Tensor], bucket: int):
        """One slot's share of a bucket: its warm program if it has one
        (``"hit"``), else the eager ``fn`` (``"miss"``); a program whose
        replay raises is retired and the rows run eagerly
        (``"retired"``). Returns the output leaves, the program replayed
        and that outcome."""
        key = (sig, layout, slot.index)
        with self._tables_lock:
            warm = self._aot.get(key)
        if warm is None:
            return self._run_cold(key, padded, False, bucket), None, "miss"
        try:
            # warmup()'s program: one replay, no per-node launches
            return self._replay(warm, padded), warm, "hit"
        except Exception:  # noqa: BLE001 - degrade, never error
            # retire the program and run eagerly: a genuine program error
            # re-raises from the eager call
            with self._tables_lock:
                self._aot.pop(key, None)
            _M_AOT_RETIRED.inc()
        return self._run_cold(key, padded, True, bucket), None, "retired"

    def _copy_out(self, ran: list, bucket: int,
                  leases: List[_HostBatch]) -> _Flight:
        """After each slot's compute, start the card-to-host copy of its
        host output leaves into its rows of one pinned buffer a leaf, on
        its copy-out stream, and record its event. The ``device_outputs``
        leaves are made on the compute stream of the first slot the bucket
        ran on, after every slot's compute: a sharded bucket's slices
        joined in row order (a
        slice on another card moved there, counted), a whole bucket's
        replayed leaf cloned (a later replay overwrites the static
        outputs). Each slot's copy-out waits for that, so its event — the
        slot's ``released`` when it replayed a graph, and what the drain
        waits on — covers every read of its outputs."""
        lead = ran[0][0]
        sharded = len(ran) > 1
        computed = []
        for slot, *_ in ran:
            ev = torch.cuda.Event()
            ev.record(slot.compute)
            computed.append(ev)
        leaves_out = list(ran[0][3])
        to_make = []
        for j in range(len(leaves_out)):
            pieces = [r[3][j] for r in ran]
            if not all(isinstance(p, torch.Tensor) and p.is_cuda
                       for p in pieces):
                if sharded:
                    leaves_out[j] = _join_leaf(pieces, ran[0][2])
                continue
            if sharded:
                _check_rows(pieces, ran[0][2])
            if j in self._device_outputs:
                if sharded or ran[0][4] is not None:
                    to_make.append(j)
            else:
                shape = ((bucket,) + tuple(pieces[0].shape[1:]) if sharded
                         else pieces[0].shape)
                leaves_out[j] = torch.empty(shape, dtype=pieces[0].dtype,
                                            pin_memory=True)
        made = None
        if to_make:
            with lead.on_compute():
                for ev in computed[1:]:
                    lead.compute.wait_event(ev)
                for j in to_make:
                    parts = []
                    for slot, _, _, leaves, _ in ran:
                        piece = leaves[j]
                        if piece.device != lead.device:
                            _M_XDEV.inc()
                            piece = piece.to(lead.device, non_blocking=True)
                        elif slot is not lead:
                            piece.record_stream(lead.compute)
                        parts.append(piece)
                    leaves_out[j] = (torch.cat(parts) if sharded
                                     else parts[0].clone())
                made = torch.cuda.Event()
                made.record(lead.compute)
        events = []
        for (slot, start, rows, leaves, warm), ev in zip(ran, computed):
            copy_out = slot.streams[2]
            with torch.cuda.stream(copy_out):
                copy_out.wait_event(ev)
                if made is not None:
                    copy_out.wait_event(made)
                for j, leaf in enumerate(leaves):
                    if (j in self._device_outputs
                            or not isinstance(leaf, torch.Tensor)
                            or not leaf.is_cuda):
                        continue
                    host = (leaves_out[j][start:start + rows] if sharded
                            else leaves_out[j])
                    host.copy_(leaf, non_blocking=True)
                    leaf.record_stream(copy_out)
                done = torch.cuda.Event()
                done.record(copy_out)
            events.append(done)
            if warm is not None:
                slot.released = done
        return _Flight(leaves_out, events, leases)

    def _run_cold(self, key: tuple, padded: List[torch.Tensor],
                  retired: bool, bucket: int) -> list:
        """The eager path of a (signature, layout, slot) without a warm
        program. Its first run is timed into ``executor_compile_seconds
        {phase="dispatch"}``; after :meth:`warmup` it is also counted in
        ``executor_recompiles_total`` by reason — an incident, not a
        mystery latency spike. A sharded bucket counts once a slot."""
        sig, layout, index = key
        slot = self._slots[index]
        with self._tables_lock:
            unseen = key not in self._lazy_seen
            if unseen:
                self._lazy_seen.add(key)
            reason = (self._classify_recompile(sig, retired)
                      if unseen and self._warmed else None)
        t0 = time.monotonic()
        try:
            out = self._fn(*self._bound_for_device(slot.device), *padded)
        except BaseException:
            if unseen:
                # a first run that RAISED is not a warm signature: the
                # retry is still counted and timed
                with self._tables_lock:
                    self._lazy_seen.discard(key)
            raise
        if unseen:
            dt = time.monotonic() - t0
            _M_COMPILE_DISP_S.observe(dt)
            if reason is not None:
                _M_RECOMPILE[reason].inc()
                _bb.record(
                    "recompile", level="warn", reason=reason,
                    bucket=bucket, layout=layout, device=str(slot.device),
                    slot=index, seconds=round(dt, 6),
                    signature=repr(sig)[:240])
        return _leaves(out)

    def _fetch(self, out: _Flight, n: int, bucket: int):
        """Wait for one batch (its events, one a slot it ran on: the
        drain thread's only wait on the card), give its staging buffers
        back, and slice the padding
        off each output leaf. A leaf whose leading dim is NOT the batch
        axis cannot be row-sliced, and doing it silently would mis-assign
        rows — fail with a recipe instead.

        Leaves listed in ``device_outputs`` stay card tensors, row-sliced
        lazily when the bucket padded."""
        for event in out.events:
            event.synchronize()
        for hb in out.leases:
            hb.release()
        leaves = []
        for i, leaf in enumerate(out.leaves):
            if i in self._device_outputs and isinstance(leaf, torch.Tensor):
                if leaf.is_cuda:
                    leaf.record_stream(
                        torch.cuda.default_stream(leaf.device))
                leaves.append(leaf)
            elif isinstance(leaf, torch.Tensor):
                leaf = leaf.cpu()
                leaves.append(leaf if leaf.dtype == torch.bfloat16
                              else leaf.numpy())
            else:
                leaves.append(np.asarray(leaf))
        trimmed = []
        for l in leaves:
            if np.ndim(l) == 0:
                raise ValueError(
                    "executor outputs must carry a batch axis: a scalar "
                    "output aggregates over the PADDING rows of the "
                    f"bucket ({bucket} padded vs {n} real) — keep a "
                    "leading batch dim and reduce outside the executor")
            if len(l) == bucket:
                trimmed.append(l[:n])
            elif len(l) <= n:
                # smaller-than-batch outputs were never sliced before;
                # keep the pass-through (no row mis-assignment occurs)
                trimmed.append(l)
            else:
                raise ValueError(
                    f"executor output with leading dim {len(l)} is not "
                    f"batch-aligned (batch bucket {bucket}, {n} real "
                    "rows): per-row slicing would silently mis-assign "
                    "rows. Batch-align it in-graph — e.g. Reshape "
                    "NonMaxSuppression's [B*C*max_out, 3] output to "
                    "[B, C*max_out, 3] before the graph output.")
        return tuple(trimmed)


# -- autotuned H2D staging lane ---------------------------------------------
#
# Lane "executor_h2d": whether a multi-argument bucket's host columns ride
# one copy a dtype group (a host memcpy into one pinned staging buffer, one
# copy to the card, views out) or the per-column copy loop. Per-column pays
# one copy launch a column; the coalesced form pays one host memcpy + one
# launch — which side wins is a property of the column count, sizes and the
# box's transfer path, so it is a MEASURED verdict keyed by the full staged
# signature and the card. Probed from warmup() only; _dispatch consults the
# persisted verdict via a per-executor memo. Verification is bit-exact per
# element and dtype — pure data movement. Both candidates' results stay on
# the card: best_of waits for them there and never copies them back.

def _coalesced_put(arrays: Sequence[torch.Tensor], device: torch.device,
                   take: Optional[Callable] = None):
    """One copy a dtype group of host tensors to ``device``; a group of one
    goes direct. Returns (the device tensors, views of one packed copy a
    group, in order; the staging buffers, which must outlive the copies).
    ``take(shape, dtype)`` gives a staging buffer (pinned, from the
    executor's pool on the card); by default a fresh one, pinned where
    ``device`` is a card."""
    out: List[Optional[torch.Tensor]] = [None] * len(arrays)
    groups: Dict[torch.dtype, List[int]] = {}
    for i, a in enumerate(arrays):
        groups.setdefault(a.dtype, []).append(i)
    held = []
    for dt, idxs in groups.items():
        if len(idxs) == 1:
            out[idxs[0]] = arrays[idxs[0]].to(device, non_blocking=True)
            continue
        total = sum(arrays[i].numel() for i in idxs)
        if take is not None:
            buf = take((total,), dt)
        else:
            buf = torch.empty((total,), dtype=dt,
                              pin_memory=device.type == "cuda")
        off = 0
        for i in idxs:
            size = arrays[i].numel()
            buf[off:off + size].copy_(arrays[i].reshape(-1))
            off += size
        packed = buf.to(device, non_blocking=True)
        held.append(buf)
        off = 0
        for i in idxs:
            size = arrays[i].numel()
            out[i] = packed[off:off + size].view(arrays[i].shape)
            off += size
    return out, held


def _h2d_args(sig, dev: torch.device):
    rng = np.random.default_rng(0)
    out = []
    for shape, name in sig:
        td = getattr(torch, name)
        if td.is_floating_point:
            a = torch.from_numpy(rng.standard_normal(shape)).to(td)
        else:
            a = torch.from_numpy(rng.integers(0, 2, shape)).to(td)
        out.append(a.pin_memory() if dev.type == "cuda" else a)
    return (out,)


def _h2d_verify(got, want) -> bool:
    if len(got) != len(want):
        return False
    return all(g.dtype == w.dtype and g.shape == w.shape
               and np.array_equal(g, w) for g, w in zip(got, want))


_H2D_LANE = None
_H2D_LOCK = threading.Lock()


def _h2d_lane():
    """Lazy registration — the lane costs nothing until an executor with
    a multi-argument signature warms up. Route args: (signature, device)."""
    global _H2D_LANE
    with _H2D_LOCK:
        if _H2D_LANE is None:
            from synapseml_tpu_torch.runtime import autotune as _at

            _H2D_LANE = _at.register_lane(
                "executor_h2d",
                key_fn=lambda sig, dev: (
                    _at.key_prefix("h2d", dev) + "|" + ";".join(
                        f"{'x'.join(str(d) for d in s)}:{t}"
                        for s, t in sig)),
                candidates={
                    "per_arg": lambda rargs, args: (
                        lambda arrs: tuple(a.to(rargs[1], non_blocking=True)
                                           for a in arrs)),
                    "coalesced": lambda rargs, args: (
                        lambda arrs: tuple(
                            _coalesced_put(arrs, rargs[1])[0])),
                },
                verify_fn=_h2d_verify,
                reference="per_arg",
                args_fn=_h2d_args,
            )
        return _H2D_LANE


class JitCache:
    """Explicit cache of built callables (executors) keyed by a user key:
    one warm executor shared by every batch on a host, as the reference
    shares one jitted executable (ref: ONNXModel.scala:497-508)."""

    def __init__(self):
        self._cache: Dict[Any, Callable] = {}
        self._lock = threading.Lock()

    def get(self, key: Any, build: Callable[[], Callable]) -> Callable:
        # callers come from arbitrary scorer threads: build() runs
        # outside the lock and setdefault crowns one winner for everyone
        with self._lock:
            got = self._cache.get(key)
        if got is None:
            built = build()
            with self._lock:
                got = self._cache.setdefault(key, built)
        return got

    def clear(self):
        """Drop cached callables AND invalidate every open store: a test
        that clears caches must not read back a memoized (possibly
        stale) record — the next load re-reads disk."""
        with self._lock:
            self._cache.clear()
        _cc.invalidate_open_stores()


GLOBAL_JIT_CACHE = JitCache()


def default_device() -> torch.device:
    """The card the entry points run on by default (raises without
    CUDA, as every entry point does)."""
    device_policy.resolve()
    return torch.device("cuda", torch.cuda.current_device())


def local_device_count() -> int:
    return torch.cuda.device_count() if torch.cuda.is_available() else 0

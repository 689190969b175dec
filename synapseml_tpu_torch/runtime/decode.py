"""Iteration-level continuous batching for autoregressive decode (the
Orca OSDI'22 scheduling discipline over this repo's executor stack).

The port's counterpart of the reference package's ``runtime/decode.py``:
the same scheduler, the same ``SYNAPSEML_DECODE_*`` / ``SYNAPSEML_KV_*``
environment defaults and the same metric names, with every step run
through the port's :class:`BatchedExecutor` on the card.

The serving layers batch *stateless* requests: every request is one
executor call. Autoregressive decode is the opposite workload — a
sequence is hundreds of tiny dependent steps — and static request
batching wastes most of the machine on it: a batch formed at admission
time runs until its LONGEST member finishes, so every short sequence's
slot decodes dead air. This module schedules at the *iteration* level
instead: each loop pass assembles one mixed batch — prefill chunks for
newly admitted sequences, single-token steps for running ones — so a
finished sequence's slot is refilled on the very next iteration.

Fixed geometry
--------------
Every executor call has a warmup-time shape signature, each captured as
one CUDA graph by :meth:`DecodeScheduler.warmup` (the recompile sentinel
stays silent in steady state):

- one **decode signature** per KV bucket: ``ids [B, 1]``,
  ``seqlens [B]``, per-layer KV buffers ``[B, Hkv, T, D]``;
- one **prefill signature** per KV bucket: the same with
  ``ids [B, S_pre]`` (``S_pre`` = the fixed prefill chunk);
- ``T`` walks a pow2-of-pages ladder (``page_size * 2^k`` capped at
  ``max_seq``), growing only when the longest live row crosses a
  bucket.

The model graph must use the share-buffer attention layout
(``GroupQueryAttention`` with ``past_present_share_buffer=1`` — see
onnx/importer.py): past buffers keep their bucket shape across steps,
new K/V scatter at each row's ``seqlens_k``-derived write position, and
per-row frontier masks keep junk slots (batch padding, right-padded
prefill tails, evicted predecessors' leftovers) out of every softmax.
Prompts longer than one chunk prefill chunk by chunk; the final partial
chunk re-feeds the tail of the previous chunk (left-overlap) so its
write position stays exact — recomputing a suffix writes the same keys,
so overlap is free.

Both phases run through ONE :class:`BatchedExecutor` whose
``device_outputs`` keeps every present-KV leaf on the card — only the
logits cross to the host each step, and they are the loop's only read
back. Rows not participating in a call (idle slots during prefill,
prefilling slots during decode) get their buffer rows restored by a
per-row ``torch.where`` merge, because the graph's scatter writes all B
rows unconditionally; a call in which every row took part keeps the new
buffers as they are.

Streams: the scheduler thread makes the merged, grown and zeroed
buffers on its current stream; ``submit`` records an event there that
the executor's compute stream waits for, and marks each buffer used on
that stream (``record_stream``), so the caching allocator keeps a
superseded buffer's block until the replay that reads it is done. The
present buffers come back as clones made on the compute stream, marked
used on the default stream, and complete when ``result()`` returns.

Eviction = recompute
--------------------
KV capacity is policy, not hope: a :class:`PagedKVCache`
(runtime/kvcache.py) accounts fixed-size pages per sequence against a
budget sized off the perfwatch device-memory records. When admission
or growth does not fit — or while the ``hbm_high_water`` latch holds —
the LRU resident sequence is evicted whole: its pages free, its slot
clears, and it re-enters the admission queue carrying prompt +
everything generated so far. Re-prefilling that history reproduces the
same greedy token stream (argmax over well-separated logits absorbs the
chunk-vs-step float formulation difference), so eviction costs
recompute time, never correctness.

Static-batching A/B: ``static_batching=True`` runs the same machinery
under the admission-time discipline (admit only into an empty batch,
hold every slot until the whole batch finishes) — the honest baseline.

Two refusals the reference does not make (ROADMAP Queue 3), because on
the card either would be a device-side assert that ends the process:
``submit`` refuses a token outside ``[0, vocab)`` (the reference's
``Gather`` reads a NaN embedding row for it and argmax then emits token
0; ``vocab`` is the rows of the embedding table the ids are gathered
from, else the logits output's last dimension, and a graph that gives
neither is refused), and
the constructor refuses ``prefill_chunk > page_size`` (the ladder's
first rung would hold a prefill chunk longer than its buffer, where the
reference's warmup fails on a shape error).
"""
from __future__ import annotations

import functools
import os
import queue
import threading
import time
from collections import deque
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from synapseml_tpu_torch import device as device_policy
from synapseml_tpu_torch.onnx.proto import node_attrs
from synapseml_tpu_torch.runtime import blackbox as _bb
from synapseml_tpu_torch.runtime import kvcache as _kvc
from synapseml_tpu_torch.runtime import structlog as _slog
from synapseml_tpu_torch.runtime import telemetry as _tm
from synapseml_tpu_torch.runtime.executor import (BatchedExecutor,
                                                  PerDevice,
                                                  resolve_devices)

__all__ = ["DecodeScheduler", "DecodeHandle"]

# token buckets for the per-step histograms: decode steps are small and
# fast; the default latency buckets top out too coarse at the low end
_STEP_BUCKETS = (0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1,
                 0.25, 0.5, 1.0, 2.5)
# the executor's counter of card tensors moved between devices
_M_XDEV = _tm.counter("executor_cross_device_copies_total")


class DecodeHandle:
    """Caller's end of one sequence: a token queue plus final state.

    Iterate to stream tokens as the scheduler emits them, or call
    :meth:`result` to block for the whole generation. Thread-safe for
    one consumer."""

    def __init__(self, seq_id: str, prompt_len: int):
        self.seq_id = seq_id
        self.prompt_len = prompt_len
        self._q: "queue.Queue[Tuple[str, Any]]" = queue.Queue()
        self._tokens: List[int] = []
        self._finish_reason: Optional[str] = None
        self._error: Optional[BaseException] = None

    # scheduler side -----------------------------------------------------
    def _emit(self, token: int) -> None:
        self._q.put(("tok", int(token)))

    def _finish(self, reason: str) -> None:
        self._q.put(("done", reason))

    def _fail(self, exc: BaseException) -> None:
        self._q.put(("err", exc))

    # consumer side ------------------------------------------------------
    # The queue is the synchronization point: the scheduler only ever
    # puts, the one consumer only ever gets, and these fields belong to
    # the consumer's side of that handoff.
    def __iter__(self):
        while True:
            kind, val = self._q.get()
            if kind == "tok":
                self._tokens.append(val)
                yield val
            elif kind == "done":
                self._finish_reason = val
                return
            else:
                self._error = val
                raise val

    def result(self, timeout: Optional[float] = None
               ) -> Tuple[List[int], str]:
        """Block until the sequence finishes; returns
        ``(generated_tokens, finish_reason)``."""
        deadline = None if timeout is None else time.monotonic() + timeout
        while self._finish_reason is None and self._error is None:
            left = None if deadline is None \
                else max(0.0, deadline - time.monotonic())
            try:
                kind, val = self._q.get(timeout=left)
            except queue.Empty:
                raise TimeoutError(
                    f"decode sequence {self.seq_id} did not finish in "
                    f"{timeout}s") from None
            if kind == "tok":
                self._tokens.append(val)
            elif kind == "done":
                self._finish_reason = val
            else:
                self._error = val
        if self._error is not None:
            raise self._error
        return list(self._tokens), self._finish_reason or "completed"

    @property
    def finish_reason(self) -> Optional[str]:
        return self._finish_reason


class _Seq:
    __slots__ = ("id", "tokens", "prompt_len", "max_new", "deadline",
                 "handle", "state", "cached", "produced", "slot",
                 "arrival", "admitted_at", "recomputes")

    def __init__(self, seq_id: str, tokens: List[int], max_new: int,
                 deadline: Optional[float], handle: DecodeHandle):
        self.id = seq_id
        self.tokens = tokens          # prompt + everything generated
        self.prompt_len = len(tokens)
        self.max_new = max_new
        self.deadline = deadline      # absolute time.monotonic(), or None
        self.handle = handle
        self.state = "waiting"        # waiting -> prefill -> decode
        self.cached = 0               # tokens covered by the KV buffer
        self.produced = 0             # generated tokens emitted
        self.slot: Optional[int] = None
        self.arrival = time.monotonic()
        self.admitted_at: Optional[float] = None
        self.recomputes = 0


class DecodeScheduler:
    """Continuous-batching decode over one imported decoder graph.

    ``graph``: an ``ImportedGraph`` (onnx/importer.py) in the
    share-buffer layout — inputs ``input_ids [B,S]``, ``seqlens_k [B]``
    and per-layer ``past_key_*/past_value_* [B, Hkv, T, D]`` pairs,
    outputs logits first then the matching present pairs (the shape
    ``tiny_decoder`` in onnx/zoo.py builds and ORT-GenAI exports
    carry). Geometry, capacity, and policy knobs default from the
    ``SYNAPSEML_DECODE_*`` / ``SYNAPSEML_KV_*`` environment.

    ``device`` is "cuda" by default and raises without CUDA; the CPU
    runs only when asked for (``device="cpu"``). The graph's float
    parameters go to it once, here (``ImportedGraph.bind``).
    ``devices=`` (a spec of :func:`~synapseml_tpu_torch.runtime.executor.resolve_devices`
    whose entries are on ``device``'s type) runs every step data-parallel:
    a slot count that divides ``max_batch`` shards the static batch (the
    present buffers come back joined in row order on the first slot's
    device), any other runs each step whole on the next slot; the
    parameters are bound once a distinct device. A buffer that must move
    to another card is counted in ``executor_cross_device_copies_total``."""

    def __init__(self, graph, *, name: str = "decode",
                 max_batch: Optional[int] = None,
                 prefill_chunk: Optional[int] = None,
                 page_size: Optional[int] = None,
                 max_seq: Optional[int] = None,
                 capacity_bytes: Optional[int] = None,
                 max_waiting: Optional[int] = None,
                 static_batching: bool = False,
                 devices=None, cache_key: Optional[str] = None,
                 cache_dir: Optional[str] = None,
                 device: str | torch.device = device_policy.DEFAULT_DEVICE):
        self.name = name
        self.B = int(max_batch if max_batch is not None
                     else os.environ.get(
                         "SYNAPSEML_DECODE_MAX_BATCH", "4"))
        self.S_pre = int(prefill_chunk if prefill_chunk is not None
                         else os.environ.get(
                             "SYNAPSEML_DECODE_PREFILL_CHUNK", "16"))
        self.page = int(page_size if page_size is not None
                        else os.environ.get("SYNAPSEML_KV_PAGE", "16"))
        self.max_seq = int(max_seq if max_seq is not None
                           else os.environ.get(
                               "SYNAPSEML_DECODE_MAX_SEQ", "128"))
        self.max_waiting = int(
            max_waiting if max_waiting is not None
            else os.environ.get("SYNAPSEML_DECODE_MAX_WAITING", "256"))
        self.wait_slo_s = float(os.environ.get(
            "SYNAPSEML_DECODE_WAIT_SLO_MS", "500")) / 1e3
        self.static_batching = bool(static_batching)
        if self.B < 1 or self.S_pre < 1 or self.page < 1:
            raise ValueError("max_batch, prefill_chunk and page_size "
                             "must be positive")
        if self.max_seq < self.S_pre:
            raise ValueError(f"max_seq={self.max_seq} below the prefill "
                             f"chunk {self.S_pre}")
        if self.S_pre > self.page:
            # the ladder's first rung (one page) would hold a prefill
            # chunk longer than its buffer: the graph's write start
            # T - S is negative there, a device-side assert on the card
            raise ValueError(
                f"prefill_chunk={self.S_pre} exceeds page_size="
                f"{self.page}: the first KV bucket (one page) must hold "
                "a whole prefill chunk")

        self._g = graph
        (self._ids_name, self._seqlens_name, self._kv_names,
         self._kv_shapes) = self._introspect(graph)
        self.n_layers = len(self._kv_names) // 2
        _, self.kv_heads, _, self.head_dim = self._kv_shapes[0]
        self.vocab = self._vocab(graph, self._ids_name)
        dev = device_policy.resolve(device)
        if dev.type == "cuda" and dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
        devs = resolve_devices(devices)
        if devs is not None and any(d.type != dev.type for d in devs):
            raise ValueError(
                f"devices={devices!r} name {[str(d) for d in devs]}, but "
                f"the scheduler runs on {dev.type!r}")
        if devs is not None:
            dev = devs[0]
        self.device = dev
        order = {nm: i for i, nm in enumerate(graph.input_names)}
        names = [self._ids_name, self._seqlens_name] + self._kv_names
        missing = [nm for nm in graph.input_names if nm not in names]
        if missing:
            raise ValueError(f"missing graph inputs: {missing}")
        slots = [order[nm] for nm in names]

        def _apply(forward, ids, seqlens, *kv):
            args: List[Any] = [None] * len(slots)
            for i, a in zip(slots, (ids, seqlens) + kv):
                args[i] = a
            return forward(*args)

        n_out = 1 + len(self._kv_names)
        # the weights go to the device first (the executor binds them on
        # each distinct device of its slots): the KV budget below reads
        # the device's memory, and a CUDA process is initialised by then
        self._ex = BatchedExecutor(
            _apply, device=None if devs else dev, devices=devs,
            bound_args=(PerDevice(lambda d: graph.bind(device=d)),),
            static_batch=self.B, cache_key=cache_key, cache_dir=cache_dir,
            device_outputs=range(1, n_out))
        # one step on the first device's weights, outside the executor
        self._fn = functools.partial(_apply,
                                     *self._ex._bound_for_device(dev))
        kv_itemsize = 4  # f32 buffers (graph dtype)
        bytes_per_token = (len(self._kv_names) * self.kv_heads
                           * self.head_dim * kv_itemsize)
        self.kv = _kvc.PagedKVCache(self.page, bytes_per_token,
                                    capacity_bytes=capacity_bytes,
                                    name=name)
        # KV bucket ladder: page * 2^k, capped at (and always including)
        # max_seq — every captured T the scheduler can ever run
        ladder = []
        t = self.page
        while t < self.max_seq:
            ladder.append(t)
            t <<= 1
        ladder.append(self.max_seq)
        self.t_ladder = ladder

        # live batch state (loop thread only)
        self._slots: List[Optional[_Seq]] = [None] * self.B
        self._kv_bufs: Optional[List[torch.Tensor]] = None
        self._t_bucket = self.t_ladder[0]
        self._seqs: Dict[str, _Seq] = {}

        self._cv = threading.Condition()
        self._waiting: deque = deque()
        self._stop = False
        self._thread: Optional[threading.Thread] = None
        self._seq_counter = 0
        self._warmed = False

        # telemetry (the reference's "Decode serving" series)
        self._m_seqs = _tm.counter("decode_sequences_total", server=name)
        self._m_tokens = _tm.counter("decode_tokens_total", server=name)
        self._m_steps = {
            ph: _tm.counter("decode_steps_total", server=name, phase=ph)
            for ph in ("prefill", "decode")}
        self._m_step_s = {
            ph: _tm.histogram("decode_step_seconds",
                              buckets=_STEP_BUCKETS, server=name,
                              phase=ph)
            for ph in ("prefill", "decode")}
        self._m_ttft = _tm.histogram("decode_ttft_seconds", server=name)
        self._m_wait = _tm.histogram("decode_queue_wait_seconds",
                                     server=name)
        self._m_finished: Dict[str, _tm.Counter] = {}
        _tm.gauge_fn("decode_active_sequences",
                     lambda: float(sum(s is not None
                                       for s in self._slots)),
                     server=name)
        _tm.gauge_fn("decode_waiting_sequences",
                     lambda: float(len(self._waiting)), server=name)
        # the autoscaler's starvation signal: recent admission wait as
        # a burn rate against the wait SLO — duty-cycle alone misreads
        # a decode fleet whose short steps keep chips busy while the
        # admission queue ages out
        self._wait_window: deque = deque()  # (ts, wait_s)
        _tm.gauge_fn("decode_queue_wait_burn", self._wait_burn,
                     server=name)

    # -- graph introspection --------------------------------------------
    @staticmethod
    def _introspect(graph):
        ids_name = seqlens_name = None
        kv: List[Tuple[str, List[Optional[int]]]] = []
        for nm in graph.input_names:
            dtype, shape = graph.input_info.get(nm, (None, []))
            low = nm.lower()
            if "past" in low and ("key" in low or "value" in low):
                kv.append((nm, shape))
            elif seqlens_name is None and "seqlens" in low:
                seqlens_name = nm
            elif ids_name is None and len(shape) == 2:
                ids_name = nm
        if ids_name is None or seqlens_name is None or not kv:
            raise ValueError(
                "DecodeScheduler needs a share-buffer decoder graph: "
                "token ids [B,S], seqlens_k [B], and past_key/past_value "
                f"buffer pairs — got inputs {graph.input_names}. "
                "Graphs without seqlens_k (plain concat KV exports) "
                "serve through ONNXModel, not the decode scheduler.")
        if len(kv) % 2:
            raise ValueError(f"unpaired past KV inputs: {[n for n, _ in kv]}")
        shapes = []
        for nm, shape in kv:
            if len(shape) != 4 or shape[1] is None or shape[3] is None:
                raise ValueError(
                    f"past buffer {nm} must be [B, Hkv, T, D] with "
                    f"concrete Hkv/D, got {shape}")
            shapes.append(shape)
        if len({(s[1], s[3]) for s in shapes}) != 1:
            raise ValueError("past buffers disagree on [Hkv, D]: "
                             f"{shapes}")
        return ids_name, seqlens_name, [n for n, _ in kv], shapes

    @staticmethod
    def _vocab(graph, ids_name: str) -> int:
        """The token ids' range: the rows of the embedding table that a
        ``Gather`` takes them from, else the logits output's last
        dimension. A graph that gives neither is refused, since an id
        past the table would be a device-side assert on the card."""
        tables = {**graph.static_params, **graph.params}
        rows = [tables[n.input[0]].shape[0] for n in graph.graph.node
                if n.op_type == "Gather" and list(n.input[1:2]) == [ids_name]
                and n.input[0] in tables
                and int(node_attrs(n).get("axis") or 0) == 0]
        if rows:
            return int(min(rows))
        out = graph.graph.output[0]
        tt = out.type.tensor_type if out.type is not None else None
        dims = list(tt.shape.dim) if tt is not None and \
            tt.shape is not None else []
        if dims and dims[-1].dim_value:
            return int(dims[-1].dim_value)
        raise ValueError(
            f"cannot bound the token ids: no Gather takes {ids_name!r} "
            "from an embedding initializer and the logits output's last "
            "dimension is symbolic")

    # -- device helpers: merge, grow, zeros ------------------------------
    def _zeros(self, t: int) -> List[torch.Tensor]:
        with torch.inference_mode():
            return [torch.zeros((self.B, self.kv_heads, t, self.head_dim),
                                dtype=torch.float32, device=self.device)
                    for _ in range(len(self._kv_names))]

    def _grow(self, kv: List[torch.Tensor], pad: int) -> List[torch.Tensor]:
        """Zero-extend every buffer's T axis by ``pad``."""
        with torch.inference_mode():
            return [F.pad(a, (0, 0, 0, pad)) for a in kv]

    def _merge(self, mask: np.ndarray, new_kv: List[torch.Tensor],
               old_kv: List[torch.Tensor]) -> List[torch.Tensor]:
        """Rows where ``mask`` holds take the call's new buffers, the
        others keep the buffers from before the call."""
        if mask.all():
            return list(new_kv)
        # a round-robin step over several cards returns its buffers on
        # its slot's card: the old rows follow them there
        dev = new_kv[0].device
        m = torch.from_numpy(mask)
        if dev.type == "cuda":
            m = m.pin_memory().to(dev, non_blocking=True)
        m = m[:, None, None, None]
        with torch.inference_mode():
            return [torch.where(m, n, self._moved(o, dev))
                    for n, o in zip(new_kv, old_kv)]

    @staticmethod
    def _moved(t: torch.Tensor, dev: torch.device) -> torch.Tensor:
        if t.device == dev:
            return t
        _M_XDEV.inc()
        return t.to(dev)

    # -- lifecycle -------------------------------------------------------
    def warmup(self) -> Dict[str, Any]:
        """Capture every (phase, T-bucket) signature as a CUDA graph and
        run the merge/grow/zeros helpers once at each rung, then arm the
        recompile sentinel — after this, a cold signature on the step
        path is a counted incident."""
        report: Dict[str, Any] = {"signatures": []}
        kv_specs_t = {}
        for t in self.t_ladder:
            kv_specs_t[t] = [((self.kv_heads, t, self.head_dim),
                              np.float32)] * len(self._kv_names)
        for t in self.t_ladder:
            for s, phase in ((self.S_pre, "prefill"), (1, "decode")):
                args_like = ([((s,), np.int64), ((), np.int32)]
                             + kv_specs_t[t])
                rep = self._ex.warmup(args_like)
                report["signatures"].append(
                    {"phase": phase, "S": s, "T": t,
                     "entries": [e.get("status") for e in rep.entries]})
            # the helpers at this bucket: merge + zeros (+ grow into the
            # next rung) — run once here, as the reference compiles them
            bufs = self._zeros(t)
            mask = np.zeros((self.B,), bool)
            self._merge(mask, bufs, bufs)
        for t_from, t_to in zip(self.t_ladder, self.t_ladder[1:]):
            self._grow(self._zeros(t_from), t_to - t_from)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self._warmed = True
        return report

    def start(self) -> None:
        if self._thread is None:
            # _loop is its own supervision boundary: every iteration runs
            # under a catch-all that fails the live handles and resets
            # batch state, so an escaped exception surfaces to callers
            self._thread = threading.Thread(
                target=self._loop, name=f"decode-{self.name}",
                daemon=True)
            self._thread.start()

    def close(self, timeout: float = 5.0) -> None:
        with self._cv:
            self._stop = True
            self._cv.notify_all()
        if self._thread is not None:
            self._thread.join(timeout)
        self._ex.close()
        # drop the instance-scope gauges so a closed scheduler neither
        # leaks through the registry nor exports stale series
        for series in ("decode_active_sequences",
                       "decode_waiting_sequences",
                       "decode_queue_wait_burn"):
            _tm.unregister(series, server=self.name)
        self.kv.close()
        self._kv_bufs = None

    def drain(self, timeout_s: float) -> bool:
        """Wait for every admitted sequence to finish (SIGTERM path);
        new submits are refused once ``close`` flips the stop flag, so
        callers shed first, then drain."""
        deadline = time.monotonic() + timeout_s
        while time.monotonic() < deadline:
            with self._cv:
                if not self._seqs:
                    return True
            time.sleep(0.01)
        return False

    # -- submission ------------------------------------------------------
    def submit(self, prompt_tokens: Sequence[int], max_new_tokens: int,
               deadline_s: Optional[float] = None,
               seq_id: Optional[str] = None) -> DecodeHandle:
        """Admit one sequence; returns a :class:`DecodeHandle` streaming
        its generated tokens. ``deadline_s`` is a relative budget — a
        sequence still unfinished then stops with reason ``deadline``
        (partial output, never an error). Raises ``RuntimeError`` when
        the admission queue is full (serving maps it to 429) and
        ``ValueError`` for prompts the geometry cannot hold or with a
        token outside ``[0, vocab)``."""
        toks = [int(t) for t in prompt_tokens]
        if not toks:
            raise ValueError("empty prompt")
        if len(toks) + max(1, int(max_new_tokens)) > self.max_seq:
            raise ValueError(
                f"prompt ({len(toks)}) + max_new_tokens "
                f"({max_new_tokens}) exceeds max_seq={self.max_seq}")
        if max_new_tokens < 1:
            raise ValueError("max_new_tokens must be >= 1")
        bad = [t for t in toks if not 0 <= t < self.vocab]
        if bad:
            raise ValueError(
                f"token ids {bad[:8]} outside [0, {self.vocab})")
        with self._cv:
            if self._stop:
                raise RuntimeError("decode scheduler is stopped")
            if len(self._waiting) >= self.max_waiting:
                raise RuntimeError("decode admission queue full")
            if seq_id is None:
                self._seq_counter += 1
                seq_id = f"{self.name}-{self._seq_counter}"
            handle = DecodeHandle(seq_id, len(toks))
            seq = _Seq(seq_id, toks, int(max_new_tokens),
                       None if deadline_s is None
                       else time.monotonic() + float(deadline_s), handle)
            self._seqs[seq_id] = seq
            self._waiting.append(seq)
            self._m_seqs.inc()
            self._cv.notify_all()
        self.start()
        return handle

    # -- scheduler loop --------------------------------------------------
    def _loop(self) -> None:
        while True:
            with self._cv:
                while (not self._stop and not self._waiting
                       and not any(self._slots)):
                    self._cv.wait(0.5)
                if self._stop and not self._waiting \
                        and not any(self._slots):
                    return
            try:
                self._iteration()
            except Exception as e:  # noqa: BLE001 - fail sequences, not thread
                _bb.record("decode_loop_error", level="error",
                           server=self.name, error=repr(e))
                _slog.log("error", "decode_loop_error",
                          server=self.name, error=repr(e))
                with self._cv:
                    for seq in list(self._seqs.values()):
                        seq.handle._fail(e)
                        self._seqs.pop(seq.id, None)
                        self.kv.release(seq.id)
                    self._waiting.clear()
                    self._slots = [None] * self.B
                    self._kv_bufs = None

    def _iteration(self) -> None:
        self._expire_deadlines()
        # HBM backpressure: while any device holds above the high-water
        # line, pause admission and shed one LRU resident per iteration
        pressure = _kvc.under_pressure()
        if pressure:
            victim = self.kv.evict_lru(reason="hbm_high_water")
            if victim is not None:
                self._evict_seq(victim)
        if not pressure:
            self._admit()
        did = False
        if any(s is not None and s.state == "prefill"
               for s in self._slots):
            self._prefill_step()
            did = True
        if any(s is not None and s.state == "decode"
               for s in self._slots):
            self._decode_step()
            did = True
        if not did:
            # nothing runnable (e.g. everything waiting under pressure):
            # don't spin
            time.sleep(0.001)

    def _expire_deadlines(self) -> None:
        now = time.monotonic()
        with self._cv:
            expired = [s for s in list(self._waiting)
                       if s.deadline is not None and now > s.deadline]
            for s in expired:
                self._waiting.remove(s)
                self._seqs.pop(s.id, None)
                s.handle._finish("deadline")
                self._finished_counter("deadline").inc()
        for s in self._slots:
            if s is not None and s.deadline is not None \
                    and now > s.deadline:
                self._retire(s, "deadline")

    def _admit(self) -> None:
        if self.static_batching and any(self._slots):
            # admission-time batching baseline: a new batch forms only
            # once the previous one fully drained
            return
        while True:
            with self._cv:
                if not self._waiting:
                    return
                free = [i for i, s in enumerate(self._slots)
                        if s is None]
                if not free:
                    return
                seq = self._waiting[0]
            if (self.kv.pages_for(len(seq.tokens) + 1)
                    > self.kv.capacity_pages):
                # can never fit, even alone — fail it now instead of
                # retrying forever at the head of the queue
                with self._cv:
                    self._waiting.popleft()
                    self._seqs.pop(seq.id, None)
                seq.handle._finish("kv_capacity")
                self._finished_counter("kv_capacity").inc()
                continue
            # admission NEVER evicts a running sequence: an evicted row
            # lands at the queue front and the next admission pass would
            # evict someone for it in turn — a livelock that admits
            # forever and steps never. Waiting sequences enter only on
            # free pages; capacity pressure flows the other way (decode
            # growth + the HBM latch evict INTO the queue, and the
            # grown row always steps next, so progress is guaranteed).
            if not self.kv.fits(len(seq.tokens) + 1):
                return  # does not fit yet — retry next iteration
            self.kv.acquire(seq.id, len(seq.tokens) + 1)
            with self._cv:
                self._waiting.popleft()
                slot = next(i for i, s in enumerate(self._slots)
                            if s is None)
                seq.slot = slot
                seq.state = "prefill"
                seq.cached = 0
                seq.admitted_at = time.monotonic()
                self._slots[slot] = seq
            wait = seq.admitted_at - seq.arrival
            if seq.recomputes == 0:
                self._m_wait.observe(wait)
                # the burn-rate window is read from scrape threads
                # (_wait_burn): every touch holds the scheduler lock
                with self._cv:
                    self._wait_window.append((seq.admitted_at, wait))
            self._ensure_bucket(min(len(seq.tokens) + 1, self.max_seq))
            if self.static_batching and len(
                    [s for s in self._slots if s is not None]) >= self.B:
                return

    def _evict_seq(self, seq_id: str) -> None:
        """Evicted by the cache: clear the slot, push the sequence —
        full history intact — back to the FRONT of the admission queue
        for recompute."""
        seq = self._seqs.get(seq_id)
        if seq is None or seq.slot is None:
            return
        with self._cv:
            self._slots[seq.slot] = None
            seq.slot = None
            seq.state = "waiting"
            seq.cached = 0
            seq.recomputes += 1
            self._waiting.appendleft(seq)
        self.kv.note_recompute(seq_id)
        _slog.log("info", "decode_evicted", server=self.name,
                  seq=seq_id, tokens=len(seq.tokens),
                  produced=seq.produced)

    def _retire(self, seq: _Seq, reason: str) -> None:
        with self._cv:
            if seq.slot is not None:
                self._slots[seq.slot] = None
                seq.slot = None
            self._seqs.pop(seq.id, None)
        self.kv.release(seq.id)
        seq.handle._finish(reason)
        self._finished_counter(reason).inc()

    def _finished_counter(self, reason: str) -> _tm.Counter:
        c = self._m_finished.get(reason)
        if c is None:
            c = _tm.counter("decode_finished_total", server=self.name,
                            reason=reason)
            self._m_finished[reason] = c
        return c

    # -- geometry --------------------------------------------------------
    def _ensure_bucket(self, need_t: int) -> None:
        """Grow the live buffers to the first ladder rung >= need_t.
        Never shrinks — re-bucketing down would change active rows'
        signatures for no memory win (the buffers are already paid)."""
        target = self._t_bucket
        for t in self.t_ladder:
            if t >= need_t:
                target = max(target, t)
                break
        else:
            target = self.t_ladder[-1]
        # the KV buffers and T-bucket are live batch state owned by the
        # loop thread alone (no reader elsewhere): lock-free by design
        if self._kv_bufs is None:
            self._kv_bufs = self._zeros(target)
            self._t_bucket = target
            return
        while self._t_bucket < target:
            nxt = self.t_ladder[self.t_ladder.index(self._t_bucket) + 1]
            self._kv_bufs = self._grow(self._kv_bufs,
                                       nxt - self._t_bucket)
            self._t_bucket = nxt

    # -- steps -----------------------------------------------------------
    def _prefill_step(self) -> None:
        rows = [(i, s) for i, s in enumerate(self._slots)
                if s is not None and s.state == "prefill"]
        ids = np.zeros((self.B, self.S_pre), np.int64)
        seqlens = np.zeros((self.B,), np.int32)
        mask = np.zeros((self.B,), bool)
        plan: List[Tuple[_Seq, int, int]] = []  # (seq, s1, last_row)
        for i, seq in rows:
            n = len(seq.tokens)
            s0 = seq.cached
            if n - s0 >= self.S_pre:
                # one full chunk at [s0, s0 + S_pre)
                s1 = s0 + self.S_pre
                ids[i] = seq.tokens[s0:s1]
                last = self.S_pre - 1
            elif n <= self.S_pre:
                # short prompt: single right-padded chunk at position 0
                s1 = n
                ids[i, :n] = seq.tokens
                last = n - 1
            else:
                # final partial chunk: left-overlap the previous chunk's
                # tail so the write position stays exact — re-fed
                # positions recompute the same keys
                s1 = n
                ids[i] = seq.tokens[n - self.S_pre:n]
                last = self.S_pre - 1
            seqlens[i] = s1 - 1
            mask[i] = True
            plan.append((seq, s1, last))
            self._ensure_bucket(min(s1 + 1, self.max_seq))
        t0 = time.monotonic()
        out = self._ex.submit(ids, seqlens, *self._kv_bufs).result()
        logits, new_kv = out[0], list(out[1:])
        # loop-thread-only batch state (see _ensure_bucket)
        self._kv_bufs = self._merge(mask, new_kv, self._kv_bufs)
        dt = time.monotonic() - t0
        self._m_steps["prefill"].inc()
        self._m_step_s["prefill"].observe(dt)
        for seq, s1, last in plan:
            seq.cached = s1
            self.kv.touch(seq.id)
            if seq.cached >= len(seq.tokens):
                # prompt (or recompute history) fully cached: the last
                # valid row's logits predict the next token
                tok = int(np.argmax(logits[seq.slot, last]))
                seq.state = "decode"
                if seq.produced == 0 and seq.admitted_at is not None \
                        and seq.recomputes == 0:
                    self._m_ttft.observe(time.monotonic() - seq.arrival)
                self._emit_token(seq, tok)

    def _decode_step(self) -> None:
        rows = [(i, s) for i, s in enumerate(self._slots)
                if s is not None and s.state == "decode"]
        if not rows:
            return
        # page accounting + bucket growth BEFORE the step: row i writes
        # at position cached, needing cached+1 slots
        for i, seq in list(rows):
            need = seq.cached + 1
            evicted = self.kv.acquire(seq.id, need)
            if evicted is None:
                # cannot fit even after evicting everything else — the
                # sequence outgrew total capacity; stop it with what it
                # has rather than thrash
                self._retire(seq, "kv_capacity")
                rows.remove((i, seq))
                continue
            for v in evicted:
                self._evict_seq(v)
                rows = [(j, s) for j, s in rows if s.id != v]
            self._ensure_bucket(need)
        if not rows:
            return
        ids = np.zeros((self.B, 1), np.int64)
        seqlens = np.zeros((self.B,), np.int32)
        mask = np.zeros((self.B,), bool)
        for i, seq in rows:
            ids[i, 0] = seq.tokens[seq.cached]
            seqlens[i] = seq.cached  # total valid = cached + 1
            mask[i] = True
        t0 = time.monotonic()
        out = self._ex.submit(ids, seqlens, *self._kv_bufs).result()
        logits, new_kv = out[0], list(out[1:])
        # loop-thread-only batch state (see _ensure_bucket)
        self._kv_bufs = self._merge(mask, new_kv, self._kv_bufs)
        dt = time.monotonic() - t0
        self._m_steps["decode"].inc()
        self._m_step_s["decode"].observe(dt)
        for i, seq in rows:
            seq.cached += 1
            self.kv.touch(seq.id)
            tok = int(np.argmax(logits[i, 0]))
            self._emit_token(seq, tok)

    def _emit_token(self, seq: _Seq, tok: int) -> None:
        seq.tokens.append(tok)
        seq.produced += 1
        seq.handle._emit(tok)
        self._m_tokens.inc()
        if seq.produced >= seq.max_new:
            self._retire(seq, "completed")
        elif len(seq.tokens) >= self.max_seq:
            self._retire(seq, "max_seq")

    # -- autoscaler signal ----------------------------------------------
    def _wait_burn(self) -> float:
        """Mean admission wait over the trailing 60s as a burn rate
        against the wait SLO — >1 means sequences wait longer than the
        target before their first prefill (a starved decode fleet)."""
        now = time.monotonic()
        with self._cv:
            while (self._wait_window
                   and now - self._wait_window[0][0] > 60.0):
                self._wait_window.popleft()
            if not self._wait_window or self.wait_slo_s <= 0:
                return 0.0
            mean = (sum(w for _, w in self._wait_window)
                    / len(self._wait_window))
        return mean / self.wait_slo_s

    # introspection for tests / debug endpoints
    def stats(self) -> Dict[str, Any]:
        with self._cv:
            return {
                "active": sum(s is not None for s in self._slots),
                "waiting": len(self._waiting),
                "t_bucket": self._t_bucket,
                "pages_in_use": self.kv.pages_in_use(),
                "capacity_pages": self.kv.capacity_pages,
                "warmed": self._warmed,
            }

"""Runtime telemetry: metrics registry + per-request trace spans.

The counterpart of the reference package's ``runtime/telemetry.py``,
with plain ``threading.Lock``s and a ``torch.profiler`` bridge:

- **Counters / gauges / fixed-bucket histograms** in one process-wide
  registry, *lock-free on the hot path*: every metric stripes its state
  per writer thread (a thread only ever mutates its own cell, claimed
  once via an atomic ``dict.setdefault``), so ``inc()``/``observe()``
  never contend on a lock and never lose updates. Aggregation happens at
  read time (:func:`snapshot`, :func:`prometheus_text`), off the hot
  path. Histograms carry last-write-wins OpenMetrics **exemplars**
  linking a latency bucket to a trace id.
- **Per-request trace spans**: a request id minted at
  ``WorkerServer._enqueue`` rides ``CachedRequest`` through the serving
  stages and — via :func:`set_current_spans` around the scorer's
  ``pipeline_fn`` call — into ``BatchedExecutor``'s pipeline units,
  whose stage/dispatch/drain threads :meth:`Span.note` each stage, so a
  completed request yields a ``queue_wait -> batch_form -> stage ->
  compute -> drain -> reply`` breakdown (:meth:`Span.breakdown`,
  ``GET /span/<rid>`` on the serving port). A span is one leg of a
  distributed trace: W3C ``traceparent`` context
  (:func:`parse_traceparent` / :func:`format_traceparent`) threads
  ``trace_id``/``parent_span_id`` through it, and :func:`trace_spans`
  answers "every leg this process holds for one trace"
  (``GET /trace/<trace_id>``). The completed-span ring depth is
  ``SYNAPSEML_SPAN_RING`` (:func:`configure_span_ring`).
- :func:`trace_annotation`: a ``torch.profiler.record_function`` range,
  so a profiler trace shows the executor's pipeline stages beside the
  card's kernels.

``SYNAPSEML_TELEMETRY=0`` (or :func:`set_enabled`) turns every record
call into a single flag test.
"""
from __future__ import annotations

import bisect
import contextlib
import contextvars
import os
import re
import threading
import time
import uuid
from collections import deque

from typing import (Any, Callable, Dict, Iterable, List, Optional, Sequence,
                    Tuple)

__all__ = [
    "Counter", "Gauge", "Histogram", "Span", "counter", "gauge", "gauge_fn",
    "histogram", "series", "unregister", "snapshot", "prometheus_text",
    "reset",
    "enabled", "set_enabled", "start_span", "get_span", "completed_spans",
    "trace_spans", "configure_span_ring", "span_ring_depth",
    "parse_traceparent", "format_traceparent", "mint_trace_id",
    "mint_span_id",
    "set_current_spans", "reset_current_spans", "current_spans",
    "trace_annotation", "LATENCY_BUCKETS", "SIZE_BUCKETS",
    "DEFAULT_SPAN_RING",
]

# log-spaced latency ladder, 100us .. 30s — covers the sub-ms serving
# roundtrip floor and a cold multi-second first call in one histogram
LATENCY_BUCKETS: Tuple[float, ...] = (
    0.0001, 0.00025, 0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025, 0.05,
    0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 30.0)
# pow2 ladder for batch/bucket size distributions
SIZE_BUCKETS: Tuple[float, ...] = (
    1, 2, 4, 8, 16, 32, 64, 128, 256, 512, 1024)

_NAME_RE = re.compile(r"[^a-zA-Z0-9_:]")
_PREFIX = "synapseml_"


class _State:
    """Module switchboard. A single attribute read gates every hot-path
    record call; the env knob is captured once at import and
    :func:`set_enabled` flips it for A/B runs and tests."""

    __slots__ = ("enabled",)

    def __init__(self):
        self.enabled = os.environ.get("SYNAPSEML_TELEMETRY", "") != "0"


_STATE = _State()


def enabled() -> bool:
    return _STATE.enabled


def set_enabled(on: bool) -> bool:
    """Flip recording globally; returns the previous value."""
    prev = _STATE.enabled
    _STATE.enabled = bool(on)
    return prev


def _qualify(name: str) -> str:
    name = _NAME_RE.sub("_", name)
    return name if name.startswith(_PREFIX) else _PREFIX + name


class _Cell:
    """One writer thread's private slice of a metric. Only the owning
    thread ever writes it (claimed via ``dict.setdefault``), so the
    read-modify-write increments need no lock and lose nothing; readers
    may observe a value mid-update, which only makes a snapshot a few
    nanoseconds stale — never wrong."""

    __slots__ = ("n", "total", "count", "counts")

    def __init__(self, n_buckets: int = 0):
        self.n = 0.0
        self.total = 0.0
        self.count = 0
        self.counts = [0] * n_buckets if n_buckets else None


class _Metric:
    """Base: per-thread striped cells."""

    kind = "untyped"

    def __init__(self, name: str, labels: Tuple[Tuple[str, str], ...]):
        self.name = name
        self.labels = labels
        self._cells: Dict[int, _Cell] = {}

    def _cell(self, n_buckets: int = 0) -> _Cell:
        tid = threading.get_ident()
        cell = self._cells.get(tid)
        if cell is None:
            # setdefault is atomic under the GIL: exactly one cell per
            # thread id ever wins, and the loser (there is none in
            # practice — a thread races only itself here) is dropped
            cell = self._cells.setdefault(tid, _Cell(n_buckets))
        return cell


class Counter(_Metric):
    """Monotonic counter. ``inc`` is the hot-path call: one dict get,
    one float add on a thread-private cell."""

    kind = "counter"

    def inc(self, n: float = 1.0):
        if not _STATE.enabled:
            return
        self._cell().n += n

    @property
    def value(self) -> float:
        return sum(c.n for c in list(self._cells.values()))


class Gauge(_Metric):
    """Last-write-wins gauge (``set``) with optional striped ``add`` for
    up/down tracking; a callable gauge (see :func:`gauge_fn`) is sampled
    at read time instead."""

    kind = "gauge"

    def __init__(self, name: str, labels: Tuple[Tuple[str, str], ...],
                 fn: Optional[Callable[[], float]] = None):
        super().__init__(name, labels)
        self._set_value: Optional[float] = None
        self._fn = fn

    def set(self, v: float):
        if not _STATE.enabled:
            return
        self._set_value = float(v)  # ref assignment: atomic

    def add(self, n: float = 1.0):
        if not _STATE.enabled:
            return
        self._cell().n += n

    @property
    def value(self) -> float:
        if self._fn is not None:
            try:
                return float(self._fn())
            except Exception:  # noqa: BLE001 - a dead sampler reads as 0
                return 0.0
        base = self._set_value if self._set_value is not None else 0.0
        return base + sum(c.n for c in list(self._cells.values()))


class Histogram(_Metric):
    """Fixed-bucket histogram with p50/p95/p99 readout.

    ``observe`` is hot-path: a bisect over ~17 bounds plus three
    thread-private writes. Percentiles are estimated at read time by
    linear interpolation inside the covering bucket (the usual
    Prometheus ``histogram_quantile`` math, done host-side)."""

    kind = "histogram"

    def __init__(self, name: str, labels: Tuple[Tuple[str, str], ...],
                 buckets: Sequence[float] = LATENCY_BUCKETS):
        super().__init__(name, labels)
        self.bounds: Tuple[float, ...] = tuple(float(b) for b in buckets)
        # per-bucket OpenMetrics exemplars, last-write-wins: each slot
        # holds one (trace_id, value, wall_ts) tuple. A single list-item
        # assignment per stamped observe — atomic under the GIL, no
        # lock, and losing a race just means the OTHER request's trace
        # becomes the bucket's exemplar (the sampling policy IS
        # last-write-wins, docs/observability.md "Distributed tracing")
        self._exemplars: List[Optional[Tuple[str, float, float]]] = \
            [None] * (len(self.bounds) + 1)

    def observe(self, v: float, exemplar: Optional[str] = None):
        """``exemplar``: a trace id to stamp on the covering bucket —
        surfaced on the OpenMetrics exposition so a dashboard's latency
        bucket links straight to the trace that landed in it."""
        if not _STATE.enabled:
            return
        idx = bisect.bisect_left(self.bounds, v)
        cell = self._cell(len(self.bounds) + 1)
        cell.counts[idx] += 1
        cell.total += v
        cell.count += 1
        if exemplar:
            self._exemplars[idx] = (exemplar, v, time.time())

    def _aggregate(self) -> Tuple[List[int], float, int]:
        counts = [0] * (len(self.bounds) + 1)
        total = 0.0
        n = 0
        for cell in list(self._cells.values()):
            if cell.counts is None:
                continue
            for i, c in enumerate(cell.counts):
                counts[i] += c
            total += cell.total
            n += cell.count
        return counts, total, n

    def percentile(self, q: float) -> float:
        """Estimated q-quantile (q in [0, 1]) from the bucket counts."""
        counts, _total, n = self._aggregate()
        if n == 0:
            return 0.0
        rank = q * n
        cum = 0
        for i, c in enumerate(counts):
            if c == 0:
                continue
            if cum + c >= rank:
                lo = self.bounds[i - 1] if i > 0 else 0.0
                hi = self.bounds[i] if i < len(self.bounds) \
                    else self.bounds[-1]
                frac = (rank - cum) / c
                return lo + (hi - lo) * min(max(frac, 0.0), 1.0)
            cum += c
        return self.bounds[-1]

    def summary(self) -> Dict[str, float]:
        counts, total, n = self._aggregate()
        out = {"count": n, "sum": round(total, 6)}
        if n:
            for q, key in ((0.5, "p50"), (0.95, "p95"), (0.99, "p99")):
                out[key] = round(self.percentile(q), 6)
        return out

    @property
    def count(self) -> int:
        return self._aggregate()[2]

    @property
    def sum(self) -> float:
        return self._aggregate()[1]


# -- registry ---------------------------------------------------------------

_REG_LOCK = threading.Lock()
_METRICS: Dict[Tuple[str, Tuple[Tuple[str, str], ...]], _Metric] = {}


def _labels_key(labels: Dict[str, Any]) -> Tuple[Tuple[str, str], ...]:
    return tuple(sorted((str(k), str(v)) for k, v in labels.items()))


def _get_or_make(cls, name: str, labels: Dict[str, Any], **kw) -> Any:
    name = _qualify(name)
    key = (name, _labels_key(labels))
    # _REG_LOCK is a leaf: metric get-or-create may nest under any
    # caller lock and acquires nothing further
    with _REG_LOCK:
        m = _METRICS.get(key)
        if m is None or not isinstance(m, cls):
            m = cls(name, key[1], **kw)
            _METRICS[key] = m
        return m


def counter(name: str, **labels: Any) -> Counter:
    """Get-or-create a counter; memoized per (name, labels). Resolve the
    handle once (module/instance init), then ``inc()`` on the hot path."""
    return _get_or_make(Counter, name, labels)


def gauge(name: str, **labels: Any) -> Gauge:
    return _get_or_make(Gauge, name, labels)


def gauge_fn(name: str, fn: Callable[[], float], **labels: Any) -> Gauge:
    """Callable gauge, sampled at scrape/snapshot time (queue depths
    etc. — nothing on the hot path). Re-registering the same series
    replaces the sampler, so a restarted server takes over its gauge."""
    name = _qualify(name)
    key = (name, _labels_key(labels))
    with _REG_LOCK:
        g = Gauge(name, key[1], fn=fn)
        _METRICS[key] = g
        return g


def histogram(name: str, buckets: Sequence[float] = LATENCY_BUCKETS,
              **labels: Any) -> Histogram:
    return _get_or_make(Histogram, name, labels, buckets=buckets)


def series(name: str) -> List[Tuple[Dict[str, str], _Metric]]:
    """Every registered label set of one family:
    ``[({label: value}, metric), ...]`` — registry-lock cost, never on a
    hot path."""
    name = _qualify(name)
    with _REG_LOCK:
        return [(dict(k[1]), m) for k, m in _METRICS.items()
                if k[0] == name]


def unregister(name: str, **labels: Any) -> bool:
    """Drop one series (stopped servers unhook their queue-depth
    samplers here so a scrape never calls into a dead object)."""
    key = (_qualify(name), _labels_key(labels))
    with _REG_LOCK:
        return _METRICS.pop(key, None) is not None


def reset():
    """Tests only: zero every metric and drop every span. Registrations
    (and module-level metric handles cached by instrumented code) stay
    valid — cells are cleared, so the next write starts from zero. A
    writer mid-increment on another thread may land one count in an
    orphaned cell; tests that assert exact values quiesce their threads
    first."""
    with _REG_LOCK:
        for m in _METRICS.values():
            m._cells.clear()
            if isinstance(m, Gauge):
                m._set_value = None
            elif isinstance(m, Histogram):
                m._exemplars = [None] * (len(m.bounds) + 1)
    with _SPAN_LOCK:
        _ACTIVE_SPANS.clear()
        _DONE_SPANS.clear()


# -- trace context (W3C traceparent) ----------------------------------------

# grammar per https://www.w3.org/TR/trace-context/:
#   version "-" trace-id "-" parent-id "-" trace-flags
# (2 / 32 / 16 / 2 lowercase hex). Version ff and all-zero ids are
# invalid; a well-formed header with an unknown version is still
# usable, INCLUDING trailing "-suffixed" data a future version may
# append (the spec's forward-compat rule: parse the first four
# fields, ignore the rest — but only for versions above 00, whose
# grammar is exactly four fields). One fullmatch on the request
# path — no lock, no allocation beyond the match object.
_TRACEPARENT_RE = re.compile(
    r"([0-9a-f]{2})-([0-9a-f]{32})-([0-9a-f]{16})-([0-9a-f]{2})(-.*)?")


def parse_traceparent(header: Optional[str]
                      ) -> Optional[Tuple[str, str]]:
    """``(trace_id, parent_span_id)`` from a W3C ``traceparent``
    header, or None when absent/malformed (the caller mints a fresh
    context then — a bad header must never reject a request)."""
    if not header:
        return None
    m = _TRACEPARENT_RE.fullmatch(header.strip())
    if m is None:
        return None
    version, trace_id, parent_id, _flags, tail = m.groups()
    if version == "ff":
        return None  # forbidden by the spec
    if version == "00" and tail is not None:
        return None  # version 00 is EXACTLY four fields
    if trace_id == "0" * 32 or parent_id == "0" * 16:
        return None  # all-zero ids are explicitly invalid
    return trace_id, parent_id


def format_traceparent(trace_id: str, span_id: str,
                       sampled: bool = True) -> str:
    """Version-00 traceparent naming OUR span as the parent — what
    every reply path echoes so the caller's next hop (or its logs)
    continues the same trace."""
    return f"00-{trace_id}-{span_id}-{'01' if sampled else '00'}"


def mint_trace_id() -> str:
    return uuid.uuid4().hex  # 32 hex, never all-zero


def mint_span_id() -> str:
    return uuid.uuid4().hex[:16]


# -- trace spans ------------------------------------------------------------

_SPAN_LOCK = threading.Lock()
_ACTIVE_SPANS: Dict[str, "Span"] = {}
_MAX_ACTIVE = 4096

DEFAULT_SPAN_RING = 1024


def _ring_depth_from_env() -> int:
    """``SYNAPSEML_SPAN_RING`` (0/unset = default 1024), validated at
    first use: a malformed or non-positive value degrades to the
    default — a bad env var must never crash a server at import."""
    raw = os.environ.get("SYNAPSEML_SPAN_RING", "").strip()
    if not raw:
        return DEFAULT_SPAN_RING
    try:
        depth = int(raw)
    except ValueError:
        return DEFAULT_SPAN_RING
    return depth if depth > 0 else DEFAULT_SPAN_RING


_DONE_SPANS: "deque[Span]" = deque(maxlen=_ring_depth_from_env())


def span_ring_depth() -> int:
    """Current completed-span ring capacity."""
    with _SPAN_LOCK:
        return _DONE_SPANS.maxlen or DEFAULT_SPAN_RING


def configure_span_ring(depth: Optional[int] = None) -> int:
    """Resize the completed-span ring, keeping the newest spans.
    ``None`` re-reads ``SYNAPSEML_SPAN_RING``; an explicit non-positive
    or non-int ``depth`` raises (the env path degrades instead).
    Returns the new capacity."""
    global _DONE_SPANS
    if depth is None:
        depth = _ring_depth_from_env()
    else:
        depth = int(depth)
        if depth <= 0:
            raise ValueError(f"span ring depth must be positive, "
                             f"got {depth}")
    with _SPAN_LOCK:
        _DONE_SPANS = deque(_DONE_SPANS, maxlen=depth)
    return depth

_STAGE_ORDER = ("queue_wait", "batch_form", "stage", "compute", "drain",
                "reply")


class Span:
    """One request's stage breakdown through the serving + executor
    pipeline. ``note`` appends to a thread-safe-enough list (appends are
    atomic under the GIL and each stage notes once); ``finish`` moves
    the span to the completed ring and feeds the per-stage histograms.

    A span is one LEG of a distributed trace — ``trace_id``
    (shared across every process the request touched, accepted from or
    minted for the W3C ``traceparent`` header), ``span_id`` (this
    leg), ``parent_span_id`` (the caller's leg, "" at the trace root)
    and ``origin`` (which server created it) are what
    ``GET /fleet/trace/<trace_id>`` stitches legs together on."""

    __slots__ = ("rid", "start", "wall", "events", "status", "finished",
                 "trace_id", "span_id", "parent_span_id", "origin",
                 "output_digest")

    def __init__(self, rid: str, trace_id: Optional[str] = None,
                 parent_span_id: Optional[str] = None,
                 span_id: Optional[str] = None,
                 origin: str = ""):
        self.rid = rid
        self.start = time.monotonic()
        self.wall = time.time()  # orders legs across processes
        self.events: List[Tuple[str, float]] = []
        self.status = "active"
        self.finished = 0.0
        self.trace_id = trace_id or mint_trace_id()
        self.span_id = span_id or mint_span_id()
        self.parent_span_id = parent_span_id or ""
        self.origin = origin
        # sha256 of the reply bytes, stamped by the serving reply path
        # (the X-Output-Digest header's value): /span/<rid> and the
        # trace archive then carry the determinism fingerprint replay
        # diffs against, without storing the output itself
        self.output_digest = ""

    def note(self, stage: str, seconds: float):
        # finished spans drop late notes: a request replayed through
        # recover() after its first reply would otherwise double its
        # stage breakdown (and disagree with the histograms, which are
        # fed once at finish)
        if not _STATE.enabled or self.status != "active":
            return
        self.events.append((stage, seconds))

    def finish(self, status: str = "ok"):
        # first-finisher-wins under the span lock: the reply thread and
        # a shutdown-path _fail_batch can race the same span
        with _SPAN_LOCK:
            if self.status != "active":
                return
            self.status = status
            self.finished = time.monotonic()
            _ACTIVE_SPANS.pop(self.rid, None)
            _DONE_SPANS.append(self)
        for stage, secs in self.breakdown()["stages"].items():
            _span_stage_hist(stage).observe(secs)

    def breakdown(self) -> Dict[str, Any]:
        stages: Dict[str, float] = {}
        for stage, secs in list(self.events):
            stages[stage] = stages.get(stage, 0.0) + secs
        ordered = {s: round(stages[s], 6) for s in _STAGE_ORDER
                   if s in stages}
        for s in sorted(stages):
            ordered.setdefault(s, round(stages[s], 6))
        end = self.finished if self.finished else time.monotonic()
        out = {"rid": self.rid, "status": self.status,
               "trace_id": self.trace_id, "span_id": self.span_id,
               "parent_span_id": self.parent_span_id,
               "origin": self.origin, "ts": round(self.wall, 6),
               "total_seconds": round(end - self.start, 6),
               "stages": ordered}
        if self.output_digest:
            out["output_digest"] = self.output_digest
        return out


class _NoopSpan(Span):
    """Returned when telemetry is disabled: every call is a no-op."""

    def __init__(self):  # noqa: D107 - trivially empty
        self.rid = ""
        self.start = 0.0
        self.wall = 0.0
        self.events = []
        self.status = "disabled"
        self.finished = 0.0
        self.trace_id = ""
        self.span_id = ""
        self.parent_span_id = ""
        self.origin = ""
        self.output_digest = ""

    def note(self, stage: str, seconds: float):
        pass

    def finish(self, status: str = "ok"):
        pass


_NOOP_SPAN = _NoopSpan()

_STAGE_HISTS: Dict[str, Histogram] = {}


def _span_stage_hist(stage: str) -> Histogram:
    h = _STAGE_HISTS.get(stage)
    if h is None or (h.name, h.labels) not in _METRICS:
        h = histogram("request_stage_seconds", stage=stage)
        _STAGE_HISTS[stage] = h
    return h


def start_span(rid: str, trace_id: Optional[str] = None,
               parent_span_id: Optional[str] = None,
               span_id: Optional[str] = None,
               origin: str = "") -> Span:
    """Mint a span for one request id (the serving enqueue path).
    ``trace_id``/``parent_span_id`` thread an accepted W3C traceparent
    through (both minted when absent); ``origin`` names the server so
    a stitched trace tells its legs apart."""
    if not _STATE.enabled:
        return _NOOP_SPAN
    span = Span(rid, trace_id=trace_id, parent_span_id=parent_span_id,
                span_id=span_id, origin=origin)
    with _SPAN_LOCK:
        _ACTIVE_SPANS[rid] = span
        while len(_ACTIVE_SPANS) > _MAX_ACTIVE:
            # insertion-ordered dict: evict the oldest straggler (a
            # request that never reached a reply path) instead of
            # growing without bound
            _ACTIVE_SPANS.pop(next(iter(_ACTIVE_SPANS)))
    return span


def get_span(rid: str) -> Optional[Span]:
    """Look a span up by request id — active first, then the completed
    ring (newest wins)."""
    with _SPAN_LOCK:
        span = _ACTIVE_SPANS.get(rid)
        if span is not None:
            return span
        for span in reversed(_DONE_SPANS):
            if span.rid == rid:
                return span
    return None


def completed_spans(limit: int = 64) -> List[Dict[str, Any]]:
    with _SPAN_LOCK:
        spans = list(_DONE_SPANS)[-limit:]
    return [s.breakdown() for s in spans]


def trace_spans(trace_id: str, limit: int = 64) -> List[Dict[str, Any]]:
    """Every span this PROCESS holds for one trace id — active and
    completed, oldest first. The per-replica half of distributed-trace
    stitching (``GET /trace/<trace_id>`` on the serving port; the
    fleet controller merges these across replicas). The lock hold is a
    bare snapshot copy — the O(ring) filter runs OUTSIDE it, so a
    polled trace surface over an operator-deepened ring
    (``SYNAPSEML_SPAN_RING``) never stalls ``start_span``/``finish``
    on the request path."""
    with _SPAN_LOCK:
        done = list(_DONE_SPANS)
        active = list(_ACTIVE_SPANS.values())
    spans = [s for s in done if s.trace_id == trace_id]
    spans += [s for s in active if s.trace_id == trace_id]
    spans.sort(key=lambda s: s.wall)
    return [s.breakdown() for s in spans[:limit]]


# ambient span context: the serving scorer sets the micro-batch's spans
# around its pipeline_fn call; BatchedExecutor.submit (same thread)
# captures them into the pipeline units so the stage/dispatch/drain
# threads can annotate per-request breakdowns without any API change
_CURRENT_SPANS: "contextvars.ContextVar[Optional[Tuple[Span, ...]]]" = \
    contextvars.ContextVar("synapseml_current_spans", default=None)


def set_current_spans(spans: Iterable[Span]):
    """Returns a token for :func:`reset_current_spans`."""
    return _CURRENT_SPANS.set(tuple(spans))


def reset_current_spans(token):
    _CURRENT_SPANS.reset(token)


def current_spans() -> Optional[Tuple[Span, ...]]:
    if not _STATE.enabled:
        return None
    return _CURRENT_SPANS.get()


# -- profiler bridge ------------------------------------------------------------

# one shared nullcontext: stateless and reusable on the per-batch path
_NULL_CTX = contextlib.nullcontext()


def trace_annotation(name: str):
    """A ``torch.profiler.record_function`` range named ``name`` while
    telemetry is enabled, so a ``torch.profiler`` trace shows the
    pipeline's stages on the host timeline beside the card's kernels; a
    no-op context otherwise."""
    if not _STATE.enabled:
        return _NULL_CTX
    import torch  # deferred: the registry itself needs no torch

    return torch.profiler.record_function(name)


# -- read surfaces ----------------------------------------------------------

def _sorted_metrics() -> List[_Metric]:
    with _REG_LOCK:
        return [m for _k, m in sorted(_METRICS.items())]


def snapshot(compact: bool = False) -> Dict[str, Any]:
    """One dict of every series: counters/gauges as numbers, histograms
    as ``{count, sum, p50, p95, p99}`` summaries (plus raw bucket counts
    unless ``compact``)."""
    counters: Dict[str, float] = {}
    gauges: Dict[str, float] = {}
    hists: Dict[str, Dict[str, Any]] = {}
    for m in _sorted_metrics():
        key = m.name + _labels_text(m.labels)
        if isinstance(m, Histogram):
            s = m.summary()
            if not compact:
                counts, _total, _n = m._aggregate()
                s["buckets"] = {
                    (str(b) if i < len(m.bounds) else "+Inf"): c
                    for i, (b, c) in enumerate(
                        zip(list(m.bounds) + [float("inf")], counts))}
            hists[key] = s
        elif isinstance(m, Counter):
            counters[key] = round(m.value, 6)
        else:
            gauges[key] = round(m.value, 6)
    with _SPAN_LOCK:
        n_done = len(_DONE_SPANS)
        n_active = len(_ACTIVE_SPANS)
    return {"counters": counters, "gauges": gauges, "histograms": hists,
            "spans": {"active": n_active, "completed_ring": n_done}}


def _labels_text(labels: Tuple[Tuple[str, str], ...],
                 extra: Tuple[Tuple[str, str], ...] = ()) -> str:
    items = labels + extra
    if not items:
        return ""
    body = ",".join(
        '%s="%s"' % (k, v.replace("\\", "\\\\").replace('"', '\\"')
                     .replace("\n", "\\n"))
        for k, v in items)
    return "{%s}" % body


def prometheus_text(openmetrics: bool = False) -> str:
    """Prometheus text exposition (format 0.0.4): counters and gauges as
    single samples, histograms as cumulative ``_bucket{le=}`` series
    plus ``_sum``/``_count`` — what ``GET /metrics`` serves.

    ``openmetrics=True`` emits the OpenMetrics-flavored variant the
    serving port negotiates on ``Accept: application/openmetrics-text``
    (or ``SYNAPSEML_OPENMETRICS=1``): identical samples, plus
    ``# {trace_id="..."} value timestamp`` **exemplars** on histogram
    bucket lines that have one, and the terminating ``# EOF``. Honesty
    caveat: series names keep their registered ``_total`` suffixes
    rather than the OpenMetrics family/suffix split — tolerant parsers
    (Prometheus's openmetrics scrape mode included) accept it; the
    default exposition is unchanged, so format-0.0.4 consumers never
    see an exemplar."""
    seen_types: Dict[str, str] = {}
    lines: List[str] = []
    for m in _sorted_metrics():
        if seen_types.get(m.name) != m.kind:
            seen_types[m.name] = m.kind
            lines.append(f"# TYPE {m.name} {m.kind}")
        if isinstance(m, Histogram):
            counts, total, n = m._aggregate()
            exemplars = list(m._exemplars) if openmetrics else None
            cum = 0
            for i, (b, c) in enumerate(
                    zip(list(m.bounds) + [float("inf")], counts)):
                cum += c
                le = "+Inf" if b == float("inf") else repr(b)
                line = "%s_bucket%s %d" % (
                    m.name, _labels_text(m.labels, (("le", le),)), cum)
                ex = exemplars[i] if exemplars else None
                if ex is not None:
                    tid, v, ts = ex
                    line += ' # {trace_id="%s"} %.9g %.3f' % (tid, v, ts)
                lines.append(line)
            lines.append("%s_sum%s %.9g" % (
                m.name, _labels_text(m.labels), total))
            lines.append("%s_count%s %d" % (
                m.name, _labels_text(m.labels), n))
        else:
            v = m.value
            text = "%d" % v if float(v).is_integer() else "%.9g" % v
            lines.append("%s%s %s" % (m.name, _labels_text(m.labels), text))
    if openmetrics:
        lines.append("# EOF")
    return "\n".join(lines) + "\n"

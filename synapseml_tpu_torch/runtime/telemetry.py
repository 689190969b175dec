"""Runtime telemetry: the metric registry and the ambient-span surface.

The counterpart of the reference package's ``runtime/telemetry.py``, cut
to what the batched executor's pipeline calls:

- **Counters / gauges / fixed-bucket histograms** in one process-wide
  registry, *lock-free on the hot path*: every metric stripes its state
  per writer thread (a thread only ever mutates its own cell, claimed
  once via an atomic ``dict.setdefault``), so ``inc()``/``observe()``
  never contend on a lock and never lose updates. Aggregation happens at
  read time (:func:`snapshot`, :func:`series`), off the hot path.
- **Ambient spans**: a caller sets the spans of the requests it is
  serving around a ``submit`` (:func:`set_current_spans`); the executor
  captures them into its pipeline units and its stage/dispatch/drain
  threads :meth:`Span.note` each stage's seconds on them.
- :func:`trace_annotation`: a ``torch.profiler.record_function`` range,
  so a profiler trace shows the executor's pipeline stages beside the
  card's kernels.

``SYNAPSEML_TELEMETRY=0`` turns every record call into a single flag test.
The Prometheus text exposition, W3C traceparent, exemplars and the
completed-span ring are not ported yet.
"""
from __future__ import annotations

import bisect
import contextlib
import contextvars
import os
import re
import threading
import time
from typing import (Any, Callable, Dict, Iterable, List, Optional, Sequence,
                    Tuple)

__all__ = [
    "Counter", "Gauge", "Histogram", "Span", "counter", "gauge", "gauge_fn",
    "histogram", "series", "unregister", "snapshot", "reset",
    "set_current_spans", "reset_current_spans", "current_spans",
    "trace_annotation", "LATENCY_BUCKETS",
]

# log-spaced latency ladder, 100us .. 30s — covers the sub-ms serving
# roundtrip floor and a cold multi-second first call in one histogram
LATENCY_BUCKETS: Tuple[float, ...] = (
    0.0001, 0.00025, 0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025, 0.05,
    0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 30.0)

_NAME_RE = re.compile(r"[^a-zA-Z0-9_:]")
_PREFIX = "synapseml_"


class _State:
    """Module switchboard: a single attribute read gates every hot-path
    record call; the env knob is read once at import."""

    __slots__ = ("enabled",)

    def __init__(self):
        self.enabled = os.environ.get("SYNAPSEML_TELEMETRY", "") != "0"


_STATE = _State()


def _qualify(name: str) -> str:
    name = _NAME_RE.sub("_", name)
    return name if name.startswith(_PREFIX) else _PREFIX + name


class _Cell:
    """One writer thread's private slice of a metric. Only the owning
    thread writes it, so its read-modify-write increments need no lock and
    lose nothing; a reader may see a value mid-update, a few nanoseconds
    stale, never wrong."""

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
            # setdefault is atomic under the GIL: one cell per thread id
            cell = self._cells.setdefault(tid, _Cell(n_buckets))
        return cell


class Counter(_Metric):
    """Monotonic counter. ``inc`` is the hot-path call: one dict get, one
    float add on a thread-private cell."""

    kind = "counter"

    def inc(self, n: float = 1.0):
        if not _STATE.enabled:
            return
        self._cell().n += n

    @property
    def value(self) -> float:
        return sum(c.n for c in list(self._cells.values()))


class Gauge(_Metric):
    """Last-write-wins gauge (``set``) with a striped ``add`` for up/down
    tracking; a callable gauge (:func:`gauge_fn`) is sampled at read
    time instead."""

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
    """Fixed-bucket histogram with p50/p95/p99 readout. ``observe`` is a
    bisect over the bounds plus three thread-private writes; percentiles
    are interpolated inside the covering bucket at read time."""

    kind = "histogram"

    def __init__(self, name: str, labels: Tuple[Tuple[str, str], ...],
                 buckets: Sequence[float] = LATENCY_BUCKETS):
        super().__init__(name, labels)
        self.bounds: Tuple[float, ...] = tuple(float(b) for b in buckets)

    def observe(self, v: float):
        if not _STATE.enabled:
            return
        idx = bisect.bisect_left(self.bounds, v)
        cell = self._cell(len(self.bounds) + 1)
        cell.counts[idx] += 1
        cell.total += v
        cell.count += 1

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
        _counts, total, n = self._aggregate()
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
    """Callable gauge, sampled at snapshot time (queue depths etc. —
    nothing on the hot path). Re-registering the same series replaces the
    sampler."""
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
    """Drop one series."""
    key = (_qualify(name), _labels_key(labels))
    with _REG_LOCK:
        return _METRICS.pop(key, None) is not None


def reset():
    """Tests and measurements: zero every metric. Registrations (and the
    module-level handles instrumented code holds) stay valid — cells are
    cleared, so the next write starts from zero. A writer mid-increment on
    another thread may land one count in an orphaned cell; quiesce the
    threads first where exact values matter."""
    with _REG_LOCK:
        for m in _METRICS.values():
            m._cells.clear()
            if isinstance(m, Gauge):
                m._set_value = None


def _labels_text(labels: Tuple[Tuple[str, str], ...]) -> str:
    if not labels:
        return ""
    body = ",".join(
        '%s="%s"' % (k, v.replace("\\", "\\\\").replace('"', '\\"')
                     .replace("\n", "\\n"))
        for k, v in labels)
    return "{%s}" % body


def snapshot(compact: bool = False) -> Dict[str, Any]:
    """One dict of every series: counters/gauges as numbers, histograms
    as ``{count, sum, p50, p95, p99}`` summaries (plus raw bucket counts
    unless ``compact``). Keys are ``name{label="value",...}``."""
    counters: Dict[str, float] = {}
    gauges: Dict[str, float] = {}
    hists: Dict[str, Dict[str, Any]] = {}
    with _REG_LOCK:
        metrics = [m for _k, m in sorted(_METRICS.items())]
    for m in metrics:
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
    return {"counters": counters, "gauges": gauges, "histograms": hists}


# -- spans --------------------------------------------------------------------

class Span:
    """One request's stage breakdown through the executor's pipeline.
    ``note`` appends (atomic under the GIL; each stage notes once)."""

    __slots__ = ("rid", "start", "events", "status")

    def __init__(self, rid: str):
        self.rid = rid
        self.start = time.monotonic()
        self.events: List[Tuple[str, float]] = []
        self.status = "active"

    def note(self, stage: str, seconds: float):
        if not _STATE.enabled or self.status != "active":
            return
        self.events.append((stage, seconds))


# ambient span context: a caller sets the spans of the requests it serves
# around a submit; BatchedExecutor.submit (same thread) captures them into
# its pipeline units so the stage/dispatch/drain threads can note them
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

"""Flight recorder: a bounded ring of structured incident events.

The port's counterpart of the reference package's
``runtime/blackbox.py``, with plain ``threading.Lock``s. It is the
in-memory half of the incident-diagnosis layer (structured logging in
:mod:`~synapseml_tpu_torch.runtime.structlog` is the emitted half):

- :func:`record` appends one structured event — breaker transition,
  failover, redisperse, pipeline break, shed, drain phase, poison
  bisection, slow batch — to a **bounded ring** (default 2048 events;
  the oldest evict). Each event carries a monotone ``seq``, wall +
  monotonic timestamps, and the ``rid``/``channel`` correlation keys
  the spans, logs, and ``X-Request-Id`` headers share. Recording is
  lock-cheap: one uncontended lock around a ``deque.append`` per
  *incident event* — never on the per-request hot path — and a single
  attribute test when disabled (``SYNAPSEML_BLACKBOX=0``).
- :func:`snapshot` returns the ring plus the live telemetry gauges and
  **per-thread stack traces** — the "what was every pipeline thread
  doing" picture. Served live as ``GET /debug/flight`` on every
  serving port.
- :func:`trigger` is the incident hook: it records the trigger event
  and (debounced, default 10s) **dumps the snapshot to a timestamped
  JSON file** in the dump dir. Wired to executor pipeline breaks
  (``_break_pipeline``), and — via
  :func:`install_signal_trigger` in the serving entry — SIGUSR2, so an
  operator can snapshot a live replica with ``kill -USR2 <pid>``.

Dump dir: ``SYNAPSEML_DUMP_DIR`` (the serving chart points it at a
volume) or ``<tmpdir>/synapseml_flight``. Dumps never raise into the
triggering code path — a failed write is counted and swallowed; the
flight recorder must never make an incident worse.
"""
from __future__ import annotations

import itertools
import json
import os
import sys
import tempfile
import threading
import time
import traceback
from collections import deque
from typing import Any, Dict, List, Optional

from synapseml_tpu_torch.runtime import structlog as _slog
from synapseml_tpu_torch.runtime import telemetry as _tm

__all__ = [
    "record", "trigger", "snapshot", "dump", "thread_stacks",
    "dump_dir", "set_dump_dir", "last_dump_path", "configure", "reset",
    "enabled", "set_enabled", "install_signal_trigger",
    "DEFAULT_CAPACITY",
]

DEFAULT_CAPACITY = 2048


class _State:
    """Module switchboard + ring. The ring and its metadata are guarded
    by one small lock; a record is one append under it (incident-rate
    events only, so contention is nil), a snapshot copies under it."""

    def __init__(self):
        self.enabled = os.environ.get("SYNAPSEML_BLACKBOX", "") != "0"
        self.lock = threading.Lock()
        self.ring: "deque[Dict[str, Any]]" = deque(maxlen=DEFAULT_CAPACITY)
        self.seq = itertools.count()
        self.dump_dir: Optional[str] = os.environ.get(
            "SYNAPSEML_DUMP_DIR") or None
        self.min_dump_interval_s = float(os.environ.get(
            "SYNAPSEML_DUMP_MIN_INTERVAL_S", "10"))
        self.last_dump_ts = 0.0
        self.last_dump_path: Optional[str] = None


_S = _State()


def enabled() -> bool:
    return _S.enabled


def set_enabled(on: bool) -> bool:
    """Flip recording globally; returns the previous value."""
    prev = _S.enabled
    _S.enabled = bool(on)
    return prev


def configure(capacity: Optional[int] = None,
              min_dump_interval_s: Optional[float] = None):
    """Resize the ring / retune the dump debounce (tests, serving
    entry). Resizing keeps the newest events."""
    with _S.lock:
        if capacity is not None:
            _S.ring = deque(_S.ring, maxlen=max(1, int(capacity)))
        if min_dump_interval_s is not None:
            _S.min_dump_interval_s = float(min_dump_interval_s)


def reset():
    """Tests only: clear the ring and the dump debounce."""
    with _S.lock:
        _S.ring.clear()
        _S.last_dump_ts = 0.0
        _S.last_dump_path = None


def dump_dir() -> str:
    """Where dumps (and on-demand profiles) land; created lazily."""
    d = _S.dump_dir or os.path.join(tempfile.gettempdir(),
                                    "synapseml_flight")
    return d


def set_dump_dir(path: Optional[str]):
    _S.dump_dir = path


def last_dump_path() -> Optional[str]:
    return _S.last_dump_path


def record(event: str, rid: Optional[str] = None,
           channel: Optional[int] = None, level: str = "info",
           trace: Optional[str] = None,
           **fields: Any) -> None:
    """Append one structured event to the ring and (when logging is on)
    emit it as a structured log line — ONE instrumentation call per
    site keeps the ring and the log telling the same story. Safe under
    locks: the ring lock is a leaf (this module acquires nothing else
    while holding it) and the log emission never blocks the caller.
    The log line is emitted even with the ring disabled
    (``SYNAPSEML_BLACKBOX=0``) — the two layers are independent, and
    turning off the in-memory recorder must not silence the operator's
    incident log. ``trace`` is the distributed-trace correlation key
    (``rid``'s fleet-wide sibling): grep one trace id across any
    replica's ring, log, span store, and the stitched
    ``/fleet/trace`` view and they tell one story."""
    _slog.log(level, event, rid=rid, channel=channel, trace=trace,
              **fields)
    if not _S.enabled:
        return
    ev: Dict[str, Any] = {"seq": next(_S.seq),
                          "ts": round(time.time(), 6),
                          "mono": time.monotonic(),
                          "event": event, "level": level}
    if rid is not None:
        ev["rid"] = rid
    if channel is not None:
        ev["channel"] = channel
    if trace is not None:
        ev["trace"] = trace
    for k, v in fields.items():
        if v is not None:
            ev[k] = v
    # the ring lock is a leaf: record() is the flight recorder and may
    # be called under any lock in the system
    with _S.lock:
        _S.ring.append(ev)


def thread_stacks() -> List[Dict[str, Any]]:
    """Every live thread's name + current stack — the forensic "what
    was the process doing". Pure host-side introspection
    (``sys._current_frames``), no device sync, safe to call from any
    thread including a signal handler."""
    names = {t.ident: (t.name, t.daemon) for t in threading.enumerate()}
    out: List[Dict[str, Any]] = []
    for ident, frame in sorted(sys._current_frames().items()):
        name, daemon = names.get(ident, (f"thread-{ident}", True))
        stack = [{"file": fs.filename, "line": fs.lineno,
                  "func": fs.name, "code": (fs.line or "").strip()}
                 for fs in traceback.extract_stack(frame)]
        out.append({"name": name, "ident": ident, "daemon": daemon,
                    "stack": stack})
    return out


def snapshot(max_events: Optional[int] = None,
             stacks: bool = True) -> Dict[str, Any]:
    """The full flight picture: ring events (oldest first), live
    telemetry gauges/counters (compact), and per-thread stacks — what
    ``GET /debug/flight`` serves and what a dump file contains."""
    with _S.lock:
        events = list(_S.ring)
        capacity = _S.ring.maxlen
    if max_events is not None:
        events = events[-max_events:]
    snap: Dict[str, Any] = {
        "ts": round(time.time(), 6),
        "pid": os.getpid(),
        "capacity": capacity,
        "n_events": len(events),
        "events": events,
        "telemetry": _tm.snapshot(compact=True),
        # the last 32 completed span breakdowns (trace ids included):
        # a forensic file alone answers "what was in flight, and which
        # traces were those requests" without a live replica to query
        "spans": _tm.completed_spans(32),
    }
    if stacks:
        snap["threads"] = thread_stacks()
    return snap


def _dump_target(reason: str) -> tuple:
    """``(path, safe_reason)`` for a new dump file. The seq suffix
    keeps two same-reason dumps inside one wall-clock second (debounce
    tuned low, or distinct triggers) from ``os.replace()``-ing each
    other's forensic file."""
    stamp = (time.strftime("%Y%m%dT%H%M%S", time.gmtime())
             + f"-{next(_S.seq):06d}")
    safe = "".join(c if c.isalnum() or c in "._-" else "_"
                   for c in reason)[:48]
    return (os.path.join(
        dump_dir(), f"flight-{stamp}-{safe}-{os.getpid()}.json"), safe)


def _write_dump(snap: Dict[str, Any], path: str, safe: str,
                reason: str) -> Optional[str]:
    """Atomic tmp-then-rename write; counts, never raises.
    ``last_dump_path`` is set only AFTER the file exists, so a reader
    polling it can open the path immediately."""
    try:
        os.makedirs(os.path.dirname(path), exist_ok=True)
        tmp = path + ".tmp"
        with open(tmp, "w", encoding="utf-8") as fh:
            json.dump(snap, fh, default=repr)
        os.replace(tmp, path)  # readers never see a torn dump
    except Exception:  # noqa: BLE001 - the recorder must not worsen incidents
        _tm.counter("blackbox_dump_failures_total").inc()
        return None
    with _S.lock:  # dumpers race (trigger thread vs sigusr2 thread)
        _S.last_dump_path = path
    _tm.counter("blackbox_dumps_total", trigger=safe).inc()
    _slog.log("info", "flight_dump", reason=reason, path=path)
    return path


def dump(reason: str, **fields: Any) -> Optional[str]:
    """Snapshot + write to ``<dump_dir>/flight-<utc>-<seq>-<reason>-
    <pid>.json`` NOW, synchronously (no debounce — :func:`trigger` is
    the debounced entry). Returns the path, or None when disabled or
    the write failed."""
    if not _S.enabled:
        return None
    snap = snapshot()
    snap["trigger"] = {"reason": reason, **fields}
    path, safe = _dump_target(reason)
    return _write_dump(snap, path, safe, reason)


def trigger(reason: str, rid: Optional[str] = None,
            channel: Optional[int] = None,
            **fields: Any) -> Optional[str]:
    """The incident hook: record the trigger as a ring event, then dump
    — debounced (``min_dump_interval_s``, default 10s) so a flapping
    breaker or a kill-storm produces one forensic file per window, not
    a dump per failure.

    The SNAPSHOT (ring + gauges + thread stacks) is taken inline —
    forensics must show the process AT the incident — but the file
    write happens on a background thread: triggers sit on failure
    paths (a breaker trip mid-failover, a pipeline break before its
    futures are failed), and a slow dump volume must not stretch the
    client-visible recovery it interrupts. Returns the destination
    path when a dump was started (``last_dump_path`` flips to it once
    the file is fully written)."""
    record(reason, rid=rid, channel=channel, level="warn", **fields)
    if not _S.enabled:
        return None
    now = time.monotonic()
    with _S.lock:
        if (_S.last_dump_ts
                and now - _S.last_dump_ts < _S.min_dump_interval_s):
            return None
        _S.last_dump_ts = now
    snap = snapshot()
    snap["trigger"] = {k: v for k, v in
                       {"reason": reason, "rid": rid,
                        "channel": channel, **fields}.items()
                       if v is not None}
    path, safe = _dump_target(reason)
    # one-shot dump writer, not a loop; a failed dump must never take
    # the serving process with it
    threading.Thread(target=_write_dump, args=(snap, path, safe, reason),
                     name="blackbox-dump", daemon=True).start()
    return path


def install_signal_trigger(signum: Optional[int] = None) -> bool:
    """Install a SIGUSR2 (or ``signum``) handler that dumps a flight
    snapshot — the operator's ``kill -USR2 <pid>`` surface. Main-thread
    only (signal module restriction); returns False where unsupported
    (e.g. Windows has no SIGUSR2) instead of raising, so the serving
    entry stays portable.

    The handler HANDS OFF to a fresh thread instead of dumping inline:
    Python signal handlers interrupt the main thread between bytecodes,
    so an inline dump could re-acquire a non-reentrant lock the
    interrupted frame already holds (the ring lock mid-``record``, the
    log write lock, the telemetry registry lock mid-snapshot) and
    deadlock the process — the one outcome a debugging surface must
    never cause."""
    import signal as _signal

    if signum is None:
        signum = getattr(_signal, "SIGUSR2", None)
        if signum is None:
            return False

    def _handler(*_):
        # one-shot signal handoff (see the docstring): inline dumping
        # could deadlock the main thread
        threading.Thread(target=trigger, args=("sigusr2",),
                         name="blackbox-sigusr2", daemon=True).start()

    try:
        _signal.signal(signum, _handler)
        return True
    except (ValueError, OSError):  # not the main thread / unsupported
        return False

"""Structured logging: one JSON-lines event schema for the runtime.

A copy of the reference package's ``runtime/structlog.py`` (the port
imports nothing of it), with plain ``threading.Lock``s. This module is
the logging half of the incident-diagnosis
layer (the flight recorder in :mod:`~synapseml_tpu_torch.runtime.blackbox`
is the in-memory half): every emitted line is ONE schema::

    {"ts": 1754236800.123, "level": "info", "event": "failover",
     "rid": "3f2a...", "channel": 0, "to_channel": 1, ...}

``ts`` is epoch seconds (float), ``level`` one of debug/info/warn/
error, ``event`` a stable snake_case name, ``rid``/``channel`` the
correlation keys (omitted when not applicable), and everything else
event-specific fields. Because the rid in the log IS the rid in the
``X-Request-Id`` header, the trace span, and the flight-recorder ring,
``grep <rid>`` over the log reconstructs a request's life end to end
(docs/observability.md, "Structured log schema").

Off by default — emission is opt-in via ``SYNAPSEML_LOG``:

- ``SYNAPSEML_LOG=json``  JSON lines (machines / log pipelines)
- ``SYNAPSEML_LOG=text``  ``ts level event k=v ...`` (humans)
- ``SYNAPSEML_LOG=0`` / unset  silent — :func:`log` is a single
  attribute test, the same degrade-to-nothing discipline the
  telemetry and fault-injection hot paths use.

``SYNAPSEML_LOG_LEVEL`` (default ``info``) gates per-request ``debug``
events (request accepted / replied) separately from the incident-grade
``info``+ events, so a production replica can log every breaker
transition without paying a line per request.

Lines go to stderr (stdout carries the serving entry's protocol lines
the chaos CI parses); the stream is injectable for tests.

**Emission never blocks the caller.** Several call sites log while
holding serving-critical locks (the breaker lock, the channel map
lock), and a stalled stderr consumer fills the pipe — a synchronous
``write`` there would wedge every channel's scoring behind one slow
log collector. Production lines (stderr) are therefore handed to a
bounded queue drained by one writer thread (oldest-wins: a full queue
DROPS the new line and counts it in :func:`dropped_lines` — losing a
log line beats losing the serving plane), flushed at interpreter exit.
An injected test stream writes synchronously under a small lock, so
tests read their buffer deterministically.
"""
from __future__ import annotations

import atexit
import json
import os
import queue as _queue
import sys
import threading
import time
from typing import Any, Dict, Optional, TextIO


__all__ = ["log", "enabled", "mode", "set_mode", "dropped_lines",
           "LEVELS"]

LEVELS: Dict[str, int] = {"debug": 10, "info": 20, "warn": 30,
                          "error": 40}


class _Cfg:
    """Module switchboard (the telemetry ``_State`` pattern): ``mode``
    gates every :func:`log` call with one attribute read; the env knobs
    are captured once at import and :func:`set_mode` flips them for
    tests and the serving entry."""

    __slots__ = ("mode", "min_level", "stream", "dropped")

    def __init__(self):
        raw = os.environ.get("SYNAPSEML_LOG", "").strip().lower()
        self.mode = raw if raw in ("json", "text") else ""
        lvl = os.environ.get("SYNAPSEML_LOG_LEVEL", "info").strip().lower()
        self.min_level = LEVELS.get(lvl, LEVELS["info"])
        # None = async writer to sys.stderr (resolved at write time so
        # pytest capture and late redirection keep working); tests
        # inject a StringIO, which writes synchronously instead
        self.stream: Optional[TextIO] = None
        self.dropped = 0  # lines lost to a full queue (bounded cost)


_CFG = _Cfg()
_WRITE_LOCK = threading.Lock()

# bounded hand-off to the stderr writer thread: log() never blocks,
# whatever the pipe's consumer is doing
_Q_MAX = 4096
_LOG_Q: "_queue.Queue[str]" = _queue.Queue(maxsize=_Q_MAX)
_WRITER_LOCK = threading.Lock()
_WRITER: Optional[threading.Thread] = None


def dropped_lines() -> int:
    """Lines dropped because the writer queue was full."""
    return _CFG.dropped


def _writer_loop():
    while True:
        line = _LOG_Q.get()
        try:
            stream = sys.stderr
            stream.write(line + "\n")
            stream.flush()
        except Exception:  # noqa: BLE001 - logging must never break the job
            pass


def _ensure_writer():
    global _WRITER
    if _WRITER is not None and _WRITER.is_alive():
        return
    with _WRITER_LOCK:
        if _WRITER is None or not _WRITER.is_alive():
            # synlint: disable=RL001 - self-healing singleton: every
            # enqueue re-checks is_alive() and respawns a dead writer
            _WRITER = threading.Thread(target=_writer_loop,
                                       name="structlog-writer",
                                       daemon=True)
            _WRITER.start()


@atexit.register
def _drain_at_exit():
    """Best-effort flush of queued lines while stderr still works —
    the writer is a daemon thread and may be frozen by interpreter
    teardown with lines still queued."""
    deadline = time.monotonic() + 2.0
    while not _LOG_Q.empty() and time.monotonic() < deadline:
        time.sleep(0.01)
    while True:
        try:
            line = _LOG_Q.get_nowait()
        except _queue.Empty:
            return
        try:
            sys.stderr.write(line + "\n")
            sys.stderr.flush()
        except Exception:  # noqa: BLE001
            return


def mode() -> str:
    """Current emission mode: ``"json"``, ``"text"``, or ``""`` (off)."""
    return _CFG.mode


def enabled(level: str = "info") -> bool:
    """True when a :func:`log` call at ``level`` would emit — the guard
    callers use before building expensive field dicts."""
    return bool(_CFG.mode) and LEVELS.get(level, 20) >= _CFG.min_level


def set_mode(new_mode: str, level: Optional[str] = None,
             stream: Optional[TextIO] = None):
    """Reconfigure emission; returns ``(prev_mode, prev_level_name)``
    so tests can restore. ``new_mode``: ``"json"``/``"text"``/``""``
    (or ``"0"``) — anything else raises."""
    if new_mode in ("0", "off", None):
        new_mode = ""
    if new_mode not in ("json", "text", ""):
        raise ValueError(
            f"unknown log mode {new_mode!r} (json, text, or '' = off)")
    prev = (_CFG.mode,
            next(k for k, v in LEVELS.items() if v == _CFG.min_level))
    _CFG.mode = new_mode
    if level is not None:
        if level not in LEVELS:
            raise ValueError(f"unknown log level {level!r} "
                             f"(levels: {', '.join(LEVELS)})")
        _CFG.min_level = LEVELS[level]
    if stream is not None:
        _CFG.stream = stream
    return prev


def _json_safe(v: Any) -> Any:
    if isinstance(v, (str, int, float, bool)) or v is None:
        return v
    if isinstance(v, (list, tuple)):
        return [_json_safe(x) for x in v]
    if isinstance(v, dict):
        return {str(k): _json_safe(x) for k, x in v.items()}
    return repr(v)


def log(level: str, event: str, rid: Optional[str] = None,
        channel: Optional[int] = None, trace: Optional[str] = None,
        **fields: Any):
    """Emit one structured event. A no-op (single attribute test) when
    logging is off or the level is below the configured floor — safe on
    any path, including under locks: production lines are enqueued to
    the writer thread (full queue drops + counts, never blocks), so a
    stalled stderr consumer cannot wedge a caller holding the breaker
    or channel-map lock. ``trace`` is the distributed-trace id
    (``rid``'s fleet-wide sibling, docs/observability.md "Distributed
    tracing"): the same 32-hex value rides the ``traceparent``
    headers, the span store, and the flight ring, so grep-by-trace
    reconstructs a request across REPLICAS the way grep-by-rid does
    within one."""
    if not _CFG.mode:
        return
    if LEVELS.get(level, 20) < _CFG.min_level:
        return
    rec: Dict[str, Any] = {"ts": round(time.time(), 6), "level": level,
                           "event": event}
    if rid is not None:
        rec["rid"] = rid
    if channel is not None:
        rec["channel"] = channel
    if trace is not None:
        rec["trace"] = trace
    for k, v in fields.items():
        if v is not None:
            rec[k] = _json_safe(v)
    if _CFG.mode == "json":
        line = json.dumps(rec, separators=(",", ":"), default=repr)
    else:
        head = f"{rec['ts']:.3f} {level:<5} {event}"
        tail = " ".join(f"{k}={rec[k]}" for k in rec
                        if k not in ("ts", "level", "event"))
        line = f"{head} {tail}".rstrip()
    stream = _CFG.stream
    if stream is not None:
        # injected stream (tests): synchronous under the lock so the
        # caller can read its buffer deterministically
        with _WRITE_LOCK:
            try:
                stream.write(line + "\n")
                stream.flush()
            except Exception:  # noqa: BLE001 - logging never breaks the job
                pass
        return
    _ensure_writer()
    try:
        _LOG_Q.put_nowait(line)
    except _queue.Full:
        _CFG.dropped += 1  # losing a line beats blocking the caller

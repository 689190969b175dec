"""Fault injection: named failure points for the executor/serving stacks.

The port's copy of the reference package's ``runtime/faults.py``: the same
points, grammar and errors; its lock is a plain ``threading.Lock`` and its
``faults_injected_total{point=}`` counter and structured-log line go
through the port's telemetry and ``runtime/structlog.py``.

The reference system gets its fault-tolerance story from Spark — a task
that dies is replayed by the scheduler, and ``WorkerServer.recover``
mirrors the request-replay half of that (HTTPSourceV2.scala:488-505).
Our runtime's pipeline THREADS (stage/dispatch/drain in
runtime/executor.py, collect/score/reply in io/serving.py) have no
scheduler above them, so every degradation path has to be built — and
*proved* — in-process. This module is the proving half: a registry of
named injection points the runtime code is permanently instrumented
with, activatable per-point via API or the ``SYNAPSEML_FAULTS`` env var,
so tests and chaos CI can make any stage fail deterministically (or
probabilistically, under load) and assert the supervision/shedding/
isolation machinery actually recovers.

Design constraints:

- **Zero hot-path cost when inactive.** An instrumentation site holds a
  module-level :class:`FaultPoint` handle; ``fire()`` is a single
  attribute test (``self._spec is None``) when nothing is injected —
  the same degrade-to-nothing pattern runtime/telemetry.py uses for its
  kill switch. No dict lookups, no env reads, no locks on the hot path.
- **No torch import.** Serving imports this module and must stay
  importable without a device runtime; :class:`PipelineBrokenError`
  lives here for the same reason (both executor and serving raise it,
  and serving must not import the executor module).

Points (catalog in docs/robustness.md):

====================  =====================================================
``staging``           host coerce+pad worker (executor ``_stage_worker``)
``h2d``               host->device placement (executor ``_dispatch``)
``compute``           compiled-program call (executor ``_dispatch``);
                      scopes ``channel<N>`` hit ONE serving channel's
                      scoring path (``DistributedServer``) — the failure
                      domain the channel circuit breakers quarantine
``drain``             device->host fetch (executor ``_drain_loop``)
``reply``             reply serialization/send (serving ``_reply_scored``)
``latency``           injected sleep — scopes ``dispatch``, ``score``,
                      ``channel_stall`` (per-channel scoring stall: the
                      breaker's slow-channel trip condition)
``thread_kill``       raises :class:`ThreadKilled` (a BaseException) at a
                      pipeline-loop top so the THREAD dies, not the batch
                      — scopes ``stage``, ``dispatch``, ``drain``,
                      ``scorer``, ``reply``, ``collector``,
                      ``distributor``
====================  =====================================================

Env grammar (parsed once at import; :func:`configure` re-parses)::

    SYNAPSEML_FAULTS=point[.scope]:prob[:detail],...
    SYNAPSEML_FAULTS=compute:0.15                 # 15% of dispatches raise
    SYNAPSEML_FAULTS=thread_kill.drain:1          # kill the drain thread
    SYNAPSEML_FAULTS=compute:0.5:ValueError       # raise ValueError instead
    SYNAPSEML_FAULTS=latency.score:1:25           # 25ms sleep per score

``detail`` is an exception name (builtins or this module) — except for
``latency`` points, where it is a sleep duration in milliseconds.
A point name without a scope activates every scope of that family.
"""
from __future__ import annotations

import builtins
import os
import random
import re
import threading
import time
from typing import Any, Dict, Iterable, List, Optional, Tuple

from synapseml_tpu_torch.runtime import structlog as _slog
from synapseml_tpu_torch.runtime import telemetry as _tm

__all__ = [
    "FaultInjected", "ThreadKilled", "PipelineBrokenError", "FaultPoint",
    "point", "activate", "deactivate", "configure", "active",
    "POINT_NAMES", "POINT_SCOPES", "POINT_SCOPE_PATTERNS",
]

POINT_NAMES = ("staging", "h2d", "compute", "drain", "reply",
               "thread_kill", "latency")

# the full scope catalog per family (docs/robustness.md). Validated in
# activate(): a typo'd scope would otherwise arm a spec no
# instrumentation site ever resolves — a chaos run that silently
# injects NOTHING and proves nothing. Families absent here take no
# scope at all.
POINT_SCOPES: Dict[str, Tuple[str, ...]] = {
    "latency": ("dispatch", "score", "channel_stall"),
    "thread_kill": ("stage", "dispatch", "drain", "scorer", "reply",
                    "collector", "distributor"),
}

# open-ended scope families: serving channels are numbered at runtime
# (``compute.channel0``, ``compute.channel7``, ...), so the catalog
# validates them by pattern instead of enumeration — ``channelX`` is
# still a loud ValueError
POINT_SCOPE_PATTERNS: Dict[str, "re.Pattern[str]"] = {
    "compute": re.compile(r"^channel\d+$"),
}


class FaultInjected(RuntimeError):
    """Default exception an active fault point raises."""


class ThreadKilled(BaseException):
    """Raised by ``thread_kill`` points at a pipeline-loop top.

    Deliberately a ``BaseException``: every per-batch handler in the
    runtime catches ``Exception`` (or ``BaseException`` scoped to one
    unit) and converts it into a failed future / 500 reply — a kill
    must escape all of them and terminate the THREAD, because that is
    the failure mode supervision exists to catch."""


class PipelineBrokenError(RuntimeError):
    """A pipeline thread died; everything in flight was failed with this.

    Raised on every in-flight future (and from ``submit`` in the narrow
    window before supervision swaps the pipeline) when an executor
    stage/dispatch/drain thread dies unexpectedly. The supervision
    contract: no future ever hangs on a dead thread, and the NEXT submit
    gets a freshly restarted pipeline. The serving layer treats it as
    transient (one bounded retry re-submits against the restarted
    pipeline) before falling back to the 500 path."""


class _FaultSpec:
    """One activation: probability, effect, and an optional firing cap."""

    __slots__ = ("prob", "exc", "latency_s", "remaining", "lock")

    def __init__(self, prob: float, exc: Optional[type],
                 latency_s: float, times: Optional[int]):
        self.prob = float(prob)
        self.exc = exc
        self.latency_s = float(latency_s)
        self.remaining = times  # None = unlimited
        self.lock = threading.Lock()

    def describe(self) -> Dict[str, Any]:
        return {"prob": self.prob,
                "exc": self.exc.__name__ if self.exc else None,
                "latency_ms": self.latency_s * 1e3,
                "remaining": self.remaining}


class FaultPoint:
    """One named injection site. Sites resolve their handle once at
    module import (like telemetry metric handles) and call :meth:`fire`
    on the hot path — a single attribute test when inactive."""

    __slots__ = ("name", "scope", "_spec")

    def __init__(self, name: str, scope: Optional[str]):
        self.name = name
        self.scope = scope
        self._spec: Optional[_FaultSpec] = None  # synlint: shared

    @property
    def full_name(self) -> str:
        return self.name if self.scope is None \
            else f"{self.name}.{self.scope}"

    def fire(self):
        """Hot-path call: no-op unless this point has an active spec."""
        spec = self._spec
        if spec is None:
            return
        self._fire(spec)

    def _fire(self, spec: _FaultSpec):
        if spec.prob < 1.0 and random.random() >= spec.prob:
            return
        if spec.remaining is not None:
            # times-bounded faults (tests/chaos inject "exactly one
            # kill"): the decrement is guarded so concurrent hot paths
            # cannot overfire
            with spec.lock:
                if spec.remaining <= 0:
                    return
                spec.remaining -= 1
        _tm.counter("faults_injected_total", point=self.full_name).inc()
        # structured breadcrumb for chaos-run log correlation (debug:
        # probabilistic injections under load are high-volume); only
        # reached when a fault actually fires, so the disarmed hot
        # path stays a single attribute test
        _slog.log("debug", "fault_injected", point=self.full_name)
        if spec.latency_s > 0.0:
            time.sleep(spec.latency_s)
            if spec.exc is None:
                return
        exc = spec.exc or FaultInjected
        raise exc(f"injected fault at {self.full_name!r}")


_LOCK = threading.Lock()
_POINTS: Dict[Tuple[str, Optional[str]], FaultPoint] = {}
# active specs keyed the same way; (name, None) applies to every scope
# of the family, including points registered AFTER activation
_SPECS: Dict[Tuple[str, Optional[str]], _FaultSpec] = {}


def point(name: str, scope: Optional[str] = None) -> FaultPoint:
    """Get-or-create the injection point for an instrumentation site.
    Resolve once at module import; ``fire()`` on the hot path."""
    key = (name, scope)
    with _LOCK:
        p = _POINTS.get(key)
        if p is None:
            p = FaultPoint(name, scope)
            _POINTS[key] = p
            spec = _SPECS.get(key) or _SPECS.get((name, None))
            if spec is not None:
                p._spec = spec
        return p


def _split(point_name: str) -> Tuple[str, Optional[str]]:
    name, _, scope = point_name.partition(".")
    return name, (scope or None)


def activate(point_name: str, prob: float = 1.0,
             exc: Optional[type] = None, latency_ms: float = 0.0,
             times: Optional[int] = None) -> None:
    """Arm one point (``"compute"``) or one scope (``"thread_kill.drain"``).

    ``prob`` fires per call; ``times`` caps total firings (exhausted
    specs stay armed but inert); ``latency_ms`` sleeps instead of (or,
    combined with ``exc``, before) raising. ``exc=None`` raises
    :class:`FaultInjected` — except pure-latency points, which return
    normally after the sleep."""
    name, scope = _split(point_name)
    if name not in POINT_NAMES:
        raise ValueError(
            f"unknown fault point {point_name!r} (families: "
            f"{', '.join(POINT_NAMES)})")
    known_scopes = POINT_SCOPES.get(name, ())
    pattern = POINT_SCOPE_PATTERNS.get(name)
    if scope is not None and scope not in known_scopes and not (
            pattern is not None and pattern.match(scope)):
        hints = list(known_scopes)
        if pattern is not None:
            hints.append(pattern.pattern)
        raise ValueError(
            f"unknown scope {scope!r} for fault point {name!r}"
            + (f" (scopes: {', '.join(hints)})" if hints
               else " (this family takes no scope)"))
    if name == "latency" and latency_ms == 0.0:
        latency_ms = 10.0
    if name == "thread_kill" and exc is None:
        # the whole point of the family: a BaseException no per-batch
        # handler converts into a failed future / 500 reply
        exc = ThreadKilled
    spec = _FaultSpec(prob, exc, latency_ms / 1e3, times)
    with _LOCK:
        _SPECS[(name, scope)] = spec
        for (pn, ps), p in _POINTS.items():
            if pn == name and (scope is None or ps == scope):
                p._spec = spec


def deactivate(point_name: Optional[str] = None) -> None:
    """Disarm one point/scope, or everything (``None``) — the hot path
    returns to its single-attribute-test no-op."""
    with _LOCK:
        if point_name is None:
            _SPECS.clear()
            for p in _POINTS.values():
                p._spec = None
            return
        name, scope = _split(point_name)
        _SPECS.pop((name, scope), None)
        for (pn, ps), p in _POINTS.items():
            if pn == name and (scope is None or ps == scope):
                p._spec = (_SPECS.get((pn, ps))
                           or _SPECS.get((pn, None)))


def active() -> Dict[str, Dict[str, Any]]:
    """Currently armed specs, keyed by ``point[.scope]``."""
    with _LOCK:
        return {(n if s is None else f"{n}.{s}"): spec.describe()
                for (n, s), spec in _SPECS.items()}


def _resolve_exc(name: str) -> type:
    exc = globals().get(name) or getattr(builtins, name, None)
    if not (isinstance(exc, type) and issubclass(exc, BaseException)):
        raise ValueError(f"SYNAPSEML_FAULTS: {name!r} is not an exception")
    return exc


def configure(spec: str) -> List[str]:
    """Parse an env-grammar string (``point[.scope]:prob[:detail],...``)
    and arm each entry; returns the armed point names. Called once at
    import with ``SYNAPSEML_FAULTS``; tests/chaos may re-call it."""
    armed: List[str] = []
    for part in spec.split(","):
        part = part.strip()
        if not part:
            continue
        fields = part.split(":")
        pname = fields[0].strip()
        prob = float(fields[1]) if len(fields) > 1 and fields[1] else 1.0
        exc: Optional[type] = None
        latency_ms = 0.0
        if len(fields) > 2 and fields[2]:
            if _split(pname)[0] == "latency":
                latency_ms = float(fields[2])
            else:
                exc = _resolve_exc(fields[2].strip())
        activate(pname, prob=prob, exc=exc, latency_ms=latency_ms)
        armed.append(pname)
    return armed


_ENV_SPEC = os.environ.get("SYNAPSEML_FAULTS", "")
if _ENV_SPEC:
    configure(_ENV_SPEC)

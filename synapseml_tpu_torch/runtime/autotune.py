"""Verify-then-time autotuner: ONE prober for every measured lane.

The counterpart of the reference package's ``runtime/autotune.py``. Each
lane is one op with several formulations; its loop is: kill switch ->
cached verdict -> build every candidate -> verify it against the
production reference -> min-of-N timing -> persist the winner -> fall
back silently on mismatch, regression or crash. Any op joins by
registering:

    lane = register_lane(
        "my_op",
        key_fn=...,        # *route_args -> versioned shape-class key
        candidates={...},  # choice -> make(rargs, args) -> callable
        verify_fn=...,     # (got, want) -> bool, reference-relative
        reference="...",   # the production formulation (always safe)
        args_fn=...,       # *route_args -> concrete probe inputs
    )
    choice = lane.route(*route_args)

The first route of a new shape class probes (builds every candidate and
runs it once, verifies each against the reference output, times the
survivors with ``proberoute.best_of`` — which waits on the card and never
copies to the host in the timed region) and persists the verdict through
:class:`RouteTable`, so processes sharing a cache volume share it.

Failure contract (the silent-fallback half):

- candidate BUILD crash        -> reference, memoized in-process ONLY;
- candidate verify mismatch or
  run failure                  -> candidate disqualified; if none
  survive, the reference verdict IS persisted;
- timing regression            -> reference persisted;
- anything else in routing     -> reference served, never raised.

Two rules of the card: probes of one lane are single-flight (the slots of
a ``devices=`` executor, or two threads meeting one new class, run one
probe), and a route that finds no verdict while the current stream is
capturing a CUDA graph serves the reference and records nothing — a
probe's synchronizations cannot be captured, and the executor's eager
pass before each capture (``BatchedExecutor._capture``) is where verdicts
settle.

``SYNAPSEML_AUTOTUNE=0`` kills every lane at once: the reference serves
with zero probes and zero table I/O.

A lane may pass ``probe_hook`` — a whole-probe callable returning the
verdict string — instead of the decomposed candidates/args_fn/verify_fn
form (the int8 router's monkeypatchable ``_probe*`` seams). Either way the
routing loop, crash-memo semantics, persistence and telemetry live HERE.

Telemetry: ``autotune_route_total{lane=,choice=}`` counts every routed
decision; ``autotune_probe_seconds{lane=}`` observes full probe cost
(build + verify + timing).
"""
from __future__ import annotations

import functools
import os
import threading
import time
from typing import Any, Callable, Dict, Iterable, Optional, Tuple

import numpy as np
import torch

from synapseml_tpu_torch.runtime.proberoute import RouteTable, _force, best_of

_LANES: Dict[str, "Lane"] = {}


def enabled() -> bool:
    """Global kill switch — ``SYNAPSEML_AUTOTUNE=0`` serves every
    lane's reference with zero probes."""
    return os.environ.get("SYNAPSEML_AUTOTUNE", "1") != "0"


@functools.lru_cache(maxsize=None)
def _fingerprint(dev: str) -> str:
    from synapseml_tpu_torch.runtime import compile_cache as _cc

    return _cc.env_fingerprint(dev)


def key_prefix(tag: str, device=None) -> str:
    """Versioned key prefix: torch's, CUDA's and cuDNN's versions, the
    package version and the card's name (``cpu`` on the CPU), so a
    change of any of them re-probes instead of remembering. ``device``
    defaults to the current CUDA device where there is one."""
    import synapseml_tpu_torch as _pkg

    if device is None:
        device = "cuda" if torch.cuda.is_available() else "cpu"
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    pkg_v = getattr(_pkg, "__version__", "0")
    return f"at1|{_fingerprint(str(dev))}|pkg{pkg_v}|{tag}"


def pow2(v: int, lo: int = 1, hi: int = 65536) -> int:
    """Shared shape-bucketing helper: next power of two, clamped."""
    return 1 << (int(min(max(v, lo), hi)) - 1).bit_length()


def capturing() -> bool:
    """The current stream is capturing a CUDA graph (False without
    CUDA)."""
    return (torch.cuda.is_available()
            and torch.cuda.is_current_stream_capturing())


def aot(fn, *args):
    """The candidate, run once on its probe inputs and waited for, so
    that lazy initialisation and cuDNN and cuBLAS plans happen outside the
    timed region (the reference's ahead-of-time compile has no other
    counterpart on the card); returns ``fn``."""
    _force(fn(*args))
    return fn


def _host(x):
    if isinstance(x, torch.Tensor):
        t = x.detach().cpu()
        return (t.float() if t.dtype == torch.bfloat16 else t).numpy()
    return np.asarray(x)


def _fetch(out):
    """Value-fetch ONE leg's output for the verify comparison — the
    only place a probe is allowed to pay D2H."""
    if isinstance(out, (tuple, list)):
        return tuple(_host(o) for o in out)
    return _host(out)


def _count(lane: str, choice: str) -> None:
    try:
        from synapseml_tpu_torch.runtime import telemetry

        telemetry.counter("autotune_route_total",
                          lane=lane, choice=choice).inc()
    except Exception:  # noqa: BLE001 - telemetry must never gate serving
        pass


def _observe_probe(lane: str, seconds: float) -> None:
    try:
        from synapseml_tpu_torch.runtime import telemetry

        telemetry.histogram("autotune_probe_seconds",
                            lane=lane).observe(seconds)
    except Exception:  # noqa: BLE001
        pass


class Lane:
    """One registered op with N formulations. Instances come from
    :func:`register_lane`; callers use :meth:`route` (may probe),
    :meth:`cached` (lookup-only), :meth:`poison` (persist a demotion
    after a runtime failure of the routed leg)."""

    def __init__(self, name: str, key_fn: Callable[..., str],
                 candidates: Dict[str, Optional[Callable]],
                 verify_fn: Optional[Callable[[Any, Any], bool]],
                 reference: str,
                 args_fn: Optional[Callable[..., Tuple]] = None,
                 probe_hook: Optional[Callable[..., str]] = None,
                 time_fn: Optional[Callable] = None,
                 table: Optional[RouteTable] = None,
                 groups: Iterable[str] = (), reps: int = 2):
        if reference not in candidates:
            raise ValueError(
                f"lane {name!r}: reference {reference!r} not a candidate")
        if probe_hook is None and args_fn is None:
            raise ValueError(
                f"lane {name!r}: needs args_fn (or a probe_hook)")
        self.name = name
        self.key_fn = key_fn
        self.candidates = dict(candidates)
        self.verify_fn = verify_fn
        self.reference = reference
        self.args_fn = args_fn
        self.probe_hook = probe_hook
        self.time_fn = time_fn or (
            lambda fn, args, reps: best_of(fn, args, reps))
        self.table = table or RouteTable(f"autotune_{name}.json")
        self.groups = tuple(groups)
        self.reps = reps
        self.probes = 0  # probes RUN by this process, this lane
        self.decisions: Dict[str, str] = {}  # key -> served choice
        self._probe_lock = threading.Lock()  # single-flight probes

    # -- routing ----------------------------------------------------

    def route(self, *rargs) -> str:
        """Cached verdict, else probe-and-persist. Never raises; the
        reference serves on any routing failure, and under a CUDA-graph
        capture a class without a verdict serves the reference and
        records nothing."""
        if not enabled():
            _count(self.name, self.reference)
            return self.reference
        try:
            key = self.key_fn(*rargs)
            got = self.table.lookup(key)
            if got is None:
                if capturing():
                    _count(self.name, self.reference)
                    return self.reference
                with self._probe_lock:
                    got = self.table.lookup(key)
                    if got is None:
                        got, persist = self._probe_guarded(rargs)
                        self.table.record(key, got, persist=persist)
            choice = got if got in self.candidates else self.reference
            self.decisions[key] = choice
        except Exception:  # noqa: BLE001 - routing never fails the op
            choice = self.reference
        _count(self.name, choice)
        return choice

    def cached(self, *rargs) -> Optional[str]:
        """Lookup-only: the persisted choice, or None when nothing is
        measured yet. Never probes, never counts."""
        if not enabled():
            return None
        try:
            key = self.key_fn(*rargs)
            got = self.table.lookup(key)
        except Exception:  # noqa: BLE001
            return None
        if got is None or got not in self.candidates:
            return None
        self.decisions[key] = got
        return got

    def poison(self, *rargs) -> None:
        """Persist a demotion to the reference after the routed leg
        failed at runtime — the failure is not re-paid after restart."""
        try:
            key = self.key_fn(*rargs)
            self.table.record(key, self.reference)
            self.decisions[key] = self.reference
        except Exception:  # noqa: BLE001
            pass

    # -- probing ----------------------------------------------------

    def _probe_guarded(self, rargs) -> Tuple[str, bool]:
        t0 = time.perf_counter()
        try:
            got = (self.probe_hook(*rargs) if self.probe_hook is not None
                   else self.probe(rargs))
            persist = True
        except Exception:  # noqa: BLE001 - probe crash = reference leg
            # memoized in-process ONLY (never persisted): a transient
            # crash must not be remembered fleet-wide, but a
            # deterministic one costs one probe per process, not one
            # per dispatch
            got, persist = self.reference, False
        self.probes += 1
        _observe_probe(self.name, time.perf_counter() - t0)
        return got, persist

    def probe(self, rargs) -> str:
        """Decomposed-lane probe: build every candidate at the probe
        args, then hand off to the shared verify-then-time core."""
        args = tuple(self.args_fn(*rargs))
        fns = {}
        for choice, make in self.candidates.items():
            # a reference build failure propagates (crash semantics)
            fns[choice] = make(rargs, args)
        return verify_then_time(fns, args, self.reference,
                                verify_fn=self.verify_fn,
                                time_fn=self.time_fn, reps=self.reps)

    def reset(self) -> None:
        """Test hook: drop table memos and in-process decisions."""
        self.table.clear()
        self.decisions.clear()
        self.probes = 0


def verify_then_time(fns, args, reference: str, verify_fn=None,
                     time_fn=None, reps: int = 2) -> str:
    """THE verify-then-time core every lane shares: run the reference,
    value-fetch its output ONCE for the comparison, disqualify candidates
    that mismatch or fail, min-of-N time reference + survivors (no D2H in
    the timed region), return the winner. A candidate wins ties: it would
    not have survived verification unless interchangeable. No survivors
    -> the reference verdict."""
    tf = time_fn or (lambda fn, a, r: best_of(fn, a, r))
    vf = verify_fn or _default_verify
    want = _fetch(fns[reference](*args))
    survivors = []
    for choice, fn in fns.items():
        if choice == reference:
            continue
        try:
            ok = vf(_fetch(fn(*args)), want)
        except Exception:  # noqa: BLE001 - candidate run/verify failure
            ok = False
        if ok:
            survivors.append(choice)
    if not survivors:
        return reference
    best_c = reference
    best_t = tf(fns[reference], args, reps)
    for choice in survivors:
        t = tf(fns[choice], args, reps)
        if t <= best_t:
            best_c, best_t = choice, t
    return best_c


def _default_verify(got, want) -> bool:
    """Same structure and shapes + allclose — lanes with looser or
    stricter contracts pass their own verify_fn."""
    if isinstance(want, tuple) != isinstance(got, tuple):
        return False
    gs = got if isinstance(got, tuple) else (got,)
    ws = want if isinstance(want, tuple) else (want,)
    if len(gs) != len(ws):
        return False
    for g, w in zip(gs, ws):
        if g.shape != w.shape:
            return False
        if not np.allclose(g, w, rtol=1e-4, atol=1e-5, equal_nan=True):
            return False
    return True


def register_lane(name: str, key_fn: Callable[..., str],
                  candidates, verify_fn=None, *, reference: str,
                  args_fn=None, probe_hook=None, time_fn=None,
                  table: Optional[RouteTable] = None,
                  groups: Iterable[str] = (), reps: int = 2) -> Lane:
    """Register (or replace) a lane. ``candidates`` is either
    {choice: make(rargs, args) -> callable} for the decomposed form,
    or an iterable of choice names when a ``probe_hook`` computes the
    verdict itself."""
    if not isinstance(candidates, dict):
        candidates = {c: None for c in candidates}
    lane = Lane(name, key_fn, candidates, verify_fn, reference,
                args_fn=args_fn, probe_hook=probe_hook, time_fn=time_fn,
                table=table, groups=groups, reps=reps)
    _LANES[name] = lane
    return lane


def lane(name: str) -> Optional[Lane]:
    return _LANES.get(name)


def lanes() -> Dict[str, Lane]:
    return dict(_LANES)


def route(name: str, *rargs) -> str:
    return _LANES[name].route(*rargs)


def cached(name: str, *rargs) -> Optional[str]:
    return _LANES[name].cached(*rargs)


def poison(name: str, *rargs) -> None:
    _LANES[name].poison(*rargs)


def snapshot() -> dict:
    """Every lane's decisions so far — which formulation serves which
    shape class."""
    return {
        "enabled": enabled(),
        "lanes": {
            n: {
                "reference": ln.reference,
                "candidates": sorted(ln.candidates),
                "groups": list(ln.groups),
                "probes": ln.probes,
                "decisions": dict(ln.decisions),
                "table": ln.table.filename,
            }
            for n, ln in sorted(_LANES.items())
        },
    }


def clear() -> None:
    """Test hook: reset every registered lane's memo state (the
    registrations themselves persist — modules register at import)."""
    for ln in _LANES.values():
        ln.reset()

"""Persisted measured-routing verdicts shared by the probers.

The counterpart of the reference package's ``runtime/proberoute.py``: a
backend choice is a MEASURED verdict keyed by shape class, memoized
in-process and persisted under ``SYNAPSEML_TPU_CACHE_DIR`` so one probe
cost covers all later runs. The negative memo ("no verdict on disk for
this key") holds a TTL, so a verdict landed by ANOTHER worker on a shared
cache volume becomes visible within ``neg_ttl_s`` instead of only after a
restart.

Lookups are host-side dict and file reads; probing and persistence are
the caller's job. On the card, :func:`best_of` waits for a leg's output
on its device (``torch.cuda.synchronize``) and never copies it to the
host inside the timed region.
"""
from __future__ import annotations

import json
import os
import threading
import time
from typing import Dict, Optional

import torch

# default negative-memo TTL: long enough that a shape with no verdict
# does not re-open the cache file on every call, short enough that a
# sibling worker's probe verdict lands without a process restart
_DEFAULT_NEG_TTL_S = 60.0


def cache_dir() -> str:
    return os.environ.get("SYNAPSEML_TPU_CACHE_DIR") or os.path.join(
        os.path.expanduser("~"), ".cache", "synapseml_tpu")


def neg_ttl_s() -> float:
    try:
        return float(os.environ.get("SYNAPSEML_ROUTE_NEG_TTL_S",
                                    _DEFAULT_NEG_TTL_S))
    except ValueError:
        return _DEFAULT_NEG_TTL_S


def _cuda_devices(out, found: set) -> set:
    if isinstance(out, torch.Tensor):
        if out.is_cuda:
            found.add(out.device)
    elif isinstance(out, (tuple, list)):
        for o in out:
            _cuda_devices(o, found)
    elif isinstance(out, dict):
        for o in out.values():
            _cuda_devices(o, found)
    return found


def _force(out) -> None:
    """Wait until ``out`` is computed WITHOUT fetching its value: every
    card its tensors live on is synchronized, and nothing is copied to
    the host — a D2H copy here would drag into the timed region and
    mis-penalize device-resident formulations. Host outputs are already
    computed. Value fetches belong in the verify leg only."""
    for dev in _cuda_devices(out, set()):
        torch.cuda.synchronize(dev)


def best_of(fn, args, reps: int = 2) -> float:
    """min-of-N wall time of one probe leg, completion forced by
    :func:`_force` (no D2H in the timed region) — the shared timing half
    of every measured prober."""
    _force(fn(*args))  # warm
    best = float("inf")
    for _ in range(reps):
        t0 = time.perf_counter()
        _force(fn(*args))
        best = min(best, time.perf_counter() - t0)
    return best


class RouteTable:
    """One lane's verdict table: {key: verdict-string} with an
    in-process memo, best-effort JSON persistence, and a TTL'd
    negative memo. Thread-safe; file I/O happens OUTSIDE the lock
    (a slow shared volume must not park other lookups)."""

    def __init__(self, filename: str):
        self.filename = filename
        self._memo: Dict[str, str] = {}
        self._neg: Dict[str, float] = {}  # key -> monotonic expiry
        self._lock = threading.Lock()
        self._read_lock = threading.Lock()  # single-flight disk reads
        self._read_gen = 0  # bumped after every merged disk read

    def path(self) -> str:
        return os.path.join(cache_dir(), self.filename)

    def _load_disk(self) -> Dict[str, str]:
        try:
            with open(self.path()) as fh:
                got = json.load(fh)
            return got if isinstance(got, dict) else {}
        except Exception:  # noqa: BLE001 - cache is best-effort
            return {}

    def lookup(self, key: str) -> Optional[str]:
        """Memoized verdict for ``key``; None = nothing measured yet.
        A disk re-read happens on first sight and again whenever the
        negative memo's TTL expires — the shared-volume visibility
        window."""
        now = time.monotonic()
        with self._lock:
            got = self._memo.get(key)
            if got is not None:
                return got
            exp = self._neg.get(key)
            if exp is not None and now < exp:
                return None
            gen = self._read_gen
        # single-flight: concurrent missers share ONE disk read. The
        # loser parks on _read_lock while the winner reads; when it
        # gets in and sees the generation advanced past its sample, the
        # winner's merge already covers it. A SEQUENTIAL misser samples
        # the post-merge generation and still re-reads (the TTL contract)
        with self._read_lock:
            with self._lock:
                merged = self._read_gen != gen
            if not merged:
                disk = self._load_disk()
                with self._lock:
                    for k, v in disk.items():
                        self._memo.setdefault(k, str(v))
                    self._read_gen += 1
        with self._lock:
            got = self._memo.get(key)
            if got is None:
                self._neg[key] = now + neg_ttl_s()
            else:
                self._neg.pop(key, None)
            return got

    def record(self, key: str, verdict: str,
               persist: bool = True) -> None:
        """Land a verdict: memo immediately (retiring THIS key's
        negative), merge-write the disk file when ``persist``, then
        retire only the negatives the merged snapshot satisfies."""
        with self._lock:
            self._memo[key] = verdict
            self._neg.pop(key, None)
        if not persist:
            return
        path = self.path()
        try:
            # merge-then-atomic-replace: re-read immediately before the
            # write (narrowing the lost-update window against sibling
            # workers on a shared volume) and land via tmp-then-rename
            # so a crashed writer never leaves a torn file. Best-effort
            # by design — a lost race costs one re-probe
            disk = self._load_disk()
            disk[key] = verdict
            os.makedirs(os.path.dirname(path), exist_ok=True)
            tmp = f"{path}.{os.getpid()}.{threading.get_ident()}.tmp"
            with open(tmp, "w") as fh:
                json.dump(disk, fh, indent=0)
            os.replace(tmp, path)
        except Exception:  # noqa: BLE001 - persistence is best-effort
            return
        with self._lock:
            # the pre-write merge may have surfaced sibling verdicts:
            # fold them in and retire exactly the negatives they satisfy
            for k, v in disk.items():
                self._memo.setdefault(k, str(v))
            for k in [k for k in self._neg if k in self._memo]:
                self._neg.pop(k, None)

    def clear(self) -> None:
        with self._lock:
            self._memo.clear()
            self._neg.clear()

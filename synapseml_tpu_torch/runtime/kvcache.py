"""Paged KV-cache accounting for decode serving (vLLM SOSP'23 shape).

The port's copy of the reference package's ``runtime/kvcache.py``: the
same page accounting, LRU eviction and telemetry names, with a plain
``threading.Lock`` and the port's perfwatch (its limit is the card's
total memory, ``torch.cuda.mem_get_info``).

The decode scheduler (:mod:`~synapseml_tpu_torch.runtime.decode`) keeps the
actual key/value tensors device-resident inside fixed-geometry batch
buffers — ``[B, Hkv, T, D]`` per layer, one compiled program per
(S, T) signature. What is NOT fixed is how much of that geometry a
replica can afford to keep live: sequences arrive with unknown output
lengths, and a cache that only ever grows walks the chip into an OOM
the serving layer can neither predict nor survive. This module is the
capacity/policy half of the cache:

- **pages**: every sequence's cache footprint is accounted in fixed
  ``page_size``-token pages (``ceil(len / page_size)``), so capacity
  arithmetic is exact under growth and never fragments — freeing a
  sequence returns whole pages.
- **capacity**: sized off the perfwatch device-memory records —
  ``SYNAPSEML_KV_HBM_FRACTION`` (default 0.3) of the smallest card
  total across the process's CUDA devices. A process without CUDA (the
  CPU) reports limit 0 and falls back to a fixed default;
  ``SYNAPSEML_KV_CAPACITY_BYTES`` overrides everything (how CI induces
  eviction deterministically).
- **LRU evict-then-recompute**: when an allocation does not fit, the
  least-recently-stepped *other* resident sequence is evicted whole.
  Eviction frees pages only — the evicted sequence keeps its full
  token history (prompt + everything generated) and re-enters the
  scheduler's admission queue to be *re-prefilled*; the recompute is
  bit-identical because greedy decode over the same tokens and weights
  is deterministic (the decode-smoke replay asserts the digests).
- **HBM backpressure**: the scheduler calls
  :meth:`under_pressure` each iteration; while perfwatch's
  ``hbm_high_water`` latch is set for any device, admission pauses and
  one LRU eviction per iteration sheds load until the device falls
  back under the line.

Nothing here touches device memory: eviction *decisions* live here,
the buffers (and the act of zeroing a freed row) live in the
scheduler. Telemetry: ``kv_capacity_bytes`` / ``kv_pages_in_use`` /
``kv_bytes_in_use`` / ``kv_sequences_resident`` gauges and
``kv_evictions_total{reason=}`` / ``kv_recomputes_total`` /
``kv_evicted_tokens_total`` counters (docs/observability.md).
"""
from __future__ import annotations

import os
import threading
from typing import Dict, List, Optional

from synapseml_tpu_torch.runtime import blackbox as _bb
from synapseml_tpu_torch.runtime import telemetry as _tm

__all__ = ["PagedKVCache", "kv_capacity_bytes", "under_pressure"]

# capacity fallback when no backend reports an HBM limit (CPU test
# platform) and no explicit override is set
_DEFAULT_CAPACITY_BYTES = 256 << 20


def kv_capacity_bytes() -> int:
    """Resolve the cache byte budget: explicit override, else the HBM
    fraction of the tightest device limit, else the fixed default."""
    explicit = os.environ.get("SYNAPSEML_KV_CAPACITY_BYTES", "")
    if explicit:
        try:
            return max(0, int(explicit))
        except ValueError:
            pass
    try:
        frac = float(os.environ.get("SYNAPSEML_KV_HBM_FRACTION", "0.3"))
    except ValueError:
        frac = 0.3
    from synapseml_tpu_torch.runtime import perfwatch as _pw

    limits = [rec.get("bytes_limit") or 0 for rec in _pw.device_memory()]
    limits = [l for l in limits if l > 0]
    if not limits:
        return _DEFAULT_CAPACITY_BYTES
    return int(min(limits) * frac)


class PagedKVCache:
    """Page allocator + residency tracker for one decode scheduler.

    Thread-safe; every mutation happens under one lock (the scheduler
    loop is the only writer in practice, the gauges read at scrape
    time)."""

    def __init__(self, page_size: int, bytes_per_token: int,
                 capacity_bytes: Optional[int] = None,
                 name: str = "decode"):
        if page_size <= 0:
            raise ValueError(f"page_size={page_size} must be positive")
        if bytes_per_token <= 0:
            raise ValueError(
                f"bytes_per_token={bytes_per_token} must be positive")
        self.page_size = int(page_size)
        self.bytes_per_token = int(bytes_per_token)
        self.page_bytes = self.page_size * self.bytes_per_token
        cap = kv_capacity_bytes() if capacity_bytes is None \
            else int(capacity_bytes)
        # at least one max-footprint sequence must fit or the scheduler
        # would evict forever without progress; capacity_pages >= 1
        self.capacity_pages = max(1, cap // self.page_bytes)
        self.name = name
        self._lock = threading.Lock()
        self._pages: Dict[str, int] = {}      # seq id -> pages held
        self._tokens: Dict[str, int] = {}     # seq id -> tokens covered
        self._clock = 0
        self._last_used: Dict[str, int] = {}  # seq id -> LRU stamp
        self._m_evict = {
            reason: _tm.counter("kv_evictions_total", cache=name,
                                reason=reason)
            for reason in ("capacity", "hbm_high_water")}
        self._m_recompute = _tm.counter("kv_recomputes_total", cache=name)
        self._m_evicted_tokens = _tm.counter("kv_evicted_tokens_total",
                                             cache=name)
        _tm.gauge_fn("kv_capacity_bytes",
                     lambda: float(self.capacity_pages * self.page_bytes),
                     cache=name)
        _tm.gauge_fn("kv_pages_in_use",
                     lambda: float(self.pages_in_use()), cache=name)
        _tm.gauge_fn("kv_bytes_in_use",
                     lambda: float(self.pages_in_use() * self.page_bytes),
                     cache=name)
        _tm.gauge_fn("kv_sequences_resident",
                     lambda: float(len(self._pages)), cache=name)

    def close(self) -> None:
        """Unregister the instance-scope gauges (scheduler shutdown) so
        a dead cache neither leaks through the registry nor keeps
        exporting its last values."""
        for series in ("kv_capacity_bytes", "kv_pages_in_use",
                       "kv_bytes_in_use", "kv_sequences_resident"):
            _tm.unregister(series, cache=self.name)

    # -- queries --------------------------------------------------------
    def pages_for(self, n_tokens: int) -> int:
        return max(1, -(-int(n_tokens) // self.page_size))

    def pages_in_use(self) -> int:
        with self._lock:
            return sum(self._pages.values())

    def resident(self, seq_id: str) -> bool:
        with self._lock:
            return seq_id in self._pages

    def fits(self, n_tokens: int) -> bool:
        """Would a fresh sequence of ``n_tokens`` fit without evicting?"""
        with self._lock:
            free = self.capacity_pages - sum(self._pages.values())
        return self.pages_for(n_tokens) <= free

    # -- mutations ------------------------------------------------------
    def touch(self, seq_id: str) -> None:
        """LRU bump — the scheduler marks every sequence it stepped."""
        with self._lock:
            self._clock += 1
            self._last_used[seq_id] = self._clock

    def acquire(self, seq_id: str, n_tokens: int,
                reason: str = "capacity") -> Optional[List[str]]:
        """Grow (or admit) ``seq_id`` to cover ``n_tokens``; evict LRU
        *other* sequences as needed. Returns the evicted sequence ids
        (often empty), or ``None`` when the allocation cannot fit even
        after evicting everything else — the caller must queue the
        sequence instead of admitting it."""
        need = self.pages_for(n_tokens)
        if need > self.capacity_pages:
            return None
        evicted: List[str] = []
        with self._lock:
            held = self._pages.get(seq_id, 0)
            while (sum(self._pages.values()) - held + need
                   > self.capacity_pages):
                victim = self._lru_locked(exclude=seq_id)
                if victim is None:
                    return None
                evicted.append(victim)
                self._evict_locked(victim, reason)
            self._pages[seq_id] = need
            self._tokens[seq_id] = int(n_tokens)
            self._clock += 1
            self._last_used[seq_id] = self._clock
        return evicted

    def evict_lru(self, reason: str = "hbm_high_water",
                  exclude: Optional[str] = None) -> Optional[str]:
        """Evict the least-recently-stepped resident sequence (the HBM
        backpressure path). Returns its id, or None if nothing to
        evict."""
        with self._lock:
            victim = self._lru_locked(exclude=exclude)
            if victim is not None:
                self._evict_locked(victim, reason)
            return victim

    def release(self, seq_id: str) -> None:
        """Free a finished sequence's pages (not an eviction)."""
        with self._lock:
            self._pages.pop(seq_id, None)
            self._tokens.pop(seq_id, None)
            self._last_used.pop(seq_id, None)

    def note_recompute(self, seq_id: str) -> None:
        """The scheduler re-prefilled an evicted sequence — the other
        half of the evict-then-recompute contract."""
        self._m_recompute.inc()

    # -- internals ------------------------------------------------------
    def _lru_locked(self, exclude: Optional[str]) -> Optional[str]:
        candidates = [(stamp, sid) for sid, stamp in
                      self._last_used.items()
                      if sid != exclude and sid in self._pages]
        if not candidates:
            return None
        return min(candidates)[1]

    def _evict_locked(self, seq_id: str, reason: str) -> None:
        pages = self._pages.pop(seq_id, 0)
        tokens = self._tokens.pop(seq_id, 0)
        self._last_used.pop(seq_id, None)
        m = self._m_evict.get(reason)
        if m is None:
            m = _tm.counter("kv_evictions_total", cache=self.name,
                            reason=reason)
            self._m_evict[reason] = m
        m.inc()
        self._m_evicted_tokens.inc(tokens)
        _bb.record("kv_evicted", level="info", cache=self.name,
                   seq=seq_id, pages=pages, tokens=tokens, reason=reason)


def under_pressure() -> bool:
    """True while any local device sits above the perfwatch high-water
    line — the scheduler's pause-admission / shed-one-LRU signal. Uses
    the same TTL-cached sample the gauges read, so polling every
    iteration costs one dict walk, not a device walk."""
    from synapseml_tpu_torch.runtime import perfwatch as _pw

    try:
        frac = _pw.high_water_fraction()
        if frac <= 0:
            return False
        for rec in _pw._sampled():
            limit = rec.get("bytes_limit") or 0
            if limit > 0 and rec["bytes_in_use"] / limit >= frac:
                return True
    except Exception:  # noqa: BLE001 - telemetry must never break decode
        return False
    return False

"""Performance observatory, device-memory half: what the decode
scheduler's KV cache sizes itself by and the HBM high-water latch it
backs off on.

The port's counterpart of the reference package's
``runtime/perfwatch.py`` (device memory, the process-lifetime peak, the
``hbm_high_water`` flight-recorder event and the ``memory_snapshot``
payload). A sample reads each CUDA device of the process through the
caching allocator and ``cudaMemGetInfo``:

- ``bytes_in_use``: ``torch.cuda.memory_stats()["allocated_bytes.all.current"]``,
  the bytes of live tensors in PyTorch's caching allocator (blocks it
  holds in reserve for reuse are not in use);
- ``peak_bytes_in_use``: ``allocated_bytes.all.peak``, the allocator's
  own peak since the process started (or since
  ``torch.cuda.reset_peak_memory_stats``);
- ``live_buffers``: ``allocation.all.current``, the allocator's live
  blocks;
- ``bytes_limit``: the card's total memory, the second value of
  ``torch.cuda.mem_get_info()``.

A device is sampled only once the process has initialised CUDA: a sample
never brings a CUDA context up on its own. A process without one (the
CPU) reports one ``cpu`` record with ``bytes_limit`` 0, as the
reference's CPU backend does, so :func:`kvcache.kv_capacity_bytes`
falls back to its fixed default and the high-water event never fires.

Not ported yet (ROADMAP Queue 1 item 6g): the gauges and their
registration, the executors' duty cycles, the process gauges
(``process_stats``), the tensor-parallel parameter bytes and the
``GET /debug/memory`` route.
"""
from __future__ import annotations

import os
import threading
import time
from typing import Any, Dict, List, Optional

import torch

from synapseml_tpu_torch.runtime import blackbox as _bb

__all__ = ["device_memory", "memory_snapshot", "check_high_water",
           "high_water_fraction", "set_high_water_fraction"]

_LOCK = threading.Lock()

# one real device walk serves every reader within the TTL: the decode
# loop polls the high-water latch each iteration, and the allocator and
# memory-info queries are not free
_MEM_TTL_S = 0.5


class _State:
    def __init__(self):
        # process-lifetime high-water per device key (bytes): the max of
        # every sampled bytes_in_use and the allocator's own peak counter
        self.peak: Dict[str, int] = {}
        # per-device "already above the line" latch for the high-water
        # event debounce (one event per crossing, not per sample)
        self.high: Dict[str, bool] = {}
        self.mem_cache: Optional[List[Dict[str, Any]]] = None
        self.mem_cache_ts = 0.0
        frac = os.environ.get("SYNAPSEML_HBM_HIGH_WATER", "0.9")
        try:
            self.high_water = float(frac)
        except ValueError:
            self.high_water = 0.9


_S = _State()


def high_water_fraction() -> float:
    return _S.high_water


def set_high_water_fraction(frac: float) -> float:
    """Retune the high-water threshold (tests, serving entry); returns
    the previous value. 0 disables the event."""
    prev = _S.high_water
    _S.high_water = float(frac)
    return prev


def _cuda_record(index: int) -> Dict[str, Any]:
    stats = torch.cuda.memory_stats(index)
    _free, total = torch.cuda.mem_get_info(index)
    return {
        "device": str(index), "platform": "gpu",
        "source": "memory_stats",
        "bytes_in_use": int(stats.get("allocated_bytes.all.current", 0)),
        "bytes_limit": int(total),
        "peak_bytes_in_use": int(stats.get("allocated_bytes.all.peak", 0)),
        "live_buffers": int(stats.get("allocation.all.current", 0)),
    }


def device_memory() -> List[Dict[str, Any]]:
    """One record per CUDA device of a process that has initialised
    CUDA, else one ``cpu`` record with limit 0. Pure sample — no peak
    update, no events (that is :func:`_sampled`'s job)."""
    if torch.cuda.is_initialized():
        out = []
        for i in range(torch.cuda.device_count()):
            try:
                out.append(_cuda_record(i))
            except Exception:  # noqa: BLE001 - a device that cannot answer
                continue
        if out:
            return out
    return [{"device": "cpu", "platform": "cpu", "source": "none",
             "bytes_in_use": 0, "bytes_limit": 0, "peak_bytes_in_use": 0,
             "live_buffers": 0}]


def _apply_peaks(devices: List[Dict[str, Any]]) -> None:
    """Fold a sample into the process-lifetime peaks and annotate each
    record with ``process_peak_bytes``."""
    with _LOCK:
        for rec in devices:
            key = rec["device"]
            peak = max(_S.peak.get(key, 0), rec["bytes_in_use"],
                       rec["peak_bytes_in_use"])
            _S.peak[key] = peak
            rec["process_peak_bytes"] = peak


def check_high_water(devices: List[Dict[str, Any]],
                     fraction: Optional[float] = None) -> List[str]:
    """Latch-debounced high-water detection over one sample: a device
    whose ``bytes_in_use / bytes_limit`` crosses ``fraction`` records
    ONE ``hbm_high_water`` flight-recorder event (which also emits the
    structured log line); the latch re-arms when usage falls below 85%
    of the threshold. Devices with no known limit (the CPU record) never
    fire. Returns the device keys that fired."""
    frac = _S.high_water if fraction is None else fraction
    fired: List[str] = []
    if frac <= 0:
        return fired
    for rec in devices:
        limit = rec.get("bytes_limit") or 0
        if limit <= 0:
            continue
        key = rec["device"]
        ratio = rec["bytes_in_use"] / limit
        with _LOCK:
            was = _S.high.get(key, False)
            if ratio >= frac and not was:
                _S.high[key] = True
                fire = True
            else:
                fire = False
                if was and ratio < frac * 0.85:
                    _S.high[key] = False
        if fire:
            # leaf call: blackbox.record takes only its own ring lock
            _bb.record("hbm_high_water", level="warn", device=key,
                       platform=rec.get("platform"),
                       bytes_in_use=rec["bytes_in_use"],
                       bytes_limit=limit,
                       fraction=round(ratio, 4), threshold=frac)
            fired.append(key)
    return fired


def _sampled(force: bool = False) -> List[Dict[str, Any]]:
    """TTL-cached sample with the peak/high-water side effects applied —
    what the decode loop and the snapshot read. ``force`` bypasses the
    cache (an operator asking wants *now*)."""
    now = time.monotonic()
    if not force:
        with _LOCK:
            if (_S.mem_cache is not None
                    and now - _S.mem_cache_ts < _MEM_TTL_S):
                return _S.mem_cache
    devices = device_memory()  # device queries outside the lock
    _apply_peaks(devices)
    check_high_water(devices)
    with _LOCK:
        _S.mem_cache = devices
        _S.mem_cache_ts = now
    return devices


def memory_snapshot(force: bool = True) -> Dict[str, Any]:
    """Per-device records plus process totals (the reference's
    ``GET /debug/memory`` payload without its tensor-parallel parameter
    bytes). ``force=True`` (the default) takes a fresh sample."""
    # copies — _sampled()'s records are TTL-cached and shared
    devices = [dict(d) for d in _sampled(force=force)]
    return {
        "ts": round(time.time(), 6),
        "pid": os.getpid(),
        "high_water_fraction": _S.high_water,
        "devices": devices,
        "totals": {
            "bytes_in_use": sum(d["bytes_in_use"] for d in devices),
            "live_buffers": sum(d["live_buffers"] for d in devices),
            "process_peak_bytes": sum(
                d.get("process_peak_bytes", 0) for d in devices),
        },
    }

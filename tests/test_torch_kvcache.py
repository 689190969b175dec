"""The port's paged KV-cache accounting (``runtime/kvcache.py``) and the
device-memory records it sizes itself by (``runtime/perfwatch.py``)
against the JAX package's, on the CPU.

Each scenario of ``tests/test_decode.py:33-107`` runs the same acquire,
touch, release and evict sequence through both packages'
``PagedKVCache``: every step's result (evicted ids, page counts, fits,
residency) must be equal, and the port's must be what the reference's
test asserts.
"""
import pytest

from synapseml_tpu.runtime import kvcache as ref_kvcache
from synapseml_tpu.runtime import perfwatch as ref_perfwatch
from synapseml_tpu_torch.runtime import blackbox
from synapseml_tpu_torch.runtime import kvcache
from synapseml_tpu_torch.runtime import perfwatch
from synapseml_tpu_torch.runtime import telemetry


def _cache(mod, pages=4, page_size=8, bpt=16, name="t_kvunit"):
    return mod.PagedKVCache(page_size, bpt,
                            capacity_bytes=pages * page_size * bpt,
                            name=name)


def _pages_for(mod):
    kv = _cache(mod, name="t_kv_pages")
    return [kv.pages_for(n) for n in (1, 8, 9, 0, 17, 64)]


def _accounting(mod):
    kv = _cache(mod, name="t_kv_acct")
    seen = [kv.capacity_pages, kv.acquire("a", 8), kv.acquire("b", 17),
            kv.pages_in_use(), kv.resident("a"), kv.resident("b"),
            kv.fits(1)]
    kv.release("b")
    return seen + [kv.pages_in_use(), kv.fits(24), kv.fits(25)]


def _grow_in_place(mod):
    kv = _cache(mod, name="t_kv_grow")
    seen = [kv.acquire("a", 8), kv.acquire("b", 8)]
    # growing a from 1 -> 3 pages fits (2 free) without evicting b
    return seen + [kv.acquire("a", 24), kv.pages_in_use(), kv.resident("b")]


def _lru_order(mod):
    kv = _cache(mod, name="t_kv_lru")
    for s in "abc":
        kv.acquire(s, 8)
    kv.touch("a")  # b is now least-recently-used
    evicted = kv.acquire("d", 17)  # needs 3 pages, 1 free -> evict 2
    return [evicted] + [kv.resident(s) for s in "abcd"] + [
        kv.pages_in_use()]


def _impossible(mod):
    kv = _cache(mod, name="t_kv_toolarge")
    # more pages than the whole cache: never admissible; growth past
    # capacity is equally refused, holder intact
    seen = [kv.acquire("a", 4 * 8 + 1), kv.acquire("a", 8),
            kv.acquire("a", 4 * 8 + 1)]
    return seen + [kv.resident("a"), kv.pages_in_use()]


def _evict_exclude(mod):
    kv = _cache(mod, name="t_kv_excl")
    kv.acquire("a", 8)
    kv.acquire("b", 8)
    return [kv.evict_lru(exclude="a"), kv.evict_lru(exclude="a"),
            kv.resident("a"), kv.pages_in_use()]


def _churn(mod):
    """A longer mixed sequence: admissions, growth by a token at a time,
    touches and releases, recording every eviction list."""
    kv = _cache(mod, pages=6, name="t_kv_churn")
    seen = []
    lens = {}
    for step in range(60):
        sid = "s%d" % (step % 5)
        if step % 7 == 6:
            kv.release(sid)
            lens.pop(sid, None)
            seen.append(("release", sid, kv.pages_in_use()))
            continue
        lens[sid] = lens.get(sid, 0) + 1 + step % 4
        got = kv.acquire(sid, lens[sid])
        for v in got or []:
            lens.pop(v, None)
        if got is None:
            lens.pop(sid, None)
        if step % 3 == 0:
            kv.touch("s%d" % ((step + 2) % 5))
        seen.append((sid, got, kv.pages_in_use()))
    return seen


@pytest.mark.parametrize("scenario, want", [
    (_pages_for, [1, 1, 2, 1, 3, 8]),
    (_accounting, [4, [], [], 4, True, True, False, 1, True, False]),
    (_grow_in_place, [[], [], [], 4, True]),
    (_lru_order, [["b", "c"], True, False, False, True, 4]),
    (_impossible, [None, [], None, True, 1]),
    (_evict_exclude, ["b", None, True, 1]),
    (_churn, None),
], ids=lambda v: getattr(v, "__name__", "want"))
def test_cache_matches_the_reference(scenario, want):
    got = scenario(kvcache)
    assert got == scenario(ref_kvcache)
    if want is not None:
        assert got == want


def test_cache_validation_matches_the_reference():
    for mod in (kvcache, ref_kvcache):
        with pytest.raises(ValueError):
            mod.PagedKVCache(0, 16)
        with pytest.raises(ValueError):
            mod.PagedKVCache(8, 0)


def test_evictions_are_counted_under_the_reference_names():
    kv = _cache(kvcache, name="t_kv_names")
    for s in "abcd":
        kv.acquire(s, 8)
    assert kv.acquire("e", 9) == ["a", "b"]
    kv.note_recompute("a")
    assert kv.evict_lru(reason="hbm_high_water") == "c"
    text = telemetry.prometheus_text()
    for line in ('synapseml_kv_evictions_total{cache="t_kv_names",'
                 'reason="capacity"} 2',
                 'synapseml_kv_evictions_total{cache="t_kv_names",'
                 'reason="hbm_high_water"} 1',
                 'synapseml_kv_recomputes_total{cache="t_kv_names"} 1',
                 'synapseml_kv_evicted_tokens_total{cache="t_kv_names"} 24',
                 'synapseml_kv_pages_in_use{cache="t_kv_names"} 3',
                 'synapseml_kv_capacity_bytes{cache="t_kv_names"} 512'):
        assert line in text, line
    kv.close()
    assert 'kv_pages_in_use{cache="t_kv_names"}' not in \
        telemetry.prometheus_text()


def test_capacity_bytes_env_matches_the_reference(monkeypatch):
    monkeypatch.setenv("SYNAPSEML_KV_CAPACITY_BYTES", "123456")
    assert kvcache.kv_capacity_bytes() == 123456 == \
        ref_kvcache.kv_capacity_bytes()
    # empty string is "unset": the device-memory path, which on the CPU
    # reports limit 0 and falls back to the fixed default in both
    monkeypatch.setenv("SYNAPSEML_KV_CAPACITY_BYTES", "")
    assert kvcache.kv_capacity_bytes() == ref_kvcache.kv_capacity_bytes() \
        == 256 << 20
    monkeypatch.setenv("SYNAPSEML_KV_CAPACITY_BYTES", "junk")
    monkeypatch.setenv("SYNAPSEML_KV_HBM_FRACTION", "junk")
    assert kvcache.kv_capacity_bytes() == 256 << 20


def test_cpu_record_has_no_limit_as_the_reference_cpu_backend():
    recs = perfwatch.device_memory()
    assert [r["bytes_limit"] for r in recs] == [0]
    assert all(r["bytes_limit"] == 0 for r in ref_perfwatch.device_memory())
    snap = perfwatch.memory_snapshot()
    assert set(snap) == {"ts", "pid", "high_water_fraction", "devices",
                         "totals"}
    assert set(snap["totals"]) == {"bytes_in_use", "live_buffers",
                                   "process_peak_bytes"}
    assert not kvcache.under_pressure()


def test_high_water_fires_once_per_crossing():
    """The reference's latch over one device's samples: one event at the
    crossing, none while above, re-armed below 85% of the line."""
    blackbox.reset()
    rec = {"device": "t_hw", "platform": "gpu", "bytes_limit": 100}
    fired = {}
    for mod in (perfwatch, ref_perfwatch):
        fired[mod] = [mod.check_high_water([dict(rec, bytes_in_use=used)],
                                           fraction=0.9)
                      for used in (50, 91, 95, 80, 77, 91, 76, 92)]
    assert fired[perfwatch] == fired[ref_perfwatch] == [
        [], ["t_hw"], [], [], [], [], [], ["t_hw"]]
    events = [e for e in blackbox.snapshot()["events"]
              if e.get("event") == "hbm_high_water"]
    assert len(events) == 2 and events[0]["device"] == "t_hw"
    prev = perfwatch.set_high_water_fraction(0.0)
    try:
        assert perfwatch.check_high_water(
            [dict(rec, bytes_in_use=99)]) == []
    finally:
        perfwatch.set_high_water_fraction(prev)

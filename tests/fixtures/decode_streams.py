"""The decode scheduler's fixture sequences and their recorder, for either
package: ``tests/fixtures/make_decode_fixture.py`` runs them through the
JAX package's ``DecodeScheduler`` into ``decode_streams.npz``, and the
port's tests and ``chip_smoke.py`` run the same sequences through the
port's and hold them to that file.

The geometry is ``tests/test_decode.py:112-135``'s (``max_batch=4,
prefill_chunk=8, page_size=8, max_seq=64``), 12 new tokens a sequence:

- ``continuous`` / ``static``: the prompts of ``_prompts((3, 11, 20, 5,
  17, 9))`` (``tests/test_decode.py:142-145``, seed 0) through a
  continuous and a ``static_batching=True`` scheduler;
- ``evict``: ``_prompts((6, 10, 14), seed=1)`` together through the
  4-page scheduler (capacity 4 pages of its own bytes a token), where
  they must evict each other; ``evict_solo``: each alone after them;
  ``evictions`` and ``recomputes``: the cache's counters after the
  concurrent run.

Each array of streams is ``[sequences, 12]`` int64 with the finish
reasons beside it. Every batch is submitted before the scheduler's loop
starts (:func:`run_batch`), so its first admission holds every slot it
can and the schedule does not hang on thread timing.

:func:`record` takes the package as arguments (``make(name, **geometry)``
returns a warmed scheduler that has not started, ``tm`` is the package's
telemetry module), so this module imports neither package and no JAX.
"""
import os
import re

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
OUT = os.path.join(HERE, "decode_streams.npz")
GEOMETRY = dict(max_batch=4, prefill_chunk=8, page_size=8, max_seq=64)
MAX_NEW = 12
CONTINUOUS_LENS, CONTINUOUS_SEED = (3, 11, 20, 5, 17, 9), 0
EVICT_LENS, EVICT_SEED = (6, 10, 14), 1
EVICT_PAGES = 4


def prompts(lens, seed=0):
    """``tests/test_decode.py``'s ``_prompts`` as plain ints."""
    rng = np.random.default_rng(seed)
    return [[int(t) for t in rng.integers(1, 50, size=n)] for n in lens]


def run_batch(sched, batch, max_new=MAX_NEW, timeout=240.0):
    """Submit every prompt of ``batch``, then start the loop if it has
    not started (so the first admission sees them all); returns
    ``[(tokens, reason)]`` in order."""
    started = sched._thread is not None
    if not started:
        sched.start = lambda: None     # submit's start() waits for us
    try:
        handles = [sched.submit(p, max_new_tokens=max_new) for p in batch]
    finally:
        if not started:
            del sched.start
    sched.start()
    return [h.result(timeout=timeout) for h in handles]


def counter_total(tm, name: str, cache: str) -> int:
    text = tm.prometheus_text()
    return sum(int(float(v)) for v in re.findall(
        name + r'\{cache="' + re.escape(cache) + r'"[^}]*\} (\S+)', text))


def record(make, tm, tag: str = "") -> dict:
    """The streams of this module's docstring through the package whose
    scheduler ``make`` builds and whose telemetry module is ``tm``."""
    out = {}
    for kind, static in (("continuous", False), ("static", True)):
        sched = make(f"fx_{kind}{tag}", static_batching=static,
                     capacity_bytes=10 ** 9)
        try:
            res = run_batch(sched, prompts(CONTINUOUS_LENS,
                                           CONTINUOUS_SEED))
        finally:
            sched.close()
        out[kind] = np.array([t for t, _ in res], np.int64)
        out[kind + "_reasons"] = np.array([r for _, r in res])
    cache = f"fx_evict{tag}_kv"
    sched = make(f"fx_evict{tag}", pages=EVICT_PAGES, cache_name=cache)
    try:
        batch = prompts(EVICT_LENS, EVICT_SEED)
        res = run_batch(sched, batch)
        out["evictions"] = np.int64(counter_total(
            tm, "kv_evictions_total", cache))
        out["recomputes"] = np.int64(counter_total(
            tm, "kv_recomputes_total", cache))
        solo = [run_batch(sched, [p])[0] for p in batch]
    finally:
        sched.close()
    out["evict"] = np.array([t for t, _ in res], np.int64)
    out["evict_reasons"] = np.array([r for _, r in res])
    out["evict_solo"] = np.array([t for t, _ in solo], np.int64)
    return out


def maker(DecodeScheduler, PagedKVCache, graph, **kw):
    """``make`` for :func:`record` over one package's classes and an
    imported ``zoo.tiny_decoder()``; ``kw`` goes to every scheduler
    (the port's ``device``)."""
    def make(name, static_batching=False, capacity_bytes=1, pages=None,
             cache_name=None):
        s = DecodeScheduler(graph, name=name, static_batching=static_batching,
                            capacity_bytes=capacity_bytes, **GEOMETRY, **kw)
        if pages is not None:
            # the cache at exactly `pages` pages of the scheduler's own
            # bytes a token, as tests/test_decode.py's tiny_sched builds it
            bpt = s.kv.bytes_per_token
            s.kv.close()
            s.kv = PagedKVCache(GEOMETRY["page_size"], bpt,
                                capacity_bytes=pages
                                * GEOMETRY["page_size"] * bpt,
                                name=cache_name)
        s.warmup()
        return s
    return make

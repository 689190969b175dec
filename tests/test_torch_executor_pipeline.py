"""The port's batched executor against the JAX package's, on the CPU.

Every case of ``tests/test_executor_pipeline.py`` runs here on both
executors — the JAX ``BatchedExecutor`` and the port's
``BatchedExecutor(device="cpu")`` — with the same seeded numpy inputs:
elementwise functions agree bitwise, and the bucket sequence agrees
(``executor_bucket_total{bucket=}`` is equal in both packages' telemetry).
The structural guarantees (thread-safe submission, in-order streaming,
errors through futures, clean shutdown, the drain thread not stalling
dispatch) are checked on the port as the reference checks them on itself.
Added: ``transfer_batches`` (3 and "auto"), ``device_outputs``, a caller's
tensor padded on its device, bf16 staging, and the dtype coercions.

Every wait on a future has a timeout, and every executor is closed.
"""
import contextlib
import gc
import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from synapseml_tpu.runtime import executor as jax_executor
from synapseml_tpu.runtime import telemetry as jax_tm
from synapseml_tpu_torch.runtime import executor as port_executor
from synapseml_tpu_torch.runtime import telemetry as port_tm
from synapseml_tpu_torch.runtime.executor import (BatchedExecutor,
                                                  ExecutorFuture)

HARD = 30.0  # hard wall for any blocking wait: a hang fails fast


def _bucket_counts(tm) -> dict:
    return {labels["bucket"]: m.value
            for labels, m in tm.series("executor_bucket_total") if m.value}


@contextlib.contextmanager
def both(fn, **kw):
    """The JAX executor and the port's on the CPU, same arguments; both
    registries zeroed first, both executors closed after."""
    jax_tm.reset()
    port_tm.reset()
    ref = jax_executor.BatchedExecutor(fn, **kw)
    port = BatchedExecutor(fn, device="cpu", **kw)
    try:
        yield ref, port
    finally:
        ref.close(wait=False)
        port.close(wait=False)


def _run(ex, *arrays):
    return ex.submit(*arrays).result(timeout=HARD)


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        x = x.detach()
        return x.float().numpy() if x.dtype == torch.bfloat16 else x.numpy()
    a = np.asarray(x)
    return a.astype(np.float32) if a.dtype.name == "bfloat16" else a


def _same(port_out, ref_out):
    """Bitwise equal, leaf by leaf, with equal dtypes."""
    assert len(port_out) == len(ref_out)
    for p, r in zip(port_out, ref_out):
        pn, rn = _np(p), _np(r)
        assert pn.dtype == rn.dtype, (pn.dtype, rn.dtype)
        assert pn.shape == rn.shape, (pn.shape, rn.shape)
        assert pn.tobytes() == rn.tobytes()


def _same_buckets():
    assert _bucket_counts(port_tm) == _bucket_counts(jax_tm)


def test_submit_returns_future_with_call_identical_result():
    x = np.random.default_rng(0).standard_normal(11).astype(np.float32)
    with both(lambda x: (x * 2.0,), min_bucket=4) as (ref, ex):
        fut, ref_fut = ex.submit(x), ref.submit(x)
        assert isinstance(fut, ExecutorFuture)
        y = fut.result(timeout=HARD)
        y_call = _run(ex, x)
        np.testing.assert_array_equal(y[0], y_call[0])
        assert fut.done() and fut.exception(timeout=HARD) is None
        _same(y, ref_fut.result(timeout=HARD))
        _same(y_call, _run(ref, x))
        _same_buckets()
        assert _bucket_counts(port_tm) == {"16": 2.0}


def test_submit_multi_chunk_concatenates_in_order():
    # 40 rows at max_bucket 8 -> 5 chunks, assembled in submission order
    x = np.random.default_rng(1).standard_normal(40).astype(np.float32)
    with both(lambda x: (x + 1.0,), min_bucket=8, max_bucket=8) as (ref, ex):
        y = _run(ex, x)
        _same(y, ref(x))
        _same_buckets()
        assert _bucket_counts(port_tm) == {"8": 5.0}


def test_concurrent_submit_from_many_threads():
    """N threads submitting distinct data concurrently each get exactly
    their own answer back, bitwise the reference's."""
    import sys

    n_threads, per_thread = 8, 6
    results, errors = {}, []
    lock = threading.Lock()
    interval = sys.getswitchinterval()
    with both(lambda x: (x * 3.0,), min_bucket=4,
              max_bucket=8) as (ref, ex):
        def worker(t):
            try:
                mine = []
                for k in range(per_thread):
                    x = (np.arange(3 + (t + k) % 9, dtype=np.float32)
                         + 100.0 * t + 10.0 * k)
                    mine.append((x, _run(ex, x)))
                with lock:
                    results[t] = mine
            except BaseException as e:  # noqa: BLE001 - reported below
                errors.append(e)

        sys.setswitchinterval(1e-5)
        try:
            threads = [threading.Thread(target=worker, args=(t,))
                       for t in range(n_threads)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=60)
        finally:
            sys.setswitchinterval(interval)
        assert not any(t.is_alive() for t in threads)
        assert errors == [] and len(results) == n_threads
        for mine in results.values():
            for x, y in mine:
                _same(y, ref(x))
        _same_buckets()


def test_stream_in_order_mixed_bucket_sizes():
    """stream() yields per-item results in submission order even when
    items land in different shape buckets."""
    sizes = [3, 17, 1, 32, 9, 4, 27, 2]
    items = [np.full(s, float(i), np.float32) for i, s in enumerate(sizes)]
    with both(lambda x: (x - 1.0,), min_bucket=4,
              max_bucket=32) as (ref, ex):
        outs = list(ex.stream((a,) for a in items))
        refs = list(ref.stream((a,) for a in items))
        assert len(outs) == len(items)
        for i, got in enumerate(outs):
            assert got[0].shape == (sizes[i],)
            _same(got, refs[i])
        _same_buckets()
        assert _bucket_counts(port_tm) == {"4": 4.0, "16": 1.0,
                                           "32": 3.0}


def test_stream_accepts_bare_arrays_and_overlaps_producer():
    """A generator item's host work runs while earlier items compute:
    the stream holds pipeline_depth items in flight."""
    with both(lambda x: (x * 2.0,), min_bucket=4,
              pipeline_depth=2) as (ref, ex):
        produced = []

        def gen():
            for i in range(5):
                produced.append(i)
                yield np.full(4, float(i), np.float32)

        seen = 0
        for i, y in enumerate(ex.stream(gen())):
            _same(y, ref(np.full(4, float(i), np.float32)))
            seen += 1
            # depth-2 window: by the time item k is yielded, the producer
            # has been advanced past it (unless exhausted)
            assert len(produced) >= min(5, i + 2)
        assert seen == 5 and produced == list(range(5))
        _same_buckets()


def test_exception_from_fn_propagates_through_future():
    def bad_fn(x):
        raise RuntimeError("scorer exploded")

    with both(bad_fn, min_bucket=4) as (ref, ex):
        fut = ex.submit(np.ones(3, np.float32))
        with pytest.raises(RuntimeError, match="scorer exploded"):
            fut.result(timeout=HARD)
        assert isinstance(fut.exception(timeout=HARD), RuntimeError)
        with pytest.raises(RuntimeError, match="scorer exploded"):
            _run(ex, np.ones(3, np.float32))
        with pytest.raises(RuntimeError, match="scorer exploded"):
            ref(np.ones(3, np.float32))


def test_exception_does_not_wedge_pipeline():
    """A failing batch must not deadlock or poison the pipeline: the
    depth slot it held is released and later submits still complete."""
    state = {"fail": True}

    def fn(x):
        if state["fail"]:
            raise ValueError("transient")
        return (x + 5.0,)

    with both(fn, min_bucket=4, pipeline_depth=2) as (ref, ex):
        futs = [ex.submit(np.ones(4, np.float32)) for _ in range(4)]
        for f in futs:
            with pytest.raises(ValueError, match="transient"):
                f.result(timeout=HARD)
        state["fail"] = False
        ref._jits.clear()  # the reference caches the failed trace
        for _ in range(4):  # more than pipeline_depth: slots were released
            _same(_run(ex, np.ones(4, np.float32)),
                  ref(np.ones(4, np.float32)))


def test_fetch_error_propagates_and_pipeline_survives():
    x = np.random.default_rng(2).standard_normal(4).astype(np.float32)
    with both(lambda x: (x * 2.0,), min_bucket=4) as (ref, ex):
        orig_fetch = ex._fetch
        boom = [True]

        def fetch(out, n, bucket):
            if boom[0]:
                boom[0] = False
                raise OSError("D2H transport dropped")
            return orig_fetch(out, n, bucket)

        ex._fetch = fetch
        with pytest.raises(OSError, match="transport dropped"):
            ex.submit(x).result(timeout=HARD)
        _same(_run(ex, x), ref(x))


def test_close_drains_inflight_batches():
    """close() lets already-submitted batches complete (their futures
    resolve with real results), then refuses new work."""
    with both(lambda x: (x + 2.0,), min_bucket=4, max_bucket=4,
              pipeline_depth=2) as (ref, ex):
        gate = threading.Event()
        orig_fetch = ex._fetch

        def slow_fetch(out, n, bucket):
            gate.wait(10)  # hold batches in flight until close() is underway
            return orig_fetch(out, n, bucket)

        ex._fetch = slow_fetch
        xs = [np.full(4, float(i), np.float32) for i in range(3)]
        futs = [ex.submit(x) for x in xs]
        closer = threading.Thread(target=lambda: ex.close(wait=True))
        closer.start()
        time.sleep(0.05)
        gate.set()
        closer.join(timeout=30)
        assert not closer.is_alive(), "close(wait=True) did not finish"
        for x, f in zip(xs, futs):
            _same(f.result(timeout=10), ref(x))
        with pytest.raises(RuntimeError, match="closed"):
            ex.submit(np.ones(4, np.float32))
        ex.close()  # idempotent


def test_close_before_first_submit():
    with both(lambda x: (x,), min_bucket=4) as (ref, ex):
        ex.close()
        ref.close()
        for e in (ex, ref):
            with pytest.raises(RuntimeError, match="closed"):
                e.submit(np.ones(4, np.float32))


def test_dropped_executor_reaps_pipeline_threads():
    """An executor dropped without close() must not leak its parked
    pipeline threads: the weakref finalizer shuts them down."""
    ex = BatchedExecutor(lambda x: (x * 2.0,), device="cpu", min_bucket=4)
    _run(ex, np.ones(4, np.float32))  # start the pipeline
    threads = list(ex._pipeline.threads)
    assert all(t.is_alive() for t in threads)
    del ex
    gc.collect()
    deadline = time.monotonic() + 10
    while time.monotonic() < deadline and any(t.is_alive() for t in threads):
        time.sleep(0.02)
    assert not any(t.is_alive() for t in threads), \
        "pipeline threads leaked after executor GC"


def test_future_add_done_callback_fires_once_after_last_chunk():
    x = np.arange(12, dtype=np.float32)  # 3 chunks
    with both(lambda x: (x,), min_bucket=4, max_bucket=4) as (ref, ex):
        fired = []
        fut = ex.submit(x)
        fut.add_done_callback(lambda f: fired.append(f.done()))
        _same(fut.result(timeout=HARD), ref(x))
        deadline = time.monotonic() + 5
        while time.monotonic() < deadline and not fired:
            time.sleep(0.01)
        assert fired == [True]


def test_submit_empty_batch_learns_structure():
    x = np.zeros((0, 3), np.float32)
    with both(lambda x: (x * 2.0,), min_bucket=4) as (ref, ex):
        y = ex.submit(x).result(timeout=HARD)
        assert y[0].shape == (0, 3)
        _same(y, ref(x))
        _same_buckets()


def test_cross_caller_overlap_one_fetch_does_not_stall_dispatch():
    """The dedicated drain thread: while caller A's fetch blocks, caller
    B's batch must still be dispatched."""
    with both(lambda x: (x * 2.0,), min_bucket=4, max_bucket=4,
              pipeline_depth=2) as (ref, ex):
        first_fetch_started = threading.Event()
        release_first_fetch = threading.Event()
        dispatched = []
        orig_fetch, orig_dispatch = ex._fetch, ex._dispatch

        def fetch(out, n, bucket):
            if not first_fetch_started.is_set():
                first_fetch_started.set()
                assert release_first_fetch.wait(30)
            return orig_fetch(out, n, bucket)

        def dispatch(arrays, n, bucket, **kw):
            dispatched.append(n)
            return orig_dispatch(arrays, n, bucket, **kw)

        ex._fetch = fetch
        ex._dispatch = dispatch
        a, b = np.ones(4, np.float32), np.full(4, 7.0, np.float32)
        fut_a = ex.submit(a)
        assert first_fetch_started.wait(10)
        fut_b = ex.submit(b)
        deadline = time.monotonic() + 10
        while time.monotonic() < deadline and len(dispatched) < 2:
            time.sleep(0.01)
        # B dispatched while A's fetch is still blocked in the drain
        assert len(dispatched) == 2, dispatched
        release_first_fetch.set()
        _same(fut_a.result(timeout=HARD), ref(a))
        _same(fut_b.result(timeout=HARD), ref(b))


# -- beyond the reference's file ------------------------------------------

@pytest.mark.parametrize("transfer_batches", [3, "auto"])
def test_transfer_batches_groups_copies_bitwise(transfer_batches):
    """Grouped host-to-device staging: one staged buffer for several
    buckets, compute on device-side slices; the ragged tail padded.
    Same rows and bucket sequence as the reference."""
    x = np.random.default_rng(3).standard_normal((75, 5))
    ids = np.random.default_rng(4).integers(-9, 9, (75, 2))
    with both(lambda x, i: (x * 2.0 + 1.0, i * 3), min_bucket=8,
              max_bucket=16, transfer_batches=transfer_batches) as (ref, ex):
        if transfer_batches == "auto":
            # ~32 MB groups: every bucket of this call rides one copy
            assert ex._resolve_transfer_batches((x, ids), 16) == \
                (32 << 20) // (16 * (5 * 4 + 2 * 4))
        y = _run(ex, x, ids)
        _same(y, ref(x, ids))
        assert y[0].dtype == np.float32 and y[1].dtype == np.int32
        _same_buckets()
        assert _bucket_counts(port_tm) == {"16": 5.0}


def test_device_outputs_stay_tensors_row_sliced():
    """``device_outputs`` leaves resolve as device tensors (jax.Arrays in
    the reference), sliced to the real rows, fed back into a submit."""
    x = np.random.default_rng(5).standard_normal((13, 4)).astype(np.float32)
    with both(lambda x: (x + 1.0, x * 2.0), min_bucket=8,
              device_outputs=[1]) as (ref, ex):
        y = _run(ex, x)
        r = ref(x)
        assert isinstance(y[0], np.ndarray)
        assert isinstance(y[1], torch.Tensor) and isinstance(r[1], jax.Array)
        _same(y, r)
        again = _run(ex, y[1])  # a device output fed straight back
        _same(again, ref(r[1]))


def test_caller_tensor_is_padded_on_its_device():
    """A caller's device-resident input (a CPU tensor for the CPU
    executor, a jax.Array in the reference) is padded and cast where it
    lies, beside host columns that are staged."""
    rng = np.random.default_rng(6)
    x = rng.standard_normal((21, 3)).astype(np.float32)
    h = rng.standard_normal((21, 3))
    with both(lambda x, h: (x * h, x + 1.0), min_bucket=8,
              max_bucket=16) as (ref, ex):
        y = _run(ex, torch.from_numpy(x), h)
        _same(y, ref(jnp.asarray(x), h))
        _same_buckets()


def test_bf16_staging_is_the_references_cast():
    """compute_dtype bf16: floating columns are cast to bf16 on the host
    (round to nearest even, as the reference's astype) — bitwise the
    reference's outputs; integer columns are not cast."""
    rng = np.random.default_rng(7)
    x = rng.standard_normal((19, 6))  # float64: -> f32 -> bf16
    ids = rng.integers(0, 100, (19, 2), dtype=np.int64)
    jax_tm.reset()
    port_tm.reset()
    ex = BatchedExecutor(lambda x, i: (x + 1.0, i + 1), device="cpu",
                         min_bucket=8, compute_dtype="bfloat16")
    ref = jax_executor.BatchedExecutor(lambda x, i: (x + 1.0, i + 1),
                                       min_bucket=8,
                                       compute_dtype=jnp.bfloat16)
    try:
        y = _run(ex, x, ids)
        r = ref(x, ids)
        assert y[0].dtype == torch.bfloat16
        np.testing.assert_array_equal(
            y[0].view(torch.int16).numpy(),
            np.asarray(r[0]).view(np.int16))
        _same(y[1:], r[1:])
        _same_buckets()
    finally:
        ex.close(wait=False)
        ref.close(wait=False)


@pytest.mark.parametrize("dtype", [np.float64, np.int64, np.uint64,
                                   np.float32, np.uint8, np.bool_])
def test_coerce_host_array_matches_the_reference(dtype):
    a = (np.random.default_rng(8).standard_normal((5, 3)) * 1e3).astype(dtype)
    got = port_executor.coerce_host_array(a)
    want = jax_executor.coerce_host_array(a)
    assert got.numpy().dtype == want.dtype
    assert got.numpy().tobytes() == want.tobytes()
    for n, b in [(1, 8), (8, 8), (9, 16), (100, 128), (129, 256)]:
        assert port_executor.round_up_pow2(n) == \
            jax_executor.round_up_pow2(n) == b


def test_default_device_is_cuda_and_raises_without_it():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        BatchedExecutor(lambda x: (x,))


def test_ambient_spans_get_each_stage_noted():
    """Spans set around a submit ride its units: the stage, compute and
    drain seconds of each chunk are noted on them, as in the reference."""
    with both(lambda x: (x * 2.0,), min_bucket=4, max_bucket=4) as (ref, ex):
        notes = {}
        for name, tm, e in (("port", port_tm, ex), ("ref", jax_tm, ref)):
            span = (tm.Span("rid-1") if name == "port"
                    else tm.start_span("rid-1"))
            token = tm.set_current_spans([span])
            try:
                fut = e.submit(np.ones(12, np.float32))  # 3 chunks
            finally:
                tm.reset_current_spans(token)
            fut.result(timeout=HARD)
            assert tm.current_spans() is None
            notes[name] = sorted(stage for stage, _ in span.events)
        assert notes["port"] == notes["ref"] == sorted(
            ["stage"] * 3 + ["compute"] * 3 + ["drain"] * 3)


def test_telemetry_registry_reads_as_the_references():
    """The same writes into both registries read back the same: counters,
    gauges (set, add, sampled), histograms' counts, sums and percentiles,
    ``series`` and ``unregister``."""
    snaps = []
    for tm in (jax_tm, port_tm):
        tm.reset()
        c = tm.counter("parity_probe_total", kind="a")
        c.inc()
        c.inc(2.5)
        g = tm.gauge("parity_probe_gauge")
        g.set(4.0)
        g.add(-1.0)
        tm.gauge_fn("parity_probe_sampled", lambda: 7.0)
        h = tm.histogram("parity_probe_seconds")
        for v in (0.0002, 0.003, 0.003, 0.04, 2.0):
            h.observe(v)
        assert [lbl for lbl, _ in tm.series("parity_probe_total")] == [
            {"kind": "a"}]
        snap = tm.snapshot()
        assert tm.unregister("parity_probe_sampled")
        assert not tm.unregister("parity_probe_sampled")
        snaps.append({k: {n: v for n, v in snap[k].items()
                          if "parity_probe" in n}
                      for k in ("counters", "gauges", "histograms")})
    assert snaps[0] == snaps[1]
    assert snaps[1]["counters"] == {
        'synapseml_parity_probe_total{kind="a"}': 3.5}

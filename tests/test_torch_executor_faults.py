"""Fault injection through the port's executor pipeline, on the CPU.

The executor cases of ``tests/test_faults.py``, run on the port's
``runtime/faults.py`` and ``BatchedExecutor(device="cpu")``: the staging,
h2d, compute and drain faults fail the batch, not the pipeline;
``thread_kill.{stage,dispatch,drain}`` fails every in-flight future with
``PipelineBrokenError`` and the next submit rides a restarted pipeline;
the dead pipeline's state is reaped; the latency point sleeps; a future's
timeout is one deadline over all its chunks. Outputs after a fault are
held bitwise to the JAX package's executor on the same rows. Every wait
has a timeout, and every executor is closed.
"""
import gc
import time
import weakref
from concurrent.futures import Future
from concurrent.futures import TimeoutError as FutureTimeout

import numpy as np
import pytest

from synapseml_tpu.runtime import executor as jax_executor
from synapseml_tpu_torch.runtime import blackbox as _bb
from synapseml_tpu_torch.runtime import executor as exmod
from synapseml_tpu_torch.runtime import faults as flt
from synapseml_tpu_torch.runtime import telemetry as tm
from synapseml_tpu_torch.runtime.executor import (BatchedExecutor,
                                                  ExecutorFuture)
from synapseml_tpu_torch.runtime.faults import (FaultInjected,
                                                PipelineBrokenError)

HARD = 30.0  # hard wall for any blocking wait: hang -> fast red X


@pytest.fixture(autouse=True)
def _clean_faults():
    flt.deactivate()
    yield
    flt.deactivate()


def _ctr(name, **labels):
    """Sum one counter family, optionally filtered by exact labels."""
    total = 0.0
    for k, v in tm.snapshot()["counters"].items():
        if not k.startswith("synapseml_" + name):
            continue
        if all(f'{lk}="{lv}"' in k for lk, lv in labels.items()):
            total += v
    return total


def _run(ex, x):
    return ex.submit(x).result(timeout=HARD)


def _reference(fn, x):
    ref = jax_executor.BatchedExecutor(fn, min_bucket=8)
    try:
        return np.asarray(ref.submit(x).result(timeout=HARD)[0])
    finally:
        ref.close(wait=False)


# ---------------------------------------------------------------------------
# framework API + env grammar
# ---------------------------------------------------------------------------

def test_inactive_point_is_a_noop_and_api_validates():
    p = flt.point("compute")
    p.fire()  # nothing armed: returns
    with pytest.raises(ValueError):
        flt.activate("no_such_point")
    with pytest.raises(ValueError):
        flt.configure("compute:1:NotAnException")
    # a typo'd scope is a loud error, not a silently-inert spec
    with pytest.raises(ValueError):
        flt.activate("thread_kill.drian")
    with pytest.raises(ValueError):
        flt.activate("compute.foo")  # family takes no such scope


def test_env_grammar_arms_points_with_details():
    armed = flt.configure(
        "compute:0.5:ValueError,latency.score:1:25,thread_kill.drain:1")
    assert set(armed) == {"compute", "latency.score", "thread_kill.drain"}
    active = flt.active()
    assert active["compute"]["prob"] == 0.5
    assert active["compute"]["exc"] == "ValueError"
    assert active["latency.score"]["latency_ms"] == 25.0
    assert active["thread_kill.drain"]["exc"] == "ThreadKilled"
    flt.deactivate("compute")
    assert "compute" not in flt.active()
    flt.deactivate()
    assert flt.active() == {}
    flt.point("compute").fire()  # disarmed again


def test_times_bound_caps_firings_and_counts_them():
    before = _ctr("faults_injected_total", point="compute")
    flt.activate("compute", times=2)
    p = flt.point("compute")
    for _ in range(2):
        with pytest.raises(FaultInjected):
            p.fire()
    p.fire()  # exhausted: armed but inert
    assert _ctr("faults_injected_total", point="compute") == before + 2


# ---------------------------------------------------------------------------
# executor: per-batch faults fail the BATCH, kills fail the THREAD
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("point", ["staging", "h2d", "compute", "drain"])
def test_injected_batch_fault_fails_future_not_pipeline(point):
    fn = lambda x: (x * 2.0,)  # noqa: E731
    ex = BatchedExecutor(fn, device="cpu", min_bucket=8)
    try:
        x = np.arange(8, dtype=np.float32).reshape(8, 1)
        base = _run(ex, x)[0]
        assert base.tobytes() == _reference(fn, x).tobytes()
        restarts0 = _ctr("executor_pipeline_restarts_total")
        flt.activate(point)
        exc = ex.submit(x).exception(timeout=HARD)
        assert isinstance(exc, FaultInjected), exc
        flt.deactivate()
        # the pipeline survived: no restart, next batch is bit-identical
        assert _ctr("executor_pipeline_restarts_total") == restarts0
        assert np.array_equal(_run(ex, x)[0], base)
    finally:
        ex.close(wait=False)


@pytest.mark.parametrize("scope", ["stage", "dispatch", "drain"])
def test_thread_kill_fails_inflight_and_restarts(scope):
    """A dead pipeline thread fails every in-flight future with
    PipelineBrokenError (never a hang) and the NEXT submit rides a
    freshly restarted pipeline, bit-identically."""
    fn = lambda x: (x * 3.0 + 1.0,)  # noqa: E731
    ex = BatchedExecutor(fn, device="cpu", min_bucket=8)
    try:
        x = np.arange(8, dtype=np.float32).reshape(8, 1)
        base = _run(ex, x)[0]
        restarts0 = _ctr("executor_pipeline_restarts_total")
        flt.activate(f"thread_kill.{scope}", times=1)
        fut = ex.submit(x)
        with pytest.raises(PipelineBrokenError):
            fut.result(timeout=HARD)
        assert _ctr("executor_pipeline_restarts_total") == restarts0 + 1
        again = _run(ex, x)[0]
        assert np.array_equal(again, base)
        assert again.tobytes() == _reference(fn, x).tobytes()
    finally:
        ex.close(wait=False)


def test_thread_kill_fails_every_inflight_future():
    ex = BatchedExecutor(lambda x: (x + 1.0,), device="cpu", min_bucket=8,
                         pipeline_depth=4)
    try:
        x = np.ones((8, 1), np.float32)
        _run(ex, x)
        flt.activate("thread_kill.drain", times=1)
        futs = [ex.submit(x) for _ in range(6)]
        outcomes = [f.exception(timeout=HARD) for f in futs]
        # nothing hung: every future resolved, at least one to the break
        assert any(isinstance(e, PipelineBrokenError) for e in outcomes)
        assert all(e is None or isinstance(e, PipelineBrokenError)
                   for e in outcomes)
        assert np.array_equal(_run(ex, x)[0], x + 1.0)
    finally:
        ex.close(wait=False)


def test_break_reaps_dead_pipeline_state():
    """After a break, the dying thread drains the dead pipeline's queues
    and the superseded finalizer is detached — the dead state becomes
    collectible once callers drop their futures."""
    ex = BatchedExecutor(lambda x: (x + 1.0,), device="cpu", min_bucket=8,
                         pipeline_depth=4)
    try:
        x = np.ones((8, 1), np.float32)
        _run(ex, x)
        state0 = ex._pipeline
        flt.activate("thread_kill.drain", times=1)
        futs = [ex.submit(x) for _ in range(4)]
        for f in futs:
            f.exception(timeout=HARD)
        assert np.array_equal(_run(ex, x)[0], x + 1.0)  # fresh pipeline
        deadline = time.monotonic() + HARD
        while any(t.is_alive() for t in state0.threads):
            assert time.monotonic() < deadline, "dead threads never exited"
            time.sleep(0.02)
        for q in (state0.stage_q, state0.dispatch_q, state0.inflight_q):
            assert all(item is exmod._SHUTDOWN for item in list(q.queue))
        wr = weakref.ref(state0)
        del state0, futs, f  # futures' done-callbacks hold the state
        deadline = time.monotonic() + HARD
        while wr() is not None:
            assert time.monotonic() < deadline, \
                "dead pipeline state never became collectible"
            gc.collect()
            time.sleep(0.02)
    finally:
        ex.close(wait=False)


@pytest.mark.parametrize("slots", [2, 3])
def test_break_reaps_dead_pipeline_state_over_two_slots(slots):
    """The same reaping over several slots (2: every bucket sharded, 3:
    round robin): the dead state holds every slot, whose streams the
    supervisor joins; the fresh pipeline runs over the same slots, and
    the dead state becomes collectible."""
    ex = BatchedExecutor(lambda x: (x + 1.0,), devices=["cpu"] * slots,
                         min_bucket=8, pipeline_depth=4)
    try:
        x = np.arange(8, dtype=np.float32).reshape(8, 1)
        _run(ex, x)
        state0 = ex._pipeline
        assert state0.slots == ex._slots and len(state0.slots) == slots
        flt.activate("thread_kill.drain", times=1)
        futs = [ex.submit(x) for _ in range(4)]
        for f in futs:
            f.exception(timeout=HARD)
        assert np.array_equal(_run(ex, x)[0], x + 1.0)  # fresh pipeline
        assert ex._pipeline is not state0
        assert ex._pipeline.slots == ex._slots
        deadline = time.monotonic() + HARD
        while any(t.is_alive() for t in state0.threads):
            assert time.monotonic() < deadline, "dead threads never exited"
            time.sleep(0.02)
        for q in (state0.stage_q, state0.dispatch_q, state0.inflight_q):
            assert all(item is exmod._SHUTDOWN for item in list(q.queue))
        wr = weakref.ref(state0)
        del state0, futs, f
        deadline = time.monotonic() + HARD
        while wr() is not None:
            assert time.monotonic() < deadline, \
                "dead pipeline state never became collectible"
            gc.collect()
            time.sleep(0.02)
    finally:
        ex.close(wait=False)


def test_break_survives_a_slot_join_that_raises(monkeypatch):
    """A break from a sticky CUDA error: joining the slots' streams
    raises again in the reap. The error is recorded, never raised out of
    supervision, and the sentinels are back in the dead queues first, so
    every dead thread still exits and the next submit runs."""
    def sticky(slot):
        raise RuntimeError("CUDA error: an illegal memory access")

    monkeypatch.setattr(exmod._Slot, "join", sticky)
    ex = BatchedExecutor(lambda x: (x + 1.0,), devices=["cpu"] * 2,
                         min_bucket=8, pipeline_depth=4)
    try:
        x = np.arange(8, dtype=np.float32).reshape(8, 1)
        _run(ex, x)
        state0 = ex._pipeline
        flt.activate("thread_kill.drain", times=1)
        futs = [ex.submit(x) for _ in range(4)]
        for f in futs:
            assert isinstance(f.exception(timeout=HARD), PipelineBrokenError)
        deadline = time.monotonic() + HARD
        while any(t.is_alive() for t in state0.threads):
            assert time.monotonic() < deadline, "dead threads never exited"
            time.sleep(0.02)
        for q in (state0.stage_q, state0.dispatch_q, state0.inflight_q):
            assert all(item is exmod._SHUTDOWN for item in list(q.queue))
        failed = [e for e in _bb.snapshot(stacks=False)["events"]
                  if e.get("event") == "pipeline_reap_join_failed"]
        assert [e["slot"] for e in failed[-2:]] == [0, 1]
        assert "illegal memory access" in failed[-1]["error"]
        assert np.array_equal(_run(ex, x)[0], x + 1.0)  # fresh pipeline
    finally:
        ex.close(wait=False)


def test_latency_point_injects_sleep_without_failing():
    ex = BatchedExecutor(lambda x: (x * 2.0,), device="cpu", min_bucket=8)
    try:
        x = np.ones((8, 1), np.float32)
        _run(ex, x)
        flt.activate("latency.dispatch", latency_ms=80)
        t0 = time.monotonic()
        out = _run(ex, x)[0]
        assert time.monotonic() - t0 >= 0.08
        assert np.array_equal(out, x * 2.0)
    finally:
        ex.close(wait=False)


def test_executor_future_timeout_is_one_overall_deadline():
    """timeout applies across ALL chunks, not per chunk — a 3-chunk
    future with timeout=0.4 fails in ~0.4s, not 1.2s."""
    fut = ExecutorFuture([Future(), Future(), Future()])
    t0 = time.monotonic()
    with pytest.raises(FutureTimeout):
        fut.result(timeout=0.4)
    assert time.monotonic() - t0 < 1.0
    t0 = time.monotonic()
    with pytest.raises(FutureTimeout):
        fut.exception(timeout=0.4)
    assert time.monotonic() - t0 < 1.0

"""Serving robustness of the port, on the CPU: poison isolation, the
deadline and queue sheds, transient retry, supervised serving threads,
the bind retry, and the single-server lifecycle (live/ready, the drain
gate, drain then stop, 503 on stop, ``Retry-After`` on every shed).

Then the channel layer, ``DistributedServer``: depth-aware placement,
quarantine and redisperse, the circuit breakers with their failover and
half-open probes, the stall accounting, the default canary, stop's 503s
and the supervised distributor.

Ported one for one from the serving half of the reference's
``tests/test_faults.py`` and from ``tests/test_channel_failover.py``.
Every server binds port 0 (the bind-retry tests excepted, which probe
the retry itself); every blocking wait has a hard wall (``HARD``).
"""
import errno
import json
import random
import socket
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest

from synapseml_tpu_torch.data.table import Table
from synapseml_tpu_torch.io.http import HTTPRequestData
from synapseml_tpu_torch.io.serving import (BREAKER_CLOSED, CachedRequest,
                                            ContinuousServer,
                                            DistributedServer,
                                            MultiChannelMap, WorkerServer,
                                            _retry_rng, make_reply)
from synapseml_tpu_torch.runtime import faults as flt
from synapseml_tpu_torch.runtime import telemetry as tm
from synapseml_tpu_torch.runtime.faults import PipelineBrokenError

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


def _post(url, obj, timeout=HARD, headers=None):
    hdrs = {"Content-Type": "application/json"}
    hdrs.update(headers or {})
    req = urllib.request.Request(url, data=json.dumps(obj).encode(),
                                 method="POST", headers=hdrs)
    with urllib.request.urlopen(req, timeout=timeout) as r:
        return r.status, json.loads(r.read().decode())


def _get(url, timeout=HARD):
    try:
        with urllib.request.urlopen(url, timeout=timeout) as r:
            return r.status, dict(r.headers)
    except urllib.error.HTTPError as e:
        e.read()
        return e.code, dict(e.headers)


def _echo_pipeline(table: Table) -> Table:
    replies = np.empty(table.num_rows, dtype=object)
    for i, v in enumerate(table["value"]):
        replies[i] = make_reply(v)
    return table.with_column("reply", replies)


def _linear_pipeline(table: Table) -> Table:
    replies = np.empty(table.num_rows, dtype=object)
    for i, v in enumerate(table["value"]):
        replies[i] = make_reply({"y": [x * 3.0 + 1.0 for x in v["x"]]})
    return table.with_column("reply", replies)


def _poison_pipeline(table: Table) -> Table:
    vals = list(table["value"])
    if any(isinstance(v, dict) and v.get("poison") for v in vals):
        raise ValueError("poison payload")
    replies = np.empty(table.num_rows, dtype=object)
    for i, v in enumerate(vals):
        replies[i] = make_reply({"y": v["x"] * 2})
    return table.with_column("reply", replies)


def _requests_batch(server, payloads):
    """Hand-built CachedRequests riding the server's epoch machinery,
    for driving the scoring internals without HTTP."""
    batch = [CachedRequest(f"rid{i}", HTTPRequestData(
        url="/", method="POST", headers={},
        entity=json.dumps(p).encode())) for i, p in enumerate(payloads)]
    server._record_epoch(batch)
    return batch


# -- poison isolation, deadlines, shedding, retry -------------------------------

def test_bisection_isolates_poison_requests_unit():
    cs = ContinuousServer("t_bisect_u", _poison_pipeline)
    try:
        batch = _requests_batch(
            cs.server, [{"x": 1}, {"x": 2, "poison": True}, {"x": 3},
                        {"x": 4}])
        epoch = batch[0].epoch
        segments = cs._score_resilient(batch)
        by_rid = {}
        for seg, out, err, status, commit_epochs in segments:
            for cr in seg:
                by_rid[cr.rid] = status
        assert by_rid == {"rid0": 200, "rid1": 400, "rid2": 200,
                          "rid3": 200}
        # the shared epoch rides ONLY the last segment
        assert [s[4] for s in segments[:-1]] == [()] * (len(segments) - 1)
        assert list(segments[-1][4]) == [epoch]
    finally:
        cs.stop()


def test_pipeline_break_mid_bisection_is_500_not_400():
    """A pipeline that dies DURING bisection is transient
    infrastructure failure: 500, never a client-blaming 400."""
    calls = {"n": 0}

    def pipeline(table):
        calls["n"] += 1
        if calls["n"] == 1:
            raise ValueError("looks like poison")
        raise PipelineBrokenError("pipeline died mid-bisection")

    cs = ContinuousServer("t_bisect_brk", pipeline, retry_transient=0)
    try:
        batch = _requests_batch(cs.server,
                                [{"x": 1}, {"x": 2}, {"x": 3}, {"x": 4}])
        statuses = {st for _, _, _, st, _ in cs._score_resilient(batch)}
        assert statuses == {500}
    finally:
        cs.stop()


def test_poison_batch_bisection_end_to_end():
    """One poisoned payload in a coalesced micro-batch gets 400; its
    neighbors still score 200 with correct outputs."""
    poison0 = _ctr("serving_poison_requests_total", server="t_poison")
    cs = ContinuousServer("t_poison", _poison_pipeline, max_batch=8,
                          batch_linger=0.5).start()
    try:
        n = 4
        barrier = threading.Barrier(n)
        results = [None] * n

        def client(i):
            barrier.wait(timeout=HARD)
            try:
                results[i] = _post(cs.url, {"x": i, "poison": i == 2})
            except urllib.error.HTTPError as e:
                results[i] = (e.code, None)

        threads = [threading.Thread(target=client, args=(i,))
                   for i in range(n)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=HARD)
            assert not t.is_alive(), "client hung"
        for i, (st, body) in enumerate(results):
            if i == 2:
                assert st == 400
            else:
                assert st == 200 and body == {"y": i * 2}
        assert _ctr("serving_poison_requests_total",
                    server="t_poison") == poison0 + 1
    finally:
        cs.stop()


def test_expired_deadline_shed_504_before_scoring():
    scored = []

    def pipeline(table):
        scored.extend(table["value"])
        return _echo_pipeline(table)

    shed0 = _ctr("serving_deadline_shed_total", server="t_dl")
    cs = ContinuousServer("t_dl", pipeline)  # not started yet
    try:
        result = {}

        def client():
            try:
                result["r"] = _post(cs.url, {"x": 1},
                                    headers={"X-Deadline-Ms": "30"})
            except urllib.error.HTTPError as e:
                result["r"] = (e.code, None)

        ct = threading.Thread(target=client)
        ct.start()
        time.sleep(0.3)  # the 30ms deadline expires while queued
        cs.start()
        ct.join(timeout=HARD)
        assert not ct.is_alive()
        assert result["r"][0] == 504
        assert scored == []  # wasted-work elimination: never scored
        assert _ctr("serving_deadline_shed_total",
                    server="t_dl") == shed0 + 1
        assert _post(cs.url, {"x": 2}) == (200, {"x": 2})
    finally:
        cs.stop()


def test_queue_shed_429_and_reply_timeout_504():
    """Admission control past max_queue is an immediate 429, and a
    request that waits out reply_timeout gets an explicit 504 plus the
    serving_reply_timeout_total count."""
    to0 = _ctr("serving_reply_timeout_total", server="t_q429")
    q0 = _ctr("serving_queue_shed_total", server="t_q429")
    cs = ContinuousServer("t_q429", _echo_pipeline, max_queue=1,
                          reply_timeout=1.0)  # never started: all park
    try:
        result = {}

        def client():
            try:
                result["r"] = _post(cs.url, {"x": 1})
            except urllib.error.HTTPError as e:
                result["r"] = (e.code, None)

        ct = threading.Thread(target=client)
        ct.start()
        deadline = time.monotonic() + HARD
        while cs.server.requests.qsize() < 1:
            assert time.monotonic() < deadline
            time.sleep(0.01)
        t0 = time.monotonic()
        with pytest.raises(urllib.error.HTTPError) as ei:
            _post(cs.url, {"x": 2})
        assert ei.value.code == 429
        assert time.monotonic() - t0 < 1.0  # shed at enqueue, no park
        assert _ctr("serving_queue_shed_total",
                    server="t_q429") == q0 + 1
        ct.join(timeout=HARD)
        assert not ct.is_alive()
        assert result["r"][0] == 504  # waited out reply_timeout
        assert _ctr("serving_reply_timeout_total",
                    server="t_q429") == to0 + 1
    finally:
        cs.stop()


def test_transient_pipeline_broken_gets_one_retry():
    calls = {"n": 0}

    def pipeline(table):
        calls["n"] += 1
        if calls["n"] == 1:
            raise PipelineBrokenError("injected transient break")
        return _echo_pipeline(table)

    retry0 = _ctr("serving_retry_total", server="t_retry")
    cs = ContinuousServer("t_retry", pipeline, max_batch=1,
                          retry_transient=1).start()
    try:
        # the bounded retry resubmits: the CLIENT sees 200, not 500
        assert _post(cs.url, {"x": 9}) == (200, {"x": 9})
        assert calls["n"] == 2
        assert _ctr("serving_retry_total", server="t_retry") == retry0 + 1
    finally:
        cs.stop()


@pytest.mark.parametrize("scope", ["scorer", "collector", "reply"])
def test_serving_thread_kill_recovery(scope):
    """Kill each serving-stage thread in turn: supervision restarts it
    (counted) and the next request still round-trips 200."""
    cs = ContinuousServer(f"t_kill_{scope}", _echo_pipeline,
                          scoring_workers=1).start()
    try:
        assert _post(cs.url, {"x": 1}) == (200, {"x": 1})
        flt.activate(f"thread_kill.{scope}", times=1)
        deadline = time.monotonic() + HARD
        while _ctr("serving_thread_restarts_total",
                   server=f"t_kill_{scope}", thread=scope) < 1:
            assert time.monotonic() < deadline, "no restart recorded"
            time.sleep(0.02)
        assert _post(cs.url, {"x": 2}) == (200, {"x": 2})
    finally:
        cs.stop()


def test_worker_server_bind_retries_past_taken_port():
    """A port probed free can be taken before the server binds: creation
    retries the NEXT ports instead of crashing, and says so."""
    blocker = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
    blocker.bind(("127.0.0.1", 0))
    taken = blocker.getsockname()[1]
    try:
        with pytest.warns(RuntimeWarning, match="requested port"):
            srv = WorkerServer("t_toctou", port=taken)
        try:
            assert srv.port != taken
            with urllib.request.urlopen(
                    f"http://127.0.0.1:{srv.port}/health",
                    timeout=HARD) as r:
                assert r.status == 200
        finally:
            srv.stop()
    finally:
        blocker.close()


def test_worker_server_bind_raises_non_addrinuse_errors():
    """Only EADDRINUSE is the race: any other bind failure (EADDRNOTAVAIL
    on an address this host does not hold) raises at once."""
    with pytest.raises(OSError) as ei:
        WorkerServer("t_bind_err", host="203.0.113.1", port=12631)
    assert ei.value.errno != errno.EADDRINUSE


# -- the single-server lifecycle ---------------------------------------------

def test_health_split_live_vs_ready():
    """/health/live is process-up (200 through warmup AND drain);
    /health(/ready) is traffic-worthiness (503 in both states)."""
    srv = WorkerServer("t_cf_health", ready=False)
    try:
        base = f"http://{srv.host}:{srv.port}"
        assert _get(f"{base}/health/live")[0] == 200
        assert _get(f"{base}/health/ready")[0] == 503  # warming
        assert _get(f"{base}/health")[0] == 503        # alias of ready
        srv.set_ready(True)
        assert _get(f"{base}/health/ready")[0] == 200
        assert _get(f"{base}/health")[0] == 200
        srv.begin_drain()
        assert _get(f"{base}/health/live")[0] == 200   # still alive
        st, hdrs = _get(f"{base}/health/ready")
        assert st == 503
        assert hdrs.get("Retry-After") == "1"
    finally:
        srv.stop()


def test_drain_gate_refuses_new_sheds_queued_finishes_accepted():
    """begin_drain: new enqueues 503 + Retry-After; wait_drained holds
    until accepted requests reply."""
    srv = WorkerServer("t_cf_drain", reply_timeout=HARD)
    try:
        results = {}

        def client():
            results["r"] = _post(srv.url, {"x": 1})

        th = threading.Thread(target=client)
        th.start()
        batch = srv.get_batch(max_rows=4, timeout=5.0)
        assert len(batch) == 1
        srv.begin_drain()
        assert srv.wait_drained(0.05) is False  # accepted, in flight
        with pytest.raises(urllib.error.HTTPError) as ei:
            _post(srv.url, {"x": 2})
        assert ei.value.code == 503
        assert ei.value.headers.get("Retry-After") == "1"
        ei.value.read()
        srv.reply_to(batch[0].rid, make_reply({"ok": True}))
        assert srv.wait_drained(HARD) is True
        th.join(timeout=HARD)
        assert results["r"] == (200, {"ok": True})
        assert _ctr("serving_drain_shed_total", server="t_cf_drain") >= 1
    finally:
        srv.stop()


def test_continuous_server_drain_then_stop():
    """ContinuousServer.drain: traffic in flight completes, the drain
    histogram records, and post-drain arrivals shed 503."""
    cs = ContinuousServer("t_cf_csdrain", _linear_pipeline,
                          max_batch=8, batch_linger=0.002).start()
    try:
        st, body = _post(cs.url, {"x": [1.0]})
        assert (st, body["y"]) == (200, [4.0])
        assert cs.drain(timeout_ms=5000) is True
        with pytest.raises(urllib.error.HTTPError) as ei:
            _post(cs.url, {"x": [2.0]})
        assert ei.value.code == 503
        ei.value.read()
        snap = tm.snapshot()["histograms"]
        key = [k for k in snap
               if k.startswith("synapseml_serving_drain_seconds")
               and "t_cf_csdrain" in k]
        assert key and snap[key[0]]["count"] >= 1
    finally:
        cs.stop()


def test_worker_stop_fails_queued_with_503():
    """stop() with unconsumed queued requests: explicit 503 +
    Retry-After, counted — never a silent reply_timeout."""
    srv = WorkerServer("t_cf_stopq", reply_timeout=HARD)
    results = {}

    def client():
        try:
            results["r"] = _post(srv.url, {"x": 1})
        except urllib.error.HTTPError as e:
            results["r"] = (e.code, dict(e.headers))

    th = threading.Thread(target=client)
    th.start()
    deadline = time.monotonic() + HARD
    while time.monotonic() < deadline and srv.requests.qsize() < 1:
        time.sleep(0.01)
    before = _ctr("serving_drain_shed_total", server="t_cf_stopq")
    srv.stop()
    th.join(timeout=HARD)
    assert not th.is_alive(), "client hung through stop()"
    st, hdrs = results["r"]
    assert st == 503
    assert hdrs.get("Retry-After") == "1"
    assert _ctr("serving_drain_shed_total",
                server="t_cf_stopq") >= before + 1


def test_stop_sets_drain_gate_before_shedding():
    srv = WorkerServer("t_cf_stopgate", reply_timeout=HARD)
    assert not srv.draining
    srv.stop()
    assert srv.draining


def test_retry_after_on_429_queue_shed():
    # scorer deliberately NOT started: with max_queue=0 admission sheds
    # every arrival at enqueue
    cs = ContinuousServer("t_cf_429", _linear_pipeline, max_queue=0)
    try:
        with pytest.raises(urllib.error.HTTPError) as ei:
            _post(cs.url, {"x": [1.0]})
        assert ei.value.code == 429
        assert ei.value.headers.get("Retry-After") == "1"
        ei.value.read()
    finally:
        cs.stop()


def test_retry_after_on_504_deadline_shed():
    cs = ContinuousServer("t_cf_504", _linear_pipeline,
                          max_batch=8).start()
    try:
        with pytest.raises(urllib.error.HTTPError) as ei:
            _post(cs.url, {"x": [1.0]}, headers={"X-Deadline-Ms": "0.01"})
        assert ei.value.code == 504
        assert ei.value.headers.get("Retry-After") == "1"
        ei.value.read()
    finally:
        cs.stop()


def test_retry_rng_seedable_and_injectable(monkeypatch):
    """SYNAPSEML_RETRY_SEED makes the transient-retry jitter stream
    deterministic; an injected RNG wins; a malformed seed degrades to
    the shared module PRNG."""
    inj = random.Random(5)
    assert _retry_rng(inj) is inj
    monkeypatch.setenv("SYNAPSEML_RETRY_SEED", "123")
    rng_a, rng_b = _retry_rng(), _retry_rng()
    assert rng_a is not rng_b
    want = random.Random(123)
    draws = [want.random() for _ in range(4)]
    assert [rng_a.random() for _ in range(4)] == draws
    assert [rng_b.random() for _ in range(4)] == draws
    monkeypatch.setenv("SYNAPSEML_RETRY_SEED", "not-a-seed")
    assert _retry_rng() is random
    monkeypatch.delenv("SYNAPSEML_RETRY_SEED")
    assert _retry_rng() is random
    cs = ContinuousServer("t_cf_rng", _linear_pipeline, retry_rng=inj)
    try:
        assert cs._retry_rng is inj
    finally:
        cs.stop()


# -- the channel layer: MultiChannelMap ---------------------------------------

def _cr(rid):
    return CachedRequest(rid, HTTPRequestData(
        url="/", method="POST", headers={}, entity=b"{}"))


def test_depth_aware_placement_prefers_least_loaded():
    """A backed-up channel sheds NEW load to its siblings instead of
    accumulating it; with uniform depths placement stays round-robin."""
    m = MultiChannelMap(3)
    for i in range(6):
        m.add(_cr(f"rr{i}"))
    assert m.depths() == [2, 2, 2]
    # channel 0 backs up (its consumer stalled): new adds avoid it
    for i in range(4):
        m.channel(0).put(_cr(f"deep{i}"))
    assert m.depths() == [6, 2, 2]
    for i in range(4):
        m.add(_cr(f"new{i}"))
    assert m.depths()[0] == 6  # nothing new landed on the deep channel
    assert sum(m.depths()) == 14


def test_placement_never_picks_quarantined_channel():
    m = MultiChannelMap(3)
    m.set_channel_enabled(0, False)
    assert m.enabled_channels() == [1, 2]
    for i in range(8):
        m.add(_cr(f"q{i}"))
    assert m.depths()[0] == 0
    assert sum(m.depths()) == 8
    # ALL channels quarantined: availability over purity — placement
    # degrades to least-loaded over everything rather than dropping
    m.set_channel_enabled(1, False)
    m.set_channel_enabled(2, False)
    m.add(_cr("last"))
    assert sum(m.depths()) == 9


def test_quarantine_redisperses_parked_requests():
    """A request must never sit on a queue no healthy consumer drains:
    tripping a channel moves its parked work onto enabled siblings."""
    m = MultiChannelMap(3)
    for i in range(5):
        m.channel(0).put(_cr(f"p{i}"))
    moved = m.set_channel_enabled(0, False)
    assert moved == 5
    d = m.depths()
    assert d[0] == 0 and d[1] + d[2] == 5
    # re-admitting moves nothing back (placement just may pick it again)
    assert m.set_channel_enabled(0, True) == 0
    assert m.enabled_channels() == [0, 1, 2]


def test_multichannelmap_concurrent_add_resize_quarantine():
    """No request lost or duplicated under concurrent add() +
    update_n_channels() + breaker-style quarantine/re-admit churn."""
    m = MultiChannelMap(3)
    N = 300
    stop = threading.Event()

    def adder():
        for i in range(N):
            m.add(_cr(f"r{i}"))

    def resizer():
        rng = random.Random(7)
        while not stop.is_set():
            m.update_n_channels(rng.randint(1, 4))
            time.sleep(0.001)

    def quarantiner():
        rng = random.Random(11)
        while not stop.is_set():
            ch = rng.randint(0, 3)
            m.set_channel_enabled(ch, False)
            time.sleep(0.001)
            m.set_channel_enabled(ch, True)

    threads = [threading.Thread(target=f)
               for f in (adder, resizer, quarantiner)]
    for t in threads:
        t.start()
    threads[0].join(timeout=HARD)
    assert not threads[0].is_alive(), "adder wedged"
    stop.set()
    for t in threads[1:]:
        t.join(timeout=HARD)
        assert not t.is_alive()
    m.update_n_channels(3)
    # re-enable everything, then drain all queues: exactly N unique rids
    for ch in range(3):
        m.set_channel_enabled(ch, True)
    seen = []
    for ch in range(3):
        q = m.channel(ch)
        while True:
            try:
                seen.append(q.get_nowait().rid)
            except Exception:  # noqa: BLE001 - queue.Empty
                break
    assert len(seen) == N, f"lost/duplicated: {len(seen)} != {N}"
    assert len(set(seen)) == N


# -- circuit breakers + failover dispatch -------------------------------------

def test_breaker_trips_quarantines_and_probe_readmits():
    """threshold consecutive failures trip OPEN (quarantine + placement
    avoidance); disarming the fault lets the half-open probe re-admit
    the channel CLOSED — the full state round trip, counted."""
    ds = DistributedServer("t_cf_brk", n_channels=2, breaker_threshold=2,
                           probe_interval=0.05)
    try:
        flt.activate("compute.channel0", prob=1.0)
        for _ in range(2):
            # failover: the same fn lands on channel 1 and succeeds
            assert ds.score_on_channel(0, lambda: 42) == 42
        # the trip wakes the probe, which may already be mid-pass
        # (HALF_OPEN) when we look: quarantined means NOT CLOSED
        assert ds.channel_state(0) != BREAKER_CLOSED
        assert ds.channels.enabled_channels() == [1]
        assert _ctr("serving_failover_total", server="t_cf_brk") >= 2
        assert _ctr("serving_channel_trips_total", server="t_cf_brk") >= 1

        flt.deactivate("compute.channel0")
        deadline = time.monotonic() + HARD
        while time.monotonic() < deadline and \
                ds.channel_state(0) != BREAKER_CLOSED:
            time.sleep(0.01)
        assert ds.channel_state(0) == BREAKER_CLOSED
        assert ds.channels.enabled_channels() == [0, 1]
        # the probe's bounce is faster than a scrape: transitions are
        # COUNTED per state, so the round trip is provable after the fact
        for state in ("open", "half_open", "closed"):
            assert _ctr("serving_breaker_transitions_total",
                        server="t_cf_brk", channel="0",
                        state=state) >= 1, state
    finally:
        ds.stop()


def test_breaker_trip_redisperses_parked_requests():
    """Requests parked on the tripping channel move to healthy siblings
    at trip time (counted in serving_redispersed_total)."""
    ds = DistributedServer("t_cf_redis", n_channels=2,
                           breaker_threshold=1, probe_interval=30.0)
    try:
        for i in range(4):
            ds.channels.channel(0).put(_cr(f"park{i}"))
        flt.activate("compute.channel0", prob=1.0)
        assert ds.score_on_channel(0, lambda: 1) == 1  # fails over
        # trip-woken probe may be mid-pass (HALF_OPEN); the armed fault
        # fails its canary, so the channel never returns to CLOSED
        assert ds.channel_state(0) != BREAKER_CLOSED
        assert ds.channels.depths()[0] == 0
        assert ds.channels.depths()[1] == 4
        assert _ctr("serving_redispersed_total", server="t_cf_redis") >= 4
    finally:
        ds.stop()


def test_no_healthy_sibling_raises_to_caller():
    """Failover needs a healthy target: with every other channel OPEN
    the original error propagates (the caller's explicit-error path —
    never a hang, never a silent drop)."""
    ds = DistributedServer("t_cf_alone", n_channels=2,
                           breaker_threshold=1, probe_interval=30.0)
    try:
        flt.activate("compute.channel0", prob=1.0)
        flt.activate("compute.channel1", prob=1.0)
        # channel0 fails -> trips OPEN -> fails over to channel1, whose
        # own fault fails the retry too: the error surfaces (explicitly)
        with pytest.raises(flt.FaultInjected):
            ds.score_on_channel(0, lambda: 1)
        # probe passes (woken at trip) fail on the armed faults: both
        # channels stay quarantined (OPEN, transiently HALF_OPEN)
        assert ds.channel_state(0) != BREAKER_CLOSED
        assert ds.channel_state(1) != BREAKER_CLOSED
        # both quarantined: no failover target exists, the error propagates
        with pytest.raises(flt.FaultInjected):
            ds.score_on_channel(1, lambda: 1)
    finally:
        ds.stop()


def test_stall_counts_as_breaker_failure():
    """A score stalled past stall_timeout counts against the channel
    even though its result still returns (the slow-channel trip)."""
    ds = DistributedServer("t_cf_stall", n_channels=2,
                           breaker_threshold=1, probe_interval=30.0,
                           stall_timeout=0.005)
    try:
        flt.activate("latency.channel_stall", prob=1.0, latency_ms=25.0)
        assert ds.score_on_channel(0, lambda: 7) == 7
        # the result returned, but the stall tripped the breaker
        assert _ctr("serving_channel_trips_total",
                    server="t_cf_stall") >= 1
    finally:
        ds.stop()


def test_probe_canary_stall_does_not_readmit():
    """A channel tripped for slowness must not be re-admitted by a
    canary that itself stalled — that would flap trip->re-admit->trip
    with a redisperse every cycle. The probe times its canary against
    stall_timeout like any real score."""
    ds = DistributedServer("t_cf_probestall", n_channels=2,
                           breaker_threshold=1, probe_interval=0.03,
                           stall_timeout=0.005)
    try:
        flt.activate("latency.channel_stall", prob=1.0, latency_ms=25.0)
        assert ds.score_on_channel(0, lambda: 3) == 3  # stall trips it
        deadline = time.monotonic() + HARD
        while time.monotonic() < deadline and _ctr(
                "serving_channel_probe_total", server="t_cf_probestall",
                outcome="fail") < 2:
            time.sleep(0.01)
        # probes ran and FAILED on the still-stalling canary; the
        # channel was never re-admitted
        assert _ctr("serving_channel_probe_total",
                    server="t_cf_probestall", outcome="fail") >= 2
        assert ds.channel_state(0) != BREAKER_CLOSED
        # disarm: the next canary is fast -> re-admitted CLOSED
        flt.deactivate("latency.channel_stall")
        deadline = time.monotonic() + HARD
        while time.monotonic() < deadline and \
                ds.channel_state(0) != BREAKER_CLOSED:
            time.sleep(0.01)
        assert ds.channel_state(0) == BREAKER_CLOSED
    finally:
        ds.stop()


def test_stall_on_failover_attempt_counts_against_target():
    """The failover attempt gets the same stall accounting as a direct
    score: a degraded channel every failover lands on must accrue
    breaker failures, not be recorded as an unconditional success."""
    ds = DistributedServer("t_cf_fostall", n_channels=2,
                           breaker_threshold=1, probe_interval=30.0,
                           stall_timeout=0.005)
    try:
        flt.activate("compute.channel0", prob=1.0)

        def slow():
            time.sleep(0.02)
            return 9

        # channel0 fails -> trips; failover to channel1 returns 9 but
        # stalls past stall_timeout -> channel1 trips too. Assert via
        # the monotonic trips counter: channel1's healthy canary may
        # legitimately re-admit it before state is observed (channel0
        # stays OPEN — its armed fault fails every probe)
        assert ds.score_on_channel(0, slow) == 9
        assert ds.channel_state(0) != BREAKER_CLOSED
        assert _ctr("serving_channel_trips_total",
                    server="t_cf_fostall") >= 2
    finally:
        ds.stop()


def test_serve_failover_bit_identical_e2e():
    """End to end over HTTP: with channel0's compute fault armed at
    prob 1.0, every request still gets 200 with the SAME numbers a
    healthy channel computes — failover is invisible to clients."""
    ds = DistributedServer("t_cf_e2e", n_channels=2, breaker_threshold=2,
                           probe_interval=0.05)
    ds.serve(_linear_pipeline, max_batch=8, linger=0.002)
    try:
        flt.activate("compute.channel0", prob=1.0)
        for k in range(8):
            st, body = _post(ds.url, {"x": [float(k), 2.0]})
            assert st == 200
            assert body["y"] == [k * 3.0 + 1.0, 7.0]
        assert ds.channel_state(0) != BREAKER_CLOSED
        flt.deactivate("compute.channel0")
        deadline = time.monotonic() + HARD
        while time.monotonic() < deadline and \
                ds.channel_state(0) != BREAKER_CLOSED:
            time.sleep(0.01)
        assert ds.channel_state(0) == BREAKER_CLOSED
        st, body = _post(ds.url, {"x": [1.0, 1.0]})
        assert (st, body["y"]) == (200, [4.0, 4.0])
    finally:
        ds.stop()


def test_default_canary_scores_real_pipeline_no_flap():
    """serve() wires a REAL-pipeline canary by default: a channel broken
    by a genuine (non-injected) fault is NOT re-admitted while the fault
    persists — a no-op canary would flap it OPEN->CLOSED->OPEN with a
    redisperse every probe cycle — and re-admission happens once the
    pipeline actually scores again."""
    broken = threading.Event()

    def pipeline(table: Table) -> Table:
        if broken.is_set():
            raise RuntimeError("device wedged")
        return _linear_pipeline(table)

    ds = DistributedServer("t_cf_canary", n_channels=2,
                           breaker_threshold=1, probe_interval=0.05)
    ds.serve(pipeline, max_batch=4, linger=0.002)
    try:
        # first success captures the known-good canary row
        st, body = _post(ds.url, {"x": [2.0]})
        assert (st, body["y"]) == (200, [7.0])
        deadline = time.monotonic() + HARD
        while time.monotonic() < deadline and ds._canary_table is None:
            time.sleep(0.01)
        assert ds._canary_table is not None
        assert ds.canary_fn is not None

        # a genuine fault (invisible to fault points) trips both
        # channels: the original score fails, so does the failover
        broken.set()
        with pytest.raises(urllib.error.HTTPError) as ei:
            _post(ds.url, {"x": [1.0]})
        assert ei.value.code == 500
        ei.value.read()
        deadline = time.monotonic() + HARD
        while time.monotonic() < deadline and not all(
                ds.channel_state(c) != BREAKER_CLOSED for c in (0, 1)):
            time.sleep(0.01)
        # the probe re-scores the canary through the REAL pipeline,
        # which still fails: channels must STAY quarantined (>= several
        # probe intervals — a no-op canary re-admits within one;
        # HALF_OPEN mid-probe still counts as quarantined)
        time.sleep(ds.probe_interval * 6)
        assert ds.channel_state(0) != BREAKER_CLOSED
        assert ds.channel_state(1) != BREAKER_CLOSED
        probe_fails = _ctr("serving_channel_probe_total",
                           server="t_cf_canary", outcome="fail")
        assert probe_fails >= 1

        # heal: the canary scores for real and re-admits both channels
        broken.clear()
        deadline = time.monotonic() + HARD
        while time.monotonic() < deadline and not all(
                ds.channel_state(c) == BREAKER_CLOSED for c in (0, 1)):
            time.sleep(0.01)
        assert ds.channel_state(0) == BREAKER_CLOSED
        assert ds.channel_state(1) == BREAKER_CLOSED
        st, body = _post(ds.url, {"x": [3.0]})
        assert (st, body["y"]) == (200, [10.0])
    finally:
        ds.stop()


def test_resize_while_serving_is_refused():
    """serve() snapshots the channel count: a live resize would route
    depth-aware placement onto queues no scorer drains (clients park
    until reply_timeout) — it must raise, not silently strand."""
    ds = DistributedServer("t_cf_resize", n_channels=2)
    ds.serve(_linear_pipeline, max_batch=4)
    try:
        with pytest.raises(ValueError, match="resize while serving"):
            ds.update_n_channels(4)
        assert ds.channels.n_channels == 2
    finally:
        ds.stop()
    # stopped: resize is supported again (stop, resize, re-serve)
    assert ds.channels.n_channels == 2


def test_distributed_stop_fails_parked_channel_requests():
    """stop() with requests still parked on channel queues replies an
    explicit 503 + Retry-After — clients never wait out reply_timeout."""
    ds = DistributedServer("t_cf_stop", n_channels=2, reply_timeout=HARD)
    results = {}

    def client():
        try:
            results["r"] = _post(ds.url, {"v": 1}) + ({},)
        except urllib.error.HTTPError as e:
            results["r"] = (e.code, None, dict(e.headers))
            e.read()

    th = threading.Thread(target=client)
    th.start()
    # wait for the distributor to fan the request onto a channel
    deadline = time.monotonic() + HARD
    while time.monotonic() < deadline and sum(ds.channels.depths()) < 1:
        time.sleep(0.01)
    assert sum(ds.channels.depths()) == 1
    ds.stop()
    th.join(timeout=HARD)
    assert not th.is_alive(), "client hung through stop()"
    st, _, hdrs = results["r"]
    assert st == 503
    assert hdrs.get("Retry-After") == "1"


def test_concurrent_trips_spawn_single_probe_thread():
    """_ensure_probe_thread under a thundering herd: N channels tripping
    in the same instant start exactly ONE probe loop (a second loop
    would double-probe quarantined channels and escape stop()'s join)."""
    ds = DistributedServer("t_cf_oneprobe", n_channels=2,
                           breaker_threshold=1, probe_interval=30.0)
    try:
        barrier = threading.Barrier(8)

        def racer():
            barrier.wait()
            ds._ensure_probe_thread()

        threads = [threading.Thread(target=racer) for _ in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=HARD)
        alive = [t for t in threading.enumerate()
                 if t.name == "breaker-probe-t_cf_oneprobe" and t.is_alive()]
        assert len(alive) == 1, f"{len(alive)} probe loops running"
        assert ds._probe_thread in alive
    finally:
        ds.stop()


def test_distributor_thread_kill_recovery():
    """An exception in DistributedServer._distribute would silently stop
    ALL traffic; supervision restarts the thread and requests keep
    routing."""
    ds = DistributedServer("t_kill_dist", n_channels=2)
    try:
        flt.activate("thread_kill.distributor", times=1)
        deadline = time.monotonic() + HARD
        while _ctr("serving_thread_restarts_total", server="t_kill_dist",
                   thread="distributor") < 1:
            assert time.monotonic() < deadline, "no restart recorded"
            time.sleep(0.02)
        result = {}

        def client():
            result["r"] = _post(ds.url, {"x": 7})

        ct = threading.Thread(target=client)
        ct.start()
        got = []
        deadline = time.monotonic() + HARD
        while not got and time.monotonic() < deadline:
            for ch in range(2):
                got.extend(ds.get_batch(ch, timeout=0.2))
        assert got, "request never routed after distributor restart"
        ds.reply_to(got[0].rid, make_reply({"ok": True}))
        ct.join(timeout=HARD)
        assert not ct.is_alive()
        assert result["r"] == (200, {"ok": True})
    finally:
        ds.stop()

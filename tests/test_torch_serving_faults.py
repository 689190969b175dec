"""Serving robustness of the port, on the CPU: poison isolation, the
deadline and queue sheds, transient retry, supervised serving threads,
the bind retry, and the single-server lifecycle (live/ready, the drain
gate, drain then stop, 503 on stop, ``Retry-After`` on every shed).

Ported from the serving half of the reference's ``tests/test_faults.py``
and the single-server tests of ``tests/test_channel_failover.py``; the
``DistributedServer`` tests beside them wait on ROADMAP Queue 1 item 3b.
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
from synapseml_tpu_torch.io.serving import (CachedRequest, ContinuousServer,
                                            WorkerServer, _retry_rng,
                                            make_reply)
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

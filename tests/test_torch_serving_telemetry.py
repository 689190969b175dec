"""Serving telemetry of the port, on the CPU: the metric registry under
concurrency, spans and their ring, the Prometheus exposition with its
exemplars, W3C ``traceparent``, a served request's span carrying the
executor's stages, the flight recorder (``runtime/blackbox.py``), the
structured log (``runtime/structlog.py``), the SLO math
(``runtime/slo.py``) and the ``/debug`` routes.

Ported from the serving, blackbox, structlog and SLO tests of the
reference's ``tests/test_telemetry.py`` and ``tests/test_blackbox.py``
(with its redisperse and breaker-trip events of ``DistributedServer``);
the executor runs with ``device="cpu"``. Left out with the code they
test: ``/debug/profile`` and the profiler helpers, the loadgen tool and
the 8-device dispatch counters (ROADMAP Queue 1 items 6 and 1e).
Every server binds port 0; every blocking wait has a hard wall.
"""
import glob
import http.client
import io
import json
import re
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest

from synapseml_tpu_torch.data.table import Table
from synapseml_tpu_torch.io.http import HTTPRequestData
from synapseml_tpu_torch.io.serving import (CachedRequest, ContinuousServer,
                                            DistributedServer,
                                            MultiChannelMap, WorkerServer,
                                            make_reply)
from synapseml_tpu_torch.runtime import blackbox as bb
from synapseml_tpu_torch.runtime import faults as flt
from synapseml_tpu_torch.runtime import slo
from synapseml_tpu_torch.runtime import structlog as slog
from synapseml_tpu_torch.runtime import telemetry as tm
from synapseml_tpu_torch.runtime.executor import BatchedExecutor
from synapseml_tpu_torch.runtime.faults import PipelineBrokenError

HARD = 30.0  # hard wall for any blocking wait: hang -> fast red X


@pytest.fixture(autouse=True)
def _clean_observability(tmp_path):
    """Fresh recorder + silent logs per test; dumps land in tmp."""
    flt.deactivate()
    prev_mode = slog.set_mode("")
    bb.set_dump_dir(str(tmp_path / "flight"))
    bb.configure(capacity=bb.DEFAULT_CAPACITY, min_dump_interval_s=0.0)
    bb.reset()
    yield
    flt.deactivate()
    slog.set_mode(prev_mode[0], level=prev_mode[1])
    bb.set_dump_dir(None)
    bb.configure(capacity=bb.DEFAULT_CAPACITY, min_dump_interval_s=10.0)
    bb.reset()


def _get(url, timeout=HARD):
    with urllib.request.urlopen(
            urllib.request.Request(url), timeout=timeout) as r:
        return r.status, r.read()


def _post(url, obj, timeout=HARD, headers=None):
    hdrs = {"Content-Type": "application/json"}
    hdrs.update(headers or {})
    req = urllib.request.Request(url, data=json.dumps(obj).encode(),
                                 method="POST", headers=hdrs)
    try:
        with urllib.request.urlopen(req, timeout=timeout) as r:
            return r.status, dict(r.headers), r.read()
    except urllib.error.HTTPError as e:
        body = e.read()
        return e.code, dict(e.headers), body


def _echo_pipeline(table: Table) -> Table:
    replies = np.empty(table.num_rows, dtype=object)
    for i, v in enumerate(table["value"]):
        replies[i] = make_reply({"echo": v})
    return table.with_column("reply", replies)


# -- metric primitives under concurrency ----------------------------------

def test_counter_concurrent_increments_exact():
    c = tm.counter("test_conc_counter", case="exact")
    base = c.value
    n_threads, per = 8, 20000

    def worker():
        for _ in range(per):
            c.inc()

    threads = [threading.Thread(target=worker) for _ in range(n_threads)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=HARD)
    assert c.value - base == n_threads * per


def test_histogram_concurrent_observes_exact_count_and_sum():
    h = tm.histogram("test_conc_hist", case="exact")
    n_threads, per = 8, 5000

    def worker(i):
        v = 0.001 * (i + 1)
        for _ in range(per):
            h.observe(v)

    threads = [threading.Thread(target=worker, args=(i,))
               for i in range(n_threads)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=HARD)
    s = h.summary()
    assert s["count"] == n_threads * per
    want = sum(0.001 * (i + 1) * per for i in range(n_threads))
    assert s["sum"] == pytest.approx(want, rel=1e-6)
    assert 0.0005 <= s["p50"] <= 0.01
    assert s["p50"] <= s["p95"] <= s["p99"]


def test_histogram_percentiles_deterministic():
    h = tm.histogram("test_hist_pct", buckets=(1.0, 2.0, 4.0, 8.0))
    for v in [0.5] * 50 + [3.0] * 50:
        h.observe(v)
    assert 0.0 < h.percentile(0.25) <= 1.0
    assert 2.0 < h.percentile(0.99) <= 4.0
    assert h.count == 100


def test_gauge_set_and_callable():
    g = tm.gauge("test_gauge_set")
    g.set(3.5)
    assert g.value == 3.5
    g.add(1.0)
    assert g.value == 4.5
    box = {"v": 7.0}
    gf = tm.gauge_fn("test_gauge_fn", lambda: box["v"])
    assert gf.value == 7.0
    box["v"] = 9.0
    assert gf.value == 9.0
    assert tm.unregister("test_gauge_fn")
    assert not tm.unregister("test_gauge_fn")


def test_kill_switch_noops_everything():
    c = tm.counter("test_kill_counter")
    h = tm.histogram("test_kill_hist")
    before_c, before_h = c.value, h.count
    prev = tm.set_enabled(False)
    try:
        c.inc()
        h.observe(1.0)
        span = tm.start_span("kill-rid")
        span.note("stage", 1.0)
        span.finish()
        assert tm.get_span("kill-rid") is None
        assert tm.current_spans() is None
    finally:
        tm.set_enabled(prev)
    assert c.value == before_c
    assert h.count == before_h
    c.inc()
    assert c.value == before_c + 1


def test_span_breakdown_and_lookup():
    span = tm.start_span("rid-span-unit")
    span.note("queue_wait", 0.010)
    span.note("compute", 0.005)
    span.note("compute", 0.002)
    assert tm.get_span("rid-span-unit") is span
    span.finish()
    again = tm.get_span("rid-span-unit")  # now from the completed ring
    assert again is span and span.status == "ok"
    b = span.breakdown()
    assert b["rid"] == "rid-span-unit"
    assert b["stages"]["queue_wait"] == pytest.approx(0.010)
    assert b["stages"]["compute"] == pytest.approx(0.007)
    span.finish("error")  # double finish is a no-op
    assert span.status == "ok"


def test_traceparent_parse_format_and_span_ring():
    tid, sid = "4bf92f3577b34da6a3ce929d0e0e4736", "00f067aa0ba902b7"
    assert tm.parse_traceparent(f"00-{tid}-{sid}-01") == (tid, sid)
    assert tm.parse_traceparent(f"01-{tid}-{sid}-01-extra") == (tid, sid)
    for bad in (None, "", "junk", f"ff-{tid}-{sid}-01",
                f"00-{tid}-{sid}-01-extra", f"00-{'0' * 32}-{sid}-01",
                f"00-{tid}-{'0' * 16}-01"):
        assert tm.parse_traceparent(bad) is None
    assert tm.format_traceparent(tid, sid) == f"00-{tid}-{sid}-01"
    assert tm.format_traceparent(tid, sid, sampled=False).endswith("-00")
    assert re.fullmatch(r"[0-9a-f]{32}", tm.mint_trace_id())
    assert re.fullmatch(r"[0-9a-f]{16}", tm.mint_span_id())
    prev = tm.span_ring_depth()
    try:
        assert tm.configure_span_ring(3) == 3
        for i in range(5):
            tm.start_span(f"ring-{i}", trace_id=tid).finish()
        assert [s["rid"] for s in tm.completed_spans()][-3:] == [
            "ring-2", "ring-3", "ring-4"]
        assert tm.get_span("ring-0") is None  # evicted
        assert [leg["rid"] for leg in tm.trace_spans(tid)] == [
            "ring-2", "ring-3", "ring-4"]
        with pytest.raises(ValueError):
            tm.configure_span_ring(0)
    finally:
        tm.configure_span_ring(prev)


# -- prometheus exposition ------------------------------------------------

_PROM_LINE = re.compile(
    r"^(# TYPE [a-zA-Z_:][a-zA-Z0-9_:]* (counter|gauge|histogram)"
    r"|[a-zA-Z_:][a-zA-Z0-9_:]*(\{[^{}]*\})? "
    r"[+-]?([0-9]*\.?[0-9]+([eE][+-]?[0-9]+)?|inf|nan))$")


def _assert_valid_exposition(text: str):
    assert text.endswith("\n")
    for line in text.rstrip("\n").splitlines():
        assert _PROM_LINE.match(line), f"invalid exposition line: {line!r}"


def test_prometheus_text_valid_and_histogram_cumulative():
    tm.counter("test_prom_counter", kind="a").inc(3)
    h = tm.histogram("test_prom_hist", buckets=(0.1, 1.0, 10.0))
    for v in (0.05, 0.5, 5.0, 50.0):
        h.observe(v)
    text = tm.prometheus_text()
    _assert_valid_exposition(text)
    bucket_lines = [ln for ln in text.splitlines()
                    if ln.startswith("synapseml_test_prom_hist_bucket")]
    assert len(bucket_lines) == 4  # 3 bounds + +Inf
    counts = [int(ln.rsplit(" ", 1)[1]) for ln in bucket_lines]
    assert counts == sorted(counts), "bucket counts must be cumulative"
    assert counts[-1] == 4
    assert 'le="+Inf"' in bucket_lines[-1]
    assert "synapseml_test_prom_hist_count 4" in text


def test_openmetrics_exemplars_only_when_asked():
    h = tm.histogram("test_om_hist", buckets=(0.1, 1.0))
    h.observe(0.5, exemplar="abc123")
    plain = tm.prometheus_text()
    assert "abc123" not in plain and "# EOF" not in plain
    om = tm.prometheus_text(openmetrics=True)
    line = next(ln for ln in om.splitlines()
                if ln.startswith('synapseml_test_om_hist_bucket{le="1.0"}'))
    assert '# {trace_id="abc123"} 0.5 ' in line
    assert om.rstrip("\n").endswith("# EOF")


def test_snapshot_shapes():
    tm.counter("test_snap_counter").inc()
    tm.histogram("test_snap_hist").observe(0.5)
    snap = tm.snapshot()
    assert {"counters", "gauges", "histograms", "spans"} <= snap.keys()
    assert any("test_snap_counter" in k for k in snap["counters"])
    hk = next(k for k in snap["histograms"] if "test_snap_hist" in k)
    assert {"count", "sum", "p50", "p95", "p99",
            "buckets"} <= snap["histograms"][hk].keys()
    compact = tm.snapshot(compact=True)
    hk = next(k for k in compact["histograms"] if "test_snap_hist" in k)
    assert "buckets" not in compact["histograms"][hk]


def test_executor_stage_histograms_and_aot_miss_move():
    h_stage = tm.histogram("executor_stage_seconds")
    h_drain = tm.histogram("executor_drain_seconds")
    miss = tm.counter("executor_aot_misses_total")
    c0, d0, m0 = h_stage.count, h_drain.count, miss.value
    ex = BatchedExecutor(lambda x: (x + 1.0,), device="cpu", min_bucket=8)
    try:
        ex(np.zeros((4, 3), np.float32))
        ex(np.ones((4, 3), np.float32))
        assert h_stage.count >= c0 + 2
        assert h_drain.count >= d0 + 2
        assert miss.value >= m0 + 2  # no warmup: every dispatch is a miss
    finally:
        ex.close()


# -- end-to-end: serving round trip -> span + /metrics + /span/<rid> ---------

def _conn_post(conn, body, headers=None):
    conn.request("POST", "/", body, {"Content-Type": "application/json",
                                     **(headers or {})})
    resp = conn.getresponse()
    return resp, resp.read()


def _conn_get(conn, path, headers=None):
    conn.request("GET", path, headers=headers or {})
    resp = conn.getresponse()
    return resp, resp.read()


def test_request_id_span_and_metrics_end_to_end():
    """A served request's span carries the serving stages AND the
    executor's (the scorer sets the batch's spans around ``pipeline_fn``;
    the port's executor notes stage, compute and drain on them)."""
    ex = BatchedExecutor(lambda x: (x * 2.0,), device="cpu", min_bucket=8)

    def pipeline(table):
        feats = np.stack([np.asarray(v["x"], np.float32)
                          for v in table["value"]])
        (out,) = ex(feats)
        replies = np.empty(table.num_rows, dtype=object)
        for i in range(table.num_rows):
            replies[i] = make_reply({"y": out[i].tolist()})
        return table.with_column("reply", replies)

    cs = ContinuousServer("telemetry_e2e", pipeline, max_batch=8).start()
    try:
        conn = http.client.HTTPConnection("127.0.0.1", cs.server.port,
                                          timeout=HARD)
        tid, parent = tm.mint_trace_id(), tm.mint_span_id()
        resp, data = _conn_post(
            conn, json.dumps({"x": [1.0, 2.0]}).encode(),
            {"traceparent": f"00-{tid}-{parent}-01"})
        assert resp.status == 200
        assert json.loads(data)["y"] == [2.0, 4.0]
        rid = resp.getheader("X-Request-Id")
        assert rid, "reply must carry the request id"
        tp = tm.parse_traceparent(resp.getheader("traceparent"))
        assert tp is not None and tp[0] == tid and tp[1] != parent

        deadline = time.monotonic() + 5
        span = tm.get_span(rid)
        while span is not None and span.status == "active" \
                and time.monotonic() < deadline:
            time.sleep(0.01)
            span = tm.get_span(rid)
        assert span is not None and span.status == "ok"
        assert span.trace_id == tid and span.parent_span_id == parent
        assert span.span_id == tp[1]
        stages = span.breakdown()["stages"]
        assert list(stages)[:6] == ["queue_wait", "batch_form", "stage",
                                    "compute", "drain", "reply"]
        assert span.output_digest == resp.getheader("X-Output-Digest")

        resp, data = _conn_get(conn, f"/span/{rid}")
        assert resp.status == 200
        assert json.loads(data)["rid"] == rid
        resp, _ = _conn_get(conn, "/span/nosuchrid")
        assert resp.status == 404
        resp, data = _conn_get(conn, f"/trace/{tid}")
        assert resp.status == 200
        legs = json.loads(data)["legs"]
        assert [leg["rid"] for leg in legs] == [rid]
        assert legs[0]["origin"] == "telemetry_e2e"
        resp, _ = _conn_get(conn, "/trace/not-hex")
        assert resp.status == 400
        resp, _ = _conn_get(conn, "/trace/" + "ab" * 16)
        assert resp.status == 404

        resp, data = _conn_get(conn, "/metrics")
        assert resp.status == 200
        assert resp.getheader("Content-Type", "").startswith("text/plain")
        text = data.decode()
        _assert_valid_exposition(text)
        for series in ("synapseml_serving_requests_total",
                       "synapseml_serving_batch_size",
                       "synapseml_serving_queue_wait_seconds",
                       "synapseml_serving_queue_depth",
                       "synapseml_serving_score_seconds",
                       "synapseml_executor_submit_total",
                       "synapseml_executor_stage_seconds",
                       "synapseml_executor_dispatch_total",
                       "synapseml_request_stage_seconds",
                       "synapseml_request_parse_seconds"):
            assert series in text, f"missing core series {series}"

        def series_value(text, prefix):
            for ln in text.splitlines():
                if ln.startswith(prefix):
                    return float(ln.rsplit(" ", 1)[1])
            return 0.0

        key = 'synapseml_serving_requests_total{server="telemetry_e2e"}'
        v1 = series_value(text, key)
        assert v1 >= 1
        _conn_post(conn, json.dumps({"x": [3.0, 4.0]}).encode())
        resp, data = _conn_get(conn, "/metrics")
        assert series_value(data.decode(), key) > v1
        # OpenMetrics on request: the roundtrip histogram's exemplar is
        # a served trace id
        resp, data = _conn_get(
            conn, "/metrics", {"Accept": "application/openmetrics-text"})
        assert resp.getheader("Content-Type").startswith(
            "application/openmetrics-text")
        assert 'trace_id="' in data.decode()
        conn.close()
    finally:
        cs.stop()
        ex.close()


def test_errors_ring_buffer_bounded_with_drop_count():
    cs = ContinuousServer("telemetry_ring", lambda t: t, max_errors=5)
    dropped0 = tm.counter("serving_errors_dropped_total",
                          server="telemetry_ring").value
    try:
        for i in range(12):
            cs._record_error(ValueError(f"boom-{i}"))
        assert len(cs.errors) == 5
        assert cs.errors_dropped == 7
        assert cs.errors == [f"ValueError('boom-{i}')" for i in range(7, 12)]
        assert tm.counter("serving_errors_dropped_total",
                          server="telemetry_ring").value - dropped0 == 7
    finally:
        cs.stop()


def test_errors_ring_survives_http_failures():
    """A pipeline that always raises: clients get 500s, the error ring
    stays bounded, the server keeps serving."""
    def bad_pipeline(table):
        raise RuntimeError("always broken")

    cs = ContinuousServer("telemetry_ring_http", bad_pipeline,
                          max_errors=3).start()
    try:
        conn = http.client.HTTPConnection("127.0.0.1", cs.server.port,
                                          timeout=HARD)
        for _ in range(7):
            resp, _data = _conn_post(conn, b'{"x": 1}')
            assert resp.status == 500
        conn.close()
        assert len(cs.errors) <= 3
        assert cs.errors_dropped >= 4
    finally:
        cs.stop()


# -- flight recorder ring ---------------------------------------------------

def test_ring_bounds_and_eviction():
    bb.configure(capacity=8)
    for i in range(20):
        bb.record("evt", idx=i)
    events = bb.snapshot(stacks=False)["events"]
    assert len(events) == 8
    assert [e["idx"] for e in events] == list(range(12, 20))
    seqs = [e["seq"] for e in events]
    assert seqs == sorted(seqs)  # monotone seq survives eviction


def test_record_fields_and_kill_switch():
    bb.record("rich", rid="r-1", channel=3, level="warn", n=2,
              rids=["a", "b"])
    (ev,) = bb.snapshot(stacks=False)["events"]
    assert ev["rid"] == "r-1" and ev["channel"] == 3
    assert ev["level"] == "warn" and ev["rids"] == ["a", "b"]
    assert ev["ts"] > 0 and "mono" in ev
    prev = bb.set_enabled(False)
    try:
        bb.record("dropped")
        assert bb.trigger("dropped_too") is None
        assert len(bb.snapshot(stacks=False)["events"]) == 1
    finally:
        bb.set_enabled(prev)


def test_snapshot_carries_threads_and_telemetry():
    bb.record("x")
    snap = bb.snapshot()
    names = {t["name"] for t in snap["threads"]}
    me = threading.current_thread().name
    assert me in names
    mine = next(t for t in snap["threads"] if t["name"] == me)
    assert any("test_torch_serving_telemetry" in fr["file"]
               for fr in mine["stack"])
    assert "counters" in snap["telemetry"]


def test_trigger_dumps_and_debounces(tmp_path):
    bb.configure(min_dump_interval_s=60.0)
    path = bb.trigger("unit_trip", channel=2, extra="ctx")
    assert path is not None
    deadline = time.monotonic() + HARD
    while bb.last_dump_path() != path and time.monotonic() < deadline:
        time.sleep(0.01)
    assert bb.last_dump_path() == path
    with open(path) as fh:
        d = json.load(fh)
    assert d["trigger"]["reason"] == "unit_trip"
    assert d["trigger"]["channel"] == 2
    assert d["events"][-1]["event"] == "unit_trip"
    assert d["threads"]
    # second trigger inside the window: event recorded, NO second dump
    assert bb.trigger("unit_trip") is None
    assert len(glob.glob(str(tmp_path / "flight" / "flight-*"))) == 1
    assert bb.last_dump_path() == path


def _cr(rid: str) -> CachedRequest:
    return CachedRequest(rid, HTTPRequestData(url="/", method="POST"))


# -- breaker trip -> auto dump, redisperse rids -------------------------------

def test_redisperse_records_rids():
    m = MultiChannelMap(3)
    rids = [f"p{i}" for i in range(5)]
    for r in rids:
        m.channel(0).put(_cr(r))
    assert m.set_channel_enabled(0, False) == 5
    evs = [e for e in bb.snapshot(stacks=False)["events"]
           if e["event"] == "redisperse"]
    assert evs and evs[-1]["channel"] == 0 and evs[-1]["n"] == 5
    assert set(evs[-1]["rids"]) <= set(rids)


def test_breaker_trip_auto_dumps_with_thread_stacks():
    flt.activate("compute.channel0", prob=1.0)
    ds = DistributedServer("bb_trip", n_channels=2,
                           breaker_threshold=1, probe_interval=5.0)
    ds.serve(_echo_pipeline, max_batch=4)
    try:
        # first scored batch on channel 0 fails -> trip (threshold 1)
        # -> failover to channel 1 -> the client still sees 200
        st, hdrs, body = _post(ds.url, {"x": [1.0]})
        assert st == 200, (st, body)
        deadline = time.monotonic() + HARD
        while bb.last_dump_path() is None and \
                time.monotonic() < deadline:
            time.sleep(0.02)
        path = bb.last_dump_path()
        assert path, "breaker trip produced no flight dump"
        with open(path) as fh:
            d = json.load(fh)
        kinds = [e["event"] for e in d["events"]]
        assert "breaker_trip" in kinds
        assert "breaker_transition" in kinds
        trip = next(e for e in d["events"]
                    if e["event"] == "breaker_trip")
        assert trip["channel"] == 0 and trip["server"] == "bb_trip"
        names = {t["name"] for t in d["threads"]}
        assert any(n.startswith("chan-scorer-bb_trip") for n in names)
        # the failover for the SAME batch lands in the ring right
        # after the trip dump; the live snapshot must carry its rid
        live = [e for e in bb.snapshot(stacks=False)["events"]
                if e["event"] == "failover"]
        assert live and live[-1]["channel"] == 0
        assert hdrs["X-Request-Id"] in live[-1]["rids"]
    finally:
        flt.deactivate()
        ds.stop()


def test_executor_pipeline_break_records_event():
    """The port's executor: a pipeline thread's death lands a
    ``pipeline_break`` event in the ring and a dump on disk."""
    ex = BatchedExecutor(lambda x: (x * 2.0,), device="cpu", min_bucket=4)
    try:
        flt.activate("thread_kill.drain", times=1)
        exc = ex.submit(np.ones((3, 2), np.float32)).exception(
            timeout=HARD)
        assert isinstance(exc, PipelineBrokenError)
        deadline = time.monotonic() + HARD
        evs = []
        while time.monotonic() < deadline:
            evs = [e for e in bb.snapshot(stacks=False)["events"]
                   if e["event"] == "pipeline_break"]
            if evs:
                break
            time.sleep(0.02)
        assert evs, "pipeline break never hit the flight ring"
        assert "drain" in evs[-1]["thread"]
        assert evs[-1]["n_inflight"] >= 1
        deadline = time.monotonic() + HARD
        while bb.last_dump_path() is None and time.monotonic() < deadline:
            time.sleep(0.02)
        assert bb.last_dump_path() is not None
    finally:
        flt.deactivate()
        ex.close(wait=False)


def test_executor_recompile_records_event():
    """After warmup, a signature it did not warm is a counted recompile
    AND a ``recompile`` event in the ring, as in the reference."""
    ex = BatchedExecutor(lambda x: (x + 1.0,), device="cpu",
                         min_bucket=8, max_bucket=8)
    try:
        ex.warmup([((3,), np.float32)])
        ex(np.zeros((2, 5), np.float32))  # an unwarmed row shape
        evs = [e for e in bb.snapshot(stacks=False)["events"]
               if e["event"] == "recompile"]
        assert len(evs) == 1
        assert evs[0]["reason"] == "shape_drift"
        assert evs[0]["bucket"] == 8 and evs[0]["device"] == "cpu"
    finally:
        ex.close()


# -- debug endpoints over HTTP ----------------------------------------------

def test_debug_flight_threads_and_build_endpoints():
    bb.record("marker", rid="dbg-1")
    srv = WorkerServer("bb_debug")
    try:
        base = f"http://{srv.host}:{srv.port}"
        st, body = _get(f"{base}/debug/flight")
        assert st == 200
        snap = json.loads(body)
        assert any(e.get("rid") == "dbg-1" for e in snap["events"])
        assert snap["threads"] and snap["telemetry"]
        st, body = _get(f"{base}/debug/threads")
        assert st == 200
        names = {t["name"] for t in json.loads(body)}
        assert "serving-bb_debug" in names  # the accept loop itself
        for t in json.loads(body):
            assert {"name", "ident", "daemon", "stack"} <= set(t)
        st, body = _get(f"{base}/debug/build")
        info = json.loads(body)
        assert st == 200 and info["server"] == "bb_debug"
        assert info["torch"] and "jax" not in info
        # this process never initialised CUDA: nothing reads the card
        assert info["backend"] == "uninitialized"
        assert info["device_kind"] is None
        assert info["ready"] is True and info["draining"] is False
    finally:
        srv.stop()


def test_debug_endpoints_gate(monkeypatch):
    """SYNAPSEML_DEBUG_ENDPOINTS=0 locks the whole /debug surface down;
    /metrics stays open."""
    monkeypatch.setenv("SYNAPSEML_DEBUG_ENDPOINTS", "0")
    srv = WorkerServer("bb_gated")
    try:
        base = f"http://{srv.host}:{srv.port}"
        for path in ("/debug/flight", "/debug/threads", "/debug/build",
                     "/debug/profile?ms=10"):
            try:
                st, _ = _get(f"{base}{path}")
            except urllib.error.HTTPError as e:
                st = e.code
            assert st == 403, path
        st, _ = _get(f"{base}/metrics")
        assert st == 200
    finally:
        srv.stop()


@pytest.mark.parametrize("path", ["/debug/capture", "/debug/cost",
                                  "/debug/memory", "/debug/profile?ms=10"])
def test_unported_debug_routes_answer_as_unknown_routes(path):
    """Incident capture, the cost model, the memory picture and the
    profiler route are not ported (ROADMAP Queue 1 item 6): their paths
    answer as any unknown route does — a GET that rides the pipeline."""
    cs = ContinuousServer("bb_unported", _echo_pipeline).start()
    try:
        def fetch(p):
            conn = http.client.HTTPConnection("127.0.0.1", cs.server.port,
                                              timeout=HARD)
            try:
                resp, data = _conn_get(conn, p)
                return resp.status, data
            finally:
                conn.close()

        assert fetch(path) == fetch("/no/such/route") == (
            200, b'{"echo": null}')
    finally:
        cs.stop()


# -- structured logging + rid round trip ------------------------------------

def test_structlog_schema_text_and_levels():
    buf = io.StringIO()
    slog.set_mode("json", level="info", stream=buf)
    slog.log("debug", "below_floor", rid="x")  # filtered
    slog.log("warn", "kept", rid="r9", channel=1, n=3)
    lines = [ln for ln in buf.getvalue().splitlines() if ln]
    assert len(lines) == 1
    rec = json.loads(lines[0])
    assert rec["event"] == "kept" and rec["level"] == "warn"
    assert rec["rid"] == "r9" and rec["channel"] == 1 and rec["n"] == 3
    assert rec["ts"] > 0
    buf2 = io.StringIO()
    slog.set_mode("text", stream=buf2)
    slog.log("info", "human", rid="r10")
    assert "human" in buf2.getvalue() and "rid=r10" in buf2.getvalue()
    with pytest.raises(ValueError):
        slog.set_mode("yaml")


def test_structlog_queue_drops_instead_of_blocking(monkeypatch):
    """The stderr path never blocks the caller: a full queue drops the
    line and counts it."""
    slog.set_mode("json")
    monkeypatch.setattr(slog._CFG, "stream", None)  # the stderr path
    monkeypatch.setattr(slog, "_ensure_writer", lambda: None)
    q = slog._LOG_Q
    held = []
    try:
        while True:
            try:
                q.put_nowait("x")
                held.append(1)
            except Exception:  # noqa: BLE001 - queue.Full
                break
        before = slog.dropped_lines()
        t0 = time.monotonic()
        slog.log("info", "overflow")
        assert time.monotonic() - t0 < 1.0
        assert slog.dropped_lines() == before + 1
    finally:
        for _ in held:
            q.get_nowait()


def test_client_request_id_round_trip_through_serving():
    buf = io.StringIO()
    slog.set_mode("json", level="debug", stream=buf)
    cs = ContinuousServer("bb_rid", _echo_pipeline, max_batch=4).start()
    try:
        st, hdrs, body = _post(cs.url, {"x": 1},
                               headers={"X-Request-Id": "caller-abc.1"})
        assert st == 200
        assert hdrs["X-Request-Id"] == "caller-abc.1"
        assert tm.get_span("caller-abc.1") is not None
        recs = [json.loads(ln) for ln in buf.getvalue().splitlines()
                if ln.startswith("{")]
        mine = [r for r in recs if r.get("rid") == "caller-abc.1"]
        assert {"request", "reply"} <= {r["event"] for r in mine}
        st, hdrs, _ = _post(cs.url, {"x": 2},
                            headers={"X-Request-Id": "y" * 300})
        assert st == 200
        assert hdrs["X-Request-Id"] != "y" * 300
        assert len(hdrs["X-Request-Id"]) == 32
    finally:
        cs.stop()


def test_request_id_echoed_on_shed_paths():
    srv = WorkerServer("bb_shed", max_queue=0)
    try:
        st, hdrs, _ = _post(f"http://{srv.host}:{srv.port}/", {"x": 1},
                            headers={"X-Request-Id": "shed-me-7"})
        assert st == 429
        assert hdrs["X-Request-Id"] == "shed-me-7"
        assert int(hdrs["Retry-After"]) >= 1
        srv.begin_drain()
        st, hdrs, _ = _post(f"http://{srv.host}:{srv.port}/", {"x": 1},
                            headers={"X-Request-Id": "drain-me-8"})
        assert st == 503
        assert hdrs["X-Request-Id"] == "drain-me-8"
        shed_evs = [e["event"] for e in
                    bb.snapshot(stacks=False)["events"]]
        assert "shed_queue" in shed_evs and "shed_drain" in shed_evs
    finally:
        srv.stop()


# -- SLO math ---------------------------------------------------------------

def test_slo_availability_math():
    assert slo.availability({}) == 1.0
    assert slo.availability({200: 99, 500: 1}) == pytest.approx(0.99)
    assert slo.availability({200: 50, 503: 25, 504: 25}) == \
        pytest.approx(0.5)
    assert slo.availability({200: 1, 400: 7, 429: 2}) == 1.0
    assert slo.availability({"error": 1, 200: 1}) == pytest.approx(0.5)


def test_slo_fraction_le_against_known_histogram():
    bounds = (0.1, 0.2, 0.4)
    assert slo.fraction_le(bounds, [0, 0, 0, 0], 0.2) == 1.0
    assert slo.fraction_le(bounds, [4, 4, 0, 0], 0.2) == 1.0
    assert slo.fraction_le(bounds, [4, 0, 0, 4], 0.2) == \
        pytest.approx(0.5)
    assert slo.fraction_le(bounds, [0, 0, 10, 0], 0.3) == \
        pytest.approx(0.5)
    h = tm.Histogram("synapseml_t_slo_hist", (), buckets=bounds)
    for v in (0.05, 0.15, 0.15, 0.3, 0.9):
        h.observe(v)
    counts, _, _ = h._aggregate()
    assert slo.fraction_le(bounds, counts, 0.2) == pytest.approx(3 / 5)


def test_slo_burn_rate_math():
    assert slo.burn_rate(1.0, 0.999) == 0.0
    assert slo.burn_rate(0.98, 0.99) == pytest.approx(2.0)
    assert slo.burn_rate(0.999, 0.999) == pytest.approx(1.0)
    assert slo.burn_rate(0.5, 1.0) == float("inf")
    assert slo.burn_rate(1.0, 1.0) == 0.0


def test_server_slo_gauges_on_scrape():
    srv = WorkerServer("bb_slo")
    try:
        srv.slo_availability_target = 0.99
        srv.slo_latency_target = 0.99
        srv.slo_latency_threshold_s = 0.25
        srv._reply_counter(200).inc(98)
        srv._reply_counter(500).inc(2)
        for _ in range(8):
            srv._m_roundtrip.observe(0.01)
        for _ in range(2):
            srv._m_roundtrip.observe(5.0)
        gauges = tm.snapshot()["gauges"]

        def g(name):
            return gauges[f'synapseml_{name}{{server="bb_slo"}}']

        assert g("serving_slo_availability") == pytest.approx(0.98)
        assert g("serving_slo_availability_burn_rate") == \
            pytest.approx(2.0)
        assert g("serving_slo_latency_good_fraction") == \
            pytest.approx(0.8)
        assert g("serving_slo_latency_burn_rate") == \
            pytest.approx(20.0)
        assert g("serving_slo_latency_threshold_ms") == \
            pytest.approx(250.0)
        text = tm.prometheus_text()
        assert 'synapseml_serving_slo_availability{server="bb_slo"}' \
            in text
    finally:
        srv.stop()
    assert 'server="bb_slo"' not in "".join(
        k for k in tm.snapshot()["gauges"])


def test_cached_request_deadline_and_span_context():
    cr = CachedRequest("dl", HTTPRequestData(url="/"), deadline_ms=50.0,
                       trace_id="ab" * 16, parent_span_id="cd" * 8,
                       span_id="ef" * 8, origin="srv")
    assert cr.deadline == pytest.approx(cr.arrival + 0.05)
    assert cr.span.trace_id == "ab" * 16
    assert cr.span.parent_span_id == "cd" * 8
    assert cr.span.span_id == "ef" * 8 and cr.span.origin == "srv"
    assert CachedRequest("nodl", HTTPRequestData(url="/")).deadline is None

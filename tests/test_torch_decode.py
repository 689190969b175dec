"""The port's continuous-batching decode scheduler
(``runtime/decode.py``) and ``POST /generate`` against the JAX package's,
on the CPU, at ``zoo.tiny_decoder()``'s default width (vocab 64, d_model
32, 4 heads, 2 KV heads, 2 layers).

The token streams are held EXACTLY to the JAX scheduler's, recorded in
``tests/fixtures/decode_streams.npz`` by
``tests/fixtures/make_decode_fixture.py`` from the sequences of
``tests/fixtures/decode_streams.py`` (continuous, static and the
evicting 4-page scheduler; the same ``record`` runs the port here). A
greedy stream can leave the reference's only where a step's top-2 logits
lie within the XLA/torch CPU difference (~1e-6 of the logits); the
fixture's prompts are ``tests/test_decode.py``'s own and have no such
tie (every stream matches), so no prompt is replaced. One prompt is also
run live through the JAX scheduler. The other tests port
``tests/test_decode.py:155-329`` one for one against the port's
scheduler, and show the two refusals the port adds beside what the
reference does with the same input (ROADMAP Queue 3).

Schedulers are module-scoped and run on ``device="cpu"``.
"""
import hashlib
import http.client
import json
import os
import re
import sys

import numpy as np
import pytest
import torch

from synapseml_tpu.onnx import zoo as jzoo
from synapseml_tpu.onnx.importer import import_model as jimport_model
from synapseml_tpu.runtime.decode import DecodeScheduler as JDecodeScheduler

from synapseml_tpu_torch.io.serving import ContinuousServer
from synapseml_tpu_torch.onnx import zoo
from synapseml_tpu_torch.onnx.importer import import_model
from synapseml_tpu_torch.runtime import telemetry as _tm
from synapseml_tpu_torch.runtime.decode import DecodeScheduler
from synapseml_tpu_torch.runtime.kvcache import PagedKVCache

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURES = os.path.join(ROOT, "tests", "fixtures")
sys.path.insert(0, FIXTURES)
import decode_streams as decode_fx  # noqa: E402

HARD = 120.0  # hard wall for any blocking wait


@pytest.fixture(scope="module")
def graph():
    return import_model(zoo.tiny_decoder())


@pytest.fixture(scope="module")
def fixture():
    return dict(np.load(os.path.join(FIXTURES, "decode_streams.npz")))


@pytest.fixture(scope="module")
def recorded(graph):
    return decode_fx.record(decode_fx.maker(DecodeScheduler, PagedKVCache,
                                            graph, device="cpu"),
                            _tm, tag="_port")


@pytest.fixture(scope="module")
def sched(graph):
    """Big-capacity warmed scheduler: no evictions, pure scheduling."""
    s = DecodeScheduler(graph, name="t_pdec", capacity_bytes=10 ** 9,
                        device="cpu", **decode_fx.GEOMETRY)
    s.warmup()
    s.start()
    yield s
    s.close()


@pytest.fixture(scope="module")
def tiny_sched(graph):
    """4-page scheduler: a 40-token prompt can never fit."""
    s = decode_fx.maker(DecodeScheduler, PagedKVCache, graph, device="cpu")(
        "t_pdec_tiny", pages=decode_fx.EVICT_PAGES,
        cache_name="t_pdec_tiny_kv")
    s.start()
    yield s
    s.close()


@pytest.fixture(scope="module")
def jsched():
    """The reference's scheduler, unwarmed (its signatures compile on
    first use): the live comparison and its behaviour on the inputs the
    port refuses."""
    s = JDecodeScheduler(jimport_model(jzoo.tiny_decoder()), name="t_jdec",
                         capacity_bytes=10 ** 9, **decode_fx.GEOMETRY)
    yield s
    s.close()


def _recompiles():
    text = _tm.prometheus_text()
    return sum(int(float(v)) for v in re.findall(
        r'executor_recompiles_total\{[^}]*\} (\S+)', text))


# -- streams against the JAX package -------------------------------------

@pytest.mark.parametrize("key", ["continuous", "continuous_reasons",
                                 "static", "static_reasons", "evict",
                                 "evict_reasons", "evict_solo"])
def test_streams_equal_the_jax_fixture(recorded, fixture, key):
    np.testing.assert_array_equal(recorded[key], fixture[key])


def test_evicting_run_evicts_and_recomputes_as_the_reference(recorded,
                                                             fixture):
    assert recorded["evictions"] >= 1 and recorded["recomputes"] >= 1
    assert (int(recorded["evictions"]), int(recorded["recomputes"])) == (
        int(fixture["evictions"]), int(fixture["recomputes"]))
    np.testing.assert_array_equal(recorded["evict"], recorded["evict_solo"])


def test_one_prompt_live_against_the_jax_scheduler(sched, jsched):
    prompt = decode_fx.prompts((13,), seed=7)[0]
    want = jsched.submit(prompt, max_new_tokens=10).result(timeout=HARD)
    assert sched.submit(prompt, max_new_tokens=10).result(
        timeout=HARD) == want


# -- the scheduler (tests/test_decode.py:155-246) -------------------------

def test_mixed_prompts_complete_with_zero_recompiles(sched):
    before = _recompiles()
    handles = [sched.submit(p, max_new_tokens=12)
               for p in decode_fx.prompts((3, 11, 20, 5, 17, 9))]
    results = [h.result(timeout=HARD) for h in handles]
    assert all(reason == "completed" for _, reason in results)
    assert all(len(toks) == 12 for toks, _ in results)
    # every (phase, T) signature was warmed: the steady-state loop never
    # runs a cold one (the recompile sentinel)
    assert _recompiles() == before


def test_warmup_reports_every_signature(graph):
    s = DecodeScheduler(graph, name="t_pdec_warm", device="cpu",
                        capacity_bytes=10 ** 9, **decode_fx.GEOMETRY)
    try:
        rep = s.warmup()
    finally:
        s.close()
    assert [(sig["phase"], sig["S"], sig["T"]) for sig in
            rep["signatures"]] == [(ph, s_, t) for t in (8, 16, 32, 64)
                                   for ph, s_ in (("prefill", 8),
                                                  ("decode", 1))]
    assert all(sig["entries"] == ["compiled"] for sig in rep["signatures"])


def test_repeat_submission_is_deterministic(sched):
    prompt = decode_fx.prompts((13,), seed=7)[0]
    a = sched.submit(prompt, max_new_tokens=10).result(timeout=HARD)
    b = sched.submit(prompt, max_new_tokens=10).result(timeout=HARD)
    assert a == b


def test_streaming_iteration_matches_result(sched):
    prompt = decode_fx.prompts((9,), seed=3)[0]
    ref, _ = sched.submit(prompt, max_new_tokens=8).result(timeout=HARD)
    h = sched.submit(prompt, max_new_tokens=8)
    assert list(h) == ref
    assert h.finish_reason == "completed"


def test_deadline_expiry_is_partial_not_error(sched):
    h = sched.submit([1, 2, 3], max_new_tokens=50, deadline_s=1e-6)
    toks, reason = h.result(timeout=HARD)
    assert reason == "deadline"
    assert len(toks) < 50


def test_submit_validation_as_the_reference(sched, jsched):
    for s in (sched, jsched):
        with pytest.raises(ValueError):
            s.submit([], max_new_tokens=4)
        with pytest.raises(ValueError):
            s.submit([1] * 60, max_new_tokens=10)  # 70 > max_seq=64
        with pytest.raises(ValueError):
            s.submit([1, 2], max_new_tokens=0)


def test_out_of_range_token_is_refused_where_the_reference_reads_nan(
        sched, jsched):
    """The reference's ``Gather`` (``jnp.take``, mode fill) reads a NaN
    embedding row for token 70 of a 64-word vocabulary, so its logits are
    NaN and argmax emits token 0 every step; on the card the port's
    ``index_select`` would assert and end the process, so ``submit``
    refuses it before anything runs."""
    assert sched.vocab == 64
    toks, reason = jsched.submit([70, 3, 5], max_new_tokens=4).result(
        timeout=HARD)
    assert (toks, reason) == ([0, 0, 0, 0], "completed")
    for bad in ([70, 3, 5], [3, -1], [64]):
        with pytest.raises(ValueError, match=r"outside \[0, 64\)"):
            sched.submit(bad, max_new_tokens=4)
    # the scheduler goes on serving: the edge of the vocabulary is fine
    toks, reason = sched.submit([63, 0, 5], max_new_tokens=4).result(
        timeout=HARD)
    assert reason == "completed" and len(toks) == 4


def test_token_range_comes_from_the_embedding_when_logits_are_symbolic():
    """A graph whose logits leave the vocabulary symbolic still bounds
    its ids, by the rows of the embedding its ``Gather`` reads; where
    neither gives a bound the constructor refuses the graph."""
    g = import_model(zoo.tiny_decoder(vocab=48))
    dim = g.graph.output[0].type.tensor_type.shape.dim[-1]
    dim.dim_value, dim.dim_param = None, "V"
    s = DecodeScheduler(g, name="t_pvocab", capacity_bytes=10 ** 9,
                        device="cpu", **decode_fx.GEOMETRY)
    try:
        assert s.vocab == 48
        with pytest.raises(ValueError, match=r"outside \[0, 48\)"):
            s.submit([3, 48], max_new_tokens=2)
    finally:
        s.close()
    table = next(n.input[0] for n in g.graph.node if n.op_type == "Gather")
    del g.params[table]
    with pytest.raises(ValueError, match="cannot bound the token ids"):
        DecodeScheduler(g, name="t_pvocab2", device="cpu",
                        **decode_fx.GEOMETRY)


def test_prefill_chunk_above_page_is_refused_where_the_reference_fails_warmup(
        graph, jsched):
    """With ``prefill_chunk > page_size`` the ladder's first rung (one
    page) is shorter than a prefill chunk. The reference's constructor
    accepts it and its warmup reports that signature ``error`` (a
    ``dynamic_update_slice`` shape error); the port's scatter start
    ``T - S`` would be negative there, a device assert on the card, so
    its constructor refuses the geometry."""
    j = JDecodeScheduler(jimport_model(jzoo.tiny_decoder()), name="t_jgeo",
                         max_batch=4, prefill_chunk=16, page_size=8,
                         max_seq=16, capacity_bytes=10 ** 9)
    try:
        kv = [((2, 8, 8), np.float32)] * 4
        rep = j._ex.warmup([((16,), np.int64), ((), np.int32)] + kv)
        assert [e["status"] for e in rep.entries] == ["error"]
    finally:
        j.close()
    with pytest.raises(ValueError, match="prefill_chunk=16 exceeds "
                                         "page_size=8"):
        DecodeScheduler(graph, name="t_pgeo", max_batch=4, prefill_chunk=16,
                        page_size=8, max_seq=16, device="cpu")


@pytest.mark.parametrize("slots", [2, 3])
def test_devices_slots_give_the_one_slot_ids(graph, fixture, slots):
    """``devices=["cpu"] * n`` over the continuous stream: 2 slots shard
    the static batch of 4 (the present buffers joined in row order before
    the merge), 3 run each step whole round robin; the ids equal the JAX
    fixture's, which the one-slot scheduler reproduces
    (``test_streams_equal_the_jax_fixture``), with no copy between
    devices."""
    moved = _tm.counter("executor_cross_device_copies_total")
    before = moved.value
    s = decode_fx.maker(DecodeScheduler, PagedKVCache, graph, device="cpu",
                        devices=["cpu"] * slots)(
        f"t_pdev{slots}", capacity_bytes=10 ** 9)
    try:
        assert s._ex.n_devices == slots
        assert s._ex._layout(s.B) == ("shard" if slots == 2 else "rr")
        res = decode_fx.run_batch(s, decode_fx.prompts(
            decode_fx.CONTINUOUS_LENS, decode_fx.CONTINUOUS_SEED))
    finally:
        s.close()
    np.testing.assert_array_equal(np.array([t for t, _ in res], np.int64),
                                  fixture["continuous"])
    assert moved.value == before


def test_bad_devices_spec_is_refused(graph, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 0)
    with pytest.raises(ValueError, match="devices=2 but 0 CUDA devices"):
        DecodeScheduler(graph, name="t_pdev_bad", devices=2, device="cpu",
                        **decode_fx.GEOMETRY)
    with pytest.raises(ValueError, match="not understood"):
        DecodeScheduler(graph, name="t_pdev_bad", devices="some",
                        device="cpu", **decode_fx.GEOMETRY)


def test_admission_queue_full_raises(sched):
    old = sched.max_waiting
    sched.max_waiting = 0
    try:
        with pytest.raises(RuntimeError):
            sched.submit([1, 2, 3], max_new_tokens=4)
    finally:
        sched.max_waiting = old


def test_stats_shape_is_the_reference(sched, jsched):
    st = sched.stats()
    assert set(st) == set(jsched.stats())
    assert st["warmed"] is True
    assert st["capacity_pages"] >= 1
    assert st["t_bucket"] in sched.t_ladder


def test_unfittable_prompt_finishes_kv_capacity(tiny_sched):
    # 40 tokens need 6 pages against a 4-page cache: admissible by the
    # geometry (40 + 8 <= max_seq) but never by capacity — retired with
    # reason kv_capacity, not hung
    toks, reason = tiny_sched.submit(
        list(range(1, 41)), max_new_tokens=8).result(timeout=HARD)
    assert (toks, reason) == ([], "kv_capacity")


# -- /generate over HTTP (tests/test_decode.py:251-329) -------------------

@pytest.fixture(scope="module")
def decode_server(sched):
    cs = ContinuousServer("t_pdec_http", lambda table: table, port=0,
                          ready=False)
    cs.server.decode = sched
    cs.server.set_ready(True)
    yield cs
    cs.stop()


def _generate(cs, payload, headers=()):
    host, port = cs.url.split("//")[1].rstrip("/").split(":")
    c = http.client.HTTPConnection(host, int(port), timeout=HARD)
    hdrs = {"Content-Type": "application/json"}
    hdrs.update(dict(headers))
    c.request("POST", "/generate", body=json.dumps(payload).encode(),
              headers=hdrs)
    r = c.getresponse()
    return r, r.read()


def test_generate_nonstream_digest_and_provenance(decode_server):
    r, body = _generate(decode_server,
                        {"tokens": [5, 9, 13, 2], "max_new_tokens": 8},
                        headers={"X-Request-Id": "rid-dec-1"})
    assert r.status == 200
    assert r.getheader("X-Request-Id") == "rid-dec-1"
    assert r.getheader("traceparent")
    assert r.getheader("X-Output-Digest") == hashlib.sha256(body).hexdigest()
    obj = json.loads(body)
    assert obj["prompt_len"] == 4
    assert len(obj["tokens"]) == 8
    assert obj["finish_reason"] == "completed"


def test_generate_stream_matches_nonstream_digest(decode_server):
    ref_r, ref_body = _generate(
        decode_server, {"tokens": [5, 9, 13, 2], "max_new_tokens": 8})
    ref_digest = ref_r.getheader("X-Output-Digest")
    ref_tokens = json.loads(ref_body)["tokens"]
    r, body = _generate(decode_server,
                        {"tokens": [5, 9, 13, 2], "max_new_tokens": 8,
                         "stream": True},
                        headers={"X-Request-Id": "rid-dec-s"})
    assert r.status == 200
    assert r.getheader("X-Request-Id") == "rid-dec-s"
    assert r.getheader("traceparent")
    assert r.getheader("Content-Type") == "application/x-ndjson"
    lines = body.decode().strip().split("\n")
    assert [json.loads(ln)["i"] for ln in lines[:-1]] == list(range(8))
    assert [json.loads(ln)["t"] for ln in lines[:-1]] == ref_tokens
    final = json.loads(lines[-1])
    assert final["done"] and final["finish_reason"] == "completed"
    assert final["n"] == 8
    # the streamed fingerprint is the CANONICAL body digest
    assert final["digest"] == ref_digest


def test_generate_bad_request_too_long_and_out_of_range(decode_server):
    r, _ = _generate(decode_server, {"max_new_tokens": 8})  # no tokens
    assert r.status == 400
    r, _ = _generate(decode_server,
                     {"tokens": [1] * 60, "max_new_tokens": 10})
    assert r.status == 400
    r, body = _generate(decode_server, {"tokens": [5, 64], "max_new_tokens": 2})
    assert r.status == 400 and b"outside [0, 64)" in body
    r, _ = _generate(decode_server, {"tokens": [5, 9], "max_new_tokens": 2})
    assert r.status == 200


def test_generate_deadline_header(decode_server):
    r, body = _generate(decode_server,
                        {"tokens": [1, 2, 3], "max_new_tokens": 50},
                        headers={"X-Deadline-Ms": "0.001"})
    assert r.status == 200
    assert json.loads(body)["finish_reason"] == "deadline"


def test_generate_admission_full_is_429(decode_server, sched):
    old = sched.max_waiting
    sched.max_waiting = 0
    try:
        r, _ = _generate(decode_server, {"tokens": [1, 2], "max_new_tokens": 2})
    finally:
        sched.max_waiting = old
    assert r.status == 429 and r.getheader("Retry-After")

"""The port's ``runtime/autotune.py`` and ``runtime/proberoute.py`` (the
shared verify-then-time prober) and its lanes, on the CPU.

The reference's own tests (``tests/test_autotune.py``), ported one for one:
the routing loop's failure contract (verify mismatch -> reference
PERSISTED, timing regression -> reference persisted, probe crash ->
in-process memo only, kill switch -> zero probes and zero table I/O), the
fleet-sharing path (a sibling process's persisted verdict is adopted with
zero probes), two routers as lane callers (the int8 router; in the gbdt
predict router's place, which the port leaves out by design, the
executor's H2D lane), and the prober's fixes: no D2H in ``best_of``'s
timed region, selective negative retirement in ``RouteTable.record``,
single-flight disk reads in ``lookup``.

Then the port's own: the key prefix, the capture rule (a route without a
verdict under a CUDA-graph capture serves the reference and records
nothing), single-flight probes across threads, ``compute_dtype="auto"``
keying the executor cache, ``preferred_wire``, the ``coalesced`` staging
bitwise ``per_arg`` (directly and through the executor), and dispatch
never probing.
"""
import json
import os
import subprocess
import sys
import threading
import time

import numpy as np
import pytest
import torch

from synapseml_tpu_torch.runtime import autotune
from synapseml_tpu_torch.runtime import executor as ex_mod
from synapseml_tpu_torch.runtime import proberoute as pr

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture
def at_env(tmp_path, monkeypatch):
    monkeypatch.setenv("SYNAPSEML_TPU_CACHE_DIR", str(tmp_path))
    monkeypatch.delenv("SYNAPSEML_AUTOTUNE", raising=False)
    yield tmp_path


def _lane(name, candidates, reference, verify_fn=None, time_fn=None,
          reps=2):
    """A host-only decomposed lane over 1-D float arrays; candidates
    map choice -> make(rargs, args) like the real registrations."""
    return autotune.register_lane(
        name,
        key_fn=lambda n: f"t|{n}",
        candidates=candidates,
        verify_fn=verify_fn,
        reference=reference,
        args_fn=lambda n: (np.arange(n, dtype=np.float64),),
        time_fn=time_fn,
        reps=reps,
    )


def _mk(fn):
    return lambda rargs, args: fn


def test_registry_round_trip_probes_once_and_persists(at_env):
    calls = {"ref": 0, "cand": 0}

    def ref(x):
        calls["ref"] += 1
        return x * 2.0

    def cand(x):
        calls["cand"] += 1
        return x + x

    ln = _lane("t_round_trip", {"ref": _mk(ref), "cand": _mk(cand)},
               "ref")
    ln.time_fn = lambda fn, a, r: 1.0 if fn is cand else 2.0
    assert ln.route(8) == "cand"
    assert ln.probes == 1
    # memoized: no second probe, same verdict
    assert ln.route(8) == "cand"
    assert ln.probes == 1
    # persisted for the fleet
    path = os.path.join(str(at_env), "autotune_t_round_trip.json")
    with open(path) as fh:
        assert json.load(fh) == {"t|8": "cand"}
    # a fresh table (new process stand-in) adopts it with zero probes
    ln2 = _lane("t_round_trip", {"ref": _mk(ref), "cand": _mk(cand)},
                "ref")
    assert ln2.route(8) == "cand"
    assert ln2.probes == 0
    assert autotune.cached("t_round_trip", 8) == "cand"


def test_verify_failure_falls_back_and_persists_reference(at_env):
    def ref(x):
        return x * 2.0

    def wrong(x):
        return x * 3.0  # mismatches the reference output

    ln = _lane("t_mismatch", {"ref": _mk(ref), "wrong": _mk(wrong)},
               "ref", time_fn=lambda fn, a, r: 0.0)
    assert ln.route(8) == "ref"
    assert ln.probes == 1
    # the reference verdict IS persisted: a deterministic mismatch
    # must not re-pay the probe after restart
    with open(os.path.join(str(at_env),
                           "autotune_t_mismatch.json")) as fh:
        assert json.load(fh) == {"t|8": "ref"}
    ln2 = _lane("t_mismatch", {"ref": _mk(ref), "wrong": _mk(wrong)},
                "ref")
    assert ln2.route(8) == "ref"
    assert ln2.probes == 0


def test_timing_regression_keeps_reference(at_env):
    def ref(x):
        return x * 2.0

    def slow(x):
        return x + x  # verifies clean, times slower

    ln = _lane("t_slow", {"ref": _mk(ref), "slow": _mk(slow)}, "ref")
    ln.time_fn = lambda fn, a, r: 5.0 if fn is slow else 1.0
    assert ln.route(8) == "ref"
    with open(os.path.join(str(at_env), "autotune_t_slow.json")) as fh:
        assert json.load(fh) == {"t|8": "ref"}


def test_probe_crash_memoized_in_process_only(at_env):
    calls = {"n": 0}

    def boom(rargs, args):
        calls["n"] += 1
        raise RuntimeError("compile exploded")

    def ref(x):
        return x

    # the REFERENCE build crashing is the probe crashing
    ln = _lane("t_crash", {"ref": boom, "cand": _mk(ref)}, "ref")
    assert ln.route(8) == "ref"
    assert ln.probes == 1
    # in-process memo: no second probe for the same key ...
    assert ln.route(8) == "ref"
    assert calls["n"] == 1
    # ... but NOTHING persisted — a transient crash must not be
    # remembered fleet-wide
    assert not os.path.exists(
        os.path.join(str(at_env), "autotune_t_crash.json"))


def test_kill_switch_zero_probes_zero_io(at_env, monkeypatch):
    monkeypatch.setenv("SYNAPSEML_AUTOTUNE", "0")

    def forbid(*a, **k):
        raise AssertionError("probe ran under the kill switch")

    ln = _lane("t_kill", {"ref": forbid, "cand": forbid}, "ref")
    ln.probe = forbid
    assert ln.route(8) == "ref"
    assert ln.cached(8) is None
    assert ln.probes == 0
    assert not os.listdir(str(at_env))
    assert autotune.snapshot()["enabled"] is False


def test_route_never_raises(at_env):
    ln = _lane("t_neverraise", {"ref": _mk(lambda x: x)}, "ref")
    ln.key_fn = lambda *a: (_ for _ in ()).throw(RuntimeError("key"))
    assert ln.route(8) == "ref"
    assert ln.cached(8) is None


def test_cross_process_sharing(at_env):
    """Process A probes and persists; process B (fresh interpreter,
    same SYNAPSEML_TPU_CACHE_DIR) serves the verdict with ZERO
    probes — the fleet-shared half of the contract, for real."""
    prog = r"""
import json, sys
import numpy as np
from synapseml_tpu_torch.runtime import autotune

ln = autotune.register_lane(
    "t_fleet",
    key_fn=lambda n: f"t|{n}",
    candidates={"ref": lambda r, a: (lambda x: x * 2.0),
                "cand": lambda r, a: (lambda x: x + x)},
    reference="ref",
    args_fn=lambda n: (np.arange(n, dtype=np.float64),),
    time_fn=lambda fn, a, r: 1.0 if fn(np.ones(1))[0] == 2.0 else 9.0,
)
# both legs compute x*2 so time_fn cannot tell them apart by value;
# the candidate wins ties
print(json.dumps({"choice": ln.route(64), "probes": ln.probes}))
"""
    env = dict(os.environ, SYNAPSEML_TPU_CACHE_DIR=str(at_env),
               PYTHONPATH=ROOT)
    out_a = subprocess.run([sys.executable, "-c", prog], env=env,
                           capture_output=True, text=True, check=True)
    got_a = json.loads(out_a.stdout.strip().splitlines()[-1])
    assert got_a["probes"] == 1
    out_b = subprocess.run([sys.executable, "-c", prog], env=env,
                           capture_output=True, text=True, check=True)
    got_b = json.loads(out_b.stdout.strip().splitlines()[-1])
    assert got_b["probes"] == 0
    assert got_b["choice"] == got_a["choice"]


def test_poison_persists_demotion(at_env):
    ln = _lane("t_poison", {"ref": _mk(lambda x: x * 2.0),
                            "cand": _mk(lambda x: x + x)}, "ref",
               time_fn=lambda fn, a, r: 0.0)
    ln.poison(8)
    with open(os.path.join(str(at_env),
                           "autotune_t_poison.json")) as fh:
        assert json.load(fh) == {"t|8": "ref"}
    # a later route serves the demotion without probing
    assert ln.route(8) == "ref"
    assert ln.probes == 0


def test_verify_then_time_candidate_wins_ties(at_env):
    def ref(x):
        return x * 2.0

    def cand(x):
        return x + x

    got = autotune.verify_then_time(
        {"ref": ref, "cand": cand}, (np.arange(4.0),), "ref",
        time_fn=lambda fn, a, r: 1.0)
    assert got == "cand"


def test_snapshot_shape(at_env):
    ln = _lane("t_snap", {"ref": _mk(lambda x: x)}, "ref")
    ln.groups = ("some_group",)
    ln.route(4)
    snap = autotune.snapshot()
    rec = snap["lanes"]["t_snap"]
    assert rec["reference"] == "ref"
    assert rec["groups"] == ["some_group"]
    assert rec["decisions"] == {"t|4": "ref"}
    assert rec["table"] == "autotune_t_snap.json"


# -- two routers as lane callers ------------------------------------------


def test_executor_h2d_is_an_autotune_lane(at_env, monkeypatch):
    """The executor's H2D lane (the port leaves the reference's gbdt
    predict router out by design; this lane takes its place here): a
    registered lane, probed from ``warmup`` through the lane's table, read
    by the dispatch path."""
    ln = ex_mod._h2d_lane()
    assert autotune.lane("executor_h2d") is ln
    assert ln.reference == "per_arg"
    assert set(ln.candidates) == {"per_arg", "coalesced"}
    ln.reset()
    monkeypatch.setattr(ln, "probe", lambda rargs: "coalesced")
    ex = ex_mod.BatchedExecutor(lambda a, b: (a + b,), device="cpu",
                                max_bucket=8)
    ex.warmup([((4,), np.float32), ((4,), np.float32)], buckets=[8])
    assert ln.probes == 1
    sig = (((8, 4), "float32"), ((8, 4), "float32"))
    assert ln.cached(sig, torch.device("cpu")) == "coalesced"
    assert ex._h2d_choice_for(sig) == "coalesced"
    ln.reset()
    ex.close()


def test_quant_route_is_an_autotune_lane(at_env, monkeypatch):
    from synapseml_tpu_torch.onnx import quant_route

    quant_route.clear_cache()
    mm = autotune.lane("onnx_int8_matmul")
    cv = autotune.lane("onnx_int8_conv")
    assert mm is quant_route._MM_LANE and cv is quant_route._CONV_LANE
    assert mm.reference == "dequant" and cv.reference == "dequant"
    monkeypatch.setattr(quant_route, "_routes_here", lambda t: True)
    monkeypatch.setattr(quant_route, "_probe_matmul",
                        lambda *a: "int8")
    a = torch.zeros((256, 256), dtype=torch.uint8)
    b = torch.zeros((256, 256), dtype=torch.int8)
    got = quant_route.route_matmul(a, b, np.uint8(3), np.int8(0))
    assert got == "int8"
    assert mm.probes == 1
    # same args, no second probe
    assert quant_route.route_matmul(a, b, np.uint8(3),
                                    np.int8(0)) == "int8"
    assert mm.probes == 1
    quant_route.clear_cache()


# -- the prober's fixes ----------------------------------------------------


class _LazyFetch:
    """Device-tensor stand-in: completion is cheap, every value fetch is
    expensive — exactly the asymmetry a fetching timing loop
    mis-measures."""

    D2H_SLEEP = 0.25

    def _fetch(self, *a, **k):
        time.sleep(self.D2H_SLEEP)
        return np.zeros(1)

    __array__ = cpu = numpy = tolist = item = _fetch


def test_best_of_no_d2h_in_timed_region():
    t = pr.best_of(lambda: _LazyFetch(), (), reps=2)
    # the wait on the card never fetches the value; the timed region
    # stays ~free
    assert t < _LazyFetch.D2H_SLEEP / 2


def test_record_retires_only_satisfied_negatives(tmp_path, monkeypatch):
    monkeypatch.setenv("SYNAPSEML_TPU_CACHE_DIR", str(tmp_path))
    t = pr.RouteTable("t_selective.json")
    assert t.lookup("k1") is None  # negatives armed for k1
    assert t.lookup("k2") is None  # ... and k2
    reads = {"n": 0}
    orig = pr.RouteTable._load_disk

    def counting(self):
        reads["n"] += 1
        return orig(self)

    monkeypatch.setattr(pr.RouteTable, "_load_disk", counting)
    t.record("k1", "v1")  # persists; must NOT blanket-clear k2's neg
    assert "k2" in t._neg
    before = reads["n"]
    assert t.lookup("k2") is None  # fresh negative: no disk re-read
    assert reads["n"] == before


def test_record_merge_adopts_sibling_and_retires_its_negative(
        tmp_path, monkeypatch):
    monkeypatch.setenv("SYNAPSEML_TPU_CACHE_DIR", str(tmp_path))
    t = pr.RouteTable("t_sibling.json")
    assert t.lookup("k2") is None  # negative armed
    # a sibling worker lands k2 on the shared volume
    sib = pr.RouteTable("t_sibling.json")
    sib.record("k2", "v2")
    # our own record's pre-write merge surfaces it: memo adopted, k2's
    # negative retired, visible immediately despite the TTL
    t.record("k1", "v1")
    assert "k2" not in t._neg
    assert t.lookup("k2") == "v2"


def test_lookup_single_flight(tmp_path, monkeypatch):
    monkeypatch.setenv("SYNAPSEML_TPU_CACHE_DIR", str(tmp_path))
    t = pr.RouteTable("t_flight.json")
    os.makedirs(str(tmp_path), exist_ok=True)
    with open(t.path(), "w") as fh:
        json.dump({"k": "v"}, fh)
    n = 4
    gate = threading.Barrier(n)
    reads = {"n": 0}
    orig = pr.RouteTable._load_disk

    def slow_read(self):
        reads["n"] += 1
        time.sleep(0.05)  # hold the read open so the others pile up
        return orig(self)

    monkeypatch.setattr(pr.RouteTable, "_load_disk", slow_read)
    got = [None] * n

    def worker(i):
        gate.wait()
        got[i] = t.lookup("k")

    threads = [threading.Thread(target=worker, args=(i,))
               for i in range(n)]
    for th in threads:
        th.start()
    for th in threads:
        th.join()
    assert got == ["v"] * n
    assert reads["n"] == 1  # one disk read served all concurrent missers


# -- the port's own --------------------------------------------------------


def test_key_prefix_names_the_stack_and_the_device():
    """torch's version, the package's and the device (``cpu`` here): a
    change of any re-probes."""
    import synapseml_tpu_torch

    got = autotune.key_prefix("q1", "cpu")
    assert got.startswith("at1|") and got.endswith("|q1")
    assert f"torch={torch.__version__}" in got and "device=cpu" in got
    assert f"pkg{synapseml_tpu_torch.__version__}" in got


def test_route_under_a_capture_serves_the_reference_and_records_nothing(
        at_env, monkeypatch):
    """A class without a verdict met while the current stream captures a
    CUDA graph: the reference serves, nothing is probed, memoized or
    persisted; the next eager route probes."""
    ln = _lane("t_capture", {"ref": _mk(lambda x: x * 2.0),
                             "cand": _mk(lambda x: x + x)}, "ref",
               time_fn=lambda fn, a, r: 0.0)
    monkeypatch.setattr(autotune, "capturing", lambda: True)
    assert ln.route(8) == "ref"
    assert ln.probes == 0 and not ln.decisions
    assert not os.listdir(str(at_env))
    monkeypatch.setattr(autotune, "capturing", lambda: False)
    assert ln.route(8) == "cand" and ln.probes == 1
    # a verdict found under a capture serves
    monkeypatch.setattr(autotune, "capturing", lambda: True)
    assert ln.route(8) == "cand" and ln.probes == 1


def test_probes_are_single_flight_across_threads(at_env):
    """Threads meeting one new class (the slots of a ``devices=``
    executor) run ONE probe; the others wait for its verdict."""
    started = threading.Event()

    def slow_ref(rargs, args):
        started.set()
        time.sleep(0.1)
        return lambda x: x * 2.0

    ln = _lane("t_flight_probe", {"ref": slow_ref,
                                  "cand": _mk(lambda x: x + x)}, "ref",
               time_fn=lambda fn, a, r: 0.0)
    got = []
    threads = [threading.Thread(target=lambda: got.append(ln.route(8)))
               for _ in range(4)]
    for th in threads:
        th.start()
    for th in threads:
        th.join()
    assert got == ["cand"] * 4 and ln.probes == 1


@pytest.fixture(scope="module")
def tiny_resnet():
    from synapseml_tpu_torch.onnx import zoo

    return zoo.tiny_resnet(), np.random.default_rng(0).standard_normal(
        (5, 3, 32, 32)).astype(np.float32)


@pytest.mark.parametrize("verdict", ["float32", "bfloat16"])
def test_compute_dtype_auto_keys_the_executor_cache(at_env, monkeypatch,
                                                    tiny_resnet, verdict):
    """``compute_dtype="auto"`` resolves through the lane before the
    executor cache is read, and the resolved dtype keys it: the executor
    is the explicit dtype's, and a verdict flip builds another."""
    from synapseml_tpu_torch.data.table import Table
    from synapseml_tpu_torch.onnx import ONNXModel
    from synapseml_tpu_torch.onnx import model as model_mod

    blob, x = tiny_resnet
    model_mod._DTYPE_LANE.reset()
    monkeypatch.setattr(model_mod._DTYPE_LANE, "probe",
                        lambda rargs: verdict)
    auto = ONNXModel(model_bytes=blob, compute_dtype="auto",
                     mini_batch_size=8)
    ex = auto._executor("cpu")
    assert auto._executor("cpu") is ex
    assert model_mod._DTYPE_LANE.probes == 1
    key = next(iter(auto._executor_cache))
    assert key[2] == verdict
    want = {"float32": None, "bfloat16": torch.bfloat16}[verdict]
    assert ex._compute_dtype == want
    got = auto.transform(Table({"data": x}), "cpu")
    same = ONNXModel(model_bytes=blob, compute_dtype=verdict,
                     mini_batch_size=8).transform(Table({"data": x}), "cpu")
    for col in got.columns:
        assert np.array_equal(got[col], same[col]), col
    other = "float32" if verdict == "bfloat16" else "bfloat16"
    model_mod._DTYPE_LANE.table.record(
        next(iter(model_mod._DTYPE_LANE.decisions)), other, persist=False)
    assert auto._executor("cpu") is not ex
    assert {k[2] for k in auto._executor_cache} == {verdict, other}
    model_mod._DTYPE_LANE.reset()


def test_compute_dtype_probe_runs_both_candidates_on_the_cpu(at_env,
                                                             tiny_resnet):
    """The real probe: both candidates bound and run, the bf16 one
    verified within 5% of the float32 output's largest |value|."""
    from synapseml_tpu_torch.onnx import import_model
    from synapseml_tpu_torch.onnx import model as model_mod

    blob, _ = tiny_resnet
    model_mod._DTYPE_LANE.reset()
    got = model_mod.routed_compute_dtype(import_model(blob), blob, 8, "cpu")
    assert got in ("float32", "bfloat16")
    assert model_mod._DTYPE_LANE.probes == 1
    model_mod._DTYPE_LANE.reset()


def test_preferred_wire(at_env, tiny_resnet):
    """"float" without ``input_norm``; with it, the lane's measured
    verdict, probed once and read after."""
    from synapseml_tpu_torch.onnx import ONNXModel
    from synapseml_tpu_torch.onnx import model as model_mod

    blob, _ = tiny_resnet
    m = ONNXModel(model_bytes=blob)
    assert m.preferred_wire("data", device="cpu") == "float"
    model_mod._WIRE_LANE.reset()
    m.set(input_norm={"data": {"mean": 127.5, "scale": 1 / 64.0}})
    got = m.preferred_wire("data", batch=16, device="cpu")
    assert got in ("uint8", "float")
    assert m.preferred_wire("data", batch=16, device="cpu") == got
    assert model_mod._WIRE_LANE.probes == 1
    model_mod._WIRE_LANE.reset()


def test_coalesced_put_is_bitwise_per_arg():
    rng = np.random.default_rng(0)
    arrays = [torch.from_numpy(rng.standard_normal((8, 3))
                               .astype(np.float32)),
              torch.from_numpy(rng.integers(0, 9, (8, 5)).astype(np.int32)),
              torch.from_numpy(rng.standard_normal((8, 2, 2))
                               .astype(np.float32)),
              torch.from_numpy(rng.standard_normal(8)).to(torch.bfloat16)]
    got, held = ex_mod._coalesced_put(arrays, torch.device("cpu"))
    assert len(held) == 1 and held[0].numel() == 8 * 3 + 8 * 4
    for g, a in zip(got, arrays):
        assert g.dtype == a.dtype and g.shape == a.shape
        assert torch.equal(g, a)
    ln = ex_mod._h2d_lane()
    args = ex_mod._h2d_args((((8, 3), "float32"), ((8, 3), "float32")),
                            torch.device("cpu"))
    fns = {c: make((None, torch.device("cpu")), args)
           for c, make in ln.candidates.items()}
    assert ex_mod._h2d_verify(autotune._fetch(fns["coalesced"](*args)),
                              autotune._fetch(fns["per_arg"](*args)))


@pytest.mark.parametrize("choice", ["per_arg", "coalesced"])
def test_executor_stages_coalesced_bitwise_per_arg(at_env, monkeypatch,
                                                   choice):
    """Three host columns (two float32, one int32) through the executor
    under each verdict, with a ragged tail: the same outputs, bitwise."""
    monkeypatch.setattr(ex_mod.BatchedExecutor, "_h2d_choice_for",
                        lambda self, hkey: choice)
    puts = []
    real_put = ex_mod._coalesced_put
    monkeypatch.setattr(ex_mod, "_coalesced_put",
                        lambda *a, **k: puts.append(a) or real_put(*a, **k))
    rng = np.random.default_rng(1)
    a = rng.standard_normal((21, 4)).astype(np.float32)
    b = rng.standard_normal((21, 4)).astype(np.float32)
    c = rng.integers(0, 5, (21, 4)).astype(np.int32)
    ex = ex_mod.BatchedExecutor(lambda x, y, z: (x * y + z, x - y),
                                device="cpu", max_bucket=8)
    got = ex(a, b, c)
    ex.close()
    ta, tb, tc = (torch.from_numpy(v) for v in (a, b, c))
    assert np.array_equal(got[0], (ta * tb + tc).numpy())
    assert np.array_equal(got[1], (ta - tb).numpy())
    # 21 rows at bucket 8: three batches, each three host columns
    assert len(puts) == (3 if choice == "coalesced" else 0)
    assert all(len(p[0]) == 3 for p in puts)


def test_dispatch_never_probes(at_env, monkeypatch):
    """A multi-argument executor that is called without warmup serves
    ``per_arg`` and probes nothing; ``warmup`` probes once a signature,
    and the dispatch memo it drops is refilled from the table."""
    ln = ex_mod._h2d_lane()
    ln.reset()
    probed = []
    monkeypatch.setattr(ln, "probe",
                        lambda rargs: probed.append(rargs) or "coalesced")
    ex = ex_mod.BatchedExecutor(lambda x, y: (x + y,), device="cpu",
                                max_bucket=8)
    x = np.ones((8, 3), np.float32)
    ex(x, x)
    assert not probed
    assert set(ex._h2d_choice.values()) == {"per_arg"}
    ex.warmup([((3,), np.float32), ((3,), np.float32)], buckets=[8])
    assert len(probed) == 1 and ex._h2d_choice == {}
    np.testing.assert_array_equal(ex(x, x)[0], x + x)
    assert set(ex._h2d_choice.values()) == {"coalesced"}
    assert len(probed) == 1
    ln.reset()
    ex.close()

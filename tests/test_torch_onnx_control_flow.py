"""The port's control flow (``If``, ``Loop``, ``Scan``) and the activation
family against the JAX package's importer.

Every graph of the reference's own control-flow tests
(``tests/test_onnx.py``: ``If`` on host and device conditions, each
``Loop`` case, ``Scan`` forward, reverse and longer than 16 steps) goes as
the same bytes, on the same seeded numpy inputs, through both importers on
the CPU (``torch_onnx_parity.run_both``), fed host values and device
values; the errors the reference raises are raised alike. Then the port's
own plumbing: an outer value read only by a body (``_last_uses``),
``truncated`` keeping captured params, and bound bodies whose float
initializers are tensors on the bind's device, one copy a bind.

Tolerance: float32 outputs within rtol=atol=1e-5 of the reference's
(control flow adds no arithmetic of its own: most cases are bitwise);
integer outputs equal; output dtypes equal but for the reference's
narrowing of 64-bit integers.
"""
import os
import sys
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from synapseml_tpu.onnx import import_model as jax_import_model
from synapseml_tpu_torch.onnx import GraphBuilder, import_model
from synapseml_tpu_torch.onnx import importer
from torch_onnx_parity import assert_parity, one_node, run_both, to_torch

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "fixtures"))
import control_flow_graphs as cfg  # noqa: E402
from control_flow_graphs import body as _body  # noqa: E402

F32 = np.float32


def _branch(name, mult):
    """Branch: x (captured from the outer scope) * mult."""
    return _body(name, [], [("Mul", ["x", f"{name}_c"], [f"{name}_out"],
                             {})],
                 [f"{name}_out"],
                 inits={f"{name}_c": F32(mult) * np.ones(1, F32)})


def _if_graph():
    g = GraphBuilder(opset=17)
    g.add_input("x", F32, ["N"])
    g.add_input("cond", np.bool_, [])
    y = g.add_node("If", ["cond"], then_branch=_branch("thenb", 2.0),
                   else_branch=_branch("elseb", 10.0))
    g.add_output(y, F32, ["N"])
    return g.to_bytes()


@pytest.mark.parametrize("host", [True, False], ids=["host", "device"])
@pytest.mark.parametrize("cond", [True, False])
def test_if_subgraphs_capture_outer_scope(host, cond):
    """A host condition runs one branch; a device one runs both and
    selects (``torch.where``, no read on the host)."""
    xv = np.array([1.0, 3.0], F32)
    port, ref = run_both(_if_graph(), [xv, np.bool_(cond)], host=host)
    assert_parity(port, ref)
    np.testing.assert_array_equal(port[0].numpy(),
                                  xv * (2.0 if cond else 10.0))


def _acc_body(name="body"):
    """Loop body: acc_out = acc + x (x captured); cond passed through; the
    sum is also a scan output."""
    return _body(name, ["iter", "cond_in", "acc"],
                 [("Identity", ["cond_in"], ["cond_out"], {}),
                  ("Add", ["acc", "x"], ["acc_out"], {})],
                 ["cond_out", "acc_out", "acc_out"])


def _static_loop_graph(trips):
    g = GraphBuilder(opset=17)
    g.add_input("x", F32, [2])
    g.add_initializer("M", np.int64(trips))
    g.add_initializer("acc0", np.zeros(2, F32))
    g.add_initializer("cond0", np.array(True))
    g.add_node("Loop", ["M", "cond0", "acc0"],
               outputs=["final", "scanned"], body=_acc_body())
    g.add_output("final", F32, [2])
    g.add_output("scanned", F32, [trips, 2])
    return g.to_bytes()


@pytest.mark.parametrize("host", [True, False], ids=["host", "device"])
@pytest.mark.parametrize("trips", [3, 0])
def test_loop_static_trip_count_with_scan_outputs(trips, host):
    """The exported for-range pattern: a host loop; a zero-trip loop
    probes the body for its empty scan output's shape."""
    xv = np.array([1.0, 2.0], F32)
    port, ref = run_both(_static_loop_graph(trips), [xv], host=host)
    assert_parity(port, ref)
    assert tuple(port[1].shape) == (trips, 2)
    if trips:
        np.testing.assert_array_equal(port[1].numpy(),
                                      [[1, 2], [2, 4], [3, 6]])


def _while_body(with_scan=False):
    """acc_out = acc + acc; cond_out = sum(acc_out) < limit (limit
    captured from the outer scope): the scripted-while pattern."""
    return _body("wbody", ["iter", "cond_in", "acc"],
                 [("Add", ["acc", "acc"], ["acc_out"], {}),
                  ("ReduceSum", ["acc_out"], ["s"], {"keepdims": 0}),
                  ("Less", ["s", "limit"], ["cond_out"], {})],
                 ["cond_out", "acc_out"] + (["acc_out"] if with_scan
                                            else []))


def _while_graph(trip=None, trip_input=False, cond_input=False,
                 with_scan=False):
    g = GraphBuilder(opset=17)
    g.add_input("acc0", F32, [2])
    g.add_input("limit", F32, [])
    if trip_input:
        g.add_input("M", np.int64, [])
    else:
        g.add_initializer("M", np.int64(trip))
    if cond_input:
        g.add_input("c0", np.bool_, [])
    else:
        g.add_initializer("c0", np.array(True))
    outs = ["final"] + (["scanned"] if with_scan else [])
    g.add_node("Loop", ["M", "c0", "acc0"], outputs=outs,
               body=_while_body(with_scan))
    g.add_output("final", F32, [2])
    if with_scan:
        g.add_output("scanned", F32, ["T", 2])
    return g.to_bytes()


@pytest.mark.parametrize("host", [True, False], ids=["host", "device"])
@pytest.mark.parametrize("limit,want", [(16.0, 8.0), (100.0, 64.0)])
def test_loop_device_condition_runs_as_a_while_loop(limit, want, host):
    """Doubling [1, 1] until the sum reaches the limit: the body decides
    on the device, so the loop restarts as a while loop."""
    port, ref = run_both(_while_graph(trip=100),
                         [np.ones(2, F32), F32(limit)], host=host)
    assert_parity(port, ref)
    np.testing.assert_array_equal(port[0].numpy(), [want, want])


@pytest.mark.parametrize("limit,trips,want", [(1e6, 2, 4.0),
                                              (16.0, 50, 8.0)])
def test_loop_device_trip_count(limit, trips, want):
    """A device trip count bounds the while loop; the smaller of it and
    the condition wins."""
    port, ref = run_both(_while_graph(trip_input=True),
                         [np.ones(2, F32), F32(limit), np.int64(trips)])
    assert_parity(port, ref)
    np.testing.assert_array_equal(port[0].numpy(), [want, want])


def test_loop_int64_max_trip_count_means_unbounded():
    """torch exports ``while cond:`` as M = INT64_MAX: unbounded."""
    port, ref = run_both(_while_graph(trip=2**63 - 1),
                         [np.ones(2, F32), F32(16.0)], host=True)
    assert_parity(port, ref)
    np.testing.assert_array_equal(port[0].numpy(), [8.0, 8.0])


@pytest.mark.parametrize("m", [2**63 - 1, -1])
def test_loop_device_int64_max_or_negative_trip_count_means_unbounded(m):
    """On the device INT64_MAX stays INT64_MAX in the port (the
    reference, under jit, sees int32 -1): both run unbounded, and so does
    a negative count."""
    blob = _while_graph(trip_input=True)
    g = jax_import_model(blob)
    ref = jax.jit(lambda a, lim, t: g.apply(g.params, a, lim, t)[0])(
        np.ones(2, F32), F32(16.0), np.int64(m))
    port = import_model(blob).bind(device="cpu")(
        torch.ones(2), torch.tensor(16.0), torch.tensor(m))
    assert_parity(port, (ref,))
    np.testing.assert_array_equal(port[0].numpy(), [8.0, 8.0])


def test_loop_device_condition_with_scan_outputs_is_refused():
    """Scan outputs under a data-dependent trip count would have a
    data-dependent shape: both packages raise."""
    blob = _while_graph(trip=100, cond_input=True, with_scan=True)
    feeds = [np.ones(2, F32), F32(16.0), np.bool_(True)]
    g = jax_import_model(blob)
    with pytest.raises(NotImplementedError, match="data-dependent"):
        jax.jit(lambda *a: g.apply(g.params, *a))(*feeds)
    with pytest.raises(NotImplementedError, match="data-dependent"):
        import_model(blob).bind(device="cpu")(*[to_torch(f) for f in feeds])


def test_loop_carries_keep_their_initial_dtype():
    """A while loop casts each carry back to its initial dtype, as the
    reference's ``lax.while_loop`` does: an int32 counter stays int32
    though the body adds a float."""
    body = _body("cast_body", ["iter", "cond_in", "k"],
                 [("Add", ["k", "half"], ["k_out"], {}),
                  ("Less", ["k_out", "limit"], ["cond_out"], {})],
                 ["cond_out", "k_out"], inits={"half": F32(0.5)})
    g = GraphBuilder(opset=17)
    g.add_input("k0", np.int32, [])
    g.add_input("limit", F32, [])
    g.add_initializer("M", np.int64(10))
    g.add_initializer("c0", np.array(True))
    g.add_node("Loop", ["M", "c0", "k0"], outputs=["k"], body=body)
    g.add_output("k", np.int32, [])
    port, ref = run_both(g.to_bytes(), [np.int32(1), F32(5.0)])
    assert_parity(port, ref)
    assert port[0].dtype == torch.int32


def test_if_subgraph_unsupported_op_fails_at_import():
    """An op outside the registry inside a branch is refused at import,
    not on the first request."""
    bad = _body("bad", [], [("TotallyUnknownOp", ["x"], ["y"], {})], ["y"])
    g = GraphBuilder(opset=17)
    g.add_input("x", F32, ["N"])
    g.add_initializer("c", np.array(True))
    g.add_node("If", ["c"], outputs=["out"], then_branch=bad,
               else_branch=bad)
    g.add_output("out", F32, ["N"])
    for imp in (jax_import_model, import_model):
        with pytest.raises(NotImplementedError, match="TotallyUnknownOp"):
            imp(g.to_bytes())


def test_truncated_keeps_subgraph_captured_params():
    """Cutting the Relu keeps the If and the param W its branches
    capture."""
    def branch(mult_name):
        return _body(f"br_{mult_name}", [],
                     [("Mul", ["x", mult_name], [f"{mult_name}_o"], {})],
                     [f"{mult_name}_o"])

    g = GraphBuilder(opset=17)
    g.add_input("x", F32, ["N"])
    g.add_initializer("W", np.array([2.0], F32))
    g.add_input("cond", np.bool_, [])
    y = g.add_node("If", ["cond"], then_branch=branch("W"),
                   else_branch=branch("W"))
    g.add_output(g.add_node("Relu", [y]), F32, ["N"])
    t = import_model(g.to_bytes()).truncated(1)
    assert "W" in t.params
    tr = jax_import_model(g.to_bytes()).truncated(1)
    x = np.array([-3.0, 3.0], F32)
    port = t.bind(device="cpu")(torch.from_numpy(x), torch.tensor(True))
    assert_parity(port, tr.apply(tr.params, x, np.bool_(True)))
    np.testing.assert_array_equal(port[0].numpy(), [-6.0, 6.0])


def _scan_cumsum_graph(length, width, reverse, axes=False):
    """Scan as a running sum (the pre-Loop RNN export pattern). With
    ``axes`` the sequence runs along axis 1 in and out, and the scan
    output is reversed."""
    body = _body("scan_body", ["s_in", "x_t"],
                 [("Add", ["s_in", "x_t"], ["s_out"], {})],
                 ["s_out", "s_out"])
    g = GraphBuilder(opset=17)
    shape = [width, length] if axes else [length, width]
    g.add_input("seq", F32, shape)
    g.add_initializer("s0", np.zeros(width, F32))
    extra = (dict(scan_input_axes=[1], scan_output_axes=[1],
                  scan_output_directions=[1]) if axes else {})
    g.add_node("Scan", ["s0", "seq"], outputs=["sfinal", "cums"],
               body=body, num_scan_inputs=1,
               scan_input_directions=[reverse], **extra)
    g.add_output("sfinal", F32, [width])
    g.add_output("cums", F32, shape)
    return g.to_bytes(), shape


@pytest.mark.parametrize("host", [True, False], ids=["host", "device"])
@pytest.mark.parametrize("length,width,reverse,axes", [
    (4, 2, 0, False), (4, 2, 1, False),
    (64, 3, 0, False), (64, 3, 1, False),   # the reference's lax.scan
    (5, 3, 0, True), (20, 3, 1, True),
], ids=["4_forward", "4_reverse", "64_forward", "64_reverse",
        "axis1_reversed_out", "20_axis1_reverse_both"])
def test_scan_running_sum(length, width, reverse, axes, host):
    blob, shape = _scan_cumsum_graph(length, width, reverse, axes)
    seq = np.random.default_rng(length).normal(size=shape).astype(F32)
    port, ref = run_both(blob, [seq], host=host)
    assert_parity(port, ref)
    src = seq.T if axes else seq
    want = np.cumsum(src[::-1] if reverse else src, 0)
    if axes:
        want = want[::-1].T
    np.testing.assert_allclose(port[1].numpy(), want, rtol=1e-5, atol=1e-5)


def test_scan_before_opset_9_is_refused():
    blob, _ = _scan_cumsum_graph(4, 2, 0)
    old = blob.replace(b"\x10\x11", b"\x10\x08")   # opset_import version
    assert old != blob
    for imp in (jax_import_model, import_model):
        g = imp(old)
        assert g.opset == 8
        with pytest.raises(NotImplementedError, match="opset-8"):
            if imp is import_model:
                g.bind(device="cpu")(torch.zeros(4, 2))
            else:
                g.apply(g.params, np.zeros((4, 2), F32))


def _captured_only_graph(kind):
    """``t = Neg(x)`` is read by no outer node: only a body captures it.
    Without the ``_last_uses`` repair the run drops ``t`` after ``Neg``."""
    g = GraphBuilder(opset=17)
    g.add_input("x", F32, [3])
    g.add_node("Neg", ["x"], outputs=["t"])
    if kind == "If":
        br = _body("br", [], [("Mul", ["t", "k"], ["o"], {})], ["o"],
                   inits={"k": np.full(3, 2.0, F32)})
        g.add_input("cond", np.bool_, [])
        g.add_node("If", ["cond"], outputs=["y"], then_branch=br,
                   else_branch=br)
    else:
        body = _body("sb", ["s", "x_t"],
                     [("Add", ["s", "x_t"], ["s1"], {}),
                      ("Add", ["s1", "t"], ["s2"], {})], ["s2", "s2"])
        g.add_input("seq", F32, [4, 3])
        g.add_initializer("s0", np.zeros(3, F32))
        g.add_node("Scan", ["s0", "seq"], outputs=["y", "ys"], body=body,
                   num_scan_inputs=1)
    g.add_output("y", F32, [3])
    return g.to_bytes()


@pytest.mark.parametrize("kind", ["If", "Scan"])
def test_outer_value_read_only_by_a_body_outlives_its_producer(kind):
    blob = _captured_only_graph(kind)
    x = np.array([1.0, -2.0, 3.0], F32)
    second = (np.bool_(True) if kind == "If"
              else np.arange(12, dtype=F32).reshape(4, 3))
    port, ref = run_both(blob, [x, second])
    assert_parity(port, ref)
    lowered = import_model(blob)._nodes
    drops = importer._last_uses(lowered, ["y"])
    assert "t" in drops[1] and "t" not in drops[0]


def _bound_step_envs(monkeypatch):
    """Record each body run's environment (a body run is every
    ``_run_nodes`` call but the outer one, which holds the graph input)."""
    envs = []
    run = importer._run_nodes

    def spy(lowered, env, drops):
        if "x" not in env and "seq" not in env:
            envs.append(dict(env))
        return run(lowered, env, drops)

    monkeypatch.setattr(importer, "_run_nodes", spy)
    return envs


def test_bound_body_initializers_are_device_tensors(monkeypatch):
    """``bind`` puts a body's float initializers on its device once
    (uncast, as the reference never casts them), keeps shape-slot ones
    host numpy, and leaves the imported graph's body untouched: no numpy
    float reaches a step."""
    body = _body("sb", ["s", "x_t"],
                 [("MatMul", ["s", "R"], ["r"], {}),
                  ("Add", ["r", "x_t"], ["a"], {}),
                  ("Reshape", ["a", "shape"], ["h"], {}),
                  ("Tanh", ["h"], ["s2"], {})], ["s2", "s2"],
                 inits={"R": np.eye(3, dtype=F32) * 0.5,
                        "shape": np.array([-1, 3], np.int64)})
    g = GraphBuilder(opset=17)
    g.add_input("seq", F32, [5, 2, 3])
    g.add_initializer("s0", np.zeros((2, 3), F32))
    g.add_node("Scan", ["s0", "seq"], outputs=["y", "ys"], body=body,
               num_scan_inputs=1)
    g.add_output("ys", F32, [5, 2, 3])
    blob = g.to_bytes()
    seq = np.random.default_rng(3).normal(size=(5, 2, 3)).astype(F32)
    graph = import_model(blob)
    envs = _bound_step_envs(monkeypatch)
    out32 = graph.bind(device="cpu")(torch.from_numpy(seq))
    assert len(envs) == 5
    for env in envs:
        floats = [k for k, v in env.items()
                  if isinstance(v, np.ndarray) and v.dtype.kind == "f"]
        assert floats == []
        assert isinstance(env["R"], torch.Tensor)
        assert env["R"].dtype == torch.float32
        assert isinstance(env["shape"], np.ndarray)
    sub = graph._nodes[0][1].attrs["__lowered_body__"]
    assert isinstance(sub.inits["R"], np.ndarray)
    envs.clear()
    out16 = graph.bind(cast_dtype=torch.bfloat16, device="cpu")(
        torch.from_numpy(seq).to(torch.bfloat16))
    assert all(env["R"].dtype == torch.float32 for env in envs)
    ref = jax_import_model(blob)
    assert_parity(out32, ref.bind()(jnp.asarray(seq)))
    assert_parity(out16, ref.bind(jnp.bfloat16)(
        jnp.asarray(seq, jnp.bfloat16)), rtol=2e-2, atol=2e-2)


def test_two_binds_on_two_threads_keep_their_own_bodies():
    """A float32 and a bf16 forward bound from one graph, run on two
    threads at once, give what each gives alone."""
    blob, shape = _scan_cumsum_graph(24, 3, 1)
    seq = np.random.default_rng(1).normal(size=shape).astype(F32)
    graph = import_model(blob)
    fns = {"f32": (graph.bind(device="cpu"), torch.from_numpy(seq)),
           "bf16": (graph.bind(cast_dtype=torch.bfloat16, device="cpu"),
                    torch.from_numpy(seq).to(torch.bfloat16))}
    alone = {k: fn(x) for k, (fn, x) in fns.items()}
    got = {k: [] for k in fns}

    def work(k):
        fn, x = fns[k]
        for _ in range(20):
            got[k].append(fn(x))

    threads = [threading.Thread(target=work, args=(k,)) for k in fns]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    for k, outs in got.items():
        for out in outs:
            for a, b in zip(out, alone[k]):
                assert a.dtype == b.dtype and torch.equal(a, b)


# -- the activation family ---------------------------------------------

RNG = np.random.default_rng(7)
X = (RNG.normal(size=(2, 3, 4)) * 3).astype(F32)

ACTIVATIONS = [
    ("LeakyRelu", {}), ("LeakyRelu", {"alpha": 0.2}), ("Elu", {}),
    ("Elu", {"alpha": 0.7}), ("Selu", {}),
    ("Selu", {"alpha": 1.5, "gamma": 1.2}), ("HardSigmoid", {}),
    ("HardSigmoid", {"alpha": 0.3, "beta": 0.4}), ("HardSwish", {}),
    ("Mish", {}), ("Celu", {}), ("Celu", {"alpha": 2.0}),
    ("Affine", {"alpha": 1.5, "beta": -0.25}), ("ThresholdedRelu", {}),
    ("ThresholdedRelu", {"alpha": 0.5}), ("Shrink", {}),
    ("Shrink", {"lambd": 1.0, "bias": 0.3}),
]


@pytest.mark.parametrize("host", [True, False], ids=["host", "device"])
@pytest.mark.parametrize("op_type,attrs", ACTIVATIONS,
                         ids=[f"{o}_{i}" for i, (o, _) in
                              enumerate(ACTIVATIONS)])
def test_activation(op_type, attrs, host):
    port, ref = run_both(one_node(op_type, {"x": X}, **attrs), [X],
                         host=host)
    assert_parity(port, ref, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("slope_shape", [(3,), (3, 1), (1,), (2, 3, 4)])
def test_prelu_slope_broadcasts_from_the_channel_axis(slope_shape):
    slope = RNG.uniform(0.05, 0.5, size=slope_shape).astype(F32)
    port, ref = run_both(one_node("PRelu", {"x": X},
                                  inits={"slope": slope}), [X])
    assert_parity(port, ref, rtol=1e-5, atol=1e-5)


def test_activation_in_bf16():
    """bf16 binds: within rtol=atol=2e-2 of the reference's bf16."""
    for op_type, attrs in ACTIVATIONS:
        port, ref = run_both(one_node(op_type, {"x": X}, **attrs),
                             [X.astype(jnp.bfloat16)], cast="bfloat16")
        assert_parity(port, ref, rtol=2e-2, atol=2e-2)


@pytest.mark.parametrize("host", [True, False], ids=["host", "device"])
@pytest.mark.parametrize("dtype", [np.uint8, np.uint32, np.int32])
@pytest.mark.parametrize("direction", ["LEFT", "RIGHT"])
def test_bit_shift(direction, dtype, host):
    x = RNG.integers(0, 200, size=(3, 5)).astype(dtype)
    y = RNG.integers(0, 7, size=(3, 5)).astype(dtype)
    port, ref = run_both(one_node("BitShift", {"x": x, "y": y},
                                  direction=direction), [x, y], host=host)
    assert_parity(port, ref)


def test_bit_shift_uint64_on_the_device_is_logical():
    """The reference narrows uint64 to uint32 on the device; the port
    keeps 64 bits and shifts them logically."""
    x = np.array([2**63 + 5, 2**40, 3], np.uint64)
    y = np.array([1, 3, 0], np.uint64)
    for direction, want in (("RIGHT", x >> y), ("LEFT", x << y)):
        out = import_model(one_node("BitShift", {"x": x, "y": y},
                                    direction=direction)).bind(
            device="cpu")(torch.from_numpy(x), torch.from_numpy(y))[0]
        assert out.dtype == torch.uint64
        np.testing.assert_array_equal(out.numpy(), want)


# -- the graphs chip_smoke.py serves through ONNXModel --------------------

@pytest.mark.parametrize("n", [8, 20])
@pytest.mark.parametrize("name", ["if_on_device", "loop_on_host",
                                  "loop_on_device_below"])
def test_served_control_flow_graph(name, n):
    """``tests/fixtures/control_flow_graphs.py``'s graphs against JAX and
    their numpy forwards; below 16 rows the nested device Loop runs."""
    x = cfg.rows(n, seed=n)
    port, ref = run_both(getattr(cfg, name)(), [x])
    assert_parity(port, ref)
    want = getattr(cfg, name.replace("_below", "") + "_reference")(x)
    for p, w in zip(port, want if isinstance(want, tuple) else (want,)):
        np.testing.assert_allclose(p.numpy(), w, rtol=1e-6, atol=1e-6)

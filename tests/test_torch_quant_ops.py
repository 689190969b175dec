"""The port's 12 integer and QOperator ops, its int8 lane and its
quantized ResNet against the JAX package's importer, on the CPU.

The one-node cases are ``tests/fixtures/quant_op_cases.py``'s (the card
runs the same ones in ``chip_smoke.py`` and ``test_torch_cuda.py``): the
same graph bytes and seeded inputs through both importers, the port bound
on the CPU, the reference through its eager bound forward. Tolerance:
bitwise on every output, integer accumulators, requantized values and
``DynamicQuantizeLinear``'s float scale alike. The reference's forward
under ``jax.jit`` is not the oracle: XLA moves ``QLinearAdd``,
``QLinearGlobalAveragePool`` and ``DynamicQuantizeLinear`` by one step
of their output (ROADMAP Queue 3), which
:func:`test_jit_reference_moves_three_ops_by_one_step` holds at exactly
that.

The int8 lane (``onnx/quant_route.py``) routes only on the card; here it
is forced (``_routes_here`` true, the probe's verdict ``"int8"``) and
every case whose contraction it takes must still be bitwise the
reference. Each int8 core is held bitwise to its widened core over the
uint8 shift, absent, scalar (host or tensor), per-row and per-column zero
points, stride, padding, dilation, groups and rank. Then the reference's
own quantization tests, ported, and a quantized ``zoo.tiny_resnet``
(``tests/fixtures/qresnet50.py``) end to end.
"""
import hashlib
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from synapseml_tpu.onnx import GraphBuilder as JaxBuilder
from synapseml_tpu.onnx import import_model as jax_import
from synapseml_tpu_torch.onnx import (GraphBuilder, import_model, importer,
                                      quant_route)
from synapseml_tpu_torch.runtime import telemetry as tm

FIXTURES = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "fixtures")
sys.path.insert(0, FIXTURES)
import qresnet50 as qr  # noqa: E402
import quant_op_cases as cases  # noqa: E402

NAMES = ("MatMulInteger", "DynamicQuantizeLinear", "ConvInteger",
         "QLinearConv", "QLinearMatMul", "QLinearAdd", "QLinearMul",
         "QLinearSigmoid", "QLinearLeakyRelu", "QLinearGlobalAveragePool",
         "QLinearConcat", "QGemm")
INT8 = tm.counter("onnx_int8_route_total", backend="int8")


def _port(case):
    return cases.run(case, import_model, GraphBuilder, "cpu")


def _reference(case, jit=False):
    fn = jax_import(cases.graph(case, JaxBuilder)).bind()
    fn = jax.jit(fn) if jit else fn
    return cases.leaves(fn(*[jnp.asarray(a) for a, _ in cases.feeds(case)]))


@pytest.fixture
def int8_lane(tmp_path, monkeypatch):
    """The int8 lane forced on the CPU: the operands count as on the
    card, and every probe's verdict is ``"int8"``."""
    monkeypatch.setenv("SYNAPSEML_TPU_CACHE_DIR", str(tmp_path))
    monkeypatch.delenv("SYNAPSEML_ONNX_INT8", raising=False)
    monkeypatch.delenv("SYNAPSEML_AUTOTUNE", raising=False)
    monkeypatch.setattr(quant_route, "_routes_here", lambda t: True)
    monkeypatch.setattr(quant_route, "_probe_matmul", lambda *r: "int8")
    monkeypatch.setattr(quant_route, "_probe_conv", lambda *r: "int8")
    quant_route.clear_cache()
    yield
    quant_route.clear_cache()


def test_every_name_is_registered_and_covered():
    assert set(NAMES) <= set(importer._REGISTRY)
    assert {c["op"] for c in cases.CASES} == set(NAMES)
    names = [c["name"] for c in cases.CASES]
    assert len(names) == len(set(names)) and len(names) >= 50
    assert cases.INT8_LANE <= set(names)


def test_both_graph_builders_give_the_same_bytes():
    for case in cases.CASES:
        assert cases.graph(case, GraphBuilder) == \
            cases.graph(case, JaxBuilder), case["name"]


@pytest.mark.parametrize("case", cases.CASES, ids=lambda c: c["name"])
def test_op_matches_the_reference(case):
    got = cases.agree(case, _port(case), _reference(case))
    assert got["ok"], got


@pytest.mark.parametrize("case", cases.CASES, ids=lambda c: c["name"])
def test_int8_lane_serves_the_case_bitwise(case, int8_lane):
    """With the lane forced, the int8 cores serve exactly the cases
    :data:`cases.INT8_LANE` names (the others are ineligible: 3-D, rows
    <= 16, N or a group's output channels not a multiple of 8, a nonzero
    weight zero point, QGemm), and every output stays bitwise."""
    before = INT8.value
    got = cases.agree(case, _port(case), _reference(case))
    assert got["ok"], got
    assert (INT8.value > before) == (case["name"] in cases.INT8_LANE)


def test_jit_reference_moves_three_ops_by_one_step():
    """The reference's forward under ``jax.jit`` is not its eager
    forward: XLA rewrites ``QLinearAdd``'s two dequantizations (a fused
    multiply-add), ``QLinearGlobalAveragePool``'s division by the count
    and ``DynamicQuantizeLinear``'s division by 255, and some outputs move
    by one step of their type. The port is bitwise the eager forward
    (:func:`test_op_matches_the_reference`); against the jitted one it is
    within one step, at the cases where the reference moves."""
    moved = set()
    for case in cases.CASES:
        port, jitted = _port(case), _reference(case, jit=True)
        if cases.agree(case, port, jitted)["ok"]:
            continue
        moved.add(case["op"])
        for (g, _, _), (w, _, _) in zip(port, jitted):
            if g.dtype.kind == "f":
                assert np.all(np.abs(g - w) <= np.spacing(np.abs(w))), \
                    case["name"]
            else:
                assert np.abs(g.astype(int) - w.astype(int)).max() <= 1, \
                    case["name"]
    assert moved == {"QLinearAdd", "QLinearGlobalAveragePool",
                     "DynamicQuantizeLinear"}


# -- the int8 cores against the widened cores ---------------------------

def _t(seed, shape, dtype):
    info = np.iinfo(dtype)
    return torch.from_numpy(np.random.default_rng(seed).integers(
        info.min, info.max + 1, shape).astype(dtype))


_ZPS = {
    "none": lambda seed, n, dt: None,
    "host_scalar": lambda seed, n, dt: np.asarray(
        np.random.default_rng(seed).integers(np.iinfo(dt).min,
                                             np.iinfo(dt).max + 1), dt),
    "tensor_scalar": lambda seed, n, dt: _t(seed, (), dt),
    "vector": lambda seed, n, dt: _t(seed, (n,), dt),
}


@pytest.mark.parametrize("a_dt,b_dt,a_zp,b_zp", [
    (np.uint8, np.int8, "none", "none"),
    (np.uint8, np.int8, "host_scalar", "none"),
    (np.uint8, np.int8, "tensor_scalar", "host_scalar"),
    (np.uint8, np.int8, "vector", "vector"),
    (np.int8, np.int8, "none", "vector"),
    (np.int8, np.uint8, "host_scalar", "tensor_scalar"),
    (np.uint8, np.uint8, "vector", "host_scalar"),
    (np.int8, np.int8, "tensor_scalar", "tensor_scalar"),
])
def test_int8_matmul_core_is_bitwise_the_widened_core(a_dt, b_dt, a_zp,
                                                      b_zp):
    a, b = _t(1, (40, 24), a_dt), _t(2, (24, 16), b_dt)
    za = _ZPS[a_zp](3, 40, a_dt)        # a vector zero point is per row
    zb = _ZPS[b_zp](4, 16, b_dt)        # ... and per column of b
    got = importer._matmul_int8_core(a, b, za, zb)
    want = importer._matmul_wide_core(a, b, za, zb)
    assert got.dtype == want.dtype == torch.int32
    assert torch.equal(got, want)
    a64 = a.to(torch.int64) - (0 if za is None else torch.as_tensor(
        np.asarray(za)).to(torch.int64).reshape(-1, 1))
    b64 = b.to(torch.int64) - (0 if zb is None else torch.as_tensor(
        np.asarray(zb)).to(torch.int64))
    assert torch.equal(want, (a64 @ b64).to(torch.int32))


@pytest.mark.parametrize("x_dt,zp,x_shape,w_shape,attrs", [
    (np.uint8, "host_scalar", (2, 3, 9, 9), (8, 3, 3, 3),
     dict(pads=[1, 1, 1, 1])),
    (np.uint8, "none", (2, 3, 20, 20), (8, 3, 7, 7),
     dict(strides=[2, 2], pads=[3, 3, 3, 3])),
    (np.int8, "tensor_scalar", (1, 4, 12, 12), (16, 2, 3, 3),
     dict(group=2, dilations=[2, 2], pads=[2, 2, 2, 2])),
    (np.int8, "none", (2, 5, 8, 8), (8, 5, 1, 1), dict(strides=[2, 2])),
    (np.uint8, "host_scalar", (1, 3, 8, 9), (8, 3, 2, 3),
     dict(auto_pad="SAME_UPPER")),
    (np.uint8, "tensor_scalar", (2, 3, 9, 7), (8, 3, 3, 3),
     dict(pads=[0, 1, 2, 0])),
    (np.uint8, "host_scalar", (2, 4, 16), (8, 4, 3),
     dict(pads=[1, 1], strides=[2])),
    (np.uint8, "host_scalar", (1, 2, 5, 6, 5), (8, 2, 3, 3, 3),
     dict(pads=[1] * 6)),
], ids=["pads", "stem_stride2_k147", "group_dilation_int8",
        "1x1_stride2", "same_upper_even_kernel", "asymmetric_pads", "1d",
        "3d"])
def test_int8_conv_core_is_bitwise_the_widened_core(x_dt, zp, x_shape,
                                                    w_shape, attrs):
    x, w = _t(5, x_shape, x_dt), _t(6, w_shape, np.int8)
    zx = _ZPS[zp](7, 1, x_dt)
    ctx = quant_route._Attrs(**attrs)
    got = importer._conv_int8_core(ctx, x, w, zx, None)
    want = importer._conv_wide_core(ctx, x, w, zx, None)
    assert got.dtype == want.dtype == torch.int32
    assert got.shape == want.shape and torch.equal(got, want)


@pytest.mark.parametrize("kind", ["matmul", "conv"])
def test_probe_verifies_the_int8_accumulator_exact(kind, tmp_path,
                                                   monkeypatch):
    """The router's own probe, run on the CPU: the int8 candidate
    verifies exact at the clamped shape and, with the clock stubbed to
    favour it, wins; a record of the probe lands in ``PROBES``."""
    monkeypatch.setattr(
        quant_route, "_best_of", lambda fn, a: 0.0 if any(
            n.endswith("_int8_core") for n in fn.__code__.co_names) else 1.0)
    quant_route.clear_cache()
    cpu = torch.device("cpu")
    if kind == "matmul":
        got = quant_route._probe_matmul(cpu, "uint8", "int8",
                                        ("uint8", 0, False),
                                        ("int8", 1, True), 300, 64, 32)
    else:
        attrs = importer._conv_attr_key(quant_route._Attrs(
            strides=[2, 2], pads=[1, 1, 1, 1]), torch.zeros(1, 1, 1, 1),
            torch.zeros(8, 3, 3, 3))
        got = quant_route._probe_conv(cpu, "uint8", ("uint8", 0, False),
                                      (4, 16, 56, 56), (64, 16, 3, 3), attrs)
    rec = quant_route.PROBES[-1]
    assert rec["kind"] == kind and rec["exact"] is True
    assert got == rec["verdict"] == "int8"
    assert rec["int8_s"] == 0.0 and rec["dequant_s"] == 1.0
    quant_route.clear_cache()


def test_routing_on_the_cpu_serves_dequant_and_probes_nothing(
        tmp_path, monkeypatch):
    """Both packages serve the widened lane on the CPU: no probe, no
    verdict file."""
    monkeypatch.setenv("SYNAPSEML_TPU_CACHE_DIR", str(tmp_path))
    quant_route.clear_cache()
    a, b = _t(1, (64, 32), np.uint8), _t(2, (32, 16), np.int8)
    assert quant_route.route_matmul(a, b, np.uint8(3), None) == "dequant"
    x, w = _t(3, (2, 8, 16, 16), np.uint8), _t(4, (16, 8, 3, 3), np.int8)
    key = importer._conv_attr_key(quant_route._Attrs(pads=[1] * 4), x, w)
    assert quant_route.route_conv(x, w, np.uint8(3), np.int8(0),
                                  key) == "dequant"
    assert quant_route._MM_LANE.probes == quant_route._CONV_LANE.probes == 0
    assert not os.listdir(tmp_path)


@pytest.mark.parametrize("rows,k,n,ok", [
    (17, 8, 8, True), (16, 8, 8, False), (8, 2048, 1000, False),
    (128, 2048, 1000, True), (24, 12, 8, False), (24, 16, 5, False),
])
def test_int_mm_eligibility_is_its_refusals_on_the_card(rows, k, n, ok):
    """``torch._int_mm``'s refusals on the card (torch 2.11, CUDA 12.8:
    ``self.size(0) needs to be greater than 16``, ``self.size(1) needs to
    be greater than 0 and a multiple of 8``, ``mat2.size(1) ...``) are the
    lane's eligibility: an ineligible class routes to ``"dequant"`` without
    a probe, so it is never poisoned (ROADMAP Queue 3)."""
    assert quant_route.int_mm_eligible(rows, k, n) is ok


def test_ineligible_shape_routes_dequant_without_probe_or_poison(int8_lane):
    calls = []
    quant_route._probe_matmul = lambda *r: calls.append(r) or "int8"
    head = (_t(1, (8, 2048), np.uint8), _t(2, (2048, 1000), np.int8))
    assert quant_route.route_matmul(*head, np.uint8(3), None) == "dequant"
    assert not calls and not quant_route._MM_LANE.decisions
    big = (_t(1, (128, 2048), np.uint8), head[1])
    assert quant_route.route_matmul(*big, np.uint8(3), None) == "int8"
    assert len(calls) == 1


def test_kill_switch_serves_the_widened_lane(int8_lane, monkeypatch):
    monkeypatch.setenv("SYNAPSEML_ONNX_INT8", "0")
    case = cases.by_name("qlconv_per_channel_scale")
    before = INT8.value
    assert cases.agree(case, _port(case), _reference(case))["ok"]
    assert INT8.value == before and quant_route._CONV_LANE.probes == 0


def test_int8_leg_failure_poisons_its_class_and_serves_dequant(int8_lane,
                                                               monkeypatch):
    """The silent-fallback contract: an int8 leg that raises serves the
    widened lane and persists a demotion of its class."""
    def boom(*a, **k):
        raise RuntimeError("int8 leg failed")

    monkeypatch.setattr(importer, "_conv_int8_core", boom)
    case = cases.by_name("qlconv_per_tensor_bias_pads")
    assert cases.agree(case, _port(case), _reference(case))["ok"]
    assert list(quant_route._CONV_LANE.decisions.values()) == ["dequant"]
    before = INT8.value
    _port(case)                          # the class stays demoted
    assert INT8.value == before
    assert quant_route._CONV_LANE.probes == 1


def test_integer_weights_go_to_the_device_once_a_node():
    """Integer initializers are host values in both importers; the port
    copies each to the run's device once a node (``_const``), so a bound
    forward and a CUDA-graph capture copy nothing."""
    case = cases.by_name("qlconv_per_tensor_bias_pads")
    graph = import_model(cases.graph(case, GraphBuilder))
    fn = graph.bind(device="cpu")
    x = torch.from_numpy(case["inputs"][0][1])
    first = fn(x)[0]

    def consts():
        return {k[1]: v[1] for _, ctx, _, _ in graph._nodes
                for k, v in ctx.attrs.get("__tables__", {}).items()
                if k[0] == "const"}

    made = consts()
    assert {"w", "b"} <= set(made)
    assert made["w"].dtype == torch.int8 and made["b"].dtype == torch.int32
    assert torch.equal(fn(x)[0], first)
    assert all(consts()[k] is v for k, v in made.items())


# -- the reference's own quantization tests, ported ---------------------

def test_quantize_dequantize_roundtrip_and_matmul_integer():
    rng = np.random.default_rng(2)
    x = rng.normal(size=(4, 8)).astype(np.float32)
    g = GraphBuilder(opset=21)
    xn = g.add_input("x", np.float32, ["N", 8])
    scale = g.add_initializer("sc", np.float32(0.05))
    zp = g.add_initializer("zp", np.uint8(128))
    q = g.add_node("QuantizeLinear", [xn, scale, zp])
    d = g.add_node("DequantizeLinear", [q, scale, zp])
    g.add_output(d, np.float32, ["N", 8])
    gi = import_model(g.to_bytes())
    got = gi.bind(device="cpu")(torch.from_numpy(x))[0].numpy()
    tq = torch.quantize_per_tensor(torch.from_numpy(x), 0.05, 128,
                                   torch.quint8).dequantize().numpy()
    np.testing.assert_allclose(got, tq, atol=1e-6)

    # int8 matmul accumulates in int32
    a = rng.integers(0, 255, (3, 4)).astype(np.uint8)
    b = rng.integers(-127, 127, (4, 5)).astype(np.int8)
    g2 = GraphBuilder(opset=21)
    an = g2.add_input("a", np.uint8, ["N", 4])
    bn_ = g2.add_initializer("b", b)
    azp = g2.add_initializer("azp", np.uint8(10))
    y = g2.add_node("MatMulInteger", [an, bn_, azp])
    g2.add_output(y, np.int32, ["N", 5])
    gi2 = import_model(g2.to_bytes())
    want = (a.astype(np.int32) - 10) @ b.astype(np.int32)
    got2 = gi2.bind(device="cpu")(torch.from_numpy(a))[0]
    assert got2.dtype == torch.int32
    np.testing.assert_array_equal(got2.numpy(), want)


def test_dynamic_quantize_linear_spec_formula():
    """DynamicQuantizeLinear follows the ONNX spec exactly: range extended
    to include zero, scale over 255 steps, saturating uint8."""
    rng = np.random.default_rng(0)
    for x in [rng.normal(size=(3, 17)).astype(np.float32) * 4,
              np.abs(rng.normal(size=(5,)).astype(np.float32)),  # min>0
              -np.abs(rng.normal(size=(5,)).astype(np.float32)),  # max<0
              np.zeros((4,), np.float32)]:                        # degenerate
        g = GraphBuilder(opset=21)
        xn = g.add_input("x", np.float32, list(x.shape))
        y, ys, yzp = g.add_node("DynamicQuantizeLinear", [xn],
                                outputs=["y", "ys", "yzp"])
        g.add_output(y, np.uint8, list(x.shape))
        g.add_output(ys, np.float32, [])
        g.add_output(yzp, np.uint8, [])
        gi = import_model(g.to_bytes())
        qy, qs, qzp = [o.numpy() for o in
                       gi.bind(device="cpu")(torch.from_numpy(x))]
        mn, mx = min(x.min(), 0.0), max(x.max(), 0.0)
        scale = (mx - mn) / 255.0 or 1.0
        zp = np.clip(np.rint(-mn / scale), 0, 255)
        np.testing.assert_allclose(qs, scale, rtol=1e-6)
        assert qzp == zp and qzp.dtype == np.uint8
        want = np.clip(np.rint(x / scale) + zp, 0, 255).astype(np.uint8)
        np.testing.assert_array_equal(qy, want)


def _qlinear_conv_graph(x_shape, w, xs, xzp, ws, wzp, ys, yzp, b=None,
                        **conv_attrs):
    g = GraphBuilder(opset=21)
    xn = g.add_input("x", np.uint8, list(x_shape))
    ins = [xn,
           g.add_initializer("xs", np.float32(xs)),
           g.add_initializer("xzp", np.uint8(xzp)),
           g.add_initializer("w", w),
           g.add_initializer("ws", np.asarray(ws, np.float32)),
           g.add_initializer("wzp", np.asarray(wzp, np.int8)),
           g.add_initializer("ys", np.float32(ys)),
           g.add_initializer("yzp", np.uint8(yzp))]
    if b is not None:
        ins.append(g.add_initializer("b", np.asarray(b, np.int32)))
    y = g.add_node("QLinearConv", ins, **conv_attrs)
    g.add_output(y, np.uint8, None)
    return import_model(g.to_bytes())


def test_qlinear_conv_matches_torch_quantized():
    """Foreign ground truth: torch.ao.nn.quantized Conv2d (fbgemm) on the
    same scales/zero-points. Requantization rounding may differ by one
    step on ties, so the gate is <= 1 LSB everywhere and overwhelmingly
    exact (the reference's own gate)."""
    import torch.ao.nn.quantized as nnq
    assert "fbgemm" in torch.backends.quantized.supported_engines
    prev_engine = torch.backends.quantized.engine
    torch.backends.quantized.engine = "fbgemm"
    try:
        _check_qlinear_conv_against_torch(nnq)
    finally:
        torch.backends.quantized.engine = prev_engine


def _check_qlinear_conv_against_torch(nnq):
    rng = np.random.default_rng(1)
    cin, cout, k = 3, 8, 3
    xs, xzp, ys, yzp = 0.05, 128, 0.12, 100
    xq = rng.integers(0, 255, (2, cin, 10, 10)).astype(np.uint8)
    x_f = (xq.astype(np.float32) - xzp) * xs

    for per_channel in (False, True):
        wq = rng.integers(-100, 100, (cout, cin, k, k)).astype(np.int8)
        if per_channel:
            ws = (rng.random(cout) * 0.03 + 0.01).astype(np.float32)
            w_f = wq.astype(np.float32) * ws[:, None, None, None]
            qw = torch.quantize_per_channel(
                torch.from_numpy(w_f), torch.from_numpy(ws),
                torch.zeros(cout, dtype=torch.long), 0, torch.qint8)
            wzp = np.zeros(cout, np.int8)
        else:
            ws = np.float32(0.02)
            w_f = wq.astype(np.float32) * float(ws)
            qw = torch.quantize_per_tensor(torch.from_numpy(w_f),
                                           float(ws), 0, torch.qint8)
            wzp = np.int8(0)
        b_f = rng.normal(size=cout).astype(np.float32)
        # ONNX bias: int32 at scale xs*ws
        b_i32 = np.rint(b_f / (xs * np.asarray(ws))).astype(np.int32)
        b_used = b_i32.astype(np.float32) * (xs * np.asarray(ws))

        conv = nnq.Conv2d(cin, cout, k, stride=1, padding=1)
        conv.set_weight_bias(qw, torch.from_numpy(b_used))
        conv.scale, conv.zero_point = ys, yzp
        qx = torch.quantize_per_tensor(torch.from_numpy(x_f), xs, xzp,
                                       torch.quint8)
        want = conv(qx).int_repr().numpy()

        gi = _qlinear_conv_graph(xq.shape, wq, xs, xzp, ws, wzp, ys, yzp,
                                 b=b_i32, strides=[1, 1],
                                 pads=[1, 1, 1, 1])
        got = gi.bind(device="cpu")(torch.from_numpy(xq))[0].numpy()
        assert got.dtype == np.uint8
        diff = np.abs(got.astype(np.int32) - want.astype(np.int32))
        assert diff.max() <= 1, (per_channel, diff.max())
        assert (diff == 0).mean() > 0.98, (per_channel, (diff == 0).mean())


def test_qlinear_matmul_and_conv_integer_exact_int_semantics():
    """QLinearMatMul against exact integer arithmetic + spec
    requantization; ConvInteger against a float64 conv over the
    zero-point-shifted operands (exact for int8 ranges)."""
    rng = np.random.default_rng(2)
    a = rng.integers(0, 255, (4, 6)).astype(np.uint8)
    b = rng.integers(-127, 127, (6, 5)).astype(np.int8)
    a_s, a_zp, b_s, b_zp, y_s, y_zp = 0.03, 120, 0.05, 3, 0.2, 64
    g = GraphBuilder(opset=21)
    an = g.add_input("a", np.uint8, [4, 6])
    ins = [an, g.add_initializer("as_", np.float32(a_s)),
           g.add_initializer("azp", np.uint8(a_zp)),
           g.add_initializer("b", b),
           g.add_initializer("bs", np.float32(b_s)),
           g.add_initializer("bzp", np.int8(b_zp)),
           g.add_initializer("ys", np.float32(y_s)),
           g.add_initializer("yzp", np.uint8(y_zp))]
    y = g.add_node("QLinearMatMul", ins)
    g.add_output(y, np.uint8, [4, 5])
    gi = import_model(g.to_bytes())
    got = gi.bind(device="cpu")(torch.from_numpy(a))[0].numpy()
    acc = (a.astype(np.int64) - a_zp) @ (b.astype(np.int64) - b_zp)
    want = np.clip(
        np.rint(acc.astype(np.float32) * np.float32(a_s * b_s / y_s))
        + y_zp, 0, 255).astype(np.uint8)
    np.testing.assert_array_equal(got, want)

    # ConvInteger: raw int32 accumulator
    x = rng.integers(0, 255, (1, 2, 7, 7)).astype(np.uint8)
    w = rng.integers(-127, 127, (4, 2, 3, 3)).astype(np.int8)
    g2 = GraphBuilder(opset=21)
    xn = g2.add_input("x", np.uint8, [1, 2, 7, 7])
    ins2 = [xn, g2.add_initializer("w", w),
            g2.add_initializer("xzp", np.uint8(99))]
    y2 = g2.add_node("ConvInteger", ins2, pads=[1, 1, 1, 1])
    g2.add_output(y2, np.int32, None)
    gi2 = import_model(g2.to_bytes())
    got2 = gi2.bind(device="cpu")(torch.from_numpy(x))[0].numpy()
    want2 = torch.nn.functional.conv2d(
        torch.from_numpy(x.astype(np.float64) - 99.0),
        torch.from_numpy(w.astype(np.float64)), padding=1).numpy()
    np.testing.assert_array_equal(got2, want2.astype(np.int32))


# -- the quantized ResNet end to end ------------------------------------

@pytest.fixture(scope="module")
def tiny_qresnet():
    blob = qr.graph(GraphBuilder, qr.TINY, accumulator=True)
    x = qr.images(6, qr.TINY, seed=5)
    return blob, x


def test_qresnet_builders_agree_and_start_from_the_zoo(tiny_qresnet):
    """Both packages' builders give the same bytes, and the float weights
    it quantizes are ``zoo.tiny_resnet``'s (BatchNorm folded), drawn in
    the zoo's order."""
    from synapseml_tpu_torch.onnx import proto, zoo

    blob, _ = tiny_qresnet
    assert blob == qr.graph(JaxBuilder, qr.TINY, accumulator=True)
    model = proto.load_model(zoo.tiny_resnet())
    inits = [(t.name, proto.tensor_to_numpy(t))
             for t in model.graph.initializer]

    def named(prefix):
        return [v for k, v in inits if k.startswith(prefix)]

    layers = qr.float_layers(qr.TINY)
    convs = [layers["stem"]] + [c for blk in layers["blocks"] for c in blk
                                if c is not None]
    ws = named("conv_w")
    stats = [named(f"bn_{s}") for s in ("scale", "bias", "mean", "var")]
    assert len(ws) == len(convs) == len(stats[0])
    for i, c in enumerate(convs):
        s, b, m, v = (st[i].astype(np.float64) for st in stats)
        f = s / np.sqrt(v + qr.BN_EPS)
        assert np.array_equal(
            c["w"], (ws[i] * f[:, None, None, None]).astype(np.float32))
        assert np.array_equal(c["b"], (b - m * f).astype(np.float32))
    assert np.array_equal(named("fc_w")[0], layers["fc"][0])
    assert np.array_equal(named("fc_b")[0], layers["fc"][1])


@pytest.mark.parametrize("lane", ["dequant", "int8"])
def test_tiny_qresnet_is_bitwise_the_reference(tiny_qresnet, lane,
                                               tmp_path, monkeypatch):
    """``zoo.tiny_resnet`` quantized (``tests/fixtures/qresnet50.py``):
    the uint8 logits, the float logits and the stem's int32 accumulator
    bitwise the JAX importer's eager forward, through the widened lane
    and with the int8 lane forced."""
    blob, x = tiny_qresnet
    quant_route.clear_cache()
    if lane == "int8":
        monkeypatch.setenv("SYNAPSEML_TPU_CACHE_DIR", str(tmp_path))
        monkeypatch.setattr(quant_route, "_routes_here", lambda t: True)
        monkeypatch.setattr(quant_route, "_probe_conv", lambda *r: "int8")
    before = INT8.value
    got = [o.numpy() for o in
           import_model(blob).bind(device="cpu")(torch.from_numpy(x))]
    want = [np.asarray(o) for o in jax_import(blob).bind()(jnp.asarray(x))]
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and np.array_equal(g, w)
    # 9 QLinearConv + the stem's ConvInteger, each > 16 rows, 8k channels
    assert INT8.value - before == (10 if lane == "int8" else 0)
    quant_route.clear_cache()


def test_full_qresnet50_graph_is_the_fixtures():
    """The FULL graph rebuilt from the stored calibration is the graph the
    JAX fixture ran (its sha256), and the fixture holds the eager and the
    jitted reference within one step."""
    blob = qr.graph(GraphBuilder, qr.FULL, accumulator=True,
                    calibrated=qr.stored_ranges())
    with np.load(qr.OUT) as z:
        assert hashlib.sha256(blob).hexdigest() == str(z["graph_sha256"])
        gap = np.abs(z["logits_q"].astype(int) - z["logits_q_jit"])
        assert z["logits_q"].shape == (2, 1000) and gap.max() <= 1
        assert z["stem_acc_channel_sums"].shape == (2, 64)


def test_dynamically_quantized_ffn_block_is_the_reference():
    """BERT's FFN block in ``quantize_dynamic``'s layout
    (``tests/fixtures/bert_ffn_int8.py``) at a small width, every stage
    exposed: the two ``DynamicQuantizeLinear``s and the two int32
    accumulators bitwise the JAX importer's eager forward, the GELU and
    the block's output (erf, LayerNorm) within 1e-6 of their largest
    |value|."""
    import bert_ffn_int8 as ffn

    blob = ffn.graph(GraphBuilder, ffn.SMALL, stages=True)
    assert blob == ffn.graph(JaxBuilder, ffn.SMALL, stages=True)
    h, r = ffn.inputs(ffn.SMALL)
    names = ("out",) + ffn.STAGES
    got = dict(zip(names, (o.numpy() for o in import_model(blob).bind(
        device="cpu")(torch.from_numpy(h), torch.from_numpy(r)))))
    want = dict(zip(names, (np.asarray(o) for o in jax_import(blob).bind()(
        jnp.asarray(h), jnp.asarray(r)))))
    for name in ("hq", "hs", "hz", "acc1", "gq", "gs", "gz", "acc2"):
        assert got[name].dtype == want[name].dtype, name
        assert np.array_equal(got[name], want[name]), name
    for name in ("g", "out"):
        span = float(np.abs(want[name]).max())
        assert float(np.abs(got[name] - want[name]).max()) <= 1e-6 * span

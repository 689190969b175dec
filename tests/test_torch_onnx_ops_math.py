"""The port's elementwise, comparison, logical, bitwise, reduction and
tensor-algebra ONNX ops (``Pow`` ... ``Round``, ``Bitwise*``, ``Clip``,
``Min``/``Max``/``Sum``/``Mean``, ``Trilu``, ``Einsum``, ``Expand``,
``CumSum``, the ``Reduce*`` family, ``ArgMax``/``ArgMin``) against the JAX
package's importer: one-node graphs built with ``GraphBuilder``, the same
bytes and the same seeded numpy inputs through both, on the CPU.

Each case feeds device arrays (torch tensors, jax arrays) or, where the
reference keeps the op on the host for numpy inputs, numpy too (``host``):
the port returns a numpy value exactly where the reference does.

Tolerance: float32 outputs within rtol=atol=1e-5 of the reference's (this
covers ``Erf``, ``Einsum`` and the transcendental ops, whose XLA CPU
results may differ from PyTorch's in the last bits; ``Det``, an LU
factorisation in both, within rtol=atol=1e-4, the reference's own test's
bound); integer and boolean outputs equal; output dtypes equal (a 64-bit
integer may stay 64-bit where the reference narrows it).
"""
import numpy as np
import pytest

from torch_onnx_parity import assert_parity, one_node, run_both

F32, I32, I64 = np.float32, np.int32, np.int64


def _x(seed, *shape, dtype=F32, lo=None, hi=None):
    rng = np.random.default_rng(seed)
    if lo is not None:
        return rng.uniform(lo, hi, shape).astype(dtype)
    if np.issubdtype(np.dtype(dtype), np.integer):
        return rng.integers(-20, 20, shape).astype(dtype)
    if dtype == np.bool_:
        return rng.random(shape) < 0.5
    return rng.standard_normal(shape).astype(dtype)


def _host(v) -> bool:
    return isinstance(v, (np.ndarray, np.generic))


def _check(blob, feeds, host=False, **tol):
    port, ref = run_both(blob, feeds, host=host)
    assert_parity(port, ref, **tol)
    for p, r in zip(port, ref):
        assert _host(p) == _host(r)
    return port


# -- binary elementwise: device tensors ------------------------------------

def _pair(op, a, b, **attrs):
    return lambda: (one_node(op, {"a": a, "b": b}, **attrs), [a, b])


BINARY = [
    ("pow_float", _pair("Pow", _x(0, 3, 4, lo=0.1, hi=3.0),
                        _x(1, 3, 4, lo=-2.0, hi=2.0))),
    ("pow_broadcast_exponent", _pair("Pow", _x(2, 2, 3, 4),
                                     np.array([2.0], F32))),
    ("pow_int", _pair("Pow", _x(3, 5, dtype=I32) % 5,
                      np.array([0, 1, 2, 3, 2], I32))),
    ("equal_float", _pair("Equal", np.array([1.0, 2.0, np.nan, 3.0], F32),
                          np.array([1.0, 2.5, np.nan, 3.0], F32))),
    ("equal_int64", _pair("Equal", _x(4, 6, dtype=I64) % 3,
                          _x(5, 6, dtype=I64) % 3)),
    ("less", _pair("Less", _x(6, 3, 4), _x(7, 4))),
    ("greater_or_equal", _pair("GreaterOrEqual", _x(8, 3, 4),
                               _x(8, 3, 4) * np.float32(0.5))),
    ("less_or_equal", _pair("LessOrEqual", _x(9, 2, 5, dtype=I32),
                            _x(10, 2, 5, dtype=I32))),
    ("and", _pair("And", _x(11, 3, 4, dtype=np.bool_),
                  _x(12, 3, 4, dtype=np.bool_))),
    ("or", _pair("Or", _x(13, 3, 4, dtype=np.bool_),
                 _x(14, 4, dtype=np.bool_))),
    ("xor", _pair("Xor", _x(15, 3, 4, dtype=np.bool_),
                  _x(16, 3, 4, dtype=np.bool_))),
    ("bitwise_and", _pair("BitwiseAnd", _x(17, 8, dtype=I32),
                          _x(18, 8, dtype=I32))),
    ("bitwise_or", _pair("BitwiseOr", _x(19, 2, 8, dtype=I64),
                         _x(20, 8, dtype=I64))),
    ("bitwise_xor", _pair("BitwiseXor",
                          np.arange(16, dtype=np.uint8),
                          np.full(16, 0x5A, np.uint8))),
]


@pytest.mark.parametrize("case", BINARY, ids=[c[0] for c in BINARY])
def test_binary_ops_match_jax(case):
    blob, feeds = case[1]()
    _check(blob, feeds)


# -- the same ops on host values: numpy in, numpy out ----------------------

def _host_pair(op, a, b):
    return lambda: one_node(op, {}, consts={"a": a, "b": b})


HOST_BINARY = [
    ("pow_host", _host_pair("Pow", np.array([2, 3], I64),
                            np.array([3, 2], I64))),
    ("equal_host", _host_pair("Equal", np.array([4, 5, 6], I64),
                              np.array([4, 0, 6], I64))),
    ("less_host", _host_pair("Less", np.array([1, 9], I64),
                             np.array([3, 3], I64))),
    ("greater_or_equal_host", _host_pair(
        "GreaterOrEqual", np.array([1, 3], I64), np.array([3, 3], I64))),
    ("less_or_equal_host", _host_pair(
        "LessOrEqual", np.array([1, 4], I64), np.array([3, 3], I64))),
    ("and_host", _host_pair("And", np.array([True, False]),
                            np.array([True, True]))),
    ("or_host", _host_pair("Or", np.array([True, False]),
                           np.array([False, False]))),
    ("xor_host", _host_pair("Xor", np.array([True, False]),
                            np.array([True, True]))),
    ("bitwise_and_host", _host_pair("BitwiseAnd", np.array([12, 10], I64),
                                    np.array([10, 6], I64))),
    ("min_host", _host_pair("Min", np.array([7, -1, 4], I64),
                            np.array([5, 5, 5], I64))),
    ("max_host", _host_pair("Max", np.array([7, -1, 4], I64),
                            np.array([5, 5, 5], I64))),
    ("sum_host", _host_pair("Sum", np.array([7, -1], I64),
                            np.array([5, 5], I64))),
    ("mean_host", _host_pair("Mean", np.array([1.0, 2.0], F32),
                             np.array([4.0, 5.0], F32))),
    ("expand_host", lambda: one_node(
        "Expand", {}, consts={"x": np.array([[1], [2]], I64),
                              "s": np.array([2, 3], I64)})),
    ("trilu_host", lambda: one_node(
        "Trilu", {}, consts={"x": np.arange(9, dtype=I64).reshape(3, 3)},
        upper=0)),
]


@pytest.mark.parametrize("case", HOST_BINARY, ids=[c[0] for c in HOST_BINARY])
def test_shape_arithmetic_ops_stay_on_the_host(case):
    port = _check(case[1](), [], host=True)
    assert all(_host(p) for p in port)


# -- unary: the reference always runs them on the device ------------------

def _unary(op, x, **tol):
    return (op, x, tol)


_NAN_INF = np.array([1.0, np.nan, -np.inf, np.inf, 0.0, -2.5], F32)
UNARY = [
    _unary("Sigmoid", _x(0, 3, 5) * 4),
    _unary("Tanh", _x(1, 3, 5) * 3),
    _unary("Exp", _x(2, 3, 5)),
    _unary("Log", _x(3, 3, 5, lo=0.01, hi=10.0)),
    _unary("Reciprocal", _x(4, 3, 5, lo=0.5, hi=4.0)),
    _unary("Neg", _x(5, 3, 5)),
    _unary("Abs", _x(6, 3, 5)),
    _unary("Floor", _x(7, 3, 5) * 3),
    _unary("Ceil", _x(8, 3, 5) * 3),
    _unary("Sign", np.array([-2.0, 0.0, 3.0, -0.0], F32)),
    _unary("Erf", _x(9, 4, 6) * 2),
    _unary("Softplus", np.linspace(-30, 30, 25).astype(F32)),
    _unary("Not", _x(10, 3, 4, dtype=np.bool_)),
    _unary("Sin", _x(11, 3, 5) * 3),
    _unary("Cos", _x(12, 3, 5) * 3),
    _unary("Tan", _x(13, 3, 5, lo=-1.2, hi=1.2)),
    _unary("Asin", _x(14, 3, 5, lo=-0.99, hi=0.99)),
    _unary("Acos", _x(15, 3, 5, lo=-0.99, hi=0.99)),
    _unary("Atan", _x(16, 3, 5) * 3),
    _unary("Sinh", _x(17, 3, 5) * 2),
    _unary("Cosh", _x(18, 3, 5) * 2),
    _unary("Asinh", _x(19, 3, 5) * 3),
    _unary("Acosh", _x(20, 3, 5, lo=1.01, hi=5.0)),
    _unary("Atanh", _x(21, 3, 5, lo=-0.95, hi=0.95)),
    _unary("Det", _x(22, 2, 3, 3), rtol=1e-4, atol=1e-4),
    _unary("IsNaN", _NAN_INF),
    _unary("IsInf", _NAN_INF),
    _unary("Softsign", _x(23, 3, 5) * 4),
    _unary("Round", np.array([0.5, 1.5, 2.5, -0.5, -1.5, 2.4, -2.6], F32)),
    _unary("BitwiseNot", np.array([0, 1, 127, 200, 255], np.uint8)),
]


@pytest.mark.parametrize("case", UNARY, ids=[c[0] for c in UNARY])
def test_unary_ops_match_jax(case):
    op, x, tol = case
    _check(one_node(op, {"x": x}), [x], **tol)


@pytest.mark.parametrize("op", ["Sigmoid", "Erf", "Abs"])
def test_unary_op_of_a_host_value_runs_on_the_device(op):
    """A Constant's value goes to the run's device, as jnp takes it."""
    port = _check(one_node(op, {}, consts={
        "x": np.array([-1.5, 0.0, 2.0], F32)}), [])
    assert not _host(port[0])


def test_opset_leftovers_against_jax_and_numpy():
    """The reference's ``test_opset_leftovers_elementwise_and_aliases``
    graph (its ported ops): Asinh, Acosh, Atanh, Det and ReduceLogSum of
    one input, beside numpy."""
    from synapseml_tpu_torch.onnx import GraphBuilder

    g = GraphBuilder(opset=17)
    x = g.add_input("x", F32, [2, 3, 3])
    outs = [g.add_node("Asinh", [x]), g.add_node("Acosh", [x]),
            g.add_node("Det", [x]),
            g.add_node("ReduceLogSum", [x], axes=[1], keepdims=0)]
    for nm in outs:
        g.add_output(nm, F32, None)
    xv = (np.random.default_rng(2).random((2, 3, 3)) * 0.2
          + 1.2).astype(F32)                     # > 1: acosh is defined
    port = _check(g.to_bytes(), [xv], rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(port[0].numpy(), np.arcsinh(xv), atol=1e-5)
    np.testing.assert_allclose(port[1].numpy(), np.arccosh(xv), atol=1e-5)
    np.testing.assert_allclose(port[2].numpy(), np.linalg.det(xv),
                               atol=1e-4)
    np.testing.assert_allclose(port[3].numpy(), np.log(xv.sum(1)),
                               atol=1e-5)


# -- Clip, Min, Max, Sum, Mean ---------------------------------------------

def _graph(op, feeds, **kw):
    """(one-node graph of ``op`` over ``feeds``, the feeds' values)."""
    return one_node(op, feeds, **kw), list(feeds.values())


_V = _x(30, 4, 5)
_VI = (_V * 10).astype(I32)
VARIADIC = [
    ("clip_both_bounds", lambda: _graph(
        "Clip", {"x": _V}, inits={"lo": np.array(-0.5, F32),
                                  "hi": np.array(0.7, F32)})),
    ("clip_low_only", lambda: _graph(
        "Clip", {"x": _V}, inits={"lo": np.array(0.0, F32)})),
    ("clip_high_only", lambda: _graph(
        "Clip", {"x": _V}, inits={"hi": np.array(0.3, F32)},
        node_inputs=["x", "", "hi"])),
    ("clip_opset6_attrs", lambda: _graph(
        "Clip", {"x": _V}, opset=6, min=-0.25, max=0.5)),
    ("clip_int_bounds", lambda: _graph(
        "Clip", {"x": _VI}, inits={"lo": np.array(-3, I32),
                                   "hi": np.array(4, I32)})),
    ("clip_int_unbounded_is_float", lambda: _graph("Clip", {"x": _VI})),
    ("min_three", lambda: _graph(
        "Min", {"x": _V, "y": _V[::-1].copy(), "z": _V * np.float32(0.5)})),
    ("max_broadcast", lambda: _graph("Max", {"x": _V, "y": _V[:1].copy()})),
    ("max_device_and_constant", lambda: _graph(
        "Max", {"x": _V}, consts={"c": np.array(0.1, F32)})),
    ("sum_three", lambda: _graph(
        "Sum", {"x": _V, "y": _V * np.float32(2), "z": _V[:, :1].copy()})),
    ("sum_one", lambda: _graph("Sum", {"x": _V})),
    ("mean_three", lambda: _graph(
        "Mean", {"x": _V, "y": _V * np.float32(3), "z": _V[:1].copy()})),
    ("mean_int", lambda: _graph(
        "Mean", {"x": _VI, "y": (_V * 7).astype(I32)})),
]


@pytest.mark.parametrize("case", VARIADIC, ids=[c[0] for c in VARIADIC])
def test_clip_min_max_sum_mean_match_jax(case):
    blob, feeds = case[1]()
    _check(blob, feeds)


# -- Trilu, Einsum, Expand, CumSum -----------------------------------------

def _feed_case(name, build, *feeds, **tol):
    return (name, build, list(feeds), tol)


_M = _x(40, 2, 4, 5)
STRUCTURE = [
    _feed_case("trilu_upper", lambda: one_node("Trilu", {"x": _M}), _M),
    _feed_case("trilu_lower", lambda: one_node("Trilu", {"x": _M}, upper=0),
               _M),
    _feed_case("trilu_upper_k2", lambda: one_node(
        "Trilu", {"x": _M}, consts={"k": np.array(2, I64)}), _M),
    _feed_case("trilu_lower_k_negative", lambda: one_node(
        "Trilu", {"x": _M}, consts={"k": np.array(-1, I64)}, upper=0), _M),
    _feed_case("trilu_int64", lambda: one_node(
        "Trilu", {"x": np.arange(16, dtype=I64).reshape(4, 4)}, upper=0),
        np.arange(16, dtype=I64).reshape(4, 4)),
    _feed_case("einsum_batched_matmul", lambda: one_node(
        "Einsum", {"a": _x(41, 2, 3, 4), "b": _x(42, 2, 4, 5)},
        equation="bij,bjk->bik"), _x(41, 2, 3, 4), _x(42, 2, 4, 5)),
    _feed_case("einsum_transpose", lambda: one_node(
        "Einsum", {"a": _x(43, 3, 4)}, equation="ij->ji"), _x(43, 3, 4)),
    _feed_case("einsum_dot", lambda: one_node(
        "Einsum", {"a": _x(44, 7), "b": _x(45, 7)}, equation="i,i->"),
        _x(44, 7), _x(45, 7)),
    _feed_case("einsum_attention_scores", lambda: one_node(
        "Einsum", {"q": _x(46, 2, 3, 5, 8), "k": _x(47, 2, 3, 6, 8)},
        equation="bhsd,bhtd->bhst"), _x(46, 2, 3, 5, 8), _x(47, 2, 3, 6, 8)),
    _feed_case("expand_rank_up", lambda: one_node(
        "Expand", {"x": _x(48, 3, 1)}, consts={
            "s": np.array([2, 3, 4], I64)}), _x(48, 3, 1)),
    _feed_case("expand_target_ones", lambda: one_node(
        "Expand", {"x": _x(49, 2, 3)}, consts={"s": np.array([1, 1], I64)}),
        _x(49, 2, 3)),
    _feed_case("expand_bool_mask", lambda: one_node(
        "Expand", {"m": _x(50, 1, 1, 4, dtype=np.bool_)}, consts={
            "s": np.array([2, 3, 1, 4], I64)}),
        _x(50, 1, 1, 4, dtype=np.bool_)),
    _feed_case("cumsum", lambda: one_node(
        "CumSum", {"x": _x(51, 3, 6)}, consts={"a": np.array(1, I64)}),
        _x(51, 3, 6)),
    _feed_case("cumsum_exclusive", lambda: one_node(
        "CumSum", {"x": _x(52, 3, 6)}, consts={"a": np.array(1, I64)},
        exclusive=1), _x(52, 3, 6)),
    _feed_case("cumsum_reverse", lambda: one_node(
        "CumSum", {"x": _x(53, 3, 6)}, consts={"a": np.array(0, I64)},
        reverse=1), _x(53, 3, 6)),
    _feed_case("cumsum_reverse_exclusive_negative_axis", lambda: one_node(
        "CumSum", {"x": _x(54, 2, 3, 4)}, consts={"a": np.array(-1, I64)},
        reverse=1, exclusive=1), _x(54, 2, 3, 4)),
    _feed_case("cumsum_int32", lambda: one_node(
        "CumSum", {"x": _x(55, 4, 5, dtype=I32)},
        consts={"a": np.array(1, I64)}), _x(55, 4, 5, dtype=I32)),
    _feed_case("cumsum_int64_mask_positions", lambda: one_node(
        "CumSum", {"x": np.array([[1, 1, 1, 0, 0]], I64)},
        consts={"a": np.array(1, I64)}), np.array([[1, 1, 1, 0, 0]], I64)),
]


@pytest.mark.parametrize("case", STRUCTURE, ids=[c[0] for c in STRUCTURE])
def test_trilu_einsum_expand_cumsum_match_jax(case):
    _, build, feeds, tol = case
    _check(build(), feeds, **tol)


def test_expand_refuses_incompatible_dims():
    from synapseml_tpu_torch.onnx import import_model

    blob = one_node("Expand", {"x": _x(0, 3, 2)},
                    consts={"s": np.array([3, 4], I64)})
    fn = import_model(blob).bind(device="cpu")
    with pytest.raises(ValueError, match="incompatible"):
        fn(np.zeros((3, 2), F32))


# -- the Reduce* family and ArgMax/ArgMin ----------------------------------

REDUCE_OPS = ["ReduceMean", "ReduceSum", "ReduceMax", "ReduceMin",
              "ReduceProd", "ReduceL1", "ReduceL2", "ReduceLogSumExp",
              "ReduceLogSum", "ReduceSumSquare"]


def _reduce_input(op):
    x = _x(60, 2, 3, 4, lo=0.5, hi=1.5)
    return x if op in ("ReduceLogSum", "ReduceProd") else x - np.float32(1)


@pytest.mark.parametrize("op", REDUCE_OPS)
@pytest.mark.parametrize("form", ["axes_attr_keepdims", "axes_attr_drop",
                                  "axes_input_opset18", "all_axes",
                                  "negative_axes"])
def test_reductions_match_jax(op, form):
    """``axes`` as the opset < 18 attribute and as the opset-18 input,
    kept and dropped dims, no axes (every axis), negative axes."""
    x = _reduce_input(op)
    if form == "axes_attr_keepdims":
        blob = one_node(op, {"x": x}, axes=[1])
    elif form == "axes_attr_drop":
        blob = one_node(op, {"x": x}, axes=[0, 2], keepdims=0)
    elif form == "axes_input_opset18":
        blob = one_node(op, {"x": x}, consts={"a": np.array([2], I64)},
                        opset=18, keepdims=0)
    elif form == "all_axes":
        blob = one_node(op, {"x": x}, opset=18)
    else:
        blob = one_node(op, {"x": x}, axes=[-1, -3])
    _check(blob, [x])


@pytest.mark.parametrize("op", ["ReduceSum", "ReduceMean"])
def test_reduction_noop_with_empty_axes_and_integers(op):
    x = _x(61, 3, 4)
    _check(one_node(op, {"x": x}, opset=18, noop_with_empty_axes=1), [x])
    xi = _x(62, 3, 4, dtype=I32)
    _check(one_node(op, {"x": xi}, consts={"a": np.array([1], I64)},
                    opset=18), [xi])


@pytest.mark.parametrize("op", ["ArgMax", "ArgMin"])
@pytest.mark.parametrize("axis,keepdims", [(0, 1), (1, 0), (-1, 1)])
def test_arg_reductions_match_jax(op, axis, keepdims):
    x = _x(63, 3, 4, 5)
    x[0, 0, :2] = x[0, 0, 2]            # ties: the first index wins
    _check(one_node(op, {"x": x}, axis=axis, keepdims=keepdims), [x])

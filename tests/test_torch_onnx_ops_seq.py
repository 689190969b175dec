"""The port's ONNX ops of the ``torch_gru``, ``torch_transformer``,
``torch_quant_cnn`` and ``torch_kv_decoder`` graphs (and ``Gelu``/``Split``
of the reference's transformer zoo) against the JAX package's importer:
one-node graphs built with ``GraphBuilder``, the same bytes and the same
seeded numpy inputs through both, on the CPU.

Each case feeds device arrays (torch tensors, jax arrays) or, where the
op keeps shape arithmetic on the host, numpy too (``host``): the port
must return a numpy value exactly where the reference does.

Tolerance: float32 outputs within rtol=atol=1e-5 of the reference's;
integer outputs equal; bf16 outputs within rtol=atol=1e-2; output dtypes
equal (a 64-bit integer may stay 64-bit where the reference narrows it).
"""
import numpy as np
import pytest
import torch

from torch_onnx_parity import assert_parity, one_node, run_both

F32, I64 = np.float32, np.int64


def _x(seed, *shape, dtype=F32):
    return np.random.default_rng(seed).standard_normal(shape).astype(dtype)


def _check(blob, feeds, host=False, **tol):
    port, ref = run_both(blob, feeds, host=host)
    assert_parity(port, ref, **tol)
    for p, r in zip(port, ref):
        assert _host(p) == _host(r)
    return port


def _host(v) -> bool:
    return isinstance(v, (np.ndarray, np.generic))


# -- shape arithmetic: host in, host out -----------------------------------

SHAPE_OPS = [
    ("shape", lambda: one_node("Shape", {"x": _x(0, 2, 3, 4)}), [0]),
    ("shape_start_end", lambda: one_node(
        "Shape", {"x": _x(0, 2, 3, 4)}, start=1, end=-1), [0]),
    ("constant_tensor", lambda: one_node(
        "Constant", {}, node_inputs=[], value=np.arange(4, dtype=I64)), []),
    ("constant_value_float", lambda: one_node(
        "Constant", {}, node_inputs=[], value_float=0.5), []),
    ("constant_value_ints", lambda: one_node(
        "Constant", {}, node_inputs=[], value_ints=[3, -1]), []),
    ("constant_of_shape_default", lambda: one_node(
        "ConstantOfShape", {}, consts={"s": np.array([2, 3], I64)}), []),
    ("constant_of_shape_int64", lambda: one_node(
        "ConstantOfShape", {}, consts={"s": np.array([4], I64)},
        value=np.array([7], I64)), []),
    ("range", lambda: one_node(
        "Range", {}, consts={"a": np.array(2, I64), "b": np.array(11, I64),
                             "d": np.array(3, I64)}), []),
    ("gather_shape_negative", lambda: one_node(
        "Gather", {}, consts={"s": np.array([5, 6, 7], I64),
                              "i": np.array(-1, I64)}), []),
    ("concat_host", lambda: one_node(
        "Concat", {}, consts={"a": np.array([1, 2], I64),
                              "b": np.array([-1], I64)}, axis=0), []),
    ("unsqueeze_host_opset13", lambda: one_node(
        "Unsqueeze", {}, consts={"a": np.array(3, I64),
                                 "ax": np.array([0], I64)}), []),
    ("mod_host", lambda: one_node(
        "Mod", {}, consts={"a": np.array([7, -7, 8], I64),
                           "b": np.array([3, 3, -3], I64)}), []),
    ("div_host_int_truncates", lambda: one_node(
        "Div", {}, consts={"a": np.array([7, -7, 7, -8], I64),
                           "b": np.array([2, 2, -2, 3], I64)}), []),
    ("sub_host", lambda: one_node(
        "Sub", {}, consts={"a": np.array([5], I64),
                           "b": np.array([7], I64)}), []),
    ("mul_host", lambda: one_node(
        "Mul", {}, consts={"a": np.array([5, 2], I64),
                           "b": np.array(3, I64)}), []),
    ("cast_host", lambda: one_node(
        "Cast", {}, consts={"a": np.array([1.7, -2.5], F32)}, to=7), []),
    ("slice_host_negative_step", lambda: one_node(
        "Slice", {}, consts={"x": np.arange(10, dtype=I64),
                             "s": np.array([-2], I64),
                             "e": np.array([-9], I64),
                             "ax": np.array([0], I64),
                             "st": np.array([-2], I64)}), []),
    ("squeeze_host", lambda: one_node(
        "Squeeze", {}, consts={"x": np.array([[4]], I64),
                               "ax": np.array([0], I64)}), []),
    ("reshape_host", lambda: one_node(
        "Reshape", {}, consts={"x": np.arange(6, dtype=I64),
                               "s": np.array([3, -1], I64)}), []),
    ("transpose_host", lambda: one_node(
        "Transpose", {}, consts={"x": np.arange(6, dtype=I64).reshape(2, 3)}),
     []),
    ("tile_host", lambda: one_node(
        "Tile", {}, consts={"x": np.array([1, 2], I64),
                            "r": np.array([3], I64)}), []),
    ("greater_host", lambda: one_node(
        "Greater", {}, consts={"a": np.array([1, 5], I64),
                               "b": np.array([3, 3], I64)}), []),
    ("where_host", lambda: one_node(
        "Where", {}, consts={"c": np.array([True, False]),
                             "a": np.array([1, 2], I64),
                             "b": np.array([7, 8], I64)}), []),
    ("identity_host", lambda: one_node(
        "Identity", {}, consts={"a": np.array([1, 2], I64)}), []),
]


@pytest.mark.parametrize("case", SHAPE_OPS, ids=[c[0] for c in SHAPE_OPS])
def test_shape_arithmetic_stays_on_the_host(case):
    _, build, feed_seeds = case
    feeds = [_x(s, 2, 3, 4) for s in feed_seeds]
    port = _check(build(), feeds, host=True)
    assert all(_host(p) for p in port)


# -- the same ops on device tensors ---------------------------------------

def test_gather_negative_indices_on_the_device():
    """Gather wraps negative indices (jnp.take does; index_select not)."""
    x = _x(1, 5, 4, 3)
    for axis, idx in ((0, np.array([[-1, 0], [2, -5]], I64)),
                      (1, np.array([-4, 3, -1], I64)),
                      (2, np.array(-2, I64))):
        blob = one_node("Gather", {"x": x, "i": idx}, axis=axis)
        _check(blob, [x, idx])
        # a host index (a Constant) into a device tensor
        blob = one_node("Gather", {"x": x}, consts={"i": idx}, axis=axis)
        _check(blob, [x])


def test_gather_embedding_from_a_param():
    ids = np.array([[0, 3, 9], [9, 1, 2]], I64)
    blob = one_node("Gather", {"ids": ids}, inits={"emb": _x(2, 10, 6)},
                    node_inputs=["emb", "ids"], axis=0)
    _check(blob, [ids])


@pytest.mark.parametrize("opset", [11, 13])
def test_unsqueeze_squeeze(opset):
    x = _x(3, 3, 1, 4)
    if opset < 13:
        un = one_node("Unsqueeze", {"x": x}, opset=opset, axes=[0, -1])
        sq = one_node("Squeeze", {"x": x}, opset=opset, axes=[1])
    else:
        un = one_node("Unsqueeze", {"x": x},
                      inits={"ax": np.array([0, -1], I64)}, opset=opset)
        sq = one_node("Squeeze", {"x": x},
                      inits={"ax": np.array([1], I64)}, opset=opset)
    _check(un, [x])
    _check(sq, [x])
    _check(one_node("Squeeze", {"x": x}, opset=opset), [x])


@pytest.mark.parametrize("case", [
    ("zero_copies_a_dim", np.array([0, -1], I64), 0),
    ("minus_one", np.array([4, -1, 3], I64), 0),
    ("allowzero", np.array([3, 4, 0], I64), 1),
], ids=lambda c: c[0])
def test_reshape(case):
    _, shape, allowzero = case
    x = _x(4, 3, 4) if not allowzero else np.zeros((3, 4, 0), F32)
    blob = one_node("Reshape", {"x": x}, inits={"s": shape},
                    allowzero=allowzero)
    _check(blob, [x])


@pytest.mark.parametrize("perm", [None, [0, 2, 1], [2, 0, 1]])
def test_transpose(perm):
    x = _x(5, 2, 3, 4)
    attrs = {} if perm is None else {"perm": perm}
    _check(one_node("Transpose", {"x": x}, **attrs), [x])


def test_concat_device_and_host_operands():
    """A host operand (Constant) meets device ones and takes their device;
    an int64 host value meets a float32 tensor as JAX promotes it."""
    x = _x(6, 2, 3)
    blob = one_node("Concat", {"x": x}, consts={"c": np.ones((2, 2), I64)},
                    axis=1)
    _check(blob, [x])


SLICES = [
    ("basic", [1], [3], [1], None),
    ("negative_start_end", [-3], [-1], [0], None),
    ("step2", [0, 1], [4, 4], [0, 2], [2, 1]),
    ("negative_step", [-1], [-100], [1], [-1]),
    ("negative_step2", [3], [0], [2], [-2]),
    ("int_max_end", [1], [2**63 - 1], [2], None),
]


@pytest.mark.parametrize("case", SLICES, ids=[c[0] for c in SLICES])
def test_slice_on_the_device(case):
    _, st, en, ax, sp = case
    x = _x(7, 5, 6, 7)
    inits = {"s": np.array(st, I64), "e": np.array(en, I64),
             "a": np.array(ax, I64)}
    if sp is not None:
        inits["p"] = np.array(sp, I64)
    _check(one_node("Slice", {"x": x}, inits=inits), [x])


@pytest.mark.parametrize("to,src", [(7, F32), (6, F32), (1, I64), (9, F32),
                                    (11, F32)])
def test_cast_on_the_device(to, src):
    """float64 on the device is float32, as under JAX's 32-bit mode."""
    x = (_x(8, 3, 4) * 3).astype(src)
    _check(one_node("Cast", {"x": x}, to=to), [x])


def test_identity():
    x = _x(9, 3)
    _check(one_node("Identity", {"x": x}), [x])


@pytest.mark.parametrize("dtype", [I64, F32])
def test_div(dtype):
    """Integer division truncates toward zero on the device too."""
    a = np.array([[7, -7, 7, -8], [9, -9, 1, 0]]).astype(dtype)
    b = np.array([2, 2, -2, 3]).astype(dtype)
    _check(one_node("Div", {"a": a, "b": b}), [a, b])
    # a host divisor (a Constant) goes to the device as a tensor
    _check(one_node("Div", {"a": a}, consts={"b": np.array(3, dtype)}), [a])


@pytest.mark.parametrize("fmod", [0, 1])
@pytest.mark.parametrize("dtype", [I64, F32])
def test_mod(fmod, dtype):
    if dtype == I64:
        a = np.array([7, -7, 7, -7, 0], I64)
        b = np.array([3, 3, -3, -3, 5], I64)
    else:
        a = np.array([7.5, -7.5, 7.5, -7.5, 1.0], F32)
        b = np.array([2.0, 2.0, -2.0, -2.0, 3.0], F32)
    _check(one_node("Mod", {"a": a, "b": b}, fmod=fmod), [a, b])


@pytest.mark.parametrize("op_type", ["Sub", "Mul", "Greater"])
def test_binary_ops_broadcast(op_type):
    a = _x(10, 2, 3, 4)
    b = _x(11, 4)
    _check(one_node(op_type, {"a": a, "b": b}), [a, b])
    _check(one_node(op_type, {"a": a}, consts={"b": np.float32(0.25)}), [a])


def test_bf16_activation_meets_a_float32_constant():
    """JAX's promotion: a 0-d float32 host value is strongly typed, so a
    bf16 activation times it is float32 (torch alone would keep bf16)."""
    import ml_dtypes

    x = _x(12, 3, 4).astype(ml_dtypes.bfloat16)
    for op_type in ("Mul", "Add", "Sub", "Div"):
        blob = one_node(op_type, {"x": x}, consts={"c": np.float32(0.3)})
        port, ref = run_both(blob, [x], cast="bfloat16")
        assert port[0].dtype == torch.float32
        assert_parity(port, ref)
    # ... and a bf16 param keeps it bf16
    blob = one_node("Mul", {"x": x}, inits={"w": _x(13, 4)})
    port, ref = run_both(blob, [x], cast="bfloat16")
    assert port[0].dtype == torch.bfloat16
    assert_parity(port, ref, rtol=1e-2, atol=1e-2)


@pytest.mark.parametrize("host", [False, True])
def test_sqrt(host):
    x = np.abs(_x(14, 3, 5))
    _check(one_node("Sqrt", {"x": x}), [x], host=host)


def test_matmul():
    a, w = _x(15, 2, 3, 4), _x(16, 4, 5)
    _check(one_node("MatMul", {"a": a}, inits={"w": w}), [a])
    b = _x(17, 2, 4, 6)
    _check(one_node("MatMul", {"a": a, "b": b}), [a, b])


@pytest.mark.parametrize("axis,bias,n_out", [(-1, True, 1), (1, True, 1),
                                             (-1, False, 1), (-1, True, 3)])
def test_layer_normalization(axis, bias, n_out):
    x = _x(18, 2, 3, 8)
    scale_shape = (8,) if axis == -1 else (3, 8)
    inits = {"s": _x(19, *scale_shape)}
    if bias:
        inits["b"] = _x(20, *scale_shape)
    blob = one_node("LayerNormalization", {"x": x}, inits=inits,
                    n_out=n_out, axis=axis, epsilon=1e-5)
    _check(blob, [x])


@pytest.mark.parametrize("approximate", ["none", "tanh"])
def test_gelu(approximate):
    x = _x(21, 4, 7) * 2
    _check(one_node("Gelu", {"x": x}, opset=20, approximate=approximate),
           [x])


@pytest.mark.parametrize("case", [
    ("equal_three", 3, None, 11),
    ("uneven_attr", 2, [2, 5], 11),
    ("sizes_input", 3, [1, 4, 2], 13),
], ids=lambda c: c[0])
def test_split(case):
    _, n_out, sizes, opset = case
    x = _x(22, 7, 3) if sizes is not None else _x(22, 9, 3)
    if sizes is not None and opset >= 13:
        blob = one_node("Split", {"x": x}, inits={"s": np.array(sizes, I64)},
                        n_out=n_out, opset=opset, axis=0)
    else:
        blob = one_node("Split", {"x": x}, n_out=n_out, opset=opset, axis=0,
                        split=sizes)
    _check(blob, [x])


@pytest.mark.parametrize("direction", ["forward", "reverse",
                                       "bidirectional"])
@pytest.mark.parametrize("linear_before_reset", [0, 1])
def test_gru(direction, linear_before_reset):
    rng = np.random.default_rng(23)
    seq, batch, inp, hid = 5, 2, 3, 4
    dirs = 2 if direction == "bidirectional" else 1
    x = rng.normal(size=(seq, batch, inp)).astype(F32)
    inits = {"w": rng.normal(size=(dirs, 3 * hid, inp)).astype(F32) * 0.5,
             "r": rng.normal(size=(dirs, 3 * hid, hid)).astype(F32) * 0.5,
             "b": rng.normal(size=(dirs, 6 * hid)).astype(F32) * 0.5,
             "h0": rng.normal(size=(dirs, batch, hid)).astype(F32)}
    blob = one_node("GRU", {"x": x}, inits=inits,
                    node_inputs=["x", "w", "r", "b", "", "h0"], n_out=2,
                    hidden_size=hid, direction=direction,
                    linear_before_reset=linear_before_reset)
    _check(blob, [x])
    # one output, no bias, no initial state
    blob = one_node("GRU", {"x": x}, inits={"w": inits["w"],
                                            "r": inits["r"]},
                    hidden_size=hid, direction=direction,
                    linear_before_reset=linear_before_reset)
    _check(blob, [x])


QDQ = [
    ("per_tensor_uint8_no_zero_point", np.uint8, None, None),
    ("per_tensor_int8", np.int8, (), 1),
    ("per_channel_axis1", np.int8, (3,), 1),
    ("per_channel_axis0", np.uint8, (2,), 0),
]


@pytest.mark.parametrize("case", QDQ, ids=[c[0] for c in QDQ])
def test_quantize_dequantize(case):
    """Round half to even, then saturate: x/scale lands on .5 exactly for
    some inputs, and on both ends of the integer range for others."""
    _, qdt, shape, axis = case
    rng = np.random.default_rng(24)
    x = (rng.integers(-600, 600, (2, 3, 4)) / 4).astype(F32)  # .25 steps
    scale = (np.float32(0.5) if shape in (None, ())
             else rng.choice([0.5, 0.25], size=shape).astype(F32))
    consts = {"s": scale}
    if shape is not None:
        zp = (np.asarray(rng.integers(-3, 3, shape)) if qdt == np.int8
              else np.asarray(rng.integers(100, 130, shape)))
        consts["z"] = zp.astype(qdt)
    attrs = {} if axis is None else {"axis": axis}
    q = one_node("QuantizeLinear", {"x": x}, consts=consts, **attrs)
    port = _check(q, [x])
    qx = port[0].numpy()
    dq = one_node("DequantizeLinear", {"q": qx}, consts=consts, **attrs)
    _check(dq, [qx])
    # an integer weight initializer (a host value) dequantized on the device
    dqw = one_node("DequantizeLinear", {}, inits={"w": qx}, consts=consts,
                   node_inputs=["w", *consts], **attrs)
    _check(dqw, [])


def test_tile_on_the_device():
    x = _x(25, 2, 3)
    _check(one_node("Tile", {"x": x}, inits={"r": np.array([2, 3], I64)}),
           [x])


def test_where_on_the_device():
    c = np.random.default_rng(26).random((3, 4)) > 0.5
    a, b = _x(27, 3, 4), _x(28, 4)
    _check(one_node("Where", {"c": c, "a": a, "b": b}), [c, a, b])
    # the causal-mask idiom: a host mask against a device tensor
    _check(one_node("Where", {"a": a}, consts={"c": c,
                                               "b": np.float32(-1e9)},
                    node_inputs=["c", "a", "b"]), [a])


def test_range_with_device_bounds_raises():
    from synapseml_tpu_torch.onnx import import_model

    blob = one_node("Range", {"a": np.array(0, I64)},
                    consts={"b": np.array(4, I64), "d": np.array(1, I64)})
    fn = import_model(blob).bind(device="cpu")
    with pytest.raises(ValueError, match="Range with device bounds"):
        fn(torch.tensor(0))

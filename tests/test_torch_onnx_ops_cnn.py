"""The port's ONNX ops of the ResNet-50 and ``torch_cnn`` graphs against the
JAX package's importer: one-node graphs built with ``GraphBuilder``, the
same bytes and the same seeded numpy inputs through both, on the CPU.

Tolerance: float32 outputs within rtol=atol=1e-5 of the reference's;
integer outputs equal; bf16 outputs within rtol=atol=1e-2 (a few bf16
roundings); output dtypes equal (a 64-bit integer may stay 64-bit).
"""
import numpy as np
import pytest

from torch_onnx_parity import assert_parity, one_node, run_both

F32 = np.float32


def _x(seed, *shape, dtype=F32):
    return np.random.default_rng(seed).standard_normal(shape).astype(dtype)


CONV = [
    ("pads_symmetric", (2, 4, 9, 9), (6, 4, 3, 3), True,
     dict(pads=[1, 1, 1, 1])),
    ("pads_asymmetric_stride2", (2, 4, 9, 10), (6, 4, 3, 3), True,
     dict(pads=[0, 1, 2, 0], strides=[2, 2])),
    ("same_upper_even_kernel", (1, 3, 10, 9), (5, 3, 4, 4), True,
     dict(auto_pad="SAME_UPPER", strides=[2, 2])),
    ("same_lower_even_kernel", (1, 3, 10, 9), (5, 3, 4, 4), False,
     dict(auto_pad="SAME_LOWER", strides=[2, 2])),
    ("group2_dilation2", (2, 4, 11, 11), (6, 2, 3, 3), True,
     dict(group=2, dilations=[2, 2], pads=[2, 2, 2, 2])),
    ("depthwise", (2, 4, 8, 8), (4, 1, 3, 3), False,
     dict(group=4, pads=[1, 1, 1, 1])),
    ("stem_7x7_s2", (1, 3, 32, 32), (8, 3, 7, 7), False,
     dict(pads=[3, 3, 3, 3], strides=[2, 2])),
    ("conv1d_asymmetric", (2, 3, 11), (5, 3, 3), True,
     dict(pads=[1, 2])),
]


@pytest.mark.parametrize("case", CONV, ids=[c[0] for c in CONV])
def test_conv(case):
    _, xs, ws, bias, attrs = case
    inits = {"w": _x(1, *ws)}
    if bias:
        inits["b"] = _x(2, ws[0])
    blob = one_node("Conv", {"x": _x(0, *xs)}, inits=inits,
                    kernel_shape=list(ws[2:]), **attrs)
    assert_parity(*run_both(blob, [_x(0, *xs)]))


def test_conv_bf16_bind_keeps_bf16():
    blob = one_node("Conv", {"x": _x(0, 2, 4, 9, 9)},
                    inits={"w": _x(1, 6, 4, 3, 3), "b": _x(2, 6)},
                    pads=[1, 1, 1, 1], kernel_shape=[3, 3])
    import ml_dtypes

    x = _x(0, 2, 4, 9, 9).astype(ml_dtypes.bfloat16)
    port, ref = run_both(blob, [x], cast="bfloat16")
    assert_parity(port, ref, rtol=1e-2, atol=1e-2)


@pytest.mark.parametrize("eps,via_apply", [(1e-5, False), (1e-3, False),
                                           (1e-5, True)])
def test_batch_norm(eps, via_apply):
    """Folded once at bind (the bound path) and folded in the call (apply
    with the params given)."""
    rng = np.random.default_rng(3)
    c = 5
    inits = {"scale": rng.normal(size=c).astype(F32),
             "bias": rng.normal(size=c).astype(F32),
             "mean": rng.normal(size=c).astype(F32),
             "var": rng.uniform(0.1, 2.0, size=c).astype(F32)}
    blob = one_node("BatchNormalization", {"x": _x(0, 2, c, 6, 6)},
                    inits=inits, epsilon=eps)
    x = _x(0, 2, c, 6, 6)
    if via_apply:
        import torch

        from synapseml_tpu.onnx import import_model as jax_import_model
        from synapseml_tpu_torch.onnx import import_model

        g, jg = import_model(blob), jax_import_model(blob)
        port = g.apply({k: torch.from_numpy(v) for k, v in g.params.items()},
                       torch.from_numpy(x))
        assert_parity(port, jg.apply(jg.params, x))
    else:
        assert_parity(*run_both(blob, [x]))


def test_batch_norm_bf16_bind():
    import ml_dtypes

    rng = np.random.default_rng(4)
    c = 4
    inits = {"scale": rng.normal(size=c).astype(F32),
             "bias": rng.normal(size=c).astype(F32),
             "mean": rng.normal(size=c).astype(F32),
             "var": rng.uniform(0.1, 2.0, size=c).astype(F32)}
    blob = one_node("BatchNormalization", {"x": _x(0, 2, c, 5, 5)},
                    inits=inits)
    x = _x(0, 2, c, 5, 5).astype(ml_dtypes.bfloat16)
    assert_parity(*run_both(blob, [x], cast="bfloat16"), rtol=1e-2,
                  atol=1e-2)


@pytest.mark.parametrize("host", [False, True])
def test_relu(host):
    blob = one_node("Relu", {"x": _x(0, 3, 7)})
    assert_parity(*run_both(blob, [_x(0, 3, 7)], host=host))


MAXPOOL = [
    ("resnet_3x3_s2_p1", (2, 3, 9, 9), F32,
     dict(kernel_shape=[3, 3], strides=[2, 2], pads=[1, 1, 1, 1])),
    ("pads_asymmetric", (2, 3, 8, 7), F32,
     dict(kernel_shape=[3, 2], pads=[0, 0, 1, 1])),
    ("ceil_mode", (1, 2, 8, 8), F32,
     dict(kernel_shape=[3, 3], strides=[2, 2], ceil_mode=1)),
    ("ceil_mode_padded", (1, 2, 9, 8), F32,
     dict(kernel_shape=[2, 2], strides=[2, 2], pads=[1, 1, 1, 1],
          ceil_mode=1)),
    ("same_upper", (1, 2, 7, 9), F32,
     dict(kernel_shape=[2, 3], strides=[2, 2], auto_pad="SAME_UPPER")),
    ("same_lower", (1, 2, 7, 9), F32,
     dict(kernel_shape=[2, 3], strides=[2, 2], auto_pad="SAME_LOWER")),
    ("dilation2", (1, 2, 11, 11), F32,
     dict(kernel_shape=[3, 3], dilations=[2, 2], pads=[1, 1, 1, 1])),
    ("int32_padded", (1, 2, 6, 6), np.int32,
     dict(kernel_shape=[3, 3], strides=[2, 2], pads=[1, 1, 1, 1])),
    ("pool1d", (2, 3, 10), F32,
     dict(kernel_shape=[3], strides=[2], pads=[1, 0])),
]


@pytest.mark.parametrize("case", MAXPOOL, ids=[c[0] for c in MAXPOOL])
def test_max_pool(case):
    _, shape, dt, attrs = case
    x = (np.random.default_rng(5).integers(-128, 128, shape).astype(dt)
         if dt is np.int32 else _x(5, *shape))
    blob = one_node("MaxPool", {"x": x}, **attrs)
    assert_parity(*run_both(blob, [x]))


def test_max_pool_int8_pads_with_the_integer_minimum():
    """int8 MaxPool equals the int32 one on the same values. (The
    reference raises here: its reduce_window init value is int32.)"""
    import torch

    from synapseml_tpu_torch.onnx import import_model

    x = np.random.default_rng(5).integers(-128, 128, (1, 2, 6, 6))
    attrs = dict(kernel_shape=[3, 3], strides=[2, 2], pads=[1, 1, 1, 1])
    outs = []
    for dt in (np.int8, np.int32):
        blob = one_node("MaxPool", {"x": x.astype(dt)}, **attrs)
        outs.append(import_model(blob).bind(device="cpu")(
            torch.from_numpy(x.astype(dt)))[0])
    assert outs[0].dtype == torch.int8
    assert torch.equal(outs[0].to(torch.int32), outs[1])
    # the corner window covers one padded row and column: they never win
    assert int(outs[0][0, 0, 0, 0]) == x[0, 0, :2, :2].max()


AVGPOOL = [
    ("pads_exclude", dict(kernel_shape=[3, 3], pads=[1, 1, 1, 1])),
    ("pads_include", dict(kernel_shape=[3, 3], pads=[1, 1, 1, 1],
                          count_include_pad=1)),
    ("asymmetric_exclude", dict(kernel_shape=[2, 3], pads=[0, 1, 1, 0],
                                strides=[2, 1])),
    ("ceil_mode_exclude", dict(kernel_shape=[3, 3], strides=[2, 2],
                               ceil_mode=1)),
    ("ceil_mode_include", dict(kernel_shape=[3, 3], strides=[2, 2],
                               pads=[1, 1, 1, 1], ceil_mode=1,
                               count_include_pad=1)),
    ("same_lower", dict(kernel_shape=[2, 2], auto_pad="SAME_LOWER")),
    ("torch_cnn_2x2", dict(kernel_shape=[2, 2], strides=[2, 2])),
]


@pytest.mark.parametrize("case", AVGPOOL, ids=[c[0] for c in AVGPOOL])
def test_average_pool(case):
    _, attrs = case
    x = _x(6, 2, 3, 8, 9)
    blob = one_node("AveragePool", {"x": x}, **attrs)
    assert_parity(*run_both(blob, [x]))


def test_average_pool_1d():
    x = _x(6, 2, 3, 10)
    blob = one_node("AveragePool", {"x": x}, kernel_shape=[3], strides=[2],
                    pads=[1, 1])
    assert_parity(*run_both(blob, [x]))


@pytest.mark.parametrize("shape", [(2, 3, 4), (4, 5)])
def test_add_broadcast(shape):
    x = _x(7, *shape)
    b = _x(8, shape[-1])
    blob = one_node("Add", {"x": x}, inits={"b": b})
    assert_parity(*run_both(blob, [x]))


def test_add_host_integers_stay_on_the_host():
    blob = one_node("Add", {}, consts={"a": np.array([1, 2], np.int64),
                                       "b": np.array([3, -4], np.int64)})
    port, ref = run_both(blob, [])
    assert isinstance(port[0], np.ndarray)
    assert_parity(port, ref)


def test_global_average_pool():
    x = _x(9, 2, 3, 5, 7)
    assert_parity(*run_both(one_node("GlobalAveragePool", {"x": x}), [x]))


@pytest.mark.parametrize("axis", [0, 1, 2, -1])
def test_flatten(axis):
    x = _x(10, 2, 3, 4, 5)
    assert_parity(*run_both(one_node("Flatten", {"x": x}, axis=axis), [x]))


GEMM = [
    ("plain_bias", (3, 4), (4, 5), (5,), {}),
    ("transB_resnet_fc", (3, 4), (5, 4), (5,), dict(transB=1)),
    ("transA_matrix_c", (4, 3), (4, 5), (3, 5), dict(transA=1)),
    ("alpha_beta", (3, 4), (4, 5), (1, 5), dict(alpha=0.5, beta=2.0)),
    ("no_c", (3, 4), (4, 5), None, dict(alpha=1.5)),
]


@pytest.mark.parametrize("case", GEMM, ids=[c[0] for c in GEMM])
def test_gemm(case):
    _, a_s, b_s, c_s, attrs = case
    inits = {"b": _x(12, *b_s)}
    if c_s is not None:
        inits["c"] = _x(13, *c_s)
    a = _x(11, *a_s)
    blob = one_node("Gemm", {"a": a}, inits=inits, **attrs)
    assert_parity(*run_both(blob, [a]))


def test_gemm_bf16_bind():
    import ml_dtypes

    a = _x(11, 3, 4).astype(ml_dtypes.bfloat16)
    blob = one_node("Gemm", {"a": a}, inits={"b": _x(12, 5, 4),
                                             "c": _x(13, 5)},
                    transB=1, alpha=0.3)
    assert_parity(*run_both(blob, [a], cast="bfloat16"), rtol=1e-2,
                  atol=1e-2)


SOFTMAX = [
    ("softmax_opset11_axis1_flattens", "Softmax", 11, {}),
    ("softmax_opset11_axis2", "Softmax", 11, dict(axis=2)),
    ("softmax_opset13_default_last", "Softmax", 13, {}),
    ("softmax_opset13_axis1", "Softmax", 13, dict(axis=1)),
    ("logsoftmax_opset11", "LogSoftmax", 11, {}),
    ("logsoftmax_opset13_axis1", "LogSoftmax", 13, dict(axis=1)),
    ("logsoftmax_opset17_torch_cnn", "LogSoftmax", 17, dict(axis=-1)),
]


@pytest.mark.parametrize("case", SOFTMAX, ids=[c[0] for c in SOFTMAX])
def test_softmax(case):
    _, op_type, opset, attrs = case
    x = _x(14, 2, 3, 5) * 3
    blob = one_node(op_type, {"x": x}, opset=opset, **attrs)
    assert_parity(*run_both(blob, [x]))

"""One-node graphs of the 12 ONNX integer and QOperator ops
(``MatMulInteger``, ``DynamicQuantizeLinear``, ``ConvInteger``,
``QLinearConv``, ``QLinearMatMul``, ``QLinearAdd``, ``QLinearMul``,
``QLinearSigmoid``, ``QLinearLeakyRelu``, ``QLinearGlobalAveragePool``,
``QLinearConcat``, ``QGemm``), with their seeded inputs.

``tests/test_torch_quant_ops.py`` runs each case through the JAX
package's importer and the port's on the CPU, and again with the port's
int8 lane forced (:data:`INT8_LANE` names the cases whose contraction that
lane takes); ``chip_smoke.py`` and ``tests/test_torch_cuda.py`` run the
port on the card against the port on the CPU. The cases cover uint8 and
int8 activations and weights (uint8 rides the int8 lane's -128 shift),
absent, scalar, per-row and per-column zero points, per-tensor and
per-channel scales, int32 biases, strides, explicit, asymmetric and
``SAME_UPPER`` pads, dilation, groups, 1-D and 3-D convolutions, a
batched (3-D) ``MatMulInteger``, shapes ``torch._int_mm`` refuses on the
card (rows <= 16, N not a multiple of 8), saturation at both ends of the
output type, and ``DynamicQuantizeLinear``'s degenerate ranges.

A case is a dict, as the other case modules name them for
``chip_smoke.py``'s ``cases_on_card``: ``op``, ``inputs``
(``[(name, array, where)]``, ``where`` one of ``"feed"`` (a graph input,
a tensor), ``"init"`` (an initializer: float ones become bound device
params, integer ones stay host values, as in both importers) or
``"const"`` (a Constant node)), ``nodes``, ``outputs``, ``opset``,
``kind`` (``"exact"``: every output bitwise — all of them here), ``exact``
and ``raises`` (None throughout).

This module imports neither package at import time: :func:`graph` takes
either package's ``GraphBuilder``, :func:`run` the port's
``import_model``.
"""
import numpy as np

from signal_op_cases import feeds, graph, leaves, run  # noqa: F401

U8, I8, I32, F32 = np.uint8, np.int8, np.int32, np.float32
OPSET = 21


def _q(seed, shape, dtype, lo=None, hi=None):
    info = np.iinfo(dtype)
    lo = info.min if lo is None else lo
    hi = info.max if hi is None else hi
    return np.random.default_rng(seed).integers(
        lo, hi + 1, shape).astype(dtype)


def _s(v):
    return np.asarray(v, F32)


def _z(v, dtype):
    return np.asarray(v, dtype)


def _case(name, op, inputs, n_out=1, **attrs):
    """A one-node case over ``inputs`` (an empty name skips a slot)."""
    outs = [f"y{i}" for i in range(n_out)]
    return dict(name=name, op=op, inputs=[i for i in inputs if i[0]],
                nodes=[(op, [n for n, _, _ in inputs], outs, attrs)],
                outputs=outs, kind="exact", exact=True, raises=None,
                opset=OPSET)


# -- MatMulInteger --------------------------------------------------------

def _mmi(name, a, b, a_zp=None, b_zp=None, a_where="feed"):
    ins = [("a", a, a_where), ("b", b, "init")]
    if a_zp is not None or b_zp is not None:
        ins.append(("a_zp", a_zp, "init") if a_zp is not None
                   else ("", None, ""))
    if b_zp is not None:
        ins.append(("b_zp", b_zp, "init"))
    return _case(name, "MatMulInteger", ins)


MATMUL_INTEGER = [
    _mmi("mmi_uint8_int8_scalar_zps", _q(1, (24, 16), U8),
         _q(2, (16, 8), I8), _z(131, U8), _z(-3, I8)),
    _mmi("mmi_int8_no_zero_points", _q(3, (20, 32), I8),
         _q(4, (32, 16), I8)),
    _mmi("mmi_per_row_a_zp", _q(5, (24, 16), U8), _q(6, (16, 8), I8),
         _q(7, (24,), U8)),
    _mmi("mmi_per_column_b_zp", _q(8, (32, 24), U8), _q(9, (24, 16), I8),
         _z(7, U8), _q(10, (16,), I8)),
    _mmi("mmi_uint8_weights_and_zero_points", _q(11, (18, 8), U8),
         _q(12, (8, 8), U8), _z(200, U8), _z(17, U8)),
    _mmi("mmi_int8_activations_scalar_zp", _q(13, (40, 24), I8),
         _q(14, (24, 32), I8), _z(-20, I8)),
    _mmi("mmi_three_dim_a_is_widened", _q(15, (2, 5, 16), U8),
         _q(16, (16, 8), I8), _z(128, U8)),
    _mmi("mmi_four_rows_int_mm_refuses", _q(17, (4, 16), U8),
         _q(18, (16, 8), I8), _z(3, U8)),
    _mmi("mmi_n_not_multiple_of_8", _q(19, (24, 16), U8),
         _q(20, (16, 5), I8), _z(90, U8)),
    _mmi("mmi_host_a", _q(21, (24, 8), U8), _q(22, (8, 8), I8), _z(5, U8),
         a_where="const"),
]

# -- DynamicQuantizeLinear ------------------------------------------------


def _dql(name, x):
    return _case(name, "DynamicQuantizeLinear", [("x", x, "feed")],
                 n_out=3)


_RNG = np.random.default_rng(30)
DYNAMIC_QUANTIZE = [
    _dql("dql_normal_spread", (_RNG.standard_normal((3, 17)) * 4)
         .astype(F32)),
    _dql("dql_all_positive", np.abs(_RNG.standard_normal(5)).astype(F32)),
    _dql("dql_all_negative", -np.abs(_RNG.standard_normal(5)).astype(F32)),
    _dql("dql_all_zero", np.zeros(4, F32)),
    _dql("dql_bert_hidden_rows", _RNG.standard_normal((32, 64))
         .astype(F32)),
]

# -- ConvInteger ----------------------------------------------------------


def _convint(name, x, w, x_zp=None, w_zp=None, **attrs):
    ins = [("x", x, "feed"), ("w", w, "init")]
    if x_zp is not None or w_zp is not None:
        ins.append(("x_zp", x_zp, "init") if x_zp is not None
                   else ("", None, ""))
    if w_zp is not None:
        ins.append(("w_zp", w_zp, "init"))
    return _case(name, "ConvInteger", ins, **attrs)


CONV_INTEGER = [
    _convint("convint_uint8_x_zp_pads", _q(40, (2, 2, 7, 7), U8),
             _q(41, (8, 2, 3, 3), I8), _z(99, U8), pads=[1, 1, 1, 1]),
    _convint("convint_int8_no_zp_stride2", _q(42, (2, 3, 9, 9), I8),
             _q(43, (8, 3, 3, 3), I8), strides=[2, 2]),
    _convint("convint_per_channel_w_zp_is_widened",
             _q(44, (1, 3, 8, 8), U8), _q(45, (8, 3, 3, 3), I8),
             _z(128, U8), _q(46, (8,), I8), pads=[1, 1, 1, 1]),
    _convint("convint_dilation2_group2", _q(47, (1, 4, 12, 12), U8),
             _q(48, (16, 2, 3, 3), I8), _z(77, U8), group=2,
             dilations=[2, 2], pads=[2, 2, 2, 2]),
    _convint("convint_same_upper_even_kernel", _q(49, (1, 3, 8, 8), U8),
             _q(50, (8, 3, 2, 2), I8), _z(10, U8), auto_pad="SAME_UPPER"),
    _convint("convint_asymmetric_pads", _q(51, (2, 3, 9, 7), U8),
             _q(52, (8, 3, 3, 3), I8), _z(250, U8), pads=[0, 1, 2, 0]),
    _convint("convint_1d", _q(53, (2, 4, 16), U8), _q(54, (8, 4, 3), I8),
             _z(128, U8), pads=[1, 1]),
    _convint("convint_3d", _q(55, (1, 2, 5, 5, 5), U8),
             _q(56, (8, 2, 3, 3, 3), I8), _z(1, U8), pads=[1] * 6),
    _convint("convint_depthwise_cout_per_group_1", _q(57, (1, 8, 6, 6), U8),
             _q(58, (8, 1, 3, 3), I8), _z(30, U8), group=8,
             pads=[1, 1, 1, 1]),
]

# -- QLinearConv ----------------------------------------------------------


def _qlconv(name, x, x_zp, w, w_scale, w_zp, y_zp, b=None, x_scale=0.05,
            y_scale=0.12, **attrs):
    ins = [("x", x, "feed"), ("x_scale", _s(x_scale), "init"),
           ("x_zp", x_zp, "init"), ("w", w, "init"),
           ("w_scale", _s(w_scale), "init"), ("w_zp", w_zp, "init"),
           ("y_scale", _s(y_scale), "init"), ("y_zp", y_zp, "init")]
    if b is not None:
        ins.append(("b", b, "init"))
    return _case(name, "QLinearConv", ins, **attrs)


QLINEAR_CONV = [
    _qlconv("qlconv_per_tensor_bias_pads", _q(60, (2, 3, 10, 10), U8),
            _z(128, U8), _q(61, (8, 3, 3, 3), I8, -100, 100), 0.02,
            _z(0, I8), _z(100, U8), b=_q(62, (8,), I32, -500, 500),
            pads=[1, 1, 1, 1]),
    _qlconv("qlconv_per_channel_scale", _q(63, (2, 3, 10, 10), U8),
            _z(128, U8), _q(64, (16, 3, 3, 3), I8, -100, 100),
            (np.random.default_rng(65).random(16) * 0.03 + 0.01),
            np.zeros(16, I8), _z(100, U8), b=_q(66, (16,), I32, -500, 500),
            pads=[1, 1, 1, 1]),
    _qlconv("qlconv_stem_7x7_stride2", _q(67, (1, 3, 20, 20), U8),
            _z(114, U8), _q(68, (8, 3, 7, 7), I8),
            (np.random.default_rng(69).random(8) * 0.01 + 0.002),
            np.zeros(8, I8), _z(0, U8), b=_q(70, (8,), I32, -2000, 2000),
            strides=[2, 2], pads=[3, 3, 3, 3]),
    _qlconv("qlconv_int8_activations", _q(71, (2, 4, 8, 8), I8),
            _z(-5, I8), _q(72, (8, 4, 3, 3), I8), 0.03, _z(0, I8),
            _z(3, I8), pads=[1, 1, 1, 1]),
    _qlconv("qlconv_group2_1x1_stride2", _q(73, (2, 16, 8, 8), U8),
            _z(60, U8), _q(74, (16, 8, 1, 1), I8), 0.02, _z(0, I8),
            _z(128, U8), group=2, strides=[2, 2]),
    _qlconv("qlconv_nonzero_w_zp_is_widened", _q(75, (1, 3, 8, 8), U8),
            _z(128, U8), _q(76, (8, 3, 3, 3), I8), 0.02, _z(4, I8),
            _z(128, U8), pads=[1, 1, 1, 1]),
    _qlconv("qlconv_saturates_both_ends", _q(77, (1, 4, 7, 7), U8),
            _z(0, U8), _q(78, (8, 4, 3, 3), I8), 0.5, _z(0, I8), _z(128, U8),
            x_scale=0.5, y_scale=0.01),
]

# -- QLinearMatMul --------------------------------------------------------


def _qlmm(name, a, a_scale, a_zp, b, b_scale, b_zp, y_scale, y_zp):
    return _case(name, "QLinearMatMul", [
        ("a", a, "feed"), ("a_scale", _s(a_scale), "init"),
        ("a_zp", a_zp, "init"), ("b", b, "init"),
        ("b_scale", _s(b_scale), "init"), ("b_zp", b_zp, "init"),
        ("y_scale", _s(y_scale), "init"), ("y_zp", y_zp, "init")])


QLINEAR_MATMUL = [
    _qlmm("qlmm_reference_scalars", _q(80, (24, 16), U8), 0.03,
          _z(120, U8), _q(81, (16, 8), I8, -127, 126), 0.05, _z(3, I8),
          0.2, _z(64, U8)),
    _qlmm("qlmm_per_row_a_per_column_b", _q(82, (32, 16), U8),
          np.random.default_rng(83).random(32) * 0.05 + 0.01, _z(128, U8),
          _q(84, (16, 24), I8), np.random.default_rng(85).random(24) * 0.02
          + 0.005, _q(86, (24,), I8, -3, 3), 0.4, _z(100, U8)),
    _qlmm("qlmm_int8_output", _q(87, (20, 8), I8), 0.1, _z(0, I8),
          _q(88, (8, 16), I8), 0.1, _z(0, I8), 1.5, _z(-10, I8)),
    _qlmm("qlmm_eight_rows_widened", _q(89, (8, 16), U8), 0.03,
          _z(120, U8), _q(90, (16, 8), I8), 0.05, _z(0, I8), 0.2,
          _z(64, U8)),
]

# -- the dequantize -> float op -> quantize family ------------------------


def _qlbin(name, op, a, a_scale, a_zp, b, b_scale, b_zp, c_scale, c_zp,
           b_where="feed"):
    return _case(name, op, [
        ("a", a, "feed"), ("a_scale", _s(a_scale), "init"),
        ("a_zp", a_zp, "init"), ("b", b, b_where),
        ("b_scale", _s(b_scale), "init"), ("b_zp", b_zp, "init"),
        ("c_scale", _s(c_scale), "init"), ("c_zp", c_zp, "init")])


def _qlun(name, op, x, x_scale, x_zp, y_scale, y_zp, **attrs):
    return _case(name, op, [
        ("x", x, "feed"), ("x_scale", _s(x_scale), "init"),
        ("x_zp", x_zp, "init"), ("y_scale", _s(y_scale), "init"),
        ("y_zp", y_zp, "init")], **attrs)


ELEMENTWISE = [
    _qlbin("qladd_uint8_residual", "QLinearAdd", _q(100, (2, 8, 5, 5), U8),
           0.031, _z(0, U8), _q(101, (2, 8, 5, 5), U8), 0.027, _z(0, U8),
           0.045, _z(0, U8)),
    _qlbin("qladd_broadcast_initializer", "QLinearAdd",
           _q(102, (2, 8, 5, 5), U8), 0.02, _z(128, U8),
           _q(103, (1, 8, 1, 1), U8), 0.05, _z(100, U8), 0.06, _z(120, U8),
           b_where="init"),
    _qlbin("qladd_int8", "QLinearAdd", _q(104, (4, 16), I8), 0.1,
           _z(-2, I8), _q(105, (4, 16), I8), 0.07, _z(5, I8), 0.12,
           _z(0, I8)),
    _qlbin("qlmul_uint8", "QLinearMul", _q(106, (3, 6, 7), U8), 0.01,
           _z(128, U8), _q(107, (3, 6, 7), U8), 0.02, _z(100, U8), 0.003,
           _z(128, U8)),
    _qlun("qlsigmoid_uint8", "QLinearSigmoid", _q(108, (4, 32), U8), 0.05,
          _z(128, U8), 1.0 / 256, _z(0, U8)),
    _qlun("qlsigmoid_int8", "QLinearSigmoid", _q(109, (4, 32), I8), 0.06,
          _z(0, I8), 1.0 / 256, _z(-128, I8)),
    _qlun("qlleakyrelu_alpha_0_1", "QLinearLeakyRelu",
          _q(110, (2, 4, 6, 6), U8), 0.04, _z(128, U8), 0.03, _z(20, U8),
          alpha=0.1),
    _qlun("qlleakyrelu_default_alpha", "QLinearLeakyRelu",
          _q(111, (3, 20), I8), 0.04, _z(3, I8), 0.05, _z(0, I8)),
    _qlun("qlgap_nchw_7x7", "QLinearGlobalAveragePool",
          _q(112, (2, 16, 7, 7), U8), 0.023, _z(0, U8), 0.02, _z(0, U8)),
    _qlun("qlgap_channels_last", "QLinearGlobalAveragePool",
          _q(113, (2, 5, 5, 8), U8), 0.05, _z(10, U8), 0.04, _z(3, U8),
          channels_last=1),
    _case("qlconcat_three_scales", "QLinearConcat", [
        ("y_scale", _s(0.05), "init"), ("y_zp", _z(128, U8), "init"),
        ("x0", _q(114, (2, 3, 4), U8), "feed"), ("s0", _s(0.02), "init"),
        ("z0", _z(128, U8), "init"),
        ("x1", _q(115, (2, 5, 4), U8), "feed"), ("s1", _s(0.07), "init"),
        ("z1", _z(90, U8), "init"),
        ("x2", _q(116, (2, 1, 4), U8), "init"), ("s2", _s(0.05), "init"),
        ("z2", _z(128, U8), "init")], axis=1),
]

# -- QGemm ----------------------------------------------------------------


def _qgemm(name, a, a_scale, a_zp, b, b_scale, b_zp, c=None, y_scale=None,
           y_zp=None, **attrs):
    ins = [("a", a, "feed"), ("a_scale", _s(a_scale), "init"),
           ("a_zp", a_zp, "init"), ("b", b, "init"),
           ("b_scale", _s(b_scale), "init"), ("b_zp", b_zp, "init")]
    if c is not None or y_scale is not None:
        ins.append(("c", c, "init") if c is not None else ("", None, ""))
    if y_scale is not None:
        ins += [("y_scale", _s(y_scale), "init"), ("y_zp", y_zp, "init")]
    return _case(name, "QGemm", ins, **attrs)


QGEMM = [
    _qgemm("qgemm_float_output", _q(120, (4, 32), U8), 0.02, _z(128, U8),
           _q(121, (32, 10), I8), 0.01, _z(0, I8)),
    _qgemm("qgemm_head_bias_requantized_transb",
           _q(122, (8, 64), U8), 0.05, _z(0, U8), _q(123, (24, 64), I8),
           np.random.default_rng(124).random(24) * 0.01 + 0.001,
           np.zeros(24, I8), c=_q(125, (24,), I32, -3000, 3000),
           y_scale=0.2, y_zp=_z(128, U8), transB=1),
    _qgemm("qgemm_alpha_per_column_b_zp_bias_float",
           _q(126, (6, 16), U8), 0.03, _z(10, U8), _q(127, (16, 8), I8),
           0.02, _q(128, (8,), I8, -4, 4), c=_q(129, (8,), I32, -100, 100),
           alpha=0.5),
    _qgemm("qgemm_transa", _q(130, (16, 5), U8), 0.02, _z(128, U8),
           _q(131, (16, 8), I8), 0.01, _z(0, I8), y_scale=0.1,
           y_zp=_z(128, U8), transA=1),
]

CASES = (MATMUL_INTEGER + DYNAMIC_QUANTIZE + CONV_INTEGER + QLINEAR_CONV
         + QLINEAR_MATMUL + ELEMENTWISE + QGEMM)

# the cases whose contraction the int8 lane takes when it serves: 2-D
# int8/uint8 matmuls of more than 16 rows with K and N multiples of 8, and
# convolutions with a zero (or absent) weight zero point whose im2col GEMM
# has more than 16 rows and a multiple of 8 output channels a group
INT8_LANE = {
    "mmi_uint8_int8_scalar_zps", "mmi_int8_no_zero_points",
    "mmi_per_row_a_zp", "mmi_per_column_b_zp",
    "mmi_uint8_weights_and_zero_points", "mmi_int8_activations_scalar_zp",
    "mmi_host_a",
    "convint_uint8_x_zp_pads", "convint_int8_no_zp_stride2",
    "convint_dilation2_group2", "convint_same_upper_even_kernel",
    "convint_asymmetric_pads", "convint_1d", "convint_3d",
    "qlconv_per_tensor_bias_pads", "qlconv_per_channel_scale",
    "qlconv_stem_7x7_stride2", "qlconv_int8_activations",
    "qlconv_group2_1x1_stride2", "qlconv_saturates_both_ends",
    "qlmm_reference_scalars", "qlmm_per_row_a_per_column_b",
    "qlmm_int8_output",
}


def by_name(name: str) -> dict:
    return next(c for c in CASES if c["name"] == name)


def agree(case: dict, got: list, want: list) -> dict:
    """``got`` against ``want`` (:func:`leaves` of two runs): the same
    outputs, host-ness, shapes and dtypes, every value bitwise. Returns
    ``{"ok", "max_abs_err", "differing"}``."""
    ok, err, differing = len(got) == len(want), 0.0, 0
    for (g, gh, gn), (w, wh, wn) in zip(got, want):
        ok &= gh == wh and g.shape == w.shape and gn == wn
        if not ok:
            break
        bits = f"u{g.itemsize}" if g.dtype.kind == "f" else g.dtype
        same = g.view(bits) == w.view(bits)
        differing += int((~same).sum())
        if g.size:
            err = max(err, float(np.abs(g.astype(np.float64)
                                        - w.astype(np.float64)).max()))
    ok &= differing == 0
    return {"ok": bool(ok), "max_abs_err": err, "differing": differing}

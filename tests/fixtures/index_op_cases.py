"""One-node graphs of the ONNX indexing and loss ops (``TopK``,
``GatherElements``, ``GatherND``, the scatters, ``OneHot``, ``Hardmax``,
``ReverseSequence``, the host-only selections and the two losses), with
their seeded inputs.

``tests/test_torch_onnx_ops_index.py`` runs each case through the JAX
package's importer and the port's on the CPU; ``chip_smoke.py`` and
``tests/test_torch_cuda.py`` run the port on the card against the port on
the CPU (:func:`run`, :func:`agree`). The cases hold every edge the
reference settles without refusing an index: a negative index wraps, then
``GatherElements`` fills past the end, ``GatherND`` clamps, the scatters
drop the update; ``OneHot`` gives a row all off for an index outside
``[0, depth)``; ``TopK`` puts the lower index first among ties and ranks a
positive NaN highest; ``ignore_index=-100`` makes the losses NaN.

A case is a dict: ``op``, ``inputs`` (``[(name, array, where)]`` in the
node's order, ``where`` one of ``"feed"`` (a graph input: a device tensor,
or numpy under ``host``), ``"init"`` (an initializer: a parameter when
float, cast by a bf16 bind) or ``"const"`` (a Constant node: a host value
in both packages); an empty name skips an optional input), ``attrs``,
``opset``, ``n_out``, ``cast`` (``"bfloat16"`` binds with that
``cast_dtype``: the way a bf16 tensor reaches an op without a numpy
bfloat16), ``host`` (feeds numpy), ``exact`` (the card equals the CPU
bitwise; otherwise within ``tol``, see :func:`agree`) and ``raises``
(the exception the op refuses a device tensor with,
``NotImplementedError``).

This module imports the port (its ``GraphBuilder``) and no JAX.
"""
import numpy as np

from synapseml_tpu_torch.onnx import GraphBuilder

F32, I64, I32 = np.float32, np.int64, np.int32
EPS32 = float(np.finfo(np.float32).eps)
LOSS_TOL = 1e-5       # float32 losses: rtol=atol, card against CPU, port against JAX


def _x(seed, *shape, dtype=F32):
    return np.random.default_rng(seed).standard_normal(shape).astype(dtype)


def _i(seed, lo, hi, *shape, dtype=I64):
    return np.random.default_rng(seed).integers(lo, hi, shape).astype(dtype)


def _case(name, op, inputs, opset=17, n_out=1, cast=None, host=False,
          exact=True, raises=None, tol=None, **attrs):
    return dict(name=name, op=op, inputs=inputs, opset=opset, n_out=n_out,
                cast=cast, host=host, exact=exact, raises=raises, tol=tol,
                attrs=attrs)


def _row_ties(seed: int, rows: int, width: int) -> np.ndarray:
    """Logits rows cut to 3 mantissa bits, so bf16 holds them exactly and
    the largest values tie many times over; stored as float32."""
    x = _x(seed, rows, width) * 4
    return (x.view(np.uint32) & np.uint32(0xFFF00000)).view(F32)


# the edges of TopK's order: +/-NaN, +/-inf, +/-0 and ties
_EDGES = np.array([[1.0, np.nan, 3.0, 3.0, -np.inf, -np.nan, 0.0, -0.0,
                    np.inf, 3.0, -1.0, -0.0]], F32)
_NLL_T = np.array([0, 3, -100, 1, 2], I64)
_GE_X = np.arange(12, dtype=F32).reshape(3, 4)
_GE_PAST = np.array([[0, -1, 4, -5, 9], [3, -4, 2, 7, -2],
                     [1, 1, -9, 0, 4]], I64)

CASES = [
    # -- Size, EyeLike, CastLike: host constants and a cast -------------
    _case("size_device", "Size", [("x", _x(0, 2, 3, 4), "feed")]),
    _case("size_host", "Size", [("x", np.zeros((5, 2), I64), "const")]),
    _case("eye_like_dtype_k", "EyeLike", [("x", _x(1, 3, 4), "feed")],
          dtype=7, k=1),
    _case("eye_like_int32_k_neg", "EyeLike",
          [("x", _i(2, 0, 5, 4, 3, dtype=I32), "feed")], k=-1),
    _case("eye_like_host_float64", "EyeLike",
          [("x", np.zeros((2, 3)), "const")]),
    _case("cast_like_device_to_int32", "CastLike",
          [("x", _x(3, 2, 5) * 10, "feed"), ("l", np.zeros(1, I32), "const")]),
    _case("cast_like_device_like", "CastLike",
          [("x", _i(4, -9, 9, 6), "feed"), ("l", _x(5, 2), "feed")]),
    _case("cast_like_host", "CastLike",
          [("x", np.array([1, -2, 7], I64), "const"),
           ("l", np.zeros(2, F32), "const")]),
    _case("cast_like_bf16_like", "CastLike",
          [("x", _x(6, 3, 4), "feed"), ("l", _x(7, 2), "init")],
          cast="bfloat16"),
    # -- GatherElements: wraps, fills past the end ----------------------
    _case("gather_elements_axis1", "GatherElements",
          [("x", _x(8, 3, 4), "feed"), ("i", _i(9, -4, 4, 3, 5), "feed")],
          axis=1),
    _case("gather_elements_axis0_int32", "GatherElements",
          [("x", _i(10, -50, 50, 4, 3, dtype=I32), "feed"),
           ("i", _i(11, -4, 4, 2, 3, dtype=I32), "feed")], axis=0),
    _case("gather_elements_past_end_fills_nan", "GatherElements",
          [("x", _GE_X, "feed"), ("i", _GE_PAST, "feed")], axis=1),
    _case("gather_elements_past_end_fills_int64", "GatherElements",
          [("x", _GE_X.astype(I64), "feed"), ("i", _GE_PAST, "feed")],
          axis=-1),
    _case("gather_elements_past_end_fills_int32", "GatherElements",
          [("x", _GE_X.astype(I32), "feed"), ("i", _GE_PAST, "feed")],
          axis=1),
    _case("gather_elements_past_end_fills_uint8", "GatherElements",
          [("x", _GE_X.astype(np.uint8), "feed"), ("i", _GE_PAST, "feed")],
          axis=1),
    _case("gather_elements_past_end_fills_bool", "GatherElements",
          [("x", _GE_X > 5, "feed"), ("i", _GE_PAST, "feed")], axis=1),
    _case("gather_elements_bf16_past_end", "GatherElements",
          [("x", _x(12, 3, 4), "init"), ("i", _GE_PAST, "feed")], axis=1,
          cast="bfloat16"),
    _case("gather_elements_host_index", "GatherElements",
          [("x", _x(13, 2, 6), "feed"),
           ("i", np.array([[5, -1, 6], [0, -7, 2]], I64), "const")], axis=1),
    # -- GatherND: wraps, then clamps into each axis --------------------
    _case("gather_nd_elements", "GatherND",
          [("x", _x(14, 3, 4), "feed"),
           ("i", np.array([[1, 2], [0, -1], [2, 0]], I64), "feed")]),
    _case("gather_nd_slices", "GatherND",
          [("x", _x(15, 3, 4, 5), "feed"),
           ("i", np.array([[[2], [0]], [[-1], [1]]], I64), "feed")]),
    _case("gather_nd_past_end_clamps", "GatherND",
          [("x", _GE_X, "feed"),
           ("i", np.array([[5, 1], [-1, 9], [-7, -9], [3, -5]], I64),
            "feed")]),
    _case("gather_nd_batch_dims1", "GatherND",
          [("x", _x(16, 2, 5, 6), "feed"),
           ("i", np.array([[[4], [0], [-2]], [[7], [-6], [1]]], I64),
            "feed")], batch_dims=1),
    _case("gather_nd_batch_dims2", "GatherND",
          [("x", _x(17, 2, 3, 4, 5), "feed"),
           ("i", _i(18, -5, 6, 2, 3, 2, 1), "feed")], batch_dims=2),
    _case("gather_nd_batch_dims1_elements_int64", "GatherND",
          [("x", _i(19, -99, 99, 3, 4, 5), "feed"),
           ("i", _i(20, -6, 7, 3, 2, 2), "feed")], batch_dims=1),
    _case("gather_nd_bf16", "GatherND",
          [("x", _x(21, 4, 6), "init"),
           ("i", np.array([[3], [-1], [9]], I64), "feed")],
          cast="bfloat16"),
    # -- ScatterND: every reduction; drops past the end -----------------
    _case("scatter_nd_rows", "ScatterND",
          [("d", _x(22, 4, 5), "feed"),
           ("i", np.array([[1], [3]], I64), "feed"),
           ("u", _x(23, 2, 5), "feed")]),
    _case("scatter_nd_elements_negative", "ScatterND",
          [("d", _x(24, 3, 4), "feed"),
           ("i", np.array([[0, 1], [2, 3], [-1, -2]], I64), "feed"),
           ("u", _x(25, 3), "feed")]),
    _case("scatter_nd_past_end_dropped", "ScatterND",
          [("d", _x(26, 5, 3), "feed"),
           ("i", np.array([[5], [-5], [-6], [2], [9]], I64), "feed"),
           ("u", _x(27, 5, 3), "feed")]),
    _case("scatter_nd_add_duplicates", "ScatterND",
          [("d", _x(28, 4, 3), "feed"),
           ("i", np.array([[1], [1], [3], [-3], [7]], I64), "feed"),
           ("u", _x(29, 5, 3), "feed")], reduction="add", exact=False,
          tol="sum"),
    _case("scatter_nd_add_duplicates_int32", "ScatterND",
          [("d", _i(30, -9, 9, 6, dtype=I32), "feed"),
           ("i", np.array([[2], [2], [0], [-4], [6]], I64), "feed"),
           ("u", _i(31, -9, 9, 5, dtype=I32), "feed")], reduction="add"),
    _case("scatter_nd_mul_duplicates_int64", "ScatterND",
          [("d", _i(32, 1, 5, 3, 2), "feed"),
           ("i", np.array([[0], [0], [2], [3]], I64), "feed"),
           ("u", _i(33, -3, 4, 4, 2), "feed")], reduction="mul"),
    _case("scatter_nd_min_duplicates", "ScatterND",
          [("d", _x(34, 4, 2), "feed"),
           ("i", np.array([[1], [1], [0], [-1], [4]], I64), "feed"),
           ("u", _x(35, 5, 2), "feed")], reduction="min"),
    _case("scatter_nd_max_duplicates", "ScatterND",
          [("d", _x(36, 4, 2), "feed"),
           ("i", np.array([[1], [1], [0], [-1], [-5]], I64), "feed"),
           ("u", _x(37, 5, 2), "feed")], reduction="max"),
    _case("scatter_nd_tokens_int64", "ScatterND",
          [("d", _i(38, 0, 100, 2, 6), "feed"),
           ("i", np.array([[[0, 1], [0, 4], [0, 5]], [[1, 0], [1, 2],
                                                    [1, -1]]], I64), "feed"),
           ("u", _i(39, 100, 200, 2, 3), "feed")]),
    _case("scatter_nd_bf16", "ScatterND",
          [("d", _x(40, 4, 3), "init"),
           ("i", np.array([[2], [0], [5]], I64), "feed"),
           ("u", _x(41, 3, 3), "init")], cast="bfloat16"),
    _case("scatter_nd_host_add", "ScatterND",
          [("d", np.arange(6, dtype=I64), "const"),
           ("i", np.array([[1], [1], [-1]], I64), "const"),
           ("u", np.array([5, 7, 9], I64), "const")], reduction="add",
          host=True),
    _case("scatter_nd_host_set", "ScatterND",
          [("d", np.arange(6, dtype=I64).reshape(2, 3), "const"),
           ("i", np.array([[1, 0]], I64), "const"),
           ("u", np.array([40], I64), "const")], host=True),
    # -- ScatterElements / Scatter: add and mul read, others set ---------
    _case("scatter_elements_axis0", "ScatterElements",
          [("d", np.zeros((3, 3), F32), "feed"),
           ("i", np.array([[1, 0, 2], [0, 2, 1]], I64), "feed"),
           ("u", _x(42, 2, 3), "feed")]),
    _case("scatter_elements_axis1_negative_past_end", "ScatterElements",
          [("d", _x(43, 2, 4), "feed"),
           ("i", np.array([[-1, 4, 0], [-5, 2, -4]], I64), "feed"),
           ("u", _x(44, 2, 3), "feed")], axis=1),
    _case("scatter_elements_add_duplicates", "ScatterElements",
          [("d", _x(45, 2, 4), "feed"),
           ("i", np.array([[1, 1, 1], [3, -1, 0]], I64), "feed"),
           ("u", _x(46, 2, 3), "feed")], axis=1, reduction="add",
          exact=False, tol="sum"),
    _case("scatter_elements_mul_duplicates_int32", "ScatterElements",
          [("d", _i(47, 1, 4, 3, 2, dtype=I32), "feed"),
           ("i", np.array([[0, 1], [0, 1], [2, 0]], I64), "feed"),
           ("u", _i(48, -3, 4, 3, 2, dtype=I32), "feed")],
          reduction="mul"),
    _case("scatter_elements_min_sets", "ScatterElements",
          [("d", _x(49, 3, 3), "feed"),
           ("i", np.array([[2, 0, 1]], I64), "feed"),
           ("u", _x(50, 1, 3) + 5, "feed")], reduction="min"),
    _case("scatter_elements_max_sets", "ScatterElements",
          [("d", _x(51, 3, 3), "feed"),
           ("i", np.array([[2, 0, 1]], I64), "feed"),
           ("u", _x(52, 1, 3) - 5, "feed")], reduction="max"),
    _case("scatter_elements_bf16", "ScatterElements",
          [("d", _x(53, 3, 4), "init"),
           ("i", np.array([[3, -1, 0, 1]], I64), "feed"),
           ("u", _x(54, 1, 4), "init")], axis=0, cast="bfloat16"),
    _case("scatter_opset9", "Scatter",
          [("d", _x(55, 3, 4), "feed"),
           ("i", np.array([[1, 3], [-1, 0]], I64), "feed"),
           ("u", _x(56, 2, 2), "feed")], opset=9, axis=1),
    # -- OneHot: compared with arange(depth) ----------------------------
    _case("one_hot_negative_and_past_end", "OneHot",
          [("i", np.array([-1, 0, 3, 5, 2, -4], I64), "feed"),
           ("d", np.array(4, I64), "const"),
           ("v", np.array([0, 1], F32), "const")]),
    _case("one_hot_axis0_int64_values", "OneHot",
          [("i", np.array([[1, 2], [0, -1]], I32), "feed"),
           ("d", np.array([3], I64), "const"),
           ("v", np.array([2, 7], I64), "const")], axis=0),
    _case("one_hot_float_indices_float64_values", "OneHot",
          [("i", np.array([0.0, 2.7, 2.0, -1.0], F32), "feed"),
           ("d", np.array(3, I32), "const"),
           ("v", np.array([0.1, 5.3]), "const")], axis=-1),
    _case("one_hot_device_values", "OneHot",
          [("i", np.array([[3, 1], [7, 0]], I64), "feed"),
           ("d", np.array(5, I64), "const"),
           ("v", np.array([-1.5, 2.25], F32), "feed")], axis=1),
    # -- Hardmax: the first maximum, the first NaN ----------------------
    _case("hardmax_ties_nan", "Hardmax",
          [("x", np.array([[1, 3, 3, 0], [2, np.nan, 5, np.nan],
                           [-0.0, 0.0, -1, -2]], F32), "feed")]),
    _case("hardmax_opset11_default_axis", "Hardmax",
          [("x", np.round(_x(57, 2, 3, 4)), "feed")], opset=11),
    _case("hardmax_bf16", "Hardmax", [("x", _row_ties(58, 3, 16), "init")],
          cast="bfloat16", axis=1),
    _case("hardmax_int32", "Hardmax",
          [("x", _i(59, 0, 3, 3, 5, dtype=I32), "feed")]),
    # -- TopK: total order, lower index first ---------------------------
    _case("topk_edges_largest", "TopK",
          [("x", _EDGES, "feed"), ("k", np.array([12], I64), "const")],
          n_out=2),
    _case("topk_edges_smallest", "TopK",
          [("x", _EDGES, "feed"), ("k", np.array([12], I64), "const")],
          n_out=2, largest=0),
    _case("topk_ties_axis0", "TopK",
          [("x", np.round(_x(60, 9, 3)), "feed"),
           ("k", np.array([4], I64), "const")], n_out=2, axis=0),
    _case("topk_opset9_attribute", "TopK",
          [("x", np.round(_x(61, 2, 10) * 2), "feed")], n_out=2, opset=9,
          k=3),
    _case("topk_int32_ties", "TopK",
          [("x", _i(62, 0, 4, 3, 9, dtype=I32), "feed"),
           ("k", np.array([5], I64), "const")], n_out=2),
    _case("topk_int64_smallest", "TopK",
          [("x", _i(63, -5, 5, 2, 8), "feed"),
           ("k", np.array([3], I64), "const")], n_out=2, largest=0),
    _case("topk_bf16_ties", "TopK",
          [("x", _row_ties(64, 8, 512), "init"),
           ("k", np.array([5], I64), "const")], n_out=2, cast="bfloat16"),
    _case("topk_bf16_ties_smallest", "TopK",
          [("x", _row_ties(65, 8, 512), "init"),
           ("k", np.array([7], I64), "const")], n_out=2, cast="bfloat16",
          largest=0),
    # -- ReverseSequence: a length past the time axis fills -------------
    _case("reverse_sequence_time0", "ReverseSequence",
          [("x", _x(66, 4, 2, 3), "feed"),
           ("l", np.array([4, 2], I64), "feed")]),
    _case("reverse_sequence_batch0_past_end", "ReverseSequence",
          [("x", _x(67, 2, 3, 2), "feed"),
           ("l", np.array([5, 1], I64), "feed")], batch_axis=0, time_axis=1),
    _case("reverse_sequence_int64_past_end", "ReverseSequence",
          [("x", _i(68, 0, 50, 3, 2), "feed"),
           ("l", np.array([3, 4], I64), "const")]),
    # -- NonZero, Unique, Compress: host values only --------------------
    _case("non_zero_host", "NonZero",
          [("x", np.array([[0, 2, 0], [1, 0, 3]], I64), "const")],
          host=True),
    _case("non_zero_device_raises", "NonZero",
          [("x", _x(69, 2, 3), "feed")], raises=NotImplementedError),
    _case("unique_sorted_host", "Unique",
          [("x", np.array([2, 1, 1, 3, 4, 3], I64), "const")], n_out=4,
          host=True),
    _case("unique_unsorted_host", "Unique",
          [("x", np.array([2, 1, 1, 3, 4, 3], I64), "const")], n_out=4,
          host=True, sorted=0),
    _case("unique_axis0_host", "Unique",
          [("x", np.array([[1, 0], [1, 0], [2, 3]], F32), "const")],
          n_out=4, host=True, axis=0, sorted=0),
    _case("unique_device_raises", "Unique", [("x", _x(70, 6), "feed")],
          raises=NotImplementedError),
    _case("compress_host", "Compress",
          [("x", np.arange(6, dtype=F32).reshape(2, 3), "const"),
           ("c", np.array([True, False, True]), "const")], host=True,
          axis=1),
    _case("compress_host_flat", "Compress",
          [("x", np.arange(6, dtype=I64).reshape(2, 3), "const"),
           ("c", np.array([0, 1, 1, 0, 1], I64), "const")], host=True),
    _case("compress_device_raises", "Compress",
          [("x", _x(71, 2, 3), "feed"),
           ("c", np.array([True, False]), "const")], raises=NotImplementedError, axis=0),
    # -- NegativeLogLikelihoodLoss, SoftmaxCrossEntropyLoss -------------
    _case("nll_mean", "NegativeLogLikelihoodLoss",
          [("x", _x(72, 5, 4), "feed"), ("t", _i(73, 0, 4, 5), "feed")],
          exact=False, tol="loss"),
    _case("nll_weight_ignore_sum", "NegativeLogLikelihoodLoss",
          [("x", _x(74, 6, 4), "feed"), ("t", _i(75, 0, 4, 6), "feed"),
           ("w", np.array([0.5, 1.0, 2.0, 0.25], F32), "init")],
          reduction="sum", ignore_index=3, exact=False, tol="loss"),
    _case("nll_ignore_minus100_none", "NegativeLogLikelihoodLoss",
          [("x", _x(76, 5, 4), "feed"), ("t", _NLL_T, "feed")],
          reduction="none", ignore_index=-100, exact=False, tol="loss"),
    _case("nll_ignore_minus100_mean", "NegativeLogLikelihoodLoss",
          [("x", _x(77, 5, 4), "feed"), ("t", _NLL_T, "feed")],
          ignore_index=-100, exact=False, tol="loss"),
    _case("nll_target_past_end", "NegativeLogLikelihoodLoss",
          [("x", _x(78, 4, 3), "feed"),
           ("t", np.array([0, 3, -1, -4], I64), "feed")], reduction="none",
          exact=False, tol="loss"),
    _case("nll_rank3_weight_none", "NegativeLogLikelihoodLoss",
          [("x", _x(79, 3, 4, 2), "feed"), ("t", _i(80, 0, 4, 3, 2), "feed"),
           ("w", np.array([1.0, 0.5, 3.0, 2.0], F32), "init")],
          reduction="none", exact=False, tol="loss"),
    _case("sce_mean_log_prob", "SoftmaxCrossEntropyLoss",
          [("x", _x(81, 5, 6) * 3, "feed"), ("t", _i(82, 0, 6, 5), "feed")],
          n_out=2, exact=False, tol="loss"),
    _case("sce_rank3_weight_ignore_sum", "SoftmaxCrossEntropyLoss",
          [("x", _x(83, 2, 5, 3), "feed"), ("t", _i(84, 0, 5, 2, 3), "feed"),
           ("w", np.array([1.0, 2.0, 0.5, 1.5, 1.0], F32), "init")],
          reduction="sum", ignore_index=2, exact=False, tol="loss"),
    _case("sce_ignore_minus100_mean", "SoftmaxCrossEntropyLoss",
          [("x", _x(85, 5, 4), "feed"), ("t", _NLL_T, "feed")],
          ignore_index=-100, n_out=2, exact=False, tol="loss"),
    _case("sce_ignore_minus100_none_int32_target", "SoftmaxCrossEntropyLoss",
          [("x", _x(86, 5, 4), "feed"), ("t", _NLL_T.astype(I32), "feed")],
          ignore_index=-100, reduction="none", exact=False, tol="loss"),
    _case("sce_bf16_scores", "SoftmaxCrossEntropyLoss",
          [("x", _x(87, 4, 7), "init"), ("t", _i(88, 0, 7, 4), "feed")],
          cast="bfloat16", reduction="none", exact=False, tol="loss"),
]

# the rows of the motivating table: each edge at least once
EDGE_CASES = {
    "gather_elements_negative_wraps": "gather_elements_axis1",
    "gather_elements_fills_past_end": "gather_elements_past_end_fills_nan",
    "gather_nd_clamps_past_end": "gather_nd_past_end_clamps",
    "scatter_drops_past_end": "scatter_nd_past_end_dropped",
    "scatter_elements_min_max_set": "scatter_elements_min_sets",
    "one_hot_negative_all_off": "one_hot_negative_and_past_end",
    "topk_ties_and_nan": "topk_edges_largest",
    "loss_ignore_minus100_nan": "sce_ignore_minus100_mean",
    "host_only_ops_refuse_a_device_tensor": "unique_device_raises",
}


def by_name(name: str) -> dict:
    return next(c for c in CASES if c["name"] == name)


def graph(case: dict) -> bytes:
    """The case's one-node graph."""
    g = GraphBuilder(opset=case["opset"])
    names = []
    for name, a, where in case["inputs"]:
        names.append(name)
        if not name:
            continue
        if where == "feed":
            g.add_input(name, a.dtype, list(a.shape))
        elif where == "init":
            g.add_initializer(name, a)
        else:
            g.add_node("Constant", [], outputs=[name], value=np.asarray(a))
    outs = [f"y{i}" for i in range(case["n_out"])]
    g.add_node(case["op"], names, outputs=outs, **case["attrs"])
    for o in outs:
        g.add_output(o, np.float32, None)
    return g.to_bytes()


def feeds(case: dict) -> list:
    """The graph inputs' numpy values, in order."""
    return [a for name, a, where in case["inputs"]
            if name and where == "feed"]


def run(case: dict, device: str) -> list:
    """The port's outputs of the case on ``device``, each as numpy (a
    bf16 tensor widened to float32, exactly), with whether each was a host
    value. A refusal propagates."""
    import torch

    from synapseml_tpu_torch.onnx import import_model

    fn = import_model(graph(case)).bind(
        cast_dtype=getattr(torch, case["cast"]) if case["cast"] else None,
        device=device)
    args = feeds(case)
    if not case["host"]:
        args = [torch.from_numpy(np.ascontiguousarray(a)).to(device)
                for a in args]
    out = []
    for v in fn(*args):
        if isinstance(v, torch.Tensor):
            v = v.float() if v.dtype == torch.bfloat16 else v
            out.append((v.cpu().numpy(), False))
        else:
            out.append((np.asarray(v), True))
    return out


def tolerance(case: dict) -> float:
    """The bound on one output value between two runs of the case. A loss:
    ``LOSS_TOL`` (rtol=atol). A scatter-add of float32 updates with
    duplicate indices (added in no fixed order on the card): a sum of m
    terms taken in any order is within (m - 1) * eps32 * sum|terms| of the
    exact sum, here m counted as every update plus the data value."""
    if case["tol"] == "loss":
        return LOSS_TOL
    upd = [a for name, a, _ in case["inputs"] if name == "u"][0]
    data = [a for name, a, _ in case["inputs"] if name == "d"][0]
    return 2 * len(upd) * EPS32 * float(np.abs(data).max()
                                        + np.abs(upd).sum())


def agree(case: dict, got: list, want: list) -> dict:
    """``got`` against ``want`` (lists of :func:`run`): bitwise (a NaN's
    sign and payload too) where the case is ``exact``, else within
    :func:`tolerance` with NaN where NaN is;
    the same host/device kind and dtype. Returns ``{"ok", "max_abs_err"}``."""
    ok, err = len(got) == len(want), 0.0
    for (g, g_host), (w, w_host) in zip(got, want):
        ok &= g_host == w_host and g.dtype == w.dtype and g.shape == w.shape
        if not ok:
            break
        if case["exact"]:
            bits = f"u{g.itemsize}" if g.dtype.kind == "f" else g.dtype
            ok &= bool(np.array_equal(g.view(bits), w.view(bits)))
        else:
            tol = tolerance(case)
            rel = LOSS_TOL if case["tol"] == "loss" else 0.0
            ok &= bool(np.allclose(g, w, rtol=rel, atol=tol, equal_nan=True))
        if g.size and g.dtype.kind in "fiu":
            with np.errstate(invalid="ignore"):    # inf - inf, NaN
                d = np.abs(g.astype(np.float64) - w.astype(np.float64))
            d = d[~np.isnan(d)]
            err = max(err, float(d.max()) if d.size else 0.0)
    return {"ok": bool(ok), "max_abs_err": err}

"""One-node graphs of the ONNX sampling and detection ops
(``NonMaxSuppression``, ``RoiAlign``, ``MaxRoiPool``, ``DeformConv``,
``GridSample``, ``AffineGrid``, ``ImageDecoder``), with their seeded
inputs.

``tests/test_torch_onnx_ops_detection.py`` runs each case through the JAX
package's importer and the port's on the CPU (the reference eagerly on host
inputs, under ``jax.jit`` on device inputs); ``chip_smoke.py`` and
``tests/test_torch_cuda.py`` run the port on the card against the port on
the CPU (:func:`run`, :func:`agree`), all but ``ImageDecoder``, which runs
on the host only (:data:`CARD_CASES`). The cases hold the reference's own
choices: NMS's host path (a stable argsort, ``inter / union > iou``)
beside its fixed-capacity device path (``inter > iou * union``, ``-1``
rows, the first index on score ties, a NaN score ending its class), boxes
within an ulp of the IoU threshold, zero-area boxes; RoiAlign's
``output_half_pixel`` 1-pixel clamp and ``max`` of bilinear samples;
MaxRoiPool's half-to-even rounding and empty bins; rois, offsets and grids
partly outside, NaN and 1e10 coordinates, batch indices of -1 and N + 2;
GridSample's half-away-from-zero ``nearest`` and integer rounding; the
refusals, which raise in both packages.

A case is a dict as in ``vision_op_cases.py``: ``op``, ``inputs``
(``[(name, array, where)]``, ``where`` one of ``"feed"``, ``"init"``,
``"const"``; an empty name skips an optional input), ``attrs``, ``opset``,
``host`` (feeds numpy), ``exact`` (equal bitwise, card against CPU and
port against reference), ``tol`` (otherwise: within ``tol`` of the largest
|value|, at least ``tol``, against the reference), ``raises`` and ``jit``
(the reference's device run goes through ``jax.jit`` as well as its eager
bound forward; off where the result is a host value in both packages, and
for MaxRoiPool, whose bin edges XLA rounds otherwise under ``jit``: it
divides by the bin count as a multiply by its reciprocal).

This module imports neither package nor PIL: :func:`graph` takes either
package's ``GraphBuilder``, :func:`run` the port's ``import_model``; the
encoded images are written here with ``zlib``.
"""
import struct
import zlib

import numpy as np

F32, I64, I32, U8 = np.float32, np.int64, np.int32, np.uint8
SAMPLE_TOL = 1e-5     # RoiAlign, GridSample, DeformConv against the reference
GRID_TOL = 1e-6       # AffineGrid against the reference
CARD_TOL = 2e-5       # every inexact case, the card against the CPU


def _x(seed, *shape, dtype=F32):
    return np.random.default_rng(seed).standard_normal(shape).astype(dtype)


def _u(seed, lo, hi, *shape):
    return np.random.default_rng(seed).uniform(lo, hi, shape).astype(F32)


def _case(name, op, inputs, opset=17, host=False, exact=True, tol=None,
          raises=None, jit=True, **attrs):
    return dict(name=name, op=op, inputs=inputs, opset=opset, n_out=1,
                host=host, exact=exact, tol=tol, raises=raises, jit=jit,
                attrs=attrs)


# -- NonMaxSuppression ----------------------------------------------------

def _boxes(seed, b, n, lo=5.0, hi=40.0, flip=False):
    """``[b, n, 4]`` (y1, x1, y2, x2) boxes in a 100 x 100 frame, some in
    clusters so that they overlap; ``flip`` swaps the diagonal of half."""
    rng = np.random.default_rng(seed)
    centre = rng.uniform(20, 80, (b, max(1, n // 4), 2))
    pick = rng.integers(0, centre.shape[1], (b, n))
    c = np.take_along_axis(centre, pick[..., None], 1) + rng.normal(0, 4, (b, n, 2))
    size = rng.uniform(lo, hi, (b, n, 2))
    out = np.concatenate([c - size / 2, c + size / 2], -1).astype(F32)
    if flip:
        out[:, ::2] = out[:, ::2][..., [2, 3, 0, 1]]
    return out


def _nms(name, boxes, scores, max_out=None, iou=None, score=None,
         host=False, jit=True, **attrs):
    inputs = [("boxes", boxes, "feed"), ("scores", scores, "feed"),
              ("max_out", np.array([max_out], I64), "init")
              if max_out is not None else ("", None, ""),
              ("iou", np.array([iou], F32), "init")
              if iou is not None else ("", None, ""),
              ("score", np.array([score], F32), "init")
              if score is not None else ("", None, "")]
    while not inputs[-1][0]:
        inputs.pop()
    return _case(name, "NonMaxSuppression", inputs, opset=11, host=host,
                 jit=jit, **attrs)


def near_threshold_pairs(n_pairs: int, iou: float = 0.5, seed: int = 7):
    """``[n_pairs, 2, 4]`` box pairs (same size, shifted along x) whose IoU
    lies within an ulp of ``iou``, chosen where the device test ``inter >
    iou * union`` decides differently with ``union`` rounded once from
    float64 (an FMA) than with each product and sum rounded to float32:
    which way each pair goes tells the two forms apart."""
    rng = np.random.default_rng(seed)
    m = 200_000
    y1, x1 = rng.uniform(0, 100, m).astype(F32), rng.uniform(0, 100, m).astype(F32)
    h, w = rng.uniform(1, 50, m).astype(F32), rng.uniform(1, 50, m).astype(F32)
    shift = (w / F32(3) * (1 + rng.uniform(-3e-7, 3e-7, m))).astype(F32)
    a = np.stack([y1, x1, y1 + h, x1 + w], 1).astype(F32)
    b = np.stack([y1, x1 + shift, y1 + h, x1 + w + shift], 1).astype(F32)
    area_a = ((a[:, 2] - a[:, 0]) * (a[:, 3] - a[:, 1])).astype(F32)
    area_b = ((b[:, 2] - b[:, 0]) * (b[:, 3] - b[:, 1])).astype(F32)
    p = np.maximum(np.minimum(a[:, 2], b[:, 2]) - np.maximum(a[:, 0], b[:, 0]), F32(0))
    q = np.maximum(np.minimum(a[:, 3], b[:, 3]) - np.maximum(a[:, 1], b[:, 1]), F32(0))
    inter = (p * q).astype(F32)
    total = (area_b + area_a).astype(F32)
    plain = (total - inter).astype(F32)
    fused = (total.astype(np.float64) - p.astype(np.float64) * q).astype(F32)
    thr = F32(iou)
    differ = np.flatnonzero((inter > thr * plain) != (inter > thr * fused))
    return np.stack([a[differ[:n_pairs]], b[differ[:n_pairs]]], 1)


def _scores(seed, b, c, n):
    return _u(seed, 0, 1, b, c, n)


_TIES = np.random.default_rng(11).integers(0, 4, (1, 2, 24)).astype(F32)
_NAN_SCORES = _scores(12, 1, 3, 16)
_NAN_SCORES[0, 0, 5] = np.nan          # a live NaN ends class 0 at once
_NAN_SCORES[0, 1, 9] = np.nan
_NAN_SCORES[0, 1, 9 - 1] = 2.0         # class 1 picks box 8 before its NaN
_ZERO_AREA = _boxes(13, 1, 12)
_ZERO_AREA[0, :4, 2] = _ZERO_AREA[0, :4, 0]        # four boxes of height 0
_ZERO_AREA[0, 4:6] = _ZERO_AREA[0, 3]              # three equal, of area 0
_NEAR = near_threshold_pairs(24)
_NEAR_SCORES = np.tile(np.array([[[0.9, 0.8]]], F32), (len(_NEAR), 1, 1))
_NEG_INF = _scores(14, 1, 2, 10)
_NEG_INF[0, 0, ::2] = -np.inf
_NEG_INF[0, 1, :] = -np.inf

NMS_CASES = [
    _nms("nms_one_class", _boxes(1, 1, 20), _scores(2, 1, 1, 20), 10, 0.5),
    _nms("nms_one_class_host", _boxes(1, 1, 20), _scores(2, 1, 1, 20), 10,
         0.5, host=True),
    _nms("nms_batches_classes_score_threshold", _boxes(3, 2, 16),
         _scores(4, 2, 3, 16), 5, 0.4, 0.3),
    _nms("nms_batches_classes_score_threshold_host", _boxes(3, 2, 16),
         _scores(4, 2, 3, 16), 5, 0.4, 0.3, host=True),
    _nms("nms_center_point_box", _boxes(5, 1, 16, flip=False)
         [..., [1, 0, 3, 2]] % 50 + 10, _scores(6, 1, 2, 16), 6, 0.3,
         center_point_box=1),
    _nms("nms_center_point_box_host", _boxes(5, 1, 16)[..., [1, 0, 3, 2]]
         % 50 + 10, _scores(6, 1, 2, 16), 6, 0.3, host=True,
         center_point_box=1),
    _nms("nms_flipped_corners", _boxes(7, 1, 18, flip=True),
         _scores(8, 1, 1, 18), 8, 0.45),
    _nms("nms_score_ties_first_index", _boxes(9, 1, 24), _TIES, 12, 0.5),
    _nms("nms_score_ties_host", _boxes(9, 1, 24), _TIES, 12, 0.5, host=True),
    _nms("nms_nan_score_ends_the_class", _boxes(10, 1, 16), _NAN_SCORES, 6,
         0.5),
    _nms("nms_nan_score_dropped_by_the_threshold", _boxes(10, 1, 16),
         _NAN_SCORES, 6, 0.5, 0.2),
    _nms("nms_nan_score_host", _boxes(10, 1, 16), _NAN_SCORES, 6, 0.5,
         host=True),
    _nms("nms_zero_area_boxes", _ZERO_AREA, _scores(15, 1, 1, 12), 12, 0.3),
    _nms("nms_zero_area_boxes_host", _ZERO_AREA, _scores(15, 1, 1, 12), 12,
         0.3, host=True),
    _nms("nms_iou_within_an_ulp_of_the_threshold", _NEAR, _NEAR_SCORES, 2,
         0.5),
    _nms("nms_iou_within_an_ulp_of_the_threshold_host", _NEAR, _NEAR_SCORES,
         2, 0.5, host=True),
    _nms("nms_max_out_past_the_boxes", _boxes(16, 2, 6), _scores(17, 2, 2, 6),
         15, 0.5),
    _nms("nms_no_iou_threshold", _boxes(18, 1, 12), _scores(19, 1, 1, 12), 12),
    _nms("nms_neg_inf_scores", _boxes(20, 1, 10), _NEG_INF, 10, 0.5),
    _nms("nms_max_out_absent", _boxes(21, 1, 5), _scores(22, 1, 1, 5),
         jit=False),
    _nms("nms_max_out_zero", _boxes(21, 1, 5), _scores(22, 1, 1, 5), 0, 0.5,
         jit=False),
]

# -- RoiAlign -------------------------------------------------------------


def _rois(seed, r, size_hw, lo=2.0, hi=None):
    """``[r, 4]`` (x1, y1, x2, y2) rois inside an image of ``size_hw``."""
    rng = np.random.default_rng(seed)
    h, w = size_hw
    hi = hi or min(h, w) / 2
    wh = rng.uniform(lo, hi, (r, 2))
    x1 = rng.uniform(0, w - wh[:, 0])
    y1 = rng.uniform(0, h - wh[:, 1])
    return np.stack([x1, y1, x1 + wh[:, 0], y1 + wh[:, 1]], 1).astype(F32)


def _roi_align(name, x, rois, bidx, opset=16, raises=None, **attrs):
    return _case(name, "RoiAlign",
                 [("x", x, "feed"), ("rois", rois, "feed"),
                  ("batch_indices", bidx, "feed")], opset=opset, exact=False,
                 tol=SAMPLE_TOL, raises=raises, **attrs)


_OUTSIDE = np.array([[-6, -3, 4, 5], [10, 12, 30, 26], [-20, -20, -2, -1],
                     [5, 0, 13, 16]], F32)
_BAD_ROIS = np.array([[np.nan, 1, 6, 7], [1e10, 2, 1e10, 9],
                      [-1e10, -1e10, 3, 4], [2, 3, 8, 9]], F32)
_TINY = np.array([[3.0, 4.0, 3.4, 4.2], [1, 1, 1, 1], [2, 2, 9, 3]], F32)

ROI_ALIGN_CASES = [
    _roi_align("roi_align_avg_half_pixel", _x(30, 2, 3, 12, 16),
               _rois(31, 6, (24, 32)), np.array([0, 1, 1, 0, 1, 0], I64),
               output_height=3, output_width=4, sampling_ratio=2,
               spatial_scale=0.5),
    _roi_align("roi_align_max_of_bilinear_samples", _x(32, 1, 4, 10, 10),
               _rois(33, 5, (10, 10)), np.zeros(5, I64), mode="max",
               output_height=2, output_width=2, sampling_ratio=3),
    _roi_align("roi_align_output_half_pixel_opset10_tiny_rois",
               _x(34, 1, 2, 8, 8), _TINY, np.zeros(3, I64), opset=10,
               output_height=2, output_width=3, sampling_ratio=2),
    _roi_align("roi_align_output_half_pixel_attribute", _x(35, 2, 3, 9, 11),
               _rois(36, 4, (18, 22)), np.array([1, 0, 1, 1], I64),
               coordinate_transformation_mode="output_half_pixel",
               output_height=2, output_width=2, sampling_ratio=1,
               spatial_scale=0.5),
    _roi_align("roi_align_partly_outside", _x(37, 1, 3, 16, 16), _OUTSIDE,
               np.zeros(4, I64), output_height=4, output_width=4,
               sampling_ratio=2),
    _roi_align("roi_align_nan_and_1e10_coordinates", _x(38, 1, 2, 10, 10),
               _BAD_ROIS, np.zeros(4, I64), output_height=2, output_width=2,
               sampling_ratio=2),
    _roi_align("roi_align_batch_index_minus_1_and_n_plus_2",
               _x(39, 3, 2, 8, 8), _rois(40, 4, (8, 8)),
               np.array([-1, 5, -4, 1], I64), output_height=2,
               output_width=2, sampling_ratio=2),
    _roi_align("roi_align_rectangular_sr3", _x(41, 1, 3, 14, 9),
               _rois(42, 3, (14, 9)), np.zeros(3, I64), output_height=3,
               output_width=5, sampling_ratio=3),
    _roi_align("roi_align_torchvision_shaped", _x(43, 1, 8, 50, 68),
               _rois(44, 16, (800, 1088), lo=224, hi=448), np.zeros(16, I64),
               coordinate_transformation_mode="output_half_pixel",
               output_height=7, output_width=7, sampling_ratio=2,
               spatial_scale=0.0625),
    _roi_align("roi_align_sampling_ratio_0_raises", _x(45, 1, 2, 6, 6),
               _rois(46, 2, (6, 6)), np.zeros(2, I64),
               raises=NotImplementedError, output_height=2, output_width=2),
]

# -- MaxRoiPool -----------------------------------------------------------


def _roi5(rois, batch):
    return np.concatenate([np.asarray(batch, F32)[:, None], rois], 1).astype(F32)


def _max_roi_pool(name, x, rois, **attrs):
    return _case(name, "MaxRoiPool", [("x", x, "feed"), ("rois", rois, "feed")],
                 opset=1, jit=False, **attrs)


_NAN_MAP = _x(50, 1, 2, 8, 8)
_NAN_MAP[0, 0, 2, 3] = np.nan
_NEG_INF_MAP = _x(51, 1, 2, 6, 6)
_NEG_INF_MAP[0, 1, :3, :3] = -np.inf
_HALF = np.array([[0.5, 2.5, 1.5, 5.5, 4.5], [1.5, 0.5, 0.5, 3.5, 3.5],
                  [2.5, 3.5, 2.5, 6.5, 7.5]], F32)

MAX_ROI_POOL_CASES = [
    _max_roi_pool("max_roi_pool_2x2", _x(52, 2, 3, 10, 12),
                  _roi5(_rois(53, 5, (10, 12)), [0, 1, 1, 0, 1]),
                  pooled_shape=[2, 2]),
    _max_roi_pool("max_roi_pool_fast_rcnn_shaped", _x(54, 1, 6, 20, 30),
                  _roi5(_rois(55, 12, (320, 480), lo=40, hi=200),
                        np.zeros(12)), pooled_shape=[7, 7],
                  spatial_scale=0.0625),
    _max_roi_pool("max_roi_pool_rounds_half_to_even", _x(56, 3, 2, 9, 9),
                  _HALF, pooled_shape=[3, 2]),
    _max_roi_pool("max_roi_pool_more_bins_than_pixels", _x(57, 1, 2, 6, 6),
                  _roi5(np.array([[1, 1, 2, 2], [0, 0, 0, 0]], F32), [0, 0]),
                  pooled_shape=[4, 3]),
    _max_roi_pool("max_roi_pool_outside_the_map_empty_bins",
                  _x(58, 1, 2, 8, 8),
                  _roi5(np.array([[5, 5, 12, 14], [20, 20, 30, 30],
                                  [-9, -9, -2, -4]], F32), [0, 0, 0]),
                  pooled_shape=[3, 3]),
    _max_roi_pool("max_roi_pool_nan_propagates", _NAN_MAP,
                  _roi5(np.array([[0, 0, 7, 7], [3, 2, 6, 7], [4, 4, 7, 7]],
                                 F32), [0, 0, 0]), pooled_shape=[2, 2]),
    _max_roi_pool("max_roi_pool_neg_inf_bin_gives_0", _NEG_INF_MAP,
                  _roi5(np.array([[0, 0, 5, 5], [0, 0, 2, 2]], F32), [0, 0]),
                  pooled_shape=[2, 2]),
    _max_roi_pool("max_roi_pool_batch_minus_1_and_n_plus_2",
                  _x(59, 3, 2, 6, 7),
                  _roi5(_rois(60, 4, (6, 7)), [-1, 5, np.nan, 1e10]),
                  pooled_shape=[2, 3]),
    _max_roi_pool("max_roi_pool_nan_and_1e10_rois", _x(61, 1, 2, 6, 6),
                  _roi5(np.array([[np.nan, 0, 4, 4], [1e10, 1, 1e10, 5],
                                  [0, 0, 3, 3]], F32), [0, 0, 0]),
                  pooled_shape=[2, 2]),
]

# -- DeformConv -----------------------------------------------------------


def _deform(name, n, c, oc, hw, k, seed, group=1, offset_group=1,
            strides=(1, 1), dilations=(1, 1), pads=(1, 1, 1, 1), mask=False,
            bias=True, spread=1.5, nan_offset=False, raises=None, x=None):
    h, w = hw
    oh = (h + pads[0] + pads[2] - dilations[0] * (k - 1) - 1) // strides[0] + 1
    ow = (w + pads[1] + pads[3] - dilations[1] * (k - 1) - 1) // strides[1] + 1
    off = _x(seed + 1, n, offset_group * k * k * 2, oh, ow) * F32(spread)
    if nan_offset:
        off[0, 0, 0, 0] = np.nan
        off[0, 1, 1, 1] = 1e10
    inputs = [("x", _x(seed, n, c, h, w) if x is None else x, "feed"),
              ("w", _x(seed + 2, oc, c // group, k, k) * F32(0.3), "init"),
              ("offset", off, "feed"),
              ("b", _x(seed + 3, oc), "init") if bias else ("", None, ""),
              ("mask", _u(seed + 4, 0, 1, n, offset_group * k * k, oh, ow),
               "feed") if mask else ("", None, "")]
    while not inputs[-1][0]:
        inputs.pop()
    return _case(name, "DeformConv", inputs, opset=19, exact=False,
                 tol=SAMPLE_TOL, raises=raises, group=group,
                 offset_group=offset_group, strides=list(strides),
                 dilations=list(dilations), pads=list(pads))


DEFORM_CASES = [
    _deform("deform_conv_3x3_bias", 2, 4, 5, (7, 8), 3, 70),
    _deform("deform_conv_v2_mask", 1, 6, 4, (6, 6), 3, 75, mask=True),
    _deform("deform_conv_groups_and_offset_groups", 1, 4, 6, (6, 7), 3, 80,
            group=2, offset_group=2, mask=True),
    _deform("deform_conv_strides_dilations_no_pads", 1, 3, 4, (11, 10), 3,
            85, strides=(2, 1), dilations=(1, 2), pads=(0, 0, 0, 0),
            bias=False),
    _deform("deform_conv_mask_without_bias", 1, 3, 2, (5, 6), 2, 90,
            pads=(0, 1, 1, 0), mask=True, bias=False),
    _deform("deform_conv_offsets_outside_nan_and_1e10", 1, 2, 3, (5, 5), 3,
            95, spread=6.0, nan_offset=True),
    _deform("deform_conv_dcnv2_shaped", 1, 16, 16, (9, 12), 3, 100,
            mask=True, bias=False),
    _deform("deform_conv_3d_input_raises", 1, 2, 2, (4, 4), 3, 105,
            raises=NotImplementedError, x=_x(105, 1, 2, 4, 4, 4)),
]

# -- GridSample -----------------------------------------------------------


def _grid(seed, n, ho, wo, spread=1.0):
    return _u(seed, -spread, spread, n, ho, wo, 2)


def _grid_sample(name, x, grid, opset=16, exact=False, raises=None, **attrs):
    return _case(name, "GridSample", [("x", x, "feed"), ("grid", grid, "feed")],
                 opset=opset, exact=exact, tol=None if exact else SAMPLE_TOL,
                 raises=raises, **attrs)


def _half_grid(n, size_hw, align):
    """A grid whose coordinates fall exactly half-way between cells (and on
    them), so ``nearest`` rounds at every tie; exact in float32 where the
    size (``align``: the size - 1) is a power of two."""
    h, w = size_hw
    ys = np.arange(-0.5, h, 0.5)[: 2 * h]
    xs = np.arange(-0.5, w, 0.5)[: 2 * w]

    def norm(c, size):
        return c * 2 / (size - 1) - 1 if align else (2 * c + 1) / size - 1

    gy, gx = np.meshgrid(norm(ys, h), norm(xs, w), indexing="ij")
    return np.broadcast_to(np.stack([gx, gy], -1), (n,) + gy.shape + (2,)).astype(F32)


_BAD_GRID = _grid(110, 1, 3, 4, 1.5)
_BAD_GRID[0, 0, 0] = [np.nan, 0.2]
_BAD_GRID[0, 0, 1] = [0.3, np.nan]
_BAD_GRID[0, 1, 1] = [1e10, -0.5]
_BAD_GRID[0, 2, 2] = [-1e10, 1e10]
_INT_MAP = np.random.default_rng(111).integers(-9, 10, (1, 2, 5, 9)).astype(I32)

GRID_SAMPLE_CASES = [
    _grid_sample("grid_sample_bilinear_zeros", _x(112, 2, 3, 6, 7),
                 _grid(113, 2, 5, 4, 1.2)),
    _grid_sample("grid_sample_bilinear_zeros_align_corners",
                 _x(114, 1, 2, 5, 5), _grid(115, 1, 6, 6, 1.2),
                 align_corners=1),
    _grid_sample("grid_sample_bilinear_border", _x(116, 2, 2, 4, 6),
                 _grid(117, 2, 3, 5, 1.5), padding_mode="border"),
    _grid_sample("grid_sample_linear_opset20_name", _x(118, 1, 2, 5, 4),
                 _grid(119, 1, 4, 4, 1.1), opset=20, mode="linear"),
    _grid_sample("grid_sample_nearest_zeros", _x(120, 2, 3, 5, 6),
                 _grid(121, 2, 4, 5, 1.3), exact=True, mode="nearest"),
    _grid_sample("grid_sample_nearest_rounds_half_away_from_zero",
                 _x(122, 1, 2, 4, 8), _half_grid(1, (4, 8), False),
                 exact=True, mode="nearest", padding_mode="border"),
    _grid_sample("grid_sample_nearest_half_align_corners",
                 _x(123, 1, 1, 5, 9), _half_grid(1, (5, 9), True),
                 exact=True, mode="nearest", align_corners=1),
    _grid_sample("grid_sample_partly_outside_zeros", _x(124, 1, 2, 6, 6),
                 _grid(125, 1, 6, 6, 2.5)),
    _grid_sample("grid_sample_nan_and_1e10_bilinear_border",
                 _x(126, 1, 2, 5, 6), _BAD_GRID, padding_mode="border"),
    _grid_sample("grid_sample_nan_and_1e10_bilinear_zeros",
                 _x(127, 1, 2, 5, 6), _BAD_GRID),
    _grid_sample("grid_sample_nan_reads_the_corner_nearest",
                 _x(128, 1, 2, 5, 6), _BAD_GRID, exact=True,
                 mode="nearest", padding_mode="border"),
    _grid_sample("grid_sample_int32_rounds_half_away_from_zero", _INT_MAP,
                 _half_grid(1, (5, 9), True), exact=True, align_corners=1),
    _grid_sample("grid_sample_bicubic_raises", _x(129, 1, 1, 4, 4),
                 _grid(130, 1, 2, 2), mode="bicubic",
                 raises=NotImplementedError),
    _grid_sample("grid_sample_reflection_raises", _x(131, 1, 1, 4, 4),
                 _grid(132, 1, 2, 2), padding_mode="reflection",
                 raises=NotImplementedError),
    _grid_sample("grid_sample_5d_raises", _x(133, 1, 1, 3, 4, 4),
                 _u(134, -1, 1, 1, 2, 2, 2, 3), opset=20,
                 raises=NotImplementedError),
]

# -- AffineGrid -----------------------------------------------------------


def _affine(name, theta, size, raises=None, **attrs):
    return _case(name, "AffineGrid",
                 [("theta", theta, "feed"),
                  ("size", np.array(size, I64), "init")], opset=20,
                 exact=False, tol=GRID_TOL, raises=raises, **attrs)


AFFINE_CASES = [
    _affine("affine_grid_2d", _x(140, 2, 2, 3), [2, 3, 5, 7]),
    _affine("affine_grid_2d_align_corners", _x(141, 2, 2, 3), [2, 1, 6, 4],
            align_corners=1),
    _affine("affine_grid_3d", _x(142, 1, 3, 4), [1, 2, 3, 4, 5]),
    _affine("affine_grid_3d_align_corners", _x(143, 2, 3, 4), [2, 1, 4, 3, 6],
            align_corners=1),
    _affine("affine_grid_axis_of_one_point", _x(144, 1, 2, 3), [1, 1, 1, 5],
            align_corners=1),
    _affine("affine_grid_published_spatial_transformer", _x(145, 1, 2, 3),
            [1, 1, 28, 28]),
    _affine("affine_grid_1d_size_raises", _x(146, 1, 1, 2), [1, 1, 4],
            raises=NotImplementedError),
]

# -- ImageDecoder (host only) ---------------------------------------------


def png(img: np.ndarray) -> bytes:
    """``img`` ``[H, W, C]`` uint8 (C of 1, 3 or 4) as a PNG, filter 0."""
    h, w, c = img.shape
    raw = b"".join(b"\x00" + img[y].tobytes() for y in range(h))

    def chunk(tag, data):
        return (struct.pack(">I", len(data)) + tag + data
                + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF))

    return (b"\x89PNG\r\n\x1a\n"
            + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8,
                                         {1: 0, 3: 2, 4: 6}[c], 0, 0, 0))
            + chunk(b"IDAT", zlib.compress(raw)) + chunk(b"IEND", b""))


def ppm(img: np.ndarray) -> bytes:
    h, w, _ = img.shape
    return b"P6\n%d %d\n255\n" % (w, h) + img.tobytes()


def _image(seed, h, w, c):
    return np.random.default_rng(seed).integers(0, 256, (h, w, c)).astype(U8)


def _decode(name, blob, host=True, raises=None, **attrs):
    return _case(name, "ImageDecoder",
                 [("encoded", np.frombuffer(blob, U8).copy(), "feed")],
                 opset=20, host=host, raises=raises, jit=False, **attrs)


_RGB = _image(150, 5, 7, 3)
IMAGE_CASES = [
    _decode("image_decoder_png_rgb", png(_RGB)),
    _decode("image_decoder_png_bgr", png(_RGB), pixel_format="BGR"),
    _decode("image_decoder_png_rgba_to_grayscale", png(_image(151, 4, 6, 4)),
            pixel_format="Grayscale"),
    _decode("image_decoder_png_gray_to_rgb", png(_image(152, 6, 3, 1))),
    _decode("image_decoder_ppm_bgr", ppm(_image(153, 3, 4, 3)),
            pixel_format="BGR"),
    _decode("image_decoder_device_tensor_raises", png(_RGB), host=False,
            raises=NotImplementedError),
]

CASES = (NMS_CASES + ROI_ALIGN_CASES + MAX_ROI_POOL_CASES + DEFORM_CASES
         + GRID_SAMPLE_CASES + AFFINE_CASES + IMAGE_CASES)
# every case but ImageDecoder's runs on the card
CARD_CASES = [c for c in CASES if c["op"] != "ImageDecoder"]


def by_name(name: str) -> dict:
    return next(c for c in CASES if c["name"] == name)


def graph(case: dict, graph_cls) -> bytes:
    """The case's graph, built with ``graph_cls`` (either package's
    ``GraphBuilder``)."""
    g = graph_cls(opset=case["opset"])
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
    g.add_node(case["op"], names, outputs=["y0"], **case["attrs"])
    g.add_output("y0", np.float32, None)
    return g.to_bytes()


def feeds(case: dict) -> list:
    """The graph inputs' numpy values, in order."""
    return [a for name, a, where in case["inputs"]
            if name and where == "feed"]


def run(case: dict, import_model, graph_cls, device: str) -> list:
    """The port's outputs of the case on ``device`` (``import_model`` and
    ``graph_cls`` the port's), each as numpy with whether it was a host
    value. A refusal propagates."""
    import torch

    fn = import_model(graph(case, graph_cls)).bind(device=device)
    args = feeds(case)
    if not case["host"]:
        args = [torch.from_numpy(np.ascontiguousarray(a)).to(device)
                for a in args]
    out = []
    for v in fn(*args):
        if isinstance(v, torch.Tensor):
            out.append((v.cpu().numpy(), False))
        else:
            out.append((np.asarray(v), True))
    return out


def bound(tol: float, want: np.ndarray) -> float:
    """``tol`` of ``want``'s largest finite |value|, at least ``tol``."""
    finite = np.abs(want[np.isfinite(want)]) if want.size else want
    return tol * max(1.0, float(finite.max()) if finite.size else 1.0)


def agree(case: dict, got: list, want: list, tol: float = CARD_TOL) -> dict:
    """``got`` against ``want`` (lists of :func:`run`): bitwise (a NaN's
    bits too) where the case is ``exact``, else within :func:`bound` of
    ``tol`` with NaN where NaN is; the same host/device kind, dtype and
    shape. Returns ``{"ok", "max_abs_err"}``."""
    ok, err = len(got) == len(want), 0.0
    for (g, g_host), (w, w_host) in zip(got, want):
        ok &= g_host == w_host and g.dtype == w.dtype and g.shape == w.shape
        if not ok:
            break
        if case["exact"]:
            bits = f"u{g.itemsize}" if g.dtype.kind == "f" else g.dtype
            ok &= bool(np.array_equal(g.view(bits), w.view(bits)))
        else:
            ok &= bool(np.allclose(g, w, rtol=0.0, atol=bound(tol, w),
                                   equal_nan=True))
        if g.size and g.dtype.kind in "fiu":
            with np.errstate(invalid="ignore"):
                d = np.abs(g.astype(np.float64) - w.astype(np.float64))
            d = d[~np.isnan(d)]
            err = max(err, float(d.max()) if d.size else 0.0)
    return {"ok": bool(ok), "max_abs_err": err}

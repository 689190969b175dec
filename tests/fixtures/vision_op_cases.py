"""One-node graphs of the ONNX dense-image ops (``ConvTranspose``,
``Resize``, ``Upsample``, ``Pad``, ``DepthToSpace``, ``SpaceToDepth``, the
pools, ``MaxPool``'s Indices with ``MaxUnpool``, the five normalizations,
``Col2Im`` and ``CenterCropPad``), with their seeded inputs.

``tests/test_torch_onnx_ops_vision.py`` runs each case through the JAX
package's importer and the port's on the CPU; ``chip_smoke.py`` and
``tests/test_torch_cuda.py`` run the port on the card against the port on
the CPU (:func:`run`, :func:`agree`). The cases hold the edges where the
reference is not ``torch.nn.functional``'s obvious call: Resize as
``jax.image.resize`` (antialiased ``linear``/``cubic`` downsampling, Keys'
cubic with a = -0.5, ``half_pixel`` nearest as ``floor((i + 0.5) * in /
out)``, ignored attributes), ``Upsample``'s half-pixel ``linear``, ``Pad``
on N and C in every mode and its refusal of negative pads, even-size
``LRN``, grouped and asymmetric ``ConvTranspose`` (its ``output_shape``
attribute ignored), opset-18 and opset-21 ``GroupNormalization``, ``LpPool``
over ``|x|``, ``LpNormalization`` reading ``p = 3`` as 2, N-d ``Col2Im``,
and ``MaxPool``'s Indices (ties to the first cell, NaN the largest, the
all-padding sentinel 2^31 - 1) with ``MaxUnpool`` dropping what is out of
range.

A case is a dict: ``op``, ``inputs`` (``[(name, array, where)]`` in the
node's order, ``where`` one of ``"feed"`` (a graph input: a device tensor,
or numpy under ``host``), ``"init"`` (an initializer: a parameter when
float, a host value when it feeds a shape slot) or ``"const"`` (a Constant
node: a host value in both packages); an empty name skips an optional
input), ``attrs``, ``opset``, ``n_out``, ``host`` (feeds numpy),
``exact`` (equal bitwise, card against CPU and port against reference;
otherwise within ``tol`` of the largest |value|, see :func:`agree`),
``raises`` (the exception both packages raise) and ``then``
(a second node fed the first's outputs and the listed inputs).

This module imports neither package: :func:`graph` takes either package's
``GraphBuilder``, :func:`run` the port's ``import_model``.
"""
import numpy as np

F32, I64, I32 = np.float32, np.int64, np.int32
# float32 sums and products of at most a few hundred terms of magnitude
# up to ~10, taken in another order (or through another kernel) than the
# other run's: within this share of the largest |value| (at least 1)
SUM_TOL = 2e-5
NO_INDEX = 2 ** 31 - 1    # MaxPool's index of a window wholly in padding


def _x(seed, *shape, dtype=F32):
    return np.random.default_rng(seed).standard_normal(shape).astype(dtype)


def _ties(seed, *shape):
    """Small integers as float32: windows with ties."""
    return np.random.default_rng(seed).integers(-2, 3, shape).astype(F32)


def _case(name, op, inputs, opset=17, n_out=1, host=False, exact=True,
          raises=None, then=None, **attrs):
    return dict(name=name, op=op, inputs=inputs, opset=opset, n_out=n_out,
                host=host, exact=exact, raises=raises, then=then,
                attrs=attrs)


def _sum(name, op, inputs, **kw):
    return _case(name, op, inputs, exact=False, **kw)


def _scales(*s):
    return np.array(s, F32)


def _sizes(*s):
    return np.array(s, I64)


def _resize(name, x, scales=None, sizes=None, roi=None, opset=19,
            exact=False, raises=None, **attrs):
    inputs = [("x", x, "feed"),
              ("roi", roi, "init") if roi is not None else ("", None, ""),
              ("scales", scales, "init") if scales is not None
              else ("", None, ""),
              ("sizes", sizes, "init") if sizes is not None
              else ("", None, "")]
    while not inputs[-1][0]:
        inputs.pop()
    return _case(name, "Resize", inputs, opset=opset, exact=exact,
                 raises=raises, **attrs)


def _unpool_input(seed, n, c, h, w, k):
    """Pooled values of a ``k`` x ``k``, stride-``k`` pool and the flat
    index (over the whole ``[n, c, h, w]`` tensor) of one seeded cell of
    each window: distinct indices, as a pool's are."""
    rng = np.random.default_rng(seed)
    oh, ow = h // k, w // k
    dy = rng.integers(0, k, (n, c, oh, ow))
    dx = rng.integers(0, k, (n, c, oh, ow))
    rows = np.arange(oh)[:, None] * k + dy
    cols = np.arange(ow)[None, :] * k + dx
    plane = (np.arange(n)[:, None] * c + np.arange(c)[None, :])[..., None, None]
    idx = (plane * h + rows) * w + cols
    return _x(seed + 1, n, c, oh, ow), idx.astype(I64)


_NAN_POOL = _x(40, 1, 2, 5, 6)
_NAN_POOL[0, 0, 1, 1] = np.nan
_NAN_POOL[0, 0, 1, 2] = np.nan
_NAN_POOL[0, 1, 4, 5] = np.nan
_UNPOOL_X, _UNPOOL_I = _unpool_input(50, 2, 3, 8, 8, 2)
_SENTINEL_I = _UNPOOL_I.copy()
_SENTINEL_I[0, 0, 0, 0] = NO_INDEX
_SENTINEL_I[0, 1, 1, 1] = -3                 # wraps to the last cells
_SENTINEL_I[1, 2, 3, 3] = 2 * 3 * 8 * 8      # one past the end: dropped
_ZERO_ROW = _x(60, 3, 5)
_ZERO_ROW[1] = 0.0

CASES = [
    # -- ConvTranspose -------------------------------------------------
    _sum("conv_t_2d_stride2", "ConvTranspose",
         [("x", _x(0, 1, 3, 5, 5), "feed"), ("w", _x(1, 3, 4, 3, 3), "init"),
          ("b", _x(2, 4), "init")], strides=[2, 2]),
    _sum("conv_t_2d_pads_output_padding", "ConvTranspose",
         [("x", _x(3, 2, 3, 4, 5), "feed"), ("w", _x(4, 3, 2, 3, 3), "init")],
         strides=[2, 2], pads=[1, 1, 1, 1], output_padding=[1, 1]),
    _sum("conv_t_2d_asymmetric_pads", "ConvTranspose",
         [("x", _x(5, 1, 2, 5, 4), "feed"), ("w", _x(6, 2, 3, 3, 2), "init"),
          ("b", _x(7, 3), "init")], strides=[2, 1], pads=[0, 1, 2, 0]),
    _sum("conv_t_2d_grouped_dilated", "ConvTranspose",
         [("x", _x(8, 2, 4, 4, 5), "feed"), ("w", _x(9, 4, 3, 3, 2), "init"),
          ("b", _x(10, 6), "init")], group=2, strides=[1, 2],
         dilations=[2, 1]),
    _sum("conv_t_1d_same_upper", "ConvTranspose",
         [("x", _x(11, 1, 2, 7), "feed"), ("w", _x(12, 2, 3, 4), "init")],
         strides=[2], auto_pad="SAME_UPPER"),
    _sum("conv_t_2d_same_lower", "ConvTranspose",
         [("x", _x(13, 1, 2, 4, 3), "feed"), ("w", _x(14, 2, 2, 3, 2), "init")],
         strides=[2, 3], auto_pad="SAME_LOWER"),
    _sum("conv_t_3d", "ConvTranspose",
         [("x", _x(15, 1, 2, 3, 4, 3), "feed"),
          ("w", _x(16, 2, 2, 2, 2, 2), "init")], strides=[2, 1, 2]),
    _sum("conv_t_negative_pads", "ConvTranspose",
         [("x", _x(17, 1, 2, 4, 4), "feed"), ("w", _x(18, 2, 2, 3, 3), "init")],
         strides=[2, 2], pads=[-1, 0, 0, -1]),
    _sum("conv_t_output_padding_past_stride", "ConvTranspose",
         [("x", _x(19, 1, 2, 3, 3), "feed"), ("w", _x(20, 2, 2, 2, 2), "init")],
         strides=[2, 2], output_padding=[2, 0]),
    _sum("conv_t_pads_crop_an_axis_empty", "ConvTranspose",
         [("x", _x(99, 1, 2, 2, 4), "feed"), ("w", _x(100, 2, 2, 2, 1), "init")],
         pads=[2, 0, 2, 1]),
    _sum("conv_t_1d_pads_crop_past_the_output", "ConvTranspose",
         [("x", _x(101, 1, 2, 5), "feed"), ("w", _x(102, 2, 3, 2), "init"),
          ("b", _x(103, 3), "init")], pads=[4, 3]),
    _sum("conv_t_output_shape_ignored", "ConvTranspose",
         [("x", _x(21, 1, 2, 3, 3), "feed"), ("w", _x(22, 2, 3, 3, 3), "init")],
         strides=[2, 2], output_shape=[10, 10]),
    # -- Resize: nearest ----------------------------------------------
    _resize("resize_nearest_asymmetric_floor_x2", _x(23, 2, 3, 4, 5),
            scales=_scales(1, 1, 2, 2), exact=True, mode="nearest",
            coordinate_transformation_mode="asymmetric", nearest_mode="floor"),
    _resize("resize_nearest_asymmetric_round_prefer_floor_down",
            _x(24, 1, 2, 7, 9), sizes=_sizes(1, 2, 4, 5), exact=True,
            mode="nearest", coordinate_transformation_mode="asymmetric"),
    _resize("resize_nearest_asymmetric_round_prefer_ceil_up",
            _x(25, 1, 2, 3, 4), sizes=_sizes(1, 2, 7, 10), exact=True,
            mode="nearest", coordinate_transformation_mode="asymmetric",
            nearest_mode="round_prefer_ceil"),
    _resize("resize_nearest_asymmetric_ceil_int32",
            _x(26, 1, 1, 5, 4, dtype=I32), sizes=_sizes(1, 1, 3, 7),
            exact=True, mode="nearest",
            coordinate_transformation_mode="asymmetric", nearest_mode="ceil"),
    _resize("resize_nearest_half_pixel_up", _x(27, 2, 2, 3, 4),
            sizes=_sizes(2, 2, 7, 9), exact=True, mode="nearest"),
    _resize("resize_nearest_half_pixel_down", _x(28, 1, 3, 8, 7),
            sizes=_sizes(1, 3, 3, 2), exact=True, mode="nearest",
            nearest_mode="round_prefer_ceil"),
    _resize("resize_nearest_pytorch_half_pixel_to_one", _x(29, 1, 2, 5, 6),
            sizes=_sizes(1, 2, 1, 4), exact=True, mode="nearest",
            coordinate_transformation_mode="pytorch_half_pixel"),
    _resize("resize_nearest_opset13_scales", _x(30, 1, 2, 4, 4),
            scales=_scales(1, 1, 1.5, 0.5), opset=13, exact=True,
            mode="nearest"),
    # -- Resize: linear and cubic (antialiased, borders renormalised) --
    _resize("resize_linear_up_x2", _x(31, 2, 3, 4, 5),
            scales=_scales(1, 1, 2, 2), mode="linear"),
    _resize("resize_linear_down_antialias", _x(32, 1, 2, 9, 11),
            sizes=_sizes(1, 2, 4, 3), mode="linear"),
    _resize("resize_linear_up_and_down", _x(33, 1, 2, 5, 12),
            sizes=_sizes(1, 2, 8, 5), mode="linear",
            coordinate_transformation_mode="pytorch_half_pixel"),
    _resize("resize_linear_on_n_and_c", _x(34, 2, 3, 4, 4),
            sizes=_sizes(3, 5, 4, 4), mode="linear"),
    _resize("resize_linear_int32_to_float", _x(35, 1, 1, 4, 5, dtype=I32),
            sizes=_sizes(1, 1, 7, 3), mode="linear"),
    _resize("resize_linear_roi_and_antialias_ignored", _x(36, 1, 2, 6, 6),
            scales=_scales(1, 1, 0.5, 2), roi=_scales(0, 0, .2, .2, 1, 1, .8, .8),
            mode="linear", antialias=0),
    _resize("resize_cubic_up", _x(37, 1, 2, 5, 6), scales=_scales(1, 1, 2, 1.5),
            mode="cubic"),
    _resize("resize_cubic_down_coeff_and_exclude_ignored", _x(38, 1, 2, 12, 9),
            sizes=_sizes(1, 2, 5, 4), mode="cubic", cubic_coeff_a=-0.75,
            exclude_outside=1),
    _resize("resize_align_corners_raises", _x(39, 1, 1, 3, 3),
            scales=_scales(1, 1, 2, 2), mode="linear",
            coordinate_transformation_mode="align_corners",
            raises=NotImplementedError),
    # -- Upsample ------------------------------------------------------
    _case("upsample_nearest_x2_x3", "Upsample",
          [("x", _x(41, 1, 2, 3, 4), "feed"),
           ("s", _scales(1, 1, 2, 3), "init")], opset=9),
    _case("upsample_opset7_attr_scales", "Upsample",
          [("x", _x(42, 2, 1, 3, 3), "feed")], opset=7,
          scales=[1.0, 1.0, 2.0, 2.0], mode="nearest"),
    _sum("upsample_linear_is_half_pixel", "Upsample",
         [("x", _x(43, 1, 2, 4, 5), "feed"),
          ("s", _scales(1, 1, 2, 2), "init")], opset=9, mode="linear"),
    # -- Pad -----------------------------------------------------------
    _case("pad_constant_n_and_c", "Pad",
          [("x", _x(44, 2, 3, 4), "feed"),
           ("p", _sizes(1, 0, 2, 0, 1, 1), "init"),
           ("v", np.array(1.5, F32), "const")], opset=13),
    _case("pad_reflect_n_and_c_wider_than_axis", "Pad",
          [("x", _x(45, 2, 3, 4), "feed"),
           ("p", _sizes(1, 4, 0, 1, 2, 5), "init")], opset=13, mode="reflect"),
    _case("pad_edge_every_axis", "Pad",
          [("x", _x(46, 2, 3, 2, 2), "feed"),
           ("p", _sizes(1, 2, 0, 3, 2, 0, 1, 1), "init")], opset=13,
          mode="edge"),
    _case("pad_wrap_wider_than_axis", "Pad",
          [("x", _x(47, 2, 3, 4), "feed"),
           ("p", _sizes(3, 1, 0, 0, 2, 9), "init")], opset=19, mode="wrap"),
    _case("pad_axes_input", "Pad",
          [("x", _x(48, 2, 3, 4), "feed"), ("p", _sizes(1, 2, 3, 0), "init"),
           ("", None, ""), ("a", _sizes(-1, 1), "init")], opset=18,
          mode="reflect"),
    _case("pad_int32_float_value_truncates", "Pad",
          [("x", _x(49, 2, 3, dtype=I32), "feed"),
           ("p", _sizes(0, 1, 2, 0), "init"),
           ("v", np.array(2.7, F32), "const")], opset=13),
    _case("pad_opset2_attrs", "Pad", [("x", _x(51, 1, 2, 3), "feed")],
          opset=10, pads=[0, 1, 1, 0, 0, 2], value=-0.5),
    _case("pad_constant_negative_raises", "Pad",
          [("x", _x(52, 2, 4), "feed"), ("p", _sizes(0, -1, 1, 0), "init")],
          opset=13, raises=ValueError),
    _case("pad_reflect_negative_raises", "Pad",
          [("x", _x(53, 2, 4), "feed"), ("p", _sizes(0, 1, 0, -2), "init")],
          opset=13, mode="reflect", raises=ValueError),
    # -- DepthToSpace, SpaceToDepth ------------------------------------
    _case("depth_to_space_dcr", "DepthToSpace",
          [("x", _x(54, 2, 8, 2, 3), "feed")], blocksize=2),
    _case("depth_to_space_crd", "DepthToSpace",
          [("x", _x(55, 1, 18, 2, 2), "feed")], blocksize=3, mode="CRD"),
    _case("depth_to_space_int64", "DepthToSpace",
          [("x", np.arange(2 * 8 * 2 * 2, dtype=I64).reshape(2, 8, 2, 2),
            "feed")], blocksize=2),
    _case("space_to_depth", "SpaceToDepth",
          [("x", _x(56, 2, 3, 4, 6), "feed")], blocksize=2),
    # -- GlobalMaxPool, GlobalLpPool, LpPool ---------------------------
    _case("global_max_pool_nan", "GlobalMaxPool",
          [("x", _NAN_POOL, "feed")]),
    _case("global_max_pool_3d", "GlobalMaxPool",
          [("x", _x(57, 2, 3, 2, 3, 4), "feed")]),
    _sum("global_lp_pool_p2", "GlobalLpPool", [("x", _x(58, 2, 3, 4, 5), "feed")]),
    _sum("global_lp_pool_p3", "GlobalLpPool", [("x", _x(59, 2, 3, 4, 5), "feed")],
         p=3),
    _sum("lp_pool_2d_pads_strides", "LpPool", [("x", _x(61, 2, 2, 5, 6), "feed")],
         kernel_shape=[2, 3], strides=[2, 2], pads=[1, 0, 1, 1]),
    _sum("lp_pool_1d_p1_dilated", "LpPool", [("x", _x(62, 1, 3, 9), "feed")],
         kernel_shape=[3], dilations=[2], p=1, opset=18),
    _sum("lp_pool_2d_ceil_mode", "LpPool", [("x", _x(63, 1, 2, 5, 5), "feed")],
         kernel_shape=[2, 2], strides=[2, 2], ceil_mode=1, opset=18),
    _sum("lp_pool_3d_p3", "LpPool", [("x", _x(64, 1, 2, 4, 3, 4), "feed")],
         kernel_shape=[2, 2, 2], p=3),
    # -- MaxPool's Indices and MaxUnpool -------------------------------
    _case("max_pool_indices_2d_pads", "MaxPool",
          [("x", _x(65, 2, 3, 8, 10), "feed")], n_out=2,
          kernel_shape=[2, 3], strides=[2, 2], pads=[0, 1, 0, 1]),
    _case("max_pool_indices_all_padding_sentinel", "MaxPool",
          [("x", np.array([[[1.0, 2.0, 3.0, 4.0]]], F32), "feed")], n_out=2,
          kernel_shape=[2], strides=[2], pads=[2, 2]),
    _case("max_pool_indices_ties_first_cell", "MaxPool",
          [("x", _ties(66, 2, 2, 6, 6), "feed")], n_out=2,
          kernel_shape=[3, 3], strides=[1, 2]),
    _case("max_pool_indices_nan", "MaxPool", [("x", _NAN_POOL, "feed")],
          n_out=2, kernel_shape=[2, 2], strides=[1, 1]),
    _case("max_pool_indices_dilated_ceil", "MaxPool",
          [("x", _x(67, 1, 2, 7, 8), "feed")], n_out=2, kernel_shape=[2, 2],
          strides=[2, 3], dilations=[2, 1], ceil_mode=1),
    _case("max_pool_indices_3d", "MaxPool", [("x", _x(68, 1, 2, 4, 4, 4), "feed")],
          n_out=2, kernel_shape=[2, 2, 2], strides=[2, 2, 2]),
    _case("max_pool_indices_int32_same_upper", "MaxPool",
          [("x", _x(69, 1, 2, 5, 5, dtype=I32), "feed")], n_out=2,
          kernel_shape=[3, 3], strides=[2, 2], auto_pad="SAME_UPPER"),
    _case("max_unpool_inferred_shape", "MaxUnpool",
          [("x", _UNPOOL_X, "feed"), ("i", _UNPOOL_I, "feed")],
          kernel_shape=[2, 2], strides=[2, 2]),
    _case("max_unpool_sentinel_negative_past_end", "MaxUnpool",
          [("x", _UNPOOL_X, "feed"), ("i", _SENTINEL_I, "feed")],
          kernel_shape=[2, 2], strides=[2, 2]),
    _case("max_unpool_output_shape_larger", "MaxUnpool",
          [("x", _UNPOOL_X, "feed"), ("i", _SENTINEL_I, "feed"),
           ("s", _sizes(2, 3, 9, 8), "init")], kernel_shape=[2, 2],
          strides=[2, 2]),
    _case("max_pool_then_unpool_1d_pads", "MaxPool",
          [("x", np.array([[[1.0, 2.0, 3.0, 4.0]]], F32), "feed")], n_out=2,
          kernel_shape=[2], strides=[2], pads=[2, 2],
          then=("MaxUnpool", [("s", _sizes(1, 1, 6), "init")],
                dict(kernel_shape=[2], strides=[2], pads=[2, 2]))),
    _case("max_pool_then_unpool_2d", "MaxPool",
          [("x", _ties(70, 2, 3, 6, 8), "feed")], n_out=2,
          kernel_shape=[2, 2], strides=[2, 2],
          then=("MaxUnpool", [], dict(kernel_shape=[2, 2], strides=[2, 2]))),
    # -- LRN -----------------------------------------------------------
    _sum("lrn_size3", "LRN", [("x", _x(71, 2, 6, 3, 3), "feed")], size=3),
    _sum("lrn_even_size4", "LRN", [("x", _x(72, 1, 7, 2, 3), "feed")], size=4,
         alpha=0.01, beta=0.5, bias=2.0),
    _sum("lrn_size5_3d", "LRN", [("x", _x(73, 2, 5, 4), "feed")], size=5,
         alpha=1e-3),
    # -- Instance, Group, MeanVariance and Lp normalization ------------
    _sum("instance_norm_4d", "InstanceNormalization",
         [("x", _x(74, 2, 3, 4, 5), "feed"), ("s", _x(75, 3), "init"),
          ("b", _x(76, 3), "init")], epsilon=1e-3),
    _sum("instance_norm_3d", "InstanceNormalization",
         [("x", _x(77, 3, 2, 6), "feed"), ("s", _x(78, 2), "init"),
          ("b", _x(79, 2), "init")]),
    _sum("group_norm_opset18_per_group", "GroupNormalization",
         [("x", _x(80, 2, 6, 3, 4), "feed"), ("s", _x(81, 2), "init"),
          ("b", _x(82, 2), "init")], opset=18, num_groups=2),
    _sum("group_norm_opset21_per_channel", "GroupNormalization",
         [("x", _x(83, 2, 6, 3, 4), "feed"), ("s", _x(84, 6), "init"),
          ("b", _x(85, 6), "init")], opset=21, num_groups=3, epsilon=1e-6),
    _sum("group_norm_groups_equal_channels", "GroupNormalization",
         [("x", _x(86, 2, 4, 5), "feed"), ("s", _x(87, 4), "init"),
          ("b", _x(88, 4), "init")], opset=18, num_groups=4),
    _sum("mvn_default_axes_across_batch", "MeanVarianceNormalization",
         [("x", _x(89, 3, 2, 4, 5), "feed")]),
    _sum("mvn_axes_2_3", "MeanVarianceNormalization",
         [("x", _x(90, 2, 3, 4, 4), "feed")], axes=[2, 3]),
    _sum("lp_normalization_p1", "LpNormalization",
         [("x", _ZERO_ROW, "feed")], p=1),
    _sum("lp_normalization_p2_axis0", "LpNormalization",
         [("x", _x(91, 4, 3), "feed")], p=2, axis=0),
    _sum("lp_normalization_p3_reads_as_2", "LpNormalization",
         [("x", _ZERO_ROW, "feed")], p=3),
    # -- Col2Im, CenterCropPad -----------------------------------------
    _sum("col2im_2d_pads_strides_dilations", "Col2Im",
         [("x", _x(92, 2, 3 * 2 * 2, 9), "feed"),
          ("i", _sizes(5, 6), "init"), ("k", _sizes(2, 2), "init")],
         opset=18, strides=[2, 2], dilations=[1, 2], pads=[1, 1, 1, 0]),
    _sum("col2im_2d_overlapping", "Col2Im",
         [("x", _x(93, 1, 2 * 3 * 3, 9), "feed"),
          ("i", _sizes(5, 5), "init"), ("k", _sizes(3, 3), "init")], opset=18),
    _sum("col2im_1d", "Col2Im",
         [("x", _x(94, 2, 3 * 3, 4), "feed"), ("i", _sizes(8,), "init"),
          ("k", _sizes(3,), "init")], opset=18, strides=[2], pads=[1, 0]),
    _sum("col2im_3d", "Col2Im",
         [("x", _x(95, 1, 2 * 2 * 2 * 2, 2 * 3 * 2), "feed"),
          ("i", _sizes(3, 4, 3), "init"), ("k", _sizes(2, 2, 2), "init")],
         opset=18),
    _case("center_crop_pad_device", "CenterCropPad",
          [("x", _x(96, 5, 4, 3), "feed"), ("s", _sizes(3, 7, 3), "init")],
          opset=18),
    _case("center_crop_pad_axes", "CenterCropPad",
          [("x", _x(97, 2, 7, 6, 3), "feed"), ("s", _sizes(4, 9), "init")],
          opset=18, axes=[-2, 1]),
    _case("center_crop_pad_host", "CenterCropPad",
          [("x", _x(98, 6, 3), "const"), ("s", _sizes(3, 6), "init")],
          opset=18),
]

# the edges the port's tests hold on their own
EDGE_CASES = {
    "sentinel": "max_pool_indices_all_padding_sentinel",
    "ties": "max_pool_indices_ties_first_cell",
    "nan": "max_pool_indices_nan",
    "lp3": "lp_normalization_p3_reads_as_2",
    "upsample_linear": "upsample_linear_is_half_pixel",
    "output_shape": "conv_t_output_shape_ignored",
    "unpool_drop": "max_unpool_sentinel_negative_past_end",
    "mvn_batch": "mvn_default_axes_across_batch",
}


def by_name(name: str) -> dict:
    return next(c for c in CASES if c["name"] == name)


def graph(case: dict, graph_cls) -> bytes:
    """The case's graph, built with ``graph_cls`` (either package's
    ``GraphBuilder``)."""
    g = graph_cls(opset=case["opset"])
    names = []

    def add(name, a, where):
        names.append(name)
        if not name:
            return
        if where == "feed":
            g.add_input(name, a.dtype, list(a.shape))
        elif where == "init":
            g.add_initializer(name, a)
        else:
            g.add_node("Constant", [], outputs=[name], value=np.asarray(a))

    for inp in case["inputs"]:
        add(*inp)
    outs = [f"y{i}" for i in range(case["n_out"])]
    g.add_node(case["op"], names, outputs=outs, **case["attrs"])
    if case["then"] is not None:
        op, extra, attrs = case["then"]
        names = list(outs)
        for inp in extra:
            add(*inp)
        outs = ["z0"]
        g.add_node(op, names, outputs=outs, **attrs)
    for o in outs:
        g.add_output(o, np.float32, None)
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


def bound(case: dict, want: np.ndarray) -> float:
    """The largest difference allowed from ``want`` in an inexact case:
    ``SUM_TOL`` of its largest |value|, at least ``SUM_TOL``."""
    finite = np.abs(want[np.isfinite(want)]) if want.size else want
    return SUM_TOL * max(1.0, float(finite.max()) if finite.size else 1.0)


def agree(case: dict, got: list, want: list) -> dict:
    """``got`` against ``want`` (lists of :func:`run`): bitwise (a NaN's
    bits too) where the case is ``exact``, else within :func:`bound` with
    NaN where NaN is; the same host/device kind, dtype and shape. Returns
    ``{"ok", "max_abs_err"}``."""
    ok, err = len(got) == len(want), 0.0
    for (g, g_host), (w, w_host) in zip(got, want):
        ok &= g_host == w_host and g.dtype == w.dtype and g.shape == w.shape
        if not ok:
            break
        if case["exact"]:
            bits = f"u{g.itemsize}" if g.dtype.kind == "f" else g.dtype
            ok &= bool(np.array_equal(g.view(bits), w.view(bits)))
        else:
            ok &= bool(np.allclose(g, w, rtol=0.0, atol=bound(case, w),
                                   equal_nan=True))
        if g.size and g.dtype.kind in "fiu":
            with np.errstate(invalid="ignore"):    # inf - inf, NaN
                d = np.abs(g.astype(np.float64) - w.astype(np.float64))
            d = d[~np.isnan(d)]
            err = max(err, float(d.max()) if d.size else 0.0)
    return {"ok": bool(ok), "max_abs_err": err}

"""The port's ``image/ops.py`` against the JAX package's, on the CPU.

The same seeded numpy images go through each JAX op and its torch
counterpart (``device="cpu"`` tensors). Resize, blur, the gaussian and
gray conversion accumulate in another order than XLA, so they are held at
atol 1e-3 on the 0-255 scale; crop, flip, channel reversal and the five
thresholds are exact. Resize's weights are held to the installed JAX's
``compute_weight_mat`` itself.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax._src.image.scale import _fill_triangle_kernel, compute_weight_mat

from synapseml_tpu.image import ops as jops
from synapseml_tpu_torch.image import ops

ATOL = 1e-3


def _img(h=24, w=32, c=3, seed=0):
    return np.random.default_rng(seed).integers(
        0, 256, (h, w, c)).astype(np.float32)


def _both(fn_name, img, *args, **kw):
    want = np.asarray(getattr(jops, fn_name)(jnp.asarray(img), *args, **kw))
    got = getattr(ops, fn_name)(torch.from_numpy(img), *args, **kw).numpy()
    assert got.shape == want.shape, (got.shape, want.shape)
    return got, want


@pytest.mark.parametrize("n_in,n_out", [
    (24, 48), (40, 20), (17, 9), (23, 31), (64, 13), (256, 240), (7, 7),
    (5, 1), (1, 6)])
def test_resize_weights_are_jax_compute_weight_mat(n_in, n_out):
    want = np.asarray(compute_weight_mat(
        n_in, n_out, jnp.float32(n_out / n_in), jnp.float32(0.0),
        _fill_triangle_kernel, True))
    got = ops.resize_weights(n_in, n_out).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("shape,kw", [
    ((24, 32), dict(height=48, width=64)),          # enlarge
    ((40, 60), dict(height=20, width=30)),          # shrink
    ((17, 23), dict(height=9, width=31)),           # odd sizes, mixed
    ((256, 256), dict(height=240, width=240)),      # the pipeline's
    ((5, 7), dict(height=5, width=11)),             # one axis unchanged
    ((40, 80), dict(size=20, keep_aspect_ratio=True)),
    ((30, 20), dict(size=15, keep_aspect_ratio=True)),
    ((33, 47), dict(size=16)),
])
def test_resize_matches_jax(shape, kw):
    got, want = _both("resize", _img(*shape), **kw)
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)


def test_resize_of_a_batch_is_each_image_resized():
    batch = np.stack([_img(20, 28, seed=s) for s in range(3)])
    got = ops.resize(torch.from_numpy(batch), height=11, width=40).numpy()
    for i in range(3):
        want = np.asarray(jops.resize(jnp.asarray(batch[i]), height=11,
                                      width=40))
        np.testing.assert_allclose(got[i], want, atol=ATOL, rtol=0)


def test_resize_of_uint8_pixels_returns_float32():
    img = _img(12, 12).astype(np.uint8)
    out = ops.resize(torch.from_numpy(img), height=6, width=6)
    assert out.dtype == torch.float32


@pytest.mark.parametrize("kh,kw", [(3, 3), (4, 2), (5, 1), (2, 6), (1, 1)])
def test_blur_matches_jax_for_even_and_odd_kernels(kh, kw):
    got, want = _both("blur", _img(20, 30), kh, kw)
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)


@pytest.mark.parametrize("aperture,sigma", [(3, 0.0), (4, 0.0), (5, 0.0),
                                            (5, 1.5), (6, 2.0)])
def test_gaussian_kernel_is_vertical_and_matches_jax(aperture, sigma):
    img = _img(20, 30)
    got, want = _both("gaussian_kernel", img, aperture, sigma)
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)
    # vertical only: a row-constant image passes unchanged away from the
    # top and bottom borders
    rows = np.repeat(_img(20, 1), 30, axis=1)
    out = ops.gaussian_kernel(torch.from_numpy(rows), aperture, sigma).numpy()
    np.testing.assert_allclose(out, out[:, :1].repeat(30, axis=1), atol=1e-4)


@pytest.mark.parametrize("ttype", [
    jops.THRESH_BINARY, jops.THRESH_BINARY_INV, jops.THRESH_TRUNC,
    jops.THRESH_TOZERO, jops.THRESH_TOZERO_INV])
def test_threshold_types_exact(ttype):
    got, want = _both("threshold", _img(10, 12), 128.3, 200.0, ttype)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("fmt", [jops.COLOR_RGB2GRAY, jops.COLOR_BGR2GRAY])
def test_gray_conversion_bt601(fmt):
    got, want = _both("color_format", _img(6, 9), fmt)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=ATOL)


@pytest.mark.parametrize("fmt", [jops.COLOR_BGR2RGB, jops.COLOR_GRAY2BGR])
def test_channel_reversal_and_gray_to_bgr_exact(fmt):
    got, want = _both("color_format", _img(6, 9), fmt)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("name,args", [
    ("crop", (2, 3, 4, 5)), ("crop", (0, 0, 10, 12)),
    ("center_crop", (6, 6)), ("center_crop", (5, 7)),
    ("center_crop", (20, 20)),
    ("flip", (jops.FLIP_UP_DOWN,)), ("flip", (jops.FLIP_LEFT_RIGHT,)),
    ("flip", (jops.FLIP_BOTH,)),
])
def test_crop_center_crop_flip_exact(name, args):
    got, want = _both(name, _img(10, 12), *args)
    np.testing.assert_array_equal(got, want)


def test_unsupported_codes_raise_as_in_jax():
    img = torch.from_numpy(_img(4, 4))
    with pytest.raises(ValueError, match="colorformat"):
        ops.color_format(img, 99)
    with pytest.raises(ValueError, match="threshold type"):
        ops.threshold(img, 1.0, 2.0, 9)
    with pytest.raises(ValueError, match="unsupported transformation"):
        ops.apply_stage(img, {"action": "warp"})


def test_apply_pipeline_of_every_stage_matches_jax():
    stages = [
        {"action": "resize", "height": 30, "width": 36},
        {"action": "crop", "x": 1, "y": 2, "height": 26, "width": 30},
        {"action": "centercrop", "height": 24, "width": 24},
        {"action": "flip", "flipCode": jops.FLIP_BOTH},
        {"action": "blur", "height": 2, "width": 3},
        {"action": "gaussiankernel", "apertureSize": 3, "sigma": 0.8},
        {"action": "threshold", "threshold": 90.0, "maxVal": 250.0,
         "type": jops.THRESH_TOZERO},
        {"action": "colorformat", "format": jops.COLOR_BGR2RGB},
        {"action": "colorformat", "format": jops.COLOR_RGB2GRAY},
    ]
    img = _img(25, 33)
    want = np.asarray(jops.apply_pipeline(jnp.asarray(img), stages))
    got = ops.apply_pipeline(torch.from_numpy(img), stages).numpy()
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)


def test_unroll_chw_is_the_reference_layout():
    img = _img(5, 7).astype(np.uint8)
    np.testing.assert_array_equal(ops.unroll_chw(img), jops.unroll_chw(img))
    np.testing.assert_array_equal(ops.unroll_chw(img[..., 0]),
                                  jops.unroll_chw(img[..., 0]))

"""Image ops: PyTorch implementations of the reference's OpenCV stage set.

The counterpart of the reference package's ``image/ops.py`` (itself the
rebuild of ref: opencv/src/main/scala/com/microsoft/ml/spark/opencv/
ImageTransformer.scala:38-275). Each op is a function of a float tensor
laid out ``[..., H, W, C]``: one image, or a batch of images of one shape,
so a stage pipeline runs once over a whole ``[B, H, W, C]`` batch on the
card.

Stage names and parameter keys are byte-compatible with the reference
("resize", "crop", "centercrop", "colorformat", "blur", "threshold",
"gaussiankernel", "flip" with the same keys), so reference pipelines
translate unmodified.

Numerics follow the JAX package, not OpenCV or ``F.interpolate``:
``resize`` is ``jax.image.resize(method="linear")`` with its default
antialias (per-axis triangle-weight matrices, widened by 1/scale when
shrinking, renormalised at the borders, zero outside the input); the
filters pad as XLA's ``"SAME"`` does, ``(k-1)//2`` before and ``k//2``
after. Convolutions and products run in IEEE float32 on the card (TF32
off, as in the ONNX importer).
"""
from __future__ import annotations

from typing import Any, Dict, List

import numpy as np
import torch
import torch.nn.functional as F

from synapseml_tpu_torch.onnx.importer import _ieee_float32

# OpenCV constant parity (the reference exposes raw cv2 enums)
COLOR_BGR2GRAY = 6
COLOR_RGB2GRAY = 7
COLOR_BGR2RGB = 4
COLOR_RGB2BGR = 4
COLOR_GRAY2BGR = 8

THRESH_BINARY = 0
THRESH_BINARY_INV = 1
THRESH_TRUNC = 2
THRESH_TOZERO = 3
THRESH_TOZERO_INV = 4

FLIP_UP_DOWN = 0
FLIP_LEFT_RIGHT = 1
FLIP_BOTH = -1

_EPS32 = float(np.finfo(np.float32).eps)


def resize_weights(n_in: int, n_out: int,
                   device: torch.device | str = "cpu") -> torch.Tensor:
    """The ``[n_in, n_out]`` float32 weights of one axis of a linear,
    antialiased resize: ``jax._src.image.scale.compute_weight_mat`` with
    the triangle kernel, scale ``n_out / n_in`` and no translation."""
    f32 = torch.float32
    scale = torch.tensor(n_out / n_in, dtype=f32, device=device)
    inv_scale = 1.0 / scale
    # shrinking widens the kernel (a low-pass filter); enlarging does not
    kernel_scale = torch.clamp(inv_scale, min=1.0)
    sample_f = (torch.arange(n_out, dtype=f32, device=device) + 0.5) \
        * inv_scale - 0.5
    x = (sample_f[None, :] - torch.arange(n_in, dtype=f32,
                                          device=device)[:, None]).abs() \
        / kernel_scale
    w = torch.clamp(1.0 - x.abs(), min=0.0)
    total = w.sum(dim=0, keepdim=True)
    w = torch.where(total.abs() > 1000.0 * _EPS32,
                    w / torch.where(total != 0, total, torch.ones_like(total)),
                    torch.zeros_like(w))
    inside = (sample_f >= -0.5) & (sample_f <= n_in - 0.5)
    return torch.where(inside[None, :], w, torch.zeros_like(w))


def resize(img: torch.Tensor, height: int = None, width: int = None,
           size: int = None, keep_aspect_ratio: bool = False) -> torch.Tensor:
    """Bilinear resize; ``size`` + keepAspectRatio resizes the shorter side
    (ref: ImageTransformer.scala:64-92). An axis whose size does not change
    is left as it is, as ``jax.image.resize`` leaves it."""
    h, w = img.shape[-3], img.shape[-2]
    if size is not None:
        if keep_aspect_ratio:
            ratio = size / min(h, w)
            th, tw = int(round(ratio * h)), int(round(ratio * w))
        else:
            th = tw = int(size)
    else:
        th, tw = int(height), int(width)
    x = img if img.is_floating_point() else img.to(torch.float32)
    with _ieee_float32():
        if th != h:
            x = torch.einsum("...hwc,hk->...kwc", x,
                             resize_weights(h, th, x.device).to(x.dtype))
        if tw != w:
            x = torch.einsum("...hwc,wk->...hkc", x,
                             resize_weights(w, tw, x.device).to(x.dtype))
    return x


def crop(img: torch.Tensor, x: int, y: int, height: int,
         width: int) -> torch.Tensor:
    # reference Rect(x, y, width, height): x = column offset, y = row offset
    return img[..., y:y + height, x:x + width, :]


def center_crop(img: torch.Tensor, height: int, width: int) -> torch.Tensor:
    h, w = img.shape[-3], img.shape[-2]
    ch, cw = min(height, h), min(width, w)
    mid_y, mid_x = h // 2, w // 2
    y0, x0 = mid_y - ch // 2, mid_x - cw // 2
    return img[..., y0:y0 + ch, x0:x0 + cw, :]


def color_format(img: torch.Tensor, format: int) -> torch.Tensor:
    if format in (COLOR_BGR2GRAY, COLOR_RGB2GRAY):
        # ITU-R BT.601 luma (what OpenCV uses), in the image's dtype
        wts = [0.114, 0.587, 0.299] if format == COLOR_BGR2GRAY \
            else [0.299, 0.587, 0.114]
        wts = torch.tensor(wts, dtype=torch.float32,
                           device=img.device).to(img.dtype)
        with _ieee_float32():
            gray = img[..., :3] @ wts
        return gray[..., None]
    if format == COLOR_BGR2RGB:  # == RGB2BGR: channel reversal
        return img.flip(-1)
    if format == COLOR_GRAY2BGR:
        return torch.cat([img[..., :1]] * 3, dim=-1)
    raise ValueError(f"unsupported colorformat code {format}")


def flip(img: torch.Tensor, flip_code: int) -> torch.Tensor:
    if flip_code == FLIP_UP_DOWN:
        return img.flip(-3)
    if flip_code == FLIP_LEFT_RIGHT:
        return img.flip(-2)
    return img.flip((-3, -2))


def _depthwise_filter(img: torch.Tensor, kernel: torch.Tensor) -> torch.Tensor:
    """filter2D analogue: a depthwise float32 correlation over each channel,
    zero-padded as XLA's ``"SAME"``: ``(k-1)//2`` before, ``k//2`` after."""
    lead, (h, w, c) = img.shape[:-3], img.shape[-3:]
    kh, kw = kernel.shape
    x = img.to(torch.float32).reshape(-1, h, w, c).permute(0, 3, 1, 2)
    x = F.pad(x, ((kw - 1) // 2, kw // 2, (kh - 1) // 2, kh // 2))
    k = kernel.to(torch.float32).expand(c, 1, kh, kw)
    with _ieee_float32():
        y = F.conv2d(x, k, groups=c)
    return y.permute(0, 2, 3, 1).reshape(*lead, h, w, c).to(img.dtype)


def blur(img: torch.Tensor, height: int, width: int) -> torch.Tensor:
    """Box blur (ref Blur stage -> Imgproc.blur)."""
    kh, kw = int(height), int(width)
    kernel = torch.full((kh, kw), 1.0 / (kh * kw), dtype=torch.float32,
                        device=img.device)
    return _depthwise_filter(img, kernel)


def gaussian_kernel_1d(aperture_size: int, sigma: float) -> np.ndarray:
    """OpenCV getGaussianKernel: Nx1 column vector."""
    if sigma <= 0:
        sigma = 0.3 * ((aperture_size - 1) * 0.5 - 1) + 0.8
    xs = np.arange(aperture_size) - (aperture_size - 1) / 2.0
    k = np.exp(-(xs ** 2) / (2 * sigma ** 2))
    return (k / k.sum()).astype(np.float32)


def gaussian_kernel(img: torch.Tensor, aperture_size: int,
                    sigma: float) -> torch.Tensor:
    """The reference applies the Nx1 getGaussianKernel via filter2D — i.e. a
    vertical-only gaussian (ref: ImageTransformer.scala:255-266). Faithful."""
    k = torch.from_numpy(gaussian_kernel_1d(aperture_size, sigma))[:, None]
    return _depthwise_filter(img, k.to(img.device))


def threshold(img: torch.Tensor, threshold: float, max_val: float,
              type: int = THRESH_BINARY) -> torch.Tensor:
    t = threshold
    top, zero = img.new_tensor(max_val), img.new_tensor(0.0)
    if type == THRESH_BINARY:
        return torch.where(img > t, top, zero)
    if type == THRESH_BINARY_INV:
        return torch.where(img > t, zero, top)
    if type == THRESH_TRUNC:
        return torch.minimum(img, img.new_tensor(t))
    if type == THRESH_TOZERO:
        return torch.where(img > t, img, zero)
    if type == THRESH_TOZERO_INV:
        return torch.where(img > t, zero, img)
    raise ValueError(f"unsupported threshold type {type}")


# ---------------------------------------------------------------------------
# Stage dispatch (param-map compatible with the reference)
# ---------------------------------------------------------------------------

def apply_stage(img: torch.Tensor, stage: Dict[str, Any]) -> torch.Tensor:
    action = stage["action"]
    if action == "resize":
        return resize(img, height=stage.get("height"), width=stage.get("width"),
                      size=stage.get("size"),
                      keep_aspect_ratio=stage.get("keepAspectRatio", False))
    if action == "crop":
        return crop(img, stage["x"], stage["y"], stage["height"], stage["width"])
    if action == "centercrop":
        return center_crop(img, stage["height"], stage["width"])
    if action == "colorformat":
        return color_format(img, stage["format"])
    if action == "blur":
        return blur(img, stage["height"], stage["width"])
    if action == "threshold":
        return threshold(img, stage["threshold"], stage["maxVal"],
                         stage.get("type", THRESH_BINARY))
    if action == "gaussiankernel":
        return gaussian_kernel(img, stage["apertureSize"], stage["sigma"])
    if action == "flip":
        return flip(img, stage["flipCode"])
    raise ValueError(f"unsupported transformation {action!r}")


def apply_pipeline(img: torch.Tensor,
                   stages: List[Dict[str, Any]]) -> torch.Tensor:
    for stage in stages:
        img = apply_stage(img, stage)
    return img


def unroll_chw(img: np.ndarray) -> np.ndarray:
    """Image (HWC, uint8-ish) -> flat float64 vector in C-major (c,h,w) order —
    exactly the reference's UnrollImage layout
    (ref: core/.../image/UnrollImage.scala:31-56)."""
    arr = np.asarray(img, dtype=np.float64)
    if arr.ndim == 2:
        arr = arr[..., None]
    return np.transpose(arr, (2, 0, 1)).reshape(-1)

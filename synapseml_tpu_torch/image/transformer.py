"""Image pipeline stages: ImageTransformer, UnrollImage, Resize, Augmenter.

The counterpart of the reference package's ``image/transformer.py``
(itself the rebuild of ref: opencv/src/main/scala/com/microsoft/ml/spark/
opencv/ImageTransformer.scala:38-275 — a pipeline of Mat ops encoded as
``Map[String, Any]`` stage dicts; ImageSetAugmenter.scala:18;
core/.../image/UnrollImage.scala:31-56, ResizeImageTransformer.scala).

Images ride in object columns as HWC numpy arrays (uint8 or float32).
Each transform groups rows by input shape; a shape's rows are stacked on
the host, copied to the device once, run through the stage pipeline as
one ``[B, H, W, C]`` float32 batch (where the reference jits one XLA
program a shape) and copied back once — no round trip per image.

``transform(table, device="cuda")`` runs on the card and raises without
CUDA; ``device="cpu"`` runs the same ops on the CPU.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, List

import numpy as np
import torch

from synapseml_tpu_torch import device as device_policy
from synapseml_tpu_torch.core.param import HasInputCol, HasOutputCol, Param
from synapseml_tpu_torch.core.pipeline import Transformer
from synapseml_tpu_torch.data.table import Table
from synapseml_tpu_torch.image import ops
from synapseml_tpu_torch.image.reader import decode_image


def _as_image(v: Any) -> np.ndarray:
    arr = np.asarray(v)
    if arr.ndim == 2:
        arr = arr[..., None]
    return arr


def shape_batched(images: np.ndarray,
                  batch_fn: Callable[[torch.Tensor], torch.Tensor],
                  device: torch.device) -> np.ndarray:
    """Apply ``batch_fn`` (``[B, H, W, C]`` float32 tensor -> ``[B, ...]``
    tensor) to an object column of images, one call a distinct shape, and
    scatter the results back in row order (``None`` rows stay ``None``)."""
    out = np.empty(len(images), dtype=object)
    by_shape: Dict[Any, List[int]] = {}
    for i, v in enumerate(images):
        if v is None:
            out[i] = None
            continue
        by_shape.setdefault(_as_image(v).shape, []).append(i)
    for idxs in by_shape.values():
        batch = np.stack([_as_image(images[i]) for i in idxs])
        x = torch.from_numpy(batch).to(device).to(torch.float32)
        res = batch_fn(x).cpu().numpy()
        for j, i in enumerate(idxs):
            out[i] = res[j]
    return out


class ImageTransformer(Transformer, HasInputCol, HasOutputCol):
    """Apply a list of param-map stages to an image column
    (ref: ImageTransformer.scala:38-275; stage dicts are byte-compatible:
    ``{"action": "resize", "height": .., "width": ..}`` etc.).

    Fluent helpers mirror the reference's builder API: ``.resize()``,
    ``.crop()``, ``.center_crop()``, ``.color_format()``, ``.blur()``,
    ``.threshold()``, ``.gaussian_kernel()``, ``.flip()``.
    """

    stages = Param("list of stage param-maps", default=())
    to_uint8 = Param("clip+cast output back to uint8", default=False)

    def _add(self, stage: Dict[str, Any]) -> "ImageTransformer":
        self.set(stages=tuple(self.stages) + (stage,))
        return self

    def resize(self, height: int = None, width: int = None, size: int = None,
               keep_aspect_ratio: bool = False) -> "ImageTransformer":
        return self._add({"action": "resize", "height": height,
                          "width": width, "size": size,
                          "keepAspectRatio": keep_aspect_ratio})

    def crop(self, x: int, y: int, height: int, width: int):
        return self._add({"action": "crop", "x": x, "y": y,
                          "height": height, "width": width})

    def center_crop(self, height: int, width: int):
        return self._add({"action": "centercrop", "height": height,
                          "width": width})

    def color_format(self, format: int):
        return self._add({"action": "colorformat", "format": format})

    def blur(self, height: int, width: int):
        return self._add({"action": "blur", "height": height, "width": width})

    def threshold(self, threshold: float, max_val: float, type: int = 0):
        return self._add({"action": "threshold", "threshold": threshold,
                          "maxVal": max_val, "type": type})

    def gaussian_kernel(self, aperture_size: int, sigma: float):
        return self._add({"action": "gaussiankernel",
                          "apertureSize": aperture_size, "sigma": sigma})

    def flip(self, flip_code: int = ops.FLIP_LEFT_RIGHT):
        return self._add({"action": "flip", "flipCode": flip_code})

    def _transform(self, table: Table, device) -> Table:
        dev = device_policy.resolve(device)
        stages = list(self.stages)
        to_uint8 = self.to_uint8

        def batch_fn(imgs: torch.Tensor) -> torch.Tensor:
            y = ops.apply_pipeline(imgs, stages)
            if to_uint8:
                y = torch.clamp(torch.round(y), 0, 255).to(torch.uint8)
            return y
        return table.with_column(
            self.output_col, shape_batched(table[self.input_col], batch_fn,
                                           dev))


class ResizeImageTransformer(Transformer, HasInputCol, HasOutputCol):
    """Standalone resize stage (ref: core/.../image/ResizeImageTransformer.scala:110)."""

    height = Param("target height", default=None)
    width = Param("target width", default=None)
    size = Param("shorter-side size (keepAspectRatio)", default=None)
    keep_aspect_ratio = Param("preserve aspect ratio", default=False)

    def _transform(self, table: Table, device) -> Table:
        dev = device_policy.resolve(device)
        stage = {"action": "resize", "height": self.height,
                 "width": self.width, "size": self.size,
                 "keepAspectRatio": self.keep_aspect_ratio}
        return table.with_column(
            self.output_col,
            shape_batched(table[self.input_col],
                          lambda imgs: ops.apply_stage(imgs, stage), dev))


def _unrolled_column(vectors: np.ndarray) -> np.ndarray:
    """Uniform lengths with no null collapse to a dense ``[N, D]`` column."""
    lens = {o.shape[0] for o in vectors if o is not None}
    if len(lens) == 1 and not any(o is None for o in vectors):
        return np.stack(list(vectors))
    return vectors


class UnrollImage(Transformer, HasInputCol, HasOutputCol):
    """Image -> flat float vector in channel-major (c, h, w) order — exactly
    the reference's layout (ref: core/.../image/UnrollImage.scala:31-56).
    Host numpy, as in the reference package."""

    def _transform(self, table: Table, device) -> Table:
        device_policy.resolve(device)
        vals = table[self.input_col]
        out = np.empty(len(vals), dtype=object)
        for i, v in enumerate(vals):
            out[i] = None if v is None else ops.unroll_chw(_as_image(v))
        return table.with_column(self.output_col, _unrolled_column(out))


class UnrollBinaryImage(Transformer, HasInputCol, HasOutputCol):
    """Decode bytes then unroll (ref: core/.../image/UnrollImage.scala
    UnrollBinaryImage variant). Host numpy, as in the reference package."""

    def _transform(self, table: Table, device) -> Table:
        device_policy.resolve(device)
        vals = table[self.input_col]
        out = np.empty(len(vals), dtype=object)
        for i, v in enumerate(vals):
            img = None if v is None else decode_image(bytes(v))
            out[i] = None if img is None else ops.unroll_chw(img)
        return table.with_column(self.output_col, _unrolled_column(out))


class ImageSetAugmenter(Transformer, HasInputCol, HasOutputCol):
    """Dataset augmentation by flips: emits the original rows plus one row
    per enabled flip (ref: opencv/.../ImageSetAugmenter.scala:18). Host
    numpy slicing, as in the reference package."""

    flip_left_right = Param("add left-right flipped copies", default=True)
    flip_up_down = Param("add up-down flipped copies", default=False)

    def _transform(self, table: Table, device) -> Table:
        device_policy.resolve(device)
        base = table.with_column(self.output_col, table[self.input_col])
        parts = [base]
        for enabled, code in [(self.flip_left_right, ops.FLIP_LEFT_RIGHT),
                              (self.flip_up_down, ops.FLIP_UP_DOWN)]:
            if not enabled:
                continue
            vals = table[self.input_col]
            flipped = np.empty(len(vals), dtype=object)
            for i, v in enumerate(vals):
                if v is None:
                    flipped[i] = None
                    continue
                arr = _as_image(v)
                arr = arr[:, ::-1] if code == ops.FLIP_LEFT_RIGHT else arr[::-1]
                flipped[i] = np.ascontiguousarray(arr)
            parts.append(table.with_column(self.output_col, flipped))
        return parts[0].concat(*parts[1:]) if len(parts) > 1 else parts[0]

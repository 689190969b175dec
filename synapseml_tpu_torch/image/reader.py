"""Image IO: decode bytes/files into HWC uint8 arrays.

Rebuild of the reference's image source + ImageUtils
(ref: core/src/main/scala/org/apache/spark/ml/source/image/PatchedImageFileFormat.scala:24,
core/.../io/image/ImageUtils.scala — Spark's image rows carry BGR bytes;
here images are HWC **RGB** numpy arrays, with explicit converters for the
Spark-layout interop).

Decoding uses PIL when available; a dependency-free PPM/PGM parser covers
environments without it (and the test fixtures). Without PIL, PNG and JPEG
bytes decode to ``None``, as in the reference package: there, binary input
must be PPM/PGM. Numpy only; a copy of the reference package's module.
"""
from __future__ import annotations

import io
import os
from typing import Optional

import numpy as np

from synapseml_tpu_torch.data.table import Table
from synapseml_tpu_torch.io.binary import read_binary_files

_IMAGE_EXTENSIONS = (".jpg", ".jpeg", ".png", ".gif", ".bmp", ".ppm", ".pgm",
                     ".tif", ".tiff", ".webp")


def _decode_pnm(data: bytes) -> Optional[np.ndarray]:
    """Minimal P5 (PGM) / P6 (PPM) binary decoder; None for anything it
    cannot decode exactly (corrupt headers, truncated data, 16-bit)."""
    if not data[:2] in (b"P5", b"P6"):
        return None
    try:
        fields = []
        pos = 2
        while len(fields) < 3:
            while pos < len(data) and data[pos:pos + 1].isspace():
                pos += 1
            if data[pos:pos + 1] == b"#":
                while pos < len(data) and data[pos:pos + 1] != b"\n":
                    pos += 1
                continue
            start = pos
            while pos < len(data) and not data[pos:pos + 1].isspace():
                pos += 1
            if start == pos:
                return None
            fields.append(int(data[start:pos]))
        pos += 1  # single whitespace after maxval
        w, h, maxval = fields
        if maxval != 255:  # 16-bit samples: let PIL handle it
            return None
        c = 3 if data[:2] == b"P6" else 1
        arr = np.frombuffer(data, dtype=np.uint8, count=w * h * c, offset=pos)
        return arr.reshape(h, w, c)
    except (ValueError, IndexError):
        return None


def decode_image(data: bytes) -> Optional[np.ndarray]:
    """bytes -> HWC uint8 RGB array (None when undecodable — the patched
    format's codec-tolerance, ref: PatchedImageFileFormat.scala)."""
    pnm = _decode_pnm(data)
    if pnm is not None:
        return pnm
    try:
        from PIL import Image
    except ImportError:
        return None
    try:
        img = Image.open(io.BytesIO(data))
        if img.mode not in ("RGB", "L"):
            img = img.convert("RGB")
        arr = np.asarray(img)
        if arr.ndim == 2:
            arr = arr[..., None]
        return arr.astype(np.uint8)
    except Exception:  # noqa: BLE001 - undecodable bytes -> null row
        return None


def read_image_files(path: str, recursive: bool = True,
                     sample_ratio: float = 1.0, seed: int = 0,
                     drop_undecodable: bool = True) -> Table:
    """Read a directory (or zip) of images into a Table with columns
    ``path`` and ``image`` (HWC uint8 object column)."""
    raw = read_binary_files(path, recursive=recursive,
                            sample_ratio=sample_ratio, seed=seed)
    keep = [
        i for i, p in enumerate(raw["path"])
        if os.path.splitext(p)[1].lower() in _IMAGE_EXTENSIONS
    ]
    paths, images = [], []
    for i in keep:
        img = decode_image(bytes(raw["bytes"][i]))
        if img is None and drop_undecodable:
            continue
        paths.append(raw["path"][i])
        images.append(img)
    img_col = np.empty(len(images), dtype=object)
    img_col[:] = images
    return Table({"path": np.array(paths, dtype=object), "image": img_col})


def to_spark_layout(img: np.ndarray) -> bytes:
    """HWC RGB -> Spark ImageSchema's BGR row-major bytes
    (ref: ImageUtils.scala toSparkImage)."""
    arr = np.asarray(img, dtype=np.uint8)
    if arr.shape[-1] == 3:
        arr = arr[..., ::-1]
    return arr.tobytes()


def from_spark_layout(data: bytes, height: int, width: int,
                      n_channels: int) -> np.ndarray:
    """Spark ImageSchema BGR bytes -> HWC RGB array."""
    arr = np.frombuffer(data, dtype=np.uint8).reshape(height, width,
                                                      n_channels)
    if n_channels == 3:
        arr = arr[..., ::-1]
    return arr.copy()

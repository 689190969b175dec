"""Generate the image-stage, ImageFeaturizer and explainer fixture.

Runs the JAX package on the CPU over inputs made here from seeds and
writes ``image_explainer_fixtures.npz``; the port's ``chip_smoke.py``
(phases 26-27) and its tests hold the port to it. The inputs are stored
beside the outputs, so the port reads the same pixels whatever numpy it
runs under:

- ``images``: 8 seeded 256x256x3 uint8 images (smooth sinusoids plus
  noise; :func:`images`);
- the stage pipeline ``PIPELINE`` (resize to 240, center-crop 224, flip,
  blur 3x3, gaussian 5, threshold, BT.601 gray) through the JAX
  ``ImageTransformer`` one prefix at a time: ``stage_<k>`` is every 8th
  row and column of the images after stages 0..k, float32;
  ``pipeline_uint8`` the same of the whole pipeline with ``to_uint8``;
- ``ImageFeaturizer`` over ``zoo.resnet50(num_classes=1000,
  image_size=224, seed=0)`` with ``cut_output_layers=1`` on the 8 images
  (resized to 224 by ``_prepare``): ``features_f32`` and
  ``features_bf16`` (widened exactly), each [8, 2048];
- ``TabularSHAP`` and ``TabularLIME`` (100 samples, seed 0, class 1) over
  the Adult fixture model (``lgbm_adult_100x31.txt``) on the first 256
  rows of ``lgbm_adult_100x31_io.npz``: ``tabular_shap`` [256, 1, 15],
  ``tabular_lime`` [256, 1, 14];
- ``ImageLIME`` and ``ImageSHAP`` (``cell_size=16``, 512 samples, seed 0,
  class 0) over ``ImageFeaturizer(cut_output_layers=0)`` (the 1,000
  logits, float32) on the 224x224 center crops of images 0 and 1:
  ``image_lime`` [2, 1, 196], ``image_shap`` [2, 1, 197], the superpixels
  ``superpixels`` [2, 224, 224] (uint8), the pixels the reference's
  final centers place within 1e-5 of a tie (``superpixel_ties``, see
  :func:`slic_ties`), and the scores the surrogates
  were fitted to (``image_lime_y``, ``image_shap_y`` [2, 512];
  ``image_shap_fnull``);
- ``transfer_accuracy``: the held-out accuracy of the transfer head
  (``texture_dataset(200, 224)``'s features, a 20-iteration, 7-leaf
  ``LightGBMClassifier`` fitted on 300 rows, scored on 100).

Run from the repo root:  python tests/fixtures/make_image_explainer_fixtures.py
(~2 min on 8 CPU cores). The generators here import no JAX;
:func:`slic_ties` imports it when called.
"""
from __future__ import annotations

import json
import os
import sys
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
OUT = os.path.join(HERE, "image_explainer_fixtures.npz")
ADULT = os.path.join(HERE, "lgbm_adult_100x31.txt")
ADULT_IO = os.path.join(HERE, "lgbm_adult_100x31_io.npz")
SIZE, CROP, STRIDE = 256, 224, 8
PIPELINE = (
    {"action": "resize", "height": 240, "width": 240, "size": None,
     "keepAspectRatio": False},
    {"action": "centercrop", "height": CROP, "width": CROP},
    {"action": "flip", "flipCode": 1},
    {"action": "blur", "height": 3, "width": 3},
    {"action": "gaussiankernel", "apertureSize": 5, "sigma": 0.0},
    {"action": "threshold", "threshold": 200.0, "maxVal": 255.0, "type": 2},
    {"action": "colorformat", "format": 7},
)
TABULAR_ROWS, TABULAR_SAMPLES = 256, 100
IMAGE_SAMPLES, CELL = 512, 16.0
TIE_REL = 1e-5                # a pixel this near a tie may flip
TRANSFER = dict(n_per_class=200, size=CROP, n_train=300, n_test=100)
HEAD = dict(num_iterations=20, num_leaves=7, min_data_in_leaf=5)


def images(n: int = 8, size: int = SIZE, seed: int = 0) -> np.ndarray:
    """``n`` seeded [size, size, 3] uint8 images: four random sinusoids a
    channel around mid-gray plus N(0, 3) noise."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:size, 0:size] / size
    out = np.empty((n, size, size, 3), np.uint8)
    for i in range(n):
        img = np.full((size, size, 3), 128.0)
        for c in range(3):
            for _ in range(4):
                fy, fx = rng.uniform(-6, 6, 2)
                amp, ph = rng.uniform(10, 35), rng.uniform(0, 2 * np.pi)
                img[..., c] += amp * np.sin(2 * np.pi * (fy * yy + fx * xx)
                                            + ph)
        img += rng.normal(0, 3, img.shape)
        out[i] = np.clip(np.round(img), 0, 255).astype(np.uint8)
    return out


def center_crop(img: np.ndarray, size: int = CROP) -> np.ndarray:
    y0 = (img.shape[0] - size) // 2
    x0 = (img.shape[1] - size) // 2
    return img[y0:y0 + size, x0:x0 + size]


def texture_dataset(n_per_class=40, size=32, seed=0):
    """Two texture classes (the flower-photos stand-in): a copy of
    ``examples/image_transfer_learning.py``'s generator."""
    rng = np.random.default_rng(seed)
    imgs, labels = [], []
    for cls in (0, 1):
        for _ in range(n_per_class):
            freq = rng.integers(2, 5)
            ramp = np.arange(size) * freq * 2 * np.pi / size
            wave = np.sin(ramp) * 100 + 128
            img = np.tile(wave[None, :] if cls == 0 else wave[:, None],
                          (size, 1) if cls == 0 else (1, size))
            img = img[..., None].repeat(3, -1)
            img = img + rng.normal(0, 20, img.shape)
            imgs.append(np.clip(img, 0, 255).astype(np.uint8))
            labels.append(cls)
    idx = rng.permutation(len(imgs))
    col = np.empty(len(imgs), dtype=object)
    for i, j in enumerate(idx):
        col[i] = imgs[j]
    return col, np.asarray(labels)[idx]


def obj_col(arrays) -> np.ndarray:
    col = np.empty(len(arrays), dtype=object)
    for i, a in enumerate(arrays):
        col[i] = a
    return col


def adult_columns(x: np.ndarray) -> dict:
    """The Adult rows as 14 scalar float64 columns ``f0..f13``."""
    return {f"f{j}": x[:, j].astype(np.float64) for j in range(x.shape[1])}


def slic_ties(pix, yx, grid_h, grid_w, spatial_w, iters):
    """The reference's SLIC assignment of one image and the pixels its
    final centers place within ``TIE_REL`` (relative) of a tie between
    their two nearest: there a last-bit difference in a center's sum may
    send the pixel to the other one.

    The reference's ``_slic`` (synapseml_tpu/explainers/superpixel.py
    :37-63) returns only the assignment, so its loop is repeated here line
    for line returning the centers too, and checked to give the same
    assignment. Imports JAX (on the CPU)."""
    import jax
    import jax.numpy as jnp

    from synapseml_tpu.explainers.superpixel import _slic

    def with_centers(pix, yx):
        h, w, _ = pix.shape
        p = grid_h * grid_w
        flat = pix.reshape(-1, pix.shape[-1])
        pos = yx.reshape(-1, 2)
        cy = (jnp.arange(grid_h) + 0.5) * (h / grid_h)
        cx = (jnp.arange(grid_w) + 0.5) * (w / grid_w)
        cyx = jnp.stack(jnp.meshgrid(cy, cx, indexing="ij"),
                        -1).reshape(-1, 2)
        c_idx = (jnp.clip(cyx[:, 0].astype(jnp.int32), 0, h - 1) * w
                 + jnp.clip(cyx[:, 1].astype(jnp.int32), 0, w - 1))
        centers = jnp.concatenate([flat[c_idx], cyx], axis=1)

        def body(_, centers):
            cd = jnp.sum((flat[:, None, :] - centers[None, :, :-2]) ** 2, -1)
            sd = jnp.sum((pos[:, None, :] - centers[None, :, -2:]) ** 2, -1)
            assign = jnp.argmin(cd + spatial_w * sd, axis=1)
            feat = jnp.concatenate([flat, pos], axis=1)
            sums = jax.ops.segment_sum(feat, assign, num_segments=p)
            cnts = jax.ops.segment_sum(jnp.ones((flat.shape[0],)), assign,
                                       num_segments=p)
            new = sums / jnp.maximum(cnts, 1.0)[:, None]
            return jnp.where(cnts[:, None] > 0, new, centers)

        centers = jax.lax.fori_loop(0, iters, body, centers)
        cd = jnp.sum((flat[:, None, :] - centers[None, :, :-2]) ** 2, -1)
        sd = jnp.sum((pos[:, None, :] - centers[None, :, -2:]) ** 2, -1)
        return (jnp.argmin(cd + spatial_w * sd, axis=1).astype(jnp.int32),
                centers)

    want = np.asarray(_slic(jnp.asarray(pix), jnp.asarray(yx), grid_h,
                            grid_w, spatial_w, iters))
    again, centers = jax.jit(with_centers)(jnp.asarray(pix), jnp.asarray(yx))
    if not np.array_equal(np.asarray(again), want):
        raise AssertionError("the repeated SLIC loop left the reference's")
    c = np.asarray(centers, np.float64)
    flat = pix.reshape(-1, pix.shape[-1]).astype(np.float64)
    pos = yx.reshape(-1, 2).astype(np.float64)
    dist = (((flat[:, None] - c[None, :, :-2]) ** 2).sum(-1)
            + spatial_w * ((pos[:, None] - c[None, :, -2:]) ** 2).sum(-1))
    two = np.sort(dist, axis=1)[:, :2]
    return want, (two[:, 1] - two[:, 0]) <= TIE_REL * np.maximum(two[:, 0],
                                                                 1e-30)


def slic_inputs(img: np.ndarray, cell: float = CELL,
                modifier: float = 130.0):
    """``superpixels``'s arguments to ``_slic`` for one image."""
    pix = np.asarray(img, np.float32)
    if pix.ndim == 2:
        pix = pix[..., None]
    if pix.max() <= 1.5:
        pix = pix * 255.0
    h, w = pix.shape[:2]
    ys, xs = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
    yx = np.stack([ys, xs], -1).astype(np.float32)
    return (pix, yx, max(1, round(h / cell)), max(1, round(w / cell)),
            (modifier / cell) ** 2)


def main() -> None:
    sys.path.insert(0, os.path.dirname(HERE))
    sys.path.insert(0, os.path.dirname(os.path.dirname(HERE)))
    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    import jax

    jax.config.update("jax_platforms", "cpu")
    from synapseml_tpu.core.pipeline import Transformer
    from synapseml_tpu.data.table import Table
    from synapseml_tpu.explainers import (ImageLIME, ImageSHAP, TabularLIME,
                                          TabularSHAP)
    from synapseml_tpu.gbdt.estimators import (LightGBMClassificationModel,
                                               LightGBMClassifier)
    from synapseml_tpu.image import ImageFeaturizer, ImageTransformer
    from synapseml_tpu.onnx import zoo

    start = time.perf_counter()
    out = {"jax_version": np.asarray(jax.__version__),
           "pipeline": np.asarray(json.dumps(PIPELINE))}
    imgs = images()
    out["images"] = imgs
    col = obj_col(list(imgs))
    for k in range(len(PIPELINE)):
        t = ImageTransformer(input_col="image", output_col="out",
                             stages=PIPELINE[:k + 1])
        res = np.stack(list(t.transform(Table({"image": col}))["out"]))
        out[f"stage_{k}"] = res[:, ::STRIDE, ::STRIDE].astype(np.float32)
    t = ImageTransformer(input_col="image", output_col="out",
                         stages=PIPELINE, to_uint8=True)
    res = np.stack(list(t.transform(Table({"image": col}))["out"]))
    out["pipeline_uint8"] = res[:, ::STRIDE, ::STRIDE]

    blob = zoo.resnet50(num_classes=1000, image_size=CROP, seed=0)
    for dtype, key in (("float32", "features_f32"),
                       ("bfloat16", "features_bf16")):
        feat = ImageFeaturizer(model_bytes=blob, cut_output_layers=1,
                               input_col="image", output_col="features",
                               compute_dtype=dtype, mini_batch_size=64)
        out[key] = np.asarray(feat.transform(Table({"image": col}))[
            "features"], np.float32)

    adult = LightGBMClassificationModel.load_native_model(
        ADULT, feature_cols=[f"f{j}" for j in range(14)])
    x = np.load(ADULT_IO)["x"][:TABULAR_ROWS]
    for cls, key in ((TabularSHAP, "tabular_shap"),
                     (TabularLIME, "tabular_lime")):
        ex = cls(model=adult, input_cols=[f"f{j}" for j in range(14)],
                 target_col="probability", target_classes=(1,),
                 num_samples=TABULAR_SAMPLES, seed=0)
        out[key] = np.asarray(ex.transform(Table(adult_columns(x)))[
            "output"], np.float32)

    logits = ImageFeaturizer(model_bytes=blob, cut_output_layers=0,
                             input_col="image", output_col="logits")

    class Recorded(Transformer):
        """The featurizer, keeping every score column it returns."""

        def _transform(self, table):
            res = logits.transform(table)
            self.__dict__.setdefault("seen", []).append(
                np.asarray(res["logits"], np.float32)[:, 0].copy())
            return res

    crops = obj_col([center_crop(im) for im in imgs[:2]])
    for cls, key in ((ImageLIME, "image_lime"), (ImageSHAP, "image_shap")):
        rec = Recorded()
        ex = cls(model=rec, input_col="image", target_col="logits",
                 target_classes=(0,), num_samples=IMAGE_SAMPLES, seed=0,
                 cell_size=CELL)
        res = ex.transform(Table({"image": crops}))
        out[key] = np.asarray(res["output"], np.float32)
        out[key + "_y"] = rec.seen[0].reshape(2, IMAGE_SAMPLES)
        if cls is ImageSHAP:
            out["image_shap_fnull"] = rec.seen[1]
        sp = np.stack(list(res["superpixels"]))
        assert sp.max() < 256
        out["superpixels"] = sp.astype(np.uint8)
    ties = [slic_ties(*slic_inputs(im), 10)[1] for im in crops]
    out["superpixel_ties"] = np.stack(ties).reshape(2, CROP, CROP)

    tex, labels = texture_dataset(TRANSFER["n_per_class"], TRANSFER["size"])
    feat = ImageFeaturizer(model_bytes=blob, cut_output_layers=1,
                           input_col="image", output_col="features")
    feats = np.asarray(feat.transform(Table({"image": tex}))["features"])
    n_train, n_test = TRANSFER["n_train"], TRANSFER["n_test"]
    head = LightGBMClassifier(**HEAD).fit(Table({
        "features": feats[:n_train],
        "label": labels[:n_train].astype(np.float64)}))
    pred = np.asarray(head.transform(Table({
        "features": feats[n_train:n_train + n_test]}))["prediction"])
    out["transfer_accuracy"] = np.asarray(
        float((pred == labels[n_train:n_train + n_test]).mean()))

    np.savez_compressed(OUT, **out)
    print(f"wrote {OUT} ({os.path.getsize(OUT) / 1e6:.2f} MB) in "
          f"{time.perf_counter() - start:.1f} s; superpixels "
          f"{[int(s.max()) + 1 for s in out['superpixels']]}, transfer "
          f"accuracy {float(out['transfer_accuracy']):.3f}")


if __name__ == "__main__":
    main()

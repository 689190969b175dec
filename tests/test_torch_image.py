"""The port's image stages, reader and ``ImageFeaturizer`` against the JAX
package's, on the CPU.

The same seeded numpy images go through the JAX stage's
``transform(table)`` and the port's ``transform(table, "cpu")``. Float
outputs are held at atol 1e-3 on the 0-255 scale (resize and the filters
add in another order than XLA); ``to_uint8`` outputs are equal except where
the JAX float value lies within 1e-3 of ``k + 0.5``, whose rounding an
ulp decides. ``ImageFeaturizer`` runs ``zoo.tiny_resnet(image_size=32)``:
float32 at rtol = atol = 1e-4, bf16 within 5% of the largest |value|.
"""
import zipfile

import numpy as np
import pytest
import torch

from synapseml_tpu.core.pipeline import PipelineStage as JaxStage
from synapseml_tpu.data.table import Table as JaxTable
from synapseml_tpu import image as jimage
from synapseml_tpu.io.binary import read_binary_files as jax_read_binary
from synapseml_tpu.onnx import zoo as jzoo
from synapseml_tpu_torch import image
from synapseml_tpu_torch.core.pipeline import PipelineStage
from synapseml_tpu_torch.data.table import Table
from synapseml_tpu_torch.image import ops
from synapseml_tpu_torch.io import read_binary_files
from synapseml_tpu_torch.onnx.builder import GraphBuilder

ATOL = 1e-3
FEAT_TOL = 1e-4
BF16_SHARE = 0.05
HALF_TIE = 1e-3


def _img(h=24, w=32, c=3, seed=0):
    return np.random.default_rng(seed).integers(
        0, 256, (h, w, c)).astype(np.uint8)


def _obj_col(imgs):
    col = np.empty(len(imgs), dtype=object)
    for i, v in enumerate(imgs):
        col[i] = v
    return col


def _ppm(img):
    c = img.shape[-1]
    head = b"P6" if c == 3 else b"P5"
    return head + f"\n{img.shape[1]} {img.shape[0]}\n255\n".encode() \
        + img.tobytes()


def _pair(name, **params):
    return getattr(jimage, name)(**params), getattr(image, name)(**params)


def _run(pair, cols, out="out"):
    ref, port = pair
    want = ref.transform(JaxTable(dict(cols)))
    got = port.transform(Table(dict(cols)), "cpu")
    return got, want


def _close_rows(got, want, atol=ATOL):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        if w is None:
            assert g is None
            continue
        g, w = np.asarray(g), np.asarray(w)
        assert g.shape == w.shape and g.dtype == w.dtype, (g.shape, w.shape)
        np.testing.assert_allclose(g.astype(np.float64), w.astype(np.float64),
                                   atol=atol, rtol=0)


# ---------------------------------------------------------------------------
# stages
# ---------------------------------------------------------------------------

STAGE_CASES = {
    "resize": ({"action": "resize", "height": 16, "width": 20},),
    "shrink_keep_aspect": ({"action": "resize", "size": 10,
                            "keepAspectRatio": True},),
    "crop": ({"action": "crop", "x": 2, "y": 3, "height": 8, "width": 9},),
    "centercrop": ({"action": "centercrop", "height": 11, "width": 13},),
    "colorformat": ({"action": "colorformat", "format": ops.COLOR_RGB2GRAY},),
    "blur": ({"action": "blur", "height": 4, "width": 3},),
    "threshold": ({"action": "threshold", "threshold": 100.0, "maxVal": 255.0,
                   "type": ops.THRESH_BINARY_INV},),
    "gaussiankernel": ({"action": "gaussiankernel", "apertureSize": 5,
                        "sigma": 0.0},),
    "flip": ({"action": "flip", "flipCode": ops.FLIP_UP_DOWN},),
    "pipeline": ({"action": "resize", "height": 30, "width": 30},
                 {"action": "centercrop", "height": 24, "width": 24},
                 {"action": "flip", "flipCode": ops.FLIP_LEFT_RIGHT},
                 {"action": "blur", "height": 3, "width": 3},
                 {"action": "colorformat", "format": ops.COLOR_BGR2GRAY}),
}


@pytest.mark.parametrize("case", sorted(STAGE_CASES))
def test_image_transformer_stage_matches_jax(case):
    imgs = _obj_col([_img(seed=i) for i in range(4)])
    pair = _pair("ImageTransformer", input_col="image", output_col="out",
                 stages=STAGE_CASES[case])
    got, want = _run(pair, {"image": imgs})
    _close_rows(got["out"], want["out"])


def test_fluent_builders_write_the_reference_stage_dicts():
    kw = dict(input_col="image", output_col="out")
    jt = jimage.ImageTransformer(**kw)
    pt = image.ImageTransformer(**kw)
    for t in (jt, pt):
        t.resize(height=16, width=16).crop(1, 2, 10, 11).center_crop(8, 8) \
            .color_format(ops.COLOR_BGR2RGB).blur(3, 3) \
            .threshold(100.0, 255.0, ops.THRESH_TRUNC) \
            .gaussian_kernel(3, 0.5).flip()
    assert pt.stages == jt.stages
    got, want = _run((jt, pt), {"image": _obj_col([_img(seed=9)])})
    _close_rows(got["out"], want["out"])


def test_mixed_shapes_and_null_rows_keep_row_order():
    imgs = _obj_col([_img(20, 20, seed=1), _img(30, 40, seed=2), None,
                     _img(20, 20, seed=3), _img(12, 12, 1, seed=4)])
    pair = _pair("ImageTransformer", input_col="image", output_col="out",
                 stages=({"action": "resize", "height": 8, "width": 8},))
    got, want = _run(pair, {"image": imgs})
    assert got["out"][2] is None
    assert got["out"][4].shape == (8, 8, 1)
    _close_rows(got["out"], want["out"])


def test_to_uint8_equal_except_at_half_ties():
    imgs = _obj_col([_img(seed=i) for i in range(6)])
    stages = ({"action": "resize", "height": 17, "width": 23},
              {"action": "blur", "height": 2, "width": 2})
    ref_f = jimage.ImageTransformer(input_col="image", output_col="out",
                                    stages=stages)
    floats = ref_f.transform(JaxTable({"image": imgs}))["out"]
    got, want = _run(_pair("ImageTransformer", input_col="image",
                           output_col="out", stages=stages, to_uint8=True),
                     {"image": imgs})
    excluded = 0
    for g, w, f in zip(got["out"], want["out"], floats):
        assert g.dtype == np.uint8 and w.dtype == np.uint8
        frac = np.abs(np.asarray(f) - np.floor(f) - 0.5)
        tie = frac < HALF_TIE
        excluded += int(tie.sum())
        np.testing.assert_array_equal(g[~tie], w[~tie])
        assert np.all(np.abs(g[tie].astype(int) - w[tie].astype(int)) <= 1)
    assert excluded < 0.01 * sum(np.asarray(f).size for f in floats)


def test_resize_image_transformer_keep_aspect_matches_jax():
    pair = _pair("ResizeImageTransformer", input_col="image",
                 output_col="out", size=20, keep_aspect_ratio=True)
    got, want = _run(pair, {"image": _obj_col([_img(40, 80), _img(60, 30)])})
    assert got["out"][0].shape == (20, 40, 3)
    _close_rows(got["out"], want["out"])


@pytest.mark.parametrize("ragged", [False, True])
def test_unroll_image_matches_jax(ragged):
    imgs = [_img(5, 7, seed=1), _img(5, 7, seed=2)]
    if ragged:
        imgs += [_img(3, 4, seed=3), None]
    got, want = _run(_pair("UnrollImage", input_col="image", output_col="v"),
                     {"image": _obj_col(imgs)})
    if not ragged:
        assert got["v"].dtype == np.float64 and got["v"].ndim == 2
        np.testing.assert_array_equal(got["v"], want["v"])
    else:
        _close_rows(got["v"], want["v"], atol=0)


def test_unroll_binary_image_matches_jax():
    blobs = _obj_col([_ppm(_img(6, 5, seed=1)), _ppm(_img(6, 5, 1, seed=2)),
                      b"garbage", None])
    got, want = _run(_pair("UnrollBinaryImage", input_col="b",
                           output_col="v"), {"b": blobs})
    _close_rows(got["v"], want["v"], atol=0)
    assert got["v"][2] is None and got["v"][3] is None


def test_image_set_augmenter_matches_jax():
    imgs = _obj_col([_img(seed=3), None, _img(seed=4)])
    got, want = _run(_pair("ImageSetAugmenter", input_col="image",
                           output_col="aug", flip_left_right=True,
                           flip_up_down=True),
                     {"image": imgs, "label": np.array([0, 1, 2])})
    assert got.num_rows == 9
    assert list(got["label"]) == list(want["label"])
    _close_rows(got["aug"], want["aug"], atol=0)


@pytest.mark.parametrize("stage,params", [
    ("ImageTransformer", dict(stages=({"action": "flip", "flipCode": 1},))),
    ("ResizeImageTransformer", dict(height=4, width=4)),
    ("UnrollImage", {}), ("UnrollBinaryImage", {}),
    ("ImageSetAugmenter", {}),
])
def test_stages_default_to_cuda_and_raise_without_it(stage, params,
                                                     monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    t = getattr(image, stage)(input_col="image", output_col="out", **params)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        t.transform(Table({"image": _obj_col([_img(4, 4)])}))


# ---------------------------------------------------------------------------
# IO
# ---------------------------------------------------------------------------

def test_decode_ppm_pgm_and_garbage_as_the_reference():
    for img in (_img(9, 11), _img(7, 5, 1)):
        data = _ppm(img)
        np.testing.assert_array_equal(image.decode_image(data), img)
        np.testing.assert_array_equal(image.decode_image(data),
                                      jimage.decode_image(data))
    comment = b"P6\n# made by hand\n3 2\n255\n" + _img(2, 3).tobytes()
    np.testing.assert_array_equal(image.decode_image(comment),
                                  jimage.decode_image(comment))
    for bad in (b"not an image", b"P6\n3"):
        assert image.decode_image(bad) is None
        assert jimage.decode_image(bad) is None
    # 16-bit samples are left to PIL: both decode them, or both give None
    wide = b"P6\n3 2\n65535\n" + bytes(36)
    got, want = image.decode_image(wide), jimage.decode_image(wide)
    assert (got is None) == (want is None)
    if want is not None:
        np.testing.assert_array_equal(got, want)


def test_read_image_files_with_zip_matches_jax(tmp_path):
    a, b = _img(seed=5), _img(seed=6)
    (tmp_path / "a.ppm").write_bytes(_ppm(a))
    with zipfile.ZipFile(tmp_path / "batch.zip", "w") as zf:
        zf.writestr("b.ppm", _ppm(b))
        zf.writestr("notes.txt", b"skip me")
    (tmp_path / "broken.ppm").write_bytes(b"corrupt")
    got = image.read_image_files(str(tmp_path))
    want = jimage.read_image_files(str(tmp_path))
    assert list(got["path"]) == list(want["path"])
    assert got.num_rows == 2
    by_path = dict(zip(got["path"], got["image"]))
    np.testing.assert_array_equal(by_path[str(tmp_path / "a.ppm")], a)
    np.testing.assert_array_equal(
        by_path[str(tmp_path / "batch.zip") + "/b.ppm"], b)
    kept = image.read_image_files(str(tmp_path), drop_undecodable=False)
    assert kept.num_rows == 3


@pytest.mark.parametrize("ratio,recursive,pattern", [
    (1.0, True, None), (0.5, True, None), (1.0, False, "*.bin")])
def test_read_binary_files_matches_jax(tmp_path, ratio, recursive, pattern):
    (tmp_path / "sub").mkdir()
    for i in range(12):
        where = tmp_path / "sub" if i % 3 == 0 else tmp_path
        (where / f"f{i:02d}.bin").write_bytes(bytes([i]) * (i + 1))
    with zipfile.ZipFile(tmp_path / "z.zip", "w") as zf:
        zf.writestr("inner/x.bin", b"xyz")
    got = read_binary_files(str(tmp_path), recursive=recursive,
                            pattern=pattern, sample_ratio=ratio, seed=3)
    want = jax_read_binary(str(tmp_path), recursive=recursive,
                           pattern=pattern, sample_ratio=ratio, seed=3)
    assert list(got["path"]) == list(want["path"])
    assert [bytes(v) for v in got["bytes"]] == [bytes(v)
                                                for v in want["bytes"]]
    np.testing.assert_array_equal(got["length"], want["length"])


def test_spark_layout_roundtrip_and_bytes_match_jax():
    for img in (_img(4, 6), _img(3, 5, 1)):
        data = image.to_spark_layout(img)
        assert data == jimage.to_spark_layout(img)
        back = image.from_spark_layout(data, *img.shape)
        np.testing.assert_array_equal(back, img)


# ---------------------------------------------------------------------------
# ImageFeaturizer
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def tiny():
    return jzoo.tiny_resnet(image_size=32, num_classes=10)


def _feat_pair(blob, **params):
    kw = dict(model_bytes=blob, image_size=32, input_col="image",
              output_col="features", mini_batch_size=8)
    kw.update(params)
    return jimage.ImageFeaturizer(**kw), image.ImageFeaturizer(**kw)


def _feats_close(got, want, bf16=False):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape and got.dtype == np.float32
    if bf16:
        span = float(np.abs(want).max())
        assert float(np.abs(got - want).max()) <= BF16_SHARE * span
    else:
        np.testing.assert_allclose(got, want, rtol=FEAT_TOL, atol=FEAT_TOL)


@pytest.mark.parametrize("cut", [0, 1])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_featurizer_matches_jax(tiny, cut, dtype):
    imgs = _obj_col([_img(40, 36, seed=i) for i in range(19)]
                    + [_img(32, 32, seed=30)])
    pair = _feat_pair(tiny, cut_output_layers=cut, compute_dtype=dtype)
    got, want = _run(pair, {"image": imgs})
    assert got["features"].shape == (20, 10 if cut == 0 else 64)
    _feats_close(got["features"], want["features"], dtype == "bfloat16")


def test_featurizer_binary_input_equals_decoded_and_jax(tiny):
    imgs = [_img(32, 32, seed=i) for i in range(5)]
    blobs = _obj_col([_ppm(im) for im in imgs])
    got, want = _run(_feat_pair(tiny), {"image": blobs})
    _feats_close(got["features"], want["features"])
    port = image.ImageFeaturizer(model_bytes=tiny, image_size=32,
                                 input_col="image", mini_batch_size=8)
    decoded = port.transform(Table({"image": _obj_col(imgs)}), "cpu")
    np.testing.assert_array_equal(got["features"], decoded[port.output_col])


def test_featurizer_gray_inputs_and_null_rows_match_jax(tiny):
    imgs = _obj_col([_img(32, 32, 1, seed=1), None, _img(20, 20, seed=2)[..., 0],
                     b"not an image"])
    got, want = _run(_feat_pair(tiny), {"image": imgs})
    out, ref = got["features"], want["features"]
    assert out.dtype == object and out[1] is None and out[3] is None
    _feats_close(np.stack([out[0], out[2]]), np.stack([ref[0], ref[2]]))


def _gray_net() -> bytes:
    """A one-channel net: 3x3 conv, ReLU, global pool, flatten."""
    g = GraphBuilder(name="gray", opset=17)
    x = g.add_input("data", np.float32, ["N", 1, 32, 32])
    w = np.random.default_rng(0).normal(size=(4, 1, 3, 3)).astype(np.float32)
    y = g.add_node("Relu", [g.conv(x, w, pads=(1, 1, 1, 1))])
    y = g.add_node("Flatten", [g.add_node("GlobalAveragePool", [y])], axis=1)
    g.add_output(y, np.float32, ["N", 4])
    return g.to_bytes()


def test_featurizer_channels_1_matches_jax():
    imgs = _obj_col([_img(32, 32, seed=i) for i in range(3)]
                    + [_img(32, 32, 1, seed=7)])
    got, want = _run(_feat_pair(_gray_net(), channels=1, mean=(0.5,),
                                std=(0.25,), cut_output_layers=0),
                     {"image": imgs})
    _feats_close(got["features"], want["features"])


def test_featurizer_mean_std_must_match_channels(tiny):
    for feat in _feat_pair(tiny, channels=1):
        with pytest.raises(ValueError, match="channels=1"):
            if isinstance(feat, image.ImageFeaturizer):
                feat.transform(Table({"image": _obj_col([_img(32, 32)])}),
                               "cpu")
            else:
                feat.transform(JaxTable({"image": _obj_col([_img(32, 32)])}))


def test_featurizer_devices_matches_one_slot(tiny):
    """``devices=["cpu"] * 2`` shards each bucket of 8 images over two
    slots: the features equal the one-slot featurizer's and the JAX
    featurizer's."""
    imgs = _obj_col([_img(32, 32, seed=s) for s in range(11)])
    ref, one = _feat_pair(tiny)
    multi = image.ImageFeaturizer(model_bytes=tiny, image_size=32,
                                  input_col="image", output_col="features",
                                  mini_batch_size=8, devices=["cpu"] * 2)
    got = multi.transform(Table({"image": imgs}), "cpu")["features"]
    assert multi._pieces("cpu").n_devices == 2
    _feats_close(got, one.transform(Table({"image": imgs}),
                                    "cpu")["features"])
    _feats_close(got, ref.transform(JaxTable({"image": imgs}))["features"])


def test_featurizer_bad_devices_spec_is_refused(tiny, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 0)
    feat = image.ImageFeaturizer(model_bytes=tiny, image_size=32,
                                 input_col="image", devices=1)
    with pytest.raises(ValueError, match="devices=1 but 0 CUDA devices"):
        feat.transform(Table({"image": _obj_col([_img(32, 32)])}), "cpu")


def test_featurizer_defaults_to_cuda_and_raises_without_it(tiny,
                                                           monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    feat = image.ImageFeaturizer(model_bytes=tiny, image_size=32,
                                 input_col="image")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        feat.transform(Table({"image": _obj_col([_img(32, 32)])}))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        feat.warmup()


def test_featurizer_warm_buckets_equal_eager(tiny):
    imgs = _obj_col([_img(32, 32, seed=i) for i in range(21)])
    eager = image.ImageFeaturizer(model_bytes=tiny, image_size=32,
                                  input_col="image", mini_batch_size=16)
    warm = eager.copy()
    report = warm.warmup(device="cpu")
    assert [e["bucket"] for e in report.entries] == [8, 16]
    assert not report.errors
    np.testing.assert_array_equal(
        warm.transform(Table({"image": imgs}), "cpu")[warm.output_col],
        eager.transform(Table({"image": imgs}), "cpu")[eager.output_col])


def test_jax_saved_featurizer_loads_and_scores_the_same(tiny, tmp_path):
    imgs = _obj_col([_img(32, 32, seed=i) for i in range(3)])
    ref, _ = _feat_pair(tiny, cut_output_layers=1)
    path = str(tmp_path / "feat")
    ref.save(path)
    loaded = PipelineStage.load(path)
    assert isinstance(loaded, image.ImageFeaturizer)
    assert loaded.cut_output_layers == 1 and loaded.image_size == 32
    got = loaded.transform(Table({"image": imgs}), "cpu")
    want = JaxStage.load(path).transform(JaxTable({"image": imgs}))
    _feats_close(got["features"], want["features"])
    own = str(tmp_path / "own")
    loaded.save(own)
    again = PipelineStage.load(own)
    np.testing.assert_array_equal(
        again.transform(Table({"image": imgs}), "cpu")["features"],
        got["features"])

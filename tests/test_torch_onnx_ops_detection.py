"""The port's ONNX sampling and detection ops against the JAX package's
importer, on the CPU: ``NonMaxSuppression``, ``RoiAlign``, ``MaxRoiPool``,
``DeformConv``, ``GridSample``, ``AffineGrid`` and ``ImageDecoder``.

The one-node cases are ``tests/fixtures/detection_op_cases.py``'s (the
card runs the same ones but ``ImageDecoder``'s in ``chip_smoke.py`` and
``test_torch_cuda.py``): the same graph bytes and seeded inputs through
both importers, the port bound on the CPU, the reference eagerly on host
inputs and under ``jax.jit`` on device inputs. Gates: NMS selections,
``MaxRoiPool``, nearest ``GridSample`` and ``ImageDecoder`` equal the
reference's (NaN where NaN is); ``RoiAlign``, ``GridSample`` and
``DeformConv`` within 1e-5 of the largest |value| (at least 1e-5);
``AffineGrid`` within 1e-6. Rows are int64 where the reference's are
int32 (its 64-bit mode is off).

Then the places where the port copies the reference and not the ONNX
spec or ``torch.nn.functional`` (ROADMAP Queue 3), each held on its own,
and torchvision Faster R-CNN's second stage
(``tests/fixtures/detection_head.py``) at a small width end to end, with
the full-width fixture's shapes, seeds and first-stage rows.
"""
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from synapseml_tpu.onnx import GraphBuilder as JaxBuilder
from synapseml_tpu.onnx import import_model as jax_import
from synapseml_tpu_torch.onnx import GraphBuilder, import_model, importer
from torch_onnx_parity import same_dtype

FIXTURES = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "fixtures")
sys.path.insert(0, FIXTURES)
import detection_head as head  # noqa: E402
import detection_op_cases as cases  # noqa: E402

NAMES = ("NonMaxSuppression", "RoiAlign", "MaxRoiPool", "DeformConv",
         "GridSample", "AffineGrid", "ImageDecoder")


def _host(v) -> bool:
    return isinstance(v, (np.ndarray, np.generic))


def _graph(case):
    return cases.graph(case, GraphBuilder)


def _port(case):
    return cases.run(case, import_model, GraphBuilder, "cpu")


def _reference(case, jit: bool = False):
    """The JAX importer's outputs of the case, as :func:`cases.run` gives
    the port's: its bound forward, eager, or under ``jax.jit``."""
    fn = jax_import(_graph(case)).bind()
    args = cases.feeds(case)
    if not case["host"]:
        args = [jnp.asarray(a) for a in args]
        if jit:
            fn = jax.jit(fn)
    return [(np.asarray(v), _host(v)) for v in fn(*args)]


def _held(case, port, ref, jitted=False):
    assert len(port) == len(ref)
    for (p, p_host), (r, r_host) in zip(port, ref):
        if not jitted:
            assert p_host == r_host
        assert same_dtype(p, r), (p.dtype, r.dtype)
        assert p.shape == r.shape, (p.shape, r.shape)
        if case["exact"]:
            if p.dtype.kind == "f":
                bits = f"u{p.itemsize}"
                np.testing.assert_array_equal(p.view(bits), r.view(bits))
            else:
                np.testing.assert_array_equal(p, r)
        else:
            np.testing.assert_allclose(p, r, rtol=0.0,
                                       atol=cases.bound(case["tol"], r))


def test_every_name_is_registered_and_covered():
    assert set(NAMES) <= set(importer._REGISTRY)
    assert {c["op"] for c in cases.CASES} == set(NAMES)
    names = [c["name"] for c in cases.CASES]
    assert len(names) == len(set(names)) and len(names) >= 60
    assert all(c["op"] != "ImageDecoder" for c in cases.CARD_CASES)


def test_both_graph_builders_give_the_same_bytes():
    for case in cases.CASES:
        assert _graph(case) == cases.graph(case, JaxBuilder), case["name"]


@pytest.mark.parametrize("case", [c for c in cases.CASES if not c["raises"]],
                         ids=lambda c: c["name"])
def test_op_matches_the_reference(case):
    port = _port(case)
    _held(case, port, _reference(case))
    if case["jit"] and not case["host"]:
        _held(case, port, _reference(case, jit=True), jitted=True)


@pytest.mark.parametrize("case", [c for c in cases.CASES if c["raises"]],
                         ids=lambda c: c["name"])
def test_op_refuses_as_the_reference_does(case):
    with pytest.raises(case["raises"]):
        _port(case)
    with pytest.raises(case["raises"]):
        _reference(case, jit=case["jit"])


# -- the reference's own results where the spec or torch.nn.functional
# says otherwise (ROADMAP Queue 3): each held here on its own ----------

def test_int32_narrowing_and_gather_index_are_jaxs():
    """A float narrowed to an int32 index: toward zero, NaN to 0,
    saturated; a traced gather's index wrapped once, then clamped."""
    vals = np.array([np.nan, 1e10, -1e10, np.inf, -np.inf, 2.7, -2.7,
                     2147483520.0, -0.5], np.float32)
    want = np.asarray(jnp.asarray(vals).astype(jnp.int32))
    got = importer._int32_of(torch.from_numpy(vals))
    assert got.dtype == torch.int64
    np.testing.assert_array_equal(got.numpy(), want)
    idx = np.array([7, -7, -1, -5, -6, 2], np.int64)
    table = jnp.arange(5.0)
    read = np.asarray(jax.jit(lambda i: table[i])(jnp.asarray(idx)))
    np.testing.assert_array_equal(
        importer._wrap_clamp(torch.from_numpy(idx), 5).numpy(), read)


def test_nms_union_is_float32_unfused_as_in_the_reference():
    """Pairs within an ulp of the IoU threshold where an FMA'd union would
    decide otherwise: the reference's scan body (eager and jitted) keeps
    each product and sum in float32, and so does the port."""
    case = cases.by_name("nms_iou_within_an_ulp_of_the_threshold")
    boxes = cases.feeds(case)[0]
    rows = _port(case)[0][0].reshape(len(boxes), 2, 3)
    a, b = boxes[:, 0], boxes[:, 1]
    f32 = np.float32
    p = np.maximum(np.minimum(a[:, 2], b[:, 2]) - np.maximum(a[:, 0], b[:, 0]), f32(0))
    q = np.maximum(np.minimum(a[:, 3], b[:, 3]) - np.maximum(a[:, 1], b[:, 1]), f32(0))
    area = lambda z: (z[:, 2] - z[:, 0]) * (z[:, 3] - z[:, 1])  # noqa: E731
    total = area(b) + area(a)
    inter = p * q
    plain = inter > f32(0.5) * (total - inter)
    fused = inter > f32(0.5) * (total.astype(np.float64)
                                - p.astype(np.float64) * q).astype(f32)
    suppressed = rows[:, 1, 2] < 0
    np.testing.assert_array_equal(suppressed, plain)
    assert (suppressed != fused).all()
    for jit in (False, True):
        ref = _reference(case, jit)[0][0]
        np.testing.assert_array_equal(ref.reshape(len(boxes), 2, 3), rows)


def test_nms_device_rows_nan_ties_and_int64():
    """The device path: int64 rows (the reference's are int32), the first
    index on tied scores, a live NaN ends its class before its first pick
    (the argmax lands on it and ``NaN > -inf`` is false), ``-1`` rows fill
    the slots; a score threshold drops the NaN first; the host path sorts
    a NaN last and fills the class."""
    nan = cases.by_name("nms_nan_score_ends_the_class")
    rows = _port(nan)[0][0]
    assert rows.dtype == np.int64 and rows.shape == (1 * 3 * 6, 3)
    per_class = rows.reshape(3, 6, 3)[..., 2]
    np.testing.assert_array_equal(per_class[:2], -1)
    assert (per_class[2] >= 0).all()
    dropped = _port(cases.by_name("nms_nan_score_dropped_by_the_threshold"))
    per_class = dropped[0][0].reshape(3, 6, 3)[..., 2]
    assert per_class[1, 0] == 8 and (per_class[:, 0] >= 0).all()
    assert _reference(nan)[0][0].dtype == np.int32
    ties = cases.by_name("nms_score_ties_first_index")
    scores = cases.feeds(ties)[1][0, 0]
    first = _port(ties)[0][0][0, 2]
    assert first == int(np.flatnonzero(scores == scores.max())[0])
    host = _port(cases.by_name("nms_nan_score_host"))[0][0]
    assert (host[:, 1] == 0).sum() == 6          # the NaN box sorted last


def test_nms_max_out_absent_or_zero_is_a_host_empty_result():
    for name in ("nms_max_out_absent", "nms_max_out_zero"):
        (rows, is_host), = _port(cases.by_name(name))
        assert is_host and rows.shape == (0, 3) and rows.dtype == np.int64


def test_roi_align_max_mode_is_the_max_of_bilinear_samples():
    """``mode="max"`` takes the largest of a bin's bilinear samples (the
    spec takes the max of the weighted corners): held to a numpy
    sampler, one roi at a time."""
    case = cases.by_name("roi_align_max_of_bilinear_samples")
    x, rois, _ = cases.feeds(case)
    got = _port(case)[0][0]
    sr, out = 3, 2
    for r, (x1, y1, x2, y2) in enumerate(rois.astype(np.float64)):
        x1, y1, x2, y2 = x1 - 0.5, y1 - 0.5, x2 - 0.5, y2 - 0.5
        for i in range(out):
            for j in range(out):
                samples = []
                for a in range(sr):
                    for b in range(sr):
                        yy = y1 + (i + (a + 0.5) / sr) * (y2 - y1) / out
                        xx = x1 + (j + (b + 0.5) / sr) * (x2 - x1) / out
                        samples.append(_bilinear(x[0], yy, xx))
                np.testing.assert_allclose(got[r, :, i, j],
                                           np.max(samples, 0), atol=1e-5)


def _bilinear(fmap, y, x):
    c, h, w = fmap.shape
    if y < -1 or y > h or x < -1 or x > w:
        return np.zeros(c)
    y, x = min(max(y, 0), h - 1), min(max(x, 0), w - 1)
    y0, x0 = int(y), int(x)
    y1, x1 = min(y0 + 1, h - 1), min(x0 + 1, w - 1)
    fy, fx = y - y0, x - x0
    return ((fmap[:, y0, x0] * (1 - fx) + fmap[:, y0, x1] * fx) * (1 - fy)
            + (fmap[:, y1, x0] * (1 - fx) + fmap[:, y1, x1] * fx) * fy)


def test_roi_align_output_half_pixel_clamps_a_roi_at_1_pixel():
    case = cases.by_name("roi_align_output_half_pixel_opset10_tiny_rois")
    x, rois, bidx = cases.feeds(case)
    wide = rois.copy()
    wide[:, 2:] = np.maximum(wide[:, 2:], wide[:, :2] + 1)   # sides of 1 px
    tiny = _port(case)[0][0]
    case_wide = dict(case, inputs=[("x", x, "feed"), ("rois", wide, "feed"),
                                   ("batch_indices", bidx, "feed")])
    np.testing.assert_array_equal(tiny[:2], _port(case_wide)[0][0][:2])


def test_grid_sample_is_map_coordinates_not_f_grid_sample():
    """``nearest`` rounds half away from zero and an integer input is
    rounded half away from zero: ``F.grid_sample`` rounds half to even."""
    case = cases.by_name("grid_sample_nearest_rounds_half_away_from_zero")
    x, grid = cases.feeds(case)
    got = _port(case)[0][0]
    lib = F.grid_sample(torch.from_numpy(x), torch.from_numpy(grid),
                        mode="nearest", padding_mode="border",
                        align_corners=False).numpy()
    assert (got != lib).any()
    ys = np.clip(np.floor(np.arange(-0.5, 4, 0.5)[:8] + 0.5), 0, 3)
    xs = np.clip(np.floor(np.arange(-0.5, 8, 0.5)[:16] + 0.5), 0, 7)
    want = x[:, :, ys.astype(int)][:, :, :, xs.astype(int)]
    np.testing.assert_array_equal(got, want)
    ints = cases.by_name("grid_sample_int32_rounds_half_away_from_zero")
    xi, gi = cases.feeds(ints)
    got = _port(ints)[0][0]
    blend = F.grid_sample(torch.from_numpy(xi).double(),
                          torch.from_numpy(gi).double(), mode="bilinear",
                          padding_mode="zeros", align_corners=True).numpy()
    away = np.sign(blend) * np.floor(np.abs(blend) + 0.5)
    np.testing.assert_array_equal(got, away.astype(np.int32))
    assert (np.round(blend) != away).any()          # ties were rounded


def test_grid_sample_nan_coordinate_reads_the_corner_under_nearest():
    case = cases.by_name("grid_sample_nan_reads_the_corner_nearest")
    x, _ = cases.feeds(case)
    got = _port(case)[0][0]
    # (nan, 0.2): x reads column 0, y = ((0.2 + 1) * 5 - 1) / 2 = 2.5 rounds
    # to row 3; (0.3, nan): y reads row 0, x = 3.4 reads column 3
    np.testing.assert_array_equal(got[0, :, 0, 0], x[0, :, 3, 0])
    np.testing.assert_array_equal(got[0, :, 0, 1], x[0, :, 0, 3])


def test_affine_grid_base_axis_is_the_references():
    """The half-step axis bitwise the reference's eager float32 formula;
    the ``align_corners`` axis bitwise ``jnp.linspace`` below 353 points
    (``torch.linspace`` is not); above, XLA:CPU rounds ``1 - step`` in an
    FMA in its vector loop body, and the port's axis stays within an ulp
    of 1."""
    for n in (1, 2, 3, 5, 7, 28, 64, 68, 100, 1088):
        step = 2.0 / n
        want = np.asarray(-1.0 + step / 2 + step * jnp.arange(
            n, dtype=jnp.float32))
        got = importer._affine_axis(n, False)
        np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))
    for n in range(2, 353):
        want = np.asarray(jnp.linspace(-1.0, 1.0, n))
        np.testing.assert_array_equal(importer._affine_axis(n, True), want)
    assert (torch.linspace(-1, 1, 68).numpy() != importer._affine_axis(
        68, True)).sum() > 0
    want = np.asarray(jnp.linspace(-1.0, 1.0, 1088))
    got = importer._affine_axis(1088, True)
    gap = np.abs(got.astype(np.float64) - want)
    assert gap.max() <= np.finfo(np.float32).eps       # an ulp of 1
    assert 0 < (gap > 0).sum() < 1088 // 2


def test_max_roi_pool_bins_are_the_eager_references():
    """The reference's bound forward divides a roi's extent by the bin
    count; under ``jax.jit`` XLA multiplies by the count's reciprocal and
    some bin edges move by a pixel. The port's bins are the bound
    forward's, bitwise."""
    case = cases.by_name("max_roi_pool_fast_rcnn_shaped")
    port = _port(case)[0][0]
    eager = _reference(case)[0][0]
    jitted = _reference(case, jit=True)[0][0]
    np.testing.assert_array_equal(port.view(np.uint32), eager.view(np.uint32))
    assert (jitted != eager).any()


def test_max_roi_pool_in_small_pieces_is_bitwise_one_piece(monkeypatch):
    """The port's per-piece masked maxes (the reference's plan would hold
    ``[R, C, ph, H, W]``) give the same bits at any piece size."""
    case = cases.by_name("max_roi_pool_fast_rcnn_shaped")
    whole = _port(case)[0][0]
    monkeypatch.setattr(importer, "_ROI_POOL_PIECE_BYTES", 1)
    pieces = _port(case)[0][0]
    np.testing.assert_array_equal(whole.view(np.uint32), pieces.view(np.uint32))


def test_image_decoder_without_pil_raises_the_references_message(monkeypatch):
    case = cases.by_name("image_decoder_png_rgb")
    monkeypatch.setitem(sys.modules, "PIL", None)
    with pytest.raises(NotImplementedError,
                       match="ImageDecoder requires PIL for this codec"):
        _port(case)


def test_deform_conv_with_zero_offsets_is_a_convolution():
    case = cases.by_name("deform_conv_3x3_bias")
    x, offset = cases.feeds(case)
    w, b = case["inputs"][1][1], case["inputs"][3][1]
    zero = dict(case, inputs=[(n, np.zeros_like(a) if n == "offset" else a, wh)
                              for n, a, wh in case["inputs"]])
    got = _port(zero)[0][0]
    conv = F.conv2d(torch.from_numpy(x), torch.from_numpy(w),
                    torch.from_numpy(b), padding=1).numpy()
    np.testing.assert_allclose(got, conv, rtol=0, atol=1e-5)


def test_a_bound_forward_copies_no_table_after_its_first_run(monkeypatch):
    """RoiAlign's sample offsets, DeformConv's base grid and AffineGrid's
    base points are made once per shape: a second run of a bound graph
    makes no tensor from a host array."""
    names = ["roi_align_torchvision_shaped", "deform_conv_dcnv2_shaped",
             "affine_grid_3d_align_corners", "nms_batches_classes_score_threshold"]
    runs = []
    for name in names:
        case = cases.by_name(name)
        fn = import_model(_graph(case)).bind(device="cpu")
        args = [torch.from_numpy(a) for a in cases.feeds(case)]
        runs.append((fn, args, fn(*args)))
    made = []
    real = importer._tensor

    def counting(x, dev=None):
        if not isinstance(x, torch.Tensor) and np.ndim(x) > 0:
            made.append(np.shape(x))
        return real(x, dev)

    monkeypatch.setattr(importer, "_tensor", counting)
    for fn, args, first in runs:
        again = fn(*args)
        for a, b in zip(first, again):
            assert torch.equal(a, b)
    assert made == []


# -- torchvision Faster R-CNN R50-FPN's second stage ---------------------

def _no_host_reads(monkeypatch):
    """Make every host read of a tensor raise (the importer's rounding of
    a host scalar to a dtype goes through numpy meanwhile)."""
    def refuse(*_, **__):
        raise AssertionError("a host read in the bound forward")

    def numpy_scalar(x, dt):
        return importer._np_value(x).astype(importer._NUMPY_OF[dt]).item()

    monkeypatch.setattr(importer, "_scalar", numpy_scalar)
    for name in ("item", "tolist", "numpy", "cpu", "nonzero", "__bool__"):
        monkeypatch.setattr(torch.Tensor, name, refuse)
    monkeypatch.setattr(torch, "nonzero", refuse)


def test_detection_head_matches_the_reference_at_small_width(monkeypatch):
    cfg = head.SMALL
    blob = head.head_graph(GraphBuilder, cfg)
    assert blob == head.head_graph(JaxBuilder, cfg)
    feeds = head.inputs(cfg)
    fn = import_model(blob).bind(device="cpu")
    args = [torch.from_numpy(feeds[k]) for k in head.INPUTS]
    with monkeypatch.context() as m:
        _no_host_reads(m)
        port = fn(*args)
    port = {k: v.numpy() for k, v in zip(head.OUTPUTS, port)}
    ref = jax_import(blob).bind()(*[jnp.asarray(feeds[k]) for k in head.INPUTS])
    ref = {k: np.asarray(v) for k, v in zip(head.OUTPUTS, ref)}
    np.testing.assert_array_equal(port["rows1"], ref["rows1"])
    kept = int((port["rows1"][:, 0] >= 0).sum())
    assert 0 < kept < cfg["proposals"]
    span = float(np.abs(ref["pooled"]).max())
    np.testing.assert_allclose(port["pooled"], ref["pooled"], rtol=0,
                               atol=cases.SAMPLE_TOL * span)
    held = head.held(port, ref, box_tol=1e-3)
    assert held["ok"], held
    assert held["near_ties"] == held["differing"] == 0
    np.testing.assert_array_equal(port["rows2"], ref["rows2"])
    assert port["det_labels"][port["det_rows"][:, 2] >= 0].min() >= 1


def test_full_width_detection_fixture_has_its_shapes_and_seeds():
    """The JAX fixture's full-width run: its shapes, seeds and counts, and
    the port's first NMS stage on the same proposals (its inputs come
    back from their seed) giving its rows exactly."""
    fx = np.load(head.OUT)
    cfg = head.FULL
    assert fx["rows1"].shape == (cfg["proposals"], 3)
    assert fx["rows2"].shape == ((cfg["classes"] - 1) * head.DETECTIONS, 3)
    assert fx["det_boxes"].shape == (head.DETECTIONS, 4)
    assert fx["det_scores"].shape == fx["det_labels"].shape == (head.DETECTIONS,)
    assert int(fx["weight_seed"]) == head.WEIGHT_SEED
    assert int(fx["input_seed"]) == head.INPUT_SEED
    assert 200 <= int(fx["pairs_over_threshold"]) <= 2000
    assert float(fx["pooled_span"]) > 0
    feeds = head.inputs(cfg)
    area = np.sqrt((feeds["proposals"][0, :, 2] - feeds["proposals"][0, :, 0])
                   * (feeds["proposals"][0, :, 3] - feeds["proposals"][0, :, 1]))
    assert area.min() >= 224 and area.max() < 448       # all on P4
    g = GraphBuilder(opset=head.OPSET)
    g.add_input("b", np.float32, list(feeds["proposals"].shape))
    g.add_input("s", np.float32, list(feeds["objectness"].shape))
    g.add_initializer("m", np.array([cfg["proposals"]], np.int64))
    g.add_initializer("t", np.array([head.RPN_NMS_IOU], np.float32))
    g.add_node("NonMaxSuppression", ["b", "s", "m", "t"], outputs=["y"])
    g.add_output("y", np.int64, None)
    rows = import_model(g.to_bytes()).bind(device="cpu")(
        torch.from_numpy(feeds["proposals"]),
        torch.from_numpy(feeds["objectness"]))[0]
    np.testing.assert_array_equal(rows.numpy(), fx["rows1"])

"""The port's ONNX dense-image ops against the JAX package's importer, on
the CPU: ``ConvTranspose``, ``Resize``, ``Upsample``, ``Pad``,
``DepthToSpace``, ``SpaceToDepth``, ``GlobalMaxPool``, ``GlobalLpPool``,
``LpPool``, ``MaxUnpool``, ``LRN``, ``InstanceNormalization``,
``GroupNormalization``, ``MeanVarianceNormalization``,
``LpNormalization``, ``Col2Im``, ``CenterCropPad`` and ``MaxPool``'s
Indices output.

The one-node cases are ``tests/fixtures/vision_op_cases.py``'s (the card
runs the same ones in ``chip_smoke.py`` and ``test_torch_cuda.py``): the
same graph bytes and seeded inputs through both importers, the port bound
on the CPU. Tolerance: gathers, pads, views, max pools, their indices and
``MaxUnpool`` equal the reference's (NaN where NaN is); sums, means,
contractions and ``Col2Im`` within ``SUM_TOL`` = 2e-5 of the largest
|value| (at least 1), about 100 times the gaps seen; output dtypes equal
(int64 indices where the reference's are int32, its 64-bit mode being
off).

Then the places where the port copies the reference and not the ONNX
spec or ``torch.nn.functional`` (ROADMAP Queue 3), each held on its own,
and Stable Diffusion's VAE decoder (``tests/fixtures/vae_decoder.py``) at
a small width end to end, with the full-width fixture's shape and seeds.
"""
import os
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from synapseml_tpu.onnx import GraphBuilder as JaxBuilder
from synapseml_tpu.onnx import import_model as jax_import
from synapseml_tpu.runtime import executor as jax_executor
from synapseml_tpu_torch.onnx import GraphBuilder, import_model, importer
from synapseml_tpu_torch.runtime.executor import BatchedExecutor
from torch_onnx_parity import assert_parity, run_both

FIXTURES = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "fixtures")
sys.path.insert(0, FIXTURES)
import vae_decoder  # noqa: E402
import vision_op_cases as cases  # noqa: E402

NAMES = ("ConvTranspose", "Resize", "Upsample", "Pad", "DepthToSpace",
         "SpaceToDepth", "GlobalMaxPool", "GlobalLpPool", "LpPool",
         "MaxUnpool", "LRN", "InstanceNormalization", "GroupNormalization",
         "MeanVarianceNormalization", "LpNormalization", "Col2Im",
         "CenterCropPad")
VAE_TOL = 1e-4     # small-width decoder, of the largest |value|


def _host(v) -> bool:
    return isinstance(v, (np.ndarray, np.generic))


def _graph(case):
    return cases.graph(case, GraphBuilder)


def _run_both(case):
    return run_both(_graph(case), cases.feeds(case), host=case["host"])


def _port(case):
    return [v for v, _ in cases.run(case, import_model, GraphBuilder, "cpu")]


def test_every_name_is_registered_and_covered():
    assert set(NAMES) <= set(importer._REGISTRY)
    assert {c["op"] for c in cases.CASES} == set(NAMES) | {"MaxPool"}
    names = [c["name"] for c in cases.CASES]
    assert len(names) == len(set(names))
    assert set(cases.EDGE_CASES.values()) <= set(names)


def test_both_graph_builders_give_the_same_bytes():
    for case in cases.CASES:
        assert _graph(case) == cases.graph(case, JaxBuilder), case["name"]


@pytest.mark.parametrize("case", [c for c in cases.CASES if not c["raises"]],
                         ids=lambda c: c["name"])
def test_op_matches_the_reference(case):
    port, ref = _run_both(case)
    if case["exact"]:
        assert_parity(port, ref, rtol=0.0, atol=0.0)
    else:
        for p, r in zip(port, ref):
            assert_parity([p], [r], rtol=0.0,
                          atol=cases.bound(case, np.asarray(r)))
    for p, r in zip(port, ref):
        assert _host(p) == _host(r)


@pytest.mark.parametrize("case", [c for c in cases.CASES if c["raises"]],
                         ids=lambda c: c["name"])
def test_op_refuses_as_the_reference_does(case):
    with pytest.raises(case["raises"]):
        _run_both(case)
    with pytest.raises(case["raises"]):
        jax_import(_graph(case)).bind()(
            *[jnp.asarray(a) for a in cases.feeds(case)])


# -- the reference's own results where the spec or torch.nn.functional
# says otherwise (ROADMAP Queue 3): each held here on its own ----------

def _first_max_indices(x, k, s):
    """numpy: each window's first largest cell (NaN the largest), as a
    flat index over the whole tensor; no padding."""
    n, c, h, w = x.shape
    oh, ow = (h - k[0]) // s[0] + 1, (w - k[1]) // s[1] + 1
    vals = np.empty((n, c, oh, ow), x.dtype)
    idx = np.empty((n, c, oh, ow), np.int64)
    for b in range(n):
        for ch in range(c):
            for i in range(oh):
                for j in range(ow):
                    win = x[b, ch, i * s[0]:i * s[0] + k[0],
                            j * s[1]:j * s[1] + k[1]]
                    flat = win.reshape(-1)
                    nan = np.flatnonzero(np.isnan(flat))
                    a = nan[0] if nan.size else int(np.argmax(flat))
                    r, q = divmod(a, k[1])
                    vals[b, ch, i, j] = flat[a]
                    idx[b, ch, i, j] = ((b * c + ch) * h + i * s[0] + r) * w \
                        + j * s[1] + q
    return vals, idx


def test_max_pool_indices_ties_go_to_the_first_cell_and_nan_wins():
    for name, k, s in (("ties", (3, 3), (1, 2)), ("nan", (2, 2), (1, 1))):
        case = cases.by_name(cases.EDGE_CASES[name])
        x = cases.feeds(case)[0]
        vals, idx = _port(case)
        want_vals, want_idx = _first_max_indices(x, k, s)
        assert idx.dtype == np.int64
        np.testing.assert_array_equal(idx, want_idx)
        np.testing.assert_array_equal(vals, want_vals)
    assert np.isnan(vals[0, 0, 0, 0]) and np.isnan(vals[0, 0, 1, 1])


def test_max_pool_index_of_a_window_wholly_in_padding_is_2_31_minus_1():
    vals, idx = _port(cases.by_name(cases.EDGE_CASES["sentinel"]))
    np.testing.assert_array_equal(idx[0, 0], [2 ** 31 - 1, 1, 3, 2 ** 31 - 1])
    np.testing.assert_array_equal(vals[0, 0], [-np.inf, 2.0, 4.0, -np.inf])
    unpooled = _port(cases.by_name("max_pool_then_unpool_1d_pads"))[0]
    np.testing.assert_array_equal(unpooled[0, 0], [0, 2, 0, 4, 0, 0])


def test_max_unpool_wraps_a_negative_index_and_drops_past_the_end():
    case = cases.by_name(cases.EDGE_CASES["unpool_drop"])
    x, idx = cases.feeds(case)
    want = np.zeros(2 * 3 * 8 * 8, np.float32)
    flat, vals = idx.reshape(-1), x.reshape(-1)
    keep = (flat >= -want.size) & (flat < want.size)
    want[flat[keep]] = vals[keep]        # -3 wraps; 2^31 - 1 and 384 drop
    np.testing.assert_array_equal(_port(case)[0].reshape(-1), want)


def test_lp_normalization_reads_p3_as_2_and_clamps_a_zero_norm():
    p3 = _port(cases.by_name(cases.EDGE_CASES["lp3"]))[0]
    x = cases.feeds(cases.by_name(cases.EDGE_CASES["lp3"]))[0]
    g = GraphBuilder(opset=17)
    g.add_input("x", np.float32, list(x.shape))
    g.add_node("LpNormalization", ["x"], outputs=["y"], p=2)
    g.add_output("y", np.float32, None)
    p2 = import_model(g.to_bytes()).bind(device="cpu")(
        torch.from_numpy(x))[0].numpy()
    np.testing.assert_array_equal(p3, p2)
    np.testing.assert_array_equal(p3[1], 0.0)


def test_upsample_linear_is_half_pixel_not_the_spec_asymmetric():
    case = cases.by_name(cases.EDGE_CASES["upsample_linear"])
    x = cases.feeds(case)[0]
    got = _port(case)[0]
    # x2 up: half-pixel, renormalised at the border = F.interpolate's
    half = F.interpolate(torch.from_numpy(x), scale_factor=2,
                         mode="bilinear", align_corners=False).numpy()
    np.testing.assert_allclose(got, half, rtol=0, atol=1e-6)
    # the spec's asymmetric linear: out[2i + 1] = (in[i] + in[i + 1]) / 2
    spec_odd_row = (x[:, :, 0] + x[:, :, 1]) / 2
    assert np.abs(got[:, :, 1, ::2] - spec_odd_row).max() > 0.05


def test_resize_is_jax_image_resize_not_f_interpolate():
    down = cases.by_name("resize_linear_down_antialias")
    x = cases.feeds(down)[0]
    plain = F.interpolate(torch.from_numpy(x), size=(4, 3), mode="bilinear",
                          align_corners=False, antialias=False).numpy()
    assert np.abs(_port(down)[0] - plain).max() > 0.05      # antialiased
    up = cases.by_name("resize_cubic_up")
    x = cases.feeds(up)[0]
    keys_075 = F.interpolate(torch.from_numpy(x), size=(10, 9),
                             mode="bicubic", align_corners=False).numpy()
    assert np.abs(_port(up)[0] - keys_075).max() > 1e-3     # a = -0.5
    half = cases.by_name("resize_nearest_half_pixel_up")
    src = np.floor((np.arange(7, dtype=np.float32) + 0.5) * 3 / 7)
    np.testing.assert_array_equal(
        _port(half)[0][:, :, :, 0], cases.feeds(half)[0][:, :, src.astype(
            int), 0])


def test_lrn_even_size_window_is_the_specs_not_f_local_response_norm():
    case = cases.by_name("lrn_even_size4")
    x = cases.feeds(case)[0]
    got = _port(case)[0]
    sq = np.pad(x.astype(np.float64) ** 2, ((0, 0), (1, 2), (0, 0), (0, 0)))
    window = sum(sq[:, i:i + 7] for i in range(4))
    spec = x / (2.0 + 0.01 / 4 * window) ** 0.5
    np.testing.assert_allclose(got, spec, rtol=1e-5, atol=1e-6)
    lib = F.local_response_norm(torch.from_numpy(x), 4, alpha=0.01,
                                beta=0.5, k=2.0).numpy()
    assert np.abs(got - lib).max() > 1e-4


def test_conv_transpose_ignores_output_shape():
    case = cases.by_name(cases.EDGE_CASES["output_shape"])
    assert _port(case)[0].shape == (1, 3, 7, 7)        # not [10, 10]


def test_mvn_statistics_span_the_batch_so_bucket_padding_moves_real_rows():
    """``MeanVarianceNormalization``'s default axes take in the batch, so
    the executor's zero rows (3 rows in a bucket of 4) change the real
    rows' output: the port's executor gives the rows of the padded
    forward, as the reference's does."""
    case = cases.by_name(cases.EDGE_CASES["mvn_batch"])
    blob, x = _graph(case), cases.feeds(case)[0]
    fn = import_model(blob).bind(device="cpu")
    alone = fn(torch.from_numpy(x))[0].numpy()
    padded = np.concatenate([x, np.zeros((1,) + x.shape[1:], np.float32)])
    in_bucket = fn(torch.from_numpy(padded))[0].numpy()[:3]
    ex = BatchedExecutor(fn, device="cpu", min_bucket=4)
    ref = jax_executor.BatchedExecutor(jax_import(blob).bind(), min_bucket=4)
    try:
        port_rows = ex.submit(x).result()[0]
        ref_rows = np.asarray(ref.submit(x).result()[0])
    finally:
        ex.close()
        ref.close()
    np.testing.assert_array_equal(port_rows, in_bucket)
    assert np.abs(port_rows - alone).max() > 0.01
    np.testing.assert_allclose(port_rows, ref_rows, rtol=0,
                               atol=cases.bound(case, ref_rows))


def test_a_bound_forward_copies_no_table_after_its_first_run(monkeypatch):
    """Resize's, Pad's and Col2Im's index and weight tables are made once
    per shape: a second run of a bound graph makes no tensor from a host
    array."""
    names = ["resize_linear_up_and_down", "resize_nearest_half_pixel_up",
             "pad_reflect_n_and_c_wider_than_axis", "col2im_3d"]
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


# -- Stable Diffusion's VAE decoder -------------------------------------

def test_vae_decoder_matches_the_reference_at_small_width():
    blob = vae_decoder.decoder_graph(GraphBuilder, vae_decoder.SMALL)
    assert blob == vae_decoder.decoder_graph(JaxBuilder, vae_decoder.SMALL)
    graph = import_model(blob)
    assert sum(v.size for v in graph.params.values()) == \
        vae_decoder.parameters(vae_decoder.SMALL) + 2   # + the two scalars
    lat = vae_decoder.latents(2, 8)
    port = graph.bind(device="cpu")(torch.from_numpy(lat))
    ref = jax_import(blob).bind()(jnp.asarray(lat))
    span = float(np.abs(np.asarray(ref[0])).max())
    assert port[0].shape == (2, 3, 16, 16)
    assert_parity(port, ref, rtol=0.0, atol=VAE_TOL * span)
    ops = {ctx.op_type for _, ctx, _, _ in graph._nodes}
    assert {"GroupNormalization", "Resize", "Softmax", "Conv"} <= ops


def test_full_width_vae_fixture_has_its_shapes_and_seeds():
    fx = np.load(vae_decoder.OUT)
    n, size = vae_decoder.FIXTURE_LATENTS, vae_decoder.FIXTURE_SIZE
    assert fx["image"].shape == (n, 3, 8 * size, 8 * size)
    assert fx["image"].dtype == np.float32 and np.isfinite(fx["image"]).all()
    np.testing.assert_array_equal(fx["latents"],
                                  vae_decoder.latents(n, size))
    assert int(fx["weight_seed"]) == vae_decoder.WEIGHT_SEED
    assert int(fx["latent_seed"]) == vae_decoder.LATENT_SEED
    assert float(fx["span"]) == float(np.abs(fx["image"]).max())
    assert vae_decoder.parameters() == 49_490_199     # the published 49.5 M
    assert abs(vae_decoder.flops(vae_decoder.FULL, 1,
                                 vae_decoder.PUBLISHED_SIZE)["total"]
               - 2.51e12) < 0.01e12

"""The port's explainers against the JAX package's, on the CPU.

- Samplers: the same ``np.random.default_rng(seed)`` draws, bitwise.
- Superpixels: the same assignments, except pixels that the JAX centers
  themselves place within 1e-5 relative of a tie (the centers' float32
  sums may differ in the last bit); the count excluded is asserted 0 on
  these seeded images.
- Surrogates: with S >= 2 D samples the coefficients agree within
  ``S · cond(A) · eps32 · max|coef|`` — the worst-case float32 error of
  summing S samples into the normal equations (S · eps32), amplified by
  the condition number of the system solved, cond(A), computed here in
  float64 from the inputs. Below 2 D samples the coefficients in A's
  near-null space are not determined (the 1e-6 ridge scales a rounding
  difference by up to 1e6), so the fitted values ``states · coef +
  intercept`` are held instead, within 1e-4 of their largest magnitude.
- Explainers: each of the eight runs over a toy scorer defined for each
  package (the same numpy float32 arithmetic, so the scores are bitwise
  equal); the solver inputs both packages hand their surrogates are
  captured and held bitwise equal, the outputs under the rules above.
  ``TabularSHAP``/``TabularLIME`` also run over the Adult fixture model
  (``lgbm_adult_100x31.txt``, the JAX package's LightGBM against the
  port's): margins bitwise, probabilities to an ulp, and 16 rows of the
  fixture ``image_explainer_fixtures.npz`` the JAX package wrote at 256
  rows x 100 samples.
"""
import os
import sys

import numpy as np
import pytest
import torch

import synapseml_tpu.explainers.local as jlocal
from synapseml_tpu.core.pipeline import Transformer as JaxTransformer
from synapseml_tpu.data.table import Table as JaxTable
from synapseml_tpu.explainers import samplers as jsamplers
from synapseml_tpu.explainers import superpixel as jsuperpixel
from synapseml_tpu.explainers import surrogate as jsurrogate
from synapseml_tpu.gbdt.estimators import \
    LightGBMClassificationModel as JaxLGBM
import synapseml_tpu_torch.explainers.local as local
from synapseml_tpu_torch import explainers
from synapseml_tpu_torch.core.pipeline import Transformer
from synapseml_tpu_torch.data.table import Table
from synapseml_tpu_torch.explainers import samplers, superpixel, surrogate
from synapseml_tpu_torch.gbdt.estimators import LightGBMClassificationModel

EPS32 = float(np.finfo(np.float32).eps)
FITTED_REL = 1e-4
EFFICIENCY_TOL = 1e-4
FIXTURES = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "fixtures")
ADULT = os.path.join(FIXTURES, "lgbm_adult_100x31.txt")
W = np.array([2.0, -1.0, 0.5], np.float32)

sys.path.insert(0, FIXTURES)
from make_image_explainer_fixtures import TIE_REL, slic_ties  # noqa: E402


# ---------------------------------------------------------------------------
# samplers: bitwise
# ---------------------------------------------------------------------------

def test_lime_samples_and_weights_bitwise():
    a = samplers.lime_state_samples(np.random.default_rng(4), 5, 17, 6,
                                    on_prob=0.6)
    b = jsamplers.lime_state_samples(np.random.default_rng(4), 5, 17, 6,
                                     on_prob=0.6)
    np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(samplers.lime_kernel_weights(a, 0.4),
                                  jsamplers.lime_kernel_weights(b, 0.4))


@pytest.mark.parametrize("d", [1, 2, 7, 30])
def test_kernel_shap_samples_bitwise(d):
    a = samplers.kernel_shap_samples(np.random.default_rng(d), 3, 25, d)
    b = jsamplers.kernel_shap_samples(np.random.default_rng(d), 3, 25, d)
    for x, y in zip(a, b):
        assert x.dtype == y.dtype
        np.testing.assert_array_equal(x, y)
    assert [samplers.shap_kernel_weight(d, k) for k in range(d + 1)] == \
        [jsamplers.shap_kernel_weight(d, k) for k in range(d + 1)]


def test_perturbations_bitwise():
    rng = np.random.default_rng(0)
    x = rng.normal(size=(4, 5)).astype(np.float32)
    states = (rng.random((4, 9, 5)) < 0.5).astype(np.float32)
    bg = rng.normal(size=5).astype(np.float32)
    np.testing.assert_array_equal(
        samplers.apply_mask_background(x, states, bg),
        jsamplers.apply_mask_background(x, states, bg))
    mean, std = x.mean(0), x.std(0) + 1e-12
    np.testing.assert_array_equal(
        samplers.tabular_value_samples(np.random.default_rng(1), states, x,
                                       mean, std),
        jsamplers.tabular_value_samples(np.random.default_rng(1), states, x,
                                        mean, std))


# ---------------------------------------------------------------------------
# superpixels: equal but for ties the JAX centers see
# ---------------------------------------------------------------------------

def _image(h, w, seed):
    """Smooth seeded color fields with noise, on the 0-255 scale."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w] / max(h, w)
    img = np.full((h, w, 3), 128.0)
    for c in range(3):
        for _ in range(3):
            fy, fx = rng.uniform(-4, 4, 2)
            img[..., c] += rng.uniform(10, 50) * np.sin(
                2 * np.pi * (fy * yy + fx * xx) + rng.uniform(0, 6))
    img += rng.normal(0, 4, img.shape)
    return np.clip(img, 0, 255).astype(np.float32)


@pytest.mark.parametrize("h,w,cell,modifier", [
    (24, 24, 8.0, 130.0), (48, 40, 8.0, 130.0), (64, 64, 16.0, 130.0),
    (33, 47, 6.0, 40.0)])
def test_superpixels_equal_jax_except_at_ties(h, w, cell, modifier):
    img = _image(h, w, seed=h + w)
    grid_h, grid_w = max(1, round(h / cell)), max(1, round(w / cell))
    ys, xs = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
    yx = np.stack([ys, xs], -1).astype(np.float32)
    spatial_w = (modifier / cell) ** 2
    want, tie = slic_ties(img, yx, grid_h, grid_w, spatial_w, 10)
    got = superpixel._slic(torch.from_numpy(img), torch.from_numpy(yx),
                           grid_h, grid_w, spatial_w, 10).numpy()
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got[~tie], want[~tie])
    assert int(tie.sum()) == 0
    sp = explainers.superpixels(img, cell, modifier, device="cpu")
    ref = jsuperpixel.superpixels(img, cell, modifier)
    assert sp.num_clusters == ref.num_clusters
    np.testing.assert_array_equal(sp.assignment, ref.assignment)


def test_superpixels_rescale_unit_images_and_gray_like_jax():
    img = _image(24, 24, seed=3) / 255.0
    for im in (img, img[..., 0]):
        sp = explainers.superpixels(im, 8.0, device="cpu")
        ref = jsuperpixel.superpixels(im, 8.0)
        np.testing.assert_array_equal(sp.assignment, ref.assignment)
    state = np.random.default_rng(0).random(sp.num_clusters) < 0.5
    np.testing.assert_array_equal(
        sp.masked_image(img, state, 7.0),
        jsuperpixel.SuperpixelData(ref.assignment, ref.num_clusters)
        .masked_image(img, state, 7.0))


# ---------------------------------------------------------------------------
# surrogate solvers
# ---------------------------------------------------------------------------

def _design(n, s, d, seed, on_prob=0.7):
    rng = np.random.default_rng(seed)
    x = (rng.random((n, s, d)) < on_prob).astype(np.float32)
    y = (x @ rng.normal(size=d) + 0.1 * rng.normal(size=(n, s))
         ).astype(np.float32)
    w = rng.random((n, s)).astype(np.float32) + 0.1
    return x, y, w


def _ls_system(x, w, l2=1e-6):
    """Row r's normal matrix of ``weighted_least_squares``, float64."""
    x, w = x.astype(np.float64), w.astype(np.float64)
    w = w / (w.sum(-1, keepdims=True) + 1e-12)
    xc = x - (x * w[..., None]).sum(-2, keepdims=True)
    return np.swapaxes(xc, -1, -2) @ (xc * w[..., None]) \
        + l2 * np.eye(x.shape[-1])


def _lasso_system(x, w):
    x, w = x.astype(np.float64), w.astype(np.float64)
    w = w / (w.sum(-1, keepdims=True) + 1e-12)
    xc = x - (x * w[..., None]).sum(-2, keepdims=True)
    xs = xc / (np.sqrt((xc * xc * w[..., None]).sum(-2, keepdims=True))
               + 1e-12)
    return np.swapaxes(xs, -1, -2) @ (xs * w[..., None])


def _shap_system(z, w):
    z, w = z.astype(np.float64), w.astype(np.float64)
    x = z[..., :-1] - z[..., -1:]
    return np.swapaxes(x, -1, -2) @ (x * w[..., None]) \
        + 1e-8 * np.eye(x.shape[-1])


def _close_under_cond(got, want, systems, s):
    """Each row within S · cond(A_r) · eps32 · max|coef_r|."""
    got, want = np.asarray(got), np.asarray(want)
    for r in range(want.shape[0]):
        cond = float(np.linalg.cond(systems[r]))
        tol = s * cond * EPS32 * float(np.abs(want[r]).max())
        err = float(np.abs(got[r] - want[r]).max())
        assert err <= tol, (r, err, tol, cond)


def _fitted(x, coefs, y, w):
    """states · coef + intercept, with the surrogate's weighted means."""
    x, y, w = (a.astype(np.float64) for a in (x, y, w))
    w = w / (w.sum(-1, keepdims=True) + 1e-12)
    xm, ym = (x * w[..., None]).sum(-2), (y * w).sum(-1)
    coefs = np.asarray(coefs, np.float64)
    return (x @ coefs[..., None])[..., 0] + (ym - (xm * coefs).sum(-1)
                                             )[..., None]


def _t(*arrays):
    return tuple(torch.from_numpy(np.ascontiguousarray(a)) for a in arrays)


@pytest.mark.parametrize("n,s,d", [(1, 40, 6), (5, 64, 12), (3, 300, 30)])
def test_least_squares_matches_jax(n, s, d):
    x, y, w = _design(n, s, d, seed=d)
    wc, wi = jsurrogate.batched_least_squares(x, y, w)
    gc, gi = surrogate.weighted_least_squares(*_t(x, y, w))
    _close_under_cond(gc, wc, _ls_system(x, w), s)
    np.testing.assert_allclose(_fitted(x, gc, y, w), _fitted(x, wc, y, w),
                               atol=FITTED_REL * float(np.abs(y).max()))
    one_c, _ = jsurrogate.weighted_least_squares(x[0], y[0], w[0],
                                                 fit_intercept=False)
    own_c, own_i = surrogate.weighted_least_squares(*_t(x[0], y[0], w[0]),
                                                    fit_intercept=False)
    assert float(own_i) == 0.0
    _close_under_cond(own_c[None], np.asarray(one_c)[None],
                      [np.swapaxes(x[0], 0, 1).astype(np.float64)
                       @ (x[0] * (w[0] / w[0].sum())[:, None])
                       + 1e-6 * np.eye(d)], s)


def test_least_squares_below_two_d_samples_holds_the_fitted_values():
    n, s, d = 3, 50, 64          # ImageLIME's default: 50 samples
    x, y, w = _design(n, s, d, seed=11)
    wc, _ = jsurrogate.batched_least_squares(x, y, w)
    gc, _ = surrogate.weighted_least_squares(*_t(x, y, w))
    fit_w = _fitted(x, wc, y, w)
    np.testing.assert_allclose(_fitted(x, gc, y, w), fit_w, rtol=0,
                               atol=FITTED_REL * float(np.abs(fit_w).max()))


@pytest.mark.parametrize("alpha", [0.001, 0.01, 0.1])
def test_lasso_matches_jax(alpha):
    n, s, d = 4, 80, 8
    x, y, w = _design(n, s, d, seed=5)
    wc, wi = jsurrogate.batched_lasso(x, y, w, np.full(n, alpha, np.float32))
    gc, gi = surrogate.weighted_lasso(*_t(x, y, w), alpha)
    _close_under_cond(gc, wc, _lasso_system(x, w), s)
    np.testing.assert_allclose(gi.numpy(), np.asarray(wi), rtol=0,
                               atol=s * EPS32 * float(np.abs(y).max()) * 10)
    assert (np.asarray(wc) == 0).sum() == (gc.numpy() == 0).sum()


@pytest.mark.parametrize("n,s,d", [(2, 40, 1), (2, 40, 2), (4, 100, 9),
                                   (2, 512, 40)])
def test_shap_fit_matches_jax(n, s, d):
    z, w = samplers.kernel_shap_samples(np.random.default_rng(d), n, s, d)
    rng = np.random.default_rng(1)
    y = (z @ rng.normal(size=d) + 0.01 * rng.normal(size=(n, s))
         ).astype(np.float32)
    fnull = rng.normal(size=n).astype(np.float32)
    fx = y[:, 0]
    want = np.asarray(jsurrogate.batched_shap_fit(z, y, w, fnull, fx))
    got = surrogate.shap_weighted_fit(*_t(z, y, w, fnull, fx)).numpy()
    assert got.shape == want.shape == (n, d + 1)
    np.testing.assert_array_equal(got[:, 0], fnull)
    if d > 1:
        _close_under_cond(got, want, _shap_system(z, w), s)
    else:
        np.testing.assert_array_equal(got, want)
    np.testing.assert_allclose(got[:, 1:].sum(1), fx - fnull,
                               atol=EFFICIENCY_TOL)


def test_solvers_batched_rows_equal_each_row_alone():
    x, y, w = _design(3, 40, 5, seed=2)
    batched, _ = surrogate.weighted_lasso(*_t(x, y, w), 0.01)
    for r in range(3):
        alone, _ = surrogate.weighted_lasso(*_t(x[r], y[r], w[r]), 0.01)
        np.testing.assert_allclose(batched[r].numpy(), alone.numpy(),
                                   rtol=1e-6, atol=1e-7)


# ---------------------------------------------------------------------------
# the eight explainers over toy scorers, one for each package
# ---------------------------------------------------------------------------

def _vector_p(table):
    return np.column_stack([np.asarray(table["features"], np.float32) @ W])


def _tabular_p(table):
    a = np.asarray(table["a"], np.float32)
    b = np.asarray(table["b"], np.float32)
    c = np.asarray(table["c"], np.float32)
    return np.column_stack([2.0 * a - b + a * c, np.tanh(b)])


def _text_p(table):
    return np.array([[1.0 if "good" in str(t).split() else 0.0,
                      0.1 * len(str(t).split())] for t in table["text"]],
                    np.float32)


def _image_p(table):
    return np.array([[float(np.mean(im)), float(np.mean(np.asarray(im)[..., 0]
                                                          ** 2))]
                     for im in table["image"]], np.float32)


def _scorers(p):
    class JaxScorer(JaxTransformer):
        def _transform(self, table):
            return table.with_column("probability", p(table))

    class PortScorer(Transformer):
        def _transform(self, table, device):
            return table.with_column("probability", p(table))
    return JaxScorer(), PortScorer()


class _Captured:
    """Records the solver inputs each package hands its surrogates."""

    def __init__(self, monkeypatch):
        self.jax, self.port = [], []
        for mod, names, sink in (
                (jlocal, ("batched_least_squares", "batched_lasso",
                          "batched_shap_fit"), self.jax),
                (local, ("weighted_least_squares", "weighted_lasso",
                         "shap_weighted_fit"), self.port)):
            for name in names:
                monkeypatch.setattr(mod, name,
                                    self._wrap(getattr(mod, name), name,
                                               sink))

    @staticmethod
    def _wrap(fn, name, sink):
        kind = ("lasso" if "lasso" in name else "shap" if "shap" in name
                else "ls")

        def call(*args):
            sink.append((kind, [a.numpy() if isinstance(a, torch.Tensor)
                                else np.asarray(a) for a in args]))
            return fn(*args)
        return call


TABLES = {
    "vector": lambda: Table({"features": np.random.default_rng(1).normal(
        size=(5, 3)).astype(np.float32)}),
    "tabular": lambda: Table({
        "a": np.array([1.0, 2.0, 0.0, -1.5]), "b": np.array([0.0, 1.0, 2.0,
                                                             0.5]),
        "c": np.array([0.3, -0.2, 1.0, 2.0]), "id": np.array([10, 11, 12,
                                                               13])}),
    "text": lambda: Table({"text": np.array(
        ["good movie plot", "bad movie plot twist ending", "good",
         "so so"], dtype=object)}),
    "image": lambda: Table({"image": local._obj_col(
        [_image(16, 16, seed=s) / 255.0 for s in range(2)]
        + [_image(24, 16, seed=9)]), "rowid": np.array([1, 2, 3])}),
}

EXPLAINERS = {
    "VectorLIME": ("vector", _vector_p, dict(input_col="features",
                                             num_samples=60)),
    "VectorSHAP": ("vector", _vector_p, dict(input_col="features",
                                             num_samples=64)),
    "TabularLIME": ("tabular", _tabular_p, dict(input_cols=["a", "b", "c"],
                                                num_samples=48,
                                                regularization=0.001)),
    "TabularSHAP": ("tabular", _tabular_p, dict(input_cols=["a", "b", "c"],
                                                num_samples=32)),
    "TextLIME": ("text", _text_p, dict(input_col="text", num_samples=64)),
    "TextSHAP": ("text", _text_p, dict(input_col="text", num_samples=64)),
    "ImageLIME": ("image", _image_p, dict(input_col="image", cell_size=8.0,
                                          num_samples=40)),
    "ImageSHAP": ("image", _image_p, dict(input_col="image", cell_size=8.0,
                                          num_samples=40)),
}


def _to_jax(table):
    return JaxTable({c: table[c] for c in table.columns})


@pytest.mark.parametrize("name", sorted(EXPLAINERS))
def test_explainer_matches_jax(name, monkeypatch):
    kind, p, params = EXPLAINERS[name]
    jmodel, pmodel = _scorers(p)
    common = dict(target_col="probability", target_classes=(0, 1), seed=3,
                  **params)
    ref = getattr(jlocal, name)(model=jmodel, **common)
    port = getattr(local, name)(model=pmodel, **common)
    table = TABLES[kind]()
    cap = _Captured(monkeypatch)
    want = ref.transform(_to_jax(table))
    got = port.transform(table, "cpu")
    assert got.columns == want.columns
    passed = list(table.columns)
    if kind in ("text", "image"):
        passed.append("tokens" if kind == "text" else "superpixels")
    for c in passed:
        for g, w in zip(got[c], want[c]):
            np.testing.assert_array_equal(np.asarray(g), np.asarray(w))
    out, ref_out = np.asarray(got["output"]), np.asarray(want["output"])
    assert out.shape == ref_out.shape and out.dtype == np.float32
    # the same solver inputs, bitwise, in the same order
    assert len(cap.port) == len(cap.jax)
    for (pk, pargs), (jk, jargs) in zip(cap.port, cap.jax):
        assert pk == jk
        for a, b in zip(pargs, jargs):
            if a.ndim == 0:  # the lasso's alpha: a float, cast on the device
                a = np.broadcast_to(a.astype(b.dtype), b.shape)
            np.testing.assert_array_equal(a, b)
    s = params["num_samples"]
    if name.endswith("SHAP"):
        _shap_rows_close(out, ref_out, cap.jax, s, _features_per_row(got,
                                                                     kind))
    else:
        _lime_rows_close(out, ref_out, cap.jax, s)


def _features_per_row(table, kind):
    n = table.num_rows
    if kind == "text":
        return np.array([max(len(t), 1) for t in table["tokens"]])
    if kind == "image":
        return np.array([int(sp.max()) + 1 for sp in table["superpixels"]])
    return np.full(n, np.asarray(table["output"]).shape[-1] - 1)


def _shap_rows_close(out, ref_out, calls, s, ds):
    """Each (row group, class) fit under its own system's bound, the
    calls in the reference's order: groups by feature count, then
    classes."""
    calls = iter(calls)
    for dv in np.unique(ds):
        idx = np.flatnonzero(ds == dv)
        for ki in range(out.shape[1]):
            _, (z, y, w, fnull, fx) = next(calls)
            assert z.shape == (len(idx), s, dv)
            got, want = out[idx, ki, :dv + 1], ref_out[idx, ki, :dv + 1]
            if dv > 1:
                _close_under_cond(got, want, _shap_system(z, w), s)
            else:
                np.testing.assert_array_equal(got, want)
            np.testing.assert_allclose(got[:, 1:].sum(1), fx - fnull,
                                       atol=EFFICIENCY_TOL)
    assert next(calls, None) is None


def _lime_rows_close(out, ref_out, calls, s):
    for ki, (kind, args) in enumerate(calls):
        x, y, w = args[:3]
        if kind == "lasso":
            system = _lasso_system(x, w)
        else:
            system = _ls_system(x, w)
        got, want = out[:, ki], ref_out[:, ki]
        if s >= 2 * x.shape[-1]:
            _close_under_cond(got, want, system, s)
        fit_w = _fitted(x, want, y, w)
        np.testing.assert_allclose(
            _fitted(x, got, y, w), fit_w, rtol=0,
            atol=FITTED_REL * max(float(np.abs(fit_w).max()), 1e-6))


def test_image_lime_below_two_d_samples_holds_the_fitted_values(monkeypatch):
    """ImageLIME's default 50 samples over 64 superpixels (a 32x32 image,
    cell 4): the coefficients are not determined, the fitted values are."""
    jmodel, pmodel = _scorers(_image_p)
    common = dict(input_col="image", target_col="probability",
                  target_classes=(0,), cell_size=4.0, seed=0)
    table = Table({"image": local._obj_col([_image(32, 32, seed=5)])})
    cap = _Captured(monkeypatch)
    want = jlocal.ImageLIME(model=jmodel, **common).transform(_to_jax(table))
    got = local.ImageLIME(model=pmodel, **common).transform(table, "cpu")
    (_, (x, y, w)), = cap.jax
    assert x.shape[-1] > 25 and x.shape[-2] == 50
    fit_w = _fitted(x, np.asarray(want["output"])[:, 0], y, w)
    np.testing.assert_allclose(
        _fitted(x, np.asarray(got["output"])[:, 0], y, w), fit_w, rtol=0,
        atol=FITTED_REL * float(np.abs(fit_w).max()))


@pytest.mark.parametrize("name", ["VectorSHAP", "TabularLIME", "TextSHAP",
                                  "ImageLIME"])
def test_explainers_default_to_cuda_and_raise_without_it(name, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    kind, p, params = EXPLAINERS[name]
    _, pmodel = _scorers(p)
    ex = getattr(local, name)(model=pmodel, **params)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ex.transform(TABLES[kind]())
    with pytest.raises(RuntimeError, match="device='cpu'"):
        explainers.superpixels(_image(8, 8, 0))


# ---------------------------------------------------------------------------
# TabularSHAP / TabularLIME over the Adult LightGBM model
# ---------------------------------------------------------------------------

FEATURES = [f"f{j}" for j in range(14)]


def _adult_rows(n):
    x = np.load(os.path.join(FIXTURES, "lgbm_adult_100x31_io.npz"))["x"][:n]
    return {c: x[:, j].astype(np.float64) for j, c in enumerate(FEATURES)}


@pytest.mark.parametrize("name", ["TabularSHAP", "TabularLIME"])
def test_tabular_over_the_adult_model_matches_jax(name, monkeypatch):
    kw = dict(input_cols=FEATURES, target_col="probability",
              target_classes=(1,), num_samples=48, seed=0)
    ref = getattr(jlocal, name)(model=JaxLGBM.load_native_model(
        ADULT, feature_cols=FEATURES), **kw)
    port = getattr(local, name)(model=LightGBMClassificationModel
                                .load_native_model(ADULT,
                                                   feature_cols=FEATURES),
                                **kw)
    cols = _adult_rows(24)
    cap = _Captured(monkeypatch)
    want = np.asarray(ref.transform(JaxTable(dict(cols)))["output"])
    got = np.asarray(port.transform(Table(dict(cols)), "cpu")["output"])
    (_, pargs), = cap.port
    (_, jargs), = cap.jax
    # the same states and weights; scores within an ulp of the sigmoid
    np.testing.assert_array_equal(pargs[0], jargs[0])
    np.testing.assert_array_equal(pargs[2], jargs[2])
    np.testing.assert_allclose(pargs[1], jargs[1], rtol=2 * EPS32, atol=0)
    if name == "TabularSHAP":
        z, y, w, fnull, fx = jargs
        _close_under_cond(got[:, 0], want[:, 0], _shap_system(z, w), 48)
        np.testing.assert_allclose(got[:, 0, 1:].sum(1), fx - fnull,
                                   atol=EFFICIENCY_TOL)
    else:
        x, y, w = jargs
        _close_under_cond(got[:, 0], want[:, 0], _ls_system(x, w), 48)


def test_tabular_shap_over_adult_matches_the_fixture_rows():
    """The first 16 of the fixture's 256 Adult rows (100 samples), with
    all 256 as the background: the sampler draws row by row, so these
    rows get the coalitions and the background of the JAX package's run
    of all 256 in ``image_explainer_fixtures.npz`` (``chip_smoke.py``
    phase 27 holds the whole table on the card). 1,600 scored rows keep
    the plain CPU traversal's index ops serial: from ~3,000 elements
    PyTorch's CPU index kernel takes its thread pool, and on a machine
    shared by several test workers each of the traversal's ~31,000 ops
    then waits milliseconds for it."""
    fx = np.load(os.path.join(FIXTURES, "image_explainer_fixtures.npz"))
    model = LightGBMClassificationModel.load_native_model(
        ADULT, feature_cols=FEATURES)
    ex = local.TabularSHAP(model=model, input_cols=FEATURES,
                           target_col="probability", target_classes=(1,),
                           num_samples=100, seed=0,
                           background_data=Table(_adult_rows(256)))
    got = np.asarray(ex.transform(Table(_adult_rows(16)), "cpu")["output"])
    want = fx["tabular_shap"][:16]
    assert got.shape == want.shape
    z, w = samplers.kernel_shap_samples(np.random.default_rng(0), 16, 100,
                                        14)
    _close_under_cond(got[:, 0], want[:, 0], _shap_system(z, w), 100)


def test_tabular_shap_over_onnx_scorer(monkeypatch):
    """``test_tabular_shap_over_onnx_scorer`` of ``tests/test_explainers.py``
    (BASELINE config 4): KernelSHAP over a LightGBM model converted to ONNX
    and scored through ``ONNXModel``, the same trees in both packages (the
    JAX fit carried over by ``Booster.to_dict``). The same states and
    weights bitwise, the ONNX scores within 1e-6 (the tree-sum rounding of
    ``tests/test_torch_onnx_ml.py``), the attributions within S · cond(A) ·
    eps32 · max|coef| a row, and f0's mean |phi| over 3x the others'."""
    from synapseml_tpu.gbdt.estimators import LightGBMClassifier as JFit
    from synapseml_tpu.onnx import ONNXModel as JONNXModel
    from synapseml_tpu.onnx import convert_lightgbm as jconvert
    from synapseml_tpu_torch.convert import booster_from_arrays
    from synapseml_tpu_torch.onnx import ONNXModel, convert_lightgbm

    rng = np.random.default_rng(2)
    x = rng.normal(size=(300, 3)).astype(np.float32)
    y = (x[:, 0] > 0).astype(np.float64)
    jlgbm = JFit(num_iterations=15, num_leaves=7).fit(
        JaxTable({"features": x, "label": y}))
    booster = booster_from_arrays(jlgbm.booster.to_dict())
    kw = dict(feed_dict={"input": "features"})
    jscorer = JONNXModel(model_bytes=jconvert(jlgbm), **kw)
    pscorer = ONNXModel(model_bytes=convert_lightgbm(booster), **kw)
    cols = ("f0", "f1", "f2")

    def feats(table):
        return np.column_stack([np.asarray(table[c], np.float32)
                                for c in cols])

    class JaxScorer(JaxTransformer):
        def _transform(self, table):
            scored = jscorer.transform(JaxTable({"features": feats(table)}))
            return table.with_column("probability",
                                     np.asarray(scored["probabilities"]))

    class PortScorer(Transformer):
        def _transform(self, table, device):
            scored = pscorer.transform(Table({"features": feats(table)}),
                                       device=device)
            return table.with_column("probability", scored["probabilities"])

    common = dict(input_cols=list(cols), target_col="probability",
                  target_classes=(1,), num_samples=32, seed=0)
    data = {c: x[:24, j].astype(np.float64) for j, c in enumerate(cols)}
    cap = _Captured(monkeypatch)
    want = np.asarray(jlocal.TabularSHAP(model=JaxScorer(), **common)
                      .transform(JaxTable(dict(data)))["output"])
    got = np.asarray(local.TabularSHAP(model=PortScorer(), **common)
                     .transform(Table(dict(data)), "cpu")["output"])
    (_, pargs), = cap.port
    (_, jargs), = cap.jax
    np.testing.assert_array_equal(pargs[0], jargs[0])
    np.testing.assert_array_equal(pargs[2], jargs[2])
    np.testing.assert_allclose(pargs[1], jargs[1], rtol=0, atol=1e-6)
    z, _, w, fnull, fx = jargs
    _close_under_cond(got[:, 0], want[:, 0], _shap_system(z, w), 32)
    np.testing.assert_allclose(got[:, 0, 1:].sum(1), fx - fnull,
                               atol=EFFICIENCY_TOL)
    mag = np.abs(got[:, 0, 1:]).mean(axis=0)
    assert mag[0] > 3 * max(mag[1], mag[2]), mag

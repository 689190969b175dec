"""GBDT training in the PyTorch port against the JAX package, on the CPU.

The same seeded numpy inputs go through the JAX reference and through the
port with ``device="cpu"``, where the histogram wrapper runs its plain
PyTorch version (kernel K1 runs only on the card, see
``tests/test_torch_cuda.py``). Each test states its tolerance and why.

Two facts set the tolerances. The plain histogram is bitwise the JAX
CPU ``segment_sum``. But JAX's CPU sums (``cumsum`` over bins, the leaf
totals, ``sigmoid``/``exp`` in the gradients) round in another order
than PyTorch's, so gains, leaf values and margins agree to a few float32
roundings, and a near-tie between two candidate splits could flip. The
training cases below are seeded so that no split is such a near-tie;
``test_best_split_matches_jax`` checks the tie rule where gains are apart.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from synapseml_tpu.data.table import Table as JTable
from synapseml_tpu.gbdt import binning as jbinning
from synapseml_tpu.gbdt import boosting as jboosting
from synapseml_tpu.gbdt import estimators as jestimators
from synapseml_tpu.gbdt import grower as jgrower
from synapseml_tpu.gbdt import objectives as jobj
from synapseml_tpu.gbdt import pallas_kernels

from synapseml_tpu_torch.convert import booster_from_arrays
from synapseml_tpu_torch.data.table import Table
from synapseml_tpu_torch.gbdt import binning, boosting, estimators, grower
from synapseml_tpu_torch.gbdt import kernels, objectives

EPS32 = 2.0 ** -24


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _rows(seed=0, n=2000, f=6, nan_frac=0.05):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, f))
    x[rng.random((n, f)) < nan_frac] = np.nan
    x0, x1, x2 = (np.nan_to_num(x[:, i]) for i in range(3))
    ys = {
        "binary": (x0 + 0.5 * x1 + rng.normal(scale=0.5, size=n) > 0
                   ).astype(np.float64),
        "regression": 2 * x0 + x2 ** 2 + rng.normal(scale=0.3, size=n),
    }
    yc = rng.integers(0, 3, n).astype(np.float64)
    yc[x0 > 1] = 2
    ys["multiclass"] = yc
    return x, ys


# -- binning ---------------------------------------------------------------

@pytest.mark.parametrize("max_bin,distinct,cat", [
    (255, None, ()),      # quantile cuts, uint8
    (16, 10, ()),         # midpoints between few distinct values
    (300, None, ()),      # > 256 total bins: uint16
    (63, None, (1,)),     # a categorical feature
])
def test_bin_mapper_matches_jax(max_bin, distinct, cat):
    """Bitwise: the same numpy code on the same float64 data."""
    rng = np.random.default_rng(max_bin)
    x = rng.normal(size=(3000, 4))
    if distinct:
        x = np.round(x * distinct / 4) / distinct
    x[:, 1] = rng.integers(0, 12, 3000)
    x[rng.random(x.shape) < 0.03] = np.nan
    x[5, :] = np.inf
    jm = jbinning.BinMapper(max_bin=max_bin, categorical_features=cat,
                            subsample=2000, seed=3).fit(x)
    tm = binning.BinMapper(max_bin=max_bin, categorical_features=cat,
                           subsample=2000, seed=3).fit(x)
    assert tm.total_bins == jm.total_bins
    for jb, tb in zip(jm.bins_, tm.bins_):
        np.testing.assert_array_equal(tb.upper_bounds, jb.upper_bounds)
        assert (tb.is_categorical, tb.n_bins) == (jb.is_categorical, jb.n_bins)
    jt, tt = jm.transform(x), tm.transform(x)
    assert tt.dtype == jt.dtype == (np.uint8 if jm.total_bins <= 256
                                    else np.uint16)
    np.testing.assert_array_equal(tt, jt)
    np.testing.assert_array_equal(tm.threshold_values(),
                                  jm.threshold_values())
    assert tt[5, 0] == tm.missing_bin(0)      # inf is missing: goes right


# -- objectives and metrics ------------------------------------------------

_OBJECTIVES = ["binary_logloss_obj", "l2_obj", "l1_obj", "huber_obj",
               "fair_obj", "poisson_obj", "quantile_obj", "mape_obj",
               "tweedie_obj"]


@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("name", _OBJECTIVES + ["softmax_obj"])
def test_objective_matches_jax(name, weighted):
    """Within 1e-6 relative (of the largest magnitude): exp and sigmoid
    round differently in XLA and PyTorch."""
    rng = np.random.default_rng(len(name))
    n = 500
    w = rng.random(n).astype(np.float32) if weighted else None
    if name == "softmax_obj":
        preds = rng.normal(size=(n, 3)).astype(np.float32)
        labels = np.eye(3, dtype=np.float32)[rng.integers(0, 3, n)]
    else:
        preds = rng.normal(size=n).astype(np.float32)
        labels = (3 * rng.random(n)).astype(np.float32)
    jg, jh = getattr(jobj, name)(jnp.asarray(preds), jnp.asarray(labels),
                                 None if w is None else jnp.asarray(w))
    tg, th = getattr(objectives, name)(_t(preds), _t(labels),
                                       None if w is None else _t(w))
    for j, t in ((jg, tg), (jh, th)):
        j = np.asarray(j)
        np.testing.assert_allclose(t.numpy(), j, rtol=1e-6,
                                   atol=1e-6 * np.abs(j).max())


@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("name", sorted(objectives.METRICS))
def test_metric_matches_jax(name, weighted):
    """Within 1e-6 relative: the means reduce in another order."""
    assert objectives.METRICS[name][1] == jobj.METRICS[name][1]
    rng = np.random.default_rng(7)
    n = 777
    w = rng.random(n).astype(np.float32) if weighted else None
    if name.startswith("multi"):
        preds = rng.normal(size=(n, 4)).astype(np.float32)
        labels = rng.integers(0, 4, n).astype(np.int32)
    else:
        preds = rng.normal(size=n).astype(np.float32)
        labels = (rng.random(n) < 0.4).astype(np.float32)
    if name == "auc":
        w = None   # the reference's AUC ignores weights
    want = float(jobj.METRICS[name][0](
        jnp.asarray(preds), jnp.asarray(labels),
        None if w is None else jnp.asarray(w)))
    got = float(objectives.METRICS[name][0](
        _t(preds), _t(labels), None if w is None else _t(w)))
    assert got == pytest.approx(want, rel=1e-6)


def test_objective_and_metric_tables_match_jax():
    assert sorted(objectives.REGRESSION_OBJECTIVES) == sorted(
        jobj.REGRESSION_OBJECTIVES)
    assert {k: v.__name__ for k, v in objectives.REGRESSION_OBJECTIVES.items()
            } == {k: v.__name__ for k, v in jobj.REGRESSION_OBJECTIVES.items()}
    assert sorted(objectives.METRICS) == sorted(jobj.METRICS)


# -- K1's plain version ----------------------------------------------------

@pytest.mark.parametrize("dtype,n_bins,masked", [
    (np.uint8, 256, False), (np.uint8, 256, True), (np.uint8, 37, True),
    (np.uint16, 1024, False), (np.uint16, 300, True),
])
def test_histogram_reference_bitwise_equals_jax(dtype, n_bins, masked):
    """Bitwise: index_add_ on the CPU adds in row order, as JAX's
    segment_sum does."""
    rng = np.random.default_rng(n_bins)
    n, f = 1009, 5                      # N a prime: a multiple of nothing
    binned = rng.integers(0, n_bins, (n, f)).astype(dtype)
    g = (rng.normal(size=n) * 10).astype(np.float32)
    h = rng.random(n).astype(np.float32)
    mask = rng.random(n) < (0.3 if masked else 2.0)
    want = np.asarray(jgrower.histogram(jnp.asarray(binned), jnp.asarray(g),
                                        jnp.asarray(h), jnp.asarray(mask),
                                        n_bins))
    got = grower.histogram(_t(binned), _t(g), _t(h), _t(mask), n_bins)
    assert got.dtype == torch.float32 and got.shape == (f, n_bins, 3)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("n", [3000, 700])
def test_histogram_reference_matches_pallas_interpret(n):
    """rtol = atol = 2e-4, the tolerance of the JAX package's own test of
    its kernel (tests/test_native.py): the Pallas kernel sums a bf16
    hi/lo split of the data on the MXU."""
    rng = np.random.default_rng(3)
    f, n_bins = 5, 64
    binned = rng.integers(0, n_bins, (n, f)).astype(np.uint8)
    data = rng.normal(size=(n, 3)).astype(np.float32)
    data[5:] *= rng.random(n - 5)[:, None] < 0.5
    want = np.asarray(pallas_kernels.histogram_tpu(
        jnp.asarray(binned, jnp.int32), jnp.asarray(data), n_bins,
        interpret=True))
    got = kernels.histogram_reference(_t(binned), _t(data), n_bins)
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("n,f", [(0, 3), (1, 1), (5, 0)])
def test_histogram_edge_shapes(n, f):
    binned = torch.zeros((n, f), dtype=torch.uint8)
    data = torch.ones((n, 3))
    out = kernels.histogram(binned, data, 4)
    assert out.shape == (f, 4, 3)
    assert float(out.sum()) == 3.0 * n * f


def test_histogram_count_column_is_exact_and_zero_mask_is_zero():
    rng = np.random.default_rng(1)
    binned = _t(rng.integers(0, 16, (5000, 3)).astype(np.uint8))
    g, h = _t(rng.normal(size=5000).astype(np.float32)), torch.ones(5000)
    full = grower.histogram(binned, g, h, torch.ones(5000, dtype=bool), 16)
    for fi in range(3):
        counts = np.bincount(binned[:, fi].numpy(), minlength=16)
        np.testing.assert_array_equal(full[fi, :, 2].numpy(), counts)
    zero = grower.histogram(binned, g, h, torch.zeros(5000, dtype=bool), 16)
    assert torch.equal(zero, torch.zeros_like(zero))


# -- split search and tree growth ------------------------------------------

def _grower_params(**kw):
    jp = jgrower.GrowerParams(**kw)
    return jp, grower.GrowerParams(**dataclasses.asdict(jp))


def test_grower_params_fields_match_jax():
    assert ([(f.name, f.default) for f in dataclasses.fields(
        jgrower.GrowerParams)] == [(f.name, f.default) for f in
                                   dataclasses.fields(grower.GrowerParams)])


@pytest.mark.parametrize("seed,kw", [
    (0, {}), (1, dict(lambda_l1=0.3, lambda_l2=1.0)),
    (2, dict(min_data_in_leaf=200)), (3, dict(min_sum_hessian_in_leaf=40.0)),
])
def test_best_split_matches_jax(seed, kw):
    """On one identical histogram: every gain within four float32
    roundings of the prefix sums it is computed from, carried through
    G^2/H (JAX's CPU cumsum adds in blocks of 16, the port in float64
    rounded once), and the same (feature, bin) wherever JAX's best two
    gains are more than 1e-5 apart, relatively."""
    rng = np.random.default_rng(seed)
    n, f, n_bins = 3000, 6, 32
    binned = rng.integers(0, n_bins, (n, f)).astype(np.uint8)
    g = rng.normal(size=n).astype(np.float32)
    h = (rng.random(n) + 0.2).astype(np.float32)
    hist = kernels.histogram_reference(
        _t(binned), _t(np.stack([g, h, np.ones(n, np.float32)], 1)), n_bins)
    totals = hist[0].sum(0)
    jp, tp = _grower_params(max_bin=n_bins, **kw)
    hist64 = hist.numpy().astype(np.float64)
    ulp_g = EPS32 * np.abs(hist64[..., 0]).sum(1, keepdims=True)
    ulp_h = EPS32 * hist64[..., 1].sum(1, keepdims=True)
    cum = np.cumsum(hist64, axis=1)
    bound = 0.0
    for gs, hs in ((cum[..., 0], cum[..., 1]),
                   (totals[0].item() - cum[..., 0],
                    totals[1].item() - cum[..., 1])):
        r = np.abs(gs) / np.clip(hs, 1e-12, None)
        bound = bound + 4 * (2 * r * ulp_g + r * r * ulp_h)
    for depth_ok in (True, False):
        jgain = np.asarray(jgrower._split_gains(
            jnp.asarray(hist.numpy()), jnp.asarray(totals.numpy()), jp,
            depth_ok))
        tgain = grower._split_gains(hist, totals, tp, depth_ok).numpy()
        fin = np.isfinite(jgain)
        np.testing.assert_array_equal(np.isfinite(tgain), fin)
        assert (np.abs(tgain[fin] - jgain[fin])
                <= bound[fin] + 1e-6 * np.abs(jgain[fin])).all()
        jg, jf, jb = (np.asarray(a) for a in jgrower.best_split(
            jnp.asarray(hist.numpy()), jnp.asarray(totals.numpy()), jp,
            depth_ok))
        tg, tf, tb = grower.best_split(hist, totals, tp, depth_ok)
        top2 = np.sort(jgain.ravel())[-2:]
        if np.isfinite(top2).all() and top2[1] - top2[0] > 1e-5 * abs(top2[1]):
            assert (int(tf), int(tb)) == (int(jf), int(jb))
        if not depth_ok:
            assert float(tg) == -np.inf and (int(tf), int(tb)) == (0, 0)


def test_best_split_batches_leaves():
    rng = np.random.default_rng(4)
    hist = _t((rng.random((2, 4, 16, 3)) * 50).astype(np.float32))
    totals = hist[:, 0].sum(1)
    p = grower.GrowerParams(max_bin=16, min_data_in_leaf=1)
    gains, feats, bins = grower.best_split(hist, totals, p)
    for i in range(2):
        g, fi, b = grower.best_split(hist[i], totals[i], p)
        assert (float(g), int(fi), int(b)) == (
            float(gains[i]), int(feats[i]), int(bins[i]))


@pytest.mark.parametrize("seed,kw", [
    (0, dict(max_depth=4)), (1, {}), (2, dict(lambda_l1=0.5)),
    (3, dict(lambda_l2=1.0, max_depth=4)), (4, dict(max_depth=4)),
    (5, dict(min_gain_to_split=2.0)),
])
def test_build_tree_matches_jax(seed, kw):
    """On identical binned/grad/hess/mask: identical split features, bin
    thresholds, children, row slots and covers; leaf values and gains
    within 1e-6 relative to the largest of them plus a few float32
    roundings of the gradient sums (JAX sums a leaf's histogram over bins
    in blocks of 32; the port in float64, rounded once)."""
    rng = np.random.default_rng(seed)
    n, f, n_bins = 1500, 6, 64
    binned = rng.integers(0, n_bins, (n, f)).astype(np.uint8)
    g = rng.normal(size=n).astype(np.float32)
    h = (rng.random(n) + 0.5).astype(np.float32)
    mask = rng.random(n) < 0.9
    thr = np.sort(rng.normal(size=(f, n_bins)), 1).astype(np.float32)
    jp, tp = _grower_params(num_leaves=15, max_bin=n_bins,
                            min_data_in_leaf=5, **kw)
    jt, jslot, jval, jnode = jgrower.build_tree(
        jnp.asarray(binned), jnp.asarray(g), jnp.asarray(h),
        jnp.asarray(mask), jnp.asarray(thr), jp)
    tt, tslot, tval, tnode = grower.build_tree(
        _t(binned), _t(g), _t(h), _t(mask), thr, tp)
    for name in ("split_feature", "threshold_bin", "left_child",
                 "right_child", "threshold", "cover"):
        np.testing.assert_array_equal(getattr(tt, name),
                                      np.asarray(getattr(jt, name)), name)
    np.testing.assert_array_equal(tslot.numpy(), np.asarray(jslot))
    np.testing.assert_array_equal(tnode, np.asarray(jnode))
    sum_abs_g = float(np.abs(g).sum())
    for t, j in ((tt.leaf_value, jt.leaf_value), (tt.gain, jt.gain),
                 (tval.numpy(), jval)):
        j = np.asarray(j)
        np.testing.assert_allclose(
            t, j, rtol=1e-6, atol=1e-6 * np.abs(j).max()
            + 8 * EPS32 * sum_abs_g * max(1.0, np.abs(j).max()))


def test_build_tree_stops_where_no_split_gains():
    """All gains below min_gain_to_split: a single leaf, one K1 pass."""
    rng = np.random.default_rng(0)
    binned = _t(rng.integers(0, 8, (200, 3)).astype(np.uint8))
    p = grower.GrowerParams(num_leaves=7, max_bin=8,
                            min_gain_to_split=1e9)
    tree, slot, val, node = grower.build_tree(
        binned, torch.ones(200), torch.ones(200),
        torch.ones(200, dtype=bool), np.zeros((3, 8), np.float32), p)
    assert (tree.split_feature == -1).all() and int(slot.max()) == 0
    assert tree.leaf_value[0] == pytest.approx(-200 / 200)
    np.testing.assert_array_equal(node, [0] + [-1] * 6)


# -- the boosting loop -----------------------------------------------------

def _assert_boosters_match(jb, tb, x, margin_tol=1e-5):
    """Identical tree structure and thresholds; leaf values and margins
    within ``margin_tol`` absolute."""
    assert tb.num_trees == jb.num_trees and tb.num_class == jb.num_class
    for name in ("trees_feature", "trees_threshold", "trees_left",
                 "trees_right", "trees_cover"):
        np.testing.assert_array_equal(getattr(tb, name), getattr(jb, name),
                                      name)
    np.testing.assert_allclose(tb.trees_value, jb.trees_value, rtol=0,
                               atol=margin_tol)
    assert tb.init_score == jb.init_score
    assert tb.best_iteration == jb.best_iteration
    np.testing.assert_allclose(tb.predict_raw(x, device="cpu"),
                               jb.predict_raw(x), rtol=0, atol=margin_tol)


_TRAIN_CASES = {
    "binary": (dict(objective="binary"), "binary"),
    "multiclass": (dict(objective="multiclass", num_class=3,
                        num_iterations=5), "multiclass"),
    "l2": (dict(objective="regression"), "regression"),
    "l1_renewal": (dict(objective="regression_l1"), "regression"),
    "quantile_renewal": (dict(objective="quantile", alpha=0.3),
                         "regression"),
    "l2_depth_lambdas": (dict(objective="regression", max_depth=3,
                              lambda_l1=0.2, lambda_l2=2.0), "regression"),
}


@pytest.mark.parametrize("case", sorted(_TRAIN_CASES))
def test_train_matches_jax(case):
    """2,000 x 6 rows with NaNs, 10 iterations of 15 leaves (5 for the
    3-class case): trees identical in structure; leaf values and margins
    within 1e-5 (gradients and sums round differently, see the module
    docstring)."""
    kw, label = _TRAIN_CASES[case]
    kw = {"num_iterations": 10, "num_leaves": 15, **kw}
    x, ys = _rows(seed=11 if case == "multiclass" else 0)
    jb = jboosting.train(jboosting.BoostParams(**kw), x, ys[label])
    before = (kernels.histogram.launches, kernels.forest_traverse.launches)
    tb = boosting.train(boosting.BoostParams(**kw), x, ys[label],
                        device="cpu")
    # a CPU fit runs the plain versions: neither kernel launches
    assert (kernels.histogram.launches,
            kernels.forest_traverse.launches) == before == (0, 0)
    _assert_boosters_match(jb, tb, _rows(seed=5, n=300)[0])
    np.testing.assert_allclose(tb.feature_importance_split,
                               jb.feature_importance_split)


def test_train_early_stopping_matches_jax():
    """A validation set with early stopping: the same metric history
    (within 1e-6 relative) and the same best_iteration."""
    x, ys = _rows(seed=2)
    y = ys["binary"]
    kw = dict(objective="binary", num_iterations=60, num_leaves=15,
              learning_rate=0.3, early_stopping_round=5)
    valid = [(x[1500:], y[1500:])]
    jb = jboosting.train(jboosting.BoostParams(**kw), x[:1500], y[:1500],
                         valid_sets=valid)
    tb = boosting.train(boosting.BoostParams(**kw), x[:1500], y[:1500],
                        valid_sets=valid, device="cpu")
    assert 0 <= jb.best_iteration < 59
    assert tb.best_iteration == jb.best_iteration
    np.testing.assert_allclose(tb.eval_history["binary_logloss"],
                               jb.eval_history["binary_logloss"], rtol=1e-6)
    _assert_boosters_match(jb, tb, x[1500:])


def test_train_learning_rate_schedule_and_hook_match_jax():
    x, ys = _rows(seed=3)
    kw = dict(objective="regression", num_iterations=8, num_leaves=7)
    lrs = np.linspace(0.3, 0.05, 8).astype(np.float32)
    jb = jboosting.train(jboosting.BoostParams(**kw), x, ys["regression"],
                         learning_rates=lrs)
    seen = []
    tb = boosting.train(boosting.BoostParams(**kw), x, ys["regression"],
                        learning_rates=lrs, iteration_hook=seen.append,
                        device="cpu")
    assert seen == list(range(1, 9))
    _assert_boosters_match(jb, tb, x[:200])
    with pytest.raises(ValueError, match="learning_rates"):
        boosting.train(boosting.BoostParams(**kw), x, ys["regression"],
                       learning_rates=lrs[:3], device="cpu")


@pytest.mark.parametrize("objective", ["binary", "multiclass"])
def test_train_continues_from_a_jax_booster(objective):
    """init_model: a JAX-trained booster carried over by
    booster_from_arrays; the port continues boosting from its margins."""
    x, ys = _rows(seed=11 if objective == "multiclass" else 4)
    y = ys[objective]
    kw = dict(objective=objective, num_leaves=7, num_iterations=4,
              num_class=3 if objective == "multiclass" else 1)
    first = jboosting.train(jboosting.BoostParams(**kw), x, y)
    jb = jboosting.train(jboosting.BoostParams(**kw), x, y,
                         init_model=first)
    tb = boosting.train(boosting.BoostParams(**kw), x, y,
                        init_model=booster_from_arrays(first.to_dict()),
                        device="cpu")
    assert tb.num_trees == 2 * first.num_trees
    _assert_boosters_match(jb, tb, x[:300])


_EST_CASES = [
    ("classifier", dict(num_iterations=8, num_leaves=7), "binary"),
    ("classifier", dict(num_iterations=4, num_leaves=7), "multiclass"),
    ("regressor", dict(num_iterations=8, num_leaves=7), "regression"),
    ("regressor", dict(num_iterations=6, num_leaves=7, objective="huber",
                       alpha=1.5), "regression"),
]


@pytest.mark.parametrize("kind,kw,label", _EST_CASES)
def test_estimator_fit_transform_matches_jax(kind, kw, label):
    """fit + transform: the same output columns as the JAX estimators,
    within 1e-5 (margins) and 1e-6 (probabilities); the same
    predictions."""
    x, ys = _rows(seed=11 if label == "multiclass" else 6)
    y = ys[label] * (5 if label == "multiclass" else 1)   # labels 0, 5, 10
    jcls = (jestimators.LightGBMClassifier if kind == "classifier"
            else jestimators.LightGBMRegressor)
    tcls = (estimators.LightGBMClassifier if kind == "classifier"
            else estimators.LightGBMRegressor)
    jm = jcls(**kw).fit(JTable({"features": x, "label": y}))
    tm = tcls(**kw).fit(Table({"features": x, "label": y}), device="cpu")
    q = _rows(seed=9, n=250)[0]
    jout = jm.transform(JTable({"features": q}))
    tout = tm.transform(Table({"features": q}), device="cpu")
    cols = (["rawPrediction", "probability", "prediction"]
            if kind == "classifier" else ["prediction"])
    for col in cols:
        tol = 1e-6 if col == "probability" else 1e-5
        np.testing.assert_allclose(tout[col], jout[col], rtol=0, atol=tol,
                                   err_msg=col)
    if kind == "classifier":
        assert tm.label_values == jm.label_values


def test_estimator_validation_and_batches_match_jax():
    """validation_indicator_col with early stopping, and num_batches
    threading the booster through two batches with a delegate."""
    x, ys = _rows(seed=4)
    y = ys["binary"]
    ind = np.zeros(len(y), bool)
    ind[1500:] = True
    kw = dict(num_iterations=40, num_leaves=15, learning_rate=0.3,
              early_stopping_round=5, validation_indicator_col="valid")

    class Hooks:
        def __init__(self, base):
            class D(base):
                def __init__(self):
                    self.calls = []

                def after_train_iteration(self, bi, done):
                    self.calls.append((bi, done))

                def get_learning_rate(self, bi, it, prev):
                    return prev * 0.9
            self.d = D()

    jd = Hooks(jestimators.LightGBMDelegate).d
    td = Hooks(estimators.LightGBMDelegate).d
    jm = jestimators.LightGBMClassifier(**kw, num_batches=2, delegate=jd).fit(
        JTable({"features": x, "label": y, "valid": ind}))
    tm = estimators.LightGBMClassifier(**kw, num_batches=2, delegate=td).fit(
        Table({"features": x, "label": y, "valid": ind}), device="cpu")
    assert tm.booster.best_iteration == jm.booster.best_iteration
    _assert_boosters_match(jm.booster, tm.booster, x[:300])
    # the port reports every iteration; the reference whole scan chunks
    assert [c for c in td.calls if c in jd.calls] == jd.calls


# -- options once refused, and the device rule ------------------------------

@pytest.mark.parametrize("kw", [
    dict(tree_learner="voting_parallel"),
], ids=lambda kw: ",".join(f"{k}={v}" for k, v in kw.items()))
def test_unported_options_raise(kw):
    """voting_parallel was refused before data-parallel training was
    ported; without a mesh it now trains as data_parallel, bitwise, as the
    reference's does (its grower.py:479)."""
    x, ys = _rows(n=100)
    got = boosting.train(boosting.BoostParams(**kw), x, ys["binary"],
                         device="cpu")
    want = boosting.train(boosting.BoostParams(), x, ys["binary"],
                          device="cpu")
    for name in ("trees_feature", "trees_threshold", "trees_value"):
        np.testing.assert_array_equal(getattr(got, name),
                                      getattr(want, name))


@pytest.mark.parametrize("extra", [dict(mesh=object())])
def test_unported_train_arguments_raise(extra):
    """``mesh`` is a torch.distributed process group (data-parallel
    training, tests/test_torch_gbdt_dp.py); anything else raises."""
    x, ys = _rows(n=100)
    with pytest.raises(ValueError, match="process group"):
        boosting.train(boosting.BoostParams(), x, ys["binary"],
                       device="cpu", **extra)


def test_unknown_tree_learner_raises_as_in_jax():
    x, ys = _rows(n=100)
    with pytest.raises(ValueError, match="tree_learner"):
        jboosting.train(jboosting.BoostParams(tree_learner="feature_parallel"),
                        x, ys["binary"])
    with pytest.raises(ValueError, match="tree_learner"):
        boosting.train(boosting.BoostParams(tree_learner="feature_parallel"),
                       x, ys["binary"], device="cpu")


def test_fit_raises_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    x, ys = _rows(n=100)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        estimators.LightGBMClassifier(num_iterations=2).fit(
            Table({"features": x, "label": ys["binary"]}))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        boosting.train(boosting.BoostParams(), x, ys["binary"])


def test_hist_backend_is_carried_not_read():
    """A stage saved by the JAX package carries hist_backend; the port
    accepts every value and trains the same trees."""
    x, ys = _rows(n=400)
    table = Table({"features": x, "label": ys["binary"]})
    arrays = [estimators.LightGBMClassifier(
        num_iterations=3, num_leaves=5, hist_backend=b).fit(
            table, device="cpu").booster.trees_threshold
        for b in ("auto", "pallas", "xla")]
    assert all(np.array_equal(arrays[0], a) for a in arrays[1:])

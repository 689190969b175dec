"""Sampled and alternative boosting in the PyTorch port against the JAX
package, on the CPU: bagging (with pos/neg fractions and
``bagging_seed``), ``feature_fraction``, goss, rf, dart, and step
checkpoints.

The same seeded numpy inputs go through the JAX reference and through the
port with ``device="cpu"`` (kernel K1 runs only on the card; there its
plain version runs). Two kinds of check:

- **Masks, bitwise.** The port's row and feature sampling
  (``boosting._sample_rows``, ``boosting._feature_keep``) against the
  reference's ``sample_mask_and_weights``/``feature_mask``
  (``synapseml_tpu/gbdt/boosting.py:944-982``, written out below with
  ``jax.random`` as they stand there, since they live inside a jitted
  closure) on identical gradients and keys. DART's drop sets and weights
  against the reference's ``_dart_select``/``_dart_normalize``.
- **Trees.** Whole fits, as ``tests/test_torch_gbdt_train.py`` holds them:
  tree structure, thresholds and per-node row counts identical (the
  counts show that the same rows were sampled), leaf values and margins
  within 1e-5 (JAX's CPU sums and ``exp`` round differently from
  PyTorch's). Binary GOSS is where that rounding shows most. GOSS keeps
  the rows whose |gradient| reaches the ``top_rate`` quantile; binary
  gradients tie in whole leaves, and a last-bit difference in ``exp`` can
  move such a group across the threshold. And it multiplies the sampled
  small gradients by ``(1 - top_rate) / other_rate``, which makes the
  rounding gaps of the split gains larger, so two near-equal candidate
  splits can swap (seen: gains 7.6411133 and 7.641037 at one node).
  The binary GOSS fits use seeds without either; L2 regression
  gradients are exact differences and do not tie.
"""
import dataclasses
import json
import os
import signal
import subprocess
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from synapseml_tpu.data.table import Table as JTable
from synapseml_tpu.gbdt import boosting as jboosting
from synapseml_tpu.gbdt import estimators as jestimators

from synapseml_tpu_torch.data.table import Table
from synapseml_tpu_torch.gbdt import boosting, estimators

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURES = os.path.join(ROOT, "tests", "fixtures")
MARGIN_TOL = 1e-5


def _rows(seed=0, n=600, f=6):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, f))
    x[rng.random((n, f)) < 0.05] = np.nan
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


def _assert_boosters_match(jb, tb, x):
    assert tb.num_trees == jb.num_trees and tb.num_class == jb.num_class
    for name in ("trees_feature", "trees_threshold", "trees_left",
                 "trees_right", "trees_cover", "tree_weights"):
        np.testing.assert_array_equal(getattr(tb, name), getattr(jb, name),
                                      name)
    np.testing.assert_allclose(tb.trees_value, jb.trees_value, rtol=0,
                               atol=MARGIN_TOL)
    assert tb.init_score == jb.init_score
    assert tb.best_iteration == jb.best_iteration
    np.testing.assert_allclose(tb.predict_raw(x, device="cpu"),
                               jb.predict_raw(x), rtol=0, atol=MARGIN_TOL)


# -- masks on identical inputs ----------------------------------------------

def _jax_sample(p, grad, hess, y, key):
    """``sample_mask_and_weights`` of the reference, as written there."""
    n = grad.shape[0]
    is_rf = p.boosting_type == "rf"
    strat = p.pos_bagging_fraction < 1.0 or p.neg_bagging_fraction < 1.0
    if p.boosting_type == "goss":
        a, b = p.top_rate, p.other_rate
        n_top = max(1, int(a * n))
        thresh = -jnp.sort(-jnp.abs(grad))[n_top - 1]
        top = jnp.abs(grad) >= thresh
        rand = jax.random.uniform(key, (n,)) < b
        amp = (1.0 - a) / max(b, 1e-12)
        small = (~top) & rand
        return (top | small, jnp.where(small, grad * amp, grad),
                jnp.where(small, hess * amp, hess))
    bkey = (key if p.bagging_seed is None
            else jax.random.fold_in(key, p.bagging_seed))
    u = jax.random.uniform(bkey, (n,))
    if strat and not is_rf:
        return (jnp.where(y > 0, u < p.pos_bagging_fraction,
                          u < p.neg_bagging_fraction), grad, hess)
    frac = p.bagging_fraction if not is_rf else (
        p.bagging_fraction if p.bagging_fraction < 1.0 else 0.632)
    return u < frac, grad, hess


def _jax_feature_mask(p, f, key):
    """``feature_mask`` of the reference, as written there."""
    keep = max(1, int(round(p.feature_fraction * f)))
    perm = jax.random.permutation(key, f)
    return jnp.zeros(f, jnp.bool_).at[perm[:keep]].set(True)


def _step_keys(seed, steps):
    """(row key, feature key) of each step, as the reference's scan draws
    them: ``rng, key = split(rng)``, then ``k1, k2 = split(key)``."""
    rng, out = jax.random.PRNGKey(seed), []
    for _ in range(steps):
        rng, key = jax.random.split(rng)
        out.append(tuple(jax.random.split(key)))
    return out


def _bits(a) -> np.ndarray:
    return np.ascontiguousarray(np.asarray(a, np.float32)).view(np.uint32)


@pytest.mark.parametrize("kw", [
    dict(bagging_fraction=0.7, bagging_freq=1),
    dict(bagging_fraction=0.5, bagging_freq=1, bagging_seed=5),
    dict(pos_bagging_fraction=0.6, neg_bagging_fraction=0.3, bagging_freq=1),
    dict(pos_bagging_fraction=0.5, bagging_freq=1, bagging_seed=2 ** 31 - 1),
    dict(boosting_type="rf"),
    dict(boosting_type="rf", bagging_fraction=0.45, bagging_freq=1,
         pos_bagging_fraction=0.2),
    dict(boosting_type="goss"),
    dict(boosting_type="goss", top_rate=0.35, other_rate=0.15),
], ids=lambda kw: ",".join(f"{k}={v}" for k, v in kw.items()))
@pytest.mark.parametrize("seed", [0, 42])
def test_row_masks_bitwise_equal_jax(kw, seed):
    """Gradients with whole groups of ties (as a leaf's rows have), the
    keys of the first steps of a fit: the same mask, and for GOSS the same
    amplified gradients, bit for bit."""
    rng = np.random.default_rng(seed)
    n = 1_013
    grad = rng.choice(rng.normal(size=40), n).astype(np.float32)
    hess = rng.random(n).astype(np.float32)
    y = (rng.random(n) < 0.4).astype(np.float32)
    jp, tp = jboosting.BoostParams(**kw), boosting.BoostParams(**kw)
    for row_key, _ in _step_keys(seed, 3):
        jm, jg, jh = _jax_sample(jp, jnp.asarray(grad), jnp.asarray(hess),
                                 jnp.asarray(y), row_key)
        tm, tg, th = boosting._sample_rows(
            tp, torch.from_numpy(grad), torch.from_numpy(hess),
            torch.from_numpy(y), torch.from_numpy(
                np.asarray(jax.random.key_data(row_key)).astype(np.int64)))
        assert np.array_equal(tm.numpy(), np.asarray(jm))
        assert 0 < int(tm.sum()) < n
        assert np.array_equal(_bits(tg), _bits(jg))
        assert np.array_equal(_bits(th), _bits(jh))


@pytest.mark.parametrize("f,frac", [(6, 0.5), (14, 0.8), (14, 0.3), (1, 0.5),
                                    (3, 0.1), (100, 0.77)])
@pytest.mark.parametrize("seed", [0, 3])
def test_feature_masks_bitwise_equal_jax(f, frac, seed):
    jp = jboosting.BoostParams(feature_fraction=frac)
    tp = boosting.BoostParams(feature_fraction=frac)
    for _, feature_key in _step_keys(seed, 4):
        want = np.asarray(_jax_feature_mask(jp, f, feature_key))
        got = boosting._feature_keep(tp, f, torch.from_numpy(
            np.asarray(jax.random.key_data(feature_key)).astype(np.int64)))
        assert np.array_equal(got.numpy(), want)
        assert int(want.sum()) == max(1, int(round(frac * f)))


def test_dart_select_and_normalize_equal_jax():
    """The drop sets of every mode (tests/test_gbdt.py:832-930) from the
    same host RNG states, and the weights they lead to, bitwise."""
    cases = [
        dict(drop_rate=1.0, skip_drop=0.0, max_drop=2),
        dict(drop_rate=0.5, skip_drop=0.0, max_drop=0),
        dict(drop_rate=0.5, skip_drop=0.0, max_drop=0, uniform_drop=True),
        dict(drop_rate=0.3, skip_drop=0.5),
        dict(drop_rate=0.3, skip_drop=1.0),
    ]
    weight_sets = [np.ones(5), np.array([0.0, 1.0, 1.0, 1.0, 1.0, 1.0]),
                   np.array([0.1, 0.05, 0.2, 0.0125]), np.zeros(3),
                   np.empty(0)]
    for kw in cases:
        jp = jboosting.BoostParams(boosting_type="dart", **kw)
        tp = boosting.BoostParams(boosting_type="dart", **kw)
        for w in weight_sets:
            jr, tr = np.random.default_rng(7), np.random.default_rng(7)
            for _ in range(20):
                want = jboosting._dart_select(jr, len(w), w, jp)
                got = boosting._dart_select(tr, len(w), w, tp)
                assert got.dtype == want.dtype
                assert np.array_equal(got, want)
    for lr, xgb in ((0.3, False), (0.3, True), (0.05, True)):
        jp = jboosting.BoostParams(learning_rate=lr, xgboost_dart_mode=xgb)
        tp = boosting.BoostParams(learning_rate=lr, xgboost_dart_mode=xgb)
        for kd in range(5):
            assert (boosting._dart_normalize(tp, kd)
                    == jboosting._dart_normalize(jp, kd))


# -- whole fits against the JAX package -------------------------------------

_FIT_CASES = {
    "bagging": (dict(bagging_fraction=0.7, bagging_freq=1), "binary", 0),
    "bagging_freq_3": (dict(bagging_fraction=0.6, bagging_freq=3),
                       "binary", 1),
    "bagging_seed": (dict(bagging_fraction=0.7, bagging_freq=1,
                          bagging_seed=5), "binary", 0),
    "pos_neg_bagging": (dict(pos_bagging_fraction=0.6,
                             neg_bagging_fraction=0.8, bagging_freq=1),
                        "binary", 0),
    "bagging_multiclass": (dict(objective="multiclass", num_class=3,
                                bagging_fraction=0.7, bagging_freq=1,
                                num_iterations=5), "multiclass", 11),
    "bagging_l2": (dict(objective="regression", bagging_fraction=0.5,
                        bagging_freq=1), "regression", 2),
    "feature_fraction": (dict(feature_fraction=0.5), "binary", 0),
    "bagging_feature_fraction_multiclass": (
        dict(objective="multiclass", num_class=3, bagging_fraction=0.7,
             bagging_freq=1, feature_fraction=0.7, num_iterations=5),
        "multiclass", 11),
    "goss_binary": (dict(boosting_type="goss", top_rate=0.3,
                         other_rate=0.2), "binary", 1),
    "goss_l2": (dict(objective="regression", boosting_type="goss",
                     top_rate=0.3, other_rate=0.2), "regression", 0),
    "goss_feature_fraction": (dict(boosting_type="goss",
                                   feature_fraction=0.7), "binary", 2),
    "rf": (dict(boosting_type="rf", bagging_fraction=0.7, bagging_freq=1),
           "binary", 0),
    "rf_default_fraction": (dict(boosting_type="rf"), "binary", 0),
    "rf_multiclass": (dict(objective="multiclass", num_class=3,
                           boosting_type="rf", feature_fraction=0.7,
                           num_iterations=5), "multiclass", 11),
    "dart_weighted": (dict(boosting_type="dart", drop_rate=0.3,
                           skip_drop=0.2), "binary", 0),
    "dart_uniform": (dict(boosting_type="dart", drop_rate=0.3,
                          skip_drop=0.2, uniform_drop=True), "binary", 0),
    "dart_xgboost_max_drop": (dict(boosting_type="dart", drop_rate=0.6,
                                   skip_drop=0.0, max_drop=2,
                                   xgboost_dart_mode=True), "binary", 3),
    "dart_l2_ignores_sampling": (
        dict(objective="regression", boosting_type="dart", drop_rate=0.4,
             skip_drop=0.1, bagging_fraction=0.5, bagging_freq=1,
             feature_fraction=0.5), "regression", 0),
    "dart_multiclass": (dict(objective="multiclass", num_class=3,
                             boosting_type="dart", drop_rate=0.3,
                             skip_drop=0.2, num_iterations=5),
                        "multiclass", 11),
}


@pytest.mark.parametrize("case", sorted(_FIT_CASES))
def test_fit_matches_jax(case):
    """600 x 6 rows with NaNs, 8 iterations of 8 leaves (5 for 3 classes):
    the same trees, row counts and tree weights; leaf values and margins
    within 1e-5."""
    kw, label, seed = _FIT_CASES[case]
    kw = {"num_iterations": 8, "num_leaves": 8, **kw}
    x, ys = _rows(seed=seed)
    jb = jboosting.train(jboosting.BoostParams(**kw), x, ys[label])
    tb = boosting.train(boosting.BoostParams(**kw), x, ys[label],
                        device="cpu")
    _assert_boosters_match(jb, tb, _rows(seed=5, n=300)[0])
    if kw.get("boosting_type") == "dart":
        assert len(set(tb.tree_weights.tolist())) > 1   # rounds dropped


def test_feature_fraction_fit_masks_feature_0_and_not():
    """The ``feature_fraction`` fit above: feature 0, whose histogram
    gives every leaf's totals, is masked in some trees and not in others,
    and a masked feature never splits."""
    kw = dict(num_iterations=8, num_leaves=8, feature_fraction=0.5)
    x, ys = _rows(seed=0)
    tb = boosting.train(boosting.BoostParams(**kw), x, ys["binary"],
                        device="cpu")
    jp = jboosting.BoostParams(**kw)
    masks = [np.asarray(_jax_feature_mask(jp, 6, fk))
             for _, fk in _step_keys(0, 8)]
    assert {bool(m[0]) for m in masks} == {True, False}
    for t, m in enumerate(masks):
        used = tb.trees_feature[t][tb.trees_feature[t] >= 0]
        assert m[used].all()


def test_rf_validation_metric_is_the_average_and_matches_jax():
    """rf's running validation sum is scaled by 1/(it+1) before the metric
    (the reference's scan, boosting.py:1058; tests/test_gbdt.py:294): the
    same history and best_iteration as the JAX package."""
    x, ys = _rows(seed=4, n=800)
    y = ys["binary"]
    kw = dict(boosting_type="rf", bagging_fraction=0.8, bagging_freq=1,
              num_iterations=15, num_leaves=8, early_stopping_round=3)
    valid = [(x[600:], y[600:])]
    jb = jboosting.train(jboosting.BoostParams(**kw), x[:600], y[:600],
                         valid_sets=valid)
    tb = boosting.train(boosting.BoostParams(**kw), x[:600], y[:600],
                        valid_sets=valid, device="cpu")
    np.testing.assert_allclose(tb.eval_history["binary_logloss"],
                               jb.eval_history["binary_logloss"], rtol=1e-6)
    _assert_boosters_match(jb, tb, x[600:])
    # the metric is that of the averaged margins, not of their sum
    it = len(tb.eval_history["binary_logloss"])
    raw = boosting.Booster.from_dict(dict(
        tb.to_dict(), best_iteration=-1)).predict_raw(x[600:], device="cpu")
    p = np.clip(1 / (1 + np.exp(-raw.astype(np.float64))), 1e-15, 1 - 1e-15)
    yv = y[600:]
    want = -(yv * np.log(p) + (1 - yv) * np.log(1 - p)).mean()
    assert tb.num_trees == it
    np.testing.assert_allclose(tb.eval_history["binary_logloss"][-1], want,
                               rtol=1e-5)


@pytest.mark.parametrize("kw,data_seed", [
    (dict(boosting_type="dart", drop_rate=0.3, skip_drop=0.0), 1),
    (dict(boosting_type="goss", feature_fraction=0.8), 5),
    (dict(bagging_fraction=0.6, bagging_freq=1, bagging_seed=9), 1),
], ids=["dart", "goss", "bagging"])
def test_estimator_fit_transform_matches_jax(kw, data_seed):
    """The estimators hand the params to ``BoostParams`` as the JAX
    package does, and ``LightGBMClassifier(boosting_type="dart").fit``
    trains: the same trees and output columns (GOSS on a seed without a
    near-tie, see the module docstring)."""
    x, ys = _rows(seed=data_seed)
    kw = dict(num_iterations=6, num_leaves=7, seed=3, **kw)
    jm = jestimators.LightGBMClassifier(**kw)
    tm = estimators.LightGBMClassifier(**kw)
    assert (dataclasses.asdict(tm._boost_params("binary"))
            == dataclasses.asdict(jm._boost_params("binary")))
    jm = jm.fit(JTable({"features": x, "label": ys["binary"]}))
    tm = tm.fit(Table({"features": x, "label": ys["binary"]}), device="cpu")
    _assert_boosters_match(jm.booster, tm.booster, x[:200])
    want = jm.transform(JTable({"features": x[:200]}))
    got = tm.transform(Table({"features": x[:200]}), device="cpu")
    np.testing.assert_array_equal(got["prediction"], want["prediction"])
    np.testing.assert_allclose(got["probability"], want["probability"],
                               rtol=0, atol=MARGIN_TOL)


def test_sampled_adult_fixture_loads_and_scores_as_jax():
    """The JAX-trained sampled Adult fixture (bagging 0.8, feature_fraction
    0.8; ``make_lgbm_adult_sampled_fixture.py``) scores in the port as the
    JAX package recorded it, bitwise. ``chip_smoke.py`` retrains it on the
    card and holds the trees to it; that 100-iteration fit is too long for
    these tests."""
    with open(os.path.join(FIXTURES, "lgbm_adult_100x31_bag08_ff08.txt")) as fh:
        booster = boosting.Booster.load_string(fh.read())
    io = np.load(os.path.join(FIXTURES,
                              "lgbm_adult_100x31_bag08_ff08_io.npz"))
    assert bool(io["jax_threefry_partitionable"])
    assert booster.num_trees == 100 and booster.num_features == 14
    assert np.array_equal(booster.predict_raw(io["x"], device="cpu"),
                          io["raw"])
    np.testing.assert_allclose(booster.predict(io["x"], device="cpu"),
                               io["prob"], rtol=0, atol=1e-7)


# -- guards -------------------------------------------------------------------

@pytest.mark.parametrize("boosting_type,extra", [
    ("rf", "init_model"), ("dart", "init_model"),
    ("rf", "learning_rates"), ("dart", "learning_rates"),
    ("dart", "checkpoint_dir"),
])
def test_rf_and_dart_guards_raise_as_in_jax(boosting_type, extra, tmp_path):
    x, ys = _rows(n=200)
    y = ys["binary"]
    first = jboosting.train(jboosting.BoostParams(num_iterations=2,
                                                  num_leaves=4), x, y)
    args = {"init_model": (first, boosting.Booster.load_string(
                first.save_string())),
            "learning_rates": (np.full(3, 0.1, np.float32),) * 2,
            "checkpoint_dir": (str(tmp_path / "j"), str(tmp_path / "t"))}
    jarg, targ = args[extra]
    kw = dict(boosting_type=boosting_type, num_iterations=3, num_leaves=4)
    with pytest.raises(NotImplementedError) as jerr:
        jboosting.train(jboosting.BoostParams(**kw), x, y, **{extra: jarg})
    with pytest.raises(NotImplementedError) as terr:
        boosting.train(boosting.BoostParams(**kw), x, y, device="cpu",
                       **{extra: targ})
    assert str(terr.value) == str(jerr.value)
    if extra == "checkpoint_dir":      # refused before anything is written
        assert not os.path.exists(targ)


# -- checkpoints --------------------------------------------------------------

def _record_checkpoints(monkeypatch, module):
    written = []
    save = module.save_checkpoint

    def record(path, booster, done, total):
        written.append((done, total, booster.num_trees,
                        booster.best_iteration))
        save(path, booster, done, total)
    monkeypatch.setattr(module, "save_checkpoint", record)
    return written


@pytest.mark.parametrize("iters,every,esr", [
    (12, 4, 0), (10, 4, 0), (10, 0, 0), (7, 1, 0), (20, 30, 0),
    (40, 5, 3),       # early stopping in the first chunk of 5
    (40, 0, 2),       # early stopping: chunks of max(esr, 16)
    (30, 0, 40),      # early stopping on, never stops
], ids=lambda v: str(v))
def test_checkpoints_written_where_jax_writes_them(monkeypatch, tmp_path,
                                                   iters, every, esr):
    """Checkpoints land at the same ``iterations_done`` as the reference's
    (its scan chunks' ends), never past an early stop, with the same tree
    counts and best_iteration; the last one loads into either package."""
    x, ys = _rows(seed=2, n=500)
    y = ys["binary"]
    kw = dict(num_iterations=iters, num_leaves=5, learning_rate=0.3,
              early_stopping_round=esr)
    valid = [(x[400:], y[400:])] if esr else []
    jw = _record_checkpoints(monkeypatch, jboosting)
    tw = _record_checkpoints(monkeypatch, boosting)
    jb = jboosting.train(jboosting.BoostParams(**kw), x[:400], y[:400],
                         valid_sets=valid, checkpoint_dir=str(tmp_path / "j"),
                         checkpoint_every=every)
    tb = boosting.train(boosting.BoostParams(**kw), x[:400], y[:400],
                        valid_sets=valid, checkpoint_dir=str(tmp_path / "t"),
                        checkpoint_every=every, device="cpu")
    assert tw == jw
    assert tb.best_iteration == jb.best_iteration
    if not tw:        # stopped inside the first chunk
        assert not os.path.exists(tmp_path / "t")
        return
    for d in ("j", "t"):
        for load in (jboosting.load_checkpoint, boosting.load_checkpoint):
            loaded, meta = load(str(tmp_path / d))
            assert (meta["iterations_done"], meta["total_iterations"],
                    loaded.num_trees, meta["best_iteration"]) == tw[-1]
            assert loaded.best_iteration == tw[-1][3]


@pytest.mark.parametrize("kw", [
    dict(objective="binary"),
    dict(objective="multiclass", num_class=3),
    dict(boosting_type="rf", bagging_fraction=0.7, bagging_freq=1),
    dict(boosting_type="goss", feature_fraction=0.7),
], ids=["binary", "multiclass", "rf", "goss"])
def test_checkpoint_round_trips_between_packages(tmp_path, kw):
    """A checkpoint written by the JAX package loads into the port and one
    written by the port into the JAX package; each scores as the booster
    it holds. Resuming the JAX checkpoint in the port grows the trees the
    JAX package grows from it."""
    x, ys = _rows(seed=11 if "num_class" in kw else 3, n=500)
    y = ys["multiclass" if "num_class" in kw else "binary"]
    kw = dict(num_iterations=6, num_leaves=6, **kw)
    jb = jboosting.train(jboosting.BoostParams(**kw), x, y,
                         checkpoint_dir=str(tmp_path / "j"),
                         checkpoint_every=4)
    tb = boosting.train(boosting.BoostParams(**kw), x, y,
                        checkpoint_dir=str(tmp_path / "t"),
                        checkpoint_every=4, device="cpu")
    t_from_j, jmeta = boosting.load_checkpoint(str(tmp_path / "j"))
    j_from_t, tmeta = jboosting.load_checkpoint(str(tmp_path / "t"))
    assert jmeta == tmeta == {"iterations_done": 6, "total_iterations": 6,
                              "best_iteration": -1}
    got = t_from_j.predict_raw(x, device="cpu")
    want = jboosting.Booster.load_string(jb.save_string()).predict_raw(x)
    if kw.get("boosting_type") == "rf":
        # non-unit tree weights: the JAX CPU scan adds value*w with an
        # FMA, the port folds the weight first (ROADMAP.md Queue 3)
        bound = t_from_j.num_trees * 2.0 ** -24 * np.maximum(1, abs(want))
        assert (np.abs(got - want) <= bound).all()
    else:
        assert np.array_equal(got, want)
    np.testing.assert_allclose(j_from_t.predict_raw(x),
                               tb.predict_raw(x, device="cpu"), rtol=0,
                               atol=MARGIN_TOL)
    if kw.get("boosting_type") == "rf":
        return    # rf does not continue from a model (guard above)
    more = dict(kw, num_iterations=3)
    jr = jboosting.train(jboosting.BoostParams(**more), x, y,
                         init_model=jboosting.load_checkpoint(
                             str(tmp_path / "j"))[0])
    tr = boosting.train(boosting.BoostParams(**more), x, y,
                        init_model=t_from_j, device="cpu")
    _assert_boosters_match(jr, tr, x[:200])


def test_checkpoint_under_early_stopping_keeps_full_stack(tmp_path):
    """The stored model carries every tree so far; best_iteration rides in
    the metadata (tests/test_checkpoint.py:124)."""
    x, ys = _rows(seed=2, n=620)
    y = ys["binary"]
    p = boosting.BoostParams(num_iterations=30, num_leaves=5,
                             early_stopping_round=50)
    b = boosting.train(p, x[:500], y[:500], valid_sets=[(x[500:], y[500:])],
                       checkpoint_dir=str(tmp_path), checkpoint_every=5,
                       device="cpu")
    loaded, meta = boosting.load_checkpoint(str(tmp_path))
    assert loaded.num_trees == meta["iterations_done"] == 30
    assert loaded.best_iteration == meta["best_iteration"] == b.best_iteration
    np.testing.assert_allclose(loaded.predict(x, device="cpu"),
                               b.predict(x, device="cpu"), rtol=1e-6,
                               atol=1e-7)


def test_resume_from_checkpoint_equals_uninterrupted(tmp_path):
    """8 iterations with a checkpoint, then 12 more from it: the run of 20
    (deterministic gbdt; tests/test_checkpoint.py:24)."""
    x, ys = _rows(seed=6, n=500)
    y = ys["binary"]
    p = boosting.BoostParams(num_iterations=20, num_leaves=7)
    full = boosting.train(p, x, y, device="cpu")
    boosting.train(dataclasses.replace(p, num_iterations=8), x, y,
                   checkpoint_dir=str(tmp_path), device="cpu")
    first, meta = boosting.load_checkpoint(str(tmp_path))
    resumed = boosting.train(
        dataclasses.replace(p, num_iterations=20 - meta["iterations_done"]),
        x, y, init_model=first, device="cpu")
    assert resumed.num_trees == 20
    np.testing.assert_allclose(resumed.predict(x, device="cpu"),
                               full.predict(x, device="cpu"), rtol=1e-4,
                               atol=1e-5)


def test_kill_mid_fit_and_resume_to_equivalent_model(tmp_path):
    """A child process trains 400 iterations with a checkpoint every 3
    and is killed once one lands; the checkpoint resumes to the model of
    an uninterrupted run (tests/test_checkpoint.py:46)."""
    ckpt = str(tmp_path / "ck")
    data = str(tmp_path / "data.npz")
    x, ys = _rows(seed=6, n=500)
    y = ys["binary"]
    np.savez(data, x=x, y=y)
    code = f"""
import numpy as np
from synapseml_tpu_torch.gbdt.boosting import BoostParams, train
d = np.load({data!r})
train(BoostParams(num_iterations=400, num_leaves=7), d["x"], d["y"],
      checkpoint_dir={ckpt!r}, checkpoint_every=3, device="cpu")
"""
    env = dict(os.environ, PYTHONPATH=ROOT)
    child = subprocess.Popen([sys.executable, "-c", code], env=env,
                             stdout=subprocess.DEVNULL,
                             stderr=subprocess.DEVNULL)
    try:
        deadline = time.monotonic() + 240
        meta_path = os.path.join(ckpt, "checkpoint.json")
        while time.monotonic() < deadline:
            if os.path.exists(meta_path):
                with open(meta_path) as fh:
                    if json.load(fh)["iterations_done"] >= 3:
                        break
            if child.poll() is not None:
                pytest.fail("child exited before being killed")
            time.sleep(0.1)
        else:
            pytest.fail("no checkpoint appeared in time")
        child.send_signal(signal.SIGKILL)
        child.wait(timeout=30)
    finally:
        if child.poll() is None:
            child.kill()
            child.wait(timeout=30)
    booster, meta = boosting.load_checkpoint(ckpt)
    done = meta["iterations_done"]
    assert booster.num_trees == done and done % 3 == 0 and done < 400
    target = done + 10
    resumed = boosting.train(boosting.BoostParams(num_iterations=10,
                                                  num_leaves=7), x, y,
                             init_model=booster, device="cpu")
    full = boosting.train(boosting.BoostParams(num_iterations=target,
                                               num_leaves=7), x, y,
                          device="cpu")
    assert resumed.num_trees == target
    np.testing.assert_allclose(resumed.predict(x, device="cpu"),
                               full.predict(x, device="cpu"), rtol=1e-4,
                               atol=1e-5)

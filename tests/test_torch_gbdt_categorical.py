"""Training with categorical features in the PyTorch port against the JAX
package, on the CPU.

The reference has no categorical split search: ``BinMapper`` bins a
categorical column by category id in order of value (unseen and NaN
categories in the missing bin, at most ``max_cat`` categories, the most
frequent kept), the split thresholds are the category values, and the
trees split those bins like numeric ones; a row is routed at prediction
by its value against the threshold. The port passes
``categorical_features`` to its own copy of ``BinMapper`` and trains as it
does on numeric columns.

The same seeded numpy inputs go through the JAX reference and through the
port with ``device="cpu"``. Fits are held as ``tests/test_torch_gbdt_train.py``
holds them: tree structure, thresholds and per-node row counts identical,
leaf values and margins within 1e-5 (JAX's CPU sums and ``exp`` round
differently from PyTorch's, so a near-tied split could flip; the seeds
below have none). Native text round trips are bitwise: the same numpy
writer and parser on the same trees.
"""
import os
import sys

import numpy as np
import pytest

from synapseml_tpu.data.table import Table as JTable
from synapseml_tpu.gbdt import binning as jbinning
from synapseml_tpu.gbdt import boosting as jboosting
from synapseml_tpu.gbdt import estimators as jestimators

from synapseml_tpu_torch.data.table import Table
from synapseml_tpu_torch.gbdt import binning, boosting, estimators

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "tests", "fixtures"))
import make_lgbm_adult_cat_fixture as cat_fixture  # noqa: E402

MARGIN_TOL = 1e-5
CAT = (1, 3)


def _rows(seed=0, n=2000, wide_cat=False):
    """Seeded rows: numeric columns 0, 2, 4 (5% NaN); categorical columns
    1 (6 categories) and 3 (12, 3% NaN); with ``wide_cat`` column 3 holds
    300 categories of skewed frequency, more than ``max_cat``."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, 5))
    x[rng.random((n, 5)) < 0.05] = np.nan
    x[:, 1] = rng.integers(0, 6, n)
    x[:, 3] = (np.minimum(rng.zipf(1.3, n), 300) - 1 if wide_cat
               else rng.integers(0, 12, n))
    x[rng.random(n) < 0.03, 3] = np.nan
    eff1, eff3 = rng.normal(size=6), rng.normal(size=300)
    t = (np.nan_to_num(x[:, 0]) + eff1[x[:, 1].astype(int)]
         + eff3[np.nan_to_num(x[:, 3]).astype(int)]
         + rng.normal(scale=0.3, size=n))
    yc = np.searchsorted(np.quantile(t, [1 / 3, 2 / 3]), t)
    return x, {"binary": (t > np.median(t)).astype(np.float64),
               "regression": t, "multiclass": yc.astype(np.float64)}


def _query(seed=9, n=300):
    """Rows for prediction: NaN and categories unseen in training (12 to
    20, and -1) in the categorical columns."""
    x, _ = _rows(seed, n)
    x[::7, 3] = 12 + np.arange(len(x[::7, 3])) % 9
    x[::11, 1] = -1
    x[::13, 1] = np.nan
    return x


def _assert_boosters_match(jb, tb, x):
    assert tb.num_trees == jb.num_trees and tb.num_class == jb.num_class
    for name in ("trees_feature", "trees_threshold", "trees_left",
                 "trees_right", "trees_cover"):
        np.testing.assert_array_equal(getattr(tb, name), getattr(jb, name),
                                      name)
    np.testing.assert_allclose(tb.trees_value, jb.trees_value, rtol=0,
                               atol=MARGIN_TOL)
    assert tb.init_score == jb.init_score
    np.testing.assert_allclose(tb.predict_raw(x, device="cpu"),
                               jb.predict_raw(x), rtol=0, atol=MARGIN_TOL)


_CASES = {
    "binary": (dict(objective="binary"), "binary", False),
    "l2": (dict(objective="regression"), "regression", False),
    "multiclass_3": (dict(objective="multiclass", num_class=3,
                          num_iterations=5), "multiclass", False),
    "more_than_max_cat": (dict(objective="regression"), "regression", True),
}


@pytest.mark.parametrize("case", sorted(_CASES))
def test_categorical_train_matches_jax(case):
    """10 iterations of 15 leaves (5 for 3 classes) on 2,000 rows: trees
    identical, leaf values and margins within 1e-5, on query rows with NaN
    and unseen categories; the categorical splits' thresholds are category
    values."""
    kw, label, wide = _CASES[case]
    kw = {"num_iterations": 10, "num_leaves": 15,
          "categorical_features": CAT, **kw}
    x, ys = _rows(seed=1, wide_cat=wide)
    jb = jboosting.train(jboosting.BoostParams(**kw), x, ys[label])
    tb = boosting.train(boosting.BoostParams(**kw), x, ys[label],
                        device="cpu")
    _assert_boosters_match(jb, tb, _query())
    cat_nodes = np.isin(tb.trees_feature, CAT)
    assert cat_nodes.any()
    thr = tb.trees_threshold[cat_nodes]
    np.testing.assert_array_equal(thr, np.round(thr))


def test_more_than_max_cat_keeps_the_most_frequent():
    """300 categories of skewed frequency against ``max_cat``: both
    packages keep the most frequent ``max_cat`` and bin the rest with the
    missing values."""
    x, _ = _rows(seed=1, wide_cat=True)
    jm = jbinning.BinMapper(categorical_features=CAT, max_cat=40).fit(x)
    tm = binning.BinMapper(categorical_features=CAT, max_cat=40).fit(x)
    np.testing.assert_array_equal(tm.bins_[3].categories,
                                  jm.bins_[3].categories)
    assert tm.bins_[3].n_bins == 40
    values, counts = np.unique(x[:, 3][np.isfinite(x[:, 3])],
                               return_counts=True)
    kept_counts = np.isin(values, tm.bins_[3].categories)
    assert counts[kept_counts].min() >= counts[~kept_counts].max()
    binned = tm.transform(x)
    np.testing.assert_array_equal(binned, jm.transform(x))
    kept = np.isin(x[:, 3], tm.bins_[3].categories)
    assert (binned[~kept, 3] == tm.missing_bin(3)).all()
    assert (binned[kept, 3] < tm.missing_bin(3)).all()


def test_estimator_categorical_slot_indexes_match_jax():
    """``categorical_slot_indexes`` reaches ``train``: fit and transform
    of both classifiers, probabilities within 1e-5, the same
    predictions."""
    x, ys = _rows(seed=2)
    kw = dict(num_iterations=8, num_leaves=7,
              categorical_slot_indexes=list(CAT))
    jm = jestimators.LightGBMClassifier(**kw).fit(
        JTable({"features": x, "label": ys["binary"]}))
    tm = estimators.LightGBMClassifier(**kw).fit(
        Table({"features": x, "label": ys["binary"]}), device="cpu")
    assert tm.booster.params.categorical_features == CAT
    _assert_boosters_match(jm.booster, tm.booster, _query())
    q = _query(seed=10)
    want = jm.transform(JTable({"features": q}))
    got = tm.transform(Table({"features": q}), device="cpu")
    np.testing.assert_array_equal(got["prediction"], want["prediction"])
    np.testing.assert_allclose(got["probability"], want["probability"],
                               rtol=0, atol=MARGIN_TOL)


def test_categorical_models_round_trip_through_native_text(tmp_path):
    """A categorical model written in LightGBM's text format by either
    package loads in the other with ``categorical_feature`` in its
    parameters and scores the same, bitwise, NaN and unseen categories
    included."""
    x, ys = _rows(seed=3)
    kw = dict(num_iterations=6, num_leaves=7,
              categorical_slot_indexes=list(CAT))
    jm = jestimators.LightGBMClassifier(**kw).fit(
        JTable({"features": x, "label": ys["binary"]}))
    tm = estimators.LightGBMClassifier(**kw).fit(
        Table({"features": x, "label": ys["binary"]}), device="cpu")
    jpath, tpath = str(tmp_path / "j.txt"), str(tmp_path / "t.txt")
    jm.save_native_model(jpath)
    tm.save_native_model(tpath)
    q = _query(seed=11)
    port_of_jax = estimators.LightGBMClassificationModel.load_native_model(
        jpath).booster
    jax_of_port = jestimators.LightGBMClassificationModel.load_native_model(
        tpath).booster
    assert port_of_jax.params.categorical_features == CAT
    assert tuple(jax_of_port.params.categorical_features) == CAT
    np.testing.assert_array_equal(
        port_of_jax.predict_raw(q, device="cpu"),
        jestimators.LightGBMClassificationModel.load_native_model(
            jpath).booster.predict_raw(q))
    np.testing.assert_array_equal(
        jax_of_port.predict_raw(q),
        estimators.LightGBMClassificationModel.load_native_model(
            tpath).booster.predict_raw(q, device="cpu"))
    np.testing.assert_allclose(port_of_jax.predict_raw(q, device="cpu"),
                               jax_of_port.predict_raw(q), rtol=0,
                               atol=MARGIN_TOL)


def test_categorical_adult_fixture_first_ten_trees_reproduced():
    """The port's 10-iteration CPU fit of the categorical Adult rows
    (32,561 x 14, 8 categorical columns, 2% NaN occupation) reproduces the
    first 10 trees of the JAX-trained 100-iteration fixture: structure and
    thresholds identical (both through the native text round trip, which
    folds the init score into the first tree), leaf values within 1e-5;
    and the fixture scores its query rows (unseen categories and NaN among
    them) in the port as the JAX package recorded, bitwise.
    ``chip_smoke.py`` fits all 100 iterations on the card."""
    with open(cat_fixture.MODEL) as fh:
        fixture = boosting.Booster.load_string(fh.read())
    io = np.load(cat_fixture.IO)
    np.testing.assert_array_equal(
        fixture.predict_raw(io["x"], device="cpu"), io["raw"])
    np.testing.assert_allclose(fixture.predict(io["x"], device="cpu"),
                               io["prob"], rtol=0, atol=1e-7)
    x, y = cat_fixture.adult_cat_rows()
    kw = dict(cat_fixture.PARAMS, num_iterations=10)
    model = estimators.LightGBMClassifier(**kw).fit(
        Table({"features": x, "label": y}), device="cpu")
    port = boosting.Booster.load_string(model.booster.save_string())
    for name in ("trees_feature", "trees_threshold", "trees_left",
                 "trees_right"):
        np.testing.assert_array_equal(getattr(port, name),
                                      getattr(fixture, name)[:10], name)
    np.testing.assert_allclose(port.trees_value, fixture.trees_value[:10],
                               rtol=0, atol=MARGIN_TOL)

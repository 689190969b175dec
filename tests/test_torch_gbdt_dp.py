"""Data-parallel GBDT training in the port against the JAX package's mesh
fits, on the CPU: every boosting mode and objective of the reference's
mesh path at W=2, and W=3 with uneven padding.

The port runs in W gloo worker processes (``tests/torch_dp_worker.py``):
``boosting.train(..., mesh=group, device="cpu")``, every rank given the
same rows. One launch runs every case of a W (a module fixture), with a
timeout that kills the workers. The oracle is the JAX package in this
process: ``train(..., mesh=Mesh(devices[:W], ("dp",)))`` on the CPU
devices of ``tests/conftest.py``.

Tolerances. Trees identical (features, thresholds, children, covers, tree
weights), leaf values and margins within 1e-5 absolute, both ranks'
boosters bitwise equal. At W=2 the reference's psum is ``h0 + h1`` and
the port's rank-ordered sum the same, and K1's plain version is bitwise
the reference's ``segment_sum``, so only the reference's CPU rounding
orders (its ``cumsum`` over bins, its reductions, its ``exp``) part the
two fits, by a few float32 roundings, as in the single-device tests
(``tests/test_torch_gbdt_train.py``). At W=3 XLA's association of the
psum is not known; the same bounds hold on the seeds chosen. Seeds avoid
near-ties between two splits, which such roundings could flip. The JAX
package's own mesh tests allow 1e-4 and more
(``tests/test_gbdt.py:185-395``); nothing here is looser.
"""
import json
import os
import sys

import jax
import numpy as np
import pytest
from jax.sharding import Mesh

from synapseml_tpu.gbdt import boosting as jboosting

from synapseml_tpu_torch.convert import booster_from_arrays

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from torch_dp_worker import run_ranks  # noqa: E402

MARGIN_TOL = 1e-5
_BASE = dict(num_iterations=10, num_leaves=15)


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


def _queries(seed=0, nq=24, f=6, lo=5, hi=45):
    """Ranking rows: ``nq`` queries of ``lo`` to ``hi`` documents in
    shuffled order, graded labels 0-4."""
    rng = np.random.default_rng(seed)
    group = np.repeat(np.arange(nq), rng.integers(lo, hi, size=nq))
    group = group[rng.permutation(len(group))]
    x = rng.normal(size=(len(group), f))
    t = x[:, 0] + 0.5 * x[:, 1] + rng.normal(scale=0.5, size=len(group))
    return x, np.clip(np.floor(t + 2), 0, 4), group


def _data(name):
    if name == "rank":
        x, y, g = _queries()
        return dict(x=x, y=y, group=g)
    if name == "classes3":   # the regression target cut at its terciles
        x, ys = _rows(1)
        t = ys["regression"]
        return dict(x=x, y=np.digitize(t, np.quantile(t, [1 / 3, 2 / 3]))
                    .astype(np.float64))
    label, seed = {"binary": ("binary", 0), "regression": ("regression", 1),
                   "multiclass": ("multiclass", 11)}[name]
    x, ys = _rows(seed)
    return dict(x=x, y=ys[label])


# name: (BoostParams kwargs, data, extra train arguments)
_CASES = {
    "binary": (dict(objective="binary"), "binary", {}),
    "multiclass": (dict(objective="multiclass", num_class=3,
                        num_iterations=5), "multiclass", {}),
    "l2_weighted": (dict(objective="regression"), "regression",
                    dict(weighted=True)),
    "goss": (dict(objective="binary", boosting_type="goss"), "binary", {}),
    "bagging_feature_fraction": (dict(
        objective="binary", bagging_fraction=0.8, bagging_freq=1,
        feature_fraction=0.8, bagging_seed=3), "binary", {}),
    "pos_neg_bagging": (dict(objective="binary", pos_bagging_fraction=0.7,
                             neg_bagging_fraction=0.5, bagging_freq=1),
                        "binary", {}),
    # bagging_seed=None splits one leaf of tree 4 at gains 3.5920162 and
    # 3.5920048 (features 5 and 3), a near-tie the roundings flip
    "rf": (dict(objective="binary", boosting_type="rf", bagging_fraction=0.7,
                bagging_freq=1, feature_fraction=0.8, bagging_seed=1),
           "binary", {}),
    "dart": (dict(objective="binary", boosting_type="dart", drop_rate=0.5,
                  skip_drop=0.0), "binary", {}),
    # 63 bins and 8 leaves: at 255 bins and 15 leaves, small leaves hold
    # empty bins between thresholds that split their rows alike, which the
    # reference's float32 prefix sums tell apart (ROADMAP.md Queue 3)
    "dart_multiclass": (dict(objective="multiclass", num_class=3,
                             boosting_type="dart", drop_rate=0.3,
                             skip_drop=0.2, num_iterations=6, max_bin=63,
                             num_leaves=8), "classes3", {}),
    "l1_renewal": (dict(objective="regression_l1"), "regression", {}),
    "quantile_renewal": (dict(objective="quantile", alpha=0.3),
                         "regression", {}),
    "lambdarank": (dict(objective="lambdarank", min_data_in_leaf=5), "rank",
                   {}),
    "lambdarank_weighted": (dict(objective="lambdarank", min_data_in_leaf=5),
                            "rank", dict(weighted=True)),
    "rank_xendcg": (dict(objective="rank_xendcg", min_data_in_leaf=5),
                    "rank", {}),
    "dart_lambdarank": (dict(objective="lambdarank", boosting_type="dart",
                             drop_rate=0.5, skip_drop=0.0,
                             min_data_in_leaf=5), "rank", {}),
}


def _train_kw(case):
    pkw, data, extra = _CASES[case]
    kw = dict(_data(data), p={**_BASE, **pkw})
    if extra.get("weighted"):
        kw["weight"] = np.random.default_rng(5).random(len(kw["y"])) + 0.5
    return kw


def _early_stopping_kw():
    x, ys = _rows(2)
    y = ys["binary"]
    return dict(x=x[:1500], y=y[:1500], valid_sets=[(x[1500:], y[1500:])],
                p=dict(objective="binary", num_iterations=60, num_leaves=15,
                       learning_rate=0.3, early_stopping_round=5))


def _lr_kw():
    x, ys = _rows(3)
    return dict(x=x, y=ys["regression"],
                p=dict(objective="regression", num_iterations=8,
                       num_leaves=7),
                learning_rates=np.linspace(0.3, 0.05, 8).astype(np.float32))


def _first_jax_booster():
    x, ys = _rows(4)
    return jboosting.train(jboosting.BoostParams(
        objective="binary", num_iterations=4, num_leaves=7), x, ys["binary"])


def _init_model_kw():
    x, ys = _rows(4)
    return dict(x=x, y=ys["binary"],
                p=dict(objective="binary", num_iterations=4, num_leaves=7))


def _checkpoint_kw(iterations):
    x, ys = _rows(6, n=600)
    return dict(x=x, y=ys["binary"],
                p=dict(objective="binary", num_iterations=iterations,
                       num_leaves=7))


def _mesh(w):
    return Mesh(np.asarray(jax.devices()[:w]), ("dp",))


def _jax_train(kw, w, **extra):
    kw = dict(kw)
    p = jboosting.BoostParams(**kw.pop("p"))
    return jboosting.train(p, kw.pop("x"), kw.pop("y"), mesh=_mesh(w), **kw,
                           **extra)


def _cases2():
    cases = [{"name": c, "kind": "train", "kw": _train_kw(c)}
             for c in _CASES]
    cases += [
        {"name": "early_stopping", "kind": "train",
         "kw": dict(_early_stopping_kw(), hook=True)},
        {"name": "learning_rates", "kind": "train",
         "kw": dict(_lr_kw(), hook=True)},
        {"name": "init_model", "kind": "train",
         "kw": dict(_init_model_kw(), init_model=booster_from_arrays(
             _first_jax_booster().to_dict()))},
        {"name": "checkpoint", "kind": "train",
         "kw": dict(_checkpoint_kw(6), checkpoint=True, checkpoint_every=4,
                    hook=True)},
        {"name": "resume", "kind": "train",
         "kw": dict(_checkpoint_kw(4), init_from_checkpoint="checkpoint")},
        {"name": "uninterrupted", "kind": "train",
         "kw": _checkpoint_kw(10)},
    ]
    cases += [{"name": c, "kind": "train", "kw": _voting_kw(c)}
              for c in _VOTING]
    cases.append({"name": "adult_dp2_10", "kind": "train",
                  "kw": _adult_dp2_kw(10)})
    return cases


_FIXTURES = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                         "fixtures")


def _adult_dp2_kw(iterations):
    """The dp=2 Adult fixture's rows and BoostParams
    (``tests/fixtures/make_lgbm_adult_dp2_fixture.py``)."""
    sys.path.insert(0, _FIXTURES)
    from make_lgbm_adult_fixture import adult_rows
    io = np.load(os.path.join(_FIXTURES, "lgbm_adult_100x31_dp2_io.npz"))
    p = json.loads(str(io["params"]))
    p["categorical_features"] = tuple(p["categorical_features"])
    x, y = adult_rows()
    return dict(x=x, y=y.astype(np.float64),
                p=dict(p, num_iterations=iterations))


# the reference's voting test (tests/test_gbdt.py:758-813) on 2,000 rows
# with label noise: its 600 noiseless rows leave pure leaves, whose split
# gains (~1e-5) are rounding noise. The deep case's leaves hold fewer than
# 2 x 30 rows on a rank, so their ranks vote by unconstrained gains
# (counted once: most splits of its trees); at min_data_in_leaf=40 one
# such election parts from the reference's at tree 0's last split, where
# those gains are float32 prefix sums there and float64 ones here
_VOTING = {
    "data_parallel": {},
    "top_k_8": dict(tree_learner="voting_parallel", voting_top_k=8),
    "top_k_2": dict(tree_learner="voting_parallel", voting_top_k=2),
    "deep_top_k_2": dict(tree_learner="voting_parallel", voting_top_k=2,
                         num_leaves=31, min_data_in_leaf=30,
                         num_iterations=4),
}


def _voting_kw(case):
    rng = np.random.default_rng(11)
    x = rng.normal(size=(2000, 8))
    y = (x[:, 0] + 0.8 * x[:, 3] - 0.5 * x[:, 6]
         + rng.normal(scale=1.0, size=2000) > 0).astype(np.float64)
    return dict(x=x, y=y, p={"objective": "binary", "num_iterations": 8,
                             "num_leaves": 7, **_VOTING[case]})


@pytest.fixture(scope="module")
def dp2(tmp_path_factory):
    """Every W=2 case in one launch of two gloo ranks."""
    return run_ranks(str(tmp_path_factory.mktemp("dp2")), 2, _cases2(),
                     timeout=400)


def _fits(res, name):
    """Both ranks' results of ``name``; their boosters bitwise equal."""
    outs = [r[name] for r in res]
    for out in outs:
        assert "error" not in out, out["error"]
    boosters = [o["cpu"]["booster"] for o in outs]
    for b in boosters[1:]:
        for field in ("trees_feature", "trees_threshold", "trees_left",
                      "trees_right", "trees_value", "trees_cover",
                      "tree_weights"):
            a, c = getattr(boosters[0], field), getattr(b, field)
            assert a.tobytes() == c.tobytes(), field
        assert b.init_score == boosters[0].init_score
        assert b.eval_history == boosters[0].eval_history
    return [o["cpu"] for o in outs]


def _assert_match(jb, tb, x, tol=MARGIN_TOL):
    assert tb.num_trees == jb.num_trees and tb.num_class == jb.num_class
    for name in ("trees_feature", "trees_threshold", "trees_left",
                 "trees_right", "trees_cover", "tree_weights"):
        np.testing.assert_array_equal(getattr(tb, name), getattr(jb, name),
                                      name)
    np.testing.assert_allclose(tb.trees_value, jb.trees_value, rtol=0,
                               atol=tol)
    assert tb.init_score == jb.init_score
    assert tb.best_iteration == jb.best_iteration
    np.testing.assert_allclose(tb.predict_raw(x, device="cpu"),
                               jb.predict_raw(x), rtol=0, atol=tol)


@pytest.mark.parametrize("case", list(_CASES))
def test_mesh_fit_matches_jax_at_two_ranks(dp2, case):
    """Each mode and objective of the reference's mesh path, 10
    iterations of 15 leaves (multiclass: 5; 3-class dart: 6 of 8) on 2,000 x 6
    rows with NaNs or 24 queries of 5-44 documents: trees identical,
    leaf values and margins within 1e-5. goss takes the global threshold,
    bagging and rf each rank's ``fold_in(key, rank)`` rows, dart the
    float32 schedule (tree weights equal), lambdarank, rank_xendcg and
    lambdarank-dart the dense gradient on group-aligned shards, L1 and
    quantile the gathered residuals."""
    kw = _train_kw(case)
    fit = _fits(dp2, case)[0]
    jb = _jax_train(kw, 2)
    _assert_match(jb, fit["booster"], kw["x"][:300])
    if kw["p"].get("boosting_type") == "dart":
        assert not np.allclose(fit["booster"].tree_weights, 1.0)
    assert fit["collective_calls"] > 0 and fit["k1_launches"] == 0


def test_rank_xendcg_takes_the_lambdarank_gradient_on_the_mesh(dp2):
    """The reference's mesh path trains rank_xendcg with the LambdaRank
    gradient (its boosting.py:2012-2016); the port keeps that parity."""
    a = _fits(dp2, "rank_xendcg")[0]["booster"]
    b = _fits(dp2, "lambdarank")[0]["booster"]
    for name in ("trees_feature", "trees_threshold", "trees_value"):
        np.testing.assert_array_equal(getattr(a, name), getattr(b, name))


def test_reductions_per_tree(dp2):
    """data_parallel reduces one histogram a leaf grown: the root and the
    right child of each split, nothing else in a plain gbdt fit."""
    fit = _fits(dp2, "binary")[0]
    b = fit["booster"]
    splits = int((b.trees_feature >= 0).sum())
    assert fit["collective_calls"] == b.num_trees + splits


def test_early_stopping_matches_jax(dp2):
    """A replicated validation set: the same metric history (1e-6
    relative), best_iteration and kept trees on both ranks and in JAX;
    the iteration hook fires where the reference's chunks end and where
    it stops."""
    kw = _early_stopping_kw()
    fit = _fits(dp2, "early_stopping")[0]
    seen = []
    jb = _jax_train(kw, 2, iteration_hook=seen.append)
    tb = fit["booster"]
    assert 0 <= jb.best_iteration < 59
    np.testing.assert_allclose(tb.eval_history["binary_logloss"],
                               jb.eval_history["binary_logloss"], rtol=1e-6)
    _assert_match(jb, tb, kw["valid_sets"][0][0])
    assert fit["hook"] == seen


def test_learning_rates_and_hook_match_jax(dp2):
    kw = _lr_kw()
    fit = _fits(dp2, "learning_rates")[0]
    seen = []
    jb = _jax_train(kw, 2, iteration_hook=seen.append)
    _assert_match(jb, fit["booster"], kw["x"][:200])
    assert fit["hook"] == seen == [8]


def test_init_model_continues_as_in_jax(dp2):
    """init_model: a JAX booster carried over by booster_from_arrays; the
    mesh fit continues from its margins on every rank."""
    kw = _init_model_kw()
    jb = _jax_train(kw, 2, init_model=_first_jax_booster())
    tb = _fits(dp2, "init_model")[0]["booster"]
    assert tb.num_trees == 8
    _assert_match(jb, tb, kw["x"][:300])


def test_checkpoint_and_resume(dp2):
    """Rank 0 writes checkpoints where the reference's chunks end (every
    4 iterations and the last); the checkpoint holds the fit; resuming
    from it for 4 more gives the uninterrupted 10-iteration fit's trees
    (margins within 1e-5: the resumed run restarts from the summed
    margins), and JAX's resumed mesh fit."""
    ck = _fits(dp2, "checkpoint")
    assert ck[0]["hook"] == [4, 6]
    first, meta = ck[0]["checkpoint"]
    assert meta["iterations_done"] == 6 and meta["total_iterations"] == 6
    kw = _checkpoint_kw(10)
    # LightGBM's text format numbers the nodes its own way and rounds
    # the scores' last bits: compare scores within the tolerance
    np.testing.assert_allclose(
        first.predict_raw(kw["x"], device="cpu"),
        ck[0]["booster"].predict_raw(kw["x"], device="cpu"), rtol=0,
        atol=MARGIN_TOL)
    resumed = _fits(dp2, "resume")[0]["booster"]
    full = _fits(dp2, "uninterrupted")[0]["booster"]
    assert resumed.num_trees == full.num_trees == 10
    for name in ("trees_feature", "trees_threshold"):
        np.testing.assert_array_equal(getattr(resumed, name)[6:],
                                      getattr(full, name)[6:])
    np.testing.assert_allclose(resumed.predict_raw(kw["x"], device="cpu"),
                               full.predict_raw(kw["x"], device="cpu"),
                               rtol=0, atol=MARGIN_TOL)
    jfirst = _jax_train(_checkpoint_kw(6), 2)
    jres = _jax_train(_checkpoint_kw(4), 2, init_model=jfirst)
    for name in ("trees_feature", "trees_threshold", "trees_cover"):
        np.testing.assert_array_equal(getattr(resumed, name)[6:],
                                      getattr(jres, name)[6:])
    np.testing.assert_allclose(resumed.predict_raw(kw["x"], device="cpu"),
                               jres.predict_raw(kw["x"]), rtol=0,
                               atol=MARGIN_TOL)


# -- voting_parallel ---------------------------------------------------------

def test_voting_with_top_k_of_every_feature_grows_data_parallel_trees(dp2):
    """top_k >= F elects every feature: data_parallel's trees; leaf
    values differ in the last bits only (totals are sums of local sums,
    not of reduced histograms), as in the reference's test. Also JAX's
    voting fit, trees identical and margins within 1e-5."""
    vote = _fits(dp2, "top_k_8")[0]["booster"]
    full = _fits(dp2, "data_parallel")[0]["booster"]
    x = _voting_kw("top_k_8")["x"]
    for name in ("trees_feature", "trees_threshold", "trees_left"):
        np.testing.assert_array_equal(getattr(vote, name),
                                      getattr(full, name))
    np.testing.assert_allclose(vote.predict_raw(x, device="cpu"),
                               full.predict_raw(x, device="cpu"), rtol=0,
                               atol=MARGIN_TOL)
    _assert_match(_jax_train(_voting_kw("top_k_8"), 2), vote, x)


@pytest.mark.parametrize("case", ["top_k_2", "deep_top_k_2"])
def test_voting_elects_the_reference_features(dp2, case):
    """top_k=2: the restricted election changes the trees (against
    data_parallel) and matches JAX's elected trees; ``deep_top_k_2`` is
    the reference's deep-leaf case, where per-rank leaf rows fall below
    min_data_in_leaf and the ranks vote by their unconstrained gains.
    Each split reduces the right child's totals, the votes and the
    elected histograms of both children: three collectives."""
    kw = _voting_kw(case)
    fit = _fits(dp2, case)[0]
    tb = fit["booster"]
    _assert_match(_jax_train(kw, 2), tb, kw["x"])
    splits = int((tb.trees_feature >= 0).sum())
    assert fit["collective_calls"] == 3 * (tb.num_trees + splits)
    if case == "top_k_2":
        full = _fits(dp2, "data_parallel")[0]["booster"]
        assert not np.array_equal(tb.trees_feature, full.trees_feature)


def test_adult_dp2_fixture_first_ten_trees_reproduced(dp2):
    """The first 10 of the 100 trees of the JAX package's 2-device Adult
    fit (the fixture ``chip_smoke.py`` holds the card's fit to) from a
    10-iteration fit of two CPU ranks: identical after the text format's
    round trip, as the fixture was written."""
    from synapseml_tpu_torch.gbdt.boosting import Booster
    with open(os.path.join(_FIXTURES, "lgbm_adult_100x31_dp2.txt")) as fh:
        fixture = Booster.load_string(fh.read())
    fit = _fits(dp2, "adult_dp2_10")[0]
    got = Booster.load_string(fit["booster"].save_string())
    assert fixture.num_trees == 100 and got.num_trees == 10
    for name in ("trees_feature", "trees_threshold", "trees_left"):
        np.testing.assert_array_equal(getattr(got, name),
                                      getattr(fixture, name)[:10])
    np.testing.assert_allclose(got.trees_value, fixture.trees_value[:10],
                               rtol=0, atol=MARGIN_TOL)


# -- W=3: uneven padding -----------------------------------------------------

_CASES3 = {
    # 2,000 rows: one pad row on the last rank
    "binary": (dict(objective="binary"), "binary", {}),
    "l2_weighted": (dict(objective="regression"), "regression",
                    dict(weighted=True)),
    "lambdarank": (dict(objective="lambdarank", min_data_in_leaf=5), "rank",
                   {}),
}


@pytest.fixture(scope="module")
def dp3(tmp_path_factory):
    cases = []
    for c in _CASES3:
        pkw, data, extra = _CASES3[c]
        kw = dict(_data(data), p={**_BASE, **pkw})
        if extra.get("weighted"):
            kw["weight"] = np.random.default_rng(5).random(len(kw["y"])) + .5
        cases.append({"name": c, "kind": "train", "kw": kw})
    return run_ranks(str(tmp_path_factory.mktemp("dp3")), 3, cases,
                     timeout=300)


@pytest.mark.parametrize("case", list(_CASES3))
def test_mesh_fit_matches_jax_at_three_ranks(dp3, case):
    """W=3 with uneven padding (a pad row, or ragged query packing): trees
    identical on these seeds, leaf values and margins within 1e-5, the
    three ranks' boosters bitwise equal."""
    pkw, data, extra = _CASES3[case]
    kw = dict(_data(data), p={**_BASE, **pkw})
    if extra.get("weighted"):
        kw["weight"] = np.random.default_rng(5).random(len(kw["y"])) + 0.5
    fit = _fits(dp3, case)[0]
    _assert_match(_jax_train(kw, 3), fit["booster"], kw["x"][:300])

"""Ranking in the PyTorch port against the JAX package, on the CPU: the
LambdaRank gradients (dense and block-diagonal), the query layout, the
NDCG metric, ``train`` with a ``group`` (lambdarank, rank_xendcg, weights,
goss, bagging, rf, early stopping on a grouped validation set,
continuation, the dense form), and ``LightGBMRanker``.

The same seeded numpy inputs go through the JAX reference and through the
port with ``device="cpu"`` (kernel K1 runs only on the card; there its
plain version runs). Tolerances, stated before any seed was chosen:

- **Gradients.** Both packages form each pair term in float32 with the
  same operations in the same order; the port evaluates sigmoid and
  log2 in float64 and rounds them, which may differ from XLA's float32
  functions by an ulp (about eight roundings a term in all). The
  reference then sums a row's n terms (n = G in the blocked form, N in
  the dense one) in float32 in XLA's order; the port sums them in float64
  and rounds once. So a row's gradient agrees within ``(n + 8) * eps32``
  times the sum of the absolute values of its terms ``sigma * s *
  delta`` (the worst case of a float32 sum of n terms, plus the terms'
  roundings). The hessian's terms ``sigma^2 * s * (1 - s) * delta`` take
  ``1 - s`` of a float32 ``s``, whose error is ``eps32`` absolute, not
  relative, so its bound uses the sum of ``sigma^2 * s * delta``.
- **Layout and NDCG.** ``build_query_blocks`` and the NDCG functions are
  the same numpy code on the same input: exactly equal.
- **Fits.** As ``tests/test_torch_gbdt_train.py`` holds them: tree
  structure, thresholds and per-node row counts identical, leaf values
  and margins within 1e-5. Two near-ties can break either way between
  the packages: the gradients' rounding gaps reach the split gains (and
  the reference's float32 prefix sums can break a tie between two
  thresholds that split a leaf's rows alike, with empty bins between
  them), and two documents of one query whose margins differ by a
  rounding can swap ranks (seen: -0.3146236 twice in JAX against
  -0.31462404 and -0.31462362 in the port, which moved a leaf value by
  5e-5 one tree later). The fits below use seeds where neither happens.
  The NDCG history of early stopping is within 1e-6 (the same ranking in
  every query).
"""
import dataclasses
import inspect
import os
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from synapseml_tpu.data.table import Table as JTable
from synapseml_tpu.gbdt import boosting as jboosting
from synapseml_tpu.gbdt import estimators as jestimators
from synapseml_tpu.gbdt import objectives as jobj

from synapseml_tpu_torch.convert import booster_from_arrays
from synapseml_tpu_torch.data.table import Table
from synapseml_tpu_torch.gbdt import boosting, estimators, kernels, objectives

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "tests", "fixtures"))
import make_lgbm_rank_fixture as rank_fixture  # noqa: E402

EPS32 = 2.0 ** -24
MARGIN_TOL = 1e-5


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _queries(seed=0, nq=20, f=8, lo=5, hi=60, nan_frac=0.05):
    """Seeded ranking rows: ``nq`` queries of ``lo`` to ``hi`` documents,
    graded labels 0-4 from a noisy score of two features."""
    rng = np.random.default_rng(seed)
    sizes = rng.integers(lo, hi, size=nq)
    group = np.repeat(np.arange(nq), sizes)
    x = rng.normal(size=(len(group), f))
    x[rng.random(x.shape) < nan_frac] = np.nan
    t = (np.nan_to_num(x[:, 0]) + 0.5 * np.nan_to_num(x[:, 1])
         + rng.normal(scale=0.5, size=len(group)))
    y = np.clip(np.floor(t + 2), 0, 4)
    return x, y, group


# -- gradients ---------------------------------------------------------------

def _bound(abs_sum, n_terms):
    """The gradient tolerance of the module docstring."""
    return (n_terms + 8) * EPS32 * abs_sum + 1e-30


def _abs_term_sums(p, lab, group, max_pos, sigma=2.0):
    """Per row, the sums of ``sigma * s * delta`` (the gradient's |pair
    terms|) and of ``sigma^2 * s * delta`` (the hessian's, with ``1 - s``
    bounded by 1), float64 numpy, ranks by stable sort within each
    group."""
    p = p.astype(np.float64)
    lab = lab.astype(np.float64)
    ranks = np.zeros(len(p), np.int64)
    for g in np.unique(group):
        rows = np.nonzero(group == g)[0]
        ranks[rows[np.argsort(-p[rows], kind="stable")]] = np.arange(len(rows))
    disc = 1.0 / np.log2(2.0 + np.minimum(ranks, max_pos))
    gain = 2.0 ** lab - 1.0
    pair = (group[:, None] == group[None, :]) & (lab[:, None] != lab[None, :])
    delta = np.abs((gain[:, None] - gain[None, :])
                   * (disc[:, None] - disc[None, :])) * pair
    s = 1.0 / (1.0 + np.exp(sigma * (p[:, None] - p[None, :])))
    s = np.where(lab[:, None] > lab[None, :], s, 1.0 - s)
    return (sigma * s * delta).sum(1), (sigma * sigma * s * delta).sum(1)


def _grad_case(case):
    rng = np.random.default_rng(len(case))
    sizes = {"ties": [30, 25, 40], "all_equal_margins": [12, 33, 7],
             "pads": [3, 50, 17, 8, 41], "one_document_queries": [1, 1, 20,
                                                                  1, 9],
             "equal_labels": [15, 20, 10], "past_max_position": [80, 120],
             "unsorted_groups": [20, 30, 25]}[case]
    group = np.repeat(np.arange(len(sizes)), sizes)
    n = len(group)
    lab = rng.integers(0, 5, n).astype(np.float32)
    p = rng.normal(size=n).astype(np.float32)
    if case == "ties":
        p = np.round(p * 2) / 2                      # many equal margins
    if case == "all_equal_margins":
        p[:] = 0.0
    if case == "equal_labels":
        lab[:15] = 2.0                               # query 0: one label
        lab[35:] = 0.0                               # query 2: all zero
    if case == "unsorted_groups":
        group = rng.permutation(group)
    max_pos = 10 if case == "past_max_position" else 30
    return p.astype(np.float32), lab, group, max_pos


_GRAD_CASES = ["ties", "all_equal_margins", "pads", "one_document_queries",
               "equal_labels", "past_max_position", "unsorted_groups"]


@pytest.mark.parametrize("case", _GRAD_CASES)
def test_lambdarank_grad_matches_jax(case, monkeypatch):
    """Dense and blocked forms of both packages, within ``(N + 8) eps32``
    of each row's absolute term sum (module docstring; N terms a row in
    the reference's dense form); the port's forms in small chunks (three
    rows' pairs a chunk) equal each other within one rounding."""
    p, lab, group, max_pos = _grad_case(case)
    monkeypatch.setattr(objectives, "_PAIR_CHUNK", 3 * len(p))
    want = jobj.lambdarank_grad(jnp.asarray(p), jnp.asarray(lab),
                                jnp.asarray(group, jnp.int32),
                                max_dcg_pos=max_pos)
    layout = jobj.build_query_blocks(group)
    want_blocked = jobj.lambdarank_grad_blocked(
        jnp.asarray(p), jnp.asarray(lab), *(jnp.asarray(a) for a in layout),
        max_dcg_pos=max_pos)
    dense = objectives.lambdarank_grad(_t(p), _t(lab), _t(group),
                                       max_dcg_pos=max_pos)
    blocked = objectives.lambdarank_grad_blocked(
        _t(p), _t(lab), *(_t(a) for a in objectives.build_query_blocks(group)),
        max_dcg_pos=max_pos)
    abs_sums = _abs_term_sums(p, lab, group, max_pos)
    for got in (dense, blocked):
        assert got[0].dtype == got[1].dtype == torch.float32
        for want_form in (want, want_blocked):
            # the clamp max(h, 1e-6) moves no two values further apart
            for w, g, a in zip(want_form, got, abs_sums):
                np.testing.assert_array_less(
                    np.abs(g.numpy().astype(np.float64) - np.asarray(w)),
                    _bound(a, len(p)))
    for d, b, a in zip(dense, blocked, abs_sums):
        np.testing.assert_array_less(
            np.abs(d.numpy().astype(np.float64) - b.numpy()),
            4 * EPS32 * a + 1e-30)
    assert float(blocked[1].min()) >= np.float32(1e-6)


@pytest.mark.parametrize("budget", [60 * 60 * 3, 60 * 17, 1])
def test_lambdarank_grad_blocked_chunks_are_bitwise(budget, monkeypatch):
    """The blocked form's pair terms in chunks of ``budget`` (whole query
    blocks a chunk; rows of the one wide 60-document query a chunk where
    its block alone is larger) give the same bits as one batch, and hold
    JAX's blocked form within the bound of the test above."""
    rng = np.random.default_rng(7)
    sizes = np.r_[rng.integers(1, 12, size=20), 60]
    group = rng.permutation(np.repeat(np.arange(len(sizes)), sizes))
    p = rng.normal(size=len(group)).astype(np.float32)
    lab = rng.integers(0, 5, size=len(group)).astype(np.float32)
    layout = objectives.build_query_blocks(group)
    args = (_t(p), _t(lab), *(_t(a) for a in layout))
    whole = objectives.lambdarank_grad_blocked(*args)
    monkeypatch.setattr(objectives, "_PAIR_CHUNK", budget)
    chunked = objectives.lambdarank_grad_blocked(*args)
    for w, c in zip(whole, chunked):
        assert torch.equal(w, c)
    want = jobj.lambdarank_grad_blocked(
        jnp.asarray(p), jnp.asarray(lab),
        *(jnp.asarray(a) for a in jobj.build_query_blocks(group)))
    for w, c, a in zip(want, chunked, _abs_term_sums(p, lab, group, 30)):
        np.testing.assert_array_less(
            np.abs(c.numpy().astype(np.float64) - np.asarray(w)),
            _bound(a, len(p)))


def test_ranks_at_all_equal_margins_match_jax():
    """Iteration 0: every margin equals the init score, so each query is
    one tie and the ranks come from the tie rule. Both forms rank ties in
    row order, as the reference's stable argsort does; pads sort last."""
    group = np.array([2, 0, 2, 1, 0, 2, 2, 1, 0, 0, 2])
    p = np.zeros(len(group), np.float32)
    same = jnp.asarray(group)[:, None] == jnp.asarray(group)[None, :]
    order = jnp.argsort(jnp.where(same, -jnp.asarray(p)[None, :], jnp.inf),
                        axis=-1)
    want = np.asarray(jnp.argsort(order, axis=-1).diagonal())
    got = objectives._group_ranks(_t(p), _t(group)).numpy()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, [0, 0, 1, 0, 1, 2, 3, 1, 2, 3, 4])
    # the blocked form's ranks: per block, in block order
    qidx, qmask, _ = objectives.build_query_blocks(group)
    key = torch.where(_t(qmask), -_t(p)[_t(qidx).long()], torch.inf)
    ranks = torch.argsort(torch.argsort(key, dim=-1, stable=True), dim=-1)
    np.testing.assert_array_equal(ranks.numpy()[qmask], got[qidx[qmask]])
    assert (ranks.numpy()[~qmask] >= qmask.sum(1).repeat(
        (~qmask).sum(1))).all()


@pytest.mark.parametrize("group", [
    [0, 0, 1, 1, 1, 2],
    [5, 3, 5, 3, 9, 9, 9, 3],                 # unsorted, sparse ids
    [0] * 50 + list(range(1, 40)),            # one large query: skew
    [7] * 4,
    [],
])
def test_build_query_blocks_matches_jax(group):
    group = np.asarray(group, np.int64)
    want = jobj.build_query_blocks(group)
    got = objectives.build_query_blocks(group)
    for w, g in zip(want, got):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("skew", [False, True])
def test_rank_objective_picks_the_reference_form(weighted, skew,
                                                 monkeypatch):
    """``_rank_objective`` takes the blocked form unless the reference's
    rule (``q*gmax^2 <= n^2 and q*gmax <= 8n``) sends it to the dense
    one, and multiplies by the weight after the hessian's clamp."""
    rng = np.random.default_rng(3)
    sizes = [300] + [2] * 60 if skew else [20] * 15
    group = np.repeat(np.arange(len(sizes)), sizes)
    n = len(group)
    p = rng.normal(size=n).astype(np.float32)
    lab = rng.integers(0, 5, n).astype(np.float32)
    w = rng.random(n).astype(np.float32) if weighted else None
    calls = []
    for name in ("lambdarank_grad", "lambdarank_grad_blocked"):
        fn = getattr(objectives, name)
        monkeypatch.setattr(objectives, name,
                            lambda *a, _fn=fn, _n=name, **k: (
                                calls.append(_n), _fn(*a, **k))[1])
    rank_obj = boosting._rank_objective(boosting.BoostParams(
        objective="lambdarank"), group, n, torch.device("cpu"))
    g, h = rank_obj(_t(p), _t(lab), None if w is None else _t(w))
    assert calls == ["lambdarank_grad" if skew else "lambdarank_grad_blocked"]
    jfn = (jobj.lambdarank_grad(jnp.asarray(p), jnp.asarray(lab),
                                jnp.asarray(group, jnp.int32)) if skew
           else jobj.lambdarank_grad_blocked(
               jnp.asarray(p), jnp.asarray(lab),
               *(jnp.asarray(a) for a in jobj.build_query_blocks(group))))
    jg, jh = (np.asarray(a) for a in jfn)
    if w is not None:
        jg, jh = jg * w, jh * w
    # the weight's product adds one rounding of the result
    scale = 1.0 if w is None else w
    for got, want_, a in zip((g, h), (jg, jh),
                             _abs_term_sums(p, lab, group, 30)):
        np.testing.assert_array_less(
            np.abs(got.numpy().astype(np.float64) - want_),
            _bound(a, n) * scale + 2 * EPS32 * np.abs(want_))


# -- NDCG ----------------------------------------------------------------------

@pytest.mark.parametrize("case", ["blocked", "skew_loop", "ties",
                                  "zero_gain_queries", "given_blocks"])
def test_ndcg_matches_jax_exactly(case):
    rng = np.random.default_rng(len(case))
    sizes = [300] + [2] * 60 if case == "skew_loop" else list(
        rng.integers(1, 40, 25))
    group = np.repeat(np.arange(len(sizes)), sizes)
    if case != "skew_loop":
        group = rng.permutation(group)
    n = len(group)
    scores = rng.normal(size=n).astype(np.float32)
    labels = rng.integers(0, 5, n).astype(np.float32)
    if case == "ties":
        scores = np.round(scores)
    if case == "zero_gain_queries":
        labels[group < 10] = 0.0
    blocks = (objectives.build_query_blocks(group)
              if case == "given_blocks" else None)
    for at in (1, 5, 30):
        want = jboosting._ndcg_score(scores, labels, group, at, blocks=blocks)
        got = boosting._ndcg_score(scores, labels, group, at, blocks=blocks)
        assert got == want
        assert (boosting._ndcg_score_loop(scores, labels, group, at)
                == jboosting._ndcg_score_loop(scores, labels, group, at))


# -- train ---------------------------------------------------------------------

def _assert_boosters_match(jb, tb, x, margin_tol=MARGIN_TOL):
    assert tb.num_trees == jb.num_trees and tb.num_class == jb.num_class
    for name in ("trees_feature", "trees_threshold", "trees_left",
                 "trees_right", "trees_cover", "tree_weights"):
        np.testing.assert_array_equal(getattr(tb, name), getattr(jb, name),
                                      name)
    np.testing.assert_allclose(tb.trees_value, jb.trees_value, rtol=0,
                               atol=margin_tol)
    assert tb.init_score == jb.init_score
    assert tb.best_iteration == jb.best_iteration
    np.testing.assert_allclose(tb.predict_raw(x, device="cpu"),
                               jb.predict_raw(x), rtol=0, atol=margin_tol)


_RANK_CASES = {
    "lambdarank": {},
    "rank_xendcg": dict(objective="rank_xendcg"),
    "max_position_5": dict(max_position=5),
    # data seed 0 splits one leaf alike at two thresholds (empty bins
    # between them) at tree 9, which the reference's float32 prefix sums
    # tell apart
    "weighted": dict(weighted=True, data_seed=1),
    "goss": dict(boosting_type="goss"),
    # data seed 0 has the rank swap of the module docstring at tree 6
    "bagging_feature_fraction": dict(bagging_fraction=0.7, bagging_freq=1,
                                     feature_fraction=0.75, data_seed=1),
    "rf": dict(boosting_type="rf", bagging_fraction=0.7, bagging_freq=1),
    "dense_skewed": dict(skew=True),
}


@pytest.mark.parametrize("case", sorted(_RANK_CASES))
def test_rank_train_matches_jax(case):
    """10 iterations of 15 leaves on ~600 rows of 20 queries (seeded,
    NaNs included): trees identical; leaf values and margins within 1e-5.
    ``dense_skewed`` puts one query of 400 documents among 60 of two, so
    both packages take the dense ``[N, N]`` form."""
    kw = dict(_RANK_CASES[case])
    weighted, skew = kw.pop("weighted", False), kw.pop("skew", False)
    data_seed = kw.pop("data_seed", 0)
    kw = {"objective": "lambdarank", "num_iterations": 10, "num_leaves": 15,
          **kw}
    if skew:
        x, y, group = _queries(seed=1, nq=61, lo=2, hi=3)
        big = _queries(seed=2, nq=1, lo=400, hi=401)
        x, y = np.concatenate([big[0], x]), np.concatenate([big[1], y])
        group = np.concatenate([big[2], group + 1])
        q, gmax = objectives.build_query_blocks(group)[0].shape
        assert q * gmax * gmax > len(group) ** 2        # the dense form
    else:
        x, y, group = _queries(seed=data_seed)
    w = (np.random.default_rng(5).random(len(y)) + 0.5
         if weighted else None)
    jb = jboosting.train(jboosting.BoostParams(**kw), x, y, w, group)
    before = (kernels.histogram.launches, kernels.forest_traverse.launches)
    tb = boosting.train(boosting.BoostParams(**kw), x, y, w, group,
                        device="cpu")
    assert (kernels.histogram.launches,
            kernels.forest_traverse.launches) == before == (0, 0)
    _assert_boosters_match(jb, tb, _queries(seed=9, nq=5)[0])


def test_rank_early_stopping_on_a_grouped_validation_set_matches_jax():
    """A ``(x, y, group)`` validation set: the NDCG@max_position history
    (within 1e-6) and best_iteration of the reference."""
    x, y, group = _queries(seed=4, nq=30)
    vx, vy, vg = _queries(seed=5, nq=12)
    kw = dict(objective="lambdarank", num_iterations=40, num_leaves=15,
              learning_rate=0.3, early_stopping_round=4, max_position=10)
    valid = [(vx, vy, vg)]
    jb = jboosting.train(jboosting.BoostParams(**kw), x, y, None, group,
                         valid_sets=valid)
    tb = boosting.train(boosting.BoostParams(**kw), x, y, None, group,
                        valid_sets=valid, device="cpu")
    assert 0 <= jb.best_iteration < 39
    assert len(jb.eval_history["ndcg"]) < 40
    np.testing.assert_allclose(tb.eval_history["ndcg"],
                               jb.eval_history["ndcg"], rtol=1e-6, atol=0)
    _assert_boosters_match(jb, tb, vx)


def test_rank_checkpoint_chunks_bound_the_margin_snapshots():
    """The reference's rank chunks hold at most 4M validation margins of
    snapshots; a checkpointing fit writes where they end."""
    p = boosting.BoostParams(objective="lambdarank", num_iterations=50,
                             early_stopping_round=30)
    tracker = boosting._ValidTracker(
        p, 1, 0.0, [(np.zeros((400_000, 2)), np.zeros(400_000),
                     np.arange(400_000) // 100)], torch.device("cpu"))
    assert tracker.enabled and tracker.ndcg_blocks is not None
    assert boosting._checkpoint_every(p, tracker, 0) == 10
    jp = jboosting.BoostParams(**dataclasses.asdict(p))
    jtracker = jboosting._ValidTracker(
        jp, 1, 0.0, [(np.zeros((400_000, 2)), np.zeros(400_000),
                      np.arange(400_000) // 100)])
    assert jboosting._compute_chunk(jp, jtracker, True, 50, 400_000) == 10


def test_rank_train_continues_from_a_jax_booster():
    """init_model: a JAX-trained ranker carried over by
    booster_from_arrays; the port continues boosting from its margins,
    tracking NDCG on a grouped validation set from the combined stack."""
    x, y, group = _queries(seed=6)
    vx, vy, vg = _queries(seed=7, nq=8)
    kw = dict(objective="lambdarank", num_leaves=7, num_iterations=4)
    first = jboosting.train(jboosting.BoostParams(**kw), x, y, None, group)
    jb = jboosting.train(jboosting.BoostParams(**kw), x, y, None, group,
                         valid_sets=[(vx, vy, vg)], init_model=first)
    tb = boosting.train(boosting.BoostParams(**kw), x, y, None, group,
                        valid_sets=[(vx, vy, vg)],
                        init_model=booster_from_arrays(first.to_dict()),
                        device="cpu")
    assert tb.num_trees == 2 * first.num_trees
    np.testing.assert_allclose(tb.eval_history["ndcg"],
                               jb.eval_history["ndcg"], rtol=1e-6, atol=0)
    _assert_boosters_match(jb, tb, vx)


def test_rank_train_takes_group_in_the_reference_position():
    """``train(p, x, y, weight, group, valid_sets, ...)`` as in the
    reference: a call that passes ``group`` (or ``valid_sets``) by
    position reaches the same argument in both packages."""
    jparams = list(inspect.signature(jboosting.train).parameters)
    params = list(inspect.signature(boosting.train).parameters)
    assert params == jparams + ["device"]
    x, y, group = _queries(seed=8, nq=10)
    p = boosting.BoostParams(objective="lambdarank", num_iterations=3,
                             num_leaves=7)
    by_position = boosting.train(p, x, y, None, group, device="cpu")
    by_keyword = boosting.train(p, x, y, group=group, device="cpu")
    jb = jboosting.train(jboosting.BoostParams(**dataclasses.asdict(p)), x,
                         y, None, group)
    _assert_boosters_match(jb, by_position, x)
    np.testing.assert_array_equal(by_position.trees_value,
                                  by_keyword.trees_value)


def test_validation_triples_are_taken_for_every_objective():
    """The tracker takes ``(x, y, group)`` triples as the reference does
    (the group is read only by the rank metric): a regression fit with a
    triple early-stops as with the pair."""
    rng = np.random.default_rng(2)
    x = rng.normal(size=(800, 5))
    y = 2 * x[:, 0] + x[:, 1] ** 2 + rng.normal(scale=0.3, size=800)
    kw = dict(objective="regression", num_iterations=60, num_leaves=7,
              learning_rate=0.5, early_stopping_round=3)
    triple = [(x[600:], y[600:], np.arange(200) // 10)]
    jb = jboosting.train(jboosting.BoostParams(**kw), x[:600], y[:600],
                         valid_sets=triple)
    tb = boosting.train(boosting.BoostParams(**kw), x[:600], y[:600],
                        valid_sets=triple, device="cpu")
    pair = boosting.train(boosting.BoostParams(**kw), x[:600], y[:600],
                          valid_sets=[triple[0][:2]], device="cpu")
    assert 0 <= jb.best_iteration < 59
    np.testing.assert_allclose(tb.eval_history["rmse"],
                               jb.eval_history["rmse"], rtol=1e-6)
    _assert_boosters_match(jb, tb, x[600:])
    assert tb.eval_history == pair.eval_history
    assert tb.best_iteration == pair.best_iteration


def test_rank_metric_needs_a_group_as_in_jax():
    """Without a group on the first validation set the ndcg tracker is
    off in both packages: no history, no early stop."""
    x, y, group = _queries(seed=3, nq=10)
    kw = dict(objective="lambdarank", num_iterations=6, num_leaves=7,
              early_stopping_round=2)
    jb = jboosting.train(jboosting.BoostParams(**kw), x, y, None, group,
                         valid_sets=[(x, y)])
    tb = boosting.train(boosting.BoostParams(**kw), x, y, None, group,
                        valid_sets=[(x, y)], device="cpu")
    assert tb.eval_history == jb.eval_history == {"ndcg": []}
    assert tb.best_iteration == jb.best_iteration == -1


def test_rank_guards_raise_as_in_jax():
    """No group: ValueError in both. dart: the reference fails with a
    TypeError (its dart loop calls the objective function, None for
    ranking); the port refuses the combination with a ValueError."""
    x, y, group = _queries(seed=3, nq=6)
    p = dict(objective="lambdarank", num_iterations=2)
    with pytest.raises(ValueError, match="group"):
        jboosting.train(jboosting.BoostParams(**p), x, y)
    with pytest.raises(ValueError, match="group"):
        boosting.train(boosting.BoostParams(**p), x, y, device="cpu")
    for objective in ("lambdarank", "rank_xendcg"):
        d = dict(p, objective=objective, boosting_type="dart")
        with pytest.raises(TypeError):
            jboosting.train(jboosting.BoostParams(**d), x, y, None, group)
        with pytest.raises(ValueError, match=f"dart.*{objective}"):
            boosting.train(boosting.BoostParams(**d), x, y, None, group,
                           device="cpu")


# -- the estimator -----------------------------------------------------------

def _rank_table(seed, shuffle=True):
    x, y, group = _queries(seed=seed, nq=25)
    order = (np.random.default_rng(seed).permutation(len(y)) if shuffle
             else np.arange(len(y)))
    # query ids far apart and out of order: the estimator sorts by them
    return {"features": x[order], "label": y[order],
            "query": (group[order] * 7919) % 1000}


def test_ranker_fit_transform_matches_jax():
    """Rows in no order of query: both estimators sort them (stably) by
    the query column and train on dense query ids; the same trees and
    predictions within 1e-5."""
    cols = _rank_table(seed=10)
    kw = dict(num_iterations=8, num_leaves=7, max_position=20)
    jm = jestimators.LightGBMRanker(**kw).fit(JTable(cols))
    tm = estimators.LightGBMRanker(**kw).fit(Table(cols), device="cpu")
    assert tm.booster.params.max_position == 20
    assert (dataclasses.asdict(tm.booster.params)
            == dataclasses.asdict(jm.booster.params))
    for name in ("objective", "group_col", "max_position", "evaluate_at"):
        assert (getattr(estimators.LightGBMRanker(), name)
                == getattr(jestimators.LightGBMRanker(), name))
    _assert_boosters_match(jm.booster, tm.booster, cols["features"])
    q = _rank_table(seed=11)
    want = jm.transform(JTable(q))["prediction"]
    got = estimators.LightGBMRankerModel(booster=tm.booster).transform(
        Table(q), device="cpu")["prediction"]
    np.testing.assert_allclose(got, want, rtol=0, atol=MARGIN_TOL)


def test_ranker_validation_column_and_batches_match_jax():
    """validation_indicator_col with early stopping on NDCG of the
    validation rows' own queries, and num_batches threading the booster
    through two batches."""
    cols = _rank_table(seed=12)
    cols["valid"] = (cols["query"] % 5) == 0
    kw = dict(num_iterations=30, num_leaves=7, learning_rate=0.3,
              early_stopping_round=3, validation_indicator_col="valid",
              max_position=10)
    jm = jestimators.LightGBMRanker(**kw).fit(JTable(cols))
    tm = estimators.LightGBMRanker(**kw).fit(Table(cols), device="cpu")
    assert 0 <= jm.booster.best_iteration < 29
    np.testing.assert_allclose(tm.booster.eval_history["ndcg"],
                               jm.booster.eval_history["ndcg"], rtol=1e-6)
    _assert_boosters_match(jm.booster, tm.booster, cols["features"])
    kw = dict(num_iterations=5, num_leaves=7, num_batches=2)
    jm = jestimators.LightGBMRanker(**kw).fit(JTable(_rank_table(13)))
    tm = estimators.LightGBMRanker(**kw).fit(Table(_rank_table(13)),
                                             device="cpu")
    _assert_boosters_match(jm.booster, tm.booster, cols["features"])


def test_ranker_native_models_load_in_either_package(tmp_path):
    """A ranker written in LightGBM's text format by either package loads
    in the other as ``objective=lambdarank`` and predicts the same margins
    (bitwise: the same numpy writer and the same trees)."""
    cols = _rank_table(seed=14)
    kw = dict(num_iterations=6, num_leaves=7)
    jm = jestimators.LightGBMRanker(**kw).fit(JTable(cols))
    tm = estimators.LightGBMRanker(**kw).fit(Table(cols), device="cpu")
    x = cols["features"]
    jpath, tpath = str(tmp_path / "j.txt"), str(tmp_path / "t.txt")
    jm.save_native_model(jpath)
    tm.save_native_model(tpath)
    port_of_jax = estimators.LightGBMRankerModel.load_native_model(jpath)
    jax_of_port = jestimators.LightGBMRankerModel.load_native_model(tpath)
    for model in (port_of_jax.booster, jax_of_port.booster):
        assert model.params.objective == "lambdarank"
    assert "objective=lambdarank" in open(tpath).read()
    np.testing.assert_array_equal(
        port_of_jax.booster.predict_raw(x, device="cpu"),
        jestimators.LightGBMRankerModel.load_native_model(
            jpath).booster.predict_raw(x))
    np.testing.assert_array_equal(
        jax_of_port.booster.predict_raw(x),
        estimators.LightGBMRankerModel.load_native_model(
            tpath).booster.predict_raw(x, device="cpu"))
    np.testing.assert_allclose(
        port_of_jax.booster.predict_raw(x, device="cpu"),
        jax_of_port.booster.predict_raw(x), rtol=0, atol=MARGIN_TOL)


def test_ranker_fit_raises_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    x, y, group = _queries(seed=3, nq=5)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        estimators.LightGBMRanker(num_iterations=2).fit(
            Table({"features": x, "label": y, "query": group}))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        boosting.train(boosting.BoostParams(objective="lambdarank"), x, y,
                       None, group)


# -- the JAX-trained fixture ---------------------------------------------------

def test_ranker_fixture_first_ten_trees_reproduced():
    """The port's 10-iteration CPU fit of the fixture's rows (300
    MSLR-width queries, 36,666 x 136) reproduces the first 10 trees of
    the JAX-trained 100-iteration fixture: structure and thresholds
    identical (both through the native text round trip), leaf values
    within 1e-5. ``chip_smoke.py`` fits all 100 iterations on the card."""
    with open(rank_fixture.MODEL) as fh:
        fixture = boosting.Booster.load_string(fh.read())
    x, y, group = rank_fixture.rank_rows(seed=rank_fixture.SEED)
    assert x.shape == (36_666, 136) and fixture.num_trees == 100
    kw = dict(rank_fixture.PARAMS, num_iterations=10)
    model = estimators.LightGBMRanker(**kw).fit(
        Table({"features": x, "label": y, "query": group}), device="cpu")
    port = boosting.Booster.load_string(model.booster.save_string())
    for name in ("trees_feature", "trees_threshold", "trees_left",
                 "trees_right"):
        np.testing.assert_array_equal(getattr(port, name),
                                      getattr(fixture, name)[:10], name)
    np.testing.assert_allclose(port.trees_value, fixture.trees_value[:10],
                               rtol=0, atol=MARGIN_TOL)

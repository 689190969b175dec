"""The port's data-parallel building blocks against the JAX package.

- The row layout helpers (``_pack_queries``, ``_layout_shards``,
  ``_layout_rows``) against the reference's: pure numpy, bitwise.
- The collectives (``synapseml_tpu_torch.parallel.collectives``) in three
  gloo worker processes on the CPU (``tests/torch_dp_worker.py``): the
  ordered sum is bitwise ``(x0 + x1) + x2`` on every rank, the max and the
  tiled gather exact, the ragged row gather exact to the bit for float64
  (-0.0, NaN, inf, subnormals) and int64.
- ``grower.best_split_voting`` on two gloo ranks against the reference's
  under ``shard_map`` on a 2-device CPU mesh, from the same local
  histograms.
- ``voting_parallel`` without a mesh trains as data_parallel in both
  packages.
- The per-leaf quantile of L1 and quantile renewal against
  ``jnp.nanquantile``.

Every worker launch has a timeout and kills its workers when it runs out.
"""
import dataclasses
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh
from jax.sharding import PartitionSpec as P

from synapseml_tpu.gbdt import boosting as jboosting
from synapseml_tpu.gbdt import grower as jgrower
from synapseml_tpu.parallel.distributed import shard_map

from synapseml_tpu_torch.gbdt import boosting, grower
from synapseml_tpu_torch.parallel import collectives

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from torch_dp_worker import run_ranks  # noqa: E402


def _groups(seed, sizes):
    """Query ids for queries of ``sizes`` rows, shuffled, ids not
    contiguous and some negative."""
    rng = np.random.default_rng(seed)
    ids = rng.permutation(len(sizes)) * 3 - 5
    g = np.repeat(ids, sizes)
    return g[rng.permutation(len(g))]


_QUERY_CASES = {
    "ragged_2": ([5, 1, 9, 3, 3, 7, 2], 2),
    "ragged_3": ([4, 4, 1, 12, 2, 2, 6, 1], 3),
    "more_shards_than_queries": ([3, 2], 4),
    "one_query": ([11], 3),
}


@pytest.mark.parametrize("case", sorted(_QUERY_CASES))
def test_pack_queries_matches_jax(case):
    sizes, shards = _QUERY_CASES[case]
    g = _groups(len(sizes), sizes)
    want = jboosting._pack_queries(g, shards)
    got = boosting._pack_queries(g, shards)
    assert len(got[0]) == shards
    for a, b in zip(got[0], want[0]):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(got[1], want[1])
    np.testing.assert_array_equal(got[2], want[2])


def test_pack_queries_of_an_empty_rank():
    got = boosting._pack_queries(np.zeros(0, np.int64), 3)
    want = jboosting._pack_queries(np.zeros(0, np.int64), 3)
    assert [len(a) for a in got[0]] == [len(a) for a in want[0]] == [0] * 3
    np.testing.assert_array_equal(got[2], want[2])


@pytest.mark.parametrize("case", sorted(_QUERY_CASES))
@pytest.mark.parametrize("neg_base", [0, 40])
def test_layout_shards_matches_jax(case, neg_base):
    """Pads at bin ``bdev - 1`` with unique negative query ids."""
    sizes, shards = _QUERY_CASES[case]
    g = _groups(len(sizes), sizes)
    n = len(g)
    rng = np.random.default_rng(n)
    binned = rng.integers(0, 30, (n, 4)).astype(np.uint8)
    y = rng.random(n).astype(np.float32)
    w = rng.random(n)
    margins = rng.normal(size=(n, 3)).astype(np.float32)
    idx, dense, loads = jboosting._pack_queries(g, shards)
    per = int(loads.max())
    want = jboosting._layout_shards(idx, dense, per, binned, y, w, margins,
                                    31, neg_base=neg_base)
    got = boosting._layout_shards(idx, dense, per, binned, y, w, margins,
                                  31, neg_base=neg_base)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
        assert a.dtype == b.dtype
    assert (got[0][~got[4]] == 30).all()
    pads = got[5][~got[4]]
    assert (pads < 0).all() and len(np.unique(pads)) == len(pads)


@pytest.mark.parametrize("is_rank", [False, True])
@pytest.mark.parametrize("shards", [1, 2, 3, 5])
def test_layout_rows_matches_jax(is_rank, shards):
    """Non-rank fits pad zero-bin rows at the end up to a multiple of the
    shards; rank fits pack queries (shard r is block r)."""
    n = 47
    rng = np.random.default_rng(shards)
    binned = rng.integers(0, 20, (n, 3)).astype(np.uint8)
    y = rng.random(n).astype(np.float32)
    w = rng.random(n)
    margins = rng.normal(size=(n, 1)).astype(np.float32)
    g = _groups(shards, [5, 9, 2, 13, 3, 1, 7, 7]) if is_rank else None
    want = jboosting._layout_rows(is_rank, shards, binned, y, w, margins, g,
                                  21)
    got = boosting._layout_rows(is_rank, shards, binned, y, w, margins, g, 21)
    assert got[-1] == want[-1] and got[-1] % shards == 0
    for a, b in zip(got[:-1], want[:-1]):
        if b is None:
            assert a is None
        else:
            np.testing.assert_array_equal(a, b)
            assert a.dtype == b.dtype
    if not is_rank:
        assert (got[0][n:] == 0).all() and not got[4][n:].any()


# -- collectives -------------------------------------------------------------

def _collective_inputs():
    rng = np.random.default_rng(0)
    # magnitudes apart, so that the association of the sum shows
    sums = [(rng.normal(size=(7, 5)) * 10.0 ** e).astype(np.float32)
            for e in (0, 7, -3)]
    sums[1][0, 0] = -sums[0][0, 0]
    f64 = [np.array([[-0.0, 1.0], [np.nan, -np.inf]]),
           np.zeros((0, 2)),
           np.array([[5e-324, -1e308], [np.pi, 0.0], [1.0, 2.0]])]
    i64 = [np.array([np.iinfo(np.int64).min, -1]), np.array([0]),
           np.array([np.iinfo(np.int64).max, 7, 9])]
    return sums, [f64, i64]


@pytest.fixture(scope="module")
def three_ranks(tmp_path_factory):
    """One launch of three gloo ranks for the collectives' tests."""
    sums, rows = _collective_inputs()
    return run_ranks(str(tmp_path_factory.mktemp("coll")), 3, [{
        "name": "c", "kind": "collectives",
        "kw": {"sum": sums, "rows": rows}}], timeout=120)


def test_ordered_sum_is_bitwise_the_rank_order_sum(three_ranks):
    sums, _ = _collective_inputs()
    res = three_ranks
    want = (sums[0] + sums[1]) + sums[2]
    other = sums[0] + (sums[1] + sums[2])
    assert not np.array_equal(want, other)  # the order is visible here
    for r, out in enumerate(res):
        c = out["c"]
        assert "error" not in c, c.get("error")
        assert c["size"] == 3 and c["index"] == r
        np.testing.assert_array_equal(c["sum"].view(np.int32),
                                      want.view(np.int32))
        np.testing.assert_array_equal(c["max"], np.maximum.reduce(sums))
        np.testing.assert_array_equal(c["gather"], np.concatenate(sums))


def test_ragged_row_gather_is_exact(three_ranks):
    _, rows = _collective_inputs()
    for out in three_ranks:
        for got, parts in zip(out["c"]["rows"], rows):
            want = np.concatenate(parts)
            assert got.dtype == want.dtype and got.shape == want.shape
            assert got.tobytes() == want.tobytes()   # -0.0 and NaN too


def test_group_must_be_a_process_group():
    with pytest.raises(ValueError, match="process group"):
        collectives.check_group(object())
    assert boosting.row_sharded_mesh_ok(None)
    assert not boosting.row_sharded_mesh_ok(object())


# -- voting ------------------------------------------------------------------

def _voting_inputs(seed, min_data):
    """Two shards' [2 leaves, F, B, 3] histograms (~64 rows a leaf on
    each) and the leaves' global totals. With two ranks voting for two
    features each, features often tie in votes."""
    rng = np.random.default_rng(seed)
    f, b = 8, 16
    hists = []
    for _ in range(2):
        cnt = rng.integers(0, 9, (2, f, b)).astype(np.float32)
        g = (rng.normal(size=(2, f, b)) * cnt).astype(np.float32)
        h = (0.25 * cnt).astype(np.float32)
        # every feature of a leaf sees the same rows
        cnt[:, 1:] = cnt[:, :1]
        h[:, 1:] = h[:, :1]
        g[:, 1:] = np.stack([rng.permutation(g[:, 0].T).T
                             for _ in range(f - 1)], 1)
        hists.append(np.stack([g, h, cnt], -1))
    tot = [h[:, 0].sum(1, dtype=np.float64).astype(np.float32)
           for h in hists]
    totals = tot[0] + tot[1]
    p = dict(num_leaves=7, max_bin=b, min_data_in_leaf=min_data,
             min_sum_hessian_in_leaf=1e-3, voting_top_k=2)
    return hists, totals, p


@pytest.mark.parametrize("seed,min_data", [(0, 5), (1, 5), (2, 40)],
                         ids=["seed0", "seed1", "local_limits_fail"])
def test_best_split_voting_matches_jax(tmp_path, seed, min_data):
    """The same elected features and split on both ranks as the
    reference's under shard_map; gains within 1e-6 relative (float32
    prefix sums add in another order). ``local_limits_fail``: no local
    candidate passes min_data_in_leaf, so the ranks vote by the
    unconstrained gains."""
    hists, totals, pkw = _voting_inputs(seed, min_data)
    tp = grower.GrowerParams(**pkw)
    local = [grower._split_gains(torch.from_numpy(h), torch.from_numpy(
        h[:, 0].sum(1, dtype=np.float64).astype(np.float32)), tp, True)
        for h in hists]
    global_ = grower._split_gains(torch.from_numpy(hists[0] + hists[1]),
                                  torch.from_numpy(totals), tp, True)
    assert bool(torch.isfinite(global_).any(-1).any(-1).all())
    assert bool(torch.isinf(torch.stack(local)).all()) == (min_data == 40)
    res = run_ranks(str(tmp_path), 2, [{
        "name": "v", "kind": "call",
        "fn": "synapseml_tpu_torch.gbdt.grower:best_split_voting",
        "args": [[h, totals, tp, True] for h in hists]}], timeout=120)
    jp = jgrower.GrowerParams(**pkw)
    mesh = Mesh(np.asarray(jax.devices()[:2]), ("dp",))

    def one(h, tot):
        return jgrower.best_split_voting(h[0], tot, jp, True, "dp")
    fn = jax.jit(shard_map(one, mesh=mesh, in_specs=(P("dp"), P()),
                           out_specs=(P(), P(), P()), check_vma=False))
    for leaf in range(2):
        jg, jf, jb = fn(jnp.asarray(np.stack([h[leaf] for h in hists])),
                        jnp.asarray(totals[leaf]))
        for out in res:
            gain, feat, b = out["v"]
            assert int(feat[leaf]) == int(jf) and int(b[leaf]) == int(jb)
            np.testing.assert_allclose(gain[leaf], float(jg), rtol=1e-6)
    assert np.array_equal(res[0]["v"][0], res[1]["v"][0])


def test_voting_parallel_without_a_mesh_is_data_parallel():
    """Without a group, voting_top_k is not read (reference grower.py:479):
    bitwise the data_parallel fit, in both packages."""
    rng = np.random.default_rng(11)
    x = rng.normal(size=(600, 8))
    y = (x[:, 0] + 0.8 * x[:, 3] - 0.5 * x[:, 6] > 0).astype(np.float64)
    kw = dict(objective="binary", num_iterations=5, num_leaves=7)
    vote = dict(kw, tree_learner="voting_parallel", voting_top_k=2)
    assert boosting.BoostParams(**vote).grower(10).voting_top_k == 2
    assert boosting.BoostParams(**kw).grower(10).voting_top_k == 0
    assert dataclasses.asdict(boosting.BoostParams(**vote).grower(10)) == {
        k: v for k, v in dataclasses.asdict(
            jboosting.BoostParams(**vote).grower()).items()} | {"max_bin": 10}
    tb = boosting.train(boosting.BoostParams(**vote), x, y, device="cpu")
    td = boosting.train(boosting.BoostParams(**kw), x, y, device="cpu")
    jv = jboosting.train(jboosting.BoostParams(**vote), x, y)
    jd = jboosting.train(jboosting.BoostParams(**kw), x, y)
    for name in ("trees_feature", "trees_threshold", "trees_value"):
        np.testing.assert_array_equal(getattr(tb, name), getattr(td, name))
        np.testing.assert_array_equal(getattr(jv, name), getattr(jd, name))
    np.testing.assert_array_equal(tb.trees_feature, jd.trees_feature)
    assert torch.equal(torch.from_numpy(tb.predict_raw(x, device="cpu")),
                       torch.from_numpy(td.predict_raw(x, device="cpu")))


@pytest.mark.parametrize("alpha", [0.5, 0.3, 0.9, 0.0, 1.0])
def test_leaf_quantiles_match_jax_nanquantile(alpha):
    """L1/quantile renewal's per-leaf quantile (one sort for all leaves)
    against ``jnp.nanquantile`` of each leaf's masked residuals, as the
    reference's mesh path takes it: within 1e-6 relative (XLA may fuse
    the interpolation into an FMA); NaN rows (pads) skipped, NaN for an
    empty leaf; ties included."""
    rng = np.random.default_rng(int(alpha * 10))
    for trial in range(15):
        n, leaves = int(rng.integers(1, 60)), int(rng.integers(1, 8))
        r = rng.normal(size=n).astype(np.float32)
        r[rng.random(n) < 0.1] = np.nan
        if trial % 3 == 0:
            r[: n // 2] = r[0]
        s = rng.integers(0, leaves, n).astype(np.int32)
        got = boosting._leaf_quantiles(torch.from_numpy(r),
                                       torch.from_numpy(s), leaves, alpha)
        want = [jnp.nanquantile(jnp.where(jnp.asarray(s) == k,
                                          jnp.asarray(r), jnp.nan), alpha)
                for k in range(leaves)]
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                                   atol=1e-7, equal_nan=True)
    empty = boosting._leaf_quantiles(torch.zeros(0),
                                     torch.zeros(0, dtype=torch.int32), 3,
                                     alpha)
    assert torch.isnan(empty).all() and empty.shape == (3,)

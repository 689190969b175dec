"""``boosting.train_row_sharded`` of the port, each gloo rank given only
its own rows, on the CPU.

- Against the port's own ``train(..., mesh=group)`` on all the rows:
  bitwise, where the rows are in rank order, their count is a multiple of
  W and within ``bin_sample_count`` (the bins and the layout are then the
  same; as ``tests/test_partitions.py:101-144`` holds for the reference).
  The init scores are equal too: the labels and integer weights make the
  rank-summed label sums exact.
- Against the JAX package's single-process ``train_row_sharded`` on a
  2-device CPU mesh: trees identical, margins within 1e-5 (the tolerance
  and its reasons are ``tests/test_torch_gbdt_dp.py``'s).
- The traffic accounting (``stats_out``) and the proportional bin sample.

All fits of a test file run in one launch of two worker processes
(``tests/torch_dp_worker.py``), with a timeout that kills them.
"""
import os
import sys

import jax
import numpy as np
import pytest
from jax.sharding import Mesh

from synapseml_tpu.gbdt import boosting as jboosting

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from torch_dp_worker import run_ranks  # noqa: E402

MARGIN_TOL = 1e-5
_N = 480


def _data():
    rng = np.random.default_rng(7)
    x = rng.normal(size=(_N, 6))
    w = rng.integers(1, 4, _N).astype(np.float64)
    s = x[:, 0] + x[:, 1]
    return x, w, {
        "binary": (s > 0).astype(np.float64),
        "multiclass": np.digitize(s, [-0.5, 0.5]).astype(np.float64),
        # integer targets: exact label sums on either side
        "regression": np.round(2 * x[:, 0] + x[:, 1]),
    }


# the reference's cases (tests/test_partitions.py:111-126)
_CASES = {
    "binary": (dict(objective="binary", num_iterations=6), "binary"),
    "multiclass": (dict(objective="multiclass", num_class=3,
                        num_iterations=4), "multiclass"),
    "quantile": (dict(objective="quantile", alpha=0.7, num_iterations=4),
                 "regression"),
    "goss": (dict(objective="regression", boosting_type="goss",
                  num_iterations=4), "regression"),
    "dart": (dict(objective="binary", boosting_type="dart", num_iterations=4,
                  drop_rate=0.5, skip_drop=0.0), "binary"),
}


def _params(case):
    pkw, label = _CASES[case]
    return {"num_leaves": 7, **pkw}, label


def _rank_data():
    rng = np.random.default_rng(8)
    n_q, per_q = 30, 8
    x = rng.normal(size=(n_q * per_q, 4))
    rel = (x[:, 0] + 0.3 * rng.normal(size=n_q * per_q) > 0.4).astype(float)
    return x, rel, np.repeat(np.arange(n_q), per_q)


_RANK_P = dict(objective="lambdarank", num_iterations=5, num_leaves=7,
               min_data_in_leaf=2)
_CAPPED_P = dict(objective="binary", num_iterations=3, num_leaves=7,
                 bin_sample_count=100)


def _halves(a):
    return None if a is None else [a[:len(a) // 2], a[len(a) // 2:]]


def _cases():
    x, w, ys = _data()
    out = []
    for case in _CASES:
        p, label = _params(case)
        out.append({"name": "rows_" + case, "kind": "row_sharded",
                    "kw": dict(p=p, x_parts=_halves(x),
                               y_parts=_halves(ys[label]),
                               weight_parts=_halves(w))})
        out.append({"name": "mesh_" + case, "kind": "train",
                    "kw": dict(p=p, x=x, y=ys[label], weight=w)})
    xr, rel, q = _rank_data()
    half = q < 15          # each rank holds whole queries
    out.append({"name": "rows_lambdarank", "kind": "row_sharded",
                "kw": dict(p=_RANK_P, x_parts=[xr[half], xr[~half]],
                           y_parts=[rel[half], rel[~half]],
                           group_parts=[q[half], q[~half]])})
    # uneven parts over a capped bin sample
    out.append({"name": "rows_capped", "kind": "row_sharded",
                "kw": dict(p=_CAPPED_P, x_parts=[x[:300], x[300:]],
                           y_parts=[ys["binary"][:300], ys["binary"][300:]])})
    return out


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    return run_ranks(str(tmp_path_factory.mktemp("rows")), 2, _cases(),
                     timeout=300)


def _fit(ranks, name):
    outs = [r[name] for r in ranks]
    for out in outs:
        assert "error" not in out, out["error"]
    a, b = (o["cpu"]["booster"] for o in outs)
    for f in ("trees_feature", "trees_threshold", "trees_value"):
        assert getattr(a, f).tobytes() == getattr(b, f).tobytes(), f
    return [o["cpu"] for o in outs]


def _jax_rows(p, x, y, **kw):
    return jboosting.train_row_sharded(
        jboosting.BoostParams(**p), x, y,
        mesh=Mesh(np.asarray(jax.devices()[:2]), ("dp",)), **kw)


@pytest.mark.parametrize("case", list(_CASES))
def test_row_sharded_is_bitwise_the_mesh_fit(ranks, case):
    """Each rank passes half the rows: bitwise the mesh fit of all of
    them, the init score included."""
    got = _fit(ranks, "rows_" + case)[0]["booster"]
    want = _fit(ranks, "mesh_" + case)[0]["booster"]
    for f in ("trees_feature", "trees_threshold", "trees_left",
              "trees_right", "trees_value", "trees_cover", "tree_weights"):
        assert getattr(got, f).tobytes() == getattr(want, f).tobytes(), f
    assert got.init_score == want.init_score
    x = _data()[0]
    np.testing.assert_array_equal(got.predict_raw(x, device="cpu"),
                                  want.predict_raw(x, device="cpu"))


@pytest.mark.parametrize("case", list(_CASES))
def test_row_sharded_matches_jax(ranks, case):
    """Against the reference's single-process ``train_row_sharded`` at
    dp=2 (its rows in the same layout): trees identical, margins within
    1e-5."""
    x, w, ys = _data()
    p, label = _params(case)
    jb = _jax_rows(p, x, ys[label], weight=w)
    tb = _fit(ranks, "rows_" + case)[0]["booster"]
    for f in ("trees_feature", "trees_threshold", "trees_cover",
              "tree_weights"):
        np.testing.assert_array_equal(getattr(tb, f), getattr(jb, f), f)
    assert tb.init_score == jb.init_score
    np.testing.assert_allclose(tb.predict_raw(x, device="cpu"),
                               jb.predict_raw(x), rtol=0, atol=MARGIN_TOL)


def test_row_sharded_ranker_matches_jax(ranks):
    """Each rank holds 15 whole queries and packs them on its own, where
    the reference's one process packs all 30 over its two devices: the
    same queries meet in other shards, so histograms add in another
    order; trees identical, margins within 1e-5."""
    xr, rel, q = _rank_data()
    jb = _jax_rows(_RANK_P, xr, rel, group=q)
    tb = _fit(ranks, "rows_lambdarank")[0]["booster"]
    np.testing.assert_array_equal(tb.trees_feature, jb.trees_feature)
    np.testing.assert_array_equal(tb.trees_threshold, jb.trees_threshold)
    np.testing.assert_allclose(tb.predict_raw(xr, device="cpu"),
                               jb.predict_raw(xr), rtol=0, atol=MARGIN_TOL)


def test_stats_out_accounts_the_traffic(ranks):
    """The reference's keys; 240 rows a rank, all sent as the bin sample
    (the job fits ``bin_sample_count``); this rank's binned block."""
    x, w, ys = _data()
    jstats = {}
    _jax_rows(_params("binary")[0], x, ys["binary"], weight=w,
              stats_out=jstats)
    fits = _fit(ranks, "rows_binary")
    for rank, fit in enumerate(fits):
        st = fit["stats_out"]
        assert set(st) == set(jstats)
        assert st["path"] == "row_sharded"
        assert (st["n_local"], st["n_total"], st["n_global"],
                st["per_host_rows"], st["n_features"]) == (240, 480, 480,
                                                          240, 6)
        assert st["binned_local_shape"] == (240, 6)
        assert st["sample_rows_sent"] == 240
        assert st["sample_rows_gathered"] == 480
        assert st["sample_gathered_bytes"] == 480 * 6 * 8
        assert st["addressable_row_bytes"] == 240 * 6


def test_capped_bin_sample_is_proportional(ranks):
    """300 and 180 rows against a budget of 100: each rank sends
    ``int(100 * n_local / 480)`` sampled rows; pads fill the smaller
    rank's block; both ranks grow the same trees."""
    fits = _fit(ranks, "rows_capped")
    sent = [f["stats_out"]["sample_rows_sent"] for f in fits]
    assert sent == [62, 37]
    assert all(f["stats_out"]["sample_rows_gathered"] == 99 for f in fits)
    assert all(f["stats_out"]["per_host_rows"] == 300 for f in fits)
    b = fits[0]["booster"]
    x, _, ys = _data()
    acc = ((b.predict(x, device="cpu") > 0.5) == ys["binary"]).mean()
    assert b.num_trees == 3 and acc > 0.8

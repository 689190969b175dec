"""The port's partition data plane (``synapseml_tpu_torch/data/
partitions.py``) against the JAX package's, on the CPU; the counterpart of
``tests/test_partitions.py``.

- One process: ``fit_partitions`` over dict, ``Table``, pandas and
  pyarrow batches is bitwise the port's ``train`` on the concatenated
  rows, and within ``tests/test_torch_gbdt_train.py``'s tolerance of the
  JAX package's ``fit_partitions`` (trees identical, margins within
  1e-5); the aggregator's checks give the reference's messages.
- A world of one: ``train_row_sharded`` in a process without a process
  group is bitwise ``train(..., mesh=<one-rank group>)``, over the
  reference's five cases and lambdarank (``tests/test_partitions.py:
  101-144``).
- Two gloo ranks formed by a ``DriverRendezvous`` on loopback and
  ``fit_partitions(rendezvous=...)``: the row-sharded fit is bitwise the
  port's ``train(mesh=)`` on all rows and within 1e-5 of the JAX
  package's ``train_row_sharded`` on a 2-device CPU mesh (a port rank is
  one device; a JAX process of ``test_partitions.py`` holds two, so the
  oracle is the 2-device mesh); an empty rank with ``weight_col``; the
  gather route with the ranker's per-rank query relabel; ``stats_out``
  on every route.

The worker processes (``tests/torch_dp_worker.py``) are launched once a
fixture, with a timeout that kills them.
"""
import os
import sys

import jax
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from synapseml_tpu.data import partitions as jpartitions
from synapseml_tpu.gbdt import boosting as jboosting
from synapseml_tpu_torch.data.partitions import (PartitionAggregator,
                                                 fit_aggregated,
                                                 fit_partitions)
from synapseml_tpu_torch.data.table import Table
from synapseml_tpu_torch.gbdt.boosting import (BoostParams, train,
                                               train_row_sharded)

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from torch_dp_worker import run_ranks  # noqa: E402

MARGIN_TOL = 1e-5   # tests/test_torch_gbdt_train.py's _assert_boosters_match
TREE_FIELDS = ("trees_feature", "trees_threshold", "trees_left",
               "trees_right", "trees_value", "trees_cover", "tree_weights")


def _toy(n=2000, d=6, seed=0):
    """``tests/test_torch_gbdt_train.py``'s binary rows (NaNs included) at
    the seed of its ``test_train_matches_jax``: no split of the fit below
    is a near-tie, where JAX's blocked float32 sums and the port's could
    break it differently (ROADMAP Queue 3)."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, d))
    x[rng.random((n, d)) < 0.05] = np.nan
    x0, x1 = np.nan_to_num(x[:, 0]), np.nan_to_num(x[:, 1])
    y = (x0 + 0.5 * x1 + rng.normal(scale=0.5, size=n) > 0).astype(np.float64)
    return x, y


def _cols(d):
    return [f"f{i}" for i in range(d)]


def _batch(x, y, lo, hi, **extra):
    d = {c: x[lo:hi, j] for j, c in enumerate(_cols(x.shape[1]))}
    d["label"] = y[lo:hi]
    for name, col in extra.items():
        d[name] = col[lo:hi]
    return d


def _assert_bitwise(got, want):
    assert got.num_trees == want.num_trees
    for f in TREE_FIELDS:
        assert getattr(got, f).tobytes() == getattr(want, f).tobytes(), f
    assert got.init_score == want.init_score


def _assert_matches_jax(tb, jb, x):
    """Trees identical, leaf values and margins within MARGIN_TOL."""
    assert tb.num_trees == jb.num_trees
    for f in ("trees_feature", "trees_threshold", "trees_left",
              "trees_right"):
        np.testing.assert_array_equal(getattr(tb, f), getattr(jb, f), f)
    np.testing.assert_allclose(tb.trees_value, jb.trees_value, rtol=0,
                               atol=MARGIN_TOL)
    np.testing.assert_allclose(tb.predict_raw(x, device="cpu"),
                               jb.predict_raw(x), rtol=0, atol=MARGIN_TOL)


# -- one process ------------------------------------------------------------

_P = dict(objective="binary", num_iterations=10, num_leaves=15)
_SPANS = [(0, 300), (300, 700), (700, 1000), (1000, 1300), (1300, 1700),
          (1700, 2000)]


def _batches(fmt, x, y):
    out = []
    for i, (lo, hi) in enumerate(_SPANS):
        d = _batch(x, y, lo, hi)
        kind = fmt if fmt != "mixed" else ("dict", "pandas", "table")[i % 3]
        if kind == "table":
            d = Table(d)
        elif kind == "pandas":
            d = pytest.importorskip("pandas").DataFrame(d)
        elif kind == "pyarrow":
            d = pytest.importorskip("pyarrow").RecordBatch.from_pydict(d)
        out.append(d)
    return out


@pytest.fixture(scope="module")
def jax_single():
    """The JAX package's one-process fit_partitions of the toy rows."""
    x, y = _toy()
    return jpartitions.fit_partitions(
        jboosting.BoostParams(**_P), [_batch(x, y, 0, 2000)],
        feature_cols=_cols(6))


@pytest.mark.parametrize("fmt", ["dict", "table", "mixed", "pyarrow"])
def test_fit_partitions_is_train_on_the_rows_and_matches_jax(fmt,
                                                             jax_single):
    """Ordered record batches (dicts, Tables, pandas frames, pyarrow
    record batches) reproduce the single-table fit bit for bit, on the
    single-process route."""
    x, y = _toy()
    stats = {}
    got = fit_partitions(BoostParams(**_P), iter(_batches(fmt, x, y)),
                         feature_cols=_cols(6), stats_out=stats,
                         device="cpu")
    _assert_bitwise(got, train(BoostParams(**_P), x, y, device="cpu"))
    assert stats["path"] == "single_process" and stats["n_local"] == 2000
    assert stats["rendezvous_s"] >= 0 and stats["aggregate_s"] > 0
    _assert_matches_jax(got, jax_single, x)


def test_aggregator_validation_and_weights():
    agg = PartitionAggregator(["a"], label_col="y", weight_col="w")
    # empty executor: (0, F) arrays, NOT an exception — a raising rank
    # would leave the other ranks hanging in the gather collective
    x0, y0, w0 = agg.to_arrays()
    assert x0.shape == (0, 1) and y0.shape == (0,) and w0.shape == (0,)
    with pytest.raises(KeyError, match="'y', 'w'"):
        agg.add({"a": [1.0]})  # weight_col is validated up front too
    with pytest.raises(ValueError, match="length"):
        agg.add({"a": [1.0], "y": [0.0, 1.0], "w": [1.0, 1.0]})
    agg.add({"a": [1.0, 2.0], "y": [0.0, 1.0], "w": [1.0, 3.0],
             "unused": ["x", "y"]})
    assert "unused" not in agg._chunks[0]  # wide partitions don't pin RAM
    with pytest.raises(TypeError, match="unsupported"):
        agg.add(object())
    xa, ya, wa = agg.to_arrays()
    assert xa.shape == (2, 1) and wa.tolist() == [1.0, 3.0]
    assert agg.num_rows == 2


def test_fit_aggregated_checks_its_inputs():
    """The reference's checks and messages: no rows, a short group=
    array, groups given both ways."""
    with pytest.raises(ValueError, match="no rows"):
        fit_aggregated(BoostParams(objective="binary", num_iterations=2),
                       PartitionAggregator(["a"], label_col="y"),
                       device="cpu")
    agg = PartitionAggregator(["a"], label_col="y")
    agg.add({"a": [1.0, 2.0, 3.0], "y": [0.0, 1.0, 0.0]})
    with pytest.raises(ValueError, match="group length"):
        fit_aggregated(BoostParams(objective="lambdarank", num_iterations=2),
                       agg, group=np.asarray([0, 0]), device="cpu")
    agg_g = PartitionAggregator(["a"], label_col="y", group_col="q")
    agg_g.add({"a": [1.0, 2.0], "y": [0.0, 1.0], "q": [0, 0]})
    with pytest.raises(TypeError, match="not both"):
        fit_aggregated(BoostParams(objective="lambdarank", num_iterations=2),
                       agg_g, group=np.asarray([0, 0]), device="cpu")


def test_entry_points_default_to_the_card():
    """Without device=, a fit runs on the card; with no card it raises
    before joining anything, never falling back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default fit would run")
    x, y = _toy(50, 2)
    with pytest.raises(RuntimeError, match="CUDA"):
        fit_partitions(BoostParams(**_P), [_batch(x, y, 0, 50)],
                       feature_cols=_cols(2))


def test_fit_partitions_ranker_groups_and_wide_query_ids():
    """group_col streams query ids through the adapter: bitwise the
    single-call ranker fit; ids above 2**53 stay distinct."""
    rng = np.random.default_rng(4)
    n_q, per_q = 30, 8
    n = n_q * per_q
    x = rng.normal(size=(n, 4))
    rel = (x[:, 0] + 0.3 * rng.normal(size=n) > 0.4).astype(np.float64)
    q = np.repeat(np.arange(n_q), per_q)
    p = BoostParams(objective="lambdarank", num_iterations=8, num_leaves=7,
                    min_data_in_leaf=2)
    want = train(p, x, rel, group=q, device="cpu")
    # group-aligned partition boundaries (rows of a query stay together)
    batches = [_batch(x, rel, lo, hi, qid=q) for lo, hi in
               [(0, 80), (80, 160), (160, 240)]]
    got = fit_partitions(p, batches, feature_cols=_cols(4), group_col="qid",
                         device="cpu")
    _assert_bitwise(got, want)

    agg = PartitionAggregator(["a"], group_col="g")
    agg.add({"a": [1.0, 2.0], "label": [0.0, 1.0],
             "g": np.array([2**53, 2**53 + 1], np.int64)})
    ga = agg.group_array()
    assert ga.dtype == np.int64 and ga[0] != ga[1]


# -- a world of one: train_row_sharded without a process group ---------------

_ONE_N = 480


def _one_data():
    rng = np.random.default_rng(7)
    x = rng.normal(size=(_ONE_N, 6))
    w = rng.random(_ONE_N) + 0.5
    s = x[:, 0] + x[:, 1]
    return x, w, {"binary": (s > 0).astype(np.float64),
                  "multiclass": np.digitize(s, [-0.5, 0.5]).astype(float),
                  "regression": x[:, 0] * 2 + x[:, 1]}


# the reference's cases (tests/test_partitions.py:111-126)
_ONE_CASES = {
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
_ONE_RANK_P = dict(objective="lambdarank", num_iterations=5, num_leaves=7,
                   min_data_in_leaf=2)


def _one_rank_data():
    rng = np.random.default_rng(8)
    n_q, per_q = 30, 8
    x = rng.normal(size=(n_q * per_q, 4))
    rel = (x[:, 0] + 0.3 * rng.normal(size=n_q * per_q) > 0.4).astype(float)
    return x, rel, np.repeat(np.arange(n_q), per_q)


def _one_args(case):
    """(BoostParams kwargs, x, y, extra train kwargs) of a world-of-one
    case."""
    if case == "lambdarank":
        x, rel, q = _one_rank_data()
        return _ONE_RANK_P, x, rel, dict(group=q)
    x, w, ys = _one_data()
    pkw, label = _ONE_CASES[case]
    return {"num_leaves": 7, **pkw}, x, ys[label], dict(weight=w)


@pytest.fixture(scope="module")
def one_rank_group(tmp_path_factory):
    """Each case through train(..., mesh=<one-rank gloo group>)."""
    cases = []
    for case in [*_ONE_CASES, "lambdarank"]:
        pkw, x, y, extra = _one_args(case)
        cases.append({"name": case, "kind": "train",
                      "kw": dict(p=pkw, x=x, y=y, **extra)})
    res = run_ranks(str(tmp_path_factory.mktemp("one")), 1, cases,
                    timeout=240)
    return res[0]


@pytest.mark.parametrize("case", [*_ONE_CASES, "lambdarank"])
def test_world_of_one_row_sharded_is_the_one_rank_group_fit(case,
                                                           one_rank_group):
    """No process group: train_row_sharded trains as a world of one rank,
    bitwise train(mesh=) on a one-rank group (the reference trains over
    its one process's devices, boosting.py:1406-1407)."""
    assert "error" not in one_rank_group[case], one_rank_group[case]["error"]
    want = one_rank_group[case]["cpu"]["booster"]
    pkw, x, y, extra = _one_args(case)
    got = train_row_sharded(BoostParams(**pkw), x, y, device="cpu", **extra)
    _assert_bitwise(got, want)
    np.testing.assert_array_equal(got.predict_raw(x, device="cpu"),
                                  want.predict_raw(x, device="cpu"))


def test_fit_aggregated_row_sharded_in_one_process(one_rank_group):
    """row_sharded=True without a group takes the repaired path."""
    pkw, x, y, extra = _one_args("binary")
    agg = PartitionAggregator(_cols(6), weight_col="w")
    agg.add(_batch(x, y, 0, _ONE_N, w=extra["weight"]))
    stats = {}
    got = fit_aggregated(BoostParams(**pkw), agg, row_sharded=True,
                         stats_out=stats, device="cpu")
    _assert_bitwise(got, one_rank_group["binary"]["cpu"]["booster"])
    assert stats["path"] == "row_sharded" and stats["n_global"] == _ONE_N


# -- two gloo ranks formed by the driver rendezvous --------------------------

_RS_P = dict(objective="binary", num_iterations=6, num_leaves=7)
_RANK_P = dict(objective="lambdarank", num_iterations=6, num_leaves=7,
               min_data_in_leaf=2)


def _rs_data():
    """``tests/test_torch_gbdt_row_sharded.py``'s binary rows: integer
    weights make the rank-summed label sums exact, and no split is a
    near-tie against JAX."""
    rng = np.random.default_rng(7)
    x = rng.normal(size=(480, 6))
    w = rng.integers(1, 4, 480).astype(np.float64)
    return x, (x[:, 0] + x[:, 1] > 0).astype(np.float64), w


def _empty_data():
    rng = np.random.default_rng(3)
    x = rng.normal(size=(300, 4))
    y = (x[:, 0] - 0.5 * x[:, 2] > 0).astype(np.float64)
    return x, y, rng.random(300) + 0.5


def _rank_data():
    rng = np.random.default_rng(0)
    n_q, per_q = 40, 8
    n = n_q * per_q
    x = rng.normal(size=(n, 4))
    rel = (x[:, 0] + 0.3 * rng.normal(size=n) > 0.4).astype(np.float64)
    return x, rel, np.repeat(np.arange(n_q), per_q)


def _two_rank_cases():
    x, y, w = _rs_data()
    # rank 0 streams a dict and a Table, rank 1 one dict
    rs_parts = [[_batch(x, y, 0, 100, w=w), Table(_batch(x, y, 100, 240,
                                                          w=w))],
                [_batch(x, y, 240, 480, w=w)]]
    xe, ye, we = _empty_data()
    xr, rel, q = _rank_data()
    q_local = [q[:160], q[160:] - 20]          # both ranks number 0..19
    rank_parts = [[_batch(xr, rel, 0, 160, qid=q)],
                  [{**_batch(xr, rel, 160, 320), "qid": q_local[1]}]]
    return [
        {"name": "row_sharded", "kind": "partitions",
         "kw": dict(p=_RS_P, batches_parts=rs_parts, feature_cols=_cols(6),
                    weight_col="w", rendezvous=True)},
        {"name": "mesh", "kind": "train",
         "kw": dict(p=_RS_P, x=x, y=y, weight=w)},
        {"name": "empty_rank", "kind": "partitions",
         "kw": dict(p=_RS_P, feature_cols=_cols(4), weight_col="wt",
                    batches_parts=[[_batch(xe, ye, 0, 300, wt=we)], []])},
        {"name": "gather_ranker", "kind": "partitions",
         "kw": dict(p=_RANK_P, batches_parts=rank_parts,
                    feature_cols=_cols(4), group_col="qid",
                    row_sharded=False)},
        {"name": "mesh_ranker", "kind": "train",
         "kw": dict(p=_RANK_P, x=xr, y=rel, group=q)},
    ]


@pytest.fixture(scope="module")
def two_ranks(tmp_path_factory):
    res = run_ranks(str(tmp_path_factory.mktemp("rdv")), 2,
                    _two_rank_cases(), timeout=240, init="rendezvous")
    for name in res[0]:
        for r in res:
            assert "error" not in r[name], r[name]["error"]
    return res


def _fits(two_ranks, name):
    a, b = (r[name]["cpu"] for r in two_ranks)
    _assert_bitwise(a["booster"], b["booster"])   # every rank, the same bits
    return a, b


def test_rendezvous_row_sharded_fit_is_the_mesh_fit_and_matches_jax(
        two_ranks):
    """Each rank streams its half: bitwise train(mesh=) on all rows (rows
    in rank order, within bin_sample_count); trees identical and margins
    within 1e-5 of the JAX package's train_row_sharded at dp=2."""
    x, y, w = _rs_data()
    got = _fits(two_ranks, "row_sharded")[0]["booster"]
    _assert_bitwise(got, _fits(two_ranks, "mesh")[0]["booster"])
    jb = jboosting.train_row_sharded(
        jboosting.BoostParams(**_RS_P), x, y, weight=w,
        mesh=Mesh(np.asarray(jax.devices()[:2]), ("dp",)))
    _assert_matches_jax(got, jb, x)


def test_rendezvous_stats_out_of_the_row_sharded_route(two_ranks):
    for rank, fit in enumerate(_fits(two_ranks, "row_sharded")):
        st = fit["stats_out"]
        assert st["path"] == "row_sharded"
        assert (st["n_local"], st["n_total"], st["n_global"]) == (240, 480,
                                                                  480)
        assert st["sample_rows_gathered"] == 480
        assert st["addressable_row_bytes"] == 240 * 6
        assert st["rendezvous_s"] > 0 and st["aggregate_s"] > 0
        assert fit["collective_calls"] > 0


def test_empty_rank_with_weight_col(two_ranks):
    """A rank with ZERO rows joins every collective; the booster is the
    one the other rank's rows imply (the reference's empty-host test)."""
    x, y, w = _empty_data()
    fits = _fits(two_ranks, "empty_rank")
    assert [f["stats_out"]["n_local"] for f in fits] == [300, 0]
    assert all(f["stats_out"]["n_total"] == 300 for f in fits)
    got = fits[0]["booster"]
    single = train(BoostParams(**_RS_P), x, y, weight=w, device="cpu")
    assert got.num_trees == single.num_trees
    np.testing.assert_allclose(got.predict(x, device="cpu"),
                               single.predict(x, device="cpu"), rtol=1e-12)


def test_gather_route_relabels_local_query_ids(two_ranks):
    """Both ranks number their queries 0..19: the gather route relabels
    them into disjoint ranges, so the fit is bitwise train(mesh=) over the
    globally numbered rows, and matches the JAX package's mesh fit."""
    xr, rel, q = _rank_data()
    fits = _fits(two_ranks, "gather_ranker")
    assert all(f["stats_out"]["path"] == "gather" for f in fits)
    assert [f["stats_out"]["n_local"] for f in fits] == [160, 160]
    got = fits[0]["booster"]
    _assert_bitwise(got, _fits(two_ranks, "mesh_ranker")[0]["booster"])
    jb = jboosting.train(jboosting.BoostParams(**_RANK_P), xr, rel, group=q,
                         mesh=Mesh(np.asarray(jax.devices()[:2]), ("dp",)))
    _assert_matches_jax(got, jb, xr)

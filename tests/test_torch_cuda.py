"""The port's CUDA kernels against their plain versions, on the card.

Marked ``cuda``: every test here needs an NVIDIA GPU and the CUDA toolkit
(the kernels are built from ``synapseml_tpu_torch/csrc`` at first use) and
skips where there is none. Run on the GPU machine with
``python -m pytest tests/test_torch_cuda.py -q``.
"""
import numpy as np
import pytest
import torch

from synapseml_tpu_torch.gbdt import kernels

pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels (K1 histogram, K2 "
                    "traversal) have no CPU or interpret mode")
    return torch.device("cuda", 0)


def _forest(rng, t, m, f):
    idx = np.arange(m)
    internal = 2 * idx + 2 < m
    feat = np.where(internal[None, :], rng.integers(0, f, (t, m)), -1)
    thr = np.where(internal[None, :], rng.normal(size=(t, m)), 0.0)
    left = np.broadcast_to(np.where(internal, 2 * idx + 1, 0), (t, m))
    right = np.broadcast_to(np.where(internal, 2 * idx + 2, 0), (t, m))
    value = np.where(internal[None, :], 0.0, rng.normal(size=(t, m)))
    return [torch.from_numpy(np.ascontiguousarray(a, dt)) for a, dt in zip(
        (feat, thr, left, right, value),
        (np.int32, np.float32, np.int32, np.int32, np.float32))]


@pytest.mark.parametrize("t,m,f,k,n,strict,depth", [
    (100, 61, 14, 1, 5000, False, None),
    (30, 63, 10, 3, 777, False, None),
    (1, 61, 14, 1, 1, False, None),
    (40, 127, 6, 1, 3000, True, 9),
    (7, 15, 4, 5, 300, True, 2),
    # the isolation forest's 511-node trees: more than one shared-memory
    # tile of trees, staged while the previous tile is walked
    (100, 511, 14, 1, 4000, True, 10),
    (100, 511, 14, 3, 4000, False, None),
    (40, 511, 14, 5, 1000, False, None),
    (5, 61, 300, 2, 3000, False, None),      # wide rows: 128-row tiles
    # beyond the tiles' records (1,024 features, 2,048 nodes a tree): the
    # direct kernel
    (5, 61, 1100, 2, 500, False, None),
    (3, 16383, 14, 1, 2000, False, 20),
])
def test_kernel_bitwise_equals_plain_version(card, t, m, f, k, n, strict,
                                             depth):
    rng = np.random.default_rng(t + m + n)
    planes = [p.to(card) for p in _forest(rng, t, m, f)]
    x = rng.normal(size=(n, f)).astype(np.float32)
    x[rng.random(x.shape) < 0.1] = np.nan
    xd = torch.from_numpy(x).to(card)
    before = kernels.forest_traverse.launches
    got = kernels.forest_traverse(xd, *planes, k=k, depth=depth,
                                  strict=strict)
    torch.cuda.synchronize()
    assert kernels.forest_traverse.launches == before + 1
    want = kernels.forest_traverse_reference(xd, *planes, k=k, depth=depth,
                                             strict=strict)
    assert torch.equal(got, want)


def test_wrapper_raises_on_what_the_kernel_does_not_take(card):
    planes = [p.to(card) for p in _forest(np.random.default_rng(0), 3, 7, 4)]
    x = torch.zeros((5, 4), device=card)
    with pytest.raises(TypeError):
        kernels.forest_traverse(x.double(), *planes)
    with pytest.raises(ValueError):
        kernels.forest_traverse(x, planes[0].cpu(), *planes[1:])
    empty = kernels.forest_traverse(x[:0], *planes, k=2)
    assert empty.shape == (0, 2) and empty.device.type == "cuda"
    with pytest.raises(ValueError):          # trees of no node
        kernels.forest_traverse(x, *[p[:, :0].contiguous() for p in planes])


# -- K1, the histogram -----------------------------------------------------

def _hist_inputs(rng, n, f, n_bins, dtype, mask_frac):
    binned = rng.integers(0, n_bins, (n, f)).astype(dtype)
    g = rng.normal(size=n).astype(np.float32)
    h = rng.random(n).astype(np.float32)
    w = (rng.random(n) < mask_frac).astype(np.float32)
    data = np.stack([g * w, h * w, w], 1)
    return torch.from_numpy(binned), torch.from_numpy(data)


@pytest.mark.parametrize("n,f,n_bins,dtype,mask_frac", [
    (32_561, 14, 256, np.uint8, 1.0),     # the Adult root histogram
    (32_561, 14, 256, np.uint8, 0.3),     # a leaf
    (32_561, 14, 256, np.uint8, 0.0),     # all rows masked: exact zeros
    (10_007, 5, 1024, np.uint16, 1.0),
    (1, 1, 8, np.uint8, 1.0),
    (0, 4, 16, np.uint8, 1.0),
    (4_099, 3, 37, np.uint8, 0.5),        # bins not a multiple of 32
])
def test_histogram_bitwise_equals_plain_version(card, n, f, n_bins, dtype,
                                                mask_frac):
    """Bitwise against the plain version run on the CPU (index_add_ adds
    in row order there; on the card it uses atomics)."""
    binned, data = _hist_inputs(np.random.default_rng(n + f), n, f, n_bins,
                                dtype, mask_frac)
    before = kernels.histogram.launches
    got = kernels.histogram(binned.to(card), data.to(card), n_bins)
    torch.cuda.synchronize()
    assert kernels.histogram.launches == before + 1
    want = kernels.histogram_reference(binned, data, n_bins)
    assert torch.equal(got.cpu(), want)


def _skewed_and_nan_cases(rng):
    """(name, binned, data, n_bins): 90% of the rows in one bin, and all
    data zero but one NaN grad."""
    n = 32_561
    skew, data = _hist_inputs(rng, n, 14, 256, np.uint8, 0.7)
    skew = skew.numpy()
    skew[rng.random(skew.shape) < 0.9] = 200
    nan_bins, _ = _hist_inputs(rng, n, 14, 256, np.uint8, 1.0)
    nan_data = np.zeros((n, 3), np.float32)
    nan_data[17_000, 0] = np.nan
    return [("skewed_90pct", torch.from_numpy(skew), data, 256),
            ("one_nan_grad", nan_bins, torch.from_numpy(nan_data), 256)]


@pytest.mark.parametrize("case", ["adult_root", "adult_leaf", "uint16_b1024",
                                  "skewed_90pct", "one_nan_grad", "n0"])
def test_histogram_with_a_given_index_bitwise_equals_plain_version(card,
                                                                   case):
    """K1 on the per-fit index (``bin_index`` built on the card), with and
    without the index given, bitwise against the plain version run on the
    CPU (NaN where the plain version has NaN); the card's index is the
    CPU's."""
    rng = np.random.default_rng(len(case))
    special = {c[0]: c[1:] for c in _skewed_and_nan_cases(rng)}
    if case in special:
        binned, data, n_bins = special[case]
    else:
        n, f, n_bins, dtype, frac = {
            "adult_root": (32_561, 14, 256, np.uint8, 1.0),
            "adult_leaf": (32_561, 14, 256, np.uint8, 0.3),
            "uint16_b1024": (10_007, 5, 1024, np.uint16, 1.0),
            "n0": (0, 4, 16, np.uint8, 1.0)}[case]
        binned, data = _hist_inputs(rng, n, f, n_bins, dtype, frac)
    want = kernels.histogram_reference(binned, data, n_bins)
    bd, dd = binned.to(card), data.to(card)
    index = kernels.bin_index(bd, n_bins)
    cpu_index = kernels.bin_index(binned, n_bins)
    assert torch.equal(index.order.cpu(), cpu_index.order)
    assert torch.equal(index.start.cpu(), cpu_index.start)
    builds = kernels.bin_index.builds
    given = kernels.histogram(bd, dd, n_bins, index=index)
    assert kernels.bin_index.builds == builds
    built = kernels.histogram(bd, dd, n_bins)
    assert kernels.bin_index.builds == builds + 1
    torch.cuda.synchronize()
    for got in (given.cpu(), built.cpu()):
        assert torch.equal(torch.isnan(got), torch.isnan(want))
        assert torch.equal(got.nan_to_num(7.0).view(torch.int32),
                           want.nan_to_num(7.0).view(torch.int32))
    if case == "one_nan_grad":
        assert int(torch.isnan(want).sum()) == 14


def test_histogram_raises_on_an_index_it_was_not_built_for(card):
    rng = np.random.default_rng(1)
    binned, data = _hist_inputs(rng, 1000, 3, 16, np.uint8, 1.0)
    bd, dd = binned.to(card), data.to(card)
    for other in (kernels.bin_index(bd, 32), kernels.bin_index(bd[:900], 16),
                  kernels.bin_index(binned, 16)):      # on the CPU
        with pytest.raises(ValueError):
            kernels.histogram(bd, dd, 16, index=other)


def test_histogram_refuses_a_stale_index_of_the_right_shape(card):
    rng = np.random.default_rng(2)
    binned, data = _hist_inputs(rng, 1000, 3, 16, np.uint8, 1.0)
    bd, dd = binned.to(card), data.to(card)
    index = kernels.bin_index(bd, 16)
    with pytest.raises(ValueError, match="bin index built from another"):
        kernels.histogram(bd.flip(0).contiguous(), dd, 16, index=index)
    bd[0, 0] = 15 - bd[0, 0]
    with pytest.raises(ValueError, match="bin index built before"):
        kernels.histogram(bd, dd, 16, index=index)


@pytest.mark.parametrize("f0_moved", [True, False])
def test_histogram_on_a_masked_index_bitwise_equals_plain_version(card,
                                                                  f0_moved):
    """``feature_fraction``'s per-tree index (``mask_features``): the
    card's equals the CPU's and ``bin_index`` of the moved bins, and K1 on
    it is the plain version of the moved bins, bitwise."""
    rng = np.random.default_rng(3)
    binned, data = _hist_inputs(rng, 32_561, 14, 256, np.uint8, 0.8)
    keep = torch.from_numpy(rng.random(14) < 0.8)
    keep[0] = not f0_moved
    bd, dd = binned.to(card), data.to(card)
    moved, masked = kernels.mask_features(kernels.bin_index(bd, 256), bd,
                                          keep.to(card))
    cpu_moved, cpu_masked = kernels.mask_features(
        kernels.bin_index(binned, 256), binned, keep)
    fresh = kernels.bin_index(moved, 256)
    for a, b in ((masked.order, cpu_masked.order),
                 (masked.start, cpu_masked.start),
                 (masked.order, fresh.order), (masked.start, fresh.start),
                 (moved, cpu_moved)):
        assert torch.equal(a.cpu(), b.cpu())
    got = kernels.histogram(moved, dd, 256, index=masked)
    torch.cuda.synchronize()
    want = kernels.histogram_reference(cpu_moved, data, 256)
    assert torch.equal(got.cpu().view(torch.int32), want.view(torch.int32))


def test_histogram_five_launches_are_bitwise_identical(card):
    binned, data = _hist_inputs(np.random.default_rng(0), 32_561, 14, 256,
                                np.uint8, 1.0)
    binned, data = binned.to(card), data.to(card)
    outs = [kernels.histogram(binned, data, 256) for _ in range(5)]
    assert all(torch.equal(outs[0], o) for o in outs[1:])


def test_histogram_wrapper_raises_on_what_the_kernel_does_not_take(card):
    binned = torch.zeros((5, 3), dtype=torch.uint8, device=card)
    data = torch.zeros((5, 3), device=card)
    with pytest.raises(TypeError):
        kernels.histogram(binned.int(), data, 4)
    with pytest.raises(TypeError):
        kernels.histogram(binned, data.double(), 4)
    with pytest.raises(TypeError):
        kernels.histogram(binned, data.cpu(), 4)
    with pytest.raises(ValueError):
        kernels.histogram(binned, data[:4], 4)
    with pytest.raises(ValueError):
        kernels.histogram(binned, data, 70_000)


# -- ranking and categorical training on the card --------------------------

def _rank_rows(seed, sizes, f=8):
    rng = np.random.default_rng(seed)
    group = np.repeat(np.arange(len(sizes)), sizes)
    x = rng.normal(size=(len(group), f))
    t = x[:, 0] + 0.5 * x[:, 1] + rng.normal(scale=0.5, size=len(group))
    return x, np.clip(np.floor(t + 2), 0, 4), group


@pytest.mark.parametrize("form", ["blocked", "dense"])
def test_lambdarank_grad_on_the_card_equals_the_cpu(card, form):
    """The LambdaRank gradients on the card against the same code on the
    CPU: float64 terms and sums rounded once, so within one float32
    rounding of each value (the float64 sums add in another order)."""
    from synapseml_tpu_torch.gbdt import objectives

    rng = np.random.default_rng(4)
    sizes = [30, 200, 1, 57, 120] if form == "blocked" else [600] + [2] * 40
    _, lab, group = _rank_rows(5, sizes)
    p = np.round(rng.normal(size=len(group)) * 4) / 4   # ties among them
    args = [torch.from_numpy(p.astype(np.float32)),
            torch.from_numpy(lab.astype(np.float32))]
    if form == "blocked":
        layout = [torch.from_numpy(a) for a in
                  objectives.build_query_blocks(group)]
        fn = objectives.lambdarank_grad_blocked
    else:
        layout = [torch.from_numpy(group)]
        fn = objectives.lambdarank_grad
    cpu = fn(*args, *layout)
    gpu = fn(*(a.to(card) for a in args), *(a.to(card) for a in layout))
    for c, g in zip(cpu, gpu):
        assert g.is_cuda and g.dtype == torch.float32
        np.testing.assert_allclose(g.cpu().numpy(), c.numpy(), rtol=2 ** -23,
                                   atol=0)


def test_categorical_fit_bins_and_index_on_the_card_equal_the_cpu(card):
    """A categorical column's bins (host numpy) and their bin index on the
    card equal the CPU's, and a categorical fit on the card grows the CPU
    fit's trees."""
    from synapseml_tpu_torch.gbdt import boosting
    from synapseml_tpu_torch.gbdt.binning import BinMapper

    rng = np.random.default_rng(6)
    x = rng.normal(size=(5000, 4))
    x[:, 1] = rng.integers(0, 9, 5000)
    x[rng.random(5000) < 0.02, 1] = np.nan
    y = (x[:, 0] + (x[:, 1] % 3 == 0) > 0.5).astype(np.float64)
    mapper = BinMapper(categorical_features=(1,)).fit(x)
    binned = torch.from_numpy(mapper.transform(x))
    index = kernels.bin_index(binned.to(card), mapper.total_bins)
    cpu_index = kernels.bin_index(binned, mapper.total_bins)
    assert torch.equal(index.order.cpu(), cpu_index.order)
    assert torch.equal(index.start.cpu(), cpu_index.start)
    p = boosting.BoostParams(num_iterations=10, num_leaves=15,
                             categorical_features=(1,))
    on_card = boosting.train(p, x, y, device="cuda")
    on_cpu = boosting.train(p, x, y, device="cpu")
    for name in ("trees_feature", "trees_threshold", "trees_left",
                 "trees_right", "trees_cover"):
        np.testing.assert_array_equal(getattr(on_card, name),
                                      getattr(on_cpu, name), name)
    np.testing.assert_allclose(on_card.predict_raw(x, device="cuda"),
                               on_cpu.predict_raw(x, device="cpu"), rtol=0,
                               atol=1e-4)


def test_ranker_fit_on_the_card_equals_the_cpu(card):
    """LightGBMRanker on the card (K1 for the trees, K2 for the grouped
    validation set's NDCG) against the same code on the CPU: the same
    trees and NDCG history, margins within 1e-4."""
    from synapseml_tpu_torch.data.table import Table
    from synapseml_tpu_torch.gbdt import estimators

    x, y, group = _rank_rows(7, np.random.default_rng(7).integers(20, 120, 40))
    table = Table({"features": x, "label": y, "query": group,
                   "valid": group % 5 == 0})
    kw = dict(num_iterations=20, num_leaves=15, early_stopping_round=5,
              validation_indicator_col="valid")
    before = kernels.histogram.launches
    on_card = estimators.LightGBMRanker(**kw).fit(table, device="cuda")
    assert kernels.histogram.launches > before
    on_cpu = estimators.LightGBMRanker(**kw).fit(table, device="cpu")
    a, b = on_card.booster, on_cpu.booster
    for name in ("trees_feature", "trees_threshold", "trees_left",
                 "trees_right", "trees_cover"):
        np.testing.assert_array_equal(getattr(a, name), getattr(b, name), name)
    assert a.best_iteration == b.best_iteration
    np.testing.assert_allclose(a.eval_history["ndcg"], b.eval_history["ndcg"],
                               rtol=1e-12)
    np.testing.assert_allclose(a.predict_raw(x, device="cuda"),
                               b.predict_raw(x, device="cpu"), rtol=0,
                               atol=1e-4)


def test_data_parallel_fits_on_the_card_equal_the_cpu(card, tmp_path):
    """Data-parallel training, two gloo ranks sharing the card against the
    same two ranks on the CPU (``tests/torch_dp_worker.py``): bitwise in
    every mode (K1 bitwise its plain version, the reductions rank-ordered,
    float64 where a device could round otherwise). Both ranks' boosters
    are equal. A one-rank NCCL group on the card trains what a one-rank
    gloo group does."""
    import os
    import sys
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from torch_dp_worker import run_ranks

    rng = np.random.default_rng(3)
    x = rng.normal(size=(6000, 8))
    t = x[:, 0] + np.sin(2 * x[:, 1]) + 0.5 * x[:, 2] * x[:, 3]
    t += rng.normal(scale=0.3, size=len(t))
    yb = (t > 0).astype(np.float64)
    y3 = np.digitize(t, np.quantile(t, [1 / 3, 2 / 3])).astype(np.float64)
    group = np.repeat(np.arange(200), 30)
    yr = np.clip(np.floor(t + 2), 0, 4)
    base = dict(num_iterations=8, num_leaves=15)
    modes = {
        "gbdt": (dict(objective="binary"), yb, {}),
        "bagging_feature_fraction": (dict(objective="binary",
                                          bagging_fraction=0.8,
                                          bagging_freq=1,
                                          feature_fraction=0.8), yb, {}),
        "goss": (dict(objective="binary", boosting_type="goss"), yb, {}),
        "rf": (dict(objective="binary", boosting_type="rf",
                    bagging_fraction=0.7, bagging_freq=1), yb, {}),
        "dart": (dict(objective="binary", boosting_type="dart",
                      drop_rate=0.3, skip_drop=0.2), yb, {}),
        "multiclass_3": (dict(objective="multiclass", num_class=3), y3, {}),
        "lambdarank": (dict(objective="lambdarank"), yr,
                       dict(group=group)),
        "regression_l1": (dict(objective="regression_l1"), t, {}),
        "voting_top_k_2": (dict(objective="binary",
                                tree_learner="voting_parallel",
                                voting_top_k=2), yb, {}),
    }
    both = ["cuda", "cpu"]
    cases = [{"name": n, "kind": "train", "devices": both,
              "kw": dict(p={**base, **pkw}, x=x, y=y, **extra)}
             for n, (pkw, y, extra) in modes.items()]
    cases.append({"name": "row_sharded", "kind": "row_sharded",
                  "devices": both,
                  "kw": dict(p={**base, "objective": "binary"},
                             x_parts=[x[:3000], x[3000:]],
                             y_parts=[yb[:3000], yb[3000:]])})
    cases.append({"name": "one_rank", "kind": "one_rank", "devices": ["cuda"],
                  "kw": dict(p={**base, "objective": "binary"}, x=x, y=yb,
                             backends=["nccl", "gloo"])})
    res = run_ranks(str(tmp_path), 2, cases, timeout=600, threads=2)
    for name in [c["name"] for c in cases[:-1]]:
        fits = [r[name] for r in res]
        assert all("error" not in f for f in fits), fits[0].get("error")
        card_b, cpu_b = fits[0]["cuda"]["booster"], fits[0]["cpu"]["booster"]
        for b in (fits[1]["cuda"]["booster"], cpu_b):
            for f in ("trees_feature", "trees_threshold", "trees_value",
                      "tree_weights"):
                assert getattr(b, f).tobytes() == getattr(
                    card_b, f).tobytes(), (name, f)
        assert fits[0]["cuda"]["k1_launches"] > 0, name
        assert fits[0]["cpu"]["k1_launches"] == 0, name
    one = res[0]["one_rank"]
    assert "error" not in one, one.get("error")
    for f in ("trees_feature", "trees_threshold", "trees_value"):
        assert (getattr(one["nccl"]["booster"], f).tobytes()
                == getattr(one["gloo"]["booster"], f).tobytes()), f


def test_one_nccl_rank_joins_through_the_rendezvous_and_fits(card, tmp_path):
    """A world of one joined through a ``DriverRendezvous`` with backend
    NCCL and ``local_device_ids=[0]`` (the card selected for the rank),
    then ``fit_partitions(row_sharded=True)`` on the card: bitwise the
    same fit on the CPU without a process group (a world of one)."""
    import os
    import sys
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from torch_dp_worker import run_ranks

    from synapseml_tpu_torch.gbdt.boosting import (BoostParams,
                                                   train_row_sharded)

    rng = np.random.default_rng(5)
    x = rng.normal(size=(4000, 6))
    y = (x[:, 0] + x[:, 1] * x[:, 2] > 0).astype(np.float64)
    p = dict(objective="binary", num_iterations=8, num_leaves=15)
    cols = [f"f{j}" for j in range(6)]
    batches = [{**{c: x[lo:hi, j] for j, c in enumerate(cols)},
                "label": y[lo:hi]} for lo, hi in ((0, 1500), (1500, 4000))]
    cases = [{"name": "join", "kind": "join"},
             {"name": "fit", "kind": "partitions", "devices": ["cuda"],
              "kw": dict(p=p, batches_parts=[batches], feature_cols=cols,
                         row_sharded=True)}]
    res = run_ranks(str(tmp_path), 1, cases, timeout=300, init="rendezvous",
                    backend="nccl", local_device=0)[0]
    assert "error" not in res["join"], res["join"].get("error")
    assert (res["join"]["backend"], res["join"]["cuda_device"]) == ("nccl", 0)
    assert "error" not in res["fit"], res["fit"].get("error")
    fit = res["fit"]["cuda"]
    assert fit["backend"] == "nccl"
    assert fit["stats_out"]["path"] == "row_sharded"
    assert fit["k1_launches"] > 0 and fit["collective_calls"] > 0
    want = train_row_sharded(BoostParams(**p), x, y, device="cpu")
    for f in ("trees_feature", "trees_threshold", "trees_value",
              "tree_weights"):
        assert getattr(fit["booster"], f).tobytes() == getattr(
            want, f).tobytes(), f

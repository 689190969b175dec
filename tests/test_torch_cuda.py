"""The port's CUDA kernels against their plain versions, on the card.

Marked ``cuda``: every test here needs an NVIDIA GPU and the CUDA toolkit
(the kernels are built from ``synapseml_tpu_torch/csrc`` at first use) and
skips where there is none. Run on the GPU machine with
``python -m pytest tests/test_torch_cuda.py -q``.
"""
import os
import sys
import zlib

import numpy as np
import pytest
import torch

from synapseml_tpu_torch.gbdt import kernels

FIXTURES = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "fixtures")

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


def test_launch_counter_is_exact_under_threads(card):
    """8 threads x 200 K2 calls at once (scorer threads sharing the card)
    count exactly 1,600 launches: the counter's increment is locked."""
    import threading

    planes = [p.to(card) for p in _forest(np.random.default_rng(3),
                                          10, 15, 4)]
    xd = torch.from_numpy(np.random.default_rng(4).normal(
        size=(64, 4)).astype(np.float32)).to(card)
    kernels.forest_traverse(xd, *planes)  # built before the race
    torch.cuda.synchronize()
    barrier = threading.Barrier(8)
    errors = []

    def caller():
        try:
            barrier.wait(timeout=60)
            for _ in range(200):
                kernels.forest_traverse(xd, *planes)
        except Exception as e:  # noqa: BLE001 - reported below
            errors.append(repr(e))

    before = kernels.forest_traverse.launches
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)  # switch threads inside the increment
    try:
        threads = [threading.Thread(target=caller) for _ in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
    finally:
        sys.setswitchinterval(interval)
    torch.cuda.synchronize()
    assert not errors and not any(t.is_alive() for t in threads), errors
    assert kernels.forest_traverse.launches - before == 1600


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


# -- the imported-ONNX forward (no hand-written kernel: cuDNN/cuBLAS) -----

def _bf16_rule(got, want) -> bool:
    """Within 5% of the float32 output's largest magnitude (the reference's
    verify rule for a cast lane)."""
    span = max(1e-6, float(np.abs(want).max()))
    return float(np.abs(got - want).max()) <= 0.05 * span


def test_onnx_resnet50_on_the_card_equals_the_cpu(card):
    """ResNet-50 at 32x32, batch 2: the float32 bind on the card within
    1e-5 of the largest |logit| of the port's CPU forward (seen: 1.5e-6;
    with TF32 the gap is ~1.2e-3 of it), the bf16 bind within the 5%
    rule; a warm forward makes no synchronizing call."""
    from synapseml_tpu_torch.onnx import import_model, zoo

    g = import_model(zoo.resnet50(num_classes=1000, image_size=32))
    x = torch.from_numpy(np.random.default_rng(0).standard_normal(
        (2, 3, 32, 32)).astype(np.float32))
    cpu = g.bind(device="cpu")(x)[0].numpy()
    f32 = g.bind()
    got = f32(x.to(card))[0]
    assert got.device.type == "cuda" and got.dtype == torch.float32
    gap = float(np.abs(got.cpu().numpy() - cpu).max())
    assert gap <= 1e-5 * float(np.abs(cpu).max()), gap
    fn = g.bind(cast_dtype=torch.bfloat16)
    xd = x.to(card, torch.bfloat16)
    got16 = fn(xd)[0]
    assert got16.dtype == torch.bfloat16
    assert _bf16_rule(got16.float().cpu().numpy(), cpu)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        fn(xd)
        f32(x.numpy())          # a host input: copied, not waited for
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()


@pytest.mark.parametrize("name", ["torch_cnn", "torch_gru",
                                  "torch_transformer", "torch_quant_cnn",
                                  "torch_kv_decoder"])
def test_onnx_fixture_on_the_card(card, name):
    """Each torch-exported graph on the card against the torch outputs
    recorded at export, at its reference test's tolerance."""
    import os

    from synapseml_tpu_torch.onnx import import_model

    fx = os.path.join(os.path.dirname(os.path.abspath(__file__)), "fixtures")
    io = np.load(os.path.join(fx, f"{name}_io.npz"))
    keys = (["input_ids", "past_key", "past_value"]
            if name == "torch_kv_decoder" else ["input"])
    wants = (["logits", "present_key", "present_value"]
             if name == "torch_kv_decoder" else ["expected"])
    fn = import_model(os.path.join(fx, f"{name}.onnx")).bind()
    outs = fn(*[torch.from_numpy(io[k]).to(card) for k in keys])
    for out, w in zip(outs, wants):
        assert out.device.type == "cuda"
        got, want = out.cpu().numpy(), io[w]
        if name == "torch_quant_cnn":
            step = float(io["out_scale"])
            err = np.abs(got - want)
            assert err.max() <= 2 * step + 1e-7
            assert (err <= step + 1e-7).mean() > 0.95
        else:
            np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)


def test_onnx_causal_encoder_on_the_card_equals_the_cpu(card):
    """The causal encoder (``Trilu`` mask) at a small width, batch 3: the
    float32 bind on the card within 1e-5 of the largest |value| of the
    port's CPU forward, the bf16 bind within the 5% rule; a warm forward
    makes no synchronizing call."""
    from synapseml_tpu_torch.onnx import import_model, zoo

    g = import_model(zoo.transformer_encoder(100, 64, 4, 128, 2, seq_len=16,
                                             causal=True, seed=1))
    ids = torch.from_numpy(np.random.default_rng(0).integers(0, 100, (3, 16)))
    cpu = g.bind(device="cpu")(ids)[0].numpy()
    f32 = g.bind()
    got = f32(ids.to(card))[0]
    assert got.device.type == "cuda" and got.dtype == torch.float32
    gap = float(np.abs(got.cpu().numpy() - cpu).max())
    assert gap <= 1e-5 * float(np.abs(cpu).max()), gap
    bf16 = g.bind(cast_dtype=torch.bfloat16)
    got16 = bf16(ids.to(card))[0]
    assert got16.dtype == torch.bfloat16
    assert _bf16_rule(got16.float().cpu().numpy(), cpu)
    idc = ids.to(card)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        f32(idc)
        bf16(idc)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()


def test_onnx_gqa_decode_steps_on_the_card_equal_the_cpu(card):
    """``zoo.tiny_decoder`` through its shared KV buffers: a right-padded
    prefill (row 1: 3 valid tokens of 5) and three decode steps on the
    card, each call's logits and buffers within 1e-5 of the CPU's; a warm
    step makes no synchronizing call and leaves its input buffers as they
    were."""
    from synapseml_tpu_torch.onnx import import_model, zoo

    g = import_model(zoo.tiny_decoder())
    on_card, on_cpu = g.bind(), g.bind(device="cpu")
    ids = torch.from_numpy(np.random.default_rng(1).integers(0, 64, (2, 8)))
    lens = torch.tensor([4, 2], dtype=torch.int32)
    bufs_cpu = [torch.zeros((2, 2, 16, 8)) for _ in range(4)]
    bufs_card = [b.to(card) for b in bufs_cpu]
    for start, stop, add in ((0, 5, 0), (5, 6, 1), (6, 7, 2), (7, 8, 3)):
        args = (ids[:, start:stop], lens + add)
        cpu = on_cpu(*args, *bufs_cpu)
        got = on_card(*[a.to(card) for a in args], *bufs_card)
        for c, d in zip(cpu, got):
            assert d.device.type == "cuda"
            gap = float((d.cpu() - c).abs().max())
            assert gap <= 1e-5 * max(1.0, float(c.abs().max())), gap
        bufs_cpu, bufs_card = list(cpu[1:]), list(got[1:])
    step = (ids[:, 7:8].to(card), (lens + 3).to(card))
    before = [b.clone() for b in bufs_card]
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        on_card(*step, *bufs_card)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(bufs_card, before))


def test_onnx_lstm_on_the_card_equals_the_cpu(card):
    """The BiLSTM tagger at the example's width (bidirectional LSTM) and a
    one-node RNN: the card's float32 output within 1e-5 of the CPU's."""
    from synapseml_tpu_torch.onnx import GraphBuilder, import_model, zoo

    g = import_model(zoo.bilstm_tagger(vocab=64, embed=16, hidden=16,
                                       n_tags=4, seq_len=16))
    ids = torch.from_numpy(np.random.default_rng(2).integers(0, 64, (16, 16)))
    cpu = g.bind(device="cpu")(ids)[0]
    got = g.bind()(ids.to(card))[0]
    assert float((got.cpu() - cpu).abs().max()) <= 1e-5
    rng = np.random.default_rng(3)
    b = GraphBuilder(opset=17)
    x = b.add_input("x", np.float32, [6, 2, 5])
    y = b.add_node("RNN", [x, b.add_initializer(
        "w", rng.normal(size=(2, 4, 5)).astype(np.float32)),
        b.add_initializer("r", rng.normal(size=(2, 4, 4)).astype(
            np.float32))], hidden_size=4, direction="bidirectional")
    b.add_output(y, np.float32, None)
    rnn = import_model(b.to_bytes())
    xs = torch.from_numpy(rng.normal(size=(6, 2, 5)).astype(np.float32))
    cpu = rnn.bind(device="cpu")(xs)[0]
    got = rnn.bind()(xs.to(card))[0]
    assert float((got.cpu() - cpu).abs().max()) <= 1e-5


# -- the batched executor and ONNXModel (no hand-written kernel) -----------

SLEEP_CYCLES = 1_000_000_000  # ~0.5 s of device spin (~1.8 GHz)


def test_executor_dispatch_returns_before_the_card_finishes(card):
    """The dispatch thread starts the copies and the compute and moves
    on: ``_dispatch`` returns while a ``torch.cuda._sleep``-padded ``fn``
    still runs on the card; the drain thread is what waits."""
    import time

    from synapseml_tpu_torch.runtime.executor import BatchedExecutor

    def fn(x):
        torch.cuda._sleep(SLEEP_CYCLES)
        return (x * 2.0,)

    ex = BatchedExecutor(fn, min_bucket=8)
    try:
        x = np.arange(8, dtype=np.float32)
        ex.submit(x).result(timeout=60)  # warm
        stamps = {}
        orig = ex._dispatch

        def dispatch(arrays, n, bucket):
            out = orig(arrays, n, bucket)
            stamps["dispatched"] = time.perf_counter()
            return out

        ex._dispatch = dispatch
        start = time.perf_counter()
        fut = ex.submit(x)
        submitted = time.perf_counter()
        (y,) = fut.result(timeout=60)
        done = time.perf_counter()
        assert submitted - start < 0.1
        assert done - stamps["dispatched"] > 0.2, (stamps, done)
        np.testing.assert_array_equal(y, x * 2.0)
    finally:
        ex.close()


def test_executor_stages_into_pinned_buffers(card):
    """Host columns (float64 grouped by ``transfer_batches``, uint8) are
    staged in pinned memory, and the pool keeps pinned buffers."""
    from synapseml_tpu_torch.runtime import executor as exmod

    ex = exmod.BatchedExecutor(lambda x, p: (x + 1.0, p.float()),
                               max_bucket=16, transfer_batches=2)
    seen = []
    orig = ex._dispatch

    def dispatch(arrays, n, bucket):
        seen.extend(a.batch.host.is_pinned() for a in arrays
                    if isinstance(a, exmod._Rows))
        return orig(arrays, n, bucket)

    ex._dispatch = dispatch
    try:
        rng = np.random.default_rng(0)
        x = rng.standard_normal((70, 5))
        p = rng.integers(0, 256, (70, 3), dtype=np.uint8)
        y, q = ex.submit(x, p).result(timeout=60)
        np.testing.assert_array_equal(y, x.astype(np.float32) + 1.0)
        np.testing.assert_array_equal(q, p.astype(np.float32))
        assert len(seen) == 10 and all(seen)
        pooled = [b for free in ex._pool._free.values() for b in free]
        assert pooled and all(b.is_pinned() for b in pooled)
    finally:
        ex.close()


def test_executor_card_tensor_input_and_device_outputs(card):
    """A caller's card tensor is padded on the card (after the caller's
    stream), a ``device_outputs`` leaf comes back a card tensor."""
    from synapseml_tpu_torch.runtime.executor import BatchedExecutor

    ex = BatchedExecutor(lambda x: (x * 3.0, x + 1.0), min_bucket=8,
                         device_outputs=[1])
    try:
        x = torch.randn(13, 4, device=card) * 2  # produced on the caller's stream
        host, dev = ex.submit(x).result(timeout=60)
        assert isinstance(host, np.ndarray) and dev.is_cuda
        assert dev.shape == (13, 4)
        np.testing.assert_array_equal(host, (x * 3.0).cpu().numpy())
        assert torch.equal(dev, x + 1.0)
    finally:
        ex.close()


def test_executor_close_resolves_batches_in_flight(card):
    from synapseml_tpu_torch.runtime.executor import BatchedExecutor

    def fn(x):
        torch.cuda._sleep(SLEEP_CYCLES // 5)
        return (x + 2.0,)

    ex = BatchedExecutor(fn, min_bucket=8, pipeline_depth=2)
    xs = [np.full(8, float(i), np.float32) for i in range(5)]
    futs = [ex.submit(x) for x in xs]
    ex.close(wait=True)
    for x, f in zip(xs, futs):
        np.testing.assert_array_equal(f.result(timeout=60)[0], x + 2.0)
    with pytest.raises(RuntimeError, match="closed"):
        ex.submit(xs[0])


@pytest.mark.parametrize("compute", ["float32", "bfloat16"])
def test_onnx_model_bucket_is_bitwise_its_bind_forward(card, compute):
    """ResNet-50 at 64x64 through ``ONNXModel.transform`` (20 rows at
    mini_batch_size 8: two full buckets and a padded tail): each bucket
    bitwise the port's ``bind()`` forward of the same padded batch."""
    from synapseml_tpu_torch.data.table import Table
    from synapseml_tpu_torch.onnx import ONNXModel, zoo

    m = ONNXModel(model_bytes=zoo.resnet50(num_classes=1000, image_size=64),
                  mini_batch_size=8, compute_dtype=compute)
    x = np.random.default_rng(0).standard_normal(
        (20, 3, 64, 64)).astype(np.float32)
    got = m.transform(Table({"data": x}))[m.graph.output_names[0]]
    cast = torch.bfloat16 if compute == "bfloat16" else None
    fn = m.graph.bind(cast_dtype=cast)
    for s in range(0, 20, 8):
        b = x[s:s + 8]
        pad = np.concatenate([b, np.zeros((8 - len(b), 3, 64, 64),
                                          np.float32)])
        xd = torch.from_numpy(pad).to(card, cast or torch.float32)
        want = fn(xd)[0][:len(b)].float().cpu().numpy()
        np.testing.assert_array_equal(got[s:s + len(b)], want)


def test_float32_and_bf16_executors_on_two_threads_stay_bitwise(card):
    """A float32 and a bf16 ``ONNXModel`` scoring at once on two threads
    (one dispatch thread each): each result bitwise its single-thread
    result, so no float32 run ever ran with TF32 on."""
    import threading

    from synapseml_tpu_torch.data.table import Table
    from synapseml_tpu_torch.onnx import ONNXModel, zoo

    blob = zoo.resnet50(num_classes=1000, image_size=32)
    x = np.random.default_rng(1).standard_normal(
        (64, 3, 32, 32)).astype(np.float32)
    table = Table({"data": x})
    models = {c: ONNXModel(model_bytes=blob, mini_batch_size=32,
                           compute_dtype=c) for c in ("float32", "bfloat16")}
    out = models["float32"].graph.output_names[0]
    alone = {c: m.transform(table)[out] for c, m in models.items()}
    saved = (torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32)
    results = {c: [] for c in models}
    errors = []

    def run(c):
        try:
            for _ in range(12):
                results[c].append(models[c].transform(table)[out])
        except BaseException as e:  # noqa: BLE001 - reported below
            errors.append(e)

    torch.backends.cudnn.allow_tf32 = True
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        threads = [threading.Thread(target=run, args=(c,)) for c in models]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=300)
        assert not any(t.is_alive() for t in threads)
        assert errors == []
        for c, rs in results.items():
            assert len(rs) == 12
            for r in rs:
                np.testing.assert_array_equal(r, alone[c])
        assert (torch.backends.cudnn.allow_tf32,
                torch.backends.cuda.matmul.allow_tf32) == (True, True)
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = saved


# -- warm programs: CUDA graphs captured per bucket at warmup() -----------

@pytest.mark.parametrize("slots", [2, 3])
def test_dp_slots_replay_concurrently_bitwise_their_one_slot_runs(card,
                                                                  slots):
    """Slots on the one card (``devices=["cuda:0"] * n``), each with its
    own graph, static buffers, pool and streams, replay at once through
    200 submits in flight together: 2 slots shard each 128-row batch (a
    64-row graph a slot), 3 run it whole round robin. Every output is
    bitwise its one-slot run: the same rows through a one-slot executor
    warmed at the slot's batch."""
    from synapseml_tpu_torch.runtime.executor import BatchedExecutor

    gen = torch.Generator().manual_seed(0)
    w1 = torch.randn(512, 2048, generator=gen) / 512 ** 0.5
    w2 = torch.randn(2048, 256, generator=gen) / 2048 ** 0.5

    def fn(p1, p2, x):
        return torch.tanh(x @ p1) @ p2, x.sum(1)

    rows = 128 // 2 if slots == 2 else 128
    multi = BatchedExecutor(fn, devices=[card] * slots, static_batch=128,
                            bound_args=(w1, w2))
    one = BatchedExecutor(fn, device=card, static_batch=rows,
                          bound_args=(w1, w2))
    try:
        rep = multi.warmup([((512,), np.float32)])
        assert rep.errors == [] and len(multi._aot) == slots
        assert one.warmup([((512,), np.float32)]).errors == []
        assert len({s.pool for s in multi._slots}) == slots
        assert len({s.streams for s in multi._slots}) == slots
        rng = np.random.default_rng(0)
        xs = [rng.standard_normal((int(rng.integers(1, 129)), 512)).astype(
            np.float32) for _ in range(200)]
        futs = [multi.submit(x) for x in xs]
        outs = [f.result(timeout=120) for f in futs]
        assert multi._aot_hits == 200
        for x, got in zip(xs, outs):
            pad = np.zeros((128, 512), np.float32)
            pad[:len(x)] = x
            parts = [one(pad[s0:s0 + rows]) for s0 in range(0, 128, rows)]
            for leaf, g in enumerate(got):
                want = np.concatenate([p[leaf] for p in parts])[:len(x)]
                np.testing.assert_array_equal(g, want)
    finally:
        multi.close()
        one.close()


@pytest.mark.parametrize("slots", [2, 3])
def test_dp_device_outputs_are_bitwise_their_one_slot_runs(card, slots):
    """``device_outputs`` over slots on the one card, warmed, 200 submits
    in flight: 2 slots join each bucket's slices, 3 clone each whole
    bucket's static outputs on the slot that replayed it. Every leaf is
    held to the end, past later replays of the same graphs, and is
    bitwise its one-slot run."""
    from synapseml_tpu_torch.runtime.executor import BatchedExecutor

    gen = torch.Generator().manual_seed(1)
    w1 = torch.randn(256, 1024, generator=gen) / 256 ** 0.5
    w2 = torch.randn(1024, 128, generator=gen) / 1024 ** 0.5

    def fn(p1, p2, x):
        h = torch.tanh(x @ p1)
        return h @ p2, h, x * 2.0

    rows = 128 // 2 if slots == 2 else 128
    multi = BatchedExecutor(fn, devices=[card] * slots, static_batch=128,
                            bound_args=(w1, w2), device_outputs=(1, 2))
    one = BatchedExecutor(fn, device=card, static_batch=rows,
                          bound_args=(w1, w2), device_outputs=(1, 2))
    try:
        assert multi.warmup([((256,), np.float32)]).errors == []
        assert one.warmup([((256,), np.float32)]).errors == []
        rng = np.random.default_rng(1)
        xs = [rng.standard_normal((int(rng.integers(1, 129)), 256)).astype(
            np.float32) for _ in range(200)]
        futs = [multi.submit(x) for x in xs]
        outs = [f.result(timeout=120) for f in futs]
        assert multi._aot_hits == 200
        torch.cuda.synchronize()
        for x, got in zip(xs, outs):
            pad = np.zeros((128, 256), np.float32)
            pad[:len(x)] = x
            parts = [one(pad[s0:s0 + rows]) for s0 in range(0, 128, rows)]
            np.testing.assert_array_equal(
                got[0], np.concatenate([p[0] for p in parts])[:len(x)])
            for leaf in (1, 2):
                assert got[leaf].is_cuda
                want = torch.cat([p[leaf] for p in parts])[:len(x)]
                assert torch.equal(got[leaf], want), leaf
    finally:
        multi.close()
        one.close()


def test_dp_warm_decode_over_three_slots_gives_the_one_slot_streams(card):
    """A warmed ``DecodeScheduler`` over three slots of the one card
    (max_batch 4, so every step runs whole on the next slot, its present
    buffers cloned there): the continuous batch's token streams equal
    the one-slot scheduler's, and no buffer moves between devices."""
    from synapseml_tpu_torch.onnx import import_model, zoo
    from synapseml_tpu_torch.runtime import telemetry as tm
    from synapseml_tpu_torch.runtime.decode import DecodeScheduler
    from synapseml_tpu_torch.runtime.kvcache import PagedKVCache

    sys.path.insert(0, FIXTURES)
    import decode_streams as decode_fx

    graph = import_model(zoo.tiny_decoder())
    batch = decode_fx.prompts(decode_fx.CONTINUOUS_LENS,
                              decode_fx.CONTINUOUS_SEED)
    moved = tm.counter("executor_cross_device_copies_total")
    res = {}
    for slots in (None, 3):
        kw = {} if slots is None else {"devices": [card] * slots}
        s = decode_fx.maker(DecodeScheduler, PagedKVCache, graph,
                            device="cuda", **kw)(
            f"t_cuda_dec_dp{slots}", capacity_bytes=10 ** 9)
        try:
            before = moved.value
            if slots is not None:
                assert s._ex._layout(s.B) == "rr"
            res[slots] = decode_fx.run_batch(s, batch, max_new=32)
            assert moved.value == before
        finally:
            s.close()
    assert res[3] == res[None] and all(t for t, _ in res[3])


def test_dp_devices_all_resolves_to_the_pinned_path(card):
    """On one card ``devices="all"`` and ``devices=1`` are the pinned
    one-device path, in the executor and through ``ONNXModel``."""
    from synapseml_tpu_torch.data.table import Table
    from synapseml_tpu_torch.onnx import ONNXModel, zoo
    from synapseml_tpu_torch.runtime.executor import BatchedExecutor

    count = torch.cuda.device_count()
    ex = BatchedExecutor(lambda x: (x * 2.0,), devices="all")
    try:
        assert ex.n_devices == count
        if count == 1:
            assert ex.devices is None and ex.device == card
            assert ex._layout(8) == "single" and ex.pipeline_depth == 2
        x = np.arange(24, dtype=np.float32).reshape(8, 3)
        np.testing.assert_array_equal(ex(x)[0], x * 2.0)
    finally:
        ex.close()
    blob = zoo.mlp([16, 32], num_classes=4, seed=0)
    feats = np.random.default_rng(0).standard_normal(
        (9, 16)).astype(np.float32)
    want = ONNXModel(model_bytes=blob).transform(Table({"input": feats}))
    for spec in ("all", 1):
        m = ONNXModel(model_bytes=blob, devices=spec)
        got = m.transform(Table({"input": feats}))
        assert m._executor("cuda").n_devices == (count if spec == "all"
                                                 else 1)
        for col in want.columns:
            np.testing.assert_array_equal(got[col], want[col])
        m._executor("cuda").close()


def _warm_resnet(compute, batch=8, image=64, **params):
    from synapseml_tpu_torch.onnx import ONNXModel, zoo

    m = ONNXModel(model_bytes=zoo.resnet50(num_classes=1000,
                                           image_size=image),
                  mini_batch_size=batch, compute_dtype=compute, **params)
    rep = m.warmup()
    assert rep.errors == [] and rep.compiled == len(rep.entries)
    return m


@pytest.mark.parametrize("compute", ["float32", "bfloat16"])
def test_replayed_bucket_is_bitwise_the_eager_bind(card, compute):
    """ResNet-50 at 64x64 warmed at mini_batch_size 8 (one graph), 20
    rows through ``transform``: every bucket a replay, each bitwise the
    port's eager ``bind()`` forward of the same padded batch."""
    from synapseml_tpu_torch.data.table import Table
    from synapseml_tpu_torch.runtime import telemetry as tm

    m = _warm_resnet(compute)
    x = np.random.default_rng(0).standard_normal(
        (20, 3, 64, 64)).astype(np.float32)
    tm.reset()
    got = m.transform(Table({"data": x}))[m.graph.output_names[0]]
    ex = m._executor("cuda")
    assert ex._aot_hits == 3
    assert tm.counter("executor_aot_misses_total").value == 0
    cast = torch.bfloat16 if compute == "bfloat16" else None
    fn = m.graph.bind(cast_dtype=cast)
    for s in range(0, 20, 8):
        b = x[s:s + 8]
        pad = np.concatenate([b, np.zeros((8 - len(b), 3, 64, 64),
                                          np.float32)])
        xd = torch.from_numpy(pad).to(card, cast or torch.float32)
        want = fn(xd)[0][:len(b)].float().cpu().numpy()
        np.testing.assert_array_equal(got[s:s + len(b)], want)
    ex.close()


def test_a_replay_issues_no_per_node_launches_from_python(card):
    """A warm dispatch dispatches one card-to-card copy an input from
    Python and replays the graph; the eager forward of the same batch
    dispatches hundreds of operations."""
    from torch.utils._python_dispatch import TorchDispatchMode

    class Count(TorchDispatchMode):
        n = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            Count.n += 1
            return func(*args, **(kwargs or {}))

    m = _warm_resnet("bfloat16", image=32)
    ex = m._executor("cuda")
    (warm,) = ex._aot.values()
    xd = torch.randn(8, 3, 32, 32, device=card, dtype=torch.bfloat16)
    with torch.inference_mode():
        with Count():
            ex._replay(warm, [xd])
        replayed, Count.n = Count.n, 0
        with Count():
            ex._fn(*ex._bound, xd)
        eager = Count.n
    torch.cuda.synchronize()
    assert replayed == 1, replayed
    assert eager > 200, eager
    ex.close()


@pytest.mark.parametrize("depth", [2, 3])
def test_pipelined_replays_give_every_batch_its_own_rows(card, depth):
    """Replay k+1 overwrites the static outputs replay k's copy out reads:
    with ``depth`` batches in flight and outputs of 8 MB, every batch
    still gets its own rows."""
    from synapseml_tpu_torch.runtime.executor import BatchedExecutor

    ex = BatchedExecutor(lambda x: (x * 2.0 + 1.0, x.sum(1)), min_bucket=8,
                         max_bucket=8, pipeline_depth=depth)
    try:
        rep = ex.warmup([((1 << 18,), np.float32)])
        assert rep.errors == [] and rep.compiled == 1
        xs = [np.full((8, 1 << 18), float(i), np.float32) for i in range(24)]
        outs = list(ex.stream(xs))
        for i, (y, s) in enumerate(outs):
            assert np.all(y == 2.0 * i + 1.0), i
            assert np.all(s == float(i) * (1 << 18)), i
        assert ex._aot_hits == 24
    finally:
        ex.close()


@pytest.mark.parametrize("depth", [2, 3])
def test_replays_of_two_buckets_give_every_batch_its_own_rows(card, depth):
    """The buckets' graphs share one memory pool: bucket 16's static
    output (16 MB) fits in the blocks bucket 8's capture used for its
    temporary (32 MB), so a bucket-8 replay may overwrite bucket 16's
    outputs. Each replay ends with a ~10 ms spin, so the host queues the
    next replay before the card is done and it starts as the previous
    batch's copy out does. Alternating 8- and 16-row batches with
    ``depth`` in flight must still each get their own rows."""
    from synapseml_tpu_torch.runtime.executor import BatchedExecutor

    def fn(x):
        t = x.repeat(1, 4) * 2.0
        out = t[:, :x.shape[1]] + 1.0
        torch.cuda._sleep(20_000_000)
        return (out,)

    ex = BatchedExecutor(fn, min_bucket=8, max_bucket=16,
                         pipeline_depth=depth)
    try:
        rep = ex.warmup([((1 << 18,), np.float32)], buckets=[8, 16])
        assert rep.errors == [] and rep.compiled == 2
        xs = [np.full((8 << (i % 2), 1 << 18), float(i), np.float32)
              for i in range(32)]
        outs = list(ex.stream(xs))
        for i, (y,) in enumerate(outs):
            assert y.shape == xs[i].shape, i
            assert np.all(y == 2.0 * i + 1.0), i
        assert ex._aot_hits == 32
    finally:
        ex.close()


def test_a_device_outputs_leaf_survives_the_next_replay(card):
    from synapseml_tpu_torch.runtime.executor import BatchedExecutor

    ex = BatchedExecutor(lambda x: (x * 3.0, x + 1.0), min_bucket=8,
                         max_bucket=8, device_outputs=[1])
    try:
        ex.warmup([((4,), np.float32)])
        a = np.full((8, 4), 1.0, np.float32)
        b = np.full((8, 4), 5.0, np.float32)
        host_a, dev_a = ex.submit(a).result(timeout=60)
        host_b, dev_b = ex.submit(b).result(timeout=60)
        torch.cuda.synchronize()
        assert dev_a.is_cuda and torch.equal(dev_a.cpu(),
                                             torch.from_numpy(a + 1.0))
        assert torch.equal(dev_b.cpu(), torch.from_numpy(b + 1.0))
        np.testing.assert_array_equal(host_a, a * 3.0)
        np.testing.assert_array_equal(host_b, b * 3.0)
        assert ex._aot_hits == 2
    finally:
        ex.close()


def test_warmup_while_another_thread_transforms(card):
    """``warmup()`` captures on the caller's thread while another thread's
    ``transform`` runs eagerly on the dispatch thread: every result stays
    the single-thread one, and later calls replay."""
    import threading

    from synapseml_tpu_torch.data.table import Table
    from synapseml_tpu_torch.onnx import ONNXModel, zoo

    m = ONNXModel(model_bytes=zoo.resnet50(num_classes=1000, image_size=32),
                  mini_batch_size=32, compute_dtype="bfloat16")
    x = np.random.default_rng(2).standard_normal(
        (64, 3, 32, 32)).astype(np.float32)
    table = Table({"data": x})
    out = m.graph.output_names[0]
    alone = m.transform(table)[out]
    results, errors, stop = [], [], threading.Event()

    def run():
        try:
            while not stop.is_set():
                results.append(m.transform(table)[out])
        except BaseException as e:  # noqa: BLE001 - reported below
            errors.append(e)

    t = threading.Thread(target=run)
    t.start()
    try:
        rep = m.warmup()
    finally:
        stop.set()
        t.join(timeout=300)
    assert not t.is_alive() and errors == []
    assert rep.errors == [] and rep.compiled == 3
    assert results
    for r in results:
        np.testing.assert_array_equal(r, alone)
    ex = m._executor("cuda")
    hits = ex._aot_hits
    np.testing.assert_array_equal(m.transform(table)[out], alone)
    assert ex._aot_hits == hits + 2
    ex.close()


def test_float32_capture_under_a_foreign_threads_tf32_replays_bitwise(card):
    """Another thread turns TF32 on and holds it while a float32 model is
    warmed and served: the capture ran inside ``_ieee_float32``, so every
    replay is bitwise the eager float32 forward (TF32 off), whatever the
    flags are at replay."""
    import threading

    from synapseml_tpu_torch.data.table import Table
    from synapseml_tpu_torch.onnx import ONNXModel, zoo

    m = ONNXModel(model_bytes=zoo.resnet50(num_classes=1000, image_size=32),
                  mini_batch_size=8)
    x = np.random.default_rng(3).standard_normal(
        (8, 3, 32, 32)).astype(np.float32)
    want = m.graph.bind()(torch.from_numpy(x).to(card))[0].cpu().numpy()
    saved = (torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32)
    on, done = threading.Event(), threading.Event()

    def foreign():
        torch.backends.cudnn.allow_tf32 = True
        torch.backends.cuda.matmul.allow_tf32 = True
        on.set()
        done.wait(timeout=300)

    t = threading.Thread(target=foreign)
    t.start()
    try:
        assert on.wait(timeout=60)
        rep = m.warmup()
        assert rep.errors == [] and rep.compiled == 1
        got = m.transform(Table({"data": x}))[m.graph.output_names[0]]
        assert (torch.backends.cudnn.allow_tf32,
                torch.backends.cuda.matmul.allow_tf32) == (True, True)
        assert m._executor("cuda")._aot_hits == 1
        np.testing.assert_array_equal(got, want)
    finally:
        done.set()
        t.join(timeout=60)
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = saved
        for ex in m._executor_cache.values():
            ex.close()


def test_a_forward_that_cannot_be_captured_reports_error_and_serves_eagerly(
        card):
    """A forward that reads a card value on the host (``.item()``, a sync)
    cannot be captured: warmup reports ``error`` and the executor serves
    the bucket eagerly, with the right rows."""
    from synapseml_tpu_torch.runtime.executor import BatchedExecutor

    def fn(x):
        return (x * float(x.abs().max().item() >= 0.0),)

    ex = BatchedExecutor(fn, min_bucket=8, max_bucket=8)
    try:
        rep = ex.warmup([((4,), np.float32)])
        assert [e["status"] for e in rep.entries] == ["error"]
        assert rep.errors
        x = np.arange(32, dtype=np.float32).reshape(8, 4)
        (y,) = ex.submit(x).result(timeout=60)
        np.testing.assert_array_equal(y, x)
        assert ex._aot_hits == 0
    finally:
        ex.close()


# -- the image stages, ImageFeaturizer and the explainers -------------------

def _uint8_images(shapes, seed=0):
    rng = np.random.default_rng(seed)
    col = np.empty(len(shapes), dtype=object)
    for i, shape in enumerate(shapes):
        col[i] = rng.integers(0, 256, shape).astype(np.uint8)
    return col


def test_image_transformer_on_the_card_equals_the_cpu(card):
    """Every stage over two shapes of image on the card within 1e-3 (0-255
    scale) of the CPU run; ``to_uint8`` equal but where the CPU float lies
    within 1e-3 of a half."""
    from synapseml_tpu_torch.data.table import Table
    from synapseml_tpu_torch.image import ImageTransformer, ops

    stages = ({"action": "resize", "height": 30, "width": 36},
              {"action": "centercrop", "height": 24, "width": 24},
              {"action": "flip", "flipCode": ops.FLIP_BOTH},
              {"action": "blur", "height": 4, "width": 3},
              {"action": "gaussiankernel", "apertureSize": 5, "sigma": 0.0},
              {"action": "threshold", "threshold": 180.0, "maxVal": 255.0,
               "type": ops.THRESH_TRUNC},
              {"action": "colorformat", "format": ops.COLOR_RGB2GRAY})
    table = Table({"image": _uint8_images([(40, 48, 3)] * 3
                                          + [(27, 31, 3)] * 2)})
    floats = ImageTransformer(input_col="image", output_col="o",
                              stages=stages)
    for a, b in zip(floats.transform(table, "cuda")["o"],
                    floats.transform(table, "cpu")["o"]):
        np.testing.assert_allclose(a, b, atol=1e-3, rtol=0)
    u8 = ImageTransformer(input_col="image", output_col="o", stages=stages,
                          to_uint8=True)
    for a, b, f in zip(u8.transform(table, "cuda")["o"],
                       u8.transform(table, "cpu")["o"],
                       floats.transform(table, "cpu")["o"]):
        tie = np.abs(f - np.floor(f) - 0.5) < 1e-3
        np.testing.assert_array_equal(a[~tie], b[~tie])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_featurizer_on_the_card_equals_the_cpu(card, dtype):
    """``zoo.tiny_resnet`` features (cut 1) of 40x36 images resized on the
    card: float32 within rtol = atol = 1e-4 of the CPU's, bf16 within 5%
    of the CPU float32's largest |value|."""
    from synapseml_tpu_torch.data.table import Table
    from synapseml_tpu_torch.image import ImageFeaturizer
    from synapseml_tpu_torch.onnx import zoo

    feat = ImageFeaturizer(model_bytes=zoo.tiny_resnet(image_size=32),
                           image_size=32, input_col="image",
                           output_col="f", compute_dtype=dtype,
                           mini_batch_size=16)
    table = Table({"image": _uint8_images([(40, 36, 3)] * 19
                                          + [(32, 32, 1)])})
    got = feat.transform(table, "cuda")["f"]
    ref = feat.copy(compute_dtype="float32").transform(table, "cpu")["f"]
    assert got.shape == (20, 64) and got.dtype == np.float32
    if dtype == "float32":
        np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-4)
    else:
        assert _bf16_rule(got, ref)


def test_featurizer_warm_buckets_are_bitwise_eager_on_the_card(card):
    """After ``warmup()`` (buckets 8 and 16 captured as CUDA graphs)
    tables of 8, 16 and 21 rows score bitwise as before it, replayed."""
    from synapseml_tpu_torch.data.table import Table
    from synapseml_tpu_torch.image import ImageFeaturizer
    from synapseml_tpu_torch.onnx import zoo

    feat = ImageFeaturizer(model_bytes=zoo.tiny_resnet(image_size=32),
                           image_size=32, input_col="image",
                           mini_batch_size=16)
    tables = [Table({"image": _uint8_images([(32, 32, 3)] * n, seed=n)})
              for n in (8, 16, 21)]
    eager = [feat.transform(t, "cuda")[feat.output_col] for t in tables]
    report = feat.warmup(device="cuda")
    assert [e["status"] for e in report.entries] == ["compiled"] * 2
    ex = feat._pieces("cuda")
    hits = ex._aot_hits
    for t, want in zip(tables, eager):
        np.testing.assert_array_equal(
            feat.transform(t, "cuda")[feat.output_col], want)
    assert ex._aot_hits - hits == 4


def test_superpixels_on_the_card_equal_the_fixture_but_at_ties(card):
    """The 224x224 crops of ``image_explainer_fixtures.npz``: the card's
    superpixels equal the JAX package's except at the pixels its centers
    place within 1e-5 of a tie (stored in the fixture)."""
    import os
    import sys

    from synapseml_tpu_torch.explainers import superpixels

    fixtures = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                            "fixtures")
    sys.path.insert(0, fixtures)
    import make_image_explainer_fixtures as imfx

    fx = np.load(os.path.join(fixtures, "image_explainer_fixtures.npz"))
    for i in range(2):
        sp = superpixels(imfx.center_crop(fx["images"][i]), imfx.CELL,
                         device="cuda")
        ties = fx["superpixel_ties"][i]
        assert sp.num_clusters == int(fx["superpixels"][i].max()) + 1
        np.testing.assert_array_equal(sp.assignment[~ties],
                                      fx["superpixels"][i][~ties])


def _solver_inputs(monkeypatch):
    """Record the inputs the explainers hand their surrogate solvers."""
    import synapseml_tpu_torch.explainers.local as local

    calls = []
    for name in ("weighted_least_squares", "weighted_lasso",
                 "shap_weighted_fit"):
        fn = getattr(local, name)

        def record(*args, _fn=fn, _name=name):
            calls.append((_name, [a.cpu().numpy()
                                  if isinstance(a, torch.Tensor) else a
                                  for a in args]))
            return _fn(*args)
        monkeypatch.setattr(local, name, record)
    return calls


def _cond(name, x, w):
    x, w = x.astype(np.float64), w.astype(np.float64)
    if name == "shap_weighted_fit":
        x = x[..., :-1] - x[..., -1:]
        return np.linalg.cond(np.swapaxes(x, -1, -2) @ (x * w[..., None])
                              + 1e-8 * np.eye(x.shape[-1]))
    w = w / w.sum(-1, keepdims=True)
    x = x - (x * w[..., None]).sum(-2, keepdims=True)
    if name == "weighted_lasso":
        x = x / (np.sqrt((x * x * w[..., None]).sum(-2, keepdims=True))
                 + 1e-12)
        return np.linalg.cond(np.swapaxes(x, -1, -2) @ (x * w[..., None]))
    return np.linalg.cond(np.swapaxes(x, -1, -2) @ (x * w[..., None])
                          + 1e-6 * np.eye(x.shape[-1]))


@pytest.mark.parametrize("name", ["VectorLIME", "VectorSHAP", "TabularLIME",
                                  "TabularSHAP", "TextLIME", "TextSHAP",
                                  "ImageLIME", "ImageSHAP"])
def test_explainers_on_the_card_equal_the_cpu(card, name, monkeypatch):
    """Each explainer over a numpy scorer on the card and on the CPU: the
    same solver inputs, bitwise; coefficients within S · cond(A) · eps32 ·
    max|coef| a row where S >= 2 D, else (ImageLIME, 64 superpixels, 50
    samples) the fitted values within 1e-4 of their largest magnitude."""
    from synapseml_tpu_torch.core.pipeline import Transformer
    from synapseml_tpu_torch.data.table import Table
    from synapseml_tpu_torch.explainers import local

    rng = np.random.default_rng(0)

    class Scorer(Transformer):
        def _transform(self, table, device):
            if "image" in table:
                p = [[float(np.mean(im)), float(np.mean(im[..., 0] ** 2))]
                     for im in table["image"]]
            elif "text" in table:
                p = [["good" in str(t).split(), 0.1 * len(str(t).split())]
                     for t in table["text"]]
            elif "features" in table:
                x = np.asarray(table["features"], np.float32)
                p = np.column_stack([x @ np.float32([2, -1, 0.5]),
                                     np.tanh(x[:, 0])])
            else:
                a, b = (np.asarray(table[c], np.float32) for c in "ab")
                p = np.column_stack([2 * a - b, a * b])
            return table.with_column("probability", np.asarray(p, np.float32))

    kind = name[:-4]
    tables = {
        "Vector": Table({"features": rng.normal(size=(6, 3))
                         .astype(np.float32)}),
        "Tabular": Table({"a": rng.normal(size=5), "b": rng.normal(size=5)}),
        "Text": Table({"text": np.array(["good movie plot", "bad plot twist",
                                         "fine"], dtype=object)}),
        "Image": Table({"image": np.array(
            [rng.random((32, 32, 3)).astype(np.float32)], dtype=object)}),
    }
    params = {"Vector": dict(input_col="features"),
              "Tabular": dict(input_cols=["a", "b"]),
              "Text": dict(input_col="text"),
              "Image": dict(input_col="image", cell_size=4.0)}[kind]
    ex = getattr(local, name)(model=Scorer(), target_col="probability",
                              target_classes=(0, 1), seed=1, **params)
    calls = _solver_inputs(monkeypatch)
    got = np.asarray(ex.transform(tables[kind], "cuda")["output"])
    on_card = list(calls)
    calls.clear()
    out = ex.transform(tables[kind], "cpu")
    want = np.asarray(out["output"])
    assert got.shape == want.shape
    assert [n for n, _ in on_card] == [n for n, _ in calls]
    for (_, a), (_, b) in zip(on_card, calls):
        for u, v in zip(a, b):
            np.testing.assert_array_equal(u, v)
    eps = np.finfo(np.float32).eps
    if name.endswith("LIME"):
        for ki, (fn, (x, y, w, *_)) in enumerate(calls):
            s, d = x.shape[-2:]
            g, r = got[:, ki, :d], want[:, ki, :d]
            if s >= 2 * d:
                tol = s * _cond(fn, x, w) * eps * np.abs(r).max(-1)
                assert (np.abs(g - r).max(-1) <= tol).all()
            else:
                wn = w / w.sum(-1, keepdims=True)
                xc = x - (x * wn[..., None]).sum(-2, keepdims=True)
                fit_r = (xc @ r[..., None])[..., 0]
                np.testing.assert_allclose(
                    (xc @ g[..., None])[..., 0], fit_r, rtol=0,
                    atol=1e-4 * np.abs(fit_r).max())
        return
    # SHAP: one call a (feature count, class), as the reference groups
    if kind == "Text":
        ds = np.array([max(len(t), 1) for t in out["tokens"]])
    elif kind == "Image":
        ds = np.array([int(sp.max()) + 1 for sp in out["superpixels"]])
    else:
        ds = np.full(got.shape[0], got.shape[-1] - 1)
    it = iter(calls)
    for dv in np.unique(ds):
        idx = np.flatnonzero(ds == dv)
        for ki in range(got.shape[1]):
            fn, (z, y, w, fnull, fx) = next(it)
            g, r = got[idx, ki, :dv + 1], want[idx, ki, :dv + 1]
            if dv > 1:
                tol = z.shape[-2] * _cond(fn, z, w) * eps * np.abs(r).max(-1)
                assert (np.abs(g - r).max(-1) <= tol).all()
            else:
                np.testing.assert_array_equal(g, r)
            np.testing.assert_allclose(g[:, 1:].sum(1), fx - fnull,
                                       atol=1e-4)


def test_tabular_shap_over_adult_launches_k2_on_the_card(card, monkeypatch):
    """TabularSHAP over the Adult fixture model scores its 32 x 50
    perturbed rows through the forest-traversal kernel in one call, and
    agrees with the CPU run within S · cond(A) · eps32 · max|phi| a row;
    its phis add up to f(all-on coalition) - f(null) within 1e-4."""
    import os

    from synapseml_tpu_torch.data.table import Table
    from synapseml_tpu_torch.explainers import TabularSHAP
    from synapseml_tpu_torch.gbdt.estimators import \
        LightGBMClassificationModel

    fixtures = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                            "fixtures")
    cols = [f"f{j}" for j in range(14)]
    model = LightGBMClassificationModel.load_native_model(
        os.path.join(fixtures, "lgbm_adult_100x31.txt"), feature_cols=cols)
    x = np.load(os.path.join(fixtures, "lgbm_adult_100x31_io.npz"))["x"][:32]
    table = Table({c: x[:, j].astype(np.float64) for j, c in enumerate(cols)})
    ex = TabularSHAP(model=model, input_cols=cols, target_col="probability",
                     target_classes=(1,), num_samples=50, seed=0)
    calls = _solver_inputs(monkeypatch)
    kernels.forest_traverse.launches = 0
    got = np.asarray(ex.transform(table, "cuda")["output"])[:, 0]
    assert kernels.forest_traverse.launches >= 1
    want = np.asarray(ex.transform(table, "cpu")["output"])[:, 0]
    (_, (z, y, w, fnull, fx)), (_, cpu_args) = calls
    np.testing.assert_array_equal(z, cpu_args[0])
    cond = _cond("shap_weighted_fit", z, w)
    tol = 50 * cond * np.finfo(np.float32).eps * np.abs(want).max(-1)
    assert (np.abs(got - want).max(-1) <= tol).all()
    np.testing.assert_allclose(got[:, 1:].sum(1), fx - fnull, atol=1e-4)


# -- control flow and CNTKModel --------------------------------------------

def _fixture_module(name):
    import importlib
    import os
    import sys

    sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(
        __file__)), "fixtures"))
    return importlib.import_module(name)


def test_warm_scan_buckets_are_bitwise_eager(card):
    """The CNTK 202 tagger at a small width over 24 tokens (two Scans of
    24 steps) through ``CNTKModel``: every bucket of ``warmup()`` is
    captured (a step copies nothing to the card and reads nothing back),
    each replayed bucket is bitwise the eager one, and both hold the numpy
    LSTM loop within rtol=atol=1e-4."""
    from synapseml_tpu_torch.data.table import Table
    from synapseml_tpu_torch.dl import cntk_format
    from synapseml_tpu_torch.dl.cntk import CNTKModel

    tagger = _fixture_module("make_cntk_tagger_fixture")
    kw = dict(vocab=50, embed=16, hidden=16, labels=8, seed=1)
    blob = tagger.build(cntk_format, **kw)
    ids = tagger.tokens(20, 24, kw["vocab"], seed=5)
    x = tagger.one_hot(ids, kw["vocab"])

    def model():
        m = CNTKModel(model_bytes=blob, mini_batch_size=16)
        m.set(feed_dict={m.graph.input_names[0]: "q"})
        return m

    eager = model()
    out = eager.graph.output_names[0]
    want = eager.transform(Table({"q": x}))[out]
    warm = model()
    rep = warm.warmup(example_feeds={warm.graph.input_names[0]: x[:1]})
    assert rep.errors == []
    assert [e["status"] for e in rep.entries] == ["compiled", "compiled"]
    got = warm.transform(Table({"q": x}))[out]
    assert warm._executor("cuda")._aot_hits == 2
    np.testing.assert_array_equal(got, want)
    np.testing.assert_allclose(
        got, tagger.reference(ids, tagger.weights(**kw)), rtol=1e-4,
        atol=1e-4)


@pytest.mark.parametrize("name", ["if_on_device", "loop_on_host"])
def test_warm_if_and_host_loop_are_bitwise_eager(card, name):
    """An ``If`` on a device condition (both branches, a select) and a
    host-trip ``Loop`` with a scan output capture and replay bitwise."""
    from synapseml_tpu_torch.data.table import Table
    from synapseml_tpu_torch.onnx import ONNXModel

    cfg = _fixture_module("control_flow_graphs")
    blob = getattr(cfg, name)()
    x = cfg.rows(20, seed=3)
    eager = ONNXModel(model_bytes=blob, mini_batch_size=16)
    warm = ONNXModel(model_bytes=blob, mini_batch_size=16)
    rep = warm.warmup()
    assert rep.errors == [] and rep.compiled == 2
    a = eager.transform(Table({"x": x}))
    b = warm.transform(Table({"x": x}))
    for col in eager.graph.output_names:
        np.testing.assert_array_equal(b[col], a[col])


def test_a_failed_loop_capture_leaves_the_executor_usable(card):
    """Below 16 rows the graph runs a ``Loop`` whose condition the body
    computes on the card: bucket 8 cannot be captured and its warmup
    entry says so, while buckets 16 and 32 of the same executor (same
    graph pool) capture after it; bucket 8 serves eagerly and right, the
    others replay bitwise a fresh eager model's buckets."""
    from synapseml_tpu_torch.data.table import Table
    from synapseml_tpu_torch.onnx import ONNXModel

    cfg = _fixture_module("control_flow_graphs")
    blob = cfg.loop_on_device_below(16)
    m = ONNXModel(model_bytes=blob, mini_batch_size=32)
    rep = m.warmup()
    assert [e["status"] for e in rep.entries] == ["error", "compiled",
                                                  "compiled"]
    assert len(rep.errors) == 1 and rep.errors[0].startswith("bucket=8")
    assert "cannot be captured" in rep.errors[0]
    x8 = cfg.rows(8, seed=1)
    np.testing.assert_array_equal(m.transform(Table({"x": x8}))["y"],
                                  cfg.loop_on_device_reference(x8))
    x = cfg.rows(48, seed=2)      # buckets 32 and 16
    eager = ONNXModel(model_bytes=blob, mini_batch_size=32)
    np.testing.assert_array_equal(m.transform(Table({"x": x}))["y"],
                                  eager.transform(Table({"x": x}))["y"])
    assert m._executor("cuda")._aot_hits == 2


# -- serving on the card: the front end over the card's scorers ------------

def _serve(cs, bodies, clients=8):
    """POST every body to ``cs`` from ``clients`` threads, each on its own
    keep-alive connection; returns ``[(status, body bytes, digest)]`` in
    the bodies' order."""
    import http.client
    import threading

    out = [None] * len(bodies)

    def client(k):
        conn = http.client.HTTPConnection("127.0.0.1", cs.server.port,
                                          timeout=120)
        for i in range(k, len(bodies), clients):
            conn.request("POST", "/", bodies[i],
                         {"Content-Type": "application/json"})
            resp = conn.getresponse()
            out[i] = (resp.status, resp.read(),
                      resp.getheader("X-Output-Digest"))
        conn.close()

    threads = [threading.Thread(target=client, args=(k,))
               for k in range(clients)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=300)
    assert not any(t.is_alive() for t in threads)
    return out


def test_served_k2_margins_bitwise_the_cpu(card):
    """A ``ContinuousServer`` scoring the Adult fixture model on the card:
    every served margin bitwise the CPU transform's and the fixture's,
    every digest the sha256 of its body, K2 launched."""
    import hashlib
    import json
    import os

    from synapseml_tpu_torch.data.table import Table
    from synapseml_tpu_torch.gbdt.estimators import (
        LightGBMClassificationModel)
    from synapseml_tpu_torch.io import serving

    fx = os.path.join(os.path.dirname(os.path.abspath(__file__)), "fixtures")
    model = LightGBMClassificationModel.load_native_model(
        os.path.join(fx, "lgbm_adult_100x31.txt"))
    io = np.load(os.path.join(fx, "lgbm_adult_100x31_io.npz"))
    x = io["x"][:256]

    def pipeline(table):
        feats = np.asarray([v["features"] for v in table["value"]],
                           np.float32)
        raw = model.transform(Table({"features": feats}),
                              device="cuda")["rawPrediction"]
        replies = np.empty(table.num_rows, dtype=object)
        for i in range(table.num_rows):
            replies[i] = serving.make_reply(
                {"rawPrediction": raw[i].tolist()})
        return table.with_column("reply", replies)

    before = kernels.forest_traverse.launches
    cs = serving.ContinuousServer("cuda_k2", pipeline, max_batch=64).start()
    try:
        got = _serve(cs, [json.dumps({"features": r.tolist()}).encode()
                          for r in x])
    finally:
        cs.stop()
    assert kernels.forest_traverse.launches > before
    cpu = model.transform(Table({"features": x}),
                          device="cpu")["rawPrediction"][:, 1]
    for (status, body, digest), want, fixture in zip(got, cpu, io["raw"]):
        assert status == 200 and digest == hashlib.sha256(body).hexdigest()
        margin = np.float32(json.loads(body)["rawPrediction"][1])
        assert margin == want == fixture


def test_served_onnx_reply_bitwise_its_transform(card, tmp_path):
    """The entry's ``_model_pipeline`` on the card: a served reply bitwise
    the in-process ``ONNXModel.transform`` of the same row (bucket 8)."""
    import json

    from synapseml_tpu_torch.data.table import Table
    from synapseml_tpu_torch.io import serving
    from synapseml_tpu_torch.onnx import ONNXModel, zoo

    blob = zoo.resnet50(num_classes=1000, image_size=32)
    path = tmp_path / "r50.onnx"
    path.write_bytes(blob)
    pipeline, model = serving._model_pipeline(str(path), device="cuda")
    assert model.warmup(buckets=[8]).compiled == 1
    x = np.random.default_rng(3).standard_normal(
        (6, 3, 32, 32)).astype(np.float32)
    cs = serving.ContinuousServer("cuda_onnx", pipeline, max_batch=1).start()
    try:
        got = _serve(cs, [json.dumps({"features": r.tolist()}).encode()
                          for r in x], clients=1)
    finally:
        cs.stop()
        serving._release_model(model)
    direct = ONNXModel(model_bytes=blob)
    out = direct.graph.output_names[0]
    for i, (status, body, _) in enumerate(got):
        assert status == 200
        want = direct.transform(Table({"data": x[i:i + 1]}))[out][0]
        np.testing.assert_array_equal(
            np.asarray(json.loads(body)["output"], np.float32), want)


def test_float32_and_bf16_servers_on_two_threads_stay_bitwise(card):
    """Two ``ContinuousServer``s in one process, over a float32 and a
    bf16 ``ONNXModel``, served at once with TF32 switched on globally:
    every reply bitwise its model's ``bind()`` forward of the padded
    bucket-8 batch."""
    import json
    import threading

    from synapseml_tpu_torch.data.table import Table
    from synapseml_tpu_torch.io import serving
    from synapseml_tpu_torch.onnx import ONNXModel, zoo

    blob = zoo.resnet50(num_classes=1000, image_size=32)
    x = np.random.default_rng(4).standard_normal(
        (12, 3, 32, 32)).astype(np.float32)
    bodies = [json.dumps({"features": r.tolist()}).encode() for r in x]
    want, servers = {}, {}
    for c in ("float32", "bfloat16"):
        m = ONNXModel(model_bytes=blob, mini_batch_size=8, compute_dtype=c)
        cast = torch.bfloat16 if c == "bfloat16" else None
        fn = m.graph.bind(cast_dtype=cast)
        pad = np.zeros((8, 3, 32, 32), np.float32)
        rows = []
        for r in x:
            pad[0] = r
            xd = torch.from_numpy(pad).to(card, cast or torch.float32)
            rows.append(fn(xd)[0][0].float().cpu().numpy())
        want[c] = rows
        out = m.graph.output_names[0]

        def pipeline(table, m=m, out=out):
            feats = np.stack([np.asarray(v["features"], np.float32)
                              for v in table["value"]])
            res = m.transform(Table({"data": feats}))[out]
            replies = np.empty(table.num_rows, dtype=object)
            for i in range(table.num_rows):
                replies[i] = serving.make_reply(
                    {"output": np.asarray(res[i], np.float32).tolist()})
            return table.with_column("reply", replies)

        servers[c] = serving.ContinuousServer(f"cuda_two_{c}", pipeline,
                                              max_batch=1).start()
    saved = (torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = True
    torch.backends.cuda.matmul.allow_tf32 = True
    results = {}
    try:
        threads = [threading.Thread(
            target=lambda c=c: results.__setitem__(
                c, _serve(servers[c], bodies * 2, clients=1)))
            for c in servers]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=300)
        assert not any(t.is_alive() for t in threads)
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = saved
        for cs in servers.values():
            cs.stop()
    for c, got in results.items():
        for i, (status, body, _) in enumerate(got):
            assert status == 200
            np.testing.assert_array_equal(
                np.asarray(json.loads(body)["output"], np.float32),
                want[c][i % len(x)])


def test_drain_on_the_card_replies_to_every_admitted_request(card):
    """Drain while 16 clients keep sending to a card-scoring server: every
    request gets a terminal reply (200 before the gate, 503 after), and
    the server's admitted count equals its replied count."""
    import http.client
    import json
    import threading
    import time

    from synapseml_tpu_torch.data.table import Table
    from synapseml_tpu_torch.io import serving
    from synapseml_tpu_torch.onnx import ONNXModel, zoo
    from synapseml_tpu_torch.runtime import telemetry as tm

    m = ONNXModel(model_bytes=zoo.resnet50(num_classes=1000, image_size=32),
                  mini_batch_size=16)
    out = m.graph.output_names[0]

    def pipeline(table):
        feats = np.stack([np.asarray(v["features"], np.float32)
                          for v in table["value"]])
        res = m.transform(Table({"data": feats}))[out]
        replies = np.empty(table.num_rows, dtype=object)
        for i in range(table.num_rows):
            replies[i] = serving.make_reply({"argmax": int(res[i].argmax())})
        return table.with_column("reply", replies)

    body = json.dumps({"features": np.zeros((3, 32, 32)).tolist()}).encode()
    cs = serving.ContinuousServer("cuda_drain", pipeline).start()
    statuses, stop = [], threading.Event()
    lock = threading.Lock()

    def client():
        conn = http.client.HTTPConnection("127.0.0.1", cs.server.port,
                                          timeout=120)
        while not stop.is_set():
            conn.request("POST", "/", body)
            resp = conn.getresponse()
            resp.read()
            with lock:
                statuses.append(resp.status)
            if resp.status != 200:
                break
        conn.close()

    threads = [threading.Thread(target=client) for _ in range(16)]
    try:
        for t in threads:
            t.start()
        time.sleep(2.0)
        assert cs.drain(timeout_ms=30_000) is True
        stop.set()
        for t in threads:
            t.join(timeout=120)
        assert not any(t.is_alive() for t in threads)
    finally:
        cs.stop()
    assert statuses.count(200) > 16 and set(statuses) <= {200, 503}
    counters = tm.snapshot()["counters"]
    admitted = counters['synapseml_serving_requests_total{server="cuda_drain"}']
    replied = sum(v for k, v in counters.items()
                  if k.startswith("synapseml_serving_replies_total")
                  and 'server="cuda_drain"' in k)
    assert admitted == replied == len(statuses)


# -- the ai.onnx.ml ops: a converted LightGBM model on the card -------------

def _adult_converted():
    import os

    from synapseml_tpu_torch.gbdt.boosting import Booster
    from synapseml_tpu_torch.onnx import convert_lightgbm

    here = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "fixtures")
    with open(os.path.join(here, "lgbm_adult_100x31.txt")) as fh:
        booster = Booster.load_string(fh.read())
    io = np.load(os.path.join(here, "lgbm_adult_100x31_io.npz"))
    fx = np.load(os.path.join(here, "lgbm_adult_100x31_onnx.npz"))
    return booster, convert_lightgbm(booster), io["x"], fx


def test_warm_tree_ensemble_buckets_are_bitwise_eager_with_no_host_copy(
        card):
    """The converted Adult model (100 trees, 31 leaves) through
    ``ONNXModel(mini_batch_size=32)``: every bucket of ``warmup()`` is
    captured with no host-to-card copy (the tree tables were bound at
    ``bind``), each replayed bucket bitwise the eager one."""
    from torch.utils._python_dispatch import TorchDispatchMode

    from synapseml_tpu_torch.data.table import Table
    from synapseml_tpu_torch.onnx import ONNXModel

    class H2D(TorchDispatchMode):
        n = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            if func.overloadpacket.__name__ in ("to", "_to_copy", "copy_",
                                                "_copy_from"):
                src = args[1] if func.overloadpacket.__name__ == "copy_" \
                    else args[0]
                dst = out if isinstance(out, torch.Tensor) else args[0]
                if (src.device.type, dst.device.type) == ("cpu", "cuda"):
                    H2D.n += 1
            return out

    _, blob, x, _ = _adult_converted()
    kw = dict(feed_dict={"input": "features"}, mini_batch_size=32)
    eager = ONNXModel(model_bytes=blob, **kw)
    want = eager.transform(Table({"features": x[:100]}))
    warm = ONNXModel(model_bytes=blob, **kw)
    ex = warm._executor("cuda")
    capture = ex._capture

    def counted(*args):
        with H2D():
            return capture(*args)
    ex._capture = counted
    rep = warm.warmup()
    assert rep.errors == [] and rep.compiled == len(rep.entries) == 3
    assert H2D.n == 0
    got = warm.transform(Table({"features": x[:100]}))
    assert ex._aot_hits == 4                      # 3 x 32 + 4 (bucket 8)
    for col in ("label", "probabilities"):
        np.testing.assert_array_equal(got[col], want[col])


def test_converted_probabilities_within_1e5_of_booster_predict(card):
    """The 1,024 Adult fixture rows: probabilities within 1e-5 of the
    port's ``Booster.predict`` on the card (K2) and of the JAX package's
    ONNX path (``lgbm_adult_100x31_onnx.npz``), labels equal to both; no
    kernel of the port runs inside the ONNX ``transform``."""
    from synapseml_tpu_torch.data.table import Table
    from synapseml_tpu_torch.onnx import ONNXModel

    booster, blob, x, fx = _adult_converted()
    kernels.forest_traverse.launches = kernels.histogram.launches = 0
    out = ONNXModel(model_bytes=blob, feed_dict={"input": "features"}
                    ).transform(Table({"features": x}))
    assert kernels.forest_traverse.launches == kernels.histogram.launches \
        == 0
    want = booster.predict(x)
    assert kernels.forest_traverse.launches == 1
    probs = out["probabilities"]
    assert out["label"].dtype == np.int64 and probs.dtype == np.float32
    np.testing.assert_allclose(probs[:, 1], want, rtol=0, atol=1e-5)
    np.testing.assert_allclose(probs, fx["probabilities"], rtol=0, atol=1e-5)
    np.testing.assert_array_equal(out["label"], (want > 0.5).astype(int))
    np.testing.assert_array_equal(out["label"], fx["label"])


def test_resnet50_padded_bucket_matches_unpadded(card):
    """``entry()``'s 8 images at batch 8 and padded into bucket 16, through
    ``bind()`` and ``ONNXModel(mini_batch_size=16)`` eager and warm: each
    replay bitwise its eager bucket, and every route within the float32
    gate (rtol=atol=1e-3) of the JAX fixture. The gap between the batch-8
    and the padded batch-16 forwards is what served rows see when they
    share a bucket with other requests."""
    import os

    from synapseml_tpu_torch.data.table import Table
    from synapseml_tpu_torch.onnx import ONNXModel, import_model, zoo

    resnet_fx = _fixture_module("make_resnet50_fixture")
    blob = zoo.resnet50(num_classes=1000, image_size=224, seed=0)
    imgs = resnet_fx.images()
    want = np.load(os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "fixtures", "resnet50_224_logits.npz"))[
        "logits_f32"]
    fn = import_model(blob).bind()
    x8 = torch.from_numpy(imgs).to(card)
    bind8 = fn(x8)[0].cpu().numpy()
    bind16 = fn(torch.cat([x8, torch.zeros_like(x8)]))[0][:8].cpu().numpy()
    eager = ONNXModel(model_bytes=blob, mini_batch_size=16)
    warm = ONNXModel(model_bytes=blob, mini_batch_size=16)
    rep = warm.warmup()
    assert rep.errors == [] and rep.compiled == 2
    name = eager.graph.input_names[0]
    out = eager.graph.output_names[0]
    padded = np.concatenate([imgs, np.zeros_like(imgs)])
    routes = {"bind8": bind8, "bind16": bind16}
    for label, m in (("eager", eager), ("warm", warm)):
        routes[f"{label}8"] = m.transform(Table({name: imgs}))[out]
        routes[f"{label}16"] = m.transform(Table({name: padded}))[out][:8]
    np.testing.assert_array_equal(routes["warm8"], routes["eager8"])
    np.testing.assert_array_equal(routes["warm16"], routes["eager16"])
    for label, got in routes.items():
        np.testing.assert_allclose(got, want, rtol=1e-3, atol=1e-3,
                                   err_msg=label)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_tagger_on_the_card_holds_to_the_jax_fixture(card, dtype):
    """The sequence tagger at its default width on the card against
    ``tests/fixtures/tagger_io.npz`` (the JAX package on the CPU): the
    dense and ring forwards of 2 x 512 tokens (float32 within
    rtol=atol=1e-3, bf16 within an RMS gap of 5% of the RMS logit: the
    reference's own bf16 paths differ by up to 11.5% of the largest
    |logit| at one token), then three AdamW steps of its 2 x 128 batch
    (float32 losses and first-step gradient norms within rtol 1e-4; bf16
    within 5%)."""
    import os

    from synapseml_tpu_torch.dl import tagger
    from synapseml_tpu_torch.parallel.mesh import single_device_mesh

    fx = np.load(os.path.join(os.path.dirname(os.path.abspath(__file__)),
                              "fixtures", "tagger_io.npz"))
    cfg = tagger.TaggerConfig(dtype=getattr(torch, dtype))
    p0 = tagger.init_params(cfg, int(fx["seed"]))
    params = tagger.params_from_numpy(p0, card)
    for path, mesh in (("dense", None), ("ring", single_device_mesh())):
        with torch.no_grad():
            logits, aux = tagger.make_apply(cfg, mesh, card)(params,
                                                             fx["tokens"])
        got = logits.cpu().numpy()
        want = fx[f"logits_{dtype}_{path}"]
        if dtype == "float32":
            np.testing.assert_allclose(got, want, rtol=1e-3, atol=1e-3)
            np.testing.assert_allclose(float(aux), fx[f"aux_{dtype}_{path}"],
                                       rtol=1e-4)
        else:
            rms = np.sqrt(((got - want) ** 2).mean() / (want ** 2).mean())
            assert rms <= 0.05, rms
            np.testing.assert_allclose(float(aux), fx[f"aux_{dtype}_{path}"],
                                       rtol=0.05)
    step, init_state, place = tagger.make_train_step(
        cfg, learning_rate=float(fx["lr"]), device=card)
    params, opt = init_state(int(fx["seed"]))
    batch = [place(fx[k]) for k in ("train_tokens", "train_labels",
                                    "train_mask")]
    losses, norms = [], None
    for _ in range(3):
        params, opt, loss = step(params, opt, *batch)
        losses.append(float(loss))
        if norms is None:
            named = dict(params.named_parameters())
            norms = [float(torch.linalg.vector_norm(named[str(n)].grad
                                                    .double()))
                     for n in fx["leaf_names"]]
    tol = 1e-4 if dtype == "float32" else 0.05
    np.testing.assert_allclose(losses, fx[f"losses_{dtype}"], rtol=tol)
    np.testing.assert_allclose(norms, fx[f"grad_norm_{dtype}"], rtol=tol)


def test_sequence_parallel_attention_on_two_ranks_sharing_the_card(
        card, tmp_path):
    """Ring (causal) and Ulysses attention over two gloo ranks sharing the
    card (``{"sp": 2}``, B = 2, S = 512, H = 4, D = 16, float32): the
    gathered outputs and the gradients of ``(out ** 2).sum()`` within
    rtol = atol = 2e-4 of dense attention on the card (the reference's
    tolerance), K/V rotated once each way, the exchanges staged through
    host memory for the gloo group."""
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from torch_dp_worker import run_ranks
    from torch_sp_cases import gather

    from synapseml_tpu_torch.parallel.ring_attention import dense_attention

    rng = np.random.default_rng(9)
    shape = (2, 512, 4, 16)
    q, k, v = (rng.standard_normal(shape).astype(np.float32)
               for _ in range(3))
    legs = (("ring", True), ("ulysses", False))
    cases = [{"name": kind, "kind": "call", "fn": "torch_sp_cases:attention",
              "args": [[kind, {"sp": 2}, causal, q, k, v, "float32",
                        "cuda"]] * 2} for kind, causal in legs]
    res = run_ranks(str(tmp_path), 2, cases, timeout=300, threads=2)
    for kind, causal in legs:
        per_rank = [r[kind] for r in res]
        assert all("error" not in r for r in per_rank), per_rank
        blocks = [torch.tensor(a, device=card).requires_grad_()
                  for a in (q, k, v)]
        want = dense_attention(*blocks, causal=causal)
        (want ** 2).sum().backward()
        for i, w in enumerate([want] + [b.grad for b in blocks]):
            got = gather(per_rank, "out" if i == 0 else "grads",
                                 ("dp", "sp"), shape,
                                 None if i == 0 else i - 1)
            np.testing.assert_allclose(got, w.detach().cpu().numpy(),
                                       rtol=2e-4, atol=2e-4,
                                       err_msg=f"{kind} {i}")
        calls = per_rank[0]["collectives"]
        assert calls[{"ring": "rotate", "ulysses": "all_to_all"}[kind]][
            "calls"] == {"ring": 2, "ulysses": 4}[kind]


def test_sequence_parallel_tagger_on_the_card_holds_to_the_jax_fixture(
        card, tmp_path):
    """The tagger at its default width over four gloo ranks sharing the
    card (``{"sp": 4}``, ring, float32) against
    ``tests/fixtures/tagger_sp_io.npz`` (the JAX package over the same
    mesh): gathered logits within rtol = atol = 1e-3, the aux shares'
    sum within rtol 1e-4, the first loss within rtol 1e-5 and the later
    two within 1e-3, each leaf's update sum within 0.01·lr a parameter,
    and the parameters bitwise equal on every rank."""
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    sys.path.insert(0, FIXTURES)
    import make_tagger_fixture as tfx
    from torch_dp_worker import run_ranks
    from torch_sp_cases import gather

    from synapseml_tpu_torch.dl import tagger

    fx = np.load(os.path.join(FIXTURES, "tagger_sp_io.npz"))
    lr, seed = float(fx["lr"]), int(fx["seed"])
    cases = [{"name": "sp4_ring", "kind": "call",
              "fn": "torch_sp_cases:tagger",
              "args": [[{}, {"sp": 4}, "ring", "float32", fx["tokens"],
                        fx["labels"], fx["mask"], 3, lr, seed, "cuda",
                        fx["tokens"], False]] * 4}]
    res = run_ranks(str(tmp_path), 4, cases, timeout=300, threads=2)
    per_rank = [r["sp4_ring"] for r in res]
    assert all("error" not in r for r in per_rank), per_rank
    want = fx["logits_sp4_ring"]
    got = gather(per_rank, "logits", ("dp", "sp"), want.shape)
    np.testing.assert_allclose(got, want, rtol=1e-3, atol=1e-3)
    aux = 0.0
    for r in per_rank:
        aux += r["aux"]
    np.testing.assert_allclose(aux, float(fx["aux_sp4_ring"]), rtol=1e-4)
    losses = per_rank[0]["losses"]
    jl = fx["losses_sp4_ring"]
    np.testing.assert_allclose(losses[0], jl[0], rtol=1e-5)
    np.testing.assert_allclose(losses, jl, rtol=1e-3)
    p0 = tagger.init_params(tagger.TaggerConfig(), seed)
    for i, name in enumerate(str(n) for n in fx["leaf_names"]):
        before = tfx.leaf(p0, name).astype(np.float64)
        update = per_rank[0]["leaf_sum"][name] - before.sum()
        gap = abs(update - fx["update_sum_sp4_ring"][i]) / (before.size * lr)
        assert gap <= 0.01, (name, gap)
    assert len({r["digest"] for r in per_rank}) == 1


@pytest.fixture(scope="module")
def decode_sched():
    """The default ``zoo.tiny_decoder`` scheduler on the card, warmed: one
    CUDA graph a (phase, KV bucket) signature."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the decode steps replay CUDA "
                    "graphs")
    from synapseml_tpu_torch.onnx import import_model, zoo
    from synapseml_tpu_torch.runtime.decode import DecodeScheduler

    s = DecodeScheduler(import_model(zoo.tiny_decoder()), name="t_cuda_dec",
                        max_batch=4, prefill_chunk=8, page_size=8,
                        max_seq=64, capacity_bytes=10 ** 9)
    rep = s.warmup()
    assert all(sig["entries"] == ["compiled"] for sig in rep["signatures"])
    s.start()
    yield s
    s.close()


def test_decode_replays_are_bitwise_their_eager_steps(decode_sched):
    """Every warm prefill and decode signature's replay, fed through the
    executor as the scheduler feeds it, against the eager forward of the
    same inputs on the same buffers: logits and every present buffer
    bitwise, each call a replay (an AOT hit, no cold run)."""
    s = decode_sched
    rng = np.random.default_rng(0)
    for t in s.t_ladder:
        for width in (s.S_pre, 1):
            ids = rng.integers(0, s.vocab, (s.B, width)).astype(np.int64)
            seqlens = rng.integers(width - 1, t, s.B).astype(np.int32)
            bufs = [torch.randn((s.B, s.kv_heads, t, s.head_dim),
                                device="cuda")
                    for _ in range(2 * s.n_layers)]
            hits = s._ex._aot_hits
            got = s._ex.submit(ids, seqlens, *bufs).result()
            assert s._ex._aot_hits == hits + 1
            want = s._fn(torch.from_numpy(ids.astype(np.int32)).cuda(),
                         torch.from_numpy(seqlens).cuda(), *bufs)
            assert np.array_equal(got[0], want[0].cpu().numpy()), (t, width)
            for a, b in zip(got[1:], want[1:]):
                assert torch.equal(a, b), (t, width)


def test_decode_refuses_an_out_of_range_token_before_any_launch(
        decode_sched):
    """A token outside ``[0, vocab)`` would be a device-side assert in the
    embedding's ``index_select``: ``submit`` raises before the executor
    dispatches anything, and the process goes on serving."""
    s = decode_sched
    dispatched = s._ex._m_disp_one.value
    for bad in ([3, s.vocab], [-1], [1, 2, 10 ** 6]):
        with pytest.raises(ValueError, match="outside"):
            s.submit(bad, max_new_tokens=4)
    torch.cuda.synchronize()
    assert s._ex._m_disp_one.value == dispatched
    toks, reason = s.submit([5, 9, 13, 2], max_new_tokens=6).result(
        timeout=120)
    assert reason == "completed" and len(toks) == 6
    assert all(0 <= t < s.vocab for t in toks)
    assert s._ex._m_disp_one.value > dispatched


def _index_cases(pick):
    sys.path.insert(0, FIXTURES)
    import index_op_cases

    return [c for c in index_op_cases.CASES if pick(c)]


_EDGE_OPS = ("GatherElements", "GatherND", "ScatterND", "ScatterElements",
             "Scatter")


@pytest.mark.parametrize(
    "name", [c["name"] for c in _index_cases(
        lambda c: c["op"] in _EDGE_OPS or c["name"].startswith("topk_bf16"))])
def test_index_op_on_the_card_equals_the_cpu(card, name):
    """The bf16 ``TopK`` ties and the gathers and scatters, out-of-range
    indices included (``tests/fixtures/index_op_cases.py``), on the card:
    no device assert, bitwise the port's CPU run (a float32 scatter-add
    over duplicate indices within its stated bound)."""
    import index_op_cases

    case = index_op_cases.by_name(name)
    got = index_op_cases.run(case, "cuda")
    torch.cuda.synchronize()
    res = index_op_cases.agree(case, got, index_op_cases.run(case, "cpu"))
    assert res["ok"], res


def test_warm_masked_lm_head_is_bitwise_its_eager_run(card):
    """``tests/fixtures/mlm_head.py``'s head over the encoder at 2 layers
    and width 64, warmed to one CUDA graph (``static_batch=16``): its
    replay bitwise the eager head on the same card tensors."""
    sys.path.insert(0, FIXTURES)
    import mlm_head

    from synapseml_tpu_torch.onnx import GraphBuilder, import_model, zoo
    from synapseml_tpu_torch.runtime.executor import BatchedExecutor

    cfg = mlm_head.SMALL_ENCODER
    enc_graph = import_model(zoo.transformer_encoder(**cfg))
    head = import_model(mlm_head.head_graph(
        GraphBuilder, enc_graph.params["tok_emb"], cfg["seq_len"],
        mlm_head.SMALL_MASKED)).bind()
    b = mlm_head.batch(16, cfg["seq_len"], cfg["vocab"],
                       mlm_head.SMALL_MASKED)
    hidden = enc_graph.bind()(torch.from_numpy(b["tokens"]).cuda())[0]
    feeds = [hidden] + [torch.from_numpy(a).cuda()
                        for a in mlm_head.head_inputs(b)]
    ex = BatchedExecutor(head, static_batch=16)
    try:
        rep = ex.warmup(feeds)
        assert [e["status"] for e in rep.entries] == ["compiled"]
        warm = ex.submit(*feeds).result()
        eager = [t.cpu().numpy() for t in head(*feeds)]
        for w, e in zip(warm, eager):
            assert w.dtype == e.dtype
            assert np.array_equal(w.view(np.uint8), e.view(np.uint8))
    finally:
        ex.close()


def _vision_cases():
    sys.path.insert(0, FIXTURES)
    import vision_op_cases

    return vision_op_cases.CASES


@pytest.mark.parametrize("name", [c["name"] for c in _vision_cases()])
def test_vision_op_on_the_card_equals_the_cpu(card, name):
    """Every one-node case of ``tests/fixtures/vision_op_cases.py`` on the
    card: no device assert, bitwise the port's CPU run where the case is
    exact (gathers, pads, views, max pools and their indices,
    ``MaxUnpool``), else within its bound; a refused case refused alike."""
    import vision_op_cases as cases

    from synapseml_tpu_torch.onnx import GraphBuilder, import_model

    case = cases.by_name(name)
    if case["raises"]:
        with pytest.raises(case["raises"]):
            cases.run(case, import_model, GraphBuilder, "cuda")
        return
    got = cases.run(case, import_model, GraphBuilder, "cuda")
    torch.cuda.synchronize()
    res = cases.agree(case, got, cases.run(case, import_model, GraphBuilder,
                                           "cpu"))
    assert res["ok"], res


def test_warm_small_vae_decoder_is_bitwise_its_eager_run(card):
    """``tests/fixtures/vae_decoder.py`` at its small width, 4 latents of
    8 x 8, warmed to one CUDA graph (``static_batch=4``): the replay
    bitwise the eager forward on the same card tensor, and both within
    1e-4 of the largest |value| of the port's CPU run."""
    sys.path.insert(0, FIXTURES)
    import vae_decoder

    from synapseml_tpu_torch.onnx import GraphBuilder, import_model
    from synapseml_tpu_torch.runtime.executor import BatchedExecutor

    graph = import_model(vae_decoder.decoder_graph(GraphBuilder,
                                                   vae_decoder.SMALL))
    fn = graph.bind()
    lat = vae_decoder.latents(4, 8)
    x = torch.from_numpy(lat).cuda()
    ex = BatchedExecutor(fn, static_batch=4)
    try:
        rep = ex.warmup([x])
        assert [e["status"] for e in rep.entries] == ["compiled"]
        warm = ex.submit(x).result()[0]
        eager = fn(x)[0].cpu().numpy()
    finally:
        ex.close()
    assert np.array_equal(warm.view(np.uint8), eager.view(np.uint8))
    cpu = graph.bind(device="cpu")(torch.from_numpy(lat))[0].numpy()
    assert np.abs(eager - cpu).max() <= 1e-4 * np.abs(cpu).max()


def _detection_cases():
    sys.path.insert(0, FIXTURES)
    import detection_op_cases

    return detection_op_cases.CARD_CASES


@pytest.mark.parametrize("name", [c["name"] for c in _detection_cases()])
def test_detection_op_on_the_card_equals_the_cpu(card, name):
    """Every one-node case of ``tests/fixtures/detection_op_cases.py`` but
    ``ImageDecoder``'s (host only) on the card: no device assert, bitwise
    the port's CPU run where the case is exact (NMS rows, ``MaxRoiPool``,
    nearest ``GridSample``), else within 2e-5 of the largest |value|; a
    refused case refused alike."""
    import detection_op_cases as cases

    from synapseml_tpu_torch.onnx import GraphBuilder, import_model

    case = cases.by_name(name)
    if case["raises"]:
        with pytest.raises(case["raises"]):
            cases.run(case, import_model, GraphBuilder, "cuda")
        return
    got = cases.run(case, import_model, GraphBuilder, "cuda")
    torch.cuda.synchronize()
    res = cases.agree(case, got, cases.run(case, import_model, GraphBuilder,
                                           "cpu"))
    assert res["ok"], res


def test_small_detection_head_captures_into_a_cuda_graph(card):
    """``tests/fixtures/detection_head.py`` at its small width captured
    into one ``torch.cuda.CUDAGraph`` after an eager run: both NMS loops
    and ``RoiAlign`` read nothing on the host, so the capture succeeds,
    the replay is bitwise the eager forward, and the first stage's rows
    equal the port's CPU run."""
    sys.path.insert(0, FIXTURES)
    import detection_head as head

    from synapseml_tpu_torch.onnx import GraphBuilder, import_model

    graph = import_model(head.head_graph(GraphBuilder, head.SMALL))
    fn = graph.bind()
    feeds = head.inputs(head.SMALL)
    xs = [torch.from_numpy(feeds[k]).cuda() for k in head.INPUTS]
    eager = [t.cpu().numpy() for t in fn(*xs)]
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn(*xs)
    torch.cuda.current_stream().wait_stream(side)
    cuda_graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(cuda_graph):
        captured = fn(*xs)
    cuda_graph.replay()
    torch.cuda.synchronize()
    for c, e in zip(captured, eager):
        assert np.array_equal(c.cpu().numpy().view(np.uint8), e.view(np.uint8))
    cpu = graph.bind(device="cpu")(*[torch.from_numpy(feeds[k])
                                     for k in head.INPUTS])
    assert np.array_equal(eager[0], cpu[0].numpy())


def _random_cases():
    sys.path.insert(0, FIXTURES)
    import random_op_cases

    return random_op_cases.CASES


@pytest.mark.parametrize("name", [c["name"] for c in _random_cases()])
def test_random_op_on_the_card_equals_the_cpu(card, name):
    """Every one-node case of ``tests/fixtures/random_op_cases.py`` on the
    card against the port's CPU run: uniform, Bernoulli and Dropout
    bitwise, normal draws within 1e-6, Multinomial's ids equal but at
    near-ties of the CPU's ``logits + noise``."""
    import random_op_cases as cases

    from synapseml_tpu_torch.onnx import GraphBuilder, import_model

    case = cases.by_name(name)
    got = cases.run(case, import_model, GraphBuilder, "cuda")
    torch.cuda.synchronize()
    res = cases.agree(case, got, cases.run(case, import_model, GraphBuilder,
                                           "cpu"))
    assert res["ok"], res


def test_random_normal_like_captures_with_no_host_copy(card):
    """A graph holding an unseeded ``RandomNormalLike`` captured into one
    ``torch.cuda.CUDAGraph`` after an eager run: its key is on the card
    from the eager run, so the capture copies nothing from the host (a
    copy would fail the capture); the replay draws bitwise what the eager
    forward drew, and every replay the same."""
    sys.path.insert(0, FIXTURES)
    import random_op_cases as cases

    from synapseml_tpu_torch.onnx import GraphBuilder, import_model

    case = cases.by_name("normal_like_unseeded_latent")
    fn = import_model(cases.graph(case, GraphBuilder)).bind()
    x = torch.from_numpy(cases.feeds(case)[0]).cuda()
    eager = fn(x)[0].cpu().numpy()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn(x)
    torch.cuda.current_stream().wait_stream(side)
    cuda_graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(cuda_graph):
        captured = fn(x)[0]
    for _ in range(2):
        cuda_graph.replay()
        torch.cuda.synchronize()
        assert np.array_equal(captured.cpu().numpy().view(np.uint32),
                              eager.view(np.uint32))


def test_warm_small_vae_encoder_is_bitwise_its_eager_run(card):
    """``tests/fixtures/vae_encoder.py`` at its small width, 4 images of
    32 x 32, warmed to one CUDA graph (``static_batch=4``): every output
    of the replay bitwise the eager forward's; 3 images padded into the
    bucket bitwise the first 3 of the full one; the latent within 1e-4 of
    the largest |value| of the port's CPU run."""
    sys.path.insert(0, FIXTURES)
    import vae_encoder

    from synapseml_tpu_torch.onnx import GraphBuilder, import_model
    from synapseml_tpu_torch.runtime.executor import BatchedExecutor

    graph = import_model(vae_encoder.encoder_graph(GraphBuilder,
                                                   vae_encoder.SMALL))
    fn = graph.bind()
    imgs = vae_encoder.images(4, 32)
    x = torch.from_numpy(imgs).cuda()
    ex = BatchedExecutor(fn, static_batch=4)
    try:
        rep = ex.warmup([x])
        assert [e["status"] for e in rep.entries] == ["compiled"]
        warm = ex.submit(x).result()
        padded = ex.submit(x[:3].clone()).result()
        eager = [t.cpu().numpy() for t in fn(x)]
    finally:
        ex.close()
    for w, p, e in zip(warm, padded, eager):
        e = np.ascontiguousarray(e)
        assert np.array_equal(np.ascontiguousarray(w).view(np.uint8),
                              e.view(np.uint8))
        assert np.array_equal(np.ascontiguousarray(p).view(np.uint8),
                              np.ascontiguousarray(e[:3]).view(np.uint8))
    cpu = graph.bind(device="cpu")(torch.from_numpy(imgs))[0].numpy()
    assert np.abs(eager[0] - cpu).max() <= 1e-4 * np.abs(cpu).max()


def _sequence_cases():
    sys.path.insert(0, FIXTURES)
    import sequence_string_op_cases

    return sequence_string_op_cases.CASES


@pytest.mark.parametrize("name", [c["name"] for c in _sequence_cases()])
def test_sequence_string_op_on_the_card_equals_the_cpu(card, name):
    """Every case of ``tests/fixtures/sequence_string_op_cases.py`` on the
    card against the port's CPU run: strings and host values equal,
    floats bitwise but sums of products within 1e-5, counts bitwise; a
    case the reference refuses raises its exception on the card too."""
    import sequence_string_op_cases as cases

    from synapseml_tpu_torch.onnx import GraphBuilder, import_model

    case = cases.by_name(name)
    if case["raises"]:
        with pytest.raises(case["raises"]):
            cases.run(case, import_model, GraphBuilder, "cuda")
        return
    got = cases.run(case, import_model, GraphBuilder, "cuda")
    torch.cuda.synchronize()
    res = cases.agree(case, got, cases.run(case, import_model, GraphBuilder,
                                           "cpu"))
    assert res["ok"], res


def test_sequence_map_graph_captures_with_no_host_copy(card):
    """``SplitToSequence`` -> ``SequenceMap`` (MatMul by a body
    initializer, Relu) -> ``ConcatFromSequence`` captured into one
    ``torch.cuda.CUDAGraph`` after an eager run: a static-length sequence
    of device values issues no copy and no host read, so the capture
    holds, and the replay is bitwise the eager forward."""
    sys.path.insert(0, FIXTURES)
    import sequence_string_op_cases as cases

    from synapseml_tpu_torch.onnx import GraphBuilder, import_model

    case = cases.by_name("sequence_map_body_initializer_matmul_relu")
    fn = import_model(cases.graph(case, GraphBuilder)).bind()
    x = torch.from_numpy(cases.feeds(case)[0]).cuda()
    eager = fn(x)[0].cpu().numpy()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn(x)
    torch.cuda.current_stream().wait_stream(side)
    cuda_graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(cuda_graph):
        captured = fn(x)[0]
    cuda_graph.replay()
    torch.cuda.synchronize()
    assert np.array_equal(captured.cpu().numpy().view(np.uint32),
                          eager.view(np.uint32))


def test_string_ops_refuse_a_cuda_tensor(card):
    sys.path.insert(0, FIXTURES)
    import sequence_string_op_cases as cases

    from synapseml_tpu_torch.onnx import GraphBuilder, import_model

    for name in ("string_split_device_tensor_raises",
                 "regex_full_match_device_tensor_raises"):
        with pytest.raises(NotImplementedError, match="host"):
            cases.run(cases.by_name(name), import_model, GraphBuilder,
                      "cuda")


def test_small_newsgroups_classifier_on_the_card_equals_the_cpu(card):
    """``tests/fixtures/newsgroups_classifier.py`` at its small width
    (5,000 words, 4 classes), 16 documents: counts bitwise, labels equal
    but at near-ties, scores within 1e-4 of the largest |score| of the
    port's CPU run."""
    sys.path.insert(0, FIXTURES)
    import newsgroups_classifier as news

    from synapseml_tpu_torch.onnx import GraphBuilder, import_model

    graph = import_model(news.classifier_graph(GraphBuilder, news.SMALL))
    docs = news.documents(news.SMALL, 16)
    labels, scores = (t.cpu().numpy() for t in graph.bind()(docs))
    cpu_labels, cpu_scores = (t.numpy() for t in graph.bind(device="cpu")(
        docs))
    held = news.held(labels, scores, {"labels": cpu_labels,
                                      "scores": cpu_scores})
    assert held["ok"], held
    head = graph.truncated(2)
    counts = news.counts_of(head.bind(), docs)
    cpu_counts = news.counts_of(head.bind(device="cpu"), docs)
    assert np.array_equal(counts.view(np.uint32), cpu_counts.view(np.uint32))


def _signal_cases():
    sys.path.insert(0, FIXTURES)
    import signal_op_cases

    return signal_op_cases.CASES


@pytest.mark.parametrize("name", [c["name"] for c in _signal_cases()])
def test_signal_op_on_the_card_equals_the_cpu(card, name):
    """Every case of ``tests/fixtures/signal_op_cases.py`` on the card
    against the port's CPU run: windows and filterbanks bitwise with the
    same host-ness, spectra within 1e-5 of each output's largest |value|
    (one step of a half-precision type), the log-mel chain within 1e-3;
    a case the reference refuses raises its exception on the card too."""
    import signal_op_cases as cases

    from synapseml_tpu_torch.onnx import GraphBuilder, import_model

    case = cases.by_name(name)
    if case["raises"]:
        with pytest.raises(case["raises"]):
            cases.run(case, import_model, GraphBuilder, "cuda")
        return
    got = cases.run(case, import_model, GraphBuilder, "cuda")
    torch.cuda.synchronize()
    res = cases.agree(case, got, cases.run(case, import_model, GraphBuilder,
                                           "cpu"))
    assert res["ok"], res


def _speech_table(n_clips, seconds):
    sys.path.insert(0, FIXTURES)
    import speech_clips as sc

    from synapseml_tpu_torch.data.table import Table

    audio = np.empty(n_clips, dtype=object)
    for i in range(n_clips):
        audio[i] = sc.clip(i)[:seconds * sc.SAMPLE_RATE]
    return Table({"audio": audio})


def test_audio_featurizer_runs_on_the_card_and_equals_the_cpu(card):
    """Four 5-s clips at Whisper's geometry (400/160, 80 mel bins): the
    card's log-mel within rtol = atol = 1e-3 of the port's CPU run, the
    default device the card."""
    import speech_clips as sc

    from synapseml_tpu_torch.cognitive import AudioFeaturizer

    table = _speech_table(4, 5)
    feat = AudioFeaturizer(**sc.WHISPER_FEATURIZER)
    got = feat.transform(table)["features"]
    (_, executor), = feat.__dict__["_audio_cache"].values()
    assert executor.device.type == "cuda"
    want = AudioFeaturizer(**sc.WHISPER_FEATURIZER).transform(
        table, device="cpu")["features"]
    for a, b in zip(got, want):
        assert a.shape == b.shape == (498, 80)
        np.testing.assert_allclose(a, b, rtol=1e-3, atol=1e-3)


def test_warm_audio_featurizer_replays_its_eager_bits(card):
    """``warmup`` captures the featurization (STFT's strided frames and
    cuFFT transform, the power, the mel matmul, the log) into a CUDA
    graph after an eager run of the shape, so cuFFT's plan and work area
    are made outside the capture; the replay is bitwise the eager
    featurizer."""
    import speech_clips as sc

    from synapseml_tpu_torch.cognitive import AudioFeaturizer

    table = _speech_table(8, 5)
    warm = AudioFeaturizer(**sc.WHISPER_FEATURIZER)
    rep = warm.warmup([5 * sc.SAMPLE_RATE], buckets=[8])
    assert [e["status"] for e in rep.entries] == ["compiled"], rep.errors
    got = warm.transform(table)["features"]
    (_, executor), = warm.__dict__["_audio_cache"].values()
    assert executor._aot_hits == 1
    want = AudioFeaturizer(**sc.WHISPER_FEATURIZER).transform(
        table)["features"]
    for a, b in zip(got, want):
        assert np.array_equal(a.view(np.uint32), b.view(np.uint32))


def test_speech_chain_on_the_card_equals_the_cpu(card):
    """The first 20 s of the seeded recording through
    ``wav_to_utterance_rows`` (80 mel bins), ``utterance_feature_batch``
    and the hidden-300 BiLSTM ``CNTKModel`` on the card, held to the
    port's CPU run where the states are determined
    (``speech_clips.held_means``) and to the JAX fixture."""
    sys.path.insert(0, FIXTURES)
    import speech_clips as sc

    from synapseml_tpu_torch.cognitive import (AudioFeaturizer, pcm_to_wav,
                                               utterance_feature_batch,
                                               wav_to_utterance_rows)
    from synapseml_tpu_torch.data.table import Table
    from synapseml_tpu_torch.dl.cntk import CNTKModel
    from synapseml_tpu_torch.dl.cntk_format import build_optimized_rnn_model

    wav = sc.long_wav(pcm_to_wav, sc.CUT_S)
    blob = build_optimized_rnn_model(**sc.RNN)
    runs = {}
    for dev in ("cuda", "cpu"):
        rows = wav_to_utterance_rows(
            wav, AudioFeaturizer(num_mel_bins=sc.N_MELS), device=dev)
        runs[dev] = sc.chain_states(CNTKModel(model_bytes=blob), rows,
                                    utterance_feature_batch, Table,
                                    device=dev)
    (card_means, _, n_frames), (cpu_means, _, cpu_n) = runs["cuda"], \
        runs["cpu"]
    np.testing.assert_array_equal(n_frames, cpu_n)
    held = sc.held_means(card_means, cpu_means, n_frames, 1e-4)
    assert held["ok"], held
    fx = np.load(sc.OUT)
    held = sc.held_means(card_means, fx["chain_means"], n_frames, 1e-4)
    assert held["ok"], held


def _quant_cases():
    sys.path.insert(0, FIXTURES)
    import quant_op_cases

    return quant_op_cases.CASES


@pytest.fixture
def quant_cache(tmp_path, monkeypatch):
    """Fresh verdict tables: every int8 class probes anew."""
    from synapseml_tpu_torch.onnx import quant_route

    monkeypatch.setenv("SYNAPSEML_TPU_CACHE_DIR", str(tmp_path))
    monkeypatch.delenv("SYNAPSEML_ONNX_INT8", raising=False)
    monkeypatch.delenv("SYNAPSEML_AUTOTUNE", raising=False)
    quant_route.clear_cache()
    yield tmp_path
    quant_route.clear_cache()


@pytest.mark.parametrize("forced", [False, True], ids=["routed", "int8"])
@pytest.mark.parametrize("name", [c["name"] for c in _quant_cases()])
def test_quant_op_on_the_card_equals_the_cpu(card, quant_cache, monkeypatch,
                                            name, forced):
    """Every case of ``tests/fixtures/quant_op_cases.py`` on the card,
    bitwise the port's CPU run (itself bitwise the JAX importer): under
    the measured verdicts, and with every probe's verdict forced to
    ``"int8"``, when exactly the cases ``INT8_LANE`` names take the int8
    lane."""
    import quant_op_cases as cases

    from synapseml_tpu_torch.onnx import GraphBuilder, import_model, quant_route
    from synapseml_tpu_torch.runtime import telemetry as tm

    if forced:
        monkeypatch.setattr(quant_route, "_probe_matmul", lambda *r: "int8")
        monkeypatch.setattr(quant_route, "_probe_conv", lambda *r: "int8")
    case = cases.by_name(name)
    int8 = tm.counter("onnx_int8_route_total", backend="int8")
    before = int8.value
    got = cases.run(case, import_model, GraphBuilder, "cuda")
    torch.cuda.synchronize()
    if forced:
        assert (int8.value > before) == (name in cases.INT8_LANE)
    res = cases.agree(case, got, cases.run(case, import_model, GraphBuilder,
                                           "cpu"))
    assert res["ok"], res
    assert all(r["exact"] for r in quant_route.PROBES), quant_route.PROBES


def _resnet50_classes():
    sys.path.insert(0, FIXTURES)
    import qresnet50

    return qresnet50.conv_classes()


@pytest.mark.parametrize("batch", [8, 128])
@pytest.mark.parametrize("cls", _resnet50_classes(), ids=str)
def test_quant_int8_lane_is_bitwise_the_widened_lane_at_resnet50(card,
                                                                 cls, batch):
    """The int8 cores against the widened cores on the card, bitwise, at
    every convolution class of ResNet-50 224 (uint8 activations with a
    host zero point, per-output-channel int8 weights) and at the head's
    matmul (uint8 rows, int8 weights with a per-column zero point), at
    buckets 8 and 128."""
    from synapseml_tpu_torch.onnx import importer, quant_route

    rng = np.random.default_rng(zlib.crc32(repr(cls).encode()))

    def q(shape, dt):
        info = np.iinfo(dt)
        return torch.from_numpy(rng.integers(info.min, info.max + 1,
                                             shape).astype(dt)).to(card)

    if cls[0] == "head":
        a = q((batch, cls[1]), np.uint8)
        b = q((cls[1], cls[2]), np.int8)
        zb = q((cls[2],), np.int8)
        want = importer._matmul_wide_core(a, b, np.uint8(7), zb)
        if not quant_route.int_mm_eligible(batch, cls[1], cls[2]):
            with pytest.raises(RuntimeError, match="greater than 16"):
                importer._matmul_int8_core(a, b, np.uint8(7), zb)
            return
        got = importer._matmul_int8_core(a, b, np.uint8(7), zb)
    else:
        c_in, h, c_out, k, stride, pad = cls
        x = q((batch, c_in, h, h), np.uint8)
        w = q((c_out, c_in, k, k), np.int8)
        ctx = quant_route._Attrs(strides=[stride] * 2, pads=[pad] * 4)
        got = importer._conv_int8_core(ctx, x, w, np.uint8(114), None)
        want = importer._conv_wide_core(ctx, x, w, np.uint8(114), None)
    torch.cuda.synchronize()
    assert got.dtype == want.dtype == torch.int32
    assert got.shape == want.shape and torch.equal(got, want)


def test_quant_capture_after_a_cold_route_probes_nothing_inside(
        card, quant_cache, monkeypatch):
    """A quantized ``zoo.tiny_resnet`` warmed through ``ONNXModel`` from
    cold tables: every probe runs in the eager pass before each capture,
    none inside a capture; the replayed forward is bitwise the CPU's."""
    sys.path.insert(0, FIXTURES)
    import qresnet50 as qr

    from synapseml_tpu_torch.data.table import Table
    from synapseml_tpu_torch.onnx import GraphBuilder, ONNXModel, quant_route
    from synapseml_tpu_torch.runtime import autotune

    inside = []
    real = autotune.Lane._probe_guarded

    def spy(self, rargs):
        inside.append(torch.cuda.is_current_stream_capturing())
        return real(self, rargs)

    monkeypatch.setattr(autotune.Lane, "_probe_guarded", spy)
    blob = qr.graph(GraphBuilder, qr.TINY)
    x = qr.images(32, qr.TINY, seed=5)
    m = ONNXModel(model_bytes=blob, mini_batch_size=32)
    rep = m.warmup(buckets=[8, 32], device="cuda")
    assert not rep.errors and rep.compiled == 2, rep
    assert inside and not any(inside)
    probes = quant_route._CONV_LANE.probes
    assert probes > 0
    got = m.transform(Table({"data": x}), "cuda")
    assert quant_route._CONV_LANE.probes == probes
    want = ONNXModel(model_bytes=blob, mini_batch_size=32).transform(
        Table({"data": x}), "cpu")
    for col in ("logits", "logits_q"):
        assert np.array_equal(got[col], want[col]), col
    assert all(r["exact"] for r in quant_route.PROBES)
    m._executor("cuda").close()


def test_quant_int_mm_ineligible_shape_routes_dequant_without_poison(
        card, quant_cache):
    """The ResNet head's matmul at bucket 8 (8 rows, which
    ``torch._int_mm`` refuses on the card) routes to the widened lane by
    eligibility: no probe, no verdict, no poison; at bucket 128 it probes
    and its verdict is the measured one, verified exact."""
    from synapseml_tpu_torch.onnx import quant_route

    head = torch.zeros((2048, 1000), dtype=torch.int8, device=card)
    a8 = torch.zeros((8, 2048), dtype=torch.uint8, device=card)
    assert quant_route.route_matmul(a8, head, np.uint8(3), None) == "dequant"
    assert quant_route._MM_LANE.probes == 0
    assert not quant_route._MM_LANE.decisions and not quant_route.PROBES
    a128 = torch.zeros((128, 2048), dtype=torch.uint8, device=card)
    got = quant_route.route_matmul(a128, head, np.uint8(3), None)
    assert quant_route._MM_LANE.probes == 1
    rec = quant_route.PROBES[-1]
    assert rec["exact"] and rec["verdict"] == got
    assert list(quant_route._MM_LANE.decisions.values()) == [got]


def test_autotune_lanes_on_the_card(card, quant_cache):
    """The measured lanes probe on the card: ``compute_dtype="auto"``
    resolves and scores as its verdict's explicit dtype (bitwise),
    ``preferred_wire`` returns a verdict of the wire lane, and
    ``best_of`` waits for a card result without copying it."""
    from synapseml_tpu_torch.data.table import Table
    from synapseml_tpu_torch.onnx import ONNXModel, zoo
    from synapseml_tpu_torch.onnx import model as model_mod
    from synapseml_tpu_torch.runtime import proberoute

    blob = zoo.tiny_resnet()
    x = np.random.default_rng(0).standard_normal(
        (16, 3, 32, 32)).astype(np.float32)
    auto = ONNXModel(model_bytes=blob, compute_dtype="auto",
                     mini_batch_size=16)
    got = auto.transform(Table({"data": x}), "cuda")
    cd = model_mod.routed_compute_dtype(auto.graph, blob, 16, "cuda")
    assert cd in ("float32", "bfloat16")
    same = ONNXModel(model_bytes=blob, compute_dtype=cd,
                     mini_batch_size=16).transform(Table({"data": x}),
                                                   "cuda")
    assert np.array_equal(got[auto.graph.output_names[0]],
                          same[auto.graph.output_names[0]])
    auto.set(input_norm={"data": {"mean": 127.5, "scale": 1 / 64.0}})
    assert auto.preferred_wire("data", device="cuda") in ("uint8", "float")
    a = torch.randn(4096, 4096, device=card)
    t = proberoute.best_of(lambda: a @ a, (), reps=2)
    assert 0 < t < 1.0


@pytest.mark.parametrize("choice", ["per_arg", "coalesced"])
def test_autotune_h2d_lane_stages_bitwise_on_the_card(card, quant_cache,
                                                      monkeypatch, choice):
    """Three host columns (two float32, one int32) through a card
    executor under each H2D verdict: bitwise the CPU executor, pinned
    staging buffers back in the pool; the lane's own probe verifies
    ``coalesced`` bitwise."""
    from synapseml_tpu_torch.runtime import executor as ex_mod

    monkeypatch.setattr(ex_mod.BatchedExecutor, "_h2d_choice_for",
                        lambda self, hkey: choice)
    rng = np.random.default_rng(1)
    a = rng.standard_normal((100, 64)).astype(np.float32)
    b = rng.standard_normal((100, 64)).astype(np.float32)
    c = rng.integers(0, 5, (100, 64)).astype(np.int32)

    def fn(x, y, z):
        return (x * y + z, x - y)

    outs = {}
    for dev in ("cuda", "cpu"):
        ex = ex_mod.BatchedExecutor(fn, device=dev, max_bucket=32)
        outs[dev] = ex(a, b, c)
        ex.close()
    for g, w in zip(outs["cuda"], outs["cpu"]):
        assert np.array_equal(g, w)
    ln = ex_mod._h2d_lane()
    ln.reset()
    sig = (((32, 64), "float32"), ((32, 64), "float32"),
           ((32, 64), "int32"))
    assert ln.route(sig, card) in ("per_arg", "coalesced")
    assert ln.probes == 1
    ln.reset()

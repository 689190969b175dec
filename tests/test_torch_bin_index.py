"""The per-fit bin index that kernel K1 walks, on the CPU.

K1 (``csrc/histogram.cu``) adds the rows of each (feature, bin) in the
order in which :func:`kernels.bin_index` lists them, skipping rows whose
three values are all zero. These tests hold the index to a stable numpy
argsort, and a numpy walk of its segments in that order, adding float32
values one at a time, to the plain version (``index_add_``) and to the
JAX package's ``grower.histogram`` (``segment_sum`` on the CPU):
**bitwise**, which is what makes the kernel's order the plain version's. The kernel itself is held to
the plain version on the card (``tests/test_torch_cuda.py``).
"""
import dataclasses

import numpy as np
import pytest
import torch

from synapseml_tpu.gbdt import grower as jgrower
from synapseml_tpu_torch.gbdt import binning, boosting, grower, kernels
from synapseml_tpu_torch.gbdt.estimators import LightGBMClassifier
from synapseml_tpu_torch.data.table import Table


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _walk(index: kernels.BinIndex, data: np.ndarray) -> np.ndarray:
    """What K1 computes, in numpy: each (feature, bin) segment's rows
    added in segment order into float32 from +0, one rounding an add,
    rows whose three values are all == 0 skipped."""
    order, start = index.order.numpy(), index.start.numpy()
    f, b = start.shape[0], start.shape[1] - 1
    lo, hi = start[:, :-1].astype(np.int64), start[:, 1:].astype(np.int64)
    acc = np.zeros((f, b, 3), np.float32)
    longest = int((hi - lo).max(initial=0))
    for step in range(longest):
        pos = lo + step
        live = pos < hi
        rows = order[np.arange(f)[:, None], np.where(live, pos, 0)]
        vals = data[rows]
        keep = live & ~(vals == 0).all(-1)
        acc = np.where(keep[..., None], acc + vals, acc)
    return acc


def _bitwise_equal(a: np.ndarray, b: np.ndarray) -> bool:
    return a.shape == b.shape and np.array_equal(
        np.ascontiguousarray(a, np.float32).view(np.uint32),
        np.ascontiguousarray(b, np.float32).view(np.uint32))


# -- the index ---------------------------------------------------------------

@pytest.mark.parametrize("n,f,n_bins,dtype,even_only", [
    (5000, 4, 256, np.uint8, False),
    (3001, 3, 1024, np.uint16, False),
    (2000, 2, 64, np.uint8, True),        # every odd bin empty
    (300, 1, 16, np.uint8, False),        # F = 1
    (1, 3, 8, np.uint16, False),          # N = 1
    (0, 4, 16, np.uint8, False),          # N = 0: every segment empty
])
def test_bin_index_is_a_stable_sort_with_segment_starts(n, f, n_bins, dtype,
                                                        even_only):
    rng = np.random.default_rng(n + f)
    binned = rng.integers(0, n_bins, (n, f)).astype(dtype)
    if even_only:
        binned &= ~np.array(1, dtype)
    before = kernels.bin_index.builds
    index = kernels.bin_index(_t(binned), n_bins)
    assert kernels.bin_index.builds == before + 1
    assert (index.n, index.f, index.n_bins) == (n, f, n_bins)
    assert index.order.dtype == index.start.dtype == torch.int32
    assert index.order.shape == (f, n) and index.start.shape == (f, n_bins + 1)
    assert index.order.is_contiguous() and index.start.is_contiguous()
    for fi in range(f):
        col = binned[:, fi]
        np.testing.assert_array_equal(index.order[fi].numpy(),
                                      np.argsort(col, kind="stable"))
        counts = np.bincount(col, minlength=n_bins)
        np.testing.assert_array_equal(
            index.start[fi].numpy(), np.concatenate([[0], np.cumsum(counts)]))
    if even_only:
        assert (np.diff(index.start.numpy(), axis=1)[:, 1::2] == 0).all()


def test_bin_index_sorts_bins_past_n_bins_after_the_last_segment():
    binned = np.array([[3], [9], [1], [3], [0]], np.uint8)
    index = kernels.bin_index(_t(binned), 4)
    np.testing.assert_array_equal(index.order.numpy(), [[4, 2, 0, 3, 1]])
    np.testing.assert_array_equal(index.start.numpy(), [[0, 1, 2, 2, 4]])


def test_bin_index_rejects_what_k1_does_not_take():
    with pytest.raises(TypeError):
        kernels.bin_index(torch.zeros((4, 2), dtype=torch.int32), 8)
    with pytest.raises(TypeError):
        kernels.bin_index(torch.zeros(4, dtype=torch.uint8), 8)
    with pytest.raises(ValueError):
        kernels.bin_index(torch.zeros((4, 2), dtype=torch.uint16), 70_000)


# -- the walk of the index is the plain version, bitwise ---------------------

def _adult_bins(n=32_561, d=14, seed=0):
    """Bins of the seeded Adult-census rows (as
    ``tests/fixtures/make_lgbm_adult_fixture.py`` makes them): quantiles of
    Gaussian columns, about 128 rows a bin."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, d))
    mapper = binning.BinMapper(max_bin=255).fit(x)
    return mapper.transform(x), mapper.total_bins


def _grads(rng, n, mask_frac):
    """(grad, hess, mask) as the grower takes them."""
    g = (rng.normal(size=n) * 10).astype(np.float32)
    h = rng.random(n).astype(np.float32)
    return g, h, rng.random(n) < mask_frac


def _stack(g, h, mask):
    """The [N, 3] rows K1 reads, as both growers stack them."""
    w = mask.astype(np.float32)
    return np.stack([g * w, h * w, w], 1)


def _data(rng, n, mask_frac):
    return _stack(*_grads(rng, n, mask_frac))


def _jax_histogram(binned, g, h, mask, n_bins):
    """The JAX package's histogram (``segment_sum`` on the CPU)."""
    import jax.numpy as jnp

    return np.asarray(jgrower.histogram(
        jnp.asarray(binned), jnp.asarray(g), jnp.asarray(h),
        jnp.asarray(mask), n_bins))


@pytest.mark.parametrize("case", ["adult_full", "adult_leaf_30pct",
                                  "adult_all_masked", "skewed_90pct",
                                  "one_bin", "uint16_b1024"])
def test_segment_walk_is_bitwise_the_plain_version(case):
    rng = np.random.default_rng(len(case))
    if case.startswith("adult"):
        binned, n_bins = _adult_bins()
        frac = {"adult_full": 1.0, "adult_leaf_30pct": 0.3,
                "adult_all_masked": 0.0}[case]
        grads = _grads(rng, len(binned), frac)
    elif case == "skewed_90pct":   # one bin holds 90% of the rows
        n, n_bins = 20_000, 256
        binned = rng.integers(0, n_bins, (n, 3)).astype(np.uint8)
        binned[rng.random((n, 3)) < 0.9] = 7
        grads = _grads(rng, n, 0.6)
    elif case == "one_bin":        # every row of every feature in bin 3
        n, n_bins = 5_000, 16
        binned = np.full((n, 2), 3, np.uint8)
        grads = _grads(rng, n, 0.5)
    else:
        n, n_bins = 4_099, 1024
        binned = rng.integers(0, n_bins, (n, 5)).astype(np.uint16)
        grads = _grads(rng, n, 1.0)
    data = _stack(*grads)
    want = kernels.histogram_reference(_t(binned), _t(data), n_bins).numpy()
    got = _walk(kernels.bin_index(_t(binned), n_bins), data)
    assert _bitwise_equal(got, want)
    assert _bitwise_equal(got, _jax_histogram(binned, *grads, n_bins))
    if case == "adult_all_masked":
        assert _bitwise_equal(want, np.zeros_like(want))   # +0, never -0


def test_segment_walk_propagates_nan_as_the_plain_version():
    """All data zero but one NaN grad: the NaN row is not skipped (NaN is
    not == 0), so its bin reads NaN in the grad column and every other
    entry stays +0, as in the plain version."""
    rng = np.random.default_rng(5)
    binned = rng.integers(0, 64, (3000, 4)).astype(np.uint8)
    g, h = np.zeros(3000, np.float32), np.zeros(3000, np.float32)
    g[1234] = np.nan
    mask = np.zeros(3000, bool)
    data = _stack(g, h, mask)
    want = kernels.histogram_reference(_t(binned), _t(data), 64).numpy()
    got = _walk(kernels.bin_index(_t(binned), 64), data)
    jax_hist = _jax_histogram(binned, g, h, mask, 64)
    assert np.isnan(want).sum() == 4
    for fi in range(4):
        assert np.isnan(want[fi, binned[1234, fi], 0])
    finite = ~np.isnan(want)
    for other in (want, jax_hist):
        assert np.array_equal(np.isnan(got), np.isnan(other))
        assert _bitwise_equal(got[finite], other[finite])


# -- the index on the training path -----------------------------------------

def test_histogram_checks_a_given_index_on_the_cpu():
    rng = np.random.default_rng(2)
    binned = _t(rng.integers(0, 16, (500, 3)).astype(np.uint8))
    data = _t(_data(rng, 500, 0.5))
    index = kernels.bin_index(binned, 16)
    want = kernels.histogram_reference(binned, data, 16)
    assert torch.equal(kernels.histogram(binned, data, 16, index=index), want)
    for other in (kernels.bin_index(binned, 32),           # other n_bins
                  kernels.bin_index(binned[:400], 16),     # other N
                  kernels.bin_index(binned[:, :2].contiguous(), 16)):  # F
        with pytest.raises(ValueError, match="bin index"):
            kernels.histogram(binned, data, 16, index=other)


def test_histogram_refuses_a_stale_index_of_the_right_shape():
    """An index describes the one tensor it was built from: a copy with
    other bins, or the same tensor written in place after the build, is
    refused (on the card K1 would walk the old bins' order)."""
    rng = np.random.default_rng(4)
    binned = _t(rng.integers(0, 16, (500, 3)).astype(np.uint8))
    data = _t(_data(rng, 500, 0.5))
    index = kernels.bin_index(binned, 16)
    other = binned.flip(0).contiguous()            # same shape, other bins
    with pytest.raises(ValueError, match="bin index built from another"):
        kernels.histogram(other, data, 16, index=index)
    with pytest.raises(ValueError, match="bin index built from another"):
        kernels.histogram(binned.clone(), data, 16, index=index)
    kernels.histogram(binned, data, 16, index=index)
    binned[0, 0] = 15 - binned[0, 0]
    with pytest.raises(ValueError, match="bin index built before"):
        kernels.histogram(binned, data, 16, index=index)
    assert torch.equal(kernels.histogram(binned, data, 16,
                                         index=kernels.bin_index(binned, 16)),
                       kernels.histogram_reference(binned, data, 16))


@pytest.mark.parametrize("keep", [
    [False, True, True, False, True],     # feature 0 moved
    [True, False, True, True, False],     # feature 0 kept
    [False, False, False, True, False],   # one feature left
    [True] * 5,
], ids=["f0_moved", "f0_kept", "one_left", "none_moved"])
@pytest.mark.parametrize("n_bins,dtype", [(256, np.uint8),
                                          (1024, np.uint16)])
def test_mask_features_is_the_index_of_the_moved_bins(keep, n_bins, dtype):
    """``feature_fraction``'s per-tree index, derived without a sort, is
    ``bin_index`` of the moved bins bitwise (what K1 then walks), and the
    walk of it is the plain version of the moved bins, bitwise."""
    rng = np.random.default_rng(n_bins + sum(keep))
    binned = _t(rng.integers(0, n_bins, (3_001, 5)).astype(dtype))
    index = kernels.bin_index(binned, n_bins)
    builds = (kernels.bin_index.builds, kernels.mask_features.builds)
    moved, masked = kernels.mask_features(index, binned, torch.tensor(keep))
    assert (kernels.bin_index.builds,
            kernels.mask_features.builds) == (builds[0], builds[1] + 1)
    want = torch.where(torch.tensor(keep)[None, :], binned,
                       torch.full_like(binned, n_bins - 1))
    assert moved.dtype == binned.dtype and torch.equal(moved, want)
    fresh = kernels.bin_index(moved, n_bins)
    assert torch.equal(masked.order, fresh.order)
    assert torch.equal(masked.start, fresh.start)
    data = _data(rng, 3_001, 0.6)
    plain = kernels.histogram_reference(moved, _t(data), n_bins)
    assert torch.equal(kernels.histogram(moved, _t(data), n_bins,
                                         index=masked), plain)
    assert _bitwise_equal(_walk(masked, data), plain.numpy())
    with pytest.raises(ValueError, match="bin index"):
        kernels.histogram(binned, _t(data), n_bins, index=masked)


@pytest.mark.parametrize("seed,kw", [(0, {}), (1, dict(max_depth=3)),
                                     (2, dict(lambda_l1=0.5))])
def test_build_tree_with_index_is_the_tree_without(seed, kw):
    rng = np.random.default_rng(seed)
    n, f, n_bins = 1500, 6, 64
    binned = _t(rng.integers(0, n_bins, (n, f)).astype(np.uint8))
    g = _t(rng.normal(size=n).astype(np.float32))
    h = _t((rng.random(n) + 0.5).astype(np.float32))
    mask = _t(rng.random(n) < 0.9)
    thr = np.sort(rng.normal(size=(f, n_bins)), 1).astype(np.float32)
    p = grower.GrowerParams(num_leaves=15, max_bin=n_bins,
                            min_data_in_leaf=5, **kw)
    plain = grower.build_tree(binned, g, h, mask, thr, p)
    indexed = grower.build_tree(binned, g, h, mask, thr, p,
                                index=kernels.bin_index(binned, n_bins))
    for name in (fld.name for fld in dataclasses.fields(grower.Tree)):
        np.testing.assert_array_equal(getattr(indexed[0], name),
                                      getattr(plain[0], name), name)
    assert torch.equal(indexed[1], plain[1])
    assert torch.equal(indexed[2], plain[2])
    np.testing.assert_array_equal(indexed[3], plain[3])
    with pytest.raises(ValueError, match="bin index"):
        grower.build_tree(binned, g, h, mask, thr, p,
                          index=kernels.bin_index(binned, n_bins // 2))


@pytest.mark.parametrize("kw", [
    dict(objective="binary", num_iterations=4),
    dict(objective="multiclass", num_class=3, num_iterations=2),
])
def test_train_builds_one_index_per_fit(kw):
    rng = np.random.default_rng(3)
    x = rng.normal(size=(600, 5))
    y = (rng.integers(0, 3, 600) if kw["objective"] == "multiclass"
         else (x[:, 0] > 0)).astype(np.float64)
    before = kernels.bin_index.builds
    boosting.train(boosting.BoostParams(num_leaves=7, **kw), x, y,
                   device="cpu")
    assert kernels.bin_index.builds == before + 1
    LightGBMClassifier(num_iterations=3, num_leaves=7).fit(
        Table({"features": x, "label": (x[:, 1] > 0).astype(np.float64)}),
        device="cpu")
    assert kernels.bin_index.builds == before + 2

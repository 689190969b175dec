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

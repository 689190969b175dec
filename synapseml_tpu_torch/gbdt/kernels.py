"""The GBDT engine's two kernels: the histogram (K1) and the forest
traversal (K2), and the per-fit bin index that K1 reads.

K1, ``histogram``, builds the [F, B, 3] per-(feature, bin) sums of
(grad, hess, count) that every split search of training reads. It
replaces ``synapseml_tpu/gbdt/pallas_kernels.py`` ``histogram_tpu``. On a
CUDA tensor the wrapper launches the hand-written Hopper kernel in
``csrc/histogram.cu``: one warp owns a (feature, bin) and adds the rows of
its bin in row order, reading them from a :class:`BinIndex` (each
feature's row ids stably sorted by bin, built once per fit by
:func:`bin_index`, since the bins never change during a fit), so the sums
are deterministic and bitwise the sequential ones. On a CPU tensor it runs
:func:`histogram_reference`, the plain PyTorch version (``index_add_`` over
flat ids ``feature * B + bin``, which on the CPU is bitwise the JAX
reference's ``segment_sum``).

K2, ``forest_traverse``, walks every row of ``x`` [N, F] through all T trees
of a stacked ensemble and adds ``value[leaf]`` of tree ``t`` into output
column ``t % k``. It is the GBDT ensemble predict (tree weights folded
into ``value`` by the caller), the isolation forest's path-length sum
(``strict=True``, ``value=depth_adj``) and, with T=1, single-tree predict.

Replaces ``synapseml_tpu/gbdt/pallas_kernels.py`` ``predict_forest_tpu``.
On a CUDA tensor the wrapper launches the hand-written Hopper kernel in
``csrc/forest_traverse.cu`` (one thread per row; the tree planes, packed a
node to 8 bytes, and the block's x rows staged in shared memory; four
trees of a column walked at once and added in tree order). What bounds
it: the bytes it must move are small (x once, the output once, ~122 KB of
tree planes for 100 trees of 61 nodes), so its time is set by the chain
of dependent loads of each walk step; see the source for what the design
does about that. On a CPU tensor the wrapper runs
:func:`forest_traverse_reference`, the plain PyTorch version.

There is no fallback: a CUDA tensor takes the kernel or the call raises.
Each wrapper counts its launches in ``<wrapper>.launches``, and
:func:`bin_index` and :func:`mask_features` their builds in ``.builds``.
"""
from __future__ import annotations

import ctypes
import dataclasses
import threading
from typing import Optional, Tuple

import torch

_BIN_DTYPES = (torch.uint8, torch.uint16)

# the launch counters' lock: ``+= 1`` on a function attribute is a
# read-modify-write, and scorer threads sharing the card launch at once
_COUNT_LOCK = threading.Lock()


def histogram_reference(binned: torch.Tensor, data: torch.Tensor,
                        n_bins: int) -> torch.Tensor:
    """Plain PyTorch version of :func:`histogram`: ``index_add_`` of each
    row's data into flat ids ``feature * n_bins + bin``.

    binned [N, F] uint8/uint16 (every bin < n_bins); data [N, 3] f32.
    Returns [F, n_bins, 3] f32. On the CPU ``index_add_`` adds in index
    order, so each (feature, bin) is summed in row order from zero; on a
    CUDA device it adds with atomics, in no fixed order.
    """
    n, f = binned.shape
    ids = (binned.long() + torch.arange(f, device=binned.device)[None, :]
           * n_bins).reshape(-1)
    flat = data[:, None, :].expand(n, f, 3).reshape(n * f, 3)
    out = torch.zeros((f * n_bins, 3), dtype=torch.float32,
                      device=binned.device)
    return out.index_add_(0, ids, flat).reshape(f, n_bins, 3)


@dataclasses.dataclass(frozen=True)
class BinIndex:
    """The rows of a binned matrix sorted by bin, feature by feature: what
    K1 walks. Built by :func:`bin_index` (or :func:`mask_features`) from
    one binned tensor, which it holds as ``source`` with that tensor's
    version counter at the time, so that it describes no other bins."""
    order: torch.Tensor   # [F, N] int32: row ids, stably sorted by bin
    start: torch.Tensor   # [F, n_bins + 1] int32: where bin b's rows begin
    n: int
    f: int
    n_bins: int
    source: torch.Tensor = dataclasses.field(repr=False, compare=False)
    version: int = dataclasses.field(compare=False)

    def check(self, binned: torch.Tensor, n_bins: int) -> None:
        """Raise unless this index was built from ``binned`` itself (the
        same memory, layout and dtype, not written since) and ``n_bins``."""
        if (self.n, self.f, self.n_bins) != (*binned.shape, n_bins):
            raise ValueError(
                f"bin index built for (N, F, n_bins) = ({self.n}, {self.f}, "
                f"{self.n_bins}), used for ({', '.join(map(str, binned.shape))}"
                f", {n_bins})")
        src = self.source
        if (binned.device != src.device or binned.dtype != src.dtype
                or binned.data_ptr() != src.data_ptr()
                or binned.stride() != src.stride()):
            raise ValueError("bin index built from another binned tensor "
                             "than the one it is used with")
        if binned._version != self.version:
            raise ValueError("bin index built before its binned tensor was "
                             "written in place")


def _check_bins(name: str, binned: torch.Tensor, n_bins: int) -> None:
    if binned.dim() != 2 or binned.dtype not in _BIN_DTYPES:
        raise TypeError(f"{name}: binned must be [N, F] uint8 or uint16, "
                        f"got {binned.dtype} of shape {tuple(binned.shape)}")
    if not 1 <= n_bins <= 65_536:
        raise ValueError(f"{name}: n_bins must be in [1, 65536], "
                         f"got {n_bins}")


def bin_index(binned: torch.Tensor, n_bins: int) -> BinIndex:
    """The :class:`BinIndex` of ``binned`` [N, F] uint8/uint16, on its
    device: for each feature the row ids stably sorted by bin (so the rows
    of one bin keep row order) and where each bin's segment begins; rows
    with a bin >= n_bins sort past the last segment. Layout work done once
    per fit, as the binning is; counted in ``bin_index.builds``."""
    _check_bins("bin_index", binned, n_bins)
    n, f = binned.shape
    keys, order = torch.sort(binned.t().to(torch.int32).contiguous(), dim=1,
                             stable=True)
    bounds = torch.arange(n_bins + 1, dtype=torch.int32,
                          device=binned.device).expand(f, -1).contiguous()
    start = torch.searchsorted(keys, bounds, out_int32=True)
    bin_index.builds += 1
    return BinIndex(order.to(torch.int32).contiguous(), start.contiguous(),
                    n, f, int(n_bins), binned, binned._version)


bin_index.builds = 0


def mask_features(index: BinIndex, binned: torch.Tensor,
                  keep: torch.Tensor) -> Tuple[torch.Tensor, BinIndex]:
    """Bins with the features outside ``keep`` [F] bool moved to the last
    bin (``feature_fraction``: such a feature has one bin, so it never
    splits), and their index, derived from ``index`` (``binned``'s) without
    a sort: a moved feature's rows are ``arange(N)``, all in the last
    segment, which is what :func:`bin_index` of the moved bins gives.
    Counted in ``mask_features.builds``."""
    index.check(binned, index.n_bins)
    last = index.n_bins - 1
    moved = torch.where(keep[None, :], binned,
                        torch.full_like(binned, last)).contiguous()
    rows = torch.arange(index.n, dtype=torch.int32, device=binned.device)
    one_segment = torch.full((index.n_bins + 1,), 0, dtype=torch.int32,
                             device=binned.device)
    one_segment[-1] = index.n
    order = torch.where(keep[:, None], index.order, rows[None, :])
    start = torch.where(keep[:, None], index.start, one_segment[None, :])
    mask_features.builds += 1
    return moved, BinIndex(order.contiguous(), start.contiguous(), index.n,
                           index.f, index.n_bins, moved, moved._version)


mask_features.builds = 0


def _hist_launcher():
    from synapseml_tpu_torch import _build

    fn = _build.load("histogram").histogram_launch
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 3 + [
            ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def histogram(binned: torch.Tensor, data: torch.Tensor, n_bins: int,
              index: Optional[BinIndex] = None) -> torch.Tensor:
    """[F, n_bins, 3] f32: ``out[f, b] = sum of data[r]`` over the rows r
    with ``binned[r, f] == b``, in row order.

    binned [N, F] uint8 or uint16, contiguous (every bin < n_bins, at most
    65,536 bins); data [N, 3] f32, contiguous, on the same device: the
    (grad, hess, count) of each row, zero for masked rows. ``index`` is
    ``bin_index(binned, n_bins)``, built once by the caller that launches
    K1 many times on the same bins; it must have been built from this
    ``binned`` tensor, unwritten since, and ``n_bins``
    (:meth:`BinIndex.check`), else the call raises. CPU tensors run
    :func:`histogram_reference` (a given index is checked, then not
    read); CUDA tensors launch ``csrc/histogram.cu``
    on the index (built here when none is given) and count it in
    ``histogram.launches``.
    """
    if binned.device.type == "cpu":
        if index is not None:
            index.check(binned, n_bins)
        return histogram_reference(binned, data, n_bins)
    if binned.device.type != "cuda":
        raise ValueError(f"histogram: unsupported device {binned.device}")
    _check_bins("histogram", binned, n_bins)
    n, f = binned.shape
    if data.device != binned.device or data.dtype != torch.float32:
        raise TypeError(f"histogram: data must be float32 on {binned.device}"
                        f", got {data.dtype} on {data.device}")
    if tuple(data.shape) != (n, 3):
        raise ValueError(f"histogram: data has shape {tuple(data.shape)}, "
                         f"want ({n}, 3)")
    if not (binned.is_contiguous() and data.is_contiguous()):
        raise ValueError("histogram: binned and data must be contiguous")
    if index is None:
        index = bin_index(binned, n_bins)
    else:
        index.check(binned, n_bins)
        if index.order.device != binned.device:
            raise ValueError(f"histogram: the bin index is on "
                             f"{index.order.device}, binned on "
                             f"{binned.device}")
    out = torch.empty((f, n_bins, 3), dtype=torch.float32,
                      device=binned.device)
    if f == 0:
        return out
    with torch.cuda.device(binned.device):
        stream = torch.cuda.current_stream(binned.device).cuda_stream
        rc = _hist_launcher()(index.order.data_ptr(),
                              index.start.data_ptr(), data.data_ptr(),
                              out.data_ptr(), n, f, int(n_bins), stream)
    if rc != 0:
        raise RuntimeError(f"histogram: kernel launch failed with CUDA "
                           f"error {rc}")
    with _COUNT_LOCK:
        histogram.launches += 1
    return out


histogram.launches = 0


def forest_traverse_reference(x: torch.Tensor, feat: torch.Tensor,
                              thr: torch.Tensor, left: torch.Tensor,
                              right: torch.Tensor, value: torch.Tensor,
                              k: int = 1, depth: Optional[int] = None,
                              strict: bool = False) -> torch.Tensor:
    """Plain PyTorch version of :func:`forest_traverse`: a loop over trees
    in order and over ``depth`` walk steps, with tensor gathers.

    x [N, F] f32; feat/left/right [T, M] int; thr/value [T, M] f32.
    NaN compares false and goes right; ``strict`` compares ``x < thr``
    (isolation forest), else ``x <= thr`` (GBDT). A node with ``feat < 0``
    is a leaf and keeps its place. Feature and child indices are clamped
    into range, as the JAX reference's gathers clamp. Returns [N, k] f32.
    """
    n, f = x.shape
    t, m = feat.shape
    if depth is None:
        depth = m // 2 + 1
    out = torch.zeros((n, k), dtype=torch.float32, device=x.device)
    if n == 0 or t == 0:
        return out
    rows = torch.arange(n, device=x.device)
    feat, left, right = feat.long(), left.long(), right.long()
    for ti in range(t):
        node = torch.zeros(n, dtype=torch.long, device=x.device)
        for _ in range(depth):
            fi = feat[ti][node]
            xv = x[rows, fi.clamp(0, f - 1)]
            th = thr[ti][node]
            go_left = xv < th if strict else xv <= th
            nxt = torch.where(go_left, left[ti][node], right[ti][node])
            node = torch.where(fi < 0, node, nxt.clamp(0, m - 1))
        out[:, ti % k] += value[ti][node]
    return out


def _check(x, planes, k: int) -> None:
    feat, thr, left, right, value = planes
    if x.dim() != 2 or feat.dim() != 2:
        raise ValueError("forest_traverse: x must be [N, F] and the tree "
                         "planes [T, M]")
    shape = feat.shape
    for name, a, dtype in (("x", x, torch.float32),
                           ("feat", feat, torch.int32),
                           ("thr", thr, torch.float32),
                           ("left", left, torch.int32),
                           ("right", right, torch.int32),
                           ("value", value, torch.float32)):
        if a.device != x.device:
            raise ValueError(f"forest_traverse: {name} is on {a.device}, "
                             f"x on {x.device}")
        if a.dtype != dtype:
            raise TypeError(f"forest_traverse: {name} must be {dtype}, "
                            f"got {a.dtype}")
        if not a.is_contiguous():
            raise ValueError(f"forest_traverse: {name} must be contiguous")
        if name != "x" and a.shape != shape:
            raise ValueError(f"forest_traverse: {name} has shape "
                             f"{tuple(a.shape)}, feat {tuple(shape)}")
    if k < 1:
        raise ValueError(f"forest_traverse: k must be >= 1, got {k}")
    if shape[0] > 0 and shape[1] < 1:
        raise ValueError("forest_traverse: a tree needs at least one node")
    if x.shape[1] < 1:
        raise ValueError("forest_traverse: x needs at least one feature")


def _launcher():
    from synapseml_tpu_torch import _build

    lib = _build.load("forest_traverse")
    fn = lib.forest_traverse_launch
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 7 + [
            ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def forest_traverse(x: torch.Tensor, feat: torch.Tensor, thr: torch.Tensor,
                    left: torch.Tensor, right: torch.Tensor,
                    value: torch.Tensor, k: int = 1,
                    depth: Optional[int] = None,
                    strict: bool = False) -> torch.Tensor:
    """Walk every row of ``x`` through all trees; [N, k] f32 leaf sums.

    ``depth`` bounds the walk (default ``M // 2 + 1``, the worst case of a
    tree of M nodes; the isolation forest passes ``max_depth + 1``).
    CPU tensors run :func:`forest_traverse_reference`; CUDA tensors launch
    ``csrc/forest_traverse.cu`` and count it in ``forest_traverse.launches``.
    """
    if x.device.type == "cpu":
        return forest_traverse_reference(x, feat, thr, left, right, value,
                                         k=k, depth=depth, strict=strict)
    if x.device.type != "cuda":
        raise ValueError(f"forest_traverse: unsupported device {x.device}")
    _check(x, (feat, thr, left, right, value), k)
    n, f = x.shape
    t, m = feat.shape
    if depth is None:
        depth = m // 2 + 1
    if n == 0 or t == 0:
        return torch.zeros((n, k), dtype=torch.float32, device=x.device)
    out = torch.empty((n, k), dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = _launcher()(
            x.data_ptr(), feat.data_ptr(), thr.data_ptr(), left.data_ptr(),
            right.data_ptr(), value.data_ptr(), out.data_ptr(),
            n, f, t, m, int(k), int(depth), int(bool(strict)), stream)
    if rc != 0:
        raise RuntimeError(f"forest_traverse: kernel launch failed with CUDA "
                           f"error {rc}")
    with _COUNT_LOCK:
        forest_traverse.launches += 1
    return out


forest_traverse.launches = 0

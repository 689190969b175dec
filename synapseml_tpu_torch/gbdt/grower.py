"""Leaf-wise histogram tree grower, and single-tree predict.

Counterpart of ``synapseml_tpu/gbdt/grower.py``: ``GrowerParams``, the
per-leaf ``histogram`` (kernel K1), the split search (``_split_gains``,
``best_split``), leaf-wise growth (``build_tree``), the ``Tree`` record and
``predict_tree``/``predict_tree_binned`` (kernel K2 with one tree), and
the data-parallel forms: with a process ``group``, ``histogram`` reduces
each rank's K1 result across the ranks (the reference's ``psum`` over
"dp"), and ``build_tree`` either reduces every histogram (data_parallel)
or, with ``voting_top_k``, keeps them local and reduces only the leaf
totals and the elected features' histograms (``best_split_voting``,
voting_parallel). The reductions are the rank-ordered sums of
:mod:`synapseml_tpu_torch.parallel.collectives`, so every rank takes the
same split decisions.

The reference grows a tree inside one jitted ``lax.fori_loop`` with
one-hot selects for every state update. Here the loop is plain Python:
the per-leaf histograms, the row partition and the split search run on
the device of ``binned``; the few numbers of each split (the two
children's best gains, features and bins, and their row counts) come to
the host in one copy per split, where the next leaf is chosen and the
node table is filled. The loop ends at the first step whose best gain
does not exceed ``min_gain_to_split``; from there on the reference's loop
changes nothing. Node numbering, the leaf value ``-l1(G)/(H+l2+1e-12)``
and the first-maximum tie order of ``best_split`` are the reference's.

Prefix sums over bins and the leaf totals are taken in float64 and
rounded once to float32, so split gains do not depend on the order in
which a device scans or reduces (on the CPU PyTorch accumulates a float32
cumsum in float64 anyway).
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

import numpy as np
import torch

from synapseml_tpu_torch.gbdt import kernels
from synapseml_tpu_torch.gbdt.kernels import forest_traverse
from synapseml_tpu_torch.parallel import collectives


@dataclasses.dataclass(frozen=True)
class GrowerParams:
    num_leaves: int = 31
    max_bin: int = 256               # device histogram width (incl. missing bin)
    max_depth: int = 0               # 0 = unlimited
    lambda_l1: float = 0.0
    lambda_l2: float = 0.0
    min_data_in_leaf: int = 20
    min_sum_hessian_in_leaf: float = 1e-3
    min_gain_to_split: float = 0.0
    # carried so params round-trip with the reference; the port has one
    # histogram (K1), so it is not read
    hist_backend: str = "auto"
    # > 0: voting_parallel elects this many features a split (read only
    # when build_tree is given a process group)
    voting_top_k: int = 0


@dataclasses.dataclass
class Tree:
    """Flat tree arrays (host numpy or tensors). M = 2*num_leaves - 1 nodes."""
    split_feature: torch.Tensor   # [M] int32, -1 => leaf/unused
    threshold: torch.Tensor       # [M] float32 raw-value threshold (<= goes left)
    threshold_bin: torch.Tensor   # [M] int32 bin threshold (<= goes left)
    left_child: torch.Tensor      # [M] int32
    right_child: torch.Tensor     # [M] int32
    leaf_value: torch.Tensor      # [M] float32 (valid where split_feature < 0)
    cover: torch.Tensor           # [M] float32 training row count per node
    gain: torch.Tensor            # [M] float32 split gain (internal nodes)


def histogram(binned: torch.Tensor, grad: torch.Tensor, hess: torch.Tensor,
              mask: torch.Tensor, n_bins: int,
              index: Optional[kernels.BinIndex] = None,
              group=None) -> torch.Tensor:
    """[F, B, 3] histogram of (grad, hess, count) over the rows in ``mask``:
    kernel K1 on a CUDA device (on ``index``, the bins' per-fit
    :func:`~synapseml_tpu_torch.gbdt.kernels.bin_index`, where the caller
    has one), its plain version on the CPU. With a process ``group`` each
    rank's histogram of its own rows is summed over the ranks in rank
    order."""
    w = mask.to(torch.float32)
    data = torch.stack([grad * w, hess * w, w], dim=-1)
    hist = kernels.histogram(binned, data, n_bins, index=index)
    if group is not None:
        hist = collectives.all_reduce_sum(hist, group)
    return hist


def _l1_threshold(g, l1):
    return torch.sign(g) * torch.clamp(g.abs() - l1, min=0.0)


def _leaf_objective(g, h, p: GrowerParams):
    gl1 = _l1_threshold(g, p.lambda_l1)
    return gl1 * gl1 / (h + p.lambda_l2 + 1e-12)


def _split_gains(hist, totals, p: GrowerParams, depth_ok: bool,
                 constrained: bool = True):
    """Split gains [..., F, B] of histograms [..., F, B, 3] with leaf
    totals [..., 3]; -inf where a side breaks the min-data/min-hessian
    limits or the depth limit is reached. ``constrained=False`` drops the
    min-data/min-hessian limits and keeps only a non-empty right side (the
    voting fallback's ranking, never a split decision)."""
    cum = torch.cumsum(hist, dim=-2, dtype=torch.float64).to(torch.float32)
    gl, hl, cl = cum.unbind(-1)
    gt, ht, ct = totals[..., None, None, :].unbind(-1)
    gr, hr, cr = gt - gl, ht - hl, ct - cl
    gain = (_leaf_objective(gl, hl, p) + _leaf_objective(gr, hr, p)
            - _leaf_objective(gt, ht, p))
    if not constrained:
        return torch.where((cr > 0) & bool(depth_ok), gain, -torch.inf)
    valid = ((cl >= p.min_data_in_leaf) & (cr >= p.min_data_in_leaf)
             & (hl >= p.min_sum_hessian_in_leaf)
             & (hr >= p.min_sum_hessian_in_leaf))
    return torch.where(valid & bool(depth_ok), gain, -torch.inf)


def best_split(hist, totals, p: GrowerParams, depth_ok: bool = True):
    """Best (gain, feature, bin) of each leaf: hist [..., F, B, 3], totals
    [..., 3]. Split semantics: bin <= b goes left. Ties go to the first
    maximum in row-major [F, B] order."""
    gain = _split_gains(hist, totals, p, depth_ok)
    n_bins = gain.shape[-1]
    flat = gain.flatten(-2)
    idx = flat.argmax(-1)
    return (flat.gather(-1, idx[..., None])[..., 0],
            (idx // n_bins).to(torch.int32), (idx % n_bins).to(torch.int32))


def _top_k(x: torch.Tensor, k: int) -> torch.Tensor:
    """Indices of the ``k`` largest of ``x`` along the last dim, ties to
    the lowest index first (``lax.top_k``; ``torch.topk`` promises no
    order of ties)."""
    return torch.sort(x, dim=-1, descending=True, stable=True).indices[..., :k]


def best_split_voting(hist_local, totals, p: GrowerParams, depth_ok: bool,
                      group):
    """PV-tree elected best split of each leaf (LightGBM voting_parallel;
    the reference's ``best_split_voting``): hist_local [..., F, B, 3] this
    rank's histograms, totals [..., 3] the leaves' GLOBAL totals. Each rank
    ranks the features by their best LOCAL gain (by the unconstrained
    gains where every local candidate breaks the min-data/min-hessian
    limits), the rank-ordered sum of the votes elects ``voting_top_k``
    features, ties to the lower feature id, and only the elected
    features' histograms are reduced. Elected ids are sorted, so gain ties
    resolve in global feature order as in :func:`best_split`. Returns
    (gain, global feature id, bin), the same on every rank."""
    f = hist_local.shape[-3]
    k = int(min(p.voting_top_k, f))
    local_tot = hist_local[..., 0, :, :].sum(-2, dtype=torch.float64).to(
        torch.float32)
    masked_f = _split_gains(hist_local, local_tot, p, depth_ok).amax(-1)
    raw_f = _split_gains(hist_local, local_tot, p, depth_ok,
                         constrained=False).amax(-1)
    local_gain_f = torch.where(
        torch.isfinite(masked_f.amax(-1, keepdim=True)), masked_f, raw_f)
    top_local = _top_k(local_gain_f, k)
    votes = torch.zeros_like(local_gain_f).scatter_(-1, top_local, 1.0)
    votes = collectives.all_reduce_sum(votes, group)
    order_score = votes * f + torch.arange(
        f, 0, -1, dtype=torch.float32, device=votes.device) / f
    elected = torch.sort(_top_k(order_score, k), dim=-1).values
    hist_elected = collectives.all_reduce_sum(torch.take_along_dim(
        hist_local, elected[..., None, None], dim=-3), group)
    gain, f_local, b_best = best_split(hist_elected, totals, p, depth_ok)
    feat = elected.gather(-1, f_local.long()[..., None])[..., 0]
    return gain, feat.to(torch.int32), b_best


def _leaf_totals(hist_leaf: torch.Tensor) -> torch.Tensor:
    """(G, H, C) of a leaf: its feature-0 histogram summed over bins."""
    return hist_leaf[0].sum(0, dtype=torch.float64).to(torch.float32)


def _to_host(*tensors: torch.Tensor) -> List[np.ndarray]:
    """Several small device tensors in one device-to-host copy (exact:
    every value is a float32 or an int below 2^53)."""
    flat = torch.cat([t.reshape(-1).to(torch.float64) for t in tensors])
    flat = flat.cpu().numpy()
    out, at = [], 0
    for t in tensors:
        out.append(flat[at:at + t.numel()])
        at += t.numel()
    return out


def _partition(row_slot: torch.Tensor, binned: torch.Tensor, leaf: int,
               feat: int, thr_bin: int, right_slot: int) -> torch.Tensor:
    """Move the rows of slot ``leaf`` whose bin of ``feat`` is above
    ``thr_bin`` to slot ``right_slot``."""
    col = binned[:, feat].to(torch.int32)
    return torch.where((row_slot == leaf) & (col > thr_bin), right_slot,
                       row_slot)


def build_tree(binned: torch.Tensor, grad: torch.Tensor, hess: torch.Tensor,
               row_mask: torch.Tensor, threshold_values, p: GrowerParams,
               index: Optional[kernels.BinIndex] = None, group=None
               ) -> Tuple[Tree, torch.Tensor, torch.Tensor, np.ndarray]:
    """Grow one tree on the device of ``binned``.

    binned [N, F] uint8/uint16; grad, hess [N] f32; row_mask [N] bool;
    threshold_values [F, B] raw split value per (feature, bin), host;
    ``index`` the bins' ``kernels.bin_index(binned, p.max_bin)``, which
    every histogram of the tree reads (the boosting loop builds it once a
    fit). Returns (tree of host numpy arrays, row_slot [N] int32 on the
    device, slot_value [L] f32 on the device, slot_node [L] host int32).

    With a process ``group`` the rows are this rank's shard and every rank
    grows the same tree (the reference's ``axis_name="dp"``): data_parallel
    reduces the root's and each right child's histogram and takes the left
    one by subtraction of reduced histograms; with ``p.voting_top_k > 0``
    (voting_parallel) histograms and their subtraction stay local and only
    the leaf totals and the elected features' histograms are reduced.
    Without a group, ``voting_top_k`` is not read: voting_parallel trains
    as data_parallel, as in the reference.
    """
    dev = binned.device
    n, f = binned.shape
    n_leaves = p.num_leaves
    m = 2 * n_leaves - 1
    n_bins = p.max_bin
    min_gain = np.float32(p.min_gain_to_split)
    voting = p.voting_top_k > 0 and group is not None
    hist_group = None if voting else group

    def leaf_totals(h):
        tot = _leaf_totals(h)
        return collectives.all_reduce_sum(tot, group) if voting else tot

    def search(h, tot, depth_ok):
        if voting:
            return best_split_voting(h, tot, p, depth_ok, group)
        return best_split(h, tot, p, depth_ok)

    hist = torch.zeros((n_leaves, f, n_bins, 3), dtype=torch.float32,
                       device=dev)
    totals = torch.zeros((n_leaves, 3), dtype=torch.float32, device=dev)
    hist[0] = histogram(binned, grad, hess, row_mask, n_bins, index,
                        hist_group)
    totals[0] = leaf_totals(hist[0])
    g0, f0, b0 = search(hist[0], totals[0], True)

    best_gain = np.full(n_leaves, -np.inf, np.float32)
    best_feat = np.zeros(n_leaves, np.int64)
    best_bin = np.zeros(n_leaves, np.int64)
    slot_node = np.full(n_leaves, -1, np.int32)
    slot_node[0] = 0
    slot_depth = np.zeros(n_leaves, np.int64)
    node_feature = np.full(m, -1, np.int32)
    node_bin = np.zeros(m, np.int32)
    node_left = np.zeros(m, np.int32)
    node_right = np.zeros(m, np.int32)
    node_cover = np.zeros(m, np.float32)
    node_gain = np.zeros(m, np.float32)
    g0, f0, b0, c0 = _to_host(g0, f0, b0, totals[0, 2])
    best_gain[0], best_feat[0], best_bin[0] = g0[0], f0[0], b0[0]
    node_cover[0] = c0[0]

    row_slot = torch.zeros(n, dtype=torch.int32, device=dev)
    for s in range(1, n_leaves):
        leaf = int(np.argmax(best_gain))
        gain = best_gain[leaf]
        if not gain > min_gain:
            break  # the reference's remaining steps change nothing
        feat, thr_bin = int(best_feat[leaf]), int(best_bin[leaf])
        parent = slot_node[leaf]
        left_id, right_id = 2 * s - 1, 2 * s
        node_feature[parent] = feat
        node_bin[parent] = thr_bin
        node_left[parent] = left_id
        node_right[parent] = right_id
        node_gain[parent] = gain

        # partition the split leaf's rows, then the right child's
        # histogram fresh (K1) and the left one by subtraction
        row_slot = _partition(row_slot, binned, leaf, feat, thr_bin, s)
        hist_r = histogram(binned, grad, hess, (row_slot == s) & row_mask,
                           n_bins, index, hist_group)
        tot_r = leaf_totals(hist_r)
        hist[leaf] -= hist_r
        totals[leaf] -= tot_r
        hist[s] = hist_r
        totals[s] = tot_r

        new_depth = int(slot_depth[leaf]) + 1
        slot_depth[leaf] = slot_depth[s] = new_depth
        slot_node[leaf], slot_node[s] = left_id, right_id
        depth_ok = p.max_depth <= 0 or new_depth < p.max_depth
        pair = torch.stack([hist[leaf], hist_r])
        gains, feats, bins = search(
            pair, torch.stack([totals[leaf], tot_r]), depth_ok)
        gains, feats, bins, covers = _to_host(
            gains, feats, bins, torch.stack([totals[leaf, 2], tot_r[2]]))
        best_gain[[leaf, s]] = gains
        best_feat[[leaf, s]] = feats
        best_bin[[leaf, s]] = bins
        node_cover[left_id], node_cover[right_id] = covers

    # leaf values: -ThresholdL1(G) / (H + l2)
    sn = torch.from_numpy(slot_node).to(dev)
    slot_value = (-_l1_threshold(totals[:, 0], p.lambda_l1)
                  / (totals[:, 1] + p.lambda_l2 + 1e-12))
    slot_value = torch.where(sn >= 0, slot_value, 0.0)
    tree = Tree(
        split_feature=node_feature,
        threshold=np.where(
            node_feature >= 0,
            np.asarray(threshold_values, np.float32)[
                np.clip(node_feature, 0, None), node_bin], 0.0
        ).astype(np.float32),
        threshold_bin=node_bin,
        left_child=node_left,
        right_child=node_right,
        leaf_value=leaf_values(slot_node, _to_host(slot_value)[0], m),
        cover=node_cover,
        gain=node_gain,
    )
    return tree, row_slot, slot_value, slot_node


def leaf_values(slot_node: np.ndarray, slot_value: np.ndarray,
                m: int) -> np.ndarray:
    """[M] float32 node table with each live slot's value at its node."""
    out = np.zeros(m, np.float32)
    live = slot_node >= 0
    out[slot_node[live]] = slot_value[live]
    return out


def _single_tree(feat, thr, left, right, value, x) -> torch.Tensor:
    """One-tree call into the forest traversal (T=1 stack); ``x`` and
    ``thr`` are float32."""
    return forest_traverse(
        x.contiguous(), feat.to(torch.int32)[None, :].contiguous(),
        thr[None, :].contiguous(), left.to(torch.int32)[None, :].contiguous(),
        right.to(torch.int32)[None, :].contiguous(),
        value.to(torch.float32)[None, :].contiguous(), k=1)[:, 0]


def predict_tree(tree_arrays, x: torch.Tensor) -> torch.Tensor:
    """Traversal on raw features. x: [N, F] float32 tensor.

    tree_arrays: tuple of [M] tensors (feature, threshold, left, right,
    value) on x's device. NaN comparisons are false, so missing goes right
    (matches training, where the missing bin sorts after every splittable
    bin). Returns [N] float32 leaf values.
    """
    feat, thr, left, right, value = tree_arrays
    return _single_tree(feat, thr.to(torch.float32), left, right, value,
                        x.to(torch.float32))


def predict_tree_binned(tree_arrays, binned: torch.Tensor) -> torch.Tensor:
    """Traversal on pre-binned rows (training-time refit / fast path).

    Bin ids and bin thresholds are cast to float32, which is exact below
    2^24 (uint8/uint16 bins), so the integer ``<=`` comparison holds."""
    feat, thr_bin, left, right, value = tree_arrays
    return _single_tree(feat, thr_bin.to(torch.float32), left, right, value,
                        binned.to(torch.float32))

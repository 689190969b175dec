"""GBDT objectives (gradients and hessians) and eval metrics, in PyTorch.

Counterpart of ``synapseml_tpu/gbdt/objectives.py``: the same formulas as
plain tensor functions, so grad/hess run on the device that holds the
scores. Custom objectives are plain callables
``(preds, labels, weight) -> (grad, hess)``. LambdaRank (the Ranker's
objective) has a dense ``[N, N]`` form and a block-diagonal ``[Q, G, G]``
form over query blocks.

The transcendental functions (sigmoid, softmax, exp, log2) of the
objectives are evaluated in float64 and rounded once to float32: the
card's and the CPU's float32 ``exp`` differ in the last bit, and through
the histograms that would let a near-tied split go one way on the card
and the other on the CPU. The rest of the arithmetic is float32, as in
the reference, but for LambdaRank's sums over a row's pairs, which add
the reference's float32 pair terms in float64 and round once.
"""
from __future__ import annotations

from typing import Callable, Optional, Tuple

import numpy as np
import torch

Tensor = torch.Tensor
ObjectiveFn = Callable[[Tensor, Tensor, Optional[Tensor]],
                       Tuple[Tensor, Tensor]]


def _f64(fn, x: Tensor) -> Tensor:
    """``fn`` of float32 ``x`` evaluated in float64, rounded to float32."""
    return fn(x.to(torch.float64)).to(torch.float32)


def _weighted(grad, hess, weight):
    if weight is not None:
        grad = grad * weight
        hess = hess * weight
    return grad, hess


# -- binary -----------------------------------------------------------------

def binary_logloss_obj(preds, labels, weight=None, sigmoid: float = 1.0):
    p = _f64(torch.sigmoid, sigmoid * preds)
    grad = sigmoid * (p - labels)
    hess = sigmoid * sigmoid * p * (1.0 - p)
    return _weighted(grad, hess, weight)


# -- regression -------------------------------------------------------------

def l2_obj(preds, labels, weight=None):
    return _weighted(preds - labels, torch.ones_like(preds), weight)


def l1_obj(preds, labels, weight=None):
    return _weighted(torch.sign(preds - labels), torch.ones_like(preds), weight)


def huber_obj(preds, labels, weight=None, alpha: float = 0.9):
    diff = preds - labels
    grad = torch.where(diff.abs() <= alpha, diff, alpha * torch.sign(diff))
    return _weighted(grad, torch.ones_like(preds), weight)


def fair_obj(preds, labels, weight=None, c: float = 1.0):
    diff = preds - labels
    grad = c * diff / (diff.abs() + c)
    hess = c * c / (diff.abs() + c) ** 2
    return _weighted(grad, hess, weight)


def poisson_obj(preds, labels, weight=None, max_delta_step: float = 0.7):
    exp_p = _f64(torch.exp, preds)
    grad = exp_p - labels
    hess = _f64(torch.exp, preds + max_delta_step)
    return _weighted(grad, hess, weight)


def quantile_obj(preds, labels, weight=None, alpha: float = 0.5):
    diff = labels - preds
    grad = torch.where(diff >= 0, -alpha, 1.0 - alpha).to(preds.dtype)
    return _weighted(grad, torch.ones_like(preds), weight)


def mape_obj(preds, labels, weight=None):
    denom = torch.clamp(labels.abs(), min=1.0)
    grad = torch.sign(preds - labels) / denom
    return _weighted(grad, torch.ones_like(preds) / denom, weight)


def tweedie_obj(preds, labels, weight=None, rho: float = 1.5):
    exp1 = _f64(torch.exp, (1.0 - rho) * preds)
    exp2 = _f64(torch.exp, (2.0 - rho) * preds)
    grad = -labels * exp1 + exp2
    hess = -labels * (1.0 - rho) * exp1 + (2.0 - rho) * exp2
    return _weighted(grad, hess, weight)


# -- multiclass (grad/hess per class; trees per class per iteration) --------

def softmax_obj(preds, labels_onehot, weight=None):
    """preds: [N, K] raw scores; labels_onehot: [N, K]."""
    p = _f64(lambda z: torch.softmax(z, dim=-1), preds)
    grad = p - labels_onehot
    hess = 2.0 * p * (1.0 - p)
    if weight is not None:
        grad = grad * weight[:, None]
        hess = hess * weight[:, None]
    return grad, hess


# -- lambdarank -------------------------------------------------------------

# Pair terms a LambdaRank call forms at once (each of its few temporaries
# holds this many elements): memory stays bounded at any query count and
# query size.
_PAIR_CHUNK = 1 << 22


def _pair_sums(p_row, p_col, gain_row, gain_col, disc_row, disc_col,
               pair, sigmoid: float):
    """Per-row LambdaRank sums of a ``[..., R]`` block of rows against a
    ``[..., C]`` block of columns: the terms in which the row is the
    better-labelled document (``pair[0]``, label above the column's) less
    those in which it is the worse one (``pair[1]``), and the hessian's
    terms of both. Each term is the reference's float32 product, in its
    order (scaling by ``sigmoid``, a power of two, commutes with
    rounding); the sums are float64, rounded once."""
    diff = p_row[..., :, None] - p_col[..., None, :]
    delta = ((gain_row[..., :, None] - gain_col[..., None, :])
             * (disc_row[..., :, None] - disc_col[..., None, :])).abs_()
    out = []
    for sign, mask in ((-1.0, pair[0]), (1.0, pair[1])):
        # s_ij = sigmoid(-sigma (p_i - p_j)); for the pair (j, i) it is
        # sigmoid(+sigma (p_i - p_j)), bitwise, as p_j - p_i = -(p_i - p_j)
        s = _f64(torch.sigmoid, diff * (sign * sigmoid))
        weighted = delta * mask
        lam = (s * weighted).sum(-1, dtype=torch.float64) * -sigmoid
        hp = ((s * (1.0 - s)) * weighted).sum(-1, dtype=torch.float64) * (
            sigmoid * sigmoid)
        out.append((lam, hp))
    (lam_row, hp_row), (lam_col, hp_col) = out
    return lam_row - lam_col, hp_row + hp_col


def _discount(ranks: Tensor, max_dcg_pos: int) -> Tensor:
    """float32 ``1 / log2(2 + min(rank, max_dcg_pos))``."""
    return 1.0 / _f64(torch.log2,
                      2.0 + ranks.clamp(max=max_dcg_pos).to(torch.float32))


def _group_ranks(preds: Tensor, group_ids: Tensor) -> Tensor:
    """Each row's 0-based rank by descending score within its group, ties
    in row order: the reference's stable ``argsort`` of
    ``where(same, -preds, inf)`` per row, from two stable sorts."""
    by_score = torch.argsort(-preds, stable=True)
    order = by_score[torch.argsort(group_ids[by_score], stable=True)]
    g = group_ids[order]
    pos = torch.arange(len(order), device=preds.device)
    first = torch.ones_like(g, dtype=torch.bool)
    first[1:] = g[1:] != g[:-1]
    start = torch.cummax(torch.where(first, pos, 0), 0).values
    ranks = torch.empty_like(order)
    ranks[order] = pos - start
    return ranks


def lambdarank_grad(preds, labels, group_ids, max_dcg_pos: int = 30,
                    sigmoid: float = 2.0):
    """Pairwise LambdaRank gradients with |delta NDCG| weighting, the dense
    form: every pair of rows, masked to pairs of one query
    (``group_ids``, same id = same query). The ``[N, N]`` pair terms are
    made about ``_PAIR_CHUNK`` at a time, a block of rows against all
    columns; each row's sums are float64, rounded once. Returns float32
    ``(grad, hess)`` with the hessian clamped at 1e-6."""
    n = preds.shape[0]
    p = preds.to(torch.float32)
    lab = labels.to(torch.float32)
    ranks = _group_ranks(p, group_ids)
    disc = _discount(ranks, max_dcg_pos)
    gain = 2.0 ** lab - 1.0
    grad = torch.empty(n, dtype=torch.float64, device=preds.device)
    hess = torch.empty_like(grad)
    rows = max(1, _PAIR_CHUNK // max(n, 1))
    for a in range(0, n, rows):
        b = min(n, a + rows)
        same = group_ids[a:b, None] == group_ids[None, :]
        diff = lab[a:b, None] - lab[None, :]
        g, h = _pair_sums(p[a:b], p, gain[a:b], gain, disc[a:b], disc,
                          (same & (diff > 0), same & (diff < 0)), sigmoid)
        grad[a:b], hess[a:b] = g, h
    return grad.to(torch.float32), hess.to(torch.float32).clamp(min=1e-6)


def build_query_blocks(group_ids):
    """Host-side layout for block-diagonal lambdarank: rows gathered into
    [Q, G] query blocks (G = max group size). Returns
    ``(row_index [Q, G] int32, pad_mask [Q, G] bool, inv [N] int64)``
    where ``inv`` maps each flat row to its block position (for the
    gather back)."""
    group_ids = np.asarray(group_ids)
    order = np.argsort(group_ids, kind="stable")
    sorted_g = group_ids[order]
    bounds = np.nonzero(sorted_g[1:] != sorted_g[:-1])[0] + 1
    groups = np.split(order, bounds)
    gmax = max((len(g) for g in groups), default=1)
    q = len(groups)
    row_index = np.zeros((q, gmax), np.int32)
    pad_mask = np.zeros((q, gmax), bool)
    inv = np.zeros(len(group_ids), np.int64)
    for i, rows in enumerate(groups):
        row_index[i, : len(rows)] = rows
        pad_mask[i, : len(rows)] = True
        inv[rows] = i * gmax + np.arange(len(rows))
    return row_index, pad_mask, inv


def lambdarank_grad_blocked(preds, labels, row_index, pad_mask, inv,
                            max_dcg_pos: int = 30, sigmoid: float = 2.0):
    """Block-diagonal LambdaRank: O(N*G) instead of the dense O(N^2) pair
    terms, since pairs only form within a query. The ``[Q, G, G]`` pair
    terms are batched over query blocks (layout from
    :func:`build_query_blocks`, as tensors on the rows' device), about
    ``_PAIR_CHUNK`` at a time: whole blocks, or rows of one block against
    its columns where a block alone is larger. The same math as
    :func:`lambdarank_grad` on the same data."""
    idx = row_index.long()
    p = preds.to(torch.float32)[idx]
    lab = labels.to(torch.float32)[idx]
    valid = pad_mask
    order = torch.argsort(torch.where(valid, -p, torch.inf), dim=-1,
                          stable=True)
    ranks = torch.argsort(order, dim=-1)
    disc = _discount(ranks, max_dcg_pos)
    gain = (2.0 ** lab - 1.0) * valid
    q, g = idx.shape
    rows = min(g, max(1, _PAIR_CHUNK // g))
    blocks = max(1, _PAIR_CHUNK // (rows * g))
    grad = torch.empty((q, g), dtype=torch.float64, device=preds.device)
    hess = torch.empty_like(grad)
    for a in range(0, q, blocks):
        qs = slice(a, a + blocks)
        for r in range(0, g, rows):
            rs = slice(r, r + rows)
            both = valid[qs, rs, None] & valid[qs, None, :]
            diff = lab[qs, rs, None] - lab[qs, None, :]
            grad[qs, rs], hess[qs, rs] = _pair_sums(
                p[qs, rs], p[qs], gain[qs, rs], gain[qs], disc[qs, rs],
                disc[qs], (both & (diff > 0), both & (diff < 0)), sigmoid)
    grad = grad.reshape(-1)[inv].to(torch.float32)
    hess = hess.reshape(-1)[inv].to(torch.float32)
    return grad, hess.clamp(min=1e-6)


# -- metrics ----------------------------------------------------------------

def auc_metric(preds, labels, weight=None):
    """ROC AUC via the rank statistic (stable ranks, as the reference)."""
    order = torch.argsort(preds, stable=True)
    ranks = torch.argsort(order, stable=True).to(torch.float32) + 1.0
    pos = labels > 0
    n_pos = pos.sum()              # integer counts, as the reference's
    n_neg = (~pos).sum()
    sum_pos_ranks = torch.where(pos, ranks, 0.0).sum()
    return ((sum_pos_ranks - (n_pos * (n_pos + 1) / 2.0).to(torch.float32))
            / torch.clamp(n_pos * n_neg, min=1).to(torch.float32))


def binary_logloss_metric(preds, labels, weight=None, eps: float = 1e-15):
    p = torch.clamp(torch.sigmoid(preds), eps, 1 - eps)
    ll = -(labels * torch.log(p) + (1 - labels) * torch.log(1 - p))
    if weight is not None:
        return (ll * weight).sum() / weight.sum()
    return ll.mean()


def rmse_metric(preds, labels, weight=None):
    d2 = (preds - labels) ** 2
    if weight is not None:
        return torch.sqrt((d2 * weight).sum() / weight.sum())
    return torch.sqrt(d2.mean())


def mae_metric(preds, labels, weight=None):
    d = (preds - labels).abs()
    if weight is not None:
        return (d * weight).sum() / weight.sum()
    return d.mean()


def multi_logloss_metric(preds, labels_int, weight=None, eps: float = 1e-15):
    logp = torch.log_softmax(preds, dim=-1)
    nll = -torch.gather(logp, -1, labels_int.long()[:, None])[:, 0]
    if weight is not None:
        return (nll * weight).sum() / weight.sum()
    return nll.mean()


def multi_error_metric(preds, labels_int, weight=None):
    err = (preds.argmax(-1) != labels_int).to(torch.float32)
    if weight is not None:
        return (err * weight).sum() / weight.sum()
    return err.mean()


REGRESSION_OBJECTIVES = {
    "regression": l2_obj, "regression_l2": l2_obj, "l2": l2_obj,
    "mse": l2_obj, "mean_squared_error": l2_obj,
    "regression_l1": l1_obj, "l1": l1_obj, "mae": l1_obj,
    "huber": huber_obj, "fair": fair_obj, "poisson": poisson_obj,
    "quantile": quantile_obj, "mape": mape_obj, "tweedie": tweedie_obj,
}

METRICS = {
    "auc": (auc_metric, True),
    "binary_logloss": (binary_logloss_metric, False),
    "rmse": (rmse_metric, False),
    "l2": (rmse_metric, False),
    "mae": (mae_metric, False),
    "l1": (mae_metric, False),
    "multi_logloss": (multi_logloss_metric, False),
    "multi_error": (multi_error_metric, False),
}

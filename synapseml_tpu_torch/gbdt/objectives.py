"""GBDT objectives (gradients and hessians) and eval metrics, in PyTorch.

Counterpart of ``synapseml_tpu/gbdt/objectives.py``: the same formulas as
plain tensor functions, so grad/hess run on the device that holds the
scores. Custom objectives are plain callables
``(preds, labels, weight) -> (grad, hess)``. Lambdarank (the Ranker's
objective) is not ported yet; see ``ROADMAP.md``.

The exponentials (sigmoid, softmax, exp) of the objectives are evaluated
in float64 and rounded once to float32: the card's and the CPU's float32
``exp`` differ in the last bit, and through the histograms that would let
a near-tied split go one way on the card and the other on the CPU. The
rest of the arithmetic is float32, as in the reference.
"""
from __future__ import annotations

from typing import Callable, Optional, Tuple

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

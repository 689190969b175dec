"""Surrogate regressions for LIME / KernelSHAP, batched over rows.

The counterpart of the reference package's ``explainers/surrogate.py``
(itself the re-design of ref: core/.../explainers/LassoRegression.scala:74
— coordinate-descent lasso, LeastSquaresRegression.scala:8,
RegressionBase.scala:20 — weighted centering/rescaling). Each function
takes tensors with any leading batch dims (one surrogate a row) and fits
every row at once on the tensors' device: the reference's ``vmap``\\ed
solvers as batched torch ops. The normal equations go to one batched
``torch.linalg.solve_ex`` (no host sync for its error check); the lasso's
coordinate descent is 100 sweeps of D coordinate updates, in the
reference's order, as a Python loop of batched ops with no host sync.
Products run in IEEE float32 on the card (TF32 off).
"""
from __future__ import annotations

import torch

from synapseml_tpu_torch.onnx.importer import _ieee_float32


def _eye(d: int, like: torch.Tensor) -> torch.Tensor:
    return torch.eye(d, dtype=like.dtype, device=like.device)


def _solve(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.linalg.solve_ex(a, b[..., None])[0][..., 0]


def weighted_least_squares(x, y, w, fit_intercept: bool = True,
                           l2: float = 1e-6):
    """Closed-form weighted ridge-stabilized least squares.

    x: [..., S, D], y: [..., S], w: [..., S] sample weights. Returns
    (coefs [..., D], intercept [...]) (ref: LeastSquaresRegression.scala:8
    — normal equations on weighted data)."""
    w = w / (w.sum(-1, keepdim=True) + 1e-12)
    with _ieee_float32():
        if fit_intercept:
            xm = (x * w[..., None]).sum(-2)
            ym = (y * w).sum(-1)
            xc, yc = x - xm[..., None, :], y - ym[..., None]
        else:
            xm = torch.zeros(x.shape[:-2] + x.shape[-1:], dtype=x.dtype,
                             device=x.device)
            ym = torch.zeros(x.shape[:-2], dtype=x.dtype, device=x.device)
            xc, yc = x, y
        xw = xc * w[..., None]
        a = xc.transpose(-1, -2) @ xw + l2 * _eye(x.shape[-1], x)
        b = (xw.transpose(-1, -2) @ yc[..., None])[..., 0]
        coefs = _solve(a, b)
        intercept = ym - (xm * coefs).sum(-1)
    return coefs, intercept


def weighted_lasso(x, y, w, alpha, iters: int = 100):
    """Weighted lasso via cyclic coordinate descent with soft-thresholding,
    on standardized features (ref: LassoRegression.scala:10-74
    CoordinateDescentLasso). x: [..., S, D], y and w: [..., S], alpha: a
    float or [...]. Returns (coefs [..., D], intercept [...]) in the
    original scale."""
    d = x.shape[-1]
    w = w / (w.sum(-1, keepdim=True) + 1e-12)
    alpha = torch.as_tensor(alpha, dtype=x.dtype, device=x.device)
    alpha = alpha.expand(x.shape[:-2])
    with _ieee_float32():
        xm = (x * w[..., None]).sum(-2)
        ym = (y * w).sum(-1)
        xc = x - xm[..., None, :]
        yc = y - ym[..., None]
        scale = torch.sqrt((xc * xc * w[..., None]).sum(-2)) + 1e-12
        xs = xc / scale[..., None, :]
        # weighted gram quantities
        xsw = xs * w[..., None]
        g = xsw.transpose(-1, -2) @ xs                   # [..., D, D]
        c = (xsw.transpose(-1, -2) @ yc[..., None])[..., 0]  # [..., D]
        gdiag = torch.diagonal(g, dim1=-2, dim2=-1)
        beta = torch.zeros(x.shape[:-2] + (d,), dtype=x.dtype,
                           device=x.device)
        for _ in range(iters):
            for j in range(d):
                rho = (c[..., j] - (g[..., j, :] * beta).sum(-1)
                       + gdiag[..., j] * beta[..., j])
                beta[..., j] = (torch.sign(rho)
                                * torch.clamp(rho.abs() - alpha, min=0.0)
                                / (gdiag[..., j] + 1e-12))
        coefs = beta / scale
        intercept = ym - (xm * coefs).sum(-1)
    return coefs, intercept


def shap_weighted_fit(z, y, w, fnull, fx):
    """KernelSHAP solve with the efficiency constraint eliminated exactly.

    z: [..., S, D] coalition matrix, y: [..., S] model outputs, w: [..., S]
    shapley kernel weights, fnull: [...] model output on the all-background
    sample, fx: [...] output on the original row. Substitutes
    ``phi_D = (fx - fnull) - sum(phi_1..D-1)`` and solves the reduced
    weighted least squares (ridge 1e-8); the intercept is phi_0 = fnull by
    construction (ref: KernelSHAPBase.scala:42-94). Returns [..., D+1]:
    phi_0 followed by phi_1..D."""
    e = fx - fnull
    zd = z[..., -1:]
    x = z[..., :-1] - zd                           # [..., S, D-1]
    t = y - fnull[..., None] - zd[..., 0] * e[..., None]
    with _ieee_float32():
        xw = x * w[..., None]
        a = x.transpose(-1, -2) @ xw + 1e-8 * _eye(x.shape[-1], x)
        b = (xw.transpose(-1, -2) @ t[..., None])[..., 0]
        head = _solve(a, b) if x.shape[-1] else b
    last = e - head.sum(-1)
    return torch.cat([fnull[..., None], head, last[..., None]], dim=-1)

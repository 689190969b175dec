"""Perturbation samplers for LIME and KernelSHAP.

Re-design of the reference's sampler hierarchy
(ref: core/.../explainers/Sampler.scala:16-237, LIMESampler.scala:11-46,
KernelSHAPSampler.scala:14-162) as vectorized numpy sampling: a whole
[rows, samples, features] mask block is drawn in one call instead of per-row
iterators, so the downstream model scores one large contiguous batch.
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import numpy as np


def lime_state_samples(rng: np.random.Generator, n_rows: int, n_samples: int,
                       d: int, on_prob: float = 0.7) -> np.ndarray:
    """Binary on/off states in interpretable space, [R, S, D]
    (ref: LIMESampler.scala:11-46 — Bernoulli feature-state draws)."""
    return (rng.random((n_rows, n_samples, d)) < on_prob).astype(np.float32)


def lime_kernel_weights(states: np.ndarray, kernel_width: float) -> np.ndarray:
    """exp(-dist^2 / width^2) over cosine-ish distance from the all-on vector
    (ref: LIMEBase.transform:67-115 kernel weighting)."""
    d = states.shape[-1]
    frac_off = 1.0 - states.sum(axis=-1) / max(d, 1)
    return np.exp(-(frac_off ** 2) / (kernel_width ** 2)).astype(np.float32)


def shap_kernel_weight(d: int, k: int) -> float:
    """Shapley kernel pi(k) = (D-1) / (C(D,k) * k * (D-k))
    (ref: KernelSHAPSamplerSupport.scala:24 — binomial-coefficient weighting)."""
    if k <= 0 or k >= d:
        # full/empty coalitions enter the solve via the exact efficiency
        # constraint (see surrogate.shap_weighted_fit), not via weights
        return 0.0
    return (d - 1) / (math.comb(d, k) * k * (d - k))


def kernel_shap_samples(rng: np.random.Generator, n_rows: int, n_samples: int,
                        d: int) -> Tuple[np.ndarray, np.ndarray]:
    """Coalition vectors + shapley kernel weights, ([R, S, D], [R, S]).

    Coalition sizes are drawn proportionally to the shapley kernel mass per
    size, mirroring the reference's sampler which enumerates small coalitions
    first then samples (ref: KernelSHAPSampler.scala:14-162). The first sample
    of every row is the all-on coalition so the surrogate always sees f(x).
    """
    sizes = np.arange(1, d)
    if len(sizes) == 0:
        states = np.ones((n_rows, n_samples, d), np.float32)
        return states, np.ones((n_rows, n_samples), np.float32)
    size_w = np.array([shap_kernel_weight(d, int(k)) * math.comb(d, int(k))
                       for k in sizes])
    size_p = size_w / size_w.sum()
    states = np.empty((n_rows, n_samples, d), dtype=np.float32)
    weights = np.empty((n_rows, n_samples), dtype=np.float32)
    for r in range(n_rows):
        states[r, 0] = 1.0  # sample 0 is always the all-on row -> f(x)
        weights[r, 0] = 0.0
        ks = rng.choice(sizes, size=n_samples - 1, p=size_p)
        for s, k in enumerate(ks, start=1):
            idx = rng.choice(d, size=int(k), replace=False)
            row = np.zeros(d, np.float32)
            row[idx] = 1.0
            states[r, s] = row
            weights[r, s] = shap_kernel_weight(d, int(k))
    return states, weights


def apply_mask_background(x: np.ndarray, states: np.ndarray,
                          background: np.ndarray) -> np.ndarray:
    """Numeric perturbation: masked features -> background values.

    x: [R, D] originals, states: [R, S, D], background: [D] or [R, D].
    Returns [R, S, D].
    """
    bg = np.broadcast_to(background, x.shape)
    return states * x[:, None, :] + (1.0 - states) * bg[:, None, :]


def tabular_value_samples(rng: np.random.Generator, states: np.ndarray,
                          x: np.ndarray, feature_means: np.ndarray,
                          feature_stds: np.ndarray) -> np.ndarray:
    """TabularLIME perturbation: off-features are resampled from the
    background distribution N(mean, std) instead of a fixed value
    (ref: TabularLIME.scala — background-df feature stats)."""
    r, s, d = states.shape
    noise = rng.standard_normal((r, s, d)) * feature_stds + feature_means
    return states * x[:, None, :] + (1.0 - states) * noise.astype(np.float32)

"""The draws of the ONNX random ops: ``jax.random``'s, bit for bit.

The reference's ``RandomNormal``, ``RandomUniform``, ``Bernoulli`` and
``Multinomial`` call ``jax.random.normal``, ``uniform`` and
``categorical`` (threefry2x32 keys, ``jax_threefry_partitionable`` on,
the default from jax 0.5 on). The bits and the floats in ``[0, 1)`` are
:mod:`synapseml_tpu_torch.gbdt.prng`'s (:func:`~synapseml_tpu_torch.gbdt.
prng.unit`, threefry over the flat row-major iota of the output shape),
so a shape's draws are a prefix of a longer batch's along its first axis,
as in the reference. On top of them:

- :func:`uniform` is ``jax._src.random._uniform`` in float32 (the only
  format the reference draws bounded uniforms in): ``floats * (maxval -
  minval) + minval``, which XLA contracts into one fused multiply-add
  (:func:`fma`), and ``max(minval, .)``.
- :func:`normal` is ``sqrt(2) * erf_inv(u)`` over ``u`` uniform in
  ``(-1, 1)``, with XLA's float32 ``erf_inv`` (Giles' polynomial, its
  Horner steps fused multiply-adds), not ``torch.erfinv``, which is
  another approximation.
- :func:`gumbel` is ``-log(-log(u))`` over ``u`` uniform in ``[tiny, 1)``
  (``jax.random.gumbel``'s ``"low"`` mode), the noise of ``categorical``.

These are plain PyTorch ops on the key's device: the reference runs
``jax.random`` as XLA ops, outside any Pallas kernel. A draw of ``n``
values makes a few ``[n]`` int64 tensors; a uniform draw is about 200
launches (threefry's int64 rounds), a normal one about 420 (nine float64
fused multiply-adds more).
"""
from __future__ import annotations

import math
from typing import Sequence

import numpy as np
import torch

from synapseml_tpu_torch.gbdt.prng import unit

# XLA's float32 erf_inv (Giles, "Approximating the erfinv function"): the
# Horner coefficients, highest power first, for w < 5 and w >= 5
_ERFINV_LT5 = (2.81022636e-08, 3.43273939e-07, -3.5233877e-06,
               -4.39150654e-06, 0.00021858087, -0.00125372503,
               -0.00417768164, 0.246640727, 1.50140941)
_ERFINV_GE5 = (-0.000200214257, 0.000100950558, 0.00134934322,
               -0.00367342844, 0.00573950773, -0.0076224613,
               0.00943887047, 1.00167406, 2.83297682)
_SQRT2 = float(np.float32(np.sqrt(2.0)))


def fma(a: torch.Tensor, b, c) -> torch.Tensor:
    """``a * b + c`` rounded once to float32, as a fused multiply-add:
    the product of two float32 values is exact in float64, the sum is
    rounded to odd in float64 (its rounding error from TwoSum decides the
    last bit) and then to nearest in float32, which is the correctly
    rounded result (53 >= 2 * 24 + 2 bits). ``b`` and ``c`` are float32
    values: tensors or Python floats."""
    p = a.double() * (b.double() if isinstance(b, torch.Tensor) else b)
    c = c.double() if isinstance(c, torch.Tensor) else c
    s = p + c
    back = s - p
    err = (p - (s - back)) + (c - back)
    even = (s.view(torch.int64) & 1) == 0
    toward = torch.where(err > 0, math.inf, -math.inf).to(s.dtype)
    s = torch.where((err != 0) & even, torch.nextafter(s, toward), s)
    return s.float()


def uniform(key: torch.Tensor, shape: Sequence[int], minval: float = 0.0,
            maxval: float = 1.0) -> torch.Tensor:
    """``jax.random.uniform(key, shape, float32, minval, maxval)``, whose
    bounds reach XLA as traced values: scaled in one float32 fused
    multiply-add, as XLA:CPU compiles it."""
    lo = np.float32(minval)
    span = float(np.float32(maxval) - lo)
    lo = float(lo)
    return torch.clamp_min(fma(unit(key, shape), span, lo), lo)


def erf_inv(x: torch.Tensor) -> torch.Tensor:
    """XLA's float32 ``erf_inv``: ``w = -log1p(-x * x)``, a nine-term
    polynomial in ``w - 2.5`` below 5 and in ``sqrt(w) - 3`` above, each
    Horner step one fused multiply-add, times ``x``; ``+-inf`` at
    ``+-1``."""
    w = -torch.log1p(-x * x)
    lt = w < 5.0
    w = torch.where(lt, w - 2.5, torch.sqrt(w) - 3.0)
    p = torch.where(lt, _ERFINV_LT5[0], _ERFINV_GE5[0]).to(torch.float32)
    for lo, hi in zip(_ERFINV_LT5[1:], _ERFINV_GE5[1:]):
        p = fma(p, w, torch.where(lt, lo, hi).to(torch.float32))
    return torch.where(x.abs() == 1.0, x * math.inf, p * x)


def normal(key: torch.Tensor, shape: Sequence[int]) -> torch.Tensor:
    """``jax.random.normal(key, shape)``, float32."""
    lo = float(np.nextafter(np.float32(-1.0), np.float32(0.0)))
    return _SQRT2 * erf_inv(uniform(key, shape, lo, 1.0))


def gumbel(key: torch.Tensor, shape: Sequence[int],
           dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """``jax.random.gumbel(key, shape, dtype)`` (the ``"low"`` mode). Its
    uniform's bounds ``tiny`` and 1 are constants inside the reference's
    jit: XLA drops the product by ``1 - tiny`` (1.0 in every float
    format) and folds ``- 1 + tiny`` into ``- 1``, so the draw is
    ``max(tiny, floats)``."""
    tiny = float(torch.finfo(dtype).tiny)
    u = torch.clamp_min(unit(key, shape, dtype), tiny)
    return -torch.log(-torch.log(u))

"""The JAX package's random key stream in PyTorch, bit for bit.

Every sampled mask of the reference's boosting loop (bagging, GOSS,
``feature_fraction``) is drawn with ``jax.random`` from
``PRNGKey(p.seed)``. This module computes the same keys and the same bits,
so the port samples the same rows and features and grows the same trees.

It reproduces ``jax.random`` as configured by default: the threefry2x32
key type, 32-bit keys (``jax_enable_x64`` off) and
``jax_threefry_partitionable = True`` (the default from jax 0.5 on). In
that mode:

- ``split`` and ``random_bits32`` hash the counters of the output shape's
  flat iota, ``threefry2x32(key, iota_hi, iota_lo)``; ``split`` stacks the
  two halves into the new keys, 32-bit bits are ``bits1 ^ bits2``;
- ``fold_in(key, d)`` is ``threefry2x32(key, 0, d)``;
- ``unit`` puts the top mantissa bits into a float in [1, 2) and
  subtracts 1 (float32 from 32-bit words; float16 from 16 bits and
  bfloat16 from 8, the low bits of the words); ``uniform`` is its float32
  draw;
- ``permutation(key, f)`` is ``_shuffle``: ``ceil(3 ln f / ln(2^32 - 1))``
  rounds (one for 1 < f < 1,625), each splitting the key and stably
  sorting by fresh 32-bit sort keys.

Keys are ``[2]`` int64 tensors holding uint32 words. All arithmetic is in
int64 masked to 32 bits (PyTorch's uint32 lacks operations on CUDA, and
int32 overflow is not relied on). Each function runs on the device of the
key it is given; :func:`prng_key` takes the device explicitly. There is no
kernel behind ``jax.random`` in the reference, so these are plain PyTorch
ops on any device.
"""
from __future__ import annotations

import math
from typing import Sequence, Tuple

import torch

_MASK = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
# the float formats: bits, mantissa bits, 1.0's bits and the signed
# integer view of the same width
_FORMATS = {torch.float32: (32, 23, 0x3F800000, torch.int32),
            torch.float16: (16, 10, 0x3C00, torch.int16),
            torch.bfloat16: (16, 7, 0x3F80, torch.int16)}


def _threefry2x32(key: torch.Tensor, x0: torch.Tensor, x1: torch.Tensor
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The Threefry-2x32 hash (20 rounds) of counter pairs (x0, x1)."""
    k0, k1 = key[0], key[1]
    ks = (k0, k1, k0 ^ k1 ^ 0x1BD11BDA)
    x0 = (x0 + ks[0]) & _MASK
    x1 = (x1 + ks[1]) & _MASK
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & _MASK
            x1 = (((x1 << r) | (x1 >> (32 - r))) & _MASK) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & _MASK
        x1 = (x1 + ks[(i + 2) % 3] + (i + 1)) & _MASK
    return x0, x1


def prng_key(seed: int, device) -> torch.Tensor:
    """``jax.random.PRNGKey(seed)``: the words (0, seed mod 2^32)."""
    return torch.tensor([0, int(seed) & _MASK], dtype=torch.int64,
                        device=device)


def split(key: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """``jax.random.split(key)``: two new keys."""
    counters = torch.arange(2, dtype=torch.int64, device=key.device)
    b0, b1 = _threefry2x32(key, torch.zeros_like(counters), counters)
    keys = torch.stack([b0, b1], dim=1)
    return keys[0], keys[1]


def fold_in(key: torch.Tensor, data: int) -> torch.Tensor:
    """``jax.random.fold_in(key, data)``."""
    zero = torch.zeros(1, dtype=torch.int64, device=key.device)
    y0, y1 = _threefry2x32(key, zero, zero + (int(data) & _MASK))
    return torch.cat([y0, y1])


def random_bits32(key: torch.Tensor, n: int) -> torch.Tensor:
    """``jax.random.bits(key, (n,))``: [n] uint32 words as int64."""
    counters = torch.arange(n, dtype=torch.int64, device=key.device)
    b0, b1 = _threefry2x32(key, counters >> 32, counters & _MASK)
    return b0 ^ b1


def unit(key: torch.Tensor, shape: Sequence[int],
         dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """``jax.random.uniform(key, shape, dtype)``: floats in [0, 1) of
    ``dtype`` (float32, float16 or bfloat16), random mantissa bits under
    1.0's exponent, minus 1."""
    nbits, nmant, one, view = _FORMATS[dtype]
    rng_bits = 8 if nmant < 8 else nbits
    bits = random_bits32(key, math.prod(shape))
    if rng_bits < 32:
        bits = bits & ((1 << rng_bits) - 1)
    word = (bits >> (rng_bits - nmant)) | one
    return word.to(view).view(dtype).reshape(tuple(shape)) - 1.0


def uniform(key: torch.Tensor, n: int) -> torch.Tensor:
    """``jax.random.uniform(key, (n,))``: [n] float32 in [0, 1)."""
    return unit(key, (n,))


def permutation(key: torch.Tensor, f: int) -> torch.Tensor:
    """``jax.random.permutation(key, f)``: [f] int64, a shuffle of
    ``arange(f)``."""
    rounds = math.ceil(3 * math.log(max(1, f)) / math.log(_MASK))
    x = torch.arange(f, dtype=torch.int64, device=key.device)
    for _ in range(rounds):
        key, sub = split(key)
        order = torch.sort(random_bits32(sub, f), stable=True).indices
        x = x[order]
    return x

"""Ring and Ulysses attention, on one rank.

Counterpart of ``synapseml_tpu/parallel/ring_attention.py``. The reference
shards the sequence over the ``sp`` mesh axis: ring attention rotates K/V
blocks between ranks (``lax.ppermute``) under an online softmax, Ulysses
trades sequence shards for head shards (``lax.all_to_all``). On a world of
one rank neither moves anything: the ring runs no rotation and makes one
online-softmax step over the whole sequence, and Ulysses' all-to-alls are
the identity, so it is :func:`dense_attention`. Those are what run here.
The rotation, the all-to-alls and the train step with sp > 1 are ROADMAP
item 4b; a mesh of more than one rank raises and names it.

The arithmetic follows the reference step for step rather than calling
``scaled_dot_product_attention``: ``q * scale`` in the input dtype (the
scale rounded to that dtype first, as JAX's weakly typed scalar is),
logits and softmax in float32, probabilities cast back to ``v``'s dtype
for the second product.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

from synapseml_tpu_torch.parallel.mesh import Mesh, require_one_rank

NEG_INF = -1e30


def _weak(x: float, dtype: torch.dtype) -> float:
    """``x`` rounded to ``dtype``: what a Python scalar becomes when JAX
    multiplies it into an array of that dtype."""
    return torch.tensor(x, dtype=dtype).item()


def dense_attention(q, k, v, *, causal: bool = False,
                    scale: Optional[float] = None):
    """Reference (single-device) attention. q,k,v: [B, S, H, D]."""
    s = scale if scale is not None else 1.0 / math.sqrt(q.shape[-1])
    logits = torch.einsum("bqhd,bkhd->bhqk", q * _weak(s, q.dtype), k)
    if causal:
        qi = torch.arange(q.shape[1], device=q.device)[:, None]
        ki = torch.arange(k.shape[1], device=q.device)[None, :]
        logits = logits.masked_fill((ki > qi)[None, None], NEG_INF)
    probs = torch.softmax(logits.float(), dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", probs.to(v.dtype), v)


def _block_step(q, k, v, m, l, o, mask):
    """One blockwise-attention accumulation step with online softmax.

    q: [B, Sq, H, D]; k,v: [B, Sk, H, D]; m,l: [B, H, Sq]; o: [B, Sq, H, D];
    mask: [Sq, Sk] boolean (True = attend) or None.
    """
    logits = torch.einsum("bqhd,bkhd->bhqk", q, k).float()
    if mask is not None:
        logits = torch.where(mask[None, None], logits, NEG_INF)
    m_new = torch.maximum(m, logits.amax(dim=-1))
    p = torch.exp(logits - m_new[..., None])
    correction = torch.exp(m - m_new)
    l_new = l * correction + p.sum(dim=-1)
    o_new = o * correction.transpose(1, 2)[..., None] + torch.einsum(
        "bhqk,bkhd->bqhd", p.to(v.dtype), v).float()
    return m_new, l_new, o_new


def _ring_attention_one_rank(q, k, v, *, causal: bool, scale: float):
    """The reference's per-rank ring body with one rank: no rotation, one
    step over the whole (local) sequence, then ``o / l``."""
    b, sq, h, d = q.shape
    sk = k.shape[1]
    q = (q * _weak(scale, q.dtype)).to(q.dtype)
    m = torch.full((b, h, sq), NEG_INF, dtype=torch.float32, device=q.device)
    l = torch.zeros((b, h, sq), dtype=torch.float32, device=q.device)
    o = torch.zeros((b, sq, h, d), dtype=torch.float32, device=q.device)
    mask = None
    if causal:
        q_pos = torch.arange(sq, device=q.device)[:, None]
        k_pos = torch.arange(sk, device=q.device)[None, :]
        mask = k_pos <= q_pos
    m, l, o = _block_step(q, k, v, m, l, o, mask)
    out = o / l.transpose(1, 2)[..., None]
    return out.to(q.dtype)


def make_ring_attention(
    mesh: Mesh,
    *,
    seq_axis: str = "sp",
    head_axis: Optional[str] = "tp",
    batch_axis: str = "dp",
    causal: bool = False,
):
    """Build a ring-attention callable over ``mesh`` (a world of one rank).

    q,k,v are [B, S, H, D] tensors. Differentiable through autograd, so it
    drops into training steps. The axis arguments name where the
    reference shards B, S and H; with one rank they shard nothing."""
    require_one_rank(mesh, "4b", "ring attention")

    def fn(q, k, v):
        scale = 1.0 / math.sqrt(q.shape[-1])
        return _ring_attention_one_rank(q, k, v, causal=causal, scale=scale)

    return fn


def make_serving_ring_attention(mesh: Mesh, *, causal: bool = False):
    """Ring attention over the serving ``dp×tp`` mesh: the sequence rides
    the ``tp`` ranks. A world of one rank only (item 4b)."""
    names = tuple(mesh.axis_names)
    if "dp" not in names or "tp" not in names:
        raise ValueError(
            f"serving ring attention needs a dp×tp mesh, got axes {names}")
    return make_ring_attention(mesh, seq_axis="tp", head_axis=None,
                               batch_axis="dp", causal=causal)


def make_ulysses_attention(
    mesh: Mesh,
    *,
    seq_axis: str = "sp",
    batch_axis: str = "dp",
    head_axis: Optional[str] = "tp",
    causal: bool = False,
):
    """All-to-all (DeepSpeed-Ulysses style) sequence parallelism on a world
    of one rank: the all-to-alls are the identity, so this is dense
    attention over the whole sequence (item 4b brings the exchanges)."""
    require_one_rank(mesh, "4b", "Ulysses attention")

    def fn(q, k, v):
        return dense_attention(q, k, v, causal=causal)

    return fn

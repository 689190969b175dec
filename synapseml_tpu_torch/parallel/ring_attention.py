"""Ring and Ulysses attention over the ranks of a mesh.

Counterpart of ``synapseml_tpu/parallel/ring_attention.py``. The reference
shards q, k and v over the mesh with ``shard_map`` (B over dp, S over the
sequence axis, H over tp) and runs a body on each device's block; here
each rank is handed its block, ``[B/dp, S/sp, H, D]``, and runs that body:

- the ring (:func:`make_ring_attention`) is ``_ring_attention_local`` as
  the reference has it: ``n - 1`` steps of (one online-softmax block
  step, one rotation of the K/V block to the next rank), then a last
  step with no rotation, the block held at step ``s`` having come from
  sequence rank ``(rank - s) % n``; causal masks from the blocks' global
  positions; ``o / l`` at the end in the input dtype. The rotation is
  :class:`_Rotate`, an autograd Function that carries K and V together in
  one transfer forward and sends their gradients the other way in one
  transfer backward (``ppermute``'s transpose), so every rank enters the
  same transfers in the same order in both passes;
- Ulysses (:func:`make_ulysses_attention`) trades the sequence shard of
  every head for the whole sequence of ``H / sp`` heads with one tiled
  all-to-all of q, k and v together (:class:`_AllToAll`, whose backward
  is the inverse exchange), runs dense attention there, and trades back;
- the serving ring (:func:`make_serving_ring_attention`) is the ring with
  the sequence over ``tp`` and the heads whole.

A mesh of one rank runs the same bodies with no exchange. A mesh that
shards heads over tp is ROADMAP item 4c and raises naming it; a mesh
wider than the process's world raises ``RuntimeError``
(``Mesh.require_world``). The transfers are ``collectives.rotate`` and
``collectives.all_to_all``: the group's backend decides how bytes move.

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

from synapseml_tpu_torch.parallel import collectives
from synapseml_tpu_torch.parallel.mesh import Mesh

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


class _Rotate(torch.autograd.Function):
    """One ring step's transfer: ``x`` to ``send_to``, the block from
    ``recv_from`` returned; the gradient goes from ``recv_from``'s side
    back to ``send_to``'s."""

    @staticmethod
    def forward(ctx, x, group, send_to: int, recv_from: int):
        ctx.group, ctx.peers = group, (send_to, recv_from)
        return collectives.rotate(x, group, send_to, recv_from)

    @staticmethod
    def backward(ctx, grad):
        send_to, recv_from = ctx.peers
        return (collectives.rotate(grad.contiguous(), ctx.group, recv_from,
                                   send_to), None, None, None)


class _AllToAll(torch.autograd.Function):
    """The tiled all-to-all, split along ``split_dim`` and concatenated
    along ``concat_dim``; its backward is the inverse exchange."""

    @staticmethod
    def forward(ctx, x, group, split_dim: int, concat_dim: int):
        ctx.group, ctx.dims = group, (split_dim, concat_dim)
        return collectives.all_to_all(x, group, split_dim, concat_dim)

    @staticmethod
    def backward(ctx, grad):
        split_dim, concat_dim = ctx.dims
        return (collectives.all_to_all(grad.contiguous(), ctx.group,
                                       concat_dim, split_dim),
                None, None, None)


def _ring_attention_local(q, k, v, *, mesh: Mesh, axis: str, causal: bool,
                          scale: float):
    """The reference's per-device ring body on this rank's blocks."""
    b, sq, h, d = q.shape
    sk = k.shape[1]
    n = mesh.shape[axis]
    rank = mesh.index(axis)
    group = mesh.group(axis)
    prev, nxt = mesh.neighbours(axis)

    q = (q * _weak(scale, q.dtype)).to(q.dtype)
    m = torch.full((b, h, sq), NEG_INF, dtype=torch.float32, device=q.device)
    l = torch.zeros((b, h, sq), dtype=torch.float32, device=q.device)
    o = torch.zeros((b, sq, h, d), dtype=torch.float32, device=q.device)

    def compute(step, kv, m, l, o):
        # the K/V block held now arrived from rank (rank - step) % n
        src = (rank - step) % n
        mask = None
        if causal:
            q_pos = rank * sq + torch.arange(sq, device=q.device)[:, None]
            k_pos = src * sk + torch.arange(sk, device=q.device)[None, :]
            mask = k_pos <= q_pos
        return _block_step(q, kv[0], kv[1], m, l, o, mask)

    # n-1 (compute, rotate) steps, then a final compute with no rotation
    kv = torch.stack([k, v])
    for step in range(n - 1):
        m, l, o = compute(step, kv, m, l, o)
        kv = _Rotate.apply(kv, group, nxt, prev)
    m, l, o = compute(n - 1, kv, m, l, o)
    out = o / l.transpose(1, 2)[..., None]
    return out.to(q.dtype)


def _require_blocks(mesh: Mesh, head_axis: Optional[str], what: str) -> None:
    """Refuse heads sharded over ranks (item 4c) and a mesh wider than
    the process's world."""
    if head_axis is not None and mesh.shape[head_axis] > 1:
        raise NotImplementedError(
            f"{what} with the heads sharded over {head_axis}="
            f"{mesh.shape[head_axis]} ({mesh.shape}): tensor parallelism "
            f"over ranks is ROADMAP item 4c")
    mesh.require_world(what)


def make_ring_attention(
    mesh: Mesh,
    *,
    seq_axis: str = "sp",
    head_axis: Optional[str] = "tp",
    batch_axis: str = "dp",
    causal: bool = False,
):
    """Build a ring-attention callable over ``mesh``.

    q,k,v are this rank's blocks of the global [B, S, H, D] arrays: B
    split over ``batch_axis``, S over ``seq_axis``, H over ``head_axis``
    (which must be 1 here), as the reference's ``shard_map`` hands them
    out. The result is this rank's block of the output. Differentiable:
    the rotation's backward sends the K/V gradients back around the ring,
    so it drops into training steps."""
    del batch_axis  # the batch blocks never meet
    _require_blocks(mesh, head_axis, "ring attention")

    def fn(q, k, v):
        scale = 1.0 / math.sqrt(q.shape[-1])
        return _ring_attention_local(q, k, v, mesh=mesh, axis=seq_axis,
                                     causal=causal, scale=scale)

    return fn


def make_serving_ring_attention(mesh: Mesh, *, causal: bool = False):
    """Ring attention over the SERVING ``dp×tp`` mesh: the sequence shards
    over ``tp`` (heads stay local), the batch stays on ``dp``, and each
    rank holds O(S/tp) of K/V while blocks rotate over the tp ranks.
    ``mesh`` must carry ``dp`` and ``tp`` axes; q,k,v are this rank's
    blocks of global [B, S, H, D] arrays with B divisible by dp and S by
    tp."""
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
    """All-to-all (DeepSpeed-Ulysses style) sequence parallelism.

    Each rank trades its sequence shard of all heads for all sequence of
    a head shard (one all-to-all over ``seq_axis`` carrying q, k and v),
    runs dense attention on whole sequences of its local heads, then
    trades back. Requires H % (sp*tp) == 0; q,k,v are this rank's blocks
    as in :func:`make_ring_attention`."""
    del batch_axis
    _require_blocks(mesh, head_axis, "Ulysses attention")
    n = mesh.shape[seq_axis]
    group = mesh.group(seq_axis)

    def fn(q, k, v):
        h = q.shape[2]
        if h % n:
            raise ValueError(
                f"Ulysses attention requires H % (sp*tp) == 0: {h} heads "
                f"over {seq_axis}={n}")
        # [3, B, S_loc, H, D] -> [3, B, S, H/n, D]
        qkv = _AllToAll.apply(torch.stack([q, k, v]), group, 3, 2)
        out = dense_attention(qkv[0], qkv[1], qkv[2], causal=causal)
        return _AllToAll.apply(out, group, 1, 2)

    return fn

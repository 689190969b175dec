"""Mixture-of-Experts feed-forward with dense dispatch.

Counterpart of ``synapseml_tpu/parallel/moe.py``. Every expert's FFN is
evaluated for every token as one einsum, and the top-k gates weight the
experts' outputs, so shapes stay static. The reference shards the expert
dimension over the ``ep`` mesh axis through ``expert_spec``; the port
keeps every expert on every rank, and the argument is taken and not read
(expert parallelism over ranks is ROADMAP item 4c).

Where a batch's tokens are split over ranks (the tagger's dp and sp),
``token_group`` names the group that holds them all. The auxiliary loss
is a product of two means over the whole batch, ``E · Σ_e frac_e ·
prob_e``, so a sum of per-rank products would be another number. Each
rank returns its share instead: ``E · Σ_e frac_e · (Σ_local gates_e) /
N``, with ``frac_e`` the whole batch's share of tokens routed to expert
``e`` (exact counts summed over the group; no gradient, as in the
reference) and ``N`` the batch's token count. The shares sum over the
group to the reference's aux, and their gradients to its gradient.
"""
from __future__ import annotations

from functools import partial

import torch
import torch.nn.functional as F

from synapseml_tpu_torch.parallel import collectives


def topk_gating(gate_logits: torch.Tensor, top_k: int) -> torch.Tensor:
    """Top-k softmax gating with renormalization. gate_logits: [..., E].

    Every expert whose probability is at least the k-th largest is kept,
    so a tie at the k-th value keeps more than k, as the reference's
    threshold does."""
    probs = torch.softmax(gate_logits.float(), dim=-1)
    threshold = torch.topk(probs, top_k, dim=-1).values[..., -1:]
    masked = torch.where(probs >= threshold, probs, 0.0)
    return masked / (masked.sum(dim=-1, keepdim=True) + 1e-9)


# jax.nn.gelu's default is the tanh approximation
gelu_tanh = partial(F.gelu, approximate="tanh")


def moe_ffn(
    x: torch.Tensor,          # [B, S, D]
    gate_w: torch.Tensor,     # [D, E]
    w1: torch.Tensor,         # [E, D, F]
    w2: torch.Tensor,         # [E, F, D]
    *,
    top_k: int = 2,
    activation=gelu_tanh,
    expert_spec=None,
    token_group=None,
):
    """Dense-dispatch MoE feed-forward. Returns ([B,S,D], aux_loss), the
    aux loss this rank's share of it where ``token_group`` is given."""
    del expert_spec  # the reference's ep sharding; experts stay whole
    gates = topk_gating(torch.einsum("bsd,de->bse", x, gate_w), top_k)
    h = activation(torch.einsum("bsd,edf->bsef", x, w1))
    y = torch.einsum("bsef,efd->bsed", h, w2)
    out = torch.einsum("bse,bsed->bsd", gates.to(y.dtype), y)
    # load-balancing auxiliary loss (Switch-style): E * sum_e f_e * p_e
    e = gate_w.shape[-1]
    if token_group is None:
        frac = (gates > 0).float().mean(dim=(0, 1))
        prob = gates.mean(dim=(0, 1))
        return out, e * torch.sum(frac * prob)
    # counts of the whole batch: each expert's routed tokens, then N
    counts = torch.cat([(gates > 0).sum(dim=(0, 1)), torch.tensor(
        [gates.shape[0] * gates.shape[1]], device=gates.device)])
    counts = collectives.all_reduce_sum(counts, token_group)
    n = counts[-1].float()
    frac = counts[:-1].float() / n
    return out, e * torch.sum(frac * (gates.sum(dim=(0, 1)) / n))

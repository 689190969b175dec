"""Sequence tagger: the port of the pod-scale sequence model.

Counterpart of ``synapseml_tpu/dl/tagger.py`` (BASELINE.json config #5,
"BiLSTM Medical Entity Extraction"). The reference replaces CNTK's BiLSTM
with a transformer encoder tagger built to shard over a five-axis mesh:
dp (batch), sp (sequence, ring attention), tp (heads, ffn), ep (MoE
experts), pp (stacked pipeline stages). This module runs it on one rank
or over a mesh of dp × sp ranks:

- :class:`TaggerConfig` and ``for_mesh`` as in the reference, with a
  ``torch.dtype`` for the activations (bf16 by default);
- :func:`init_params` draws the same numpy arrays from the same seed;
  :func:`params_from_numpy` puts them in a :class:`Tagger` module whose
  parameters keep the reference's stacked shapes (``[s, l, d, h, dh]``
  and so on), and :func:`params_to_numpy` takes them back out;
- :func:`make_apply` is the forward: embedding gather, then for each
  stage and layer (a Python loop where the reference runs ``lax.scan``)
  layer norm, rope, attention (dense without a mesh, the mesh's ring or
  Ulysses path with one), the MoE feed-forward; then the float32 head.
  Parameters stay float32 and are cast at each use;
- :func:`make_train_step` is autograd and ``torch.optim.AdamW`` with
  optax's defaults, updating the parameters and the optimizer state in
  place (the reference donates them).

Over a mesh with dp or sp above 1 every rank holds the whole model and
its ``(dp, sp)`` block of the batch, as the reference's ``P("dp", "sp")``
places it: ``batch_placement`` cuts the block, ``apply`` and ``step``
take and return blocks, rope reads the block's global positions, and
attention is the mesh's ring or Ulysses path. Each rank's loss is its
share of the reference's: ``Σ_local nll·mask / Σ_global mask`` plus the
aux weight times its MoE shares (``moe_ffn(token_group=)``), so the
shares sum to the reference's loss. The gradients of the shares are
flattened into one buffer, exchanged once a step and summed in rank
order (``collectives.all_reduce_sum``), so every rank applies the same
AdamW update to the same bits: the parameters stay bitwise equal on
every rank. The reported loss is the shares' rank-ordered sum.

Token ids outside ``[0, vocab)`` raise ``ValueError`` before the gather:
JAX clamps such an index, and on the card it would be a device-side
assert that ends the process. tp, pp or ep above 1 raises naming ROADMAP
item 4c; a mesh wider than the process's world raises ``RuntimeError``.
"""
from __future__ import annotations

import dataclasses
from functools import partial
from typing import Any, Callable, Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from synapseml_tpu_torch import device as device_policy
from synapseml_tpu_torch.parallel import collectives
from synapseml_tpu_torch.parallel.mesh import (
    Mesh, require_axes, single_device_mesh)
from synapseml_tpu_torch.parallel.moe import moe_ffn
from synapseml_tpu_torch.parallel.ring_attention import (
    dense_attention, make_ring_attention, make_ulysses_attention)

STAGE_LEAVES = ("ln1", "ln2", "wq", "wk", "wv", "wo", "gate", "w1", "w2")


@dataclasses.dataclass(frozen=True)
class TaggerConfig:
    vocab_size: int = 4096
    num_tags: int = 16
    d_model: int = 64
    num_heads: int = 4
    head_dim: int = 16
    ffn_dim: int = 128
    num_stages: int = 2          # pipeline stages (stacked, sharded over pp)
    layers_per_stage: int = 1
    num_experts: int = 4
    top_k: int = 2
    max_seq_len: int = 512
    attention: str = "ring"      # ring | ulysses | dense
    dtype: Any = torch.bfloat16

    @staticmethod
    def for_mesh(mesh: Mesh, **overrides) -> "TaggerConfig":
        """Smallest config whose dims are divisible by the mesh axes."""
        def up(n, m):
            return ((n + m - 1) // m) * m

        ax = dict(mesh.shape)
        pp, tp, ep = ax.get("pp", 1), ax.get("tp", 1), ax.get("ep", 1)
        base = dict(
            num_stages=up(max(2, pp), pp),
            num_heads=up(max(4, tp), tp),
            num_experts=up(max(2, ep), ep),
        )
        base.update(overrides)
        cfg = TaggerConfig(**base)
        # round sharded dims up to mesh divisibility (tp shards d_model/ffn,
        # ep shards experts, pp shards the stage stack)
        fixed = dataclasses.replace(
            cfg,
            num_stages=up(cfg.num_stages, pp),
            num_heads=up(cfg.num_heads, tp),
            num_experts=up(cfg.num_experts, ep),
            d_model=up(cfg.d_model, tp),
            ffn_dim=up(cfg.ffn_dim, tp),
        )
        return fixed


def _init(rng: np.random.Generator, shape, scale=None):
    scale = scale if scale is not None else 1.0 / np.sqrt(shape[-2] if len(shape) > 1 else shape[-1])
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def init_params(cfg: TaggerConfig, seed: int = 0) -> Dict[str, Any]:
    r = np.random.default_rng(seed)
    s, l = cfg.num_stages, cfg.layers_per_stage
    d, h, dh, f, e = (cfg.d_model, cfg.num_heads, cfg.head_dim,
                      cfg.ffn_dim, cfg.num_experts)
    return {
        "embed": _init(r, (cfg.vocab_size, d), scale=0.02),
        "stages": {
            "ln1": np.ones((s, l, d), np.float32),
            "ln2": np.ones((s, l, d), np.float32),
            "wq": _init(r, (s, l, d, h, dh)),
            "wk": _init(r, (s, l, d, h, dh)),
            "wv": _init(r, (s, l, d, h, dh)),
            "wo": _init(r, (s, l, h, dh, d), scale=1.0 / np.sqrt(h * dh)),
            "gate": _init(r, (s, l, d, e)),
            "w1": _init(r, (s, l, e, d, f)),
            "w2": _init(r, (s, l, e, f, d), scale=1.0 / np.sqrt(f)),
        },
        "ln_f": np.ones((d,), np.float32),
        "head": _init(r, (d, cfg.num_tags)),
    }


def param_specs(cfg: TaggerConfig) -> Dict[str, Any]:
    """How the reference shards each leaf of :func:`init_params`: one mesh
    axis name (or None) a dimension. Not applied on one rank; item 4c
    places the leaves by it."""
    del cfg  # structure only
    return {
        "embed": (None, "tp"),
        "stages": {
            "ln1": ("pp",),
            "ln2": ("pp",),
            "wq": ("pp", None, None, "tp", None),
            "wk": ("pp", None, None, "tp", None),
            "wv": ("pp", None, None, "tp", None),
            "wo": ("pp", None, "tp", None, None),
            "gate": ("pp", None, None, "ep"),
            "w1": ("pp", None, "ep", None, "tp"),
            "w2": ("pp", None, "ep", "tp", None),
        },
        "ln_f": (),
        "head": (),
    }


class Tagger(nn.Module):
    """The tagger's parameters, float32, in the shapes :func:`init_params`
    gives them: ``embed``, ``stages`` (the nine stacked leaves), ``ln_f``
    and ``head``. :func:`make_apply` runs the forward over them."""

    def __init__(self, params: Dict[str, Any], device: torch.device):
        super().__init__()

        def leaf(a):
            return nn.Parameter(torch.tensor(np.asarray(a, np.float32),
                                             device=device))

        stages = params["stages"]
        if sorted(stages) != sorted(STAGE_LEAVES):
            raise KeyError(f"stage leaves {sorted(stages)}; the tagger has "
                           f"{sorted(STAGE_LEAVES)}")
        self.embed = leaf(params["embed"])
        self.stages = nn.ParameterDict(
            {k: leaf(stages[k]) for k in STAGE_LEAVES})
        self.ln_f = leaf(params["ln_f"])
        self.head = leaf(params["head"])


def params_from_numpy(params: Dict[str, Any],
                      device: str | torch.device = "cuda") -> Tagger:
    """A :class:`Tagger` on ``device`` holding ``params`` (the nested dict
    of :func:`init_params`), name for name and shape for shape."""
    return Tagger(params, _resolve(device))


def params_to_numpy(module: Tagger) -> Dict[str, Any]:
    """The nested dict of float32 numpy arrays that
    :func:`params_from_numpy` took, read back from ``module``."""
    def host(p):
        return p.detach().cpu().numpy()

    return {"embed": host(module.embed),
            "stages": {k: host(module.stages[k]) for k in STAGE_LEAVES},
            "ln_f": host(module.ln_f), "head": host(module.head)}


def _layer_norm(x, scale):
    x32 = x.float()
    mu = x32.mean(-1, keepdim=True)
    var = ((x32 - mu) ** 2).mean(-1, keepdim=True)
    return ((x32 - mu) * torch.rsqrt(var + 1e-6) * scale).to(x.dtype)


def _rope(x, positions):
    """Rotary embedding, interleaved pairs. x: [B, S, H, D], positions: [S]."""
    d = x.shape[-1]
    freqs = 1.0 / (10000.0 ** (torch.arange(
        0, d, 2, dtype=torch.float32, device=x.device) / d))
    angles = positions[:, None].float() * freqs[None, :]  # [S, D/2]
    cos = torch.cos(angles)[None, :, None, :]
    sin = torch.sin(angles)[None, :, None, :]
    x1, x2 = x[..., 0::2], x[..., 1::2]
    out = torch.stack([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.reshape(x.shape).to(x.dtype)


def _require_dp_sp(mesh: Mesh) -> None:
    """The tagger runs dp and sp over ranks; tp, pp and ep are item 4c."""
    require_axes(mesh, ("dp", "sp"), "4c", "the tagger")
    mesh.require_world("the tagger")


def _sharded(mesh: Optional[Mesh]) -> bool:
    return mesh is not None and mesh.size > 1


def _resolve(device) -> torch.device:
    """``device`` through the port's policy, with a CUDA device's index
    made explicit (tensors report ``cuda:0``, not ``cuda``)."""
    dev = device_policy.resolve(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def _ids_on(ids, limit: int, what: str, device: torch.device) -> torch.Tensor:
    """``ids`` (numpy or a tensor) on ``device``, refused with
    ``ValueError`` if any lies outside ``[0, limit)``: a host check for
    numpy, one read back for a tensor."""
    if isinstance(ids, torch.Tensor):
        if ids.device != device:
            raise ValueError(f"{what} lie on {ids.device}; the tagger runs "
                             f"on {device}")
        bad = ids.numel() and bool(((ids < 0) | (ids >= limit)).any())
        t = ids
    else:
        a = np.asarray(ids)
        bad = a.size and bool(((a < 0) | (a >= limit)).any())
        t = torch.as_tensor(a, device=device)
    if bad:
        raise ValueError(
            f"{what} outside [0, {limit}): the reference clamps such an "
            f"index; the port refuses it")
    return t


def _place(a, device: torch.device) -> torch.Tensor:
    """A batch array on ``device`` (a tensor there already passes)."""
    if isinstance(a, torch.Tensor):
        return a.to(device)
    return torch.as_tensor(np.asarray(a), device=device)


def make_apply(cfg: TaggerConfig, mesh: Optional[Mesh] = None,
               device: str | torch.device = "cuda") -> Callable:
    """Build the forward ``apply(params, tokens) -> (logits, aux)``:
    ``params`` a :class:`Tagger` on ``device``, ``tokens`` ``[B, S]``
    integers (numpy or a tensor), logits ``[B, S, num_tags]`` float32 and
    the MoE auxiliary loss summed over layers. With a mesh, attention is
    the path ``cfg.attention`` names (ring by default), as in the
    reference; without one, dense. Over dp × sp ranks ``tokens`` is this
    rank's block, the logits are its block and aux is its share of the
    batch's (the shares sum over the ranks to the reference's aux).
    Raises without CUDA unless ``device="cpu"`` is asked for."""
    dev = _resolve(device)
    if mesh is not None:
        _require_dp_sp(mesh)
    token_group = mesh.group("dp", "sp") if _sharded(mesh) else None
    sp_index = mesh.index("sp") if mesh is not None else 0
    if mesh is not None and cfg.attention == "ring":
        attn_fn = make_ring_attention(mesh)
    elif mesh is not None and cfg.attention == "ulysses":
        attn_fn = make_ulysses_attention(mesh)
    else:
        attn_fn = partial(dense_attention, causal=False)

    # The reference constrains q, k, v and each residual to (dp, sp, tp)
    # shardings here; each rank's tensors are its (dp, sp) block already.
    def block(x, w, positions):
        # attention
        y = _layer_norm(x, w["ln1"])
        q = torch.einsum("bsd,dhe->bshe", y, w["wq"].to(y.dtype))
        k = torch.einsum("bsd,dhe->bshe", y, w["wk"].to(y.dtype))
        v = torch.einsum("bsd,dhe->bshe", y, w["wv"].to(y.dtype))
        q, k = _rope(q, positions), _rope(k, positions)
        a = attn_fn(q, k, v)
        a = torch.einsum("bshe,hed->bsd", a, w["wo"].to(a.dtype))
        x = x + a
        # MoE FFN
        y = _layer_norm(x, w["ln2"])
        m, aux = moe_ffn(y, w["gate"].to(y.dtype), w["w1"].to(y.dtype),
                         w["w2"].to(y.dtype), top_k=cfg.top_k,
                         expert_spec=None, token_group=token_group)
        return x + m, aux

    def apply(params: Tagger, tokens):
        if params.embed.device != dev:
            raise ValueError(f"the parameters lie on {params.embed.device}; "
                             f"this forward runs on {dev}")
        tokens = _ids_on(tokens, cfg.vocab_size, "token ids", dev)
        s_loc = tokens.shape[1]
        positions = sp_index * s_loc + torch.arange(s_loc, device=dev)
        x = F.embedding(tokens, params.embed.to(cfg.dtype))
        aux_total = torch.zeros((), dtype=torch.float32, device=dev)
        stages = params.stages
        n_stages, n_layers = stages["ln1"].shape[:2]
        for s in range(n_stages):
            for l in range(n_layers):
                w = {name: stages[name][s, l] for name in STAGE_LEAVES}
                x, a = block(x, w, positions)
                aux_total = aux_total + a
        x = _layer_norm(x, params.ln_f)
        logits = torch.einsum("bsd,dt->bst", x.float(), params.head)
        return logits, aux_total

    return apply


def tagging_loss(logits, labels, mask, aux, aux_weight=0.01):
    """Token-level cross entropy. labels: [B,S] int, mask: [B,S] bool."""
    return _masked_loss(logits, labels, mask, mask.sum(), aux, aux_weight)


def _masked_loss(logits, labels, mask, count, aux, aux_weight=0.01):
    """``Σ nll·mask / max(count, 1) + aux_weight·aux``: the batch's loss
    where ``count`` is ``mask``'s own, a rank's share of it where
    ``count`` is the whole batch's and ``aux`` the rank's aux share."""
    logp = torch.log_softmax(logits, dim=-1)
    nll = -torch.gather(logp, -1, labels[..., None].long())[..., 0]
    denom = torch.clamp(count, min=1)
    return (nll * mask).sum() / denom + aux_weight * aux


def make_train_step(cfg: TaggerConfig, mesh: Optional[Mesh] = None,
                    learning_rate: float = 1e-3,
                    device: str | torch.device = "cuda"
                    ) -> Tuple[Callable, Callable, Callable]:
    """``(step, init_state, batch_placement)``, as the reference returns
    its jitted step, ``init_state`` and the batch sharding.

    ``step(params, opt_state, tokens, labels, mask) -> (params, opt_state,
    loss)`` runs the forward through ``mesh``'s attention path (a world of
    one rank when ``mesh`` is None: the ring, as the reference trains),
    the loss, its gradients and one AdamW update. The parameters and the
    optimizer state are updated in place and returned; the loss is a
    0-dim tensor on the device, and each parameter's ``.grad`` holds the
    step's gradient until the next step. ``init_state(seed=0)`` gives the
    :class:`Tagger` and its ``torch.optim.AdamW`` with optax's defaults
    (betas 0.9 and 0.999, eps 1e-8, weight decay 1e-4 on every parameter,
    in one group). ``batch_placement(array)`` puts this rank's ``(dp,
    sp)`` block of a global ``[B, S]`` array on the device (the whole
    array on one rank), raising ``ValueError`` where B does not divide by
    dp or S by sp.

    Over dp × sp ranks the batch arrays are blocks, every rank calls
    ``step`` together, and the step makes three kinds of exchange over the
    mesh: the mask's count, each MoE layer's routing counts, and one
    buffer of every gradient and the loss share (``.grad`` then holds the
    whole batch's gradient, the same bits on every rank)."""
    dev = _resolve(device)
    mesh = single_device_mesh() if mesh is None else mesh
    apply = make_apply(cfg, mesh, dev)
    sharded = _sharded(mesh)
    group = mesh.group("dp", "sp") if sharded else None

    def step(params: Tagger, opt_state: torch.optim.Optimizer, tokens,
             labels, mask):
        opt_state.zero_grad(set_to_none=True)
        logits, aux = apply(params, tokens)
        labels = _ids_on(labels, cfg.num_tags, "labels", dev)
        mask = _place(mask, dev)
        if not sharded:
            loss = tagging_loss(logits, labels, mask, aux)
            loss.backward()
            opt_state.step()
            return params, opt_state, loss.detach()
        # this rank's share of the loss: the mask counted over the batch
        count = collectives.all_reduce_sum(mask.sum()[None], group)[0]
        share = _masked_loss(logits, labels, mask, count, aux)
        share.backward()
        loss = _sum_gradients(params, share.detach(), group)
        opt_state.step()
        return params, opt_state, loss

    def init_state(seed: int = 0):
        params = params_from_numpy(init_params(cfg, seed), dev)
        opt_state = torch.optim.AdamW(
            params.parameters(), lr=learning_rate, betas=(0.9, 0.999),
            eps=1e-8, weight_decay=1e-4)
        return params, opt_state

    def batch_placement(arr):
        if sharded:
            arr = mesh.block(arr, ("dp", "sp"))
        return _place(arr, dev)

    return step, init_state, batch_placement


def _sum_gradients(params: Tagger, share: torch.Tensor, group
                   ) -> torch.Tensor:
    """Replace every ``.grad`` by its sum over ``group`` in rank order,
    with one exchange of a flat float32 buffer that also carries the loss
    share; returns the shares' rank-ordered sum (the batch's loss)."""
    leaves = list(params.parameters())
    flat = torch.cat([p.grad.reshape(-1) for p in leaves]
                     + [share.reshape(1)])
    total = collectives.all_reduce_sum(flat, group)
    at = 0
    for p in leaves:
        n = p.numel()
        p.grad.copy_(total[at:at + n].view_as(p.grad))
        at += n
    return total[at]

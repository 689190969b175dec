"""Rank bodies of the port's sequence-parallel runs, launched as ``call`` cases.

``tests/torch_dp_worker.py``'s ``run_ranks`` starts W processes that join a
gloo group; a ``call`` case runs ``fn(*args[rank], group=world)`` on each.
The functions here build a :class:`Mesh` over that world (every rank the
same meshes in the same order), cut this rank's block out of global numpy
arrays that every rank is handed (``Mesh.block``, the reference's
``NamedSharding``), run the port on it and return what the caller holds to
a reference: this rank's coordinates, its output blocks, and for the
tagger its losses, gradients and parameters (or their sums and a digest).

- :func:`attention` runs ``make_ring_attention``,
  ``make_ulysses_attention`` or ``make_serving_ring_attention`` forward
  and backward (the gradients of ``(out.float() ** 2).sum()`` of this
  rank's block: their sum over the ranks is the global loss);
- :func:`tagger` runs ``make_train_step``'s steps over the mesh from
  ``init_params(cfg, seed)``, and ``make_apply``'s forward of a batch;
- :func:`placement` records ``batch_placement``'s blocks and refusals;
- :func:`gather` puts the ranks' blocks back into the global array.

With ``timed=True`` a body also reports wall ms (the ranks synchronised
by a barrier around each call), its peak device allocation and the
collectives' calls, bytes and seconds by kind. Every body records K1's
and K2's launches in its process (0: no GBDT kernel lies on this path).
Imports neither JAX nor the JAX package: ``chip_smoke.py`` phase 42
launches these on the card.
"""
from __future__ import annotations

import hashlib
import statistics
import time

import numpy as np
import torch
import torch.distributed as dist

from synapseml_tpu_torch.dl import tagger as ttag
from synapseml_tpu_torch.gbdt import kernels
from synapseml_tpu_torch.parallel import collectives
from synapseml_tpu_torch.parallel import ring_attention as tra
from synapseml_tpu_torch.parallel.mesh import Mesh

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
MAKERS = {"ring": tra.make_ring_attention,
          "ulysses": tra.make_ulysses_attention,
          "serving_ring": tra.make_serving_ring_attention}


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def _wall_ms(fn, device, calls: int = 3) -> float:
    """Median wall ms of ``fn()`` over ``calls`` calls, each between two
    barriers with the device synchronised (the slowest rank's time)."""
    ms = []
    for _ in range(calls):
        _sync(device)
        dist.barrier()
        start = time.perf_counter()
        fn()
        _sync(device)
        dist.barrier()
        ms.append((time.perf_counter() - start) * 1e3)
    return statistics.median(ms)


def _launches() -> dict:
    """K1's and K2's launches in this rank's process so far."""
    return {"histogram": kernels.histogram.launches,
            "forest_traverse": kernels.forest_traverse.launches}


def _kinds() -> dict:
    return {k: dict(v) for k, v in collectives.stats.kinds.items()}


def _reset_peak(device) -> int:
    """Reset the device's peak and return what is allocated now."""
    if torch.device(device).type != "cuda":
        return 0
    torch.cuda.reset_peak_memory_stats()
    return torch.cuda.memory_allocated()


def _peak(device) -> int:
    if torch.device(device).type != "cuda":
        return 0
    return torch.cuda.max_memory_allocated()


def _host(t: torch.Tensor) -> np.ndarray:
    return t.detach().float().cpu().numpy()


def attention(kind, shape, causal, q, k, v, dtype="float32", device="cpu",
              timed=False, group=None):
    """``kind`` attention over ``Mesh(shape)`` on this rank's blocks of the
    global ``q, k, v`` (numpy ``[B, S, H, D]``): its output block and the
    gradients of ``(out.float() ** 2).sum()`` for q, k and v."""
    del group
    mesh = Mesh(shape)
    seq = "tp" if kind == "serving_ring" else "sp"
    spec = ("dp", seq, None, None)
    fn = MAKERS[kind](mesh, causal=causal)
    dt = DTYPES[dtype]

    def leaf(a):
        return torch.as_tensor(mesh.block(a, spec)).to(device, dt)

    blocks = [leaf(a).requires_grad_() for a in (q, k, v)]
    collectives.stats.reset()
    base = _reset_peak(device)
    out = fn(*blocks)
    (out.float() ** 2).sum().backward()
    _sync(device)
    res = {"coords": mesh.coords, "out": _host(out),
           "grads": [_host(b.grad) for b in blocks],
           "peak_bytes": _peak(device), "resident_bytes": base,
           "collectives": _kinds(), "launches": _launches()}
    if not timed:
        return res

    def fwd():
        with torch.no_grad():
            fn(*blocks)

    def fwd_bwd():
        for b in blocks:
            b.grad = None
        (fn(*blocks).float() ** 2).sum().backward()

    res["forward_ms"] = _wall_ms(fwd, device)
    res["forward_backward_ms"] = _wall_ms(fwd_bwd, device)
    res["backward_ms"] = res["forward_backward_ms"] - res["forward_ms"]
    collectives.stats.reset()
    collectives.stats.timed = True
    try:
        fwd_bwd()
        _sync(device)
    finally:
        collectives.stats.timed = False
    res["collectives_timed"] = _kinds()
    res["staged_bytes"] = collectives.stats.staged_bytes
    return res


def _digest(params) -> str:
    h = hashlib.sha256()
    for name, p in params.named_parameters():
        h.update(name.encode())
        h.update(p.detach().cpu().numpy().tobytes())
    return h.hexdigest()


def tagger(cfg_kw, shape, attention, dtype, tokens, labels, mask, steps=3,
           lr=1e-3, seed=0, device="cpu", forward_tokens=None, full=True,
           timed_steps=0, group=None):
    """``steps`` AdamW steps of the tagger over ``Mesh(shape)`` on this
    rank's blocks of the global batch, from ``init_params(cfg, seed)``:
    the reported losses, the first step's gradients (each rank's after
    the exchange: the whole batch's), and the parameters after (whole
    where ``full``, else each leaf's sum and |sum|), with their sha256.
    ``forward_tokens``: ``make_apply``'s logits block and aux share of
    that global batch first, from the same initial weights."""
    del group
    mesh = Mesh(shape)
    cfg = ttag.TaggerConfig(**cfg_kw, attention=attention,
                            dtype=DTYPES[dtype])
    step, init_state, place = ttag.make_train_step(cfg, mesh, lr, device)
    params, opt = init_state(seed)
    res = {"coords": mesh.coords}
    if forward_tokens is not None:
        with torch.no_grad():
            logits, aux = ttag.make_apply(cfg, mesh, device)(
                params, place(forward_tokens))
        res["logits"], res["aux"] = _host(logits), float(aux)
    batch = [place(a) for a in (tokens, labels, mask)]
    collectives.stats.reset()
    base = _reset_peak(device)
    losses, grads = [], None
    for _ in range(steps):
        params, opt, loss = step(params, opt, *batch)
        losses.append(float(loss))
        if grads is None and full:
            grads = {n: _host(p.grad) for n, p in params.named_parameters()}
    res.update(losses=losses, grads=grads, digest=_digest(params),
               step_peak_bytes=_peak(device) - base,
               collectives=_kinds(), launches=_launches())
    if full:
        res["params"] = {n: _host(p) for n, p in params.named_parameters()}
    else:
        res["leaf_sum"] = {n: float(p.detach().double().sum())
                           for n, p in params.named_parameters()}
        res["leaf_abs_sum"] = {n: float(p.detach().double().abs().sum())
                               for n, p in params.named_parameters()}
    if timed_steps:
        def one_step():
            step(params, opt, *batch)

        res["step_ms"] = _wall_ms(one_step, device, timed_steps)
        collectives.stats.reset()
        collectives.stats.timed = True
        try:
            one_step()
            _sync(device)
        finally:
            collectives.stats.timed = False
        res["collectives_timed"] = _kinds()
        res["staged_bytes"] = collectives.stats.staged_bytes
    return res


def gather(per_rank, key, axes, shape, index=None) -> np.ndarray:
    """The global array from each rank's block ``key`` (``key[index]``
    where ``index`` is given), each placed by the rank's coordinates on
    ``axes``, one a leading dimension of the block."""
    out = np.zeros(shape, np.float32)
    for res in per_rank:
        block = res[key] if index is None else res[key][index]
        at = tuple(slice(res["coords"][a] * n, (res["coords"][a] + 1) * n)
                   for a, n in zip(axes, block.shape))
        out[at] = block
    return out


def placement(shape, arrays, group=None):
    """``batch_placement``'s block of each global array over
    ``Mesh(shape)``, and the message of each refusal it raises for
    ``bad`` arrays (one whose B or S does not divide)."""
    del group
    mesh = Mesh(shape)
    cfg = ttag.TaggerConfig(vocab_size=64, num_tags=4, d_model=32,
                            head_dim=8, ffn_dim=64)
    _, _, place = ttag.make_train_step(cfg, mesh, device="cpu")
    blocks, errors = [], []
    for a in arrays:
        try:
            blocks.append(place(a).numpy())
        except ValueError as exc:   # the refusal is what is recorded
            errors.append(str(exc))
    return {"coords": mesh.coords, "blocks": blocks, "errors": errors}

"""Collectives over a ``torch.distributed`` process group.

Counterpart of ``synapseml_tpu/parallel/collectives.py`` (``all_reduce_sum``
:20, ``all_gather`` :28, tiled, ``axis_size`` :36, ``axis_index`` :53), of
the reference's ``lax.pmax`` (``all_reduce_max``) and of
``host_allgather_rows`` (``synapseml_tpu/parallel/distributed.py:266``,
here :func:`gather_rows`). The reference's ``mesh`` axis ``"dp"`` is a
process group here: one rank is one device, and rank order is shard order.

Every result is bitwise the same on every rank, on the CPU and on the
card, run after run. Data-parallel training takes its split decisions on
the host from the reduced histograms on every rank; a last-bit difference
between ranks could grow different trees and leave one rank waiting in a
collective that another never enters. NCCL's and gloo's ``SUM`` promise
no association order, so no float is ever summed by the backend:
:func:`exchange` gathers every rank's tensor exactly, and the reductions
add the ranks' slots in rank order on each rank, ``((x0 + x1) + x2) + ...``
in the tensor's own dtype, as the reference's two-shard ``psum`` is
``x0 + x1``.

The exact gather needs only ``all_reduce``, which gloo offers on CUDA
tensors too: each rank writes its tensor's bytes, as int32 words, into its
own slot of a zeroed ``[W, words]`` buffer, and the buffer is summed. Every
word has one nonzero addend, so the integer sum is each rank's bit pattern
(``-0.0`` and NaN payloads included). The cost: each rank's reduction moves
W times the tensor (``stats.bytes`` counts the buffer), where a
reduce-scatter would move about twice it; making it cheaper is later work.

The group decides the transport: NCCL between cards, gloo on the CPU and
for ranks that share one card. Tensors stay on the device they are
given. :data:`ALONE` stands for this process alone where no
``torch.distributed`` group is initialized: a world of one rank, as the
reference's one-process mesh over its own devices is, whose exchange is
the tensor itself and makes no backend call.
``stats`` counts the calls, their buffer bytes and, with ``stats.timed``
set, the seconds spent in them with the device synchronised around each.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist


@dataclasses.dataclass
class CollectiveStats:
    calls: int = 0
    bytes: int = 0
    seconds: float = 0.0
    timed: bool = False

    def reset(self) -> None:
        self.calls, self.bytes, self.seconds = 0, 0, 0.0


stats = CollectiveStats()


class _Alone:
    """The world of one rank that a process forms without a process group."""

    def __repr__(self) -> str:
        return "collectives.ALONE"


ALONE = _Alone()


def _initialized() -> bool:
    return dist.is_available() and dist.is_initialized()


def check_group(mesh):
    """``mesh`` as the process group a data-parallel fit runs over; raises
    unless it is one that this process belongs to. ``None`` is the world
    group, or :data:`ALONE` where none is initialized."""
    if mesh is None:
        mesh = dist.group.WORLD if _initialized() else ALONE
    if mesh is ALONE:
        return ALONE
    if not _initialized():
        raise ValueError(
            "mesh= needs an initialized torch.distributed process group "
            "(init_process_group), one rank per device")
    if not isinstance(mesh, dist.ProcessGroup):
        raise ValueError(
            f"mesh must be a torch.distributed process group (the "
            f"counterpart of the reference's 1-axis 'dp' mesh), got "
            f"{type(mesh).__name__}")
    if dist.get_rank(mesh) < 0:
        raise ValueError("this process has no rank in the mesh's group")
    return mesh


def axis_size(group) -> int:
    """Ranks in ``group`` (the reference's ``axis_size("dp")``)."""
    return 1 if group is ALONE else dist.get_world_size(group)


def axis_index(group) -> int:
    """This process's rank in ``group`` (``lax.axis_index("dp")``)."""
    return 0 if group is ALONE else dist.get_rank(group)


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def exchange(x: torch.Tensor, group) -> torch.Tensor:
    """[W, *x.shape]: every rank's ``x`` (same shape and dtype on every
    rank), in rank order, bit for bit."""
    if group is ALONE:
        return x[None].clone()
    w, r = axis_size(group), axis_index(group)
    x = x.contiguous()
    flat = x.reshape(-1).view(torch.uint8)
    n_bytes = flat.numel()
    buf = torch.zeros((w, -(-max(n_bytes, 1) // 4) * 4), dtype=torch.uint8,
                      device=x.device)
    buf[r, :n_bytes] = flat
    if stats.timed:
        _sync(x.device)
        start = time.perf_counter()
    dist.all_reduce(buf.view(torch.int32), op=dist.ReduceOp.SUM, group=group)
    if stats.timed:
        _sync(x.device)
        stats.seconds += time.perf_counter() - start
    stats.calls += 1
    stats.bytes += buf.numel()
    return buf[:, :n_bytes].contiguous().view(x.dtype).reshape(
        (w,) + tuple(x.shape))


def all_reduce_sum(x: torch.Tensor, group) -> torch.Tensor:
    """The ranks' ``x`` summed in rank order, ``((x0 + x1) + x2) + ...``,
    in ``x``'s dtype: bitwise the same on every rank and device."""
    slots = exchange(x, group)
    acc = slots[0]
    for s in slots[1:]:
        acc = acc + s
    return acc


def all_reduce_max(x: torch.Tensor, group) -> torch.Tensor:
    """Elementwise max over the ranks' ``x`` (the reference's ``lax.pmax``)."""
    return exchange(x, group).amax(0)


def all_gather(x: torch.Tensor, group) -> torch.Tensor:
    """The ranks' ``x`` [n, ...] concatenated in rank order, [W * n, ...]
    (``lax.all_gather(..., tiled=True)``)."""
    slots = exchange(x, group)
    return slots.reshape((-1,) + tuple(x.shape[1:]))


def gather_rows(a: np.ndarray, group,
                device: Optional[torch.device] = None) -> np.ndarray:
    """Bit-exact gather of per-rank row blocks with a ragged first dim
    (any dtype: float64 and int64 ride as their bytes), concatenated in
    rank order, as host numpy. The exchange runs on ``device`` (the fit's;
    an NCCL group needs a CUDA one)."""
    a = np.ascontiguousarray(a)
    if group is ALONE:
        return a
    device = torch.device("cpu") if device is None else torch.device(device)
    counts = exchange(torch.tensor([a.shape[0]], dtype=torch.int64,
                                   device=device), group).cpu().numpy()[:, 0]
    n_max = max(int(counts.max()), 1)   # a well-shaped call when all are empty
    padded = np.zeros((n_max,) + a.shape[1:], a.dtype)
    padded[:a.shape[0]] = a
    slots = exchange(torch.from_numpy(padded).to(device), group).cpu().numpy()
    return np.concatenate([slots[i, :counts[i]] for i in range(len(counts))])

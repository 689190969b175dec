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
set, the seconds spent in them with the device synchronised around each;
``stats.kinds`` splits them by kind (``exchange``, ``rotate``,
``all_to_all``).

Sequence parallelism moves blocks rather than sums: :func:`rotate` sends
a tensor to one rank while receiving one from another (the ring's
``lax.ppermute``), :func:`all_to_all` trades equal slices with every rank
(Ulysses' tiled ``lax.all_to_all``). Both move a tensor's bytes (any
dtype). gloo's point-to-point calls read and write host memory only: on
the card a CUDA tensor fails with ``writev ... Bad address``
(``tools/gloo_cuda_probe.py``), so :func:`rotate` stages a CUDA tensor
through pinned host buffers for a gloo group, always (one copy out, the
transfer, one copy in; counted in ``stats.staged_bytes``). gloo's
``all_to_all_single`` takes CUDA tensors (it stages them itself), and an
NCCL group moves device memory directly. The group's backend decides
which; nothing is tried and swapped.
"""
from __future__ import annotations

import contextlib
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
    staged_bytes: int = 0
    kinds: dict = dataclasses.field(default_factory=dict)

    def reset(self) -> None:
        self.calls, self.bytes, self.seconds = 0, 0, 0.0
        self.staged_bytes = 0
        self.kinds = {}

    def record(self, kind: str, n_bytes: int, seconds: float) -> None:
        self.calls += 1
        self.bytes += n_bytes
        self.seconds += seconds
        k = self.kinds.setdefault(kind, {"calls": 0, "bytes": 0,
                                         "seconds": 0.0})
        k["calls"] += 1
        k["bytes"] += n_bytes
        k["seconds"] += seconds


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


@contextlib.contextmanager
def _timed(kind: str, n_bytes: int, device: torch.device):
    """Record one call of ``kind`` moving ``n_bytes``; with
    ``stats.timed``, its seconds with ``device`` synchronised around it."""
    if stats.timed:
        _sync(device)
        start = time.perf_counter()
    yield
    seconds = 0.0
    if stats.timed:
        _sync(device)
        seconds = time.perf_counter() - start
    stats.record(kind, n_bytes, seconds)


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
    with _timed("exchange", buf.numel(), x.device):
        dist.all_reduce(buf.view(torch.int32), op=dist.ReduceOp.SUM,
                        group=group)
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


def _staged(x: torch.Tensor, group) -> bool:
    """Whether ``x`` rides a point-to-point transfer through host memory:
    a CUDA tensor in a gloo group."""
    return x.is_cuda and dist.get_backend(group) == dist.Backend.GLOO


def _wire(x: torch.Tensor, staged: bool) -> torch.Tensor:
    """``x``'s bytes, ``[x.shape[0], -1]`` uint8, on the wire's side: a
    pinned host copy where ``staged``."""
    flat = x.contiguous().view(torch.uint8).reshape(x.shape[0], -1)
    if not staged:
        return flat
    host = torch.empty(flat.shape, dtype=torch.uint8, pin_memory=True)
    host.copy_(flat)
    stats.staged_bytes += flat.numel()
    return host


def _unwire(buf: torch.Tensor, like: torch.Tensor, staged: bool
            ) -> torch.Tensor:
    """The received bytes ``buf`` as a tensor shaped and typed as ``like``
    (on its device)."""
    if staged:
        stats.staged_bytes += buf.numel()
        buf = buf.to(like.device)
    return buf.view(like.dtype).reshape(like.shape)


def rotate(x: torch.Tensor, group, send_to: int, recv_from: int
           ) -> torch.Tensor:
    """Send ``x`` to global rank ``send_to`` and return the tensor of the
    same shape and dtype that global rank ``recv_from`` sends (the
    reference's ``lax.ppermute`` of one ring step): one
    ``batch_isend_irecv`` of an isend and an irecv. In
    :data:`ALONE` the ring is this rank: ``x`` comes back."""
    if group is ALONE:
        return x
    staged = _staged(x, group)
    send = _wire(x, staged)
    recv = torch.empty_like(send)
    with _timed("rotate", send.numel(), x.device):
        ops = [dist.P2POp(dist.isend, send, send_to, group),
               dist.P2POp(dist.irecv, recv, recv_from, group)]
        for work in dist.batch_isend_irecv(ops):
            work.wait()
    return _unwire(recv, x, staged)


def all_to_all(x: torch.Tensor, group, split_dim: int, concat_dim: int
               ) -> torch.Tensor:
    """The tiled all-to-all (``lax.all_to_all(..., tiled=True)``): ``x``
    cut into W equal slices along ``split_dim``, slice j sent to the
    group's rank j, and the slices received concatenated along
    ``concat_dim`` in the group's rank order; one
    ``all_to_all_single``."""
    w = axis_size(group)
    if x.shape[split_dim] % w:
        raise ValueError(f"all_to_all: dimension {split_dim} of "
                         f"{tuple(x.shape)} does not split over {w} ranks")
    if w == 1:
        return x
    slices = torch.stack(x.chunk(w, dim=split_dim))
    send = _wire(slices, False)
    recv = torch.empty_like(send)
    with _timed("all_to_all", send.numel(), x.device):
        dist.all_to_all_single(recv, send, group=group)
    got = _unwire(recv, slices, False)
    return torch.cat(got.unbind(0), dim=concat_dim)

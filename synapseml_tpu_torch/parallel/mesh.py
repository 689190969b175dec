"""The five-axis device mesh over the ranks of a ``torch.distributed`` world.

Counterpart of ``synapseml_tpu/parallel/mesh.py``. The reference builds a
named ``jax.sharding.Mesh`` over a slice and lets XLA insert the
collectives. Here a rank is a device, and :class:`Mesh` lays the world's
ranks out as the reference lays its devices out: in :data:`AXES` order,
``np.asarray(devices).reshape(shape)``, so rank ``r`` sits at
``np.unravel_index(r, shape)``. A mesh of more than one rank holds this
rank's coordinate on each axis, one process group a line of each axis
above 1 (made by ``dist.new_group`` on every rank in the same order, so
every rank must build its meshes in the same order) and, for an axis,
this rank's neighbours in global ranks. :meth:`Mesh.block` cuts this
rank's block out of a global array, as ``jax.device_put(arr,
NamedSharding(mesh, P(...)))`` places it.

The axes that run over ranks are ``dp`` (batch), ``sp`` (sequence: ring
and Ulysses attention) and ``tp`` where it carries only the sequence (the
serving ring). A mesh with ``pp`` or ``ep`` above 1, and a ``tp`` axis
that shards heads or weights, is ROADMAP item 4c and raises naming it. A
mesh of more than one rank in a process without a world of that size
may be described (``TaggerConfig.for_mesh`` reads its sizes), but every
path that would run on it raises ``RuntimeError`` saying what world it
needs: nothing quietly runs it as one rank.

Mesh axes (the framework's canonical names):
  dp — data parallel (batch)          sp — sequence/context parallel
  pp — pipeline parallel (stages)     tp — tensor parallel (heads / ffn)
  ep — expert parallel (MoE)
"""
from __future__ import annotations

import math
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch.distributed as dist

from synapseml_tpu_torch.parallel import collectives

AXES = ("dp", "pp", "sp", "tp", "ep")


def _prime_factors(n: int) -> List[int]:
    out, d = [], 2
    while d * d <= n:
        while n % d == 0:
            out.append(d)
            n //= d
        d += 1
    if n > 1:
        out.append(n)
    return sorted(out, reverse=True)


def factor_axes(
    n_devices: int,
    want: Optional[Dict[str, int]] = None,
) -> Dict[str, int]:
    """Factor ``n_devices`` into the five canonical axes.

    Explicit sizes in ``want`` are honored (their product must divide
    n_devices); the remainder is distributed round-robin over the unpinned
    model axes (tp, sp, pp) before spilling into dp, so a pure power-of-two
    slice exercises every parallelism style.
    """
    want = dict(want or {})
    sizes = {a: want.get(a, 0) for a in AXES}
    pinned = math.prod(v for v in sizes.values() if v > 0)
    if n_devices % pinned != 0:
        raise ValueError(
            f"pinned axes product {pinned} does not divide {n_devices}")
    rest = n_devices // pinned
    free = [a for a in ("tp", "sp", "pp") if sizes[a] == 0]
    for a in AXES:
        if sizes[a] == 0:
            sizes[a] = 1
    for p in _prime_factors(rest):
        # spread model-parallel factors first, then pile the rest onto dp
        target = None
        for a in free:
            if sizes[a] == 1:
                target = a
                break
        if target is None:
            target = "dp"
        sizes[target] *= p
    if math.prod(sizes.values()) != n_devices:
        raise AssertionError(f"factor_axes: {sizes} does not cover "
                             f"{n_devices} devices")
    return sizes


def _world_size() -> int:
    """Ranks in this process's ``torch.distributed`` world; 1 without one."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size()
    return 1


def coords_of(rank: int, shape: Dict[str, int]) -> Dict[str, int]:
    """Rank ``rank``'s coordinate on each axis of a mesh of ``shape``:
    where the reference's ``np.asarray(devices).reshape(shape)`` puts
    device ``rank``."""
    return dict(zip(AXES, (int(c) for c in np.unravel_index(
        rank, tuple(shape[a] for a in AXES)))))


class Mesh:
    """Axis sizes over :data:`AXES`, and this rank's place among them.

    ``shape`` is a dict in axis order, as the reference's ``Mesh.shape``
    is. A mesh of one rank is this process alone. A mesh of ``n > 1``
    ranks built in a process whose world has ``n`` ranks is bound to it:
    the constructor makes the axis groups (a collective call: every rank
    builds the same meshes in the same order). Otherwise it is only a
    description, and :meth:`require_world` raises."""

    axis_names = AXES

    def __init__(self, shape: Optional[Dict[str, int]] = None):
        shape = dict(shape or {})
        unknown = set(shape) - set(AXES)
        if unknown:
            raise ValueError(f"unknown mesh axes {sorted(unknown)}; the "
                             f"axes are {AXES}")
        self.shape = {a: int(shape.get(a, 1)) for a in AXES}
        self.rank = 0
        self.coords = {a: 0 for a in AXES}
        self._lines: Dict[str, Tuple[List[int], object]] = {}
        self.bound = self.size == 1
        if self.size > 1 and _world_size() == self.size:
            self._bind()

    @property
    def size(self) -> int:
        return math.prod(self.shape.values())

    def _bind(self) -> None:
        self.rank = dist.get_rank()
        grid = np.arange(self.size).reshape(
            tuple(self.shape[a] for a in AXES))
        self.coords = coords_of(self.rank, self.shape)
        for i, a in enumerate(AXES):
            n = self.shape[a]
            if n == 1:
                continue
            # every line of the axis, in the same order on every rank;
            # along a line the global ranks rise with the coordinate, so
            # the group's own rank order is the axis' order
            for line in np.moveaxis(grid, i, -1).reshape(-1, n):
                ranks = [int(r) for r in line]
                group = dist.new_group(ranks)
                if self.rank in ranks:
                    self._lines[a] = (ranks, group)
        self.bound = True

    def require_world(self, what: str) -> None:
        """Raise ``RuntimeError`` unless this mesh can run ``what``: one
        rank, or bound to a world of its size."""
        if self.bound:
            return
        have = (f"a world of {_world_size()} ranks"
                if dist.is_available() and dist.is_initialized()
                else "no torch.distributed world")
        raise RuntimeError(
            f"{what} over a mesh of {self.size} ranks ({self.shape}) needs "
            f"a torch.distributed world of {self.size} ranks, one rank a "
            f"device (init_process_group(..., world_size={self.size}) on "
            f"every rank, then the mesh built on each); this process has "
            f"{have}")

    def index(self, axis: str) -> int:
        """This rank's coordinate on ``axis`` (``lax.axis_index``)."""
        return self.coords[axis]

    def ranks(self, axis: str) -> List[int]:
        """The global ranks of this rank's line along ``axis``, in axis
        order (this rank alone where the axis is 1)."""
        if self.shape[axis] == 1:
            return [self.rank]
        self.require_world(f"the {axis!r} axis")
        return list(self._lines[axis][0])

    def neighbours(self, axis: str) -> Tuple[int, int]:
        """``(previous, next)`` on ``axis``' ring, in global ranks."""
        line = self.ranks(axis)
        i = self.index(axis)
        return line[(i - 1) % len(line)], line[(i + 1) % len(line)]

    def group(self, *axes: str):
        """The process group of the ranks that differ from this one only
        on ``axes``, in their rank order: one axis' line, or the whole
        mesh where ``axes`` cover every axis above 1.
        :data:`collectives.ALONE` where that is this rank alone."""
        spanned = [a for a in AXES if self.shape[a] > 1 and a in axes]
        if not spanned:
            return collectives.ALONE
        self.require_world(f"a group over {axes}")
        if len(spanned) == 1:
            return self._lines[spanned[0]][1]
        if all(self.shape[a] == 1 for a in AXES if a not in axes):
            return dist.group.WORLD
        raise NotImplementedError(
            f"a group over {axes} that is not the whole mesh {self.shape}: "
            f"that is ROADMAP item 4c")

    def block(self, arr, spec: Sequence[Optional[str]]):
        """This rank's block of the global ``arr`` (numpy or a tensor),
        dimension ``i`` cut over the mesh axis ``spec[i]`` (None: whole),
        as ``NamedSharding(mesh, P(*spec))`` places it. Raises
        ``ValueError`` where a dimension does not divide by its axis."""
        self.require_world("a block of a global array")
        index = []
        for dim, axis in enumerate(spec):
            if axis is None:
                index.append(slice(None))
                continue
            n, length = self.shape[axis], arr.shape[dim]
            if length % n:
                raise ValueError(
                    f"dimension {dim} of a {tuple(arr.shape)} array does "
                    f"not divide over the mesh axis {axis!r} of {n} ranks")
            step = length // n
            i = self.index(axis)
            index.append(slice(i * step, (i + 1) * step))
        return arr[tuple(index)]

    def __repr__(self) -> str:
        return f"Mesh({self.shape})"


def require_axes(mesh: Mesh, allowed: Sequence[str], item: str,
                 what: str) -> None:
    """Raise ``NotImplementedError`` naming ROADMAP ``item`` where an axis
    outside ``allowed`` is above 1 in ``mesh``."""
    over = {a: n for a, n in mesh.shape.items() if n > 1
            and a not in allowed}
    if over:
        raise NotImplementedError(
            f"{what} over {over} ({mesh.shape}): the port runs "
            f"{'/'.join(allowed) or 'no axis'} over ranks here; that is "
            f"ROADMAP item {item}")


def build_mesh(
    devices: Optional[Sequence] = None,
    want: Optional[Dict[str, int]] = None,
) -> Mesh:
    """The mesh over this process's world (one rank a device), factored
    as the reference factors its devices. ``devices`` (default: the
    world's) may only name as many devices as the world has ranks. Every
    axis above 1 must be dp, sp or tp; pp and ep over ranks raise naming
    item 4c. A mesh wider than the process's world raises
    ``RuntimeError``."""
    world = _world_size()
    n = world if devices is None else len(devices)
    pinned = math.prod(v for a, v in (want or {}).items()
                       if a in AXES and v > 0)
    need = max(n, pinned)
    sizes = factor_axes(need, want)
    over = {a: sizes[a] for a in ("pp", "ep") if sizes[a] > 1}
    if over:
        raise NotImplementedError(
            f"a mesh with {over} over ranks ({sizes}): pipeline and "
            f"expert parallelism over ranks is ROADMAP item 4c")
    if need != world:
        raise RuntimeError(
            f"a mesh of {need} ranks (devices={n}, want={want}) needs a "
            f"torch.distributed world of {need} ranks, one rank a device; "
            f"this process's world has {world}")
    return Mesh(sizes)


def single_device_mesh() -> Mesh:
    return Mesh({a: 1 for a in AXES})

"""The five-axis device mesh, as far as one rank goes.

Counterpart of ``synapseml_tpu/parallel/mesh.py``. The reference builds a
named ``jax.sharding.Mesh`` over a slice and lets XLA insert the
collectives. Here a mesh is a plain description: :class:`Mesh` holds the
five canonical axes and their sizes, which is what the tagger reads
(``TaggerConfig.for_mesh``, the attention builders). Only a world of one
rank runs: every axis 1. A wider mesh (tensor, pipeline or expert
parallelism over ranks, and the sharding helpers ``data_sharding`` and
``shard_batch``) is ROADMAP item 4c and raises here.

Mesh axes (the framework's canonical names):
  dp — data parallel (batch)          sp — sequence/context parallel
  pp — pipeline parallel (stages)     tp — tensor parallel (heads / ffn)
  ep — expert parallel (MoE)
"""
from __future__ import annotations

import math
from typing import Dict, List, Optional, Sequence

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


class Mesh:
    """Axis sizes over :data:`AXES`; ``shape`` is a dict in axis order, as
    the reference's ``Mesh.shape`` is. Any size may be described; the
    builders and the attention paths refuse more than one rank."""

    axis_names = AXES

    def __init__(self, shape: Optional[Dict[str, int]] = None):
        shape = dict(shape or {})
        unknown = set(shape) - set(AXES)
        if unknown:
            raise ValueError(f"unknown mesh axes {sorted(unknown)}; the "
                             f"axes are {AXES}")
        self.shape = {a: int(shape.get(a, 1)) for a in AXES}

    @property
    def size(self) -> int:
        return math.prod(self.shape.values())

    def __repr__(self) -> str:
        return f"Mesh({self.shape})"


def require_one_rank(mesh: Mesh, item: str, what: str) -> None:
    """Raise ``NotImplementedError`` naming ROADMAP ``item`` where ``mesh``
    spans more than one rank."""
    if mesh.size != 1:
        raise NotImplementedError(
            f"{what} over a mesh of {mesh.size} ranks ({mesh.shape}): the "
            f"port runs a world of one rank; that is ROADMAP item {item}")


def build_mesh(
    devices: Optional[Sequence] = None,
    want: Optional[Dict[str, int]] = None,
) -> Mesh:
    """The mesh over ``devices`` (default: this process's one device),
    factored as the reference factors it. Raises for more than one rank
    (item 4c)."""
    n = 1 if devices is None else len(devices)
    pinned = math.prod(v for a, v in (want or {}).items()
                       if a in AXES and v > 0)
    if n > 1 or pinned > 1:
        raise NotImplementedError(
            f"a mesh of {max(n, pinned)} ranks (want={want}): the port runs "
            f"a world of one rank; tensor, pipeline and expert parallelism "
            f"over ranks is ROADMAP item 4c")
    return Mesh(factor_axes(n, want))


def single_device_mesh() -> Mesh:
    return Mesh({a: 1 for a in AXES})

"""Measured routing for the true-int8 QOperator execution lane.

The counterpart of the reference package's ``onnx/quant_route.py``. The
QOperator contractions (``QLinearConv`` / ``QLinearMatMul`` /
``ConvInteger`` / ``MatMulInteger``) have two formulations in
:mod:`~synapseml_tpu_torch.onnx.importer`:

- ``"dequant"``, the widened reference: zero points subtracted first, the
  contraction in float64 (cuBLAS DGEMM, cuDNN's float64 convolution) and
  the result cast to int32. Each product is an integer of at most 255² and
  every partial sum stays far below 2**53, so the float64 contraction is
  exact in any summation order: the int32 accumulator is the reference's
  bit for bit.
- ``"int8"``: the operands stay int8 into ``torch._int_mm`` (cuBLASLt's
  s8 x s8 -> s32 GEMM; a convolution rides an int8 im2col made from
  ``Tensor.unfold`` views, its K padded with zeros to a multiple of 8),
  zero points handled as exact integer corrections after the contraction.

On first sight of an (op kind, dtypes, zero-point structure, bucketed
shape) class on the card, :func:`route_matmul` / :func:`route_conv` probe
both lanes at a clamped stand-in shape, verify the int8 accumulator equals
the widened one EXACTLY, time both and persist the winner
(``onnx_int8_routing.json``). Any mismatch, failure or timing regression
lands ``"dequant"``. Where the reference routes on ``jax.default_backend()
== "tpu"``, the port routes where the operand lives on a CUDA device; on
the CPU both packages serve ``"dequant"``.

Eligibility adds ``torch._int_mm``'s own shape rules to the reference's
2-D and dtype gates — more than 16 rows, and K and N multiples of 8 (the
conv lane pads K itself) — so an ineligible class (a one-image bucket's
head) routes to ``"dequant"`` by eligibility instead of failing its probe.
``SYNAPSEML_ONNX_INT8=0`` kills the lane. Decisions are counted in
``onnx_int8_route_total{backend=}``.
"""
from __future__ import annotations

import json
import os

import numpy as np
import torch

from synapseml_tpu_torch.runtime import autotune
from synapseml_tpu_torch.runtime import telemetry as _tm
from synapseml_tpu_torch.runtime.proberoute import RouteTable
from synapseml_tpu_torch.runtime.proberoute import best_of as _best_of

_TABLE = RouteTable("onnx_int8_routing.json")

# probe shape clamps: verify+time at a bounded stand-in for the real
# shape class (same dtypes/zp structure) so a first sight of a huge
# conv does not pay a huge probe
_PROBE_ROWS_CAP = 256
_PROBE_SPATIAL_CAP = 32
_PROBE_BATCH_CAP = 2

# torch._int_mm's refusals on the card: rows > 16, K and N multiples of 8
_INT_MM_MIN_ROWS = 17
_INT_MM_MULTIPLE = 8

_INT8_DTYPES = (torch.int8, torch.uint8)
_M_ROUTE = {b: _tm.counter("onnx_int8_route_total", backend=b)
            for b in ("int8", "dequant")}


def enabled() -> bool:
    return os.environ.get("SYNAPSEML_ONNX_INT8", "1") != "0"


def count(backend: str) -> None:
    """Count one served decision in onnx_int8_route_total — the op
    dispatchers route with ``do_count=False`` and report the lane that
    actually served AFTER the int8 leg's outcome is known (a leg that
    raises is served by the widened path and counts dequant)."""
    _M_ROUTE[backend].inc()


def _routes_here(t: torch.Tensor) -> bool:
    """The lane routes where the operand lives on the card."""
    return t.is_cuda


def concrete_zero(zp) -> bool:
    """True when ``zp`` is absent or a HOST all-zero value — the
    eligibility test of the conv lane's weight zero point. A device tensor
    is never read (a sync on every call, and an error under a CUDA-graph
    capture): it routes to the widened path, as a traced zero point does
    in the reference. Initializers are host values in the port."""
    if zp is None:
        return True
    if isinstance(zp, torch.Tensor):
        return False
    return not np.any(np.asarray(zp))


def _dt(dt) -> str:
    return str(dt).replace("torch.", "")


def _zp_meta(zp):
    """(dtype name, ndim, on the device) of a zero point, or None: what
    the key and the probe read of it (never its value)."""
    if zp is None:
        return None
    if isinstance(zp, torch.Tensor):
        return (_dt(zp.dtype), zp.ndim, True)
    a = np.asarray(zp)
    return (a.dtype.name, a.ndim, False)


def _zp_tag(meta) -> str:
    if meta is None:
        return "none"
    return f"v{meta[1]}" if meta[1] else "s"


def _bucket(v: int, lo: int = 1, hi: int = 65536) -> int:
    return 1 << (int(min(max(v, lo), hi)) - 1).bit_length()


def _key(dev, kind: str, parts) -> str:
    return (autotune.key_prefix("q1", dev) + f"|{kind}|"
            + "|".join(str(p) for p in parts))


def _matmul_parts_p(a_dt, b_dt, a_zp, b_zp, n: int, k: int, m: int):
    """Key parts from primitives — the same tuple route args carry to
    the probe, so one lane rargs list serves key_fn AND probe_hook."""
    return (a_dt, b_dt, _zp_tag(a_zp), _zp_tag(b_zp),
            f"n{_bucket(n)}", f"k{_bucket(k)}", f"m{_bucket(m)}")


def _conv_parts_p(x_dt, x_zp, x_shape, w_shape, attrs: str):
    spatial = "x".join(str(_bucket(s, hi=4096)) for s in x_shape[2:])
    return (x_dt, _zp_tag(x_zp), f"b{_bucket(x_shape[0])}",
            f"ci{x_shape[1]}", f"co{w_shape[0]}",
            "k" + "x".join(str(s) for s in w_shape[2:]),
            f"s{spatial}", attrs)


def int_mm_eligible(rows: int, k: int, n: int) -> bool:
    """``torch._int_mm`` takes the shapes (its refusals on the card)."""
    return (rows >= _INT_MM_MIN_ROWS and k > 0 and n > 0
            and k % _INT_MM_MULTIPLE == 0 and n % _INT_MM_MULTIPLE == 0)


def conv_rows_and_out(x_shape, w_shape, attrs: str):
    """(rows of the im2col GEMM, output channels a group) of a conv
    class — what :func:`int_mm_eligible` reads for the conv lane, whose
    K is padded."""
    from synapseml_tpu_torch.onnx import importer

    ctx = _Attrs(**json.loads(attrs))
    _, strides, dilations, group, pads = importer._conv_params(
        ctx, tuple(x_shape), tuple(w_shape))
    out = importer._conv_out_shape(x_shape[2:], w_shape[2:], strides,
                                   dilations, pads)
    return x_shape[0] * int(np.prod(out, dtype=np.int64)), \
        w_shape[0] // max(1, group)


def route_matmul(a, b, a_zp, b_zp, do_count: bool = True) -> str:
    """Route one MatMulInteger/QLinearMatMul contraction. Eligibility:
    2-D x 2-D, int8/uint8 operands (uint8 rides an exact -128 shift), and
    ``torch._int_mm``'s shapes."""
    backend = "dequant"
    if (a.ndim == 2 and b.ndim == 2 and a.dtype in _INT8_DTYPES
            and b.dtype in _INT8_DTYPES
            and int_mm_eligible(a.shape[0], a.shape[1], b.shape[1])
            and enabled() and _routes_here(a)):
        n, k = a.shape
        backend = _MM_LANE.route(a.device, _dt(a.dtype), _dt(b.dtype),
                                 _zp_meta(a_zp), _zp_meta(b_zp), n, k,
                                 b.shape[1])
    if do_count:
        count(backend)
    return backend


def route_conv(x, w, x_zp, w_zp, attrs: str,
               do_count: bool = True) -> str:
    """Route one ConvInteger/QLinearConv. Eligibility: int8/uint8
    activations, int8 weights with a zero (or absent) host weight zero
    point — the static quantizer's symmetric-weight default — and an
    im2col GEMM ``torch._int_mm`` takes; any other layout takes the
    widened path."""
    backend = "dequant"
    if (x.dtype in _INT8_DTYPES and w.dtype == torch.int8
            and concrete_zero(w_zp) and enabled() and _routes_here(x)):
        rows, cout = conv_rows_and_out(tuple(x.shape), tuple(w.shape),
                                       attrs)
        if int_mm_eligible(rows, _INT_MM_MULTIPLE, cout):
            backend = _CONV_LANE.route(x.device, _dt(x.dtype),
                                       _zp_meta(x_zp), tuple(x.shape),
                                       tuple(w.shape), attrs)
    if do_count:
        count(backend)
    return backend


def poison_matmul(a, b, a_zp, b_zp) -> None:
    """Demote ONE matmul shape class to the widened path after a
    runtime failure of its int8 leg — persisted, so a verdict the
    clamped probe landed but the real shape cannot run is not
    re-trusted (or after restart)."""
    n, k = a.shape
    _MM_LANE.poison(a.device, _dt(a.dtype), _dt(b.dtype), _zp_meta(a_zp),
                    _zp_meta(b_zp), n, k, b.shape[1])


def poison_conv(x, w, x_zp, attrs: str) -> None:
    """Conv twin of :func:`poison_matmul`."""
    _CONV_LANE.poison(x.device, _dt(x.dtype), _zp_meta(x_zp),
                      tuple(x.shape), tuple(w.shape), attrs)


class _Attrs:
    """Minimal ctx stand-in for probing the conv cores outside a real
    graph: attribute dict with the onnx defaulting convention."""

    def __init__(self, **attrs):
        self._attrs = attrs
        self.opset = 21

    def attr(self, name, default=None):
        got = self._attrs.get(name)
        return default if got is None else got


def _verify_exact(got, want) -> bool:
    """The int8 accumulator must be EXACT — same dtype, same bits."""
    return got.dtype == want.dtype and np.array_equal(got, want)


# one record a probe run by this process: {"kind", "parts", "exact",
# "int8_s", "dequant_s", "verdict"} (best-of wall seconds at the clamped
# probe shape, None where a leg was not timed) — what a report prints
# beside autotune.snapshot()'s verdicts
PROBES: list = []


def _verify_and_time(int8_fn, wide_fn, args, kind: str, parts) -> str:
    rec = {"kind": kind, "parts": list(parts), "exact": False,
           "int8_s": None, "dequant_s": None}
    fns = {"int8": autotune.aot(int8_fn, *args),
           "dequant": autotune.aot(wide_fn, *args)}

    def verify(got, want):
        rec["exact"] = _verify_exact(got, want)
        return rec["exact"]

    def timed(fn, a, reps):
        t = _best_of(fn, a)
        rec["int8_s" if fn is fns["int8"] else "dequant_s"] = t
        return t

    rec["verdict"] = autotune.verify_then_time(
        fns, args, "dequant", verify_fn=verify, time_fn=timed)
    PROBES.append(rec)
    return rec["verdict"]


def _rand_q(rng, shape, dtype, dev):
    dt = np.dtype(dtype)
    info = np.iinfo(dt)
    a = rng.integers(info.min, info.max + 1, shape).astype(dt)
    return torch.from_numpy(a).to(dev)


def _probe_zp(rng, meta, length: int, dev):
    """Synthetic zero point with the SAME structure (none / scalar /
    vector), dtype and place (a host scalar or a tensor on the probe's
    device) as the real one."""
    if meta is None:
        return None
    dt = np.dtype(meta[0])
    info = np.iinfo(dt)
    if meta[1]:
        return torch.from_numpy(rng.integers(
            info.min, info.max + 1, length).astype(dt)).to(dev)
    v = dt.type(rng.integers(info.min, info.max + 1))
    return torch.tensor(int(v), dtype=getattr(torch, meta[0]),
                        device=dev) if meta[2] else v


def _probe_matmul(dev, a_dt, b_dt, a_zp, b_zp, n: int, k: int,
                  m: int) -> str:
    from synapseml_tpu_torch.onnx import importer

    rng = np.random.default_rng(0)
    n_p = min(n, _PROBE_ROWS_CAP)
    a = _rand_q(rng, (n_p, k), a_dt, dev)
    b = _rand_q(rng, (k, m), b_dt, dev)
    za = _probe_zp(rng, a_zp, n_p, dev)
    zb = _probe_zp(rng, b_zp, m, dev)
    args = tuple(v for v in (a, b, za, zb) if v is not None)
    has_za, has_zb = za is not None, zb is not None

    def unpack(vals):
        it = iter(vals)
        aa, bb = next(it), next(it)
        return (aa, bb, next(it) if has_za else None,
                next(it) if has_zb else None)

    return _verify_and_time(
        lambda *v: importer._matmul_int8_core(*unpack(v)),
        lambda *v: importer._matmul_wide_core(*unpack(v)), args, "matmul",
        _matmul_parts_p(a_dt, b_dt, a_zp, b_zp, n, k, m))


def _probe_conv(dev, x_dt, x_zp, x_shape, w_shape, attrs: str) -> str:
    from synapseml_tpu_torch.onnx import importer

    rng = np.random.default_rng(0)
    parsed = json.loads(attrs)
    ctx = _Attrs(**parsed)
    xs = (min(x_shape[0], _PROBE_BATCH_CAP), x_shape[1]) + tuple(
        min(s, _PROBE_SPATIAL_CAP) for s in x_shape[2:])
    # spatial extent must still cover the EFFECTIVE kernel under the
    # probe clamp — (k-1)*dilation+1, not the raw tap count
    dil = parsed.get("dilations") or [1] * len(w_shape[2:])
    xs = xs[:2] + tuple(max(s, (kk - 1) * dd + 1) for s, kk, dd
                        in zip(xs[2:], w_shape[2:], dil))
    x = _rand_q(rng, xs, x_dt, dev)
    w = _rand_q(rng, w_shape, np.int8, dev)
    zx = _probe_zp(rng, x_zp, 1, dev)
    args = (x, w) if zx is None else (x, w, zx)

    def unpack(vals):
        return (vals[0], vals[1],
                vals[2] if len(vals) > 2 else None, None)

    return _verify_and_time(
        lambda *v: importer._conv_int8_core(ctx, *unpack(v)),
        lambda *v: importer._conv_wide_core(ctx, *unpack(v)), args, "conv",
        _conv_parts_p(x_dt, x_zp, x_shape, w_shape, attrs))


# Lane registrations: both share onnx_int8_routing.json and the q1| key
# schema. _probe_matmul / _probe_conv stay the monkeypatchable whole-probe
# seams, riding the autotuner's probe_hook form via late-bound lambdas.
_MM_LANE = autotune.register_lane(
    "onnx_int8_matmul",
    key_fn=lambda dev, *r: _key(dev, "matmul", _matmul_parts_p(*r)),
    candidates=("dequant", "int8"),
    reference="dequant",
    probe_hook=lambda *r: _probe_matmul(*r),
    table=_TABLE,
    groups=("onnx_int8",),
)
_CONV_LANE = autotune.register_lane(
    "onnx_int8_conv",
    key_fn=lambda dev, *r: _key(dev, "conv", _conv_parts_p(*r)),
    candidates=("dequant", "int8"),
    reference="dequant",
    probe_hook=lambda *r: _probe_conv(*r),
    table=_TABLE,
    groups=("onnx_int8",),
)


def clear_cache() -> None:
    """Test hook: drop the in-process memo + negative memo."""
    _MM_LANE.reset()
    _CONV_LANE.reset()
    PROBES.clear()

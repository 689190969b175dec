"""ONNX graph -> PyTorch importer: runs a loaded ONNX graph as torch ops.

The counterpart of the reference package's ``onnx/importer.py``: the graph
is parsed once (:mod:`synapseml_tpu_torch.onnx.proto`), each node is mapped
to a torch op, and the model becomes one ``apply(params, *inputs)`` function
over a dict of weights. ``bind`` moves the float weights to the card once and
returns the forward. No op here is a hand-written kernel: the reference
lowers ``Conv``/``MatMul``/``Gemm`` to XLA ops outside any Pallas kernel, so
the port runs them as ``torch.nn.functional.conv*`` and ``torch.matmul``
(cuDNN, cuBLAS on the card).

Design notes:
- **Host values versus device tensors.** Shape arithmetic stays in numpy,
  exactly where the reference keeps it (``Shape -> Gather -> Concat ->
  Reshape`` never touches the device), and the same ops take the host path
  (:func:`_is_host`, :func:`_all_host`). A host value that meets a tensor is
  first made a tensor on that tensor's device, explicitly
  (:func:`_operands`); an op the reference always runs on the device
  (``jnp``) makes its host inputs tensors on the run's device.
- **dtype promotion follows JAX's rules**, not torch's: a numpy value or a
  tensor is strongly typed whatever its rank (torch treats a 0-dim tensor
  like a Python scalar), so a bf16 activation meeting a float32 constant
  gives float32, as it does in the reference. A float64 host value becomes
  float32 when it reaches the device, as under JAX's default 32-bit mode.
  Integers are the exception: the reference narrows int64 to int32 on the
  device, the port keeps int64.
- **Rounding order is the reference's**: ``Gemm`` is matmul, then
  ``alpha``, then ``+ c``; ``BatchNormalization`` folds its statistics in
  float32 and casts the scale and bias to the activation dtype (``bind``
  folds once, as XLA's constant folding does for the reference); a
  scalar's value is rounded to the operation's dtype before it is used.
- **Float32 means float32**: every run disables TF32 in cuDNN and cuBLAS
  (:func:`_ieee_float32`), so a float32 forward on the card is not a TF32
  one. bf16 (``bind(cast_dtype=torch.bfloat16)``) is the fast path.
- Recurrent ops run a Python loop over time steps where the reference runs
  ``lax.scan``; so does ``Scan``, at every length. Control-flow bodies
  are lowered at import (:class:`_Subgraph`); a bound graph's bodies hold
  their float constants on the card, so a step of a warm forward copies
  nothing to the card and reads nothing back. A ``Loop`` whose condition
  is on the device is the exception: it reads the condition every
  iteration and cannot be captured into a CUDA graph.

An op outside the registry raises ``NotImplementedError`` when the graph
is imported; nothing falls back.
"""
from __future__ import annotations

import contextlib
import itertools
import math
import operator
import threading
import zlib
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from synapseml_tpu_torch import device as device_policy
from synapseml_tpu_torch.onnx import proto
from synapseml_tpu_torch.onnx import random as _random
from synapseml_tpu_torch.onnx.proto import Msg, node_attrs, tensor_to_numpy

_REGISTRY: Dict[str, Callable] = {}


def op(*names: str):
    def deco(fn):
        for n in names:
            _REGISTRY[n] = fn
        return fn
    return deco


class OpContext:
    """Per-node context handed to op impls."""

    __slots__ = ("attrs", "opset", "name", "op_type", "n_outputs")

    def __init__(self, attrs: Dict[str, Any], opset: int, name: str,
                 op_type: str, n_outputs: int):
        self.attrs = attrs
        self.opset = opset
        self.name = name
        self.op_type = op_type
        self.n_outputs = n_outputs

    def attr(self, key: str, default: Any = None) -> Any:
        return self.attrs.get(key, default)


# ---------------------------------------------------------------------------
# Host values, device tensors and dtypes
# ---------------------------------------------------------------------------

def _is_host(x) -> bool:
    return isinstance(x, (np.ndarray, np.generic, int, float, bool))


def _all_host(inputs) -> bool:
    return all(x is None or _is_host(x) for x in inputs)


def _static_int_list(x, what: str) -> List[int]:
    """Require a host-side (concrete) integer vector — used for shapes/axes."""
    if x is None:
        return []
    if isinstance(x, (list, tuple)):
        return [int(v) for v in x]
    if _is_host(x):
        return [int(v) for v in np.asarray(x).reshape(-1)]
    raise ValueError(
        f"ONNX import: {what} must be statically known (got a device "
        "tensor); constant-fold the producing subgraph or use an initializer")


_TORCH_OF = {np.dtype(k): v for k, v in (
    (np.bool_, torch.bool), (np.uint8, torch.uint8), (np.int8, torch.int8),
    (np.int16, torch.int16), (np.int32, torch.int32),
    (np.int64, torch.int64), (np.float16, torch.float16),
    (np.float32, torch.float32), (np.float64, torch.float64),
    (np.uint16, torch.uint16), (np.uint32, torch.uint32),
    (np.uint64, torch.uint64))}
_NUMPY_OF = {v: k for k, v in _TORCH_OF.items()}


def _canonical(dt: np.dtype) -> np.dtype:
    """The dtype a host value takes on the device: float64 becomes float32
    (the reference runs with JAX's 64-bit mode off); integers keep theirs."""
    return np.dtype(np.float32) if dt == np.float64 else dt


def _torch_dtype(dt) -> torch.dtype:
    """The torch dtype for a torch dtype, a numpy dtype or its name."""
    if isinstance(dt, torch.dtype):
        return dt
    dt = np.dtype(dt)
    if dt.name == "bfloat16":
        return torch.bfloat16
    if dt not in _TORCH_OF:
        raise ValueError(f"no torch dtype for {dt}")
    return _TORCH_OF[dt]


def _np_value(x) -> np.ndarray:
    """A host value as a numpy array in the dtype it takes on the device."""
    a = np.asarray(x)
    return a.astype(_canonical(a.dtype), copy=False)


class _Run(threading.local):
    """The device of the graph run in progress on this thread: where an op
    puts a tensor made from host values when no operand is a tensor."""
    device: Optional[torch.device] = None


_RUN = _Run()


@contextlib.contextmanager
def _running_on(dev: torch.device):
    prev, _RUN.device = _RUN.device, dev
    try:
        yield
    finally:
        _RUN.device = prev


def _device_of(xs) -> torch.device:
    for x in xs:
        if isinstance(x, torch.Tensor):
            return x.device
    if _RUN.device is None:
        raise RuntimeError("ONNX op called outside a graph run")
    return _RUN.device


def _tensor(x, dev: Optional[torch.device] = None) -> torch.Tensor:
    """``x`` as a tensor (``jnp.asarray``): a host value goes to ``dev`` (the
    run's device by default), a 0-d one by a fill, no copy. The copy does
    not wait for the card: CUDA stages pageable memory before the call
    returns, so the host array may go at once."""
    if isinstance(x, torch.Tensor):
        return x
    dev = dev if dev is not None else _device_of(())
    a = _np_value(x)
    td = _torch_dtype(a.dtype)
    if a.ndim == 0:
        return torch.full((), a.item(), dtype=td, device=dev)
    if not (a.flags.c_contiguous and a.flags.writeable):
        a = a.copy()
    t = torch.from_numpy(a.view(np.uint16) if td == torch.bfloat16 else a)
    return t.view(td).to(dev, non_blocking=True)


_TABLE_LOCK = threading.Lock()


def _table(ctx, key, dev: torch.device, build: Callable[[], np.ndarray],
           dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """A node's constant that depends on static shapes (an index or a
    weight table), built on the host by ``build`` and copied to ``dev``
    once per ``key``, device and ``dtype``, then kept on the node's
    context: later runs of the node, a bound forward's and a CUDA-graph
    capture's, copy nothing to the card."""
    tables = ctx.attrs.setdefault("__tables__", {})
    k = (key, str(dev), dtype)
    t = tables.get(k)
    if t is None:
        with _TABLE_LOCK, torch.inference_mode(False):
            t = tables.get(k)
            if t is None:
                t = _tensor(build(), dev)
                t = tables[k] = t if dtype is None else t.to(dtype)
    return t


def _strong_dtype(x) -> Optional[torch.dtype]:
    """x's dtype under JAX's promotion; None for a (weak) Python scalar."""
    if isinstance(x, torch.Tensor):
        return x.dtype
    if isinstance(x, (bool, int, float)):
        return None
    return _torch_dtype(_np_value(x).dtype)


def _result_dtype(xs) -> torch.dtype:
    strong = [d for d in map(_strong_dtype, xs) if d is not None]
    out = strong[0]
    for d in strong[1:]:
        out = torch.promote_types(out, d)
    if (not out.is_floating_point
            and any(isinstance(x, float) for x in xs)):
        out = torch.get_default_dtype()
    return out


def _scalar(x, dt: torch.dtype):
    """A 0-d host value as a Python number, rounded to ``dt`` first."""
    return torch.tensor(_np_value(x).item()).to(dt).item()


def _operands(xs, scalars: bool = True) -> list:
    """The operands of a device op, in JAX's result dtype: tensors cast to
    it, host arrays copied to the operands' device in it, and 0-d host
    values passed as Python numbers rounded to it (``scalars``; otherwise
    as 0-d tensors on the device, filled, not copied). A Python number
    keeps its dtype in torch's promotion, so the op's dtype is ``dt``."""
    dev = _device_of(xs)
    dt = _result_dtype(xs)
    out = []
    for x in xs:
        if isinstance(x, torch.Tensor):
            out.append(x if x.dtype == dt else x.to(dt))
        elif scalars and np.ndim(x) == 0:
            out.append(_scalar(x, dt))
        else:
            out.append(_tensor(x, dev).to(dt))
    return out


def _bin(fn, a, b, scalars: bool = True):
    return fn(*_operands((a, b), scalars))


class _TF32Runs:
    """How many graph runs are inside :func:`_ieee_float32`, process-wide,
    and the flags the first of them found."""

    lock = threading.Lock()
    active = 0
    saved: Tuple[bool, bool] = (True, True)


@contextlib.contextmanager
def _ieee_float32():
    """Float32 convolutions and matmuls in IEEE float32, not TF32: cuDNN
    allows TF32 by default, which would miss the reference's float32 by
    more than its tolerance.

    The flags are process-global and graphs run on several threads at
    once (one dispatch thread an executor), so the runs are counted under
    a lock: the first to enter saves the caller's flags and sets both
    False, the last to leave restores them, and while any run is inside
    both stay False. A thread that sets the flags itself while a run is
    inside is not stopped: the runs issuing after its write use its value
    until the last run leaves and restores the flags saved at the first
    entry, overwriting that write."""
    with _TF32Runs.lock:
        if _TF32Runs.active == 0:
            _TF32Runs.saved = (torch.backends.cudnn.allow_tf32,
                               torch.backends.cuda.matmul.allow_tf32)
            torch.backends.cudnn.allow_tf32 = False
            torch.backends.cuda.matmul.allow_tf32 = False
        _TF32Runs.active += 1
    try:
        yield
    finally:
        with _TF32Runs.lock:
            _TF32Runs.active -= 1
            if _TF32Runs.active == 0:
                (torch.backends.cudnn.allow_tf32,
                 torch.backends.cuda.matmul.allow_tf32) = _TF32Runs.saved


# ---------------------------------------------------------------------------
# Elementwise / math
# ---------------------------------------------------------------------------

def _ew(fn_np, fn_torch):
    def impl(ctx, *xs):
        if _all_host(xs):
            return fn_np(*[np.asarray(x) for x in xs])
        return fn_torch(*_operands(xs))
    return impl


for _name, _np_fn, _torch_fn in [
    ("Add", np.add, operator.add), ("Sub", np.subtract, operator.sub),
    ("Mul", np.multiply, operator.mul), ("Pow", np.power, torch.pow),
    ("Equal", np.equal, torch.eq), ("Greater", np.greater, operator.gt),
    ("Less", np.less, torch.lt),
    ("GreaterOrEqual", np.greater_equal, torch.ge),
    ("LessOrEqual", np.less_equal, torch.le),
    ("And", np.logical_and, torch.logical_and),
    ("Or", np.logical_or, torch.logical_or),
    ("Xor", np.logical_xor, torch.logical_xor),
]:
    _REGISTRY[_name] = _ew(_np_fn, _torch_fn)


# the reference runs these on the device whatever their input (``jnp``): a
# host input becomes a tensor on the run's device
for _name, _fn in [
    ("Sigmoid", torch.sigmoid), ("Tanh", torch.tanh), ("Exp", torch.exp),
    ("Log", torch.log), ("Reciprocal", lambda x: 1.0 / x),
    ("Neg", torch.neg), ("Abs", torch.abs), ("Floor", torch.floor),
    ("Ceil", torch.ceil), ("Sign", torch.sign), ("Erf", torch.erf),
    # jax.nn.softplus is logaddexp(x, 0), with no linear tail
    ("Softplus", lambda x: torch.logaddexp(x, torch.zeros_like(x))),
    ("Not", torch.logical_not),
    ("Sin", torch.sin), ("Cos", torch.cos), ("Tan", torch.tan),
    ("Asin", torch.asin), ("Acos", torch.acos), ("Atan", torch.atan),
    ("Sinh", torch.sinh), ("Cosh", torch.cosh),
    ("Asinh", torch.asinh), ("Acosh", torch.acosh), ("Atanh", torch.atanh),
    ("Det", torch.linalg.det),
    ("IsNaN", torch.isnan), ("IsInf", torch.isinf),
    ("Softsign", lambda x: x / (1 + torch.abs(x))),
    ("Round", torch.round),      # half to even, as jnp.round
]:
    _REGISTRY[_name] = (lambda f: lambda ctx, x: f(_tensor(x)))(_fn)

for _name, _np_fn, _torch_fn in [
    ("BitwiseAnd", np.bitwise_and, torch.bitwise_and),
    ("BitwiseOr", np.bitwise_or, torch.bitwise_or),
    ("BitwiseXor", np.bitwise_xor, torch.bitwise_xor),
    ("BitwiseNot", np.invert, torch.bitwise_not),
]:
    _REGISTRY[_name] = _ew(_np_fn, _torch_fn)


# Div on integers truncates toward zero in ONNX; a true divide would
# promote to float. A float divisor stays a device tensor: torch on the
# card multiplies by the reciprocal of a Python-number divisor.
@op("Div")
def _int_safe_div(ctx, a, b):
    if _all_host((a, b)):
        if np.issubdtype(np.asarray(a).dtype, np.integer):
            return np.sign(a) * np.sign(b) * (np.abs(a) // np.abs(b))
        return np.divide(a, b)
    da = _strong_dtype(a)
    a, b = _operands((a, b), scalars=False)
    if da is not None and da != torch.bool and not da.is_floating_point:
        return torch.sign(a) * torch.sign(b) * (torch.abs(a) // torch.abs(b))
    return torch.div(a, b)


@op("Relu")
def _relu(ctx, x):
    return torch.relu(_tensor(x))


@op("Sqrt")
def _sqrt(ctx, x):
    return torch.sqrt(_tensor(x))


@op("Gelu")
def _gelu(ctx, x):
    approximate = "tanh" if ctx.attr("approximate", "none") == "tanh" else "none"
    return F.gelu(_tensor(x), approximate=approximate)


# The activation family. The reference runs each on the device (``jnp``); a
# float attribute is a weak Python scalar there, rounded to the input's
# dtype (``_attr_in``) before it is used.
def _attr_in(ctx, key: str, default: float, x: torch.Tensor):
    return _scalar(np.float64(ctx.attr(key, default)), x.dtype) \
        if x.is_floating_point() else ctx.attr(key, default)


@op("LeakyRelu")
def _leaky_relu(ctx, x):
    x = _tensor(x)
    return torch.where(x >= 0, x, _attr_in(ctx, "alpha", 0.01, x) * x)


@op("PRelu")
def _prelu(ctx, x, slope):
    # slope broadcasts from the channel axis (ONNX's unidirectional form)
    x = _tensor(x)
    nd = np.ndim(slope)
    if 1 <= nd < x.ndim:
        shape = (1, *np.shape(slope)) + (1,) * (x.ndim - nd - 1)
        slope = (np.reshape(slope, shape) if _is_host(slope)
                 else slope.reshape(shape))
    return torch.where(x >= 0, *_operands((x, _bin(operator.mul, slope, x)),
                                          scalars=False))


def _elu_branch(x, a):
    return a * (torch.exp(x) - 1)


@op("Elu")
def _elu(ctx, x):
    x = _tensor(x)
    return torch.where(x >= 0, x, _elu_branch(x, _attr_in(ctx, "alpha", 1.0,
                                                           x)))


@op("Selu")
def _selu(ctx, x):
    x = _tensor(x)
    a = _attr_in(ctx, "alpha", 1.6732632423543772, x)
    g = _attr_in(ctx, "gamma", 1.0507009873554805, x)
    return g * torch.where(x >= 0, x, _elu_branch(x, a))


@op("HardSigmoid")
def _hard_sigmoid(ctx, x):
    x = _tensor(x)
    a, b = _attr_in(ctx, "alpha", 0.2, x), _attr_in(ctx, "beta", 0.5, x)
    return torch.clamp(a * x + b, 0, 1)


@op("HardSwish")
def _hard_swish(ctx, x):
    x = _tensor(x)
    return x * torch.clamp(x / 6.0 + 0.5, 0, 1)


@op("Mish")
def _mish(ctx, x):
    x = _tensor(x)
    return x * torch.tanh(torch.logaddexp(x, torch.zeros_like(x)))


@op("Celu")
def _celu(ctx, x):
    x = _tensor(x)
    a = _attr_in(ctx, "alpha", 1.0, x)
    return (torch.clamp(x, min=0)
            + torch.clamp(a * (torch.exp(x / a) - 1), max=0.0))


@op("Affine")
def _affine(ctx, x):
    # legacy experimental op (pre-opset-10 exporters): alpha * x + beta
    x = _tensor(x)
    return _attr_in(ctx, "alpha", 1.0, x) * x + _attr_in(ctx, "beta", 0.0, x)


@op("ThresholdedRelu")
def _thresholded_relu(ctx, x):
    x = _tensor(x)
    return torch.where(x > _attr_in(ctx, "alpha", 1.0, x), x, 0.0)


@op("Shrink")
def _shrink(ctx, x):
    x = _tensor(x)
    lambd = _attr_in(ctx, "lambd", 0.5, x)
    bias = _attr_in(ctx, "bias", 0.0, x)
    return torch.where(x < -lambd, x + bias,
                       torch.where(x > lambd, x - bias, 0.0))


# torch shifts no unsigned type wider than 8 bits: those shift as int64
# (bit for bit) and are masked back to their width
_SHIFT_BITS = {torch.uint16: 16, torch.uint32: 32, torch.uint64: 64}


@op("BitShift")
def _bit_shift(ctx, x, y):
    left = ctx.attr("direction", "LEFT") == "LEFT"
    if _all_host((x, y)):
        return (np.left_shift if left else np.right_shift)(x, y)
    x, y = _operands((x, y), scalars=False)
    bits = _SHIFT_BITS.get(x.dtype)
    if bits is None:
        return (torch.bitwise_left_shift if left
                else torch.bitwise_right_shift)(x, y)
    xi, yi = x.to(torch.int64), y.to(torch.int64)
    if left:
        r = torch.bitwise_left_shift(xi, yi)
    elif bits < 64:
        r = torch.bitwise_right_shift(xi, yi)
    else:   # a logical shift of the 64 bits: clear the sign first
        r = torch.where(yi == 0, xi, torch.bitwise_right_shift(
            torch.bitwise_right_shift(xi, 1) & (2**63 - 1),
            torch.clamp(yi - 1, min=0)))
    if bits < 64:
        r = r & ((1 << bits) - 1)
    return r.to(x.dtype)


def _per_axis_qparams(x, axis, scale, zp):
    """Reshape 1-D per-channel quantization scale/zero-point for
    broadcast along ``axis`` of ``x`` (shared by Quantize/Dequantize)."""
    if np.ndim(scale) == 1 and np.ndim(x) > 1:
        shape = [1] * np.ndim(x)
        shape[axis % np.ndim(x)] = -1
        scale = _tensor(scale).reshape(shape)
        zp = _tensor(zp).reshape(shape) if np.ndim(zp) == 1 else zp
    return scale, zp


def _as_float32(v):
    """``jnp.asarray(v).astype(float32)``: a strongly typed float32."""
    if isinstance(v, torch.Tensor):
        return v.to(torch.float32)
    return np.asarray(v).astype(np.float32)


@op("QuantizeLinear")
def _quantize_linear(ctx, x, scale, zero_point=None):
    """fp -> int8/uint8 affine quantization: round half to even, add the
    zero point, saturate. axis applies when scale is 1-D per-channel."""
    if zero_point is None:
        dtype = np.dtype(np.uint8)
    elif isinstance(zero_point, torch.Tensor):
        dtype = _NUMPY_OF[zero_point.dtype]
    else:
        dtype = np.asarray(zero_point).dtype
    zp = 0 if zero_point is None else zero_point
    x = _tensor(x)
    scale, zp = _per_axis_qparams(x, ctx.attr("axis", 1), scale, zp)
    q = torch.round(_bin(torch.div, x, scale, scalars=False))
    q = _bin(operator.add, q, _as_float32(zp))
    info = np.iinfo(dtype)
    return torch.clamp(q, info.min, info.max).to(_torch_dtype(dtype))


@op("DequantizeLinear")
def _dequantize_linear(ctx, x, scale, zero_point=None):
    zp = 0 if zero_point is None else zero_point
    x = _tensor(x)
    scale, zp = _per_axis_qparams(x, ctx.attr("axis", 1), scale, zp)
    y = _bin(operator.sub, x.to(torch.float32), _as_float32(zp))
    return _bin(operator.mul, y, scale)


# ---------------------------------------------------------------------------
# Integer contractions and the QOperator family
# ---------------------------------------------------------------------------
#
# Two formulations of every integer contraction, routed by
# onnx/quant_route.py: the widened one (zero points subtracted first, the
# contraction in float64 — exact, as every partial sum of products of at
# most 255**2 is an integer far below 2**53 — then cast to int32) and the
# int8 one (int8 operands into torch._int_mm, zero points as exact int32
# corrections after it). Both give the reference's int32 accumulator bit
# for bit. Integer initializers (int8 weights, int32 biases, zero points)
# are host values: each goes to the device once a node (_const).

def _const(ctx, slot: str, x, dev: torch.device) -> torch.Tensor:
    """``x`` as a tensor on ``dev``: a tensor as it is; a host value (an
    integer initializer) copied to ``dev`` once a node, slot and device
    and kept on the node's context, so a bound forward and a CUDA-graph
    capture copy nothing. The entry holds the host array it was made from
    and is made anew when another one arrives in the slot."""
    if isinstance(x, torch.Tensor):
        return x
    tables = ctx.attrs.setdefault("__tables__", {})
    k = ("const", slot, str(dev))
    hit = tables.get(k)
    if hit is None or hit[0] is not x:
        with _TABLE_LOCK, torch.inference_mode(False):
            hit = tables.get(k)
            if hit is None or hit[0] is not x:
                hit = tables[k] = (x, _tensor(x, dev))
    return hit[1]


def _f32(v, dev: torch.device) -> torch.Tensor:
    """``jnp.asarray(v, float32)`` on ``dev``."""
    return _tensor(v, dev).to(torch.float32)


def _zp_dtype(zp) -> np.dtype:
    if isinstance(zp, torch.Tensor):
        return _NUMPY_OF[zp.dtype]
    return np.asarray(zp).dtype


def _matmul_wide_core(a, b, a_zp=None, b_zp=None):
    """Widened integer matmul: zero points subtracted BEFORE the
    contraction (a 1-D ``a_zp`` per row, a 1-D ``b_zp`` per column), the
    contraction in float64 and cast to int32 — the always-correct
    reference formulation (and the fallback lane of the int8 router).
    Operands are tensors on one device."""
    a64 = a.to(torch.float64)
    b64 = b.to(torch.float64)
    if a_zp is not None:
        zp = _f64_zp(a_zp)
        if getattr(zp, "ndim", 0) == 1:  # per-ROW: broadcast down the rows
            zp = zp[:, None]
        a64 = a64 - zp
    if b_zp is not None:  # 1-D b_zp is per-column: trailing-axis broadcast
        b64 = b64 - _f64_zp(b_zp)
    return torch.matmul(a64, b64).to(torch.int32)


def _to_int8(x: torch.Tensor):
    """(int8 view, offset) with ``x == view + offset`` elementwise: int8
    passes through, uint8 rides an exact -128 shift (its top bit flipped,
    read as int8)."""
    if x.dtype == torch.uint8:
        return torch.bitwise_xor(x, 128).view(torch.int8), 128
    return x, 0


def _zero_shift(zp, off: int):
    """The zero point of an int8 view, ``zp - off`` (``-off`` when there
    is none): a Python int for a host scalar, else an int32 tensor."""
    if zp is None:
        return -off
    if isinstance(zp, torch.Tensor):
        return zp.to(torch.int32) - off
    return int(np.asarray(zp)) - off


def _minus(acc, z, s):
    """``acc - z * s``, one launch where ``z`` is a Python int."""
    if isinstance(z, int):
        return torch.sub(acc, s, alpha=z)
    return acc - z * s


def _f64_zp(zp):
    """A zero point to subtract from a float64 operand: a Python float
    for a host scalar, else a float64 tensor."""
    if isinstance(zp, torch.Tensor):
        return zp.to(torch.float64)
    return float(np.asarray(zp))


def _zp_arg(ctx, slot: str, zp, dev: torch.device):
    """A zero point as the cores take it: absent, a tensor, a host scalar
    (read on the host, never from the card), or a host vector copied to
    ``dev`` once a node (:func:`_const`)."""
    if zp is None or isinstance(zp, torch.Tensor) or np.ndim(zp) == 0:
        return zp
    return _const(ctx, slot, zp, dev)


def _int_mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``torch._int_mm``, with ``a``'s rows zero-padded to a multiple of
    32 on the card where K < 128: there cuBLASLt (CUDA 12.8, H100) refuses
    an s8 GEMM of 32 or more columns whose row count is not a multiple of
    32 (``CUBLAS_STATUS_NOT_SUPPORTED``; ROADMAP Queue 3). The padded rows'
    results are dropped."""
    rows, k = a.shape
    if a.is_cuda and k < 128 and rows % 32 and b.shape[1] >= 32:
        return torch._int_mm(F.pad(a, (0, 0, 0, 32 - rows % 32)), b)[:rows]
    return torch._int_mm(a, b)


def _matmul_int8_core(a, b, a_zp=None, b_zp=None):
    """TRUE int8 matmul lane: ``torch._int_mm`` consumes the int8
    operands (cuBLASLt's s8 x s8 -> s32 GEMM on the card); zero points
    become EXACT integer correction terms after the product:

        (a - za)·(b - zb) = a·b - za*colsum(b) - zb*rowsum(a) + K*za*zb

    (with the uint8 -128 shift folded into za/zb). Bit-identical to
    :func:`_matmul_wide_core` — the router's probe asserts exactly that
    before this lane ever serves. 2-D x 2-D, and on the card only the
    shapes ``_int_mm`` takes (router-gated)."""
    a8, a_off = _to_int8(a)
    b8, b_off = _to_int8(b)
    acc = _int_mm(a8, b8)                                      # [N, M]
    kdim = a8.shape[1]
    za = _zero_shift(a_zp, a_off)
    zb = _zero_shift(b_zp, b_off)
    za_col = za[:, None] if getattr(za, "ndim", 0) == 1 else za
    zb_row = zb[None, :] if getattr(zb, "ndim", 0) == 1 else zb
    need_za = a_zp is not None or a_off
    need_zb = b_zp is not None or b_off
    if need_za:
        acc = _minus(acc, za_col, b8.sum(0, dtype=torch.int32)[None, :])
    if need_zb:
        acc = _minus(acc, zb_row, a8.sum(1, dtype=torch.int32)[:, None])
    if need_za and need_zb:
        acc = acc + kdim * za_col * zb_row
    return acc


@op("MatMulInteger")
def _matmul_integer(ctx, a, b, a_zp=None, b_zp=None):
    """int8 matmul accumulating in int32 (quantized-model compute).
    Routed (onnx/quant_route.py): the true-int8 lane where the measured
    prober verified it exact and faster, the widened formulation
    everywhere else — a lane failure silently falls back."""
    from synapseml_tpu_torch.onnx import quant_route

    dev = _device_of((a, b))
    a = _const(ctx, "a", a, dev)
    b = _const(ctx, "b", b, dev)
    za = _zp_arg(ctx, "a_zp", a_zp, dev)
    zb = _zp_arg(ctx, "b_zp", b_zp, dev)
    if quant_route.route_matmul(a, b, za, zb, do_count=False) == "int8":
        try:
            out = _matmul_int8_core(a, b, za, zb)
            quant_route.count("int8")
            return out
        except Exception:  # noqa: BLE001 - silent fallback is the contract
            quant_route.poison_matmul(a, b, za, zb)
    # served-by honesty: the routed-away case AND an int8-leg failure
    # both count the widened lane
    quant_route.count("dequant")
    return _matmul_wide_core(a, b, za, zb)


@op("DynamicQuantizeLinear")
def _dynamic_quantize_linear(ctx, x):
    """x -> (uint8 y, scale, zero_point), ONNX spec formula: the range is
    extended to include 0 so zero stays exactly representable."""
    x = _tensor(x).to(torch.float32)
    zero = x.new_zeros(())
    mn = torch.minimum(x.min(), zero)
    mx = torch.maximum(x.max(), zero)
    # a tensor divisor: CUDA divides by a Python scalar as a product with
    # its reciprocal, which is not the reference's quotient
    scale = (mx - mn) / x.new_full((), 255.0)
    scale = torch.where(scale <= 0, x.new_ones(()), scale)  # constant input
    zp = torch.clamp(torch.round(-mn / scale), 0, 255)
    y = torch.clamp(torch.round(x / scale) + zp, 0, 255).to(torch.uint8)
    return y, scale, zp.to(torch.uint8)


def _conv_params(ctx, x_shape, w_shape):
    rank = len(x_shape) - 2
    strides = ctx.attr("strides", [1] * rank)
    dilations = ctx.attr("dilations", [1] * rank)
    group = ctx.attr("group", 1)
    kernel = ctx.attr("kernel_shape", list(w_shape[2:]))
    pads = _resolve_pads(ctx, x_shape[2:], kernel, strides, dilations)
    return rank, strides, dilations, group, pads


def _conv_out_shape(sp, kernel, strides, dilations, pads) -> List[int]:
    return [(s + lo + hi - (k - 1) * d - 1) // st + 1 for s, k, st, d, (lo, hi)
            in zip(sp, kernel, strides, dilations, pads)]


def _conv_wide_core(ctx, x, w, x_zp=None, w_zp=None):
    """Widened integer conv: zero points subtracted BEFORE the conv (a
    1-D ``w_zp`` per output channel), the shifted activations padded with
    zero, the conv in float64 (cuDNN has no FFT or Winograd algorithm for
    float64, so each output is its exact integer sum) and cast to int32 —
    the reference formulation (and the fallback lane of the int8
    router)."""
    x64 = x.to(torch.float64)
    w64 = w.to(torch.float64)
    if x_zp is not None:
        x64 = x64 - _f64_zp(x_zp)  # scalar per spec
    if w_zp is not None:
        zp = _f64_zp(w_zp)
        if getattr(zp, "ndim", 0) == 1:  # per-output-channel
            zp = zp.reshape((-1,) + (1,) * (w64.ndim - 1))
        w64 = w64 - zp
    rank, strides, dilations, group, pads = _conv_params(
        ctx, x64.shape, w64.shape)
    padding = _symmetric(pads)
    if padding is None:  # F.conv* pads both sides alike: pad first
        x64, padding = _pad(x64, pads), [0] * rank
    return _CONV[rank](x64, w64, None, strides, padding, dilations,
                       group).to(torch.int32)


def _im2col(x: torch.Tensor, kernel, strides, dilations, pads):
    """``[N, C, *spatial]`` -> (``[N * L, C * prod(kernel)]`` with columns
    in (channel, kernel offsets) order, the output's spatial shape): zero
    padding (negative pads crop), then one ``Tensor.unfold`` window view a
    spatial dim (any dtype, int8 included), strided by the dilation."""
    rank = len(kernel)
    x = _pad(x, pads)
    for i in range(rank):
        x = x.unfold(2 + i, (kernel[i] - 1) * dilations[i] + 1, strides[i])
    if any(d > 1 for d in dilations):
        x = x[(slice(None),) * (2 + rank)
              + tuple(slice(None, None, d) for d in dilations)]
    n, c = x.shape[:2]
    out = list(x.shape[2:2 + rank])
    perm = ([0] + list(range(2, 2 + rank)) + [1]
            + list(range(2 + rank, 2 + 2 * rank)))
    cols = x.permute(perm).reshape(n * math.prod(out),
                                   c * math.prod(kernel))
    return cols, out


def _conv_int8_core(ctx, x, w, x_zp=None, w_zp=None):
    """TRUE int8 conv lane: an int8 im2col (:func:`_im2col`) of the
    zero-padded int8 activations, K padded with zero columns to a multiple
    of 8, one ``torch._int_mm`` a group against the int8 weights; the
    activation zero point becomes ONE exact correction after it:

        conv(x - zx, w) = conv(x, w) - zx * conv(ones_like(x), w)

    where both share the zero padding, so the correction's ones-conv
    (an exact float64 product of the 0/1 im2col of ones with the weights)
    gives each output position's valid-window weight sum — the border
    behaviour of shifting before padding. The uint8 -128 shift folds into
    zx. Weights must be int8 with a zero (or absent) zero point — the
    router gates on exactly that. Bit-identical to :func:`_conv_wide_core`;
    the router's probe asserts it. Returns the accumulator as an
    ``[N, Cout, *out]`` view of the GEMM's ``[N * L, Cout]`` result."""
    x8, x_off = _to_int8(x)
    rank, strides, dilations, group, pads = _conv_params(
        ctx, x8.shape, w.shape)
    kernel = list(w.shape[2:])
    cols, out = _im2col(x8, kernel, strides, dilations, pads)
    n, cout = x8.shape[0], w.shape[0]
    cg, kg = cout // group, w.shape[1] * math.prod(kernel)
    kp = -(-kg // 8) * 8
    wmat = w.reshape(cout, kg)
    shifted = x_zp is not None or x_off
    if shifted:
        zx = _zero_shift(x_zp, x_off)
        ones = torch.ones((1,) + tuple(x8.shape[1:]), dtype=torch.float64,
                          device=x8.device)
        mask, _ = _im2col(ones, kernel, strides, dilations, pads)
    parts = []
    for g in range(group):
        cols_g = cols[:, g * kg:(g + 1) * kg]
        w_g = wmat[g * cg:(g + 1) * cg]
        a, b = cols_g, w_g
        if kp != kg:
            a, b = F.pad(cols_g, (0, kp - kg)), F.pad(w_g, (0, kp - kg))
        acc = _int_mm(a.contiguous(), b.t())                # [N * L, cg]
        if shifted:
            corr = (mask[:, g * kg:(g + 1) * kg]
                    @ w_g.t().to(torch.float64)).to(torch.int32)
            acc = _minus(acc.view(n, -1, cg), zx, corr).view(-1, cg)
        parts.append(acc)
    acc = parts[0] if group == 1 else torch.cat(parts, 1)
    return acc.view(n, *out, cout).permute(0, rank + 1, *range(1, rank + 1))


def _int_conv_core(ctx, x, w, x_zp=None, w_zp=None):
    """Integer conv accumulating in int32 — the shared engine of
    ConvInteger and QLinearConv, routed (onnx/quant_route.py): the
    true-int8 lane where the measured prober verified it exact and
    faster, the widened formulation everywhere else."""
    from synapseml_tpu_torch.onnx import quant_route

    x = _tensor(x)
    dev = x.device
    w = _const(ctx, "w", w, dev)
    xz = _zp_arg(ctx, "x_zp", x_zp, dev)
    attrs = _conv_attr_key(ctx, x, w)
    if quant_route.route_conv(x, w, xz, w_zp, attrs,
                              do_count=False) == "int8":
        try:
            out = _conv_int8_core(ctx, x, w, xz, None)
            quant_route.count("int8")
            return out
        except Exception:  # noqa: BLE001 - silent fallback is the contract
            quant_route.poison_conv(x, w, xz, attrs)
    quant_route.count("dequant")
    return _conv_wide_core(ctx, x, w, xz, _zp_arg(ctx, "w_zp", w_zp, dev))


def _conv_attr_key(ctx, x, w) -> str:
    """The conv attributes that change the computation, as a stable JSON
    key fragment for the router (also how the probe reconstructs an
    equivalent ctx outside a real graph)."""
    import json

    rank = x.ndim - 2
    return json.dumps({
        "strides": list(ctx.attr("strides", [1] * rank)),
        "dilations": list(ctx.attr("dilations", [1] * rank)),
        "group": ctx.attr("group", 1),
        "kernel_shape": list(ctx.attr("kernel_shape",
                                      list(w.shape[2:]))),
        "pads": ctx.attr("pads"),
        "auto_pad": ctx.attr("auto_pad", "NOTSET"),
    }, sort_keys=True)


@op("ConvInteger")
def _conv_integer(ctx, x, w, x_zp=None, w_zp=None):
    """int8/uint8 conv -> raw int32 accumulator (the integer half of a
    dynamically-quantized conv; requantization happens in the graph)."""
    return _int_conv_core(ctx, x, w, x_zp, w_zp)


def _requantize(acc32, combined_scale, y_zp):
    """int32 accumulator -> affine-quantized output: scale in float32,
    round-half-to-even, shift by the output zero point, saturate to the
    zero point's dtype (onnxruntime's requantization semantics)."""
    out_dt = _zp_dtype(y_zp)
    info = np.iinfo(out_dt)
    q = (torch.round(acc32.to(torch.float32) * combined_scale)
         + _f32(y_zp, acc32.device))
    return torch.clamp(q, info.min, info.max).to(_torch_dtype(out_dt))


@op("QLinearConv")
def _qlinear_conv(ctx, x, x_scale, x_zp, w, w_scale, w_zp, y_scale, y_zp,
                  b=None):
    """Statically-quantized conv: int32 accumulation, then
    requantization. Bias is int32 at scale x_scale*w_scale per spec;
    w_scale may be per-output-channel."""
    acc = _int_conv_core(ctx, x, w, x_zp, w_zp)
    dev = acc.device
    rank = acc.ndim - 2
    if b is not None:
        acc = acc + _const(ctx, "b", b, dev).to(torch.int32).reshape(
            (1, -1) + (1,) * rank)
    w_s = _f32(w_scale, dev)
    if w_s.ndim == 1:
        w_s = w_s.reshape((1, -1) + (1,) * rank)
    combined = _f32(x_scale, dev) * w_s / _f32(y_scale, dev)
    return _requantize(acc, combined, y_zp)


@op("QLinearMatMul")
def _qlinear_matmul(ctx, a, a_scale, a_zp, b, b_scale, b_zp, y_scale,
                    y_zp):
    """Statically-quantized matmul: MatMulInteger accumulation + the
    shared requantization. 1-D a_scale is per-row, 1-D b_scale is
    per-column (ONNX spec broadcast)."""
    acc = _matmul_integer(ctx, a, b, a_zp, b_zp)
    dev = acc.device
    a_s = _f32(a_scale, dev)
    if a_s.ndim == 1:
        a_s = a_s[:, None]
    combined = a_s * _f32(b_scale, dev) / _f32(y_scale, dev)
    return _requantize(acc, combined, y_zp)


def _dq(x, scale, zp, dev):
    """Affine dequantize to f32 (per-tensor, the com.microsoft contrib
    ops' convention)."""
    return ((_tensor(x, dev).to(torch.float32) - _f32(zp, dev))
            * _f32(scale, dev))


def _q(val, y_scale, y_zp):
    """Affine quantize f32 -> the zero point's dtype, saturating."""
    info = np.iinfo(_zp_dtype(y_zp))
    q = (torch.round(val / _f32(y_scale, val.device))
         + _f32(y_zp, val.device))
    return torch.clamp(q, info.min, info.max).to(
        _torch_dtype(_zp_dtype(y_zp)))


# com.microsoft QOperator contrib family — what onnxruntime's static
# quantizer (quant_format=QOperator) emits between the QLinearConv/
# QLinearMatMul nodes. Dispatch is by op_type (domains carry no semantics
# here); compute is dequant -> f32 op -> requant, each step its own
# rounded op, as in the reference.
def _qlinear_binary(fn):
    def impl(ctx, a, a_scale, a_zp, b, b_scale, b_zp, c_scale, c_zp):
        dev = _device_of((a, b))
        return _q(fn(_dq(a, a_scale, a_zp, dev), _dq(b, b_scale, b_zp, dev)),
                  c_scale, c_zp)
    return impl


_REGISTRY["QLinearAdd"] = _qlinear_binary(torch.add)
_REGISTRY["QLinearMul"] = _qlinear_binary(torch.mul)


@op("QLinearSigmoid")
def _qlinear_sigmoid(ctx, x, x_scale, x_zp, y_scale, y_zp):
    dev = _device_of((x,))
    return _q(torch.sigmoid(_dq(x, x_scale, x_zp, dev)), y_scale, y_zp)


@op("QLinearLeakyRelu")
def _qlinear_leaky_relu(ctx, x, x_scale, x_zp, y_scale, y_zp):
    dev = _device_of((x,))
    v = _dq(x, x_scale, x_zp, dev)
    alpha = _scalar(np.float64(ctx.attr("alpha", 0.01)), torch.float32)
    return _q(torch.where(v >= 0, v, alpha * v), y_scale, y_zp)


@op("QLinearGlobalAveragePool")
def _qlinear_global_avg_pool(ctx, x, x_scale, x_zp, y_scale, y_zp):
    x = _tensor(x)
    axes = (tuple(range(1, x.ndim - 1)) if ctx.attr("channels_last", 0)
            else tuple(range(2, x.ndim)))
    # the mean over the integer values first (a float32 sum, then one
    # division by the count as a tensor — CUDA turns a division by a Python
    # scalar into a product with its reciprocal — as jnp.mean), then one
    # affine rescale
    count = float(math.prod(x.shape[a] for a in axes))
    m = (x.to(torch.float32).sum(axes, keepdim=True)
         / torch.full((), count, device=x.device))
    dev = x.device
    return _q((m - _f32(x_zp, dev)) * _f32(x_scale, dev), y_scale, y_zp)


@op("QLinearConcat")
def _qlinear_concat(ctx, y_scale, y_zp, *parts):
    axis = ctx.attr("axis")
    if axis is None:
        raise ValueError("QLinearConcat needs an axis attribute")
    if len(parts) % 3:
        raise ValueError("QLinearConcat inputs must be (X, scale, zp) "
                         "triplets after (Y_scale, Y_zp)")
    dev = _device_of(parts[0::3])
    deq = [_dq(parts[i], parts[i + 1], parts[i + 2], dev)
           for i in range(0, len(parts), 3)]
    return _q(torch.cat(deq, dim=int(axis)), y_scale, y_zp)


@op("QGemm")
def _qgemm(ctx, a, a_scale, a_zp, b, b_scale, b_zp, c=None, y_scale=None,
           y_zp=None):
    """com.microsoft QGemm: integer gemm (the widened formulation; the
    reference does not route it) with optional int32 bias; float output
    when y_scale is absent, requantized otherwise."""
    alpha = _scalar(np.float64(ctx.attr("alpha", 1.0)), torch.float32)
    dev = _device_of((a, b))
    a64 = _const(ctx, "a", a, dev).to(torch.float64)
    b64 = _const(ctx, "b", b, dev).to(torch.float64)
    if ctx.attr("transA", 0):
        a64 = a64.T
    if ctx.attr("transB", 0):
        b64 = b64.T
    a64 = a64 - _const(ctx, "a_zp", a_zp, dev).to(torch.float64)
    bz = _const(ctx, "b_zp", b_zp, dev).to(torch.float64)
    b64 = b64 - (bz if bz.ndim == 0 else bz[None, :])
    acc = (a64 @ b64).to(torch.int32)
    if c is not None:
        acc = acc + _const(ctx, "c", c, dev).to(torch.int32)
    combined = alpha * _f32(a_scale, dev) * _f32(b_scale, dev)
    if y_scale is None:
        return acc.to(torch.float32) * combined
    return _requantize(acc, combined / _f32(y_scale, dev), y_zp)


@op("Where")
def _where(ctx, cond, a, b):
    if _all_host((cond, a, b)):
        return np.where(cond, a, b)
    a, b = _operands((a, b), scalars=False)
    return torch.where(_tensor(cond, a.device).to(torch.bool), a, b)


@op("Clip")
def _clip(ctx, x, lo=None, hi=None):
    if ctx.opset < 11:
        lo = ctx.attr("min", -np.inf)
        hi = ctx.attr("max", np.inf)
    # a missing bound is a weak float infinity, as in the reference: an
    # integer input clipped without both bounds becomes float
    lo = -math.inf if lo is None else lo
    hi = math.inf if hi is None else hi
    x, lo, hi = _operands((x, lo, hi), scalars=False)
    return torch.clamp(x, lo, hi)


def _fold(np_fn, torch_fn, xs):
    """``fn`` folded left over ``xs``: numpy where all are host values (shape
    chains clamp through Min/Max), else tensors in the joint dtype."""
    if _all_host(xs):
        out = xs[0]
        for x in xs[1:]:
            out = np_fn(out, x)
        return out
    xs = _operands(xs, scalars=False)
    out = xs[0]
    for x in xs[1:]:
        out = torch_fn(out, x)
    return out


@op("Min")
def _min(ctx, *xs):
    return _fold(np.minimum, torch.minimum, xs)


@op("Max")
def _max(ctx, *xs):
    return _fold(np.maximum, torch.maximum, xs)


@op("Sum")
def _sum(ctx, *xs):
    return _fold(np.add, torch.add, xs)


@op("Mean")
def _mean(ctx, *xs):
    s = _sum(ctx, *xs)
    if _is_host(s):
        return s / float(len(xs))
    return _bin(torch.div, s, float(len(xs)), scalars=False)


@op("Trilu")
def _trilu(ctx, x, k=None):
    """Upper/lower triangle (causal-mask construction in transformer
    graphs)."""
    kk = _static_int_list(k, "Trilu k")[0] if k is not None else 0
    if _is_host(x):
        return (np.triu if ctx.attr("upper", 1) else np.tril)(x, kk)
    return (torch.triu if ctx.attr("upper", 1) else torch.tril)(x, kk)


@op("Mod")
def _mod(ctx, a, b):
    # host-preserving: exporters route SHAPE arithmetic through Mod
    # (torch MultiheadAttention's head-split checks); a device result
    # here would poison downstream Reshape/Slice static params
    fmod = ctx.attr("fmod", 0)
    if _all_host((a, b)):
        return np.fmod(a, b) if fmod else np.mod(a, b)
    a, b = _operands((a, b), scalars=False)
    return torch.fmod(a, b) if fmod else torch.remainder(a, b)


# ---------------------------------------------------------------------------
# Linear algebra
# ---------------------------------------------------------------------------

@op("MatMul")
def _matmul(ctx, a, b):
    return torch.matmul(*_operands((a, b), scalars=False))


@op("Gemm")
def _gemm(ctx, a, b, c=None):
    alpha, beta = ctx.attr("alpha", 1.0), ctx.attr("beta", 1.0)
    a, b = _operands((a, b), scalars=False)
    if ctx.attr("transA", 0):
        a = a.T
    if ctx.attr("transB", 0):
        b = b.T
    # matmul, then alpha, then + c, each rounded to the result dtype, as
    # the reference's three ops are (one addmm would round once); the
    # scalars are rounded to that dtype first, as its dtype-pinned ones
    y = torch.matmul(a, b)
    dt = y.dtype
    if alpha != 1.0:
        y = y * _scalar(alpha, dt)
    if c is not None:
        cc = _tensor(c, y.device).to(dt)
        y = y + (cc * _scalar(beta, dt) if beta != 1.0 else cc)
    return y


@op("Einsum")
def _einsum(ctx, *xs):
    return torch.einsum(ctx.attr("equation"), *_operands(xs, scalars=False))


# ---------------------------------------------------------------------------
# Convolution & pooling
# ---------------------------------------------------------------------------

def _resolve_pads(ctx, x_sp: Sequence[int], kernel: Sequence[int],
                  strides: Sequence[int], dilations: Sequence[int],
                  ceil_mode: int = 0) -> List[Tuple[int, int]]:
    rank = len(kernel)
    auto = ctx.attr("auto_pad", "NOTSET")
    if auto in ("SAME_UPPER", "SAME_LOWER"):
        out: List[Tuple[int, int]] = []
        for i in range(rank):
            o = math.ceil(x_sp[i] / strides[i])
            eff_k = (kernel[i] - 1) * dilations[i] + 1
            total = max(0, (o - 1) * strides[i] + eff_k - x_sp[i])
            if auto == "SAME_UPPER":
                out.append((total // 2, total - total // 2))
            else:
                out.append((total - total // 2, total // 2))
        return out
    pads = ctx.attr("pads", [0] * (2 * rank))
    out = [(int(pads[i]), int(pads[i + rank])) for i in range(rank)]
    if ceil_mode:
        # grow the high-side pad so the final (ceil'd) window fits
        for i in range(rank):
            eff_k = (kernel[i] - 1) * dilations[i] + 1
            padded = x_sp[i] + out[i][0] + out[i][1]
            o = math.ceil((padded - eff_k) / strides[i]) + 1
            need = (o - 1) * strides[i] + eff_k
            if need > padded:
                out[i] = (out[i][0], out[i][1] + need - padded)
    return out


def _pad(x: torch.Tensor, pads: Sequence[Tuple[int, int]], value=0):
    """Pad the last ``len(pads)`` dims (the spatial ones, where ``pads``
    has one pair a spatial dim) by ``pads``, (low, high) each; a negative
    amount crops."""
    flat = [p for lo_hi in reversed(pads) for p in lo_hi]
    return F.pad(x, flat, value=value) if any(flat) else x


def _symmetric(pads, limit=None) -> Optional[List[int]]:
    """The per-dim pad if every dim pads both sides alike (and at most
    ``limit[i]``), else None."""
    if any(lo != hi for lo, hi in pads):
        return None
    if limit is not None and any(lo > m for (lo, _), m in zip(pads, limit)):
        return None
    return [lo for lo, _ in pads]


_CONV = {1: F.conv1d, 2: F.conv2d, 3: F.conv3d}
_MAX_POOL = {1: F.max_pool1d, 2: F.max_pool2d, 3: F.max_pool3d}
_AVG_POOL = {2: F.avg_pool2d, 3: F.avg_pool3d}   # take divisor_override


@op("Conv")
def _conv(ctx, x, w, b=None):
    x, w = _operands((x, w), scalars=False)
    rank = x.ndim - 2
    strides = ctx.attr("strides", [1] * rank)
    dilations = ctx.attr("dilations", [1] * rank)
    group = ctx.attr("group", 1)
    kernel = ctx.attr("kernel_shape", list(w.shape[2:]))
    pads = _resolve_pads(ctx, x.shape[2:], kernel, strides, dilations)
    padding = _symmetric(pads)
    if padding is None:  # F.conv* pads both sides alike: pad first
        x, padding = _pad(x, pads), [0] * rank
    y = _CONV[rank](x, w, None, strides, padding, dilations, group)
    if b is not None:  # its own add, rounded after the convolution's
        b = b.reshape((1, -1) + (1,) * rank)
        y = _bin(operator.add, y, b)
    return y


_CONV_T = {1: F.conv_transpose1d, 2: F.conv_transpose2d,
           3: F.conv_transpose3d}


@op("ConvTranspose")
def _conv_transpose(ctx, x, w, b=None):
    """The reference's transposed convolution: ``x`` dilated by the
    strides, padded by ``eff - 1 - pad`` (``+ output_padding`` high; a
    negative amount crops) and convolved with the flipped kernel. Its
    output is a window of the full transposed convolution (no padding),
    which ``F.conv_transpose*d`` computes; the window is cut out, or
    padded with zeros, per axis (``F.conv_transpose*d``'s own padding is
    symmetric and caps ``output_padding``). Asymmetric ``pads``,
    ``auto_pad`` SAME_* and grouped ``(I, O/g, k)`` weights as the
    reference takes them; the ``output_shape`` attribute is not read, as
    in the reference."""
    x, w = _operands((x, w), scalars=False)
    rank = x.ndim - 2
    strides = ctx.attr("strides", [1] * rank)
    dilations = ctx.attr("dilations", [1] * rank)
    group = ctx.attr("group", 1)
    kernel = ctx.attr("kernel_shape", list(w.shape[2:]))
    out_pad = ctx.attr("output_padding", [0] * rank)
    pads = ctx.attr("pads", None)
    auto = ctx.attr("auto_pad", "NOTSET")
    eff = [(k - 1) * d + 1 for k, d in zip(kernel, dilations)]
    eff_w = [(k - 1) * d + 1 for k, d in zip(w.shape[2:], dilations)]
    if pads is not None:
        pairs = [(int(pads[i]), int(pads[i + rank])) for i in range(rank)]
    elif auto in ("SAME_UPPER", "SAME_LOWER"):
        pairs = []
        for e, s in zip(eff, strides):
            total = max(0, e - s)
            lo = total // 2 if auto == "SAME_UPPER" else total - total // 2
            pairs.append((lo, total - lo))
    else:
        pairs = [(0, 0)] * rank
    y = _CONV_T[rank](x, w, None, strides, 0, 0, group, dilations)
    window = []
    for i in range(rank):
        # the reference's output j is the full output's j + start; pads
        # that crop past the full output leave an empty axis, as there
        start = pairs[i][0] + eff_w[i] - eff[i]
        length = max(0, (x.shape[2 + i] - 1) * strides[i] + 2 * eff[i]
                     - pairs[i][0] - pairs[i][1] + out_pad[i] - eff_w[i])
        size = y.shape[2 + i]
        lo = min(max(start, 0), size)
        hi = max(min(start + length, size), lo)
        y = y.narrow(2 + i, lo, hi - lo)
        before = min(max(-start, 0), length)
        window.append((before, length - (hi - lo) - before))
    y = _pad(y, window)
    if b is not None:
        y = _bin(operator.add, y, b.reshape((1, -1) + (1,) * rank))
    return y


def _window_reduce(x: torch.Tensor, kernel, strides, dilations, reduce):
    """``reduce`` over every window of the (already padded) spatial dims:
    each dim unfolded into (out, effective kernel), the kernel strided by
    its dilation. For what the library's pools do not take (integers)."""
    rank = len(kernel)
    for d in range(rank):
        eff_k = (kernel[d] - 1) * dilations[d] + 1
        x = x.unfold(2 + d, eff_k, strides[d])[..., ::dilations[d]]
    return reduce(x.reshape(x.shape[:2 + rank] + (-1,)), -1)


@op("MaxPool")
def _max_pool(ctx, x):
    x = _tensor(x)
    rank = x.ndim - 2
    kernel = ctx.attr("kernel_shape")
    strides = ctx.attr("strides", [1] * rank)
    dilations = ctx.attr("dilations", [1] * rank)
    pads = _resolve_pads(ctx, x.shape[2:], kernel, strides, dilations,
                         ctx.attr("ceil_mode", 0))
    floating = x.is_floating_point()
    fill = -math.inf if floating else int(torch.iinfo(x.dtype).min)
    if ctx.n_outputs > 1:
        if int(ctx.attr("storage_order", 0)):
            raise NotImplementedError(
                "MaxPool storage_order=1 (column-major Indices) is not "
                "supported; re-export with row-major indices")
        return _max_pool_with_indices(x, kernel, strides, dilations, pads,
                                      fill)
    if floating and rank in _MAX_POOL:
        padding = _symmetric(pads, [k // 2 for k in kernel])
        if padding is None:
            x, padding = _pad(x, pads, -math.inf), [0] * rank
        return _MAX_POOL[rank](x, kernel, strides, padding, dilations)
    x = _pad(x, pads, fill)
    return _window_reduce(x, kernel, strides, dilations, torch.amax)


# the reference's index for a window that lies wholly in padding: the
# largest value of its index dtype, int32 under JAX's default 32-bit mode,
# past the end of any unpooled tensor (MaxUnpool drops it)
_NO_INDEX = 2 ** 31 - 1


def _max_pool_with_indices(x, kernel, strides, dilations, pads, fill):
    """MaxPool and its Indices output, as the reference computes them:
    each window's cells in row-major order, the first largest one wins (a
    NaN is the largest), and its index is flat over the whole ``[N, C,
    spatial]`` input. A window whose winner is a padded cell gets
    ``_NO_INDEX``."""
    rank = len(kernel)
    sp = x.shape[2:]
    n, c = x.shape[:2]
    dev = x.device
    padded = _pad(x, pads, fill)
    out_sp = [(sp[d] + pads[d][0] + pads[d][1]
               - (kernel[d] - 1) * dilations[d] - 1) // strides[d] + 1
              for d in range(rank)]
    win = padded
    for d in range(rank):
        eff_k = (kernel[d] - 1) * dilations[d] + 1
        win = win.unfold(2 + d, eff_k, strides[d])[..., ::dilations[d]]
    vals, rem = win.reshape(win.shape[:2 + rank] + (-1,)).max(-1)
    in_bounds = torch.ones_like(rem, dtype=torch.bool)
    coords = [None] * rank
    for d in reversed(range(rank)):    # unravel the window's argmax
        kd, rem = rem % kernel[d], rem // kernel[d]
        shape = [1] * (2 + rank)
        shape[2 + d] = out_sp[d]
        o = torch.arange(out_sp[d], device=dev).reshape(shape)
        raw = o * strides[d] + kd * dilations[d] - pads[d][0]
        in_bounds &= (raw >= 0) & (raw < sp[d])
        coords[d] = raw.clamp(0, sp[d] - 1)
    flat = coords[0]
    for d in range(1, rank):
        flat = flat * sp[d] + coords[d]
    plane = torch.arange(n * c, device=dev).reshape((n, c) + (1,) * rank)
    index = plane * math.prod(sp) + flat
    return vals, torch.where(in_bounds, index, _NO_INDEX)


@op("MaxUnpool")
def _max_unpool(ctx, x, idx, output_shape=None):
    """The pooled values written to their flat indices in a zero tensor
    (``.at[idx].set`` in the reference): a negative index counts from the
    end, one still out of range (``_NO_INDEX`` included) is dropped
    through :func:`_scatter_rows`'s spare row. Two values at one index
    land in no fixed order, in either package."""
    kernel = ctx.attr("kernel_shape")
    rank = len(kernel)
    strides = ctx.attr("strides", [1] * rank)
    pads = [int(p) for p in ctx.attr("pads", [0] * (2 * rank))]
    x = _tensor(x)
    if output_shape is not None:
        out_shape = tuple(_static_int_list(output_shape,
                                           "MaxUnpool output_shape"))
    else:
        sp = x.shape[2:]
        out_shape = tuple(x.shape[:2]) + tuple(
            (sp[d] - 1) * strides[d] + kernel[d] - pads[d] - pads[rank + d]
            for d in range(rank))
    total = math.prod(out_shape)
    i = _tensor(idx, x.device).to(torch.int64).reshape(-1)
    i = torch.where(i < 0, i + total, i)
    rows = torch.where((i >= 0) & (i < total), i, total)
    out = _scatter_rows(x.new_zeros((total, 1)), rows, x.reshape(-1, 1),
                        "none")
    return out.reshape(out_shape)


def _window_sum(x: torch.Tensor, kernel, strides,
                dilations=None) -> torch.Tensor:
    """Window sums of the (already padded) spatial dims."""
    rank = len(kernel)
    dilations = dilations or [1] * rank
    if rank in _AVG_POOL and all(d == 1 for d in dilations):
        return _AVG_POOL[rank](x, kernel, strides, divisor_override=1)
    return _window_reduce(x, kernel, strides, dilations, torch.sum)


@op("AveragePool")
def _avg_pool(ctx, x):
    x = _tensor(x)
    rank = x.ndim - 2
    kernel = ctx.attr("kernel_shape")
    strides = ctx.attr("strides", [1] * rank)
    pads = _resolve_pads(ctx, x.shape[2:], kernel, strides, [1] * rank,
                         ctx.attr("ceil_mode", 0))
    # zero-padded window sums divided by a device divisor: the padded
    # cells (the ceil_mode growth included) count only where
    # count_include_pad says so, as in the reference
    s = _window_sum(_pad(x, pads), kernel, strides)
    if ctx.attr("count_include_pad", 0):
        return s / torch.full((), float(np.prod(kernel)), dtype=s.dtype,
                              device=s.device)
    ones = torch.ones((1, 1) + tuple(x.shape[2:]), dtype=x.dtype,
                      device=x.device)
    return s / _window_sum(_pad(ones, pads), kernel, strides)


@op("GlobalAveragePool")
def _gap(ctx, x):
    x = _tensor(x)
    return x.mean(dim=tuple(range(2, x.ndim)), keepdim=True)


@op("GlobalMaxPool")
def _gmp(ctx, x):
    x = _tensor(x)
    return x.amax(dim=tuple(range(2, x.ndim)), keepdim=True)


@op("LpPool")
def _lp_pool(ctx, x):
    """Window sums of ``|x| ** p`` (zero-padded; dilations as opset 18
    has them), to the power ``1 / p``: ``F.lp_pool*d`` takes no
    absolute value, padding or dilation."""
    x = _tensor(x)
    rank = x.ndim - 2
    p = ctx.attr("p", 2)
    kernel = ctx.attr("kernel_shape")
    strides = ctx.attr("strides", [1] * rank)
    dilations = ctx.attr("dilations", [1] * rank)
    pads = _resolve_pads(ctx, x.shape[2:], kernel, strides, dilations,
                         ctx.attr("ceil_mode", 0))
    s = _window_sum(_pad(x.abs() ** p, pads), kernel, strides, dilations)
    return s ** (1.0 / p)


@op("GlobalLpPool")
def _global_lp_pool(ctx, x):
    x = _tensor(x)
    p = ctx.attr("p", 2)
    axes = tuple(range(2, x.ndim))
    return (x.abs() ** p).sum(dim=axes, keepdim=True) ** (1.0 / p)


@op("LRN")
def _lrn(ctx, x):
    """Sums of squares over a window of ``size`` channels, ``(size - 1)
    // 2`` before a channel and the rest after, as the spec and the
    reference place it (``F.local_response_norm`` puts the larger half
    before)."""
    x = _tensor(x)
    size = ctx.attr("size")
    dt = x.dtype
    lo = (size - 1) // 2
    sq = F.pad((x * x).movedim(1, -1), (lo, size - 1 - lo))
    window = sq.unfold(-1, size, 1).sum(-1).movedim(-1, 1)
    base = (window * _scalar(ctx.attr("alpha", 1e-4) / size, dt)
            + _scalar(ctx.attr("bias", 1.0), dt))
    return x / torch.pow(base, _scalar(ctx.attr("beta", 0.75), dt))


# ---------------------------------------------------------------------------
# Normalization
# ---------------------------------------------------------------------------

def _bn_fold(scale, b, mean, var, eps: float):
    """BatchNormalization's statistics as one float32 scale and bias:
    ``rsqrt(var + eps) * scale`` and ``b - mean * inv * scale``."""
    f32 = torch.float32
    inv = torch.rsqrt(var.to(f32) + eps)
    w = inv * scale.to(f32)
    bias = b.to(f32) - mean.to(f32) * inv * scale.to(f32)
    return w, bias


def _bn_affine(x: torch.Tensor, w: torch.Tensor, bias: torch.Tensor):
    """``x * w + bias`` over the channel axis, w and bias cast to x's
    dtype: two roundings in a bf16 graph, as the reference's two ops."""
    shape = (1, -1) + (1,) * (x.ndim - 2)
    return (x * w.to(x.dtype).reshape(shape)
            + bias.to(x.dtype).reshape(shape))


@op("BatchNormalization")
def _batch_norm(ctx, x, scale, b, mean, var):
    x = _tensor(x)
    stats = [_tensor(v, x.device) for v in (scale, b, mean, var)]
    return _bn_affine(x, *_bn_fold(*stats, ctx.attr("epsilon", 1e-5)))


def _batch_norm_bound(ctx, x, w, bias, w32, bias32):
    """A BatchNormalization folded at ``bind``: ``w``/``bias`` cast to the
    dtype the bind expects; the float32 fold for any other."""
    x = _tensor(x)
    if x.dtype != w.dtype:
        w, bias = w32, bias32
    return _bn_affine(x, w, bias)


@op("LayerNormalization")
def _layer_norm(ctx, x, scale, b=None):
    x = _tensor(x)
    axis = ctx.attr("axis", -1)
    eps = ctx.attr("epsilon", 1e-5)
    axes = tuple(range(axis % x.ndim, x.ndim))
    mean = x.mean(dim=axes, keepdim=True)
    var = x.var(dim=axes, correction=0, keepdim=True)
    inv = torch.rsqrt(var + _scalar(eps, var.dtype))
    y = _bin(operator.mul, (x - mean) * inv, scale)
    if b is not None:
        y = _bin(operator.add, y, b)
    if ctx.n_outputs > 1:
        return (y, mean, inv)[: ctx.n_outputs]
    return y


def _standardize(x: torch.Tensor, dims, eps: float) -> torch.Tensor:
    """``(x - mean) * rsqrt(var + eps)`` over ``dims``, with the
    population variance."""
    var, mean = torch.var_mean(x, dim=dims, correction=0, keepdim=True)
    return (x - mean) * torch.rsqrt(var + _scalar(eps, var.dtype))


def _per_channel(v, ndim: int):
    """A ``[C]`` scale or bias shaped to broadcast over ``[N, C, ...]``."""
    return v.reshape((1, -1) + (1,) * (ndim - 2))


@op("InstanceNormalization")
def _instance_norm(ctx, x, scale, b):
    x = _tensor(x)
    y = _standardize(x, tuple(range(2, x.ndim)), ctx.attr("epsilon", 1e-5))
    y = _bin(operator.mul, y, _per_channel(scale, x.ndim))
    return _bin(operator.add, y, _per_channel(b, x.ndim))


@op("GroupNormalization")
def _group_norm(ctx, x, scale, b):
    """Statistics over each group of ``C / num_groups`` channels; opset
    18's per-group scale and bias (length ``num_groups``) repeated over
    their channels, opset 21's per-channel ones as they are, told apart
    by length as in the reference (so with ``num_groups == C`` either
    reads per channel)."""
    x = _tensor(x)
    groups = int(ctx.attr("num_groups"))
    n, c = x.shape[:2]
    xg = x.reshape((n, groups, c // groups) + tuple(x.shape[2:]))
    y = _standardize(xg, tuple(range(2, xg.ndim)),
                     ctx.attr("epsilon", 1e-5)).reshape(x.shape)
    if scale.shape[0] == groups and groups != c:
        r = c // groups
        scale, b = [np.repeat(v, r) if _is_host(v)
                    else v.reshape(-1, 1).expand(-1, r).reshape(-1)
                    for v in (scale, b)]
    y = _bin(operator.mul, y, _per_channel(scale, x.ndim))
    return _bin(operator.add, y, _per_channel(b, x.ndim))


@op("MeanVarianceNormalization")
def _mvn(ctx, x):
    """Statistics over ``axes`` (``[0, 2, 3]`` by default: across the
    batch, so the rows of a padded bucket change each other's output, in
    either package) with a fixed eps of 1e-9, as in the reference."""
    x = _tensor(x)
    axes = tuple(int(a) for a in ctx.attr("axes", [0, 2, 3]))
    return _standardize(x, axes, 1e-9)


@op("LpNormalization")
def _lp_normalization(ctx, x):
    """``x`` over its L1 norm along ``axis`` where ``p == 1``, else over
    its L2 norm (the reference reads any other ``p`` as 2), the norm
    clamped below at 1e-12."""
    x = _tensor(x)
    axis = ctx.attr("axis", -1)
    if ctx.attr("p", 2) == 1:
        norm = x.abs().sum(dim=axis, keepdim=True)
    else:
        norm = torch.sqrt((x * x).sum(dim=axis, keepdim=True))
    if not norm.is_floating_point():
        norm = norm.to(torch.get_default_dtype())
    return x / torch.clamp(norm, min=1e-12)


# ---------------------------------------------------------------------------
# Shape / structure ops (host-foldable where possible)
# ---------------------------------------------------------------------------

@op("Shape")
def _shape(ctx, x):
    start = ctx.attr("start", 0)
    end = ctx.attr("end", None)
    shp = list(np.shape(x))
    shp = shp[start:end] if end is not None else shp[start:]
    return np.asarray(shp, dtype=np.int64)


@op("Size")
def _size(ctx, x):
    return np.asarray(int(np.prod(np.shape(x))), dtype=np.int64)


def _host_dtype(x) -> np.dtype:
    """The numpy dtype of a host value or of a tensor's dtype; bfloat16
    needs ``ml_dtypes`` (as :mod:`proto` reads it), else it raises."""
    if _is_host(x):
        return np.asarray(x).dtype
    if x.dtype in _NUMPY_OF:
        return _NUMPY_OF[x.dtype]
    dt = proto.TENSOR_DTYPES.get(proto.DTYPE_BFLOAT16)
    if x.dtype == torch.bfloat16 and dt is not None:
        return np.dtype(dt)
    raise ValueError(f"no numpy dtype for {x.dtype} (ml_dtypes is not "
                     "installed)")


@op("EyeLike")
def _eye_like(ctx, x):
    dt = proto.TENSOR_DTYPES.get(ctx.attr("dtype")) or _host_dtype(x)
    n, m = np.shape(x)
    return np.eye(n, m, k=ctx.attr("k", 0), dtype=dt)  # a host constant


@op("ReverseSequence")
def _reverse_sequence(ctx, x, seq_lens):
    """Positions before a row's length reverse, the rest stay; a length
    past the time axis reads past it, where the reference's gather fills
    (:func:`_take_along`)."""
    batch_axis = ctx.attr("batch_axis", 1)
    time_axis = ctx.attr("time_axis", 0)
    x = _tensor(x)
    idx = torch.arange(x.shape[time_axis], device=x.device)
    lens = _tensor(seq_lens, x.device).to(torch.int32)[:, None]
    gather_idx = torch.where(idx < lens, lens - 1 - idx, idx)   # [B, T]
    moved = x.movedim((batch_axis, time_axis), (0, 1))
    out = _take_along(moved, gather_idx.reshape(
        gather_idx.shape + (1,) * (moved.ndim - 2)), 1)
    return out.movedim((0, 1), (batch_axis, time_axis))


@op("NonZero")
def _non_zero(ctx, x):
    if not _is_host(x):
        raise NotImplementedError(
            "NonZero on traced tensors has a data-dependent output shape, "
            "which XLA cannot express; restructure with Where/masking")
    return np.stack(np.nonzero(np.asarray(x))).astype(np.int64)


@op("Reshape")
def _reshape(ctx, x, shape=None):
    target = _static_int_list(shape if shape is not None else ctx.attr("shape"),
                              "Reshape shape")
    allowzero = ctx.attr("allowzero", 0)
    cur = list(np.shape(x))
    out = []
    for i, d in enumerate(target):
        if d == 0 and not allowzero:
            out.append(cur[i])
        else:
            out.append(d)
    if _is_host(x):
        return np.reshape(x, out)
    return x.reshape(out)


@op("Flatten")
def _flatten(ctx, x):
    x = _tensor(x)
    axis = ctx.attr("axis", 1) % (x.ndim + 1)
    lead = int(np.prod(x.shape[:axis])) if axis else 1
    return x.reshape(lead, -1)


@op("Transpose")
def _transpose(ctx, x):
    perm = ctx.attr("perm", list(range(np.ndim(x)))[::-1])
    if _is_host(x):
        return np.transpose(x, perm)
    return x.permute(perm)


@op("Squeeze")
def _squeeze(ctx, x, axes=None):
    if ctx.opset < 13:
        axes = ctx.attr("axes", None)
    ax = _static_int_list(axes, "Squeeze axes") if axes is not None else None
    if not ax:
        return np.squeeze(x) if _is_host(x) else x.squeeze()
    ax = tuple(a % np.ndim(x) for a in ax)
    return np.squeeze(x, axis=ax) if _is_host(x) else x.squeeze(ax)


@op("Unsqueeze")
def _unsqueeze(ctx, x, axes=None):
    if ctx.opset < 13:
        axes = ctx.attr("axes")
    ax = _static_int_list(axes, "Unsqueeze axes")
    out_rank = np.ndim(x) + len(ax)
    ax = sorted(a % out_rank for a in ax)
    host = _is_host(x)
    for a in ax:
        x = np.expand_dims(x, a) if host else x.unsqueeze(a)
    return x


@op("Concat")
def _concat(ctx, *xs):
    axis = ctx.attr("axis")
    if _all_host(xs):
        return np.concatenate([np.asarray(x) for x in xs], axis=axis)
    return torch.cat(_operands(xs, scalars=False), dim=axis)


@op("Split")
def _split(ctx, x, split=None):
    axis = ctx.attr("axis", 0)
    if ctx.opset < 13:
        split = ctx.attr("split", None)
    n_out = ctx.n_outputs
    dim = np.shape(x)[axis]
    if split is None:
        sizes = [dim // n_out + (1 if i < dim % n_out else 0) for i in range(n_out)]
    else:
        sizes = _static_int_list(split, "Split sizes")
    offs = np.cumsum([0] + sizes)
    if _is_host(x):
        return tuple(np.take(x, range(offs[i], offs[i + 1]), axis=axis)
                     for i in range(len(sizes)))
    return tuple(x.narrow(axis, int(offs[i]), int(sizes[i]))
                 for i in range(len(sizes)))


@op("Slice")
def _slice(ctx, x, starts=None, ends=None, axes=None, steps=None):
    if ctx.opset < 10:
        starts, ends = ctx.attr("starts"), ctx.attr("ends")
        axes = ctx.attr("axes", None)
    starts = _static_int_list(starts, "Slice starts")
    ends = _static_int_list(ends, "Slice ends")
    axes = (_static_int_list(axes, "Slice axes") if axes is not None
            else list(range(len(starts))))
    steps = _static_int_list(steps, "Slice steps") if steps is not None else [1] * len(starts)
    slices = [slice(None)] * np.ndim(x)
    for st, en, ax, sp in zip(starts, ends, axes, steps):
        d = np.shape(x)[ax]
        INT_MAX = 2**62
        st = max(st + d, 0) if st < 0 else min(st, d)
        if en < -INT_MAX:
            en = None if sp < 0 else 0
        elif en < 0:
            en = max(en + d, -1)
            en = None if (sp < 0 and en < 0) else en
        else:
            en = min(en, d)
        slices[ax % np.ndim(x)] = slice(st, en, sp)
    if _is_host(x):
        return x[tuple(slices)]
    # torch takes no negative step: take the same elements forward, flip
    flips = []
    for i, s in enumerate(slices):
        if s.step is not None and s.step < 0:
            idx = range(*s.indices(x.shape[i]))
            slices[i] = (slice(idx[-1], idx[0] + 1, -s.step) if len(idx)
                         else slice(0, 0))
            flips.append(i)
    out = x[tuple(slices)]
    return out.flip(flips) if flips else out


@op("Gather")
def _gather(ctx, x, idx):
    axis = ctx.attr("axis", 0)
    if _all_host((x, idx)):
        return np.take(x, np.asarray(idx, dtype=np.int64), axis=axis)
    x = _tensor(x)
    axis %= x.ndim
    dim = x.shape[axis]
    # negative indices count from the end, as jnp.take/np.take wrap them
    if _is_host(idx):
        i = np.asarray(idx, dtype=np.int64)
        i = np.where(i < 0, i + dim, i)
        if i.ndim == 0:
            return x.select(axis, int(i))
        idx = _tensor(i, x.device)
    else:
        idx = idx.to(torch.int64)
        idx = torch.where(idx < 0, idx + dim, idx)
    out = x.index_select(axis, idx.reshape(-1))
    return out.reshape(x.shape[:axis] + idx.shape + x.shape[axis + 1:])


# The reference's gathers and scatters never refuse an index: XLA wraps a
# negative one, then a gather through ``take_along_axis`` fills past the
# end, an indexing gather clamps, and a scatter drops the update. On the
# card an index out of range would be a device assert, so these ops hand
# ``gather``/``scatter`` only indices in range, made with ``torch.where``
# and ``clamp`` on the device (no host read: a graph of them captures).

def _fill_value(dt: torch.dtype):
    """The value JAX's gather gives past the end (mode "fill"): NaN for a
    float, the lowest value of a signed integer, the highest of an
    unsigned one, True for bool. A 64-bit integer takes the value of the
    32-bit integer the reference narrows it to, so the packages agree."""
    if dt.is_floating_point:
        return math.nan
    if dt == torch.bool:
        return True
    info = torch.iinfo({torch.int64: torch.int32,
                        torch.uint64: torch.uint32}.get(dt, dt))
    return info.min if info.min < 0 else info.max


def _take_along(x: torch.Tensor, idx: torch.Tensor, axis: int):
    """``jnp.take_along_axis(x, idx, axis)``: the other axes broadcast, a
    negative index counts from the end, one still out of range reads
    :func:`_fill_value`."""
    n = x.shape[axis]
    shape = list(torch.broadcast_shapes(
        x.shape[:axis] + (1,) + x.shape[axis + 1:],
        idx.shape[:axis] + (1,) + idx.shape[axis + 1:]))
    idx = idx.to(torch.int64)
    idx = torch.where(idx < 0, idx + n, idx)
    ok = (idx >= 0) & (idx < n)
    shape[axis] = idx.shape[axis]
    safe = torch.where(ok, idx, 0).expand(shape)
    shape[axis] = n
    got = x.expand(shape).gather(axis, safe)
    return torch.where(ok, got, _fill_value(x.dtype))


def _scatter_rows(data: torch.Tensor, rows: torch.Tensor,
                  updates: torch.Tensor, reduction: str) -> torch.Tensor:
    """``data`` ``[M, R]`` with ``updates`` ``[n, R]`` written to ``rows``
    ``[n]`` under ``reduction``; a row of ``M`` is a spare row past the
    end, sliced off, which is how an update out of range is dropped."""
    out = torch.cat([data, data.new_zeros((1,) + data.shape[1:])])
    index = rows.reshape(-1, 1).expand(updates.shape)
    updates = updates.to(data.dtype)
    if reduction == "add":
        out.scatter_add_(0, index, updates)
    elif reduction in ("mul", "multiply", "min", "max"):
        out.scatter_reduce_(0, index, updates, {
            "mul": "prod", "multiply": "prod", "min": "amin",
            "max": "amax"}[reduction])
    else:
        out.scatter_(0, index, updates)
    return out[:-1]


def _flat_index(coords, dims, shape, dev, clamp: bool) -> torch.Tensor:
    """The row-major flat index of ``coords`` (one index tensor an axis of
    ``dims``, broadcasting to ``shape``) on ``dev``, a negative index
    counted from the end. An index still out of range is clamped into its axis (``clamp``:
    JAX's indexing gather) or sends the whole index to ``prod(dims)``, one
    past the end (a scatter's update that is dropped)."""
    flat = torch.zeros(shape, dtype=torch.int64, device=dev)
    ok = torch.ones_like(flat, dtype=torch.bool)
    for i, d in zip(coords, dims):
        i = torch.where(i < 0, i + d, i)
        if clamp:
            i = i.clamp(0, d - 1)
        else:
            ok = ok & (i >= 0) & (i < d)
        flat = flat * d + i
    return flat if clamp else torch.where(ok, flat, math.prod(dims))


@op("GatherElements")
def _gather_elements(ctx, x, idx):
    x = _tensor(x)
    return _take_along(x, _tensor(idx, x.device), ctx.attr("axis", 0) % x.ndim)


@op("GatherND")
def _gather_nd(ctx, x, idx):
    """The reference indexes each batch's slice with the index tuples: a
    negative index counts from the end, then each is clamped into its
    axis (JAX's indexing gather), one flat index a tuple here."""
    b = int(ctx.attr("batch_dims", 0))
    x = _tensor(x)
    idx = _tensor(idx, x.device).to(torch.int64)
    k = idx.shape[-1]
    dims, rest = x.shape[b:b + k], x.shape[b + k:]
    flat = _flat_index(idx.unbind(-1), dims, idx.shape[:-1], x.device,
                       clamp=True)
    nb, r = math.prod(x.shape[:b]), math.prod(rest)
    flat = flat.reshape(nb, -1, 1)
    out = x.reshape(nb, math.prod(dims), r).gather(
        1, flat.expand(nb, flat.shape[1], r))
    return out.reshape(idx.shape[:-1] + rest)


@op("ScatterElements")
def _scatter_elements(ctx, x, idx, updates):
    """``x.at[index]`` with ``index`` the indices along ``axis`` and the
    positions along every other axis. Only ``add`` and ``mul`` are read:
    any other reduction sets, as in the reference."""
    reduction = ctx.attr("reduction", "none")
    x = _tensor(x)
    idx = _tensor(idx, x.device).to(torch.int64)
    axis = ctx.attr("axis", 0) % x.ndim
    coords = [idx if d == axis else torch.arange(
        idx.shape[d], device=x.device).reshape(
            [-1 if e == d else 1 for e in range(idx.ndim)])
        for d in range(x.ndim)]
    flat = _flat_index(coords, x.shape, idx.shape, x.device, clamp=False)
    upd = _tensor(updates, x.device).expand(idx.shape).reshape(-1, 1)
    out = _scatter_rows(x.reshape(-1, 1), flat.reshape(-1), upd,
                        reduction if reduction in ("add", "mul") else "none")
    return out.reshape(x.shape)


# deprecated opset-9 name for the same op (no reduction attr back then)
_REGISTRY["Scatter"] = _scatter_elements


@op("ScatterND")
def _scatter_nd(ctx, data, indices, updates):
    reduction = ctx.attr("reduction", "none")
    if _all_host((data, indices, updates)):
        # stay on host so integer results can still feed shape slots
        out = np.array(data)
        idx = tuple(np.moveaxis(np.asarray(indices), -1, 0))
        upd = np.asarray(updates)
        if reduction == "add":
            np.add.at(out, idx, upd)
        elif reduction in ("mul", "multiply"):
            np.multiply.at(out, idx, upd)
        elif reduction == "min":
            np.minimum.at(out, idx, upd)
        elif reduction == "max":
            np.maximum.at(out, idx, upd)
        else:
            out[idx] = upd
        return out
    x = _tensor(data)
    idx = _tensor(indices, x.device).to(torch.int64)
    k = idx.shape[-1]
    flat = _flat_index(idx.unbind(-1), x.shape[:k], idx.shape[:-1],
                       x.device, clamp=False)
    rest = math.prod(x.shape[k:])
    upd = _tensor(updates, x.device).reshape(-1, rest)
    out = _scatter_rows(x.reshape(-1, rest), flat.reshape(-1), upd,
                        reduction)
    return out.reshape(x.shape)


@op("Expand")
def _expand(ctx, x, shape):
    # bidirectional numpy broadcast: align ranks from the right, then each
    # result dim is max(cur, target) with 1s broadcasting either way
    target = _static_int_list(shape, "Expand shape")
    cur = list(np.shape(x))
    rank = max(len(cur), len(target))
    cur = [1] * (rank - len(cur)) + cur
    target = [1] * (rank - len(target)) + target
    out = []
    for c, t in zip(cur, target):
        if c != t and 1 not in (c, t):
            raise ValueError(f"Expand: incompatible dims {c} vs {t}")
        out.append(max(c, t))
    if _is_host(x):
        return np.broadcast_to(np.reshape(x, cur), out)
    return x.reshape(cur).expand(out)


@op("Tile")
def _tile(ctx, x, repeats):
    reps = _static_int_list(repeats, "Tile repeats")
    return np.tile(x, reps) if _is_host(x) else torch.tile(x, reps)


_PAD_MODES = {"reflect": "reflect", "edge": "edge", "wrap": "wrap"}


@op("Pad")
def _pad_node(ctx, x, pads=None, value=None, axes=None):
    """``jnp.pad`` on any axis, N and C included. ``constant`` pads with
    ``value`` cast to x's dtype (a float value truncates for an integer
    tensor); ``reflect``, ``edge`` and ``wrap`` gather each padded axis
    through the source index numpy's ``pad`` gives for that mode (so a
    reflection wider than the axis repeats, as in the reference), built
    once per shape (:func:`_table`). A negative pad raises ``ValueError``,
    as ``jnp.pad`` does."""
    mode = ctx.attr("mode", "constant")
    if ctx.opset < 11:
        pads = ctx.attr("pads")
        value = ctx.attr("value", 0.0)
    plist = _static_int_list(pads, "Pad pads")
    x = _tensor(x)
    ax = (_static_int_list(axes, "Pad axes") if axes is not None
          else list(range(x.ndim)))
    half = len(plist) // 2
    width = [(0, 0)] * x.ndim
    for i, a in enumerate(ax):
        width[a % x.ndim] = (plist[i], plist[half + i])
    if any(lo < 0 or hi < 0 for lo, hi in width):
        raise ValueError(f"Pad: negative pads {plist}: the reference's "
                         "jnp.pad refuses them (index can't contain "
                         "negative values)")
    if mode == "constant":
        v = value.cpu().numpy() if isinstance(value, torch.Tensor) \
            else np.asarray(0.0 if value is None else value)
        cv = float(v.reshape(())) if v.size else 0.0
        if x.dtype == torch.bool:
            cv = bool(cv)
        elif not x.is_floating_point():
            cv = int(cv)
        return _pad(x, width, cv)
    np_mode = _PAD_MODES[mode]
    for a, (lo, hi) in enumerate(width):
        if lo or hi:
            n = x.shape[a]
            idx = _table(ctx, ("pad", np_mode, n, lo, hi), x.device,
                         lambda: np.pad(np.arange(n), (lo, hi), np_mode))
            x = x.index_select(a, idx)
    return x


@op("Cast")
def _cast(ctx, x):
    to = proto.TENSOR_DTYPES[ctx.attr("to")]
    if _is_host(x):
        return np.asarray(x).astype(to)
    return x.to(_torch_dtype(_canonical(np.dtype(to))))


@op("CastLike")
def _cast_like(ctx, x, like):
    if _is_host(x):
        return np.asarray(x).astype(_host_dtype(like))
    if isinstance(like, torch.Tensor):
        return x.to(like.dtype)
    return x.to(_torch_dtype(_canonical(np.asarray(like).dtype)))


@op("Identity")
def _identity(ctx, x):
    return x


@op("Constant")
def _constant(ctx):
    for key in ("value", "value_float", "value_int"):
        v = ctx.attr(key)
        if v is not None:
            return np.asarray(v)
    for key, dt in (("value_floats", np.float32), ("value_ints", np.int64)):
        v = ctx.attr(key)
        if v is not None:
            return np.asarray(v, dtype=dt)
    raise ValueError("Constant node without value")


@op("ConstantOfShape")
def _constant_of_shape(ctx, shape):
    dims = _static_int_list(shape, "ConstantOfShape shape")
    v = ctx.attr("value")
    if v is None:
        return np.zeros(dims, dtype=np.float32)
    v = np.asarray(v)
    return np.full(dims, v.reshape(-1)[0], dtype=v.dtype)


@op("Range")
def _range(ctx, start, limit, delta):
    if _all_host((start, limit, delta)):
        return np.arange(int(np.asarray(start)), int(np.asarray(limit)),
                         int(np.asarray(delta)),
                         dtype=np.asarray(start).dtype)
    raise ValueError("Range with device bounds is not supported (dynamic shape)")


@op("OneHot")
def _one_hot(ctx, indices, depth, values):
    """``jax.nn.one_hot``: each index compared with ``arange(depth)``, so a
    negative or out-of-range index gives a row all off (the spec wraps a
    negative one), in float32 whatever the values' dtype; then scaled and
    shifted by the values."""
    axis = ctx.attr("axis", -1)
    d = _static_int_list(depth, "OneHot depth")[0]
    idx = _tensor(indices)
    oh = (idx.unsqueeze(-1) == torch.arange(d, device=idx.device)).to(
        torch.float32).movedim(-1, axis % (idx.ndim + 1))
    if _is_host(values):
        values = np.asarray(values).reshape(-1)
    off_val, on_val = values[0], values[1]
    return _bin(operator.add, _bin(operator.mul, oh, on_val - off_val),
                off_val)


@op("SpaceToDepth")
def _space_to_depth(ctx, x):
    b = ctx.attr("blocksize")
    x = _tensor(x)
    n, c, h, w = x.shape
    x = x.reshape(n, c, h // b, b, w // b, b).permute(0, 3, 5, 1, 2, 4)
    return x.reshape(n, c * b * b, h // b, w // b)


@op("DepthToSpace")
def _depth_to_space(ctx, x):
    b = ctx.attr("blocksize")
    x = _tensor(x)
    n, c, h, w = x.shape
    if ctx.attr("mode", "DCR") == "DCR":
        x = x.reshape(n, b, b, c // (b * b), h, w).permute(0, 3, 4, 1, 5, 2)
    else:
        x = x.reshape(n, c // (b * b), b, b, h, w).permute(0, 1, 4, 2, 5, 3)
    return x.reshape(n, c // (b * b), h * b, w * b)


def _softmax_impl(ctx, x, log: bool):
    x = _tensor(x)
    axis = ctx.attr("axis", -1 if ctx.opset >= 13 else 1)
    fn = torch.log_softmax if log else torch.softmax
    if ctx.opset >= 13:
        return fn(x, axis)
    # legacy semantics: flatten to 2D at `axis`, softmax, reshape back
    axis = axis % x.ndim
    lead = int(np.prod(x.shape[:axis])) if axis else 1
    return fn(x.reshape(lead, -1), -1).reshape(x.shape)


@op("Softmax")
def _softmax(ctx, x):
    return _softmax_impl(ctx, x, log=False)


@op("LogSoftmax")
def _log_softmax(ctx, x):
    return _softmax_impl(ctx, x, log=True)


@op("Hardmax")
def _hardmax(ctx, x):
    """One at the first maximum along ``axis`` (the first NaN if there is
    one, as ``jnp.argmax``), built so: the first hit of an integer mask."""
    x = _tensor(x)
    axis = ctx.attr("axis", -1 if ctx.opset >= 13 else 1) % x.ndim
    top = x.amax(axis, keepdim=True)
    hit = x == top
    if x.is_floating_point():
        hit = torch.where(top.isnan(), x.isnan(), hit)
    first = hit.to(torch.uint8).argmax(axis, keepdim=True)
    return torch.zeros_like(x).scatter_(axis, first, 1)


def _order_key(x: torch.Tensor, negate: bool = False) -> torch.Tensor:
    """An integer tensor ordered as XLA's sort orders ``x``, or ``-x``
    under ``negate``: a float's IEEE total order (-NaN < -inf < ... < -0 <
    +0 < ... < +inf < +NaN, the sign bit read on a NaN too), an integer's
    value. A float is negated on its bits, as JAX negates it: CUDA's
    negation would leave a NaN's sign as it was."""
    if not x.is_floating_point():
        return x.neg() if negate else x
    wide = torch.int64 if x.dtype == torch.float64 else torch.int32
    bits = (x if x.dtype == torch.float64 else x.float()).view(wide)
    if negate:
        bits = bits ^ torch.iinfo(wide).min
    return bits ^ ((bits >> (bits.element_size() * 8 - 1))
                   & torch.iinfo(wide).max)


@op("TopK")
def _topk(ctx, x, k=None):
    """``lax.top_k``, the smallest through ``top_k(-x)`` as the reference
    takes them, on the total-order key of :func:`_order_key`. Ties keep
    the lower index first by construction (``torch.topk`` fixes no order
    among ties): a key of 32 bits or fewer takes its position in the low
    32 bits of an int64, lower positions larger, so no two keys tie; a
    64-bit key is sorted stably."""
    axis = ctx.attr("axis", -1)
    largest = ctx.attr("largest", 1)
    if ctx.opset < 10:
        kk = ctx.attr("k")
    else:
        kk = _static_int_list(k, "TopK k")[0]
    moved = _tensor(x).movedim(axis, -1)
    key = _order_key(moved, negate=not largest)
    if key.element_size() <= 4:
        width = key.shape[-1]
        rank = torch.arange(width - 1, -1, -1, device=key.device)
        idx = torch.topk((key.to(torch.int64) << 32) | rank, kk, dim=-1)[1]
    else:
        idx = torch.sort(key, dim=-1, descending=True, stable=True)[1][
            ..., :kk]
    return (moved.gather(-1, idx).movedim(-1, axis), idx.movedim(-1, axis))


# ---------------------------------------------------------------------------
# Reductions
# ---------------------------------------------------------------------------

def _int_kept(x: torch.Tensor) -> Optional[torch.dtype]:
    """The accumulation dtype of a sum or product: an int32 or int64 input
    keeps its width, as JAX's does (torch would widen int32); bool and
    narrower integers take torch's default, int64."""
    return x.dtype if x.dtype in (torch.int32, torch.int64) else None


def _sum_dims(x, dims, keep):
    return torch.sum(x, dim=dims, keepdim=keep, dtype=_int_kept(x))


def _prod_dims(x, dims, keep):
    dt = _int_kept(x)
    for d in sorted(dims, reverse=True):
        x = torch.prod(x, d, keepdim=keep, dtype=dt)
    return x


def _mean_dims(x, dims, keep):
    if not x.is_floating_point():   # jnp.mean of integers is float32
        x = x.to(torch.get_default_dtype())
    return torch.mean(x, dim=dims, keepdim=keep)


def _reduce(fn):
    def impl(ctx, x, axes=None):
        if ctx.opset < 18 and axes is None:
            axes = ctx.attr("axes", None)
        keep = bool(ctx.attr("keepdims", 1))
        x = _tensor(x)
        if axes is None or np.size(axes) == 0:
            if ctx.attr("noop_with_empty_axes", 0):
                return x
            dims = tuple(range(x.ndim))
        else:
            dims = tuple(a % x.ndim
                         for a in _static_int_list(axes, "Reduce axes"))
        return fn(x, dims, keep)
    return impl


for _name, _fn in [
    ("ReduceMean", _mean_dims), ("ReduceSum", _sum_dims),
    ("ReduceMax", lambda x, d, k: torch.amax(x, dim=d, keepdim=k)),
    ("ReduceMin", lambda x, d, k: torch.amin(x, dim=d, keepdim=k)),
    ("ReduceProd", _prod_dims),
    ("ReduceL1", lambda x, d, k: _sum_dims(torch.abs(x), d, k)),
    ("ReduceL2", lambda x, d, k: torch.sqrt(_sum_dims(x * x, d, k))),
    ("ReduceLogSumExp", lambda x, d, k: torch.logsumexp(x, dim=d,
                                                        keepdim=k)),
    ("ReduceLogSum", lambda x, d, k: torch.log(_sum_dims(x, d, k))),
    ("ReduceSumSquare", lambda x, d, k: _sum_dims(x * x, d, k)),
]:
    _REGISTRY[_name] = _reduce(_fn)


def _arg_reduce(fn):
    def impl(ctx, x):
        return fn(_tensor(x), dim=ctx.attr("axis", 0),
                  keepdim=bool(ctx.attr("keepdims", 1)))
    return impl


_REGISTRY["ArgMax"] = _arg_reduce(torch.argmax)
_REGISTRY["ArgMin"] = _arg_reduce(torch.argmin)


@op("CumSum")
def _cumsum(ctx, x, axis):
    ax = _static_int_list(axis, "CumSum axis")[0]
    y = _tensor(x)
    reverse = ctx.attr("reverse", 0)
    if reverse:
        y = torch.flip(y, (ax,))
    out = torch.cumsum(y, ax, dtype=_int_kept(y))
    if ctx.attr("exclusive", 0):
        out = out - y
    if reverse:
        out = torch.flip(out, (ax,))
    return out


# ---------------------------------------------------------------------------
# Recurrent: LSTM / GRU / RNN, one Python step a time step
# ---------------------------------------------------------------------------
# As in the reference, ``seq_lens``, LSTM's peepholes ``p``, ``clip``,
# ``input_forget`` and ``layout`` are not read (every sequence runs its
# full length); LSTM and GRU take their default activations.

def _direction_slices(direction: str):
    if direction == "bidirectional":
        return [(0, False), (1, True)]
    return [(0, direction == "reverse")]


def _recurrent_dirs(ctx, x, w, r, b, init, n_gates, step):
    """Run ``step(x_proj_t, carry, rd, rb) -> (carry, h)`` over the time
    steps of each direction. The input projection is one product a
    direction; ``init`` holds the initial states (``None``: zeros).
    Returns the op's outputs: ``Y [S, dirs, B, H]``, then each state's
    final value ``[dirs, B, H]`` as far as the node names outputs.

    The products promote their operands as jnp's do (a float32 initial
    state against bf16 weights gives float32); torch's elementwise ops
    between tensors of rank > 0 already promote as JAX does."""
    hidden = ctx.attr("hidden_size")
    x = _tensor(x)
    w, r = _tensor(w, x.device), _tensor(r, x.device)
    seq, batch, _ = x.shape
    outs, finals = [], []
    for d, reverse in _direction_slices(ctx.attr("direction", "forward")):
        wd, rd = w[d], r[d]
        if b is not None:
            bd = _tensor(b, x.device)[d]
            wb, rb = bd[: n_gates * hidden], bd[n_gates * hidden:]
        else:
            wb = rb = torch.zeros((n_gates * hidden,), dtype=x.dtype,
                                  device=x.device)
        carry = tuple(
            _tensor(s, x.device)[d] if s is not None else
            torch.zeros((batch, hidden), dtype=x.dtype, device=x.device)
            for s in init)
        xs = torch.flip(x, (0,)) if reverse else x
        x_proj = torch.einsum("sbi,gi->sbg", *_operands((xs, wd))) + wb
        ys = []
        for t in range(seq):
            carry, h = step(x_proj[t], carry, rd, rb)
            ys.append(h)
        ys = torch.stack(ys)
        outs.append(torch.flip(ys, (0,)) if reverse else ys)
        finals.append(carry)
    y = torch.stack(outs, dim=1)
    if ctx.n_outputs <= 1:
        return y
    return (y, *(torch.stack(s) for s in zip(*finals)))[: ctx.n_outputs]


@op("LSTM")
def _lstm(ctx, x, w, r, b=None, seq_lens=None, init_h=None, init_c=None,
          p=None):
    """ONNX LSTM, gate order i,o,f,c."""
    def step(xp_t, carry, rd, rb):
        h, c = carry
        gates = xp_t + _matmul(ctx, h, rd.T) + rb
        i_g, o_g, f_g, c_g = torch.chunk(gates, 4, dim=-1)
        c_new = (torch.sigmoid(f_g) * c
                 + torch.sigmoid(i_g) * torch.tanh(c_g))
        h_new = torch.sigmoid(o_g) * torch.tanh(c_new)
        return (h_new, c_new), h_new

    return _recurrent_dirs(ctx, x, w, r, b, (init_h, init_c), 4, step)


@op("GRU")
def _gru(ctx, x, w, r, b=None, seq_lens=None, init_h=None):
    """ONNX GRU, gate order z,r,h."""
    hidden = ctx.attr("hidden_size")
    linear_before_reset = ctx.attr("linear_before_reset", 0)

    def step(xp_t, carry, rd, rb):
        (h,) = carry
        xz, xr, xh = torch.split(xp_t, hidden, dim=-1)
        hz, hr, hh = torch.split(_matmul(ctx, h, rd.T), hidden, dim=-1)
        rbz, rbr, rbh = torch.split(rb, hidden)
        z = torch.sigmoid(xz + hz + rbz)
        rg = torch.sigmoid(xr + hr + rbr)
        if linear_before_reset:
            h_cand = torch.tanh(xh + rg * (hh + rbh))
        else:
            h_cand = torch.tanh(
                xh + _matmul(ctx, rg * h, rd[2 * hidden:].T) + rbh)
        h = (1 - z) * h_cand + z * h
        return (h,), h

    return _recurrent_dirs(ctx, x, w, r, b, (init_h,), 3, step)


_RNN_ACTIVATIONS = {"Tanh": torch.tanh, "Relu": torch.relu,
                    "Sigmoid": torch.sigmoid}


@op("RNN")
def _rnn(ctx, x, w, r, b=None, seq_lens=None, init_h=None):
    acts = [a.decode() if isinstance(a, bytes) else str(a)
            for a in (ctx.attr("activations", None) or [])]
    if len(set(acts)) > 1:
        raise NotImplementedError(
            f"RNN: per-direction activations {acts} are not supported")
    name = acts[0] if acts else "Tanh"
    act = _RNN_ACTIVATIONS.get(name)
    if act is None:
        raise NotImplementedError(f"RNN activation {name!r}")

    def step(xp_t, carry, rd, rb):
        h = act(xp_t + _matmul(ctx, carry[0], rd.T) + rb)
        return (h,), h

    return _recurrent_dirs(ctx, x, w, r, b, (init_h,), 1, step)


# ---------------------------------------------------------------------------
# Host-only selections and the two losses
# ---------------------------------------------------------------------------

@op("Unique")
def _unique(ctx, x):
    """Data-dependent output shape: host-side only (same contract as the
    reference's ORT CPU kernel; a traced input cannot produce a
    dynamic-shape XLA result)."""
    if not _is_host(x):
        raise NotImplementedError(
            "Unique produces data-dependent shapes; feed it host-side "
            "data (constant-folded subgraph) or move it out of the "
            "jitted region")
    x = np.asarray(x)
    axis = ctx.attr("axis")
    is_sorted = bool(ctx.attr("sorted", 1))
    y, first_idx, inverse, counts = np.unique(
        x, return_index=True, return_inverse=True, return_counts=True,
        axis=axis)
    if not is_sorted:
        order = np.argsort(first_idx, kind="stable")
        rank_of = np.empty_like(order)
        rank_of[order] = np.arange(len(order))
        y = np.take(y, order, axis=axis if axis is not None else 0)
        first_idx = first_idx[order]
        counts = counts[order]
        inverse = rank_of[inverse]
    outs = (y, first_idx.astype(np.int64),
            inverse.reshape(-1).astype(np.int64),
            counts.astype(np.int64))
    return outs[: max(ctx.n_outputs, 1)] if ctx.n_outputs > 1 else y


@op("Compress")
def _compress(ctx, x, condition):
    """Boolean-mask selection — output length is data-dependent, so the
    condition must be host-side (initializer / folded)."""
    if not (_is_host(condition) and _is_host(x)):
        raise NotImplementedError(
            "Compress produces data-dependent shapes; condition and data "
            "must be host-side (constant-folded)")
    return np.compress(np.asarray(condition, bool).reshape(-1),
                       np.asarray(x), axis=ctx.attr("axis"))


def _nll_core(logp, target, weight, reduction, ignore_index):
    """The reference's loss: the target's log-probability through its
    filling gather, so a target outside ``[0, C)`` (``ignore_index``
    -100 among them) reads NaN, and ``-NaN * 0`` keeps the ignored row's
    loss NaN and a ``mean`` NaN (the reference's result, kept)."""
    c = logp.shape[1]
    t = _tensor(target, logp.device).to(torch.int32).unsqueeze(1)
    gather = _take_along(logp, t, 1).squeeze(1)
    t = t.squeeze(1)
    if weight is not None:
        w = _tensor(weight, logp.device).to(torch.float32)[
            t.clamp(0, c - 1).to(torch.int64)]
    else:
        w = torch.ones_like(gather)
    if ignore_index is not None:
        w = torch.where(t == ignore_index, 0.0, w)
    loss = -gather * w
    if reduction == "none":
        return loss
    if reduction == "sum":
        return loss.sum()
    return loss.sum() / torch.clamp_min(w.sum(), 1e-12)


@op("NegativeLogLikelihoodLoss")
def _nll_loss(ctx, x, target, weight=None):
    return _nll_core(_tensor(x).to(torch.float32), target, weight,
                     ctx.attr("reduction", "mean"), ctx.attr("ignore_index"))


@op("SoftmaxCrossEntropyLoss")
def _softmax_ce_loss(ctx, scores, target, weight=None):
    logp = torch.log_softmax(_tensor(scores).to(torch.float32), 1)
    loss = _nll_core(logp, target, weight, ctx.attr("reduction", "mean"),
                     ctx.attr("ignore_index"))
    return (loss, logp) if ctx.n_outputs > 1 else loss


# ---------------------------------------------------------------------------
# com.microsoft LLM weights and positions: MatMulNBits, RotaryEmbedding
# ---------------------------------------------------------------------------

def _absent(x) -> bool:
    """An optional input left out: no value, or an empty one."""
    if x is None:
        return True
    return (np.size(x) if _is_host(x) else x.numel()) == 0


def _rows(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``table[idx]`` as the reference's gather reads it: a negative index
    counts from the end, an index past the end reads the last row (JAX
    clamps a gather's indices)."""
    n = table.shape[0]
    idx = torch.where(idx < 0, idx + n, idx).clamp(0, n - 1)
    return table[idx]


@op("MatMulNBits")
def _matmul_nbits(ctx, a, b_packed, scales, zero_points=None):
    """com.microsoft blockwise 4-bit quantized matmul. B is ``[N, K/block,
    block/2]`` packed nibbles (the low nibble is the even element); it is
    dequantized blockwise to ``[N, K]`` in float32 (zero point 8 unless
    given), cast to ``a``'s dtype, and multiplied."""
    bits = int(ctx.attr("bits", 4))
    if bits != 4:
        raise NotImplementedError("MatMulNBits: only bits=4 is supported")
    K = int(ctx.attr("K"))
    N = int(ctx.attr("N"))
    block = int(ctx.attr("block_size"))
    a = _tensor(a)
    bp = _tensor(b_packed, a.device)
    n_blocks = bp.shape[1]
    nibbles = torch.stack([bp & 0xF, bp >> 4], -1).reshape(N, n_blocks, -1)
    sc = _tensor(scales, a.device).to(torch.float32).reshape(N, n_blocks)
    if zero_points is None:
        zp = torch.full((N, n_blocks), 8.0, device=a.device)
    else:
        zpa = _tensor(zero_points, a.device)
        if zpa.dtype == torch.uint8 and zpa.ndim == 1:
            # packed 4-bit zero points, one nibble per block
            zp = torch.stack([zpa & 0xF, zpa >> 4], -1).reshape(N, -1)
            zp = zp[:, :n_blocks].to(torch.float32)
        else:
            zp = zpa.to(torch.float32).reshape(N, n_blocks)
    deq = (nibbles.to(torch.float32) - zp[..., None]) * sc[..., None]
    w = deq.reshape(N, n_blocks * block)[:, :K]               # [N, K]
    return torch.matmul(a, w.T.to(a.dtype))


def _apply_rope(t, cc, ss, interleaved, rot):
    """Rotate the leading ``rot`` features of ``t`` by (cos, sin), the core
    shared by RotaryEmbedding and GroupQueryAttention's internal rope.
    ``cc``/``ss`` (float32) broadcast against ``t[..., :rot//2]``; the
    rotation runs in the promoted dtype and is cast back to ``t``'s."""
    tr, tp = t[..., :rot], t[..., rot:]
    if interleaved:
        t1, t2 = tr[..., 0::2], tr[..., 1::2]
    else:
        t1, t2 = tr[..., : rot // 2], tr[..., rot // 2:]
    o1 = t1 * cc - t2 * ss
    o2 = t2 * cc + t1 * ss
    out = (torch.stack([o1, o2], -1).reshape(tr.shape) if interleaved
           else torch.cat([o1, o2], -1))
    return torch.cat([out.to(t.dtype), tp], -1)


@op("RotaryEmbedding")
def _rotary_embedding(ctx, x, position_ids, cos_cache, sin_cache):
    """com.microsoft rotary position embedding: 3-D ``[B, S, H]`` input
    (``num_heads`` attr) or 4-D ``[B, NH, S, Hd]``; interleaved and
    half-split layouts; one position id is ORT's start offset."""
    interleaved = bool(ctx.attr("interleaved", 0))
    x = _tensor(x)
    squeeze_back = x.ndim == 3
    if squeeze_back:
        nh = int(ctx.attr("num_heads", 0))
        b, s, h = x.shape
        if nh <= 0:
            raise ValueError("RotaryEmbedding: 3-D input needs num_heads")
        x = x.reshape(b, s, nh, h // nh).transpose(1, 2)
    b, nh, s, hd = x.shape
    rot = int(ctx.attr("rotary_embedding_dim", 0)) or hd
    pos = _tensor(position_ids, x.device).to(torch.int64)
    if pos.numel() == 1:
        # ORT's start-offset form: one position id means positions start
        # there and increment per token
        pos = pos.reshape(1, 1) + torch.arange(s, device=x.device)[None, :]
    elif pos.ndim == 1:
        pos = pos[None, :]
    cos = _rows(_tensor(cos_cache, x.device).to(torch.float32), pos)
    sin = _rows(_tensor(sin_cache, x.device).to(torch.float32), pos)
    out = _apply_rope(x, cos[:, None], sin[:, None], interleaved, rot)
    if squeeze_back:
        out = out.transpose(1, 2).reshape(b, s, nh * hd)
    return out


# ---------------------------------------------------------------------------
# Attention: GroupQueryAttention, MultiHeadAttention, Attention
# ---------------------------------------------------------------------------
# As in the reference: q, k and v in float32, grouped heads without a
# materialised repeat of K/V, masking by -inf (or ORT's additive filter
# value), a float32 softmax, the result cast back to the input's dtype.

def _grouped_scores(q, k, kv_heads, scale):
    """``einsum("bkgsd,bktd->bkgst")`` of ``q [B, Hq, S, D]`` grouped onto
    ``k [B, Hkv, T, D]``, in float32, times ``scale``: one batched product
    of ``[G*S, D]`` by ``[D, T]`` a KV head."""
    b, nq, s, d = q.shape
    qg = q.reshape(b, kv_heads, (nq // kv_heads) * s, d).to(torch.float32)
    logits = torch.matmul(qg, k.to(torch.float32).transpose(-1, -2)) * scale
    return logits.reshape(b, kv_heads, nq // kv_heads, s, k.shape[2])


def _grouped_values(probs, v):
    """``einsum("bkgst,bktd->bkgsd")`` in float32, as ``[B, Hq, S, Dv]``."""
    b, nk, g, s, t = probs.shape
    out = torch.matmul(probs.reshape(b, nk, g * s, t), v.to(torch.float32))
    return out.reshape(b, nk * g, s, v.shape[-1])


def _merge_heads(out, dt):
    """``[B, N, S, D]`` -> ``[B, S, N*D]`` in ``dt``."""
    b, n, s, d = out.shape
    return out.transpose(1, 2).reshape(b, s, n * d).to(dt)


@op("GroupQueryAttention")
def _group_query_attention(ctx, query, key=None, value=None,
                           past_key=None, past_value=None, seqlens_k=None,
                           total_sequence_length=None, cos_cache=None,
                           sin_cache=None):
    """com.microsoft GroupQueryAttention: causal grouped-head attention
    with an optional KV cache, separate or packed QKV, internal rotary
    (``do_rotary``).

    ``past_present_share_buffer=1`` is the serving-cache layout:
    ``past_key/past_value`` are max-length buffers ``[B, Hkv, T, D]``;
    row b's new K/V rows go at ``past_len_b = max(seqlens_k + 1 - S, 0)``
    (ORT: ``seqlens_k`` = total valid keys - 1), the start clamped to
    ``[0, T - S]`` as JAX's ``dynamic_update_slice`` clamps it; rotary
    positions and the causal frontier ``k_pos <= past_len_b + q_idx`` use
    the unclamped ``past_len_b``. Everything is computed on the device
    from ``seqlens_k``: no host sync. ``present_*`` are new tensors; the
    caller's buffers are not written."""
    num_heads = int(ctx.attr("num_heads", 0))
    kv_heads = int(ctx.attr("kv_num_heads", 0))
    if num_heads <= 0 or kv_heads <= 0:
        raise ValueError("GroupQueryAttention needs num_heads and "
                         "kv_num_heads attributes")
    q = _tensor(query)
    dev = q.device
    b, s, dq = q.shape
    if _absent(key):
        # packed QKV: [B, S, (Hq + 2*Hkv) * D]
        head = dq // (num_heads + 2 * kv_heads)
        qw, kw = num_heads * head, (num_heads + kv_heads) * head
        q, k, v = q[..., :qw], q[..., qw:kw], q[..., kw:]
    else:
        head = dq // num_heads
        k, v = _tensor(key, dev), _tensor(value, dev)
    dt = q.dtype

    def heads(t, h):
        return t.reshape(b, s, h, head).transpose(1, 2)

    q = heads(q, num_heads)                        # [B, Hq, S, D]
    k = heads(k, kv_heads)                         # [B, Hkv, S, D]
    v = heads(v, kv_heads)
    share = bool(ctx.attr("past_present_share_buffer", 0))
    if share and (past_key is None or seqlens_k is None):
        raise ValueError(
            "GroupQueryAttention: past_present_share_buffer=1 needs "
            "past_key/past_value buffers and seqlens_k")
    past_len = np.shape(past_key)[2] if past_key is not None else 0
    steps = torch.arange(s, device=dev)
    if share:
        lens = _tensor(seqlens_k, dev).to(torch.int64).reshape(b)
        past_len_b = torch.clamp(lens + 1 - s, min=0)   # [B] write positions

    if ctx.attr("do_rotary", 0):
        if cos_cache is None or sin_cache is None:
            raise ValueError("do_rotary=1 needs cos_cache/sin_cache")
        cos = _tensor(cos_cache, dev).to(torch.float32)
        sin = _tensor(sin_cache, dev).to(torch.float32)
        rot = 2 * cos.shape[-1]
        max_pos = past_len if share else past_len + s
        if max_pos > cos.shape[0]:
            # a clamped gather would silently freeze the rotary angle
            raise ValueError(
                f"GroupQueryAttention: positions up to {max_pos} exceed "
                f"the exported rope cache ({cos.shape[0]} rows); "
                "re-export with a longer max position")
        inter = bool(ctx.attr("rotary_interleaved", 0))
        if share:
            pos = past_len_b[:, None] + steps
            cc, ss = _rows(cos, pos)[:, None], _rows(sin, pos)[:, None]
        else:
            pos = past_len + steps
            cc, ss = cos[pos][None, None], sin[pos][None, None]
        q = _apply_rope(q, cc, ss, inter, rot)
        k = _apply_rope(k, cc, ss, inter, rot)

    if share:
        # out-of-place scatter at each row's write position: the buffer's
        # shape is step-invariant and the caller's buffer stays as it was
        start = torch.clamp(past_len_b, max=past_len - s)
        idx = (start[:, None] + steps)[:, None, :, None].expand(
            b, kv_heads, s, head)
        k = _tensor(past_key, dev).to(dt).scatter(2, idx, k)
        v = _tensor(past_value, dev).to(dt).scatter(2, idx, v)
    elif past_key is not None:
        k = torch.cat([_tensor(past_key, dev).to(dt), k], dim=2)
        v = torch.cat([_tensor(past_value, dev).to(dt), v], dim=2)
    present_k, present_v = k, v
    t_kv = k.shape[2]

    scale = ctx.attr("scale", 0.0) or 1.0 / math.sqrt(head)
    logits = _grouped_scores(q, k, kv_heads, scale)   # [B, Hkv, G, S, T]
    k_pos = torch.arange(t_kv, device=dev)
    if share:
        # per-row causal frontier: row b's query j sits at global
        # position past_len_b[b] + j; slots beyond it never enter the
        # softmax
        q_pos = past_len_b[:, None, None] + steps[None, :, None]
        mask = (k_pos <= q_pos)[:, None, None]              # [B,1,1,S,T]
    else:
        mask = (k_pos <= past_len + steps[:, None])[None, None, None]
        if seqlens_k is not None:
            # ORT convention: seqlens_k = total valid keys per batch - 1
            lim = _tensor(seqlens_k, dev).to(torch.int64).reshape(b) + 1
            mask = mask & (k_pos < lim[:, None])[:, None, None, None, :]
    logits = torch.where(mask, logits, -math.inf)
    out = _grouped_values(torch.softmax(logits, dim=-1), v)
    out = _merge_heads(out, dt)
    if ctx.n_outputs > 1:
        return out, present_k, present_v
    return out


def _standard_attention(ctx, q, k, v, attn_mask=None, past_key=None,
                        past_value=None):
    """Standard ai.onnx Attention (opset 23): scaled dot-product attention
    over separate Q/K/V, 3-D (``[B, S, N*D]`` with q/kv_num_heads attrs)
    or 4-D (``[B, N, S, D]``). Grouped-query head counts, ``is_causal``
    (top-left alignment), additive or boolean masks, scale and softcap;
    KV cache inputs/outputs and the qk_matmul_output modes raise."""
    if k is None or v is None:
        raise NotImplementedError(
            "standard Attention needs Q, K and V inputs")
    if past_key is not None or past_value is not None:
        raise NotImplementedError(
            "standard Attention with past_key/past_value (KV cache) is "
            "not supported; re-export the decode step with explicit "
            "Concat of the cache, or use the com.microsoft "
            "GroupQueryAttention form")
    if ctx.n_outputs > 1:
        raise NotImplementedError(
            "standard Attention present_key/present_value (or "
            "qk_matmul_output) outputs are not supported")
    if int(ctx.attr("qk_matmul_output_mode", 0)) != 0:
        raise NotImplementedError(
            "Attention qk_matmul_output_mode != 0 (exposing the raw "
            "QK product) is not supported")
    q = _tensor(q)
    dev = q.device
    k, v = _tensor(k, dev), _tensor(v, dev)
    three_d = q.ndim == 3
    if three_d:
        nq = int(ctx.attr("q_num_heads", 0))
        nk = int(ctx.attr("kv_num_heads", 0))
        if nq <= 0 or nk <= 0:
            raise ValueError(
                "3-D standard Attention needs q_num_heads/kv_num_heads")
        b, s, dq = q.shape
        q = q.reshape(b, s, nq, dq // nq).transpose(1, 2)
        k = k.reshape(k.shape[0], k.shape[1], nk,
                      k.shape[2] // nk).transpose(1, 2)
        v = v.reshape(v.shape[0], v.shape[1], nk,
                      v.shape[2] // nk).transpose(1, 2)
    b, nq, s, head = q.shape
    nk, t_kv = k.shape[1], k.shape[2]
    if nq % nk:
        raise ValueError(
            f"Attention q heads {nq} not a multiple of kv heads {nk}")
    group = nq // nk
    dt = q.dtype
    scale = ctx.attr("scale", 0.0) or 1.0 / math.sqrt(head)
    logits = _grouped_scores(q, k, nk, scale)
    bool_mask = None
    if attn_mask is not None:
        m = _tensor(attn_mask, dev)
        # right-align onto [B, N, S, T] then add the group axis
        m4 = m.reshape((1,) * (4 - m.ndim) + tuple(m.shape))
        if m4.shape[1] == 1:        # broadcast over heads
            m5 = m4[:, :, None]
        else:                       # per-q-head mask: split (nk, group)
            m5 = m4.reshape(m4.shape[0], nk, group, m4.shape[2],
                            m4.shape[3])
        if m.dtype == torch.bool:
            bool_mask = m5
        else:
            # an additive float mask adds before softcap (the spec's
            # Add -> softcap -> Softmax node order)
            logits = logits + m5.to(torch.float32)
    softcap = float(ctx.attr("softcap", 0.0))
    if softcap > 0.0:
        logits = softcap * torch.tanh(logits / softcap)
    # hard masking applies after softcap: a -inf folded into the tanh
    # would become -softcap and unmask the position
    if bool_mask is not None:
        logits = torch.where(bool_mask, logits, -math.inf)
    if ctx.attr("is_causal", 0):
        # top-left alignment: query i attends keys j <= i
        causal = (torch.arange(t_kv, device=dev)[None, :]
                  <= torch.arange(s, device=dev)[:, None])
        logits = torch.where(causal, logits, -math.inf)
    probs = torch.softmax(logits, dim=-1)
    probs = torch.where(torch.isnan(probs), 0.0, probs)  # fully-masked rows
    out = _grouped_values(probs, v).to(dt)
    if three_d:
        out = _merge_heads(out, dt)
    return out


def _additive_key_mask(ok, neg):
    """0 where a key is attended, ORT's filter value ``neg`` (a float32
    tensor) where it is not: ORT masks additively, which keeps the order
    of masked logits (soft masking with a small filter value)."""
    return torch.where(ok, 0.0, neg)


@op("MultiHeadAttention")
def _multi_head_attention(ctx, query, key=None, value=None, bias=None,
                          key_padding_mask=None, attention_bias=None,
                          past_key=None, past_value=None):
    """com.microsoft MultiHeadAttention (already-projected Q/K/V): 3-D
    ``[B, S, N*D]`` Q/K/V with ``num_heads``, a combined QKV bias split at
    the actual q/k/v widths, ``[B]`` or ``[B, T]`` key padding masks, an
    additive attention_bias, unidirectional, past/present KV cache. The
    5-D packed-QKV and 4-D past-format K/V layouts raise."""
    num_heads = int(ctx.attr("num_heads", 0))
    if num_heads <= 0:
        raise ValueError("MultiHeadAttention needs num_heads")
    q = _tensor(query)
    dev, out_dt = q.device, q.dtype
    if q.ndim != 3:
        raise NotImplementedError(
            "MultiHeadAttention supports 3-D [B, S, N*D] inputs; the "
            "5-D packed-QKV form is not supported — re-export unpacked")
    b, s, _ = q.shape
    if _absent(key):
        raise NotImplementedError(
            "MultiHeadAttention needs separate 3-D key/value inputs "
            "(the packed-QKV layout is 5-D and unsupported — re-export "
            "unpacked)")
    k, v = _tensor(key, dev), _tensor(value, dev)
    if k.ndim != 3:
        raise NotImplementedError(
            "MultiHeadAttention past-format (4-D) K/V inputs are "
            "not supported; re-export with 3-D K/V + past_key/"
            "past_value cache inputs")
    if bias is not None:
        # ORT layout: (q_hidden | k_hidden | v_hidden); v may differ
        bias = _tensor(bias, dev)
        qw, kw = q.shape[-1], q.shape[-1] + k.shape[-1]
        q = _bin(operator.add, q, bias[:qw])
        k = _bin(operator.add, k, bias[qw:kw])
        v = _bin(operator.add, v, bias[kw:])
    head = q.shape[-1] // num_heads

    def heads(t):
        return t.reshape(t.shape[0], t.shape[1], num_heads,
                         -1).transpose(1, 2)

    q, k, v = heads(q), heads(k), heads(v)          # [B, N, S|T, D]
    if past_key is not None:
        k = torch.cat([_tensor(past_key, dev).to(k.dtype), k], dim=2)
        v = torch.cat([_tensor(past_value, dev).to(v.dtype), v], dim=2)
    present_k, present_v = k, v
    t_kv = k.shape[2]
    scale = ctx.attr("scale", 0.0) or 1.0 / math.sqrt(head)
    logits = _grouped_scores(q, k, num_heads, scale)[:, :, 0]
    if attention_bias is not None:
        ab = _tensor(attention_bias, dev).to(torch.float32)
        logits = logits + ab.reshape((1,) * (4 - ab.ndim) + tuple(ab.shape))
    neg = torch.full((), ctx.attr("mask_filter_value", -10000.0),
                     dtype=torch.float32, device=dev)
    k_pos = torch.arange(t_kv, device=dev)
    if key_padding_mask is not None:
        m = _tensor(key_padding_mask, dev)
        if m.ndim == 1:                             # [B] valid lengths
            ok = k_pos[None, :] < m.to(torch.int64)[:, None]
        elif m.ndim == 2:                           # [B, T_kv] 0/1
            ok = m != 0
        else:
            raise NotImplementedError(
                "MultiHeadAttention key_padding_mask must be [B] "
                "lengths or a [B, T_kv] 0/1 mask")
        logits = logits + _additive_key_mask(ok[:, None, None, :], neg)
    if ctx.attr("unidirectional", 0):
        q_pos = (t_kv - s) + torch.arange(s, device=dev)[:, None]
        logits = logits + _additive_key_mask(k_pos[None, :] <= q_pos, neg)
    probs = torch.softmax(logits, dim=-1)
    out = _grouped_values(probs[:, :, None], v)
    out = _merge_heads(out, out_dt)
    if ctx.n_outputs > 1:
        return out, present_k, present_v
    return out


@op("Attention")
def _contrib_attention(ctx, x, weights, bias=None, mask_index=None,
                       past=None, attention_bias=None,
                       past_sequence_length=None):
    """com.microsoft Attention: the fused BERT self-attention block (input
    projection and multi-head attention): equal Q/K/V widths, ``[B]``
    lengths or ``[B, T]`` / broadcastable 0/1 key masks, an additive
    attention_bias, unidirectional, the stacked ``[2, B, N, P, D]``
    past/present cache. The standard opset-23 Attention shares the
    op_type; its second input is not a 2-D weight, and it goes to
    :func:`_standard_attention`."""
    if weights is None or np.ndim(weights) != 2:
        return _standard_attention(ctx, x, weights, bias, mask_index,
                                   past, attention_bias)
    num_heads = int(ctx.attr("num_heads", 0))
    if num_heads <= 0:
        raise ValueError("Attention needs the num_heads attribute")
    sizes = ctx.attr("qkv_hidden_sizes")
    if sizes and len(set(int(v) for v in sizes)) != 1:
        raise NotImplementedError(
            "Attention with asymmetric qkv_hidden_sizes is not "
            "supported; re-export with equal Q/K/V widths")
    if int(ctx.attr("past_present_share_buffer", 0)) \
            or past_sequence_length is not None:
        raise NotImplementedError(
            "Attention with past_present_share_buffer (max-length cache "
            "buffer + past_sequence_length) is not supported: the cached "
            "length would be read from the buffer dimension and attend "
            "uninitialized rows; re-export with a dense (unshared) past")
    x = _tensor(x)
    dev = x.device
    b, s, _ = x.shape
    w = _tensor(weights, dev)
    hidden = w.shape[1] // 3
    head = hidden // num_heads
    qkv = _matmul(ctx, x, w)
    if bias is not None:
        qkv = _bin(operator.add, qkv, bias)
    q, k, v = torch.chunk(qkv, 3, dim=-1)

    def heads(t):
        return t.reshape(b, s, num_heads, head).transpose(1, 2)

    q, k, v = heads(q), heads(k), heads(v)          # [B, N, S, D]
    past_len = 0
    if past is not None:
        p = _tensor(past, dev)                      # [2, B, N, P, D]
        past_len = p.shape[3]
        k = torch.cat([p[0].to(k.dtype), k], dim=2)
        v = torch.cat([p[1].to(v.dtype), v], dim=2)
    t_kv = k.shape[2]
    scale = ctx.attr("scale", 0.0) or 1.0 / math.sqrt(head)
    logits = _grouped_scores(q, k, num_heads, scale)[:, :, 0]
    if attention_bias is not None:
        logits = logits + _tensor(attention_bias, dev).to(torch.float32)
    neg = torch.full((), ctx.attr("mask_filter_value", -10000.0),
                     dtype=torch.float32, device=dev)
    k_pos = torch.arange(t_kv, device=dev)
    if mask_index is not None:
        m = _tensor(mask_index, dev)
        if m.ndim == 1 and m.shape[0] != b:
            raise NotImplementedError(
                f"Attention 1-D mask_index has {m.shape[0]} entries for "
                f"batch {b}: the (2*batch,) end/start left-padding format "
                "is not supported; re-export with a [batch] lengths "
                "vector or a [batch, seq] key mask")
        if m.ndim == 1:                             # [B] valid-key lengths
            ok = k_pos[None, :] < m.to(torch.int64)[:, None]
            logits = logits + _additive_key_mask(ok[:, None, None, :], neg)
        else:                                       # 0/1 key mask
            # right-align onto [B, N, S, T]: [B,T] -> [B,1,1,T],
            # [B,S,T] -> [B,1,S,T], 4-D passes through
            m2 = m.reshape((b,) + (1,) * (4 - m.ndim) + tuple(m.shape[1:]))
            logits = logits + _additive_key_mask(m2 != 0, neg)
    if ctx.attr("unidirectional", 0):
        q_pos = past_len + torch.arange(s, device=dev)[:, None]
        logits = logits + _additive_key_mask(k_pos[None, :] <= q_pos, neg)
    probs = torch.softmax(logits, dim=-1)
    out = _merge_heads(_grouped_values(probs[:, :, None], v), x.dtype)
    if ctx.n_outputs > 1:
        return out, torch.stack([k, v], dim=0)
    return out


# ---------------------------------------------------------------------------
# com.microsoft transformer-fusion family: what onnxruntime's transformer
# optimizer rewrites BERT/GPT graphs into. Each fused node lowers to what
# its unfused composition would; the contrib layer norms normalize in
# float32 whatever the input dtype, as ORT does.
# ---------------------------------------------------------------------------

@op("FusedMatMul")
def _fused_matmul(ctx, a, b):
    if int(ctx.attr("transBatchA", 0)) or int(ctx.attr("transBatchB", 0)):
        raise NotImplementedError(
            "FusedMatMul transBatchA/transBatchB (batch-axis folding) is "
            "not supported; re-export without batch transpose")
    a, b = _operands((a, b), scalars=False)
    if int(ctx.attr("transA", 0)):
        a = a.transpose(-1, -2)
    if int(ctx.attr("transB", 0)):
        b = b.transpose(-1, -2)
    y = torch.matmul(a, b)
    return y * _scalar(float(ctx.attr("alpha", 1.0)), y.dtype)


@op("BiasGelu")
def _bias_gelu(ctx, x, bias):
    return F.gelu(_bin(operator.add, x, bias))


@op("FastGelu")
def _fast_gelu(ctx, x, bias=None):
    x = _tensor(x)
    if bias is not None:
        x = _bin(operator.add, x, bias)
    return F.gelu(x, approximate="tanh")


@op("QuickGelu")
def _quick_gelu(ctx, x):
    x = _tensor(x)
    return x * torch.sigmoid(x * _scalar(float(ctx.attr("alpha", 1.702)),
                                         x.dtype))


def _rms_norm(x, scale, eps, dims):
    x = _tensor(x)
    x32 = x.to(torch.float32)
    ms = torch.mean(x32 * x32, dim=dims, keepdim=True)
    inv = torch.rsqrt(ms + eps)
    scale = _tensor(scale, x.device).to(torch.float32)
    return (x32 * inv * scale).to(x.dtype), inv


@op("SimplifiedLayerNormalization", "RMSNormalization")
def _simplified_layer_norm(ctx, x, scale):
    """RMSNorm: ORT's contrib name for it and the opset-23 standard one
    (same signature and attributes)."""
    axis = int(ctx.attr("axis", -1)) % np.ndim(x)
    y, inv = _rms_norm(x, scale, ctx.attr("epsilon", 1e-5),
                       tuple(range(axis, np.ndim(x))))
    return (y, inv)[: ctx.n_outputs] if ctx.n_outputs > 1 else y


def _ln_affine(h, gamma, beta, eps):
    """The fusion family's float32 layer norm. Returns (y, mean,
    inv_std), y cast back to ``h``'s dtype; the variance is the mean of
    squared deviations, as ``jnp.var`` forms it."""
    h32 = h.to(torch.float32)
    mean = torch.mean(h32, dim=-1, keepdim=True)
    c = h32 - mean
    inv = torch.rsqrt(torch.mean(c * c, dim=-1, keepdim=True) + eps)
    y = c * inv * _tensor(gamma, h.device).to(torch.float32)
    if beta is not None:
        y = y + _tensor(beta, h.device).to(torch.float32)
    return y.to(h.dtype), mean, inv


def _skip_sum(x, skip, bias):
    h = _bin(operator.add, x, skip)
    return h if bias is None else _bin(operator.add, h, bias)


@op("SkipSimplifiedLayerNormalization")
def _skip_simplified_layer_norm(ctx, x, skip, gamma, bias=None):
    h = _skip_sum(x, skip, bias)
    y, inv = _rms_norm(h, gamma, ctx.attr("epsilon", 1e-5), -1)
    if ctx.n_outputs > 1:
        # slot 2 ("mean") is defined on the summed input though the RMS
        # normalization itself takes no mean
        mean = torch.mean(h.to(torch.float32), dim=-1, keepdim=True)
        return (y, mean, inv, h)[: ctx.n_outputs]
    return y


@op("SkipLayerNormalization")
def _skip_layer_norm(ctx, x, skip, gamma, beta=None, bias=None):
    h = _skip_sum(x, skip, bias)
    y, mean, inv = _ln_affine(h, gamma, beta, ctx.attr("epsilon", 1e-5))
    if ctx.n_outputs > 1:
        return (y, mean, inv, h)[: ctx.n_outputs]
    return y


@op("EmbedLayerNormalization")
def _embed_layer_norm(ctx, input_ids, segment_ids=None, word_emb=None,
                      pos_emb=None, seg_emb=None, gamma=None, beta=None,
                      mask=None, position_ids=None):
    """com.microsoft EmbedLayerNormalization: the BERT front-end fusion
    (word + position + segment gather, layer norm, mask length)."""
    ids = _tensor(input_ids).to(torch.int64)
    dev = ids.device
    b, s = ids.shape
    emb = _rows(_tensor(word_emb, dev), ids)
    if position_ids is not None:
        pos = _tensor(position_ids, dev).to(torch.int64)
        pos = pos.reshape(-1, s).expand(b, s)
    else:
        pos = torch.arange(s, device=dev).expand(b, s)
    emb = _bin(operator.add, emb, _rows(_tensor(pos_emb, dev), pos))
    if seg_emb is not None:
        if segment_ids is None:
            raise ValueError(
                "EmbedLayerNormalization has a segment embedding but no "
                "segment_ids input")
        seg = _tensor(segment_ids, dev).to(torch.int64)
        emb = _bin(operator.add, emb, _rows(_tensor(seg_emb, dev), seg))
    y, _, _ = _ln_affine(emb, gamma, beta, ctx.attr("epsilon", 1e-12))
    if mask is not None:
        mask_index = torch.sum(_tensor(mask, dev).to(torch.int32), dim=1,
                               dtype=torch.int32)
    else:
        mask_index = torch.zeros((b,), dtype=torch.int32, device=dev)
    if ctx.n_outputs > 2:
        return y, mask_index, emb
    return y, mask_index


# ---------------------------------------------------------------------------
# Resize / Upsample
# ---------------------------------------------------------------------------
#
# The reference's Resize is ``jax.image.resize`` but for ``nearest`` under
# ``asymmetric``, and not ``F.interpolate``: ``linear`` and ``cubic``
# downsample with an antialiasing kernel, ``cubic`` is Keys' with a = -0.5,
# weights are renormalised at the borders, and ``nearest`` under
# ``half_pixel`` reads ``floor((i + 0.5) * in / out)``. Each axis here is a
# gather through a host-built index or a product with a host-built
# ``[in, out]`` weight matrix (``compute_weight_mat`` of
# ``jax/_src/image/scale.py``), both made once per shape (:func:`_table`).

def _nearest_asymmetric(n_in: int, n_out: int, mode: str) -> np.ndarray:
    """``in[round(i * in / out)]`` with ``mode``'s rounding: the opset-10
    and ``Upsample`` convention that torch exports by default."""
    pos = np.arange(n_out) * (n_in / n_out)
    if mode in ("floor", ""):
        idx = np.floor(pos)
    elif mode == "ceil":
        idx = np.ceil(pos)
    elif mode == "round_prefer_ceil":
        idx = np.floor(pos + 0.5)
    else:  # round_prefer_floor (the spec's default)
        idx = np.ceil(pos - 0.5)
    return np.clip(idx, 0, n_in - 1).astype(np.int64)


def _nearest_half_pixel(n_in: int, n_out: int) -> np.ndarray:
    """``jax.image.resize``'s nearest: ``floor((i + 0.5) * in / out)`` in
    float32."""
    f32 = np.float32
    pos = (np.arange(n_out, dtype=f32) + f32(0.5)) * f32(n_in) / f32(n_out)
    return np.floor(pos).astype(np.int64)


def _keys_cubic(x: np.ndarray) -> np.ndarray:
    out = ((1.5 * x - 2.5) * x) * x + 1.0
    out = np.where(x >= 1.0, ((-0.5 * x + 2.5) * x - 4.0) * x + 2.0, out)
    return np.where(x >= 2.0, 0.0, out)


_RESIZE_KERNELS = {"linear": lambda x: np.maximum(0.0, 1.0 - np.abs(x)),
                   "cubic": _keys_cubic}


def _resize_weights(n_in: int, n_out: int, method: str) -> np.ndarray:
    """The ``[n_in, n_out]`` float32 weights of one axis: the kernel at
    each (input, sample) distance, widened by ``1 / scale`` when
    shrinking, each column divided by its sum (zero where the sum is
    within 1000 eps32 of 0), zero where the sample lies outside the
    input."""
    f32 = np.float32
    inv_scale = f32(1.0) / f32(n_out / n_in)
    kernel_scale = max(inv_scale, f32(1.0))
    sample = (np.arange(n_out, dtype=f32) + f32(0.5)) * inv_scale - f32(0.5)
    x = np.abs(sample[None, :] - np.arange(n_in, dtype=f32)[:, None]) \
        / kernel_scale
    w = _RESIZE_KERNELS[method](x).astype(f32)
    total = w.sum(axis=0, keepdims=True)
    w = np.where(np.abs(total) > 1000.0 * np.finfo(f32).eps,
                 w / np.where(total != 0, total, f32(1.0)), f32(0.0))
    inside = (sample >= -0.5) & (sample <= n_in - 0.5)
    return np.where(inside[None, :], w, f32(0.0)).astype(f32)


def _resize_nearest(ctx, x: torch.Tensor, out_shape, index, key):
    """Each axis whose size changes gathered through ``index(in, out)``."""
    for axis, o in enumerate(out_shape[:x.ndim]):
        i = x.shape[axis]
        if o != i:
            idx = _table(ctx, (key, i, o), x.device, lambda: index(i, o))
            x = x.index_select(axis, idx)
    return x


def _resize_kernel(ctx, x: torch.Tensor, out_shape, method: str):
    """``jax.image.resize(x, out_shape, method)`` for ``linear`` and
    ``cubic`` (antialiased): each axis whose size changes contracted with
    its weight matrix, in x's float dtype (float32 for an integer x)."""
    if len(out_shape) != x.ndim:
        raise ValueError("shape must have length equal to the number of "
                         f"dimensions of x;  {out_shape} vs {x.shape}")
    if not x.is_floating_point():
        x = x.to(torch.float32)
    for axis, o in enumerate(out_shape):
        i = x.shape[axis]
        if o != i:
            w = _table(ctx, (method, i, o), x.device,
                       lambda: _resize_weights(i, o, method), x.dtype)
            x = torch.matmul(x.movedim(axis, -1), w).movedim(-1, axis)
    return x


@op("Resize")
def _resize(ctx, x, roi=None, scales=None, sizes=None):
    """The reference's Resize. ``roi``, ``cubic_coeff_a``,
    ``exclude_outside``, ``extrapolation_value``, ``antialias``,
    ``axes``, ``keep_aspect_ratio_policy`` and ``pytorch_half_pixel``'s
    rule for an output of size 1 are not read, as in the reference; a
    mode other than ``nearest`` + ``asymmetric`` and the half-pixel
    family raises."""
    mode = ctx.attr("mode", "nearest")
    coord = ctx.attr("coordinate_transformation_mode", "half_pixel")
    x = _tensor(x)
    if sizes is not None and np.asarray(sizes).size:
        out_shape = _static_int_list(sizes, "Resize sizes")
    else:
        sc = np.asarray(scales).reshape(-1)
        out_shape = [int(math.floor(s * f)) for s, f in zip(x.shape, sc)]
    if mode == "nearest" and coord == "asymmetric":
        nearest = ctx.attr("nearest_mode", "round_prefer_floor")
        return _resize_nearest(
            ctx, x, out_shape,
            lambda i, o: _nearest_asymmetric(i, o, nearest),
            ("asymmetric", nearest))
    if coord not in ("half_pixel", "pytorch_half_pixel"):
        raise NotImplementedError(
            f"Resize coordinate_transformation_mode={coord!r} with "
            f"mode={mode!r} is not supported (half_pixel family and "
            "nearest+asymmetric are)")
    method = {"nearest": "nearest", "linear": "linear", "cubic": "cubic"}[mode]
    if method == "nearest":
        if len(out_shape) != x.ndim:
            raise ValueError("shape must have length equal to the number "
                             f"of dimensions of x;  {out_shape} vs "
                             f"{x.shape}")
        return _resize_nearest(ctx, x, out_shape, _nearest_half_pixel,
                               "half_pixel")
    return _resize_kernel(ctx, x, out_shape, method)


@op("Upsample")
def _upsample(ctx, x, scales=None):
    """``nearest`` reads ``in[floor(i * in / out)]``; any other mode is
    the reference's half-pixel, antialiased ``linear`` (the spec's
    ``linear`` is asymmetric)."""
    if scales is None:
        scales = ctx.attr("scales")
    x = _tensor(x)
    sc = np.asarray(scales).reshape(-1)
    out_shape = [int(math.floor(s * f)) for s, f in zip(x.shape, sc)]
    if ctx.attr("mode", "nearest") == "nearest":
        return _resize_nearest(
            ctx, x, out_shape,
            lambda i, o: _nearest_asymmetric(i, o, "floor"),
            ("asymmetric", "floor"))
    return _resize_kernel(ctx, x, out_shape, "linear")


# ---------------------------------------------------------------------------
# Image layout: CenterCropPad, Col2Im
# ---------------------------------------------------------------------------

@op("CenterCropPad")
def _center_crop_pad(ctx, x, shape):
    """Each listed axis cropped about its centre (the odd cell left at
    the low side) or padded with zeros (the odd cell at the high side); a
    host value stays on the host, as in the reference."""
    target = _static_int_list(shape, "CenterCropPad shape")
    axes = ctx.attr("axes")
    if axes is None:
        axes = list(range(len(target)))
    host = _is_host(x)
    if host:
        x = np.asarray(x)
    for ax, want in zip(axes, target):
        ax %= x.ndim
        have = x.shape[ax]
        if want < have:
            lo = (have - want) // 2
            x = (np.take(x, range(lo, lo + want), axis=ax) if host
                 else x.narrow(ax, lo, want))
        elif want > have:
            lo = (want - have) // 2
            width = [(0, 0)] * x.ndim
            width[ax] = (lo, want - have - lo)
            x = np.pad(x, width) if host else _pad(x, width)
    return x


def _col2im_cells(img, blk, strides, dil, pads, outs):
    """The flat image cell of each (block offset, column) pair, clamped
    into the image, and whether the pair lies inside it (``[K, L]``)."""
    rank = len(img)
    kprod, n_cols = math.prod(blk), math.prod(outs)
    k_idx = np.stack(np.unravel_index(np.arange(kprod), blk), 0)
    l_idx = np.stack(np.unravel_index(np.arange(n_cols), outs), 0)
    flat = np.zeros((kprod, n_cols), np.int64)
    valid = np.ones((kprod, n_cols), bool)
    for d in range(rank):
        pos = (k_idx[d][:, None] * dil[d] + l_idx[d][None, :] * strides[d]
               - pads[d])
        valid &= (pos >= 0) & (pos < img[d])
        flat = flat * img[d] + np.clip(pos, 0, img[d] - 1)
    return flat.reshape(-1), valid.reshape(-1)


@op("Col2Im")
def _col2im(ctx, x, image_shape, block_shape):
    """Column blocks added back into the image, any number of spatial
    dims: the columns outside the image multiplied by 0 (a NaN stays
    NaN, as in the reference) and every column added at its clamped cell
    with one ``index_add_`` (``F.fold`` is 2-D only)."""
    img = _static_int_list(image_shape, "Col2Im image_shape")
    blk = _static_int_list(block_shape, "Col2Im block_shape")
    rank = len(img)
    strides = ctx.attr("strides", [1] * rank)
    dil = ctx.attr("dilations", [1] * rank)
    pads = ctx.attr("pads", [0] * (2 * rank))
    x = _tensor(x)
    n, ckk, n_cols = x.shape
    kprod = math.prod(blk)
    c = ckk // kprod
    outs = [1 + (img[d] + pads[d] + pads[d + rank]
                 - dil[d] * (blk[d] - 1) - 1) // strides[d]
            for d in range(rank)]
    if math.prod(outs) != n_cols:
        raise ValueError(
            f"Col2Im: {n_cols} columns do not factor into positions {outs}")
    key = ("col2im", tuple(img), tuple(blk), tuple(strides), tuple(dil),
           tuple(pads))
    args = (img, blk, strides, dil, pads, outs)
    flat = _table(ctx, key + ("cell",), x.device,
                  lambda: _col2im_cells(*args)[0])
    valid = _table(ctx, key + ("valid",), x.device,
                   lambda: _col2im_cells(*args)[1], x.dtype)
    out = x.new_zeros((n, c, math.prod(img)))
    out.index_add_(2, flat, x.reshape(n, c, -1) * valid)
    return out.reshape((n, c) + tuple(img))


# ---------------------------------------------------------------------------
# Detection ops: NonMaxSuppression, RoiAlign, MaxRoiPool, DeformConv,
# GridSample, AffineGrid, ImageDecoder
# ---------------------------------------------------------------------------
# Where the reference narrows a float to an int32 index (``astype``), XLA
# truncates toward zero, saturates at the int32 range and sends NaN to 0;
# a traced ``jnp`` gather wraps a negative index once, then clamps it.
# Torch's cast differs there (the CPU's gives -2^31 for NaN, +-1e10 and
# inf alike) and an index out of range on the card is a device assert, so
# these ops settle each index on the device (:func:`_int32_of`,
# :func:`_wrap_clamp`) before it reaches a gather, with no host read.

def _int32_of(x: torch.Tensor) -> torch.Tensor:
    """``x.astype(jnp.int32)`` of a float tensor, as int64: toward zero,
    NaN to 0, saturated at the int32 range."""
    x = torch.nan_to_num(x, nan=0.0).clamp(-2.0 ** 31, 2.0 ** 31)
    return x.to(torch.int64).clamp(max=2 ** 31 - 1)


def _wrap_int32(i: torch.Tensor) -> torch.Tensor:
    """An int64 result wrapped as int32 arithmetic wraps it."""
    return (i + 2 ** 31) % 2 ** 32 - 2 ** 31


def _wrap_clamp(i: torch.Tensor, n: int) -> torch.Tensor:
    """A traced ``jnp`` gather's index into an axis of ``n``: a negative
    one counts from the end once, then it is clamped into the axis."""
    return torch.where(i < 0, i + n, i).clamp(0, n - 1)


def _round_away(x: torch.Tensor) -> torch.Tensor:
    """``lax.round``: half away from zero (``torch.round`` takes half to
    even); NaN and inf stay."""
    t = x.trunc()
    return torch.where((x - t).abs() >= 0.5, t + x.sign(), t)


def _div(x: torch.Tensor, n) -> torch.Tensor:
    """``x / n`` correctly rounded on every device: CUDA divides a tensor
    by a host scalar as a multiply by its reciprocal, which rounds
    otherwise than the CPU and the reference (a quantized bin edge would
    move), so ``n`` is made a 0-d tensor on ``x``'s device first (a fill,
    no copy)."""
    return x / torch.full((), n, dtype=x.dtype, device=x.device)


def _host_scalar(x) -> np.ndarray:
    """A scalar input's value on the host; a tensor is read back, as the
    reference reads a device array with ``np.asarray``."""
    if isinstance(x, torch.Tensor):
        x = x.cpu().numpy()
    return np.asarray(x).reshape(())


def _nms_iou_corners(boxes, center_point_box):
    """``[..., N, 4]`` -> (y1, x1, y2, x2) corners and areas, per ONNX NMS
    conventions (corner coordinates may arrive in either diagonal order;
    center format is [x_c, y_c, w, h]); numpy or torch, as ``boxes`` is."""
    if center_point_box:
        xc, yc, w, h = (boxes[..., 0], boxes[..., 1], boxes[..., 2],
                        boxes[..., 3])
        y1, y2 = yc - h / 2, yc + h / 2
        x1, x2 = xc - w / 2, xc + w / 2
    else:
        xp = np if _is_host(boxes) else torch
        y1 = xp.minimum(boxes[..., 0], boxes[..., 2])
        y2 = xp.maximum(boxes[..., 0], boxes[..., 2])
        x1 = xp.minimum(boxes[..., 1], boxes[..., 3])
        x2 = xp.maximum(boxes[..., 1], boxes[..., 3])
    area = (y2 - y1) * (x2 - x1)
    return y1, x1, y2, x2, area


def _nms_host(boxes, scores, max_out, iou_th, score_th, center):
    """Exact ONNX semantics on host data: [num_selected, 3] int64 rows of
    (batch, class, box), per-class score-descending selection order (the
    reference's host path, verbatim)."""
    nb, nc, n = scores.shape
    rows = []
    for bi in range(nb):
        y1, x1, y2, x2, area = _nms_iou_corners(boxes[bi], center)
        for ci in range(nc):
            s = scores[bi, ci]
            cand = np.argsort(-s, kind="stable")
            if score_th is not None:
                cand = cand[s[cand] > score_th]
            chosen: List[int] = []
            for i in cand:
                if len(chosen) >= max_out:
                    break
                ok = True
                for j in chosen:
                    yy1 = max(y1[i], y1[j]); xx1 = max(x1[i], x1[j])  # noqa: E702
                    yy2 = min(y2[i], y2[j]); xx2 = min(x2[i], x2[j])  # noqa: E702
                    inter = max(0.0, yy2 - yy1) * max(0.0, xx2 - xx1)
                    union = area[i] + area[j] - inter
                    if union > 0 and inter / union > iou_th:
                        ok = False
                        break
                if ok:
                    chosen.append(int(i))
            rows.extend([bi, ci, i] for i in chosen)
    return (np.asarray(rows, np.int64).reshape(-1, 3) if rows
            else np.zeros((0, 3), np.int64))


def _nms_device(boxes: torch.Tensor, scores: torch.Tensor, n_max: int,
                iou: float, sth: Optional[float], center) -> torch.Tensor:
    """The reference's fixed-capacity NMS, every (batch, class) at once:
    ``n_max`` steps of an argmax over the live scores (the first index on
    ties) and a suppression of the live boxes that overlap the pick
    (``inter > iou * union`` and ``union > 0``, each product and sum
    rounded to float32 on its own, as the reference's scan body does). A
    pick that is not above -inf (a NaN among the live scores, or none
    left) ends its class. ``[B * C * n_max, 3]`` int64 rows, ``-1`` rows
    for unused slots. Nothing is read on the host."""
    nb, nc, n = scores.shape
    dev = scores.device
    y1, x1, y2, x2, area = _nms_iou_corners(boxes, center)      # [B, N]
    table = torch.stack([y1, x1, y2, x2, area], -1)             # [B, N, 5]
    lo = torch.stack([y1, x1], -1)[:, None]                     # [B, 1, N, 2]
    hi = torch.stack([y2, x2], -1)[:, None]
    area = area[:, None]                                        # [B, 1, N]
    alive = (scores > float(np.float32(sth)) if sth is not None
             else torch.ones_like(scores, dtype=torch.bool))
    iou = float(np.float32(iou))
    picks, valids = [], []
    for _ in range(n_max):
        best, i = torch.where(alive, scores, -math.inf).max(-1)     # [B, C]
        valid = best > -math.inf
        p = table.gather(1, i[..., None].expand(nb, nc, 5))[:, :, None]
        d = (torch.minimum(hi, p[..., 2:4])
             - torch.maximum(lo, p[..., 0:2])).clamp_min(0.0)
        inter = d[..., 0] * d[..., 1]                            # [B, C, N]
        union = area + p[..., 4] - inter
        sup = (inter > iou * union) & (union > 0)
        alive = alive > sup                   # alive and not suppressed
        alive.scatter_(-1, i[..., None], False)
        alive &= valid[..., None]
        picks.append(i)
        valids.append(valid)
    sel = torch.where(torch.stack(valids, -1), torch.stack(picks, -1), -1)
    bi = torch.arange(nb, device=dev)[:, None, None].expand_as(sel)
    ci = torch.arange(nc, device=dev)[None, :, None].expand_as(sel)
    out = torch.stack([bi, ci, sel], -1).reshape(-1, 3)
    return torch.where(out[:, 2:] < 0, -1, out)


@op("NonMaxSuppression")
def _non_max_suppression(ctx, boxes, scores, max_out=None, iou_th=None,
                         score_th=None):
    """ONNX NMS, the reference's two paths. Host inputs get the exact,
    data-dependent ``[num_selected, 3]`` (:func:`_nms_host`: a stable
    argsort, ``inter / union > iou``). Device inputs get the
    fixed-capacity ``[B * C * max_out, 3]`` of :func:`_nms_device`, in the
    same (batch, class, score-descending) order, unused slots ``-1`` rows
    (consumers mask on the first column). Rows are int64, as the spec
    says (the reference narrows them to int32). ``max_out`` absent or not
    positive gives a host ``zeros((0, 3))``."""
    center = ctx.attr("center_point_box", 0)
    n_max = 0 if max_out is None else int(_host_scalar(max_out))
    iou = 0.0 if iou_th is None else float(_host_scalar(iou_th))
    sth = None if score_th is None else float(_host_scalar(score_th))
    if n_max <= 0:
        return np.zeros((0, 3), np.int64)
    if _all_host((boxes, scores)):
        return _nms_host(np.asarray(boxes, np.float32),
                         np.asarray(scores, np.float32),
                         n_max, iou, sth, center)
    scores = _tensor(scores).to(torch.float32)
    boxes = _tensor(boxes, scores.device).to(torch.float32)
    return _nms_device(boxes, scores, n_max, iou, sth, center)


def _roi_offsets(n: int, sr: int) -> np.ndarray:
    """RoiAlign's sample offsets along an axis of ``n`` bins, in bins:
    ``i + (j + 0.5) / sr`` for bin i and sample j, in float32."""
    f32 = np.float32
    return (np.arange(n, dtype=f32)[:, None]
            + (np.arange(sr, dtype=f32) + f32(0.5)) / f32(sr)).reshape(-1)


def _roi_axis(g: torch.Tensor, size: int):
    """The reference's per-axis bilinear terms of sample positions ``g``:
    the lower and upper cell (clamped into the axis), the upper weight,
    and whether the sample lies outside ``[-1, size]``."""
    outside = (g < -1.0) | (g > size)
    gc = g.clamp(0, size - 1)
    lo = _int32_of(torch.floor(gc))
    hi = (lo + 1).clamp(max=size - 1)
    return lo, hi, gc - lo.to(g.dtype), outside


@op("RoiAlign")
def _roi_align(ctx, x, rois, batch_indices):
    """ONNX RoiAlign, the rows of the reference's roi-by-roi ``vmap`` with
    every roi in one pass: each roi's ``sr`` x ``sr`` samples a bin, four
    row gathers of the channels-last map a sample, lerped along x, then
    y, in the reference's order; a sample outside ``[-1, size]`` is 0;
    ``mode="max"`` is the max of the bilinear samples (the spec takes
    the max of weighted corners). ``output_half_pixel`` (opset < 16, and
    torchvision's ``aligned=False`` export) clamps a roi's sides at 1
    pixel. A ``batch_indices`` value out of range reads as the
    reference's traced gather does (wrap once, then clamp).
    ``sampling_ratio=0`` raises, as in the reference."""
    mode = ctx.attr("mode", "avg")
    oh, ow = ctx.attr("output_height", 1), ctx.attr("output_width", 1)
    sr = int(ctx.attr("sampling_ratio", 0))
    scale = ctx.attr("spatial_scale", 1.0)
    ctm = ctx.attr("coordinate_transformation_mode",
                   "half_pixel" if ctx.opset >= 16 else "output_half_pixel")
    if sr <= 0:
        raise NotImplementedError(
            "RoiAlign with sampling_ratio=0 sizes its sampling grid from "
            "roi extents (data-dependent shapes); re-export with an "
            "explicit sampling_ratio (torchvision/detectron2 use 2)")
    x = _tensor(x).to(torch.float32)
    dev = x.device
    rois = _tensor(rois, dev).to(torch.float32)
    bidx = _tensor(batch_indices, dev)
    n, c, h, w = x.shape
    bidx = _wrap_clamp(_int32_of(bidx) if bidx.is_floating_point()
                       else bidx.to(torch.int64), n)
    off = 0.5 if ctm == "half_pixel" else 0.0
    scale = float(np.float32(scale))
    x1, y1, x2, y2 = (rois[:, k] * scale - off for k in range(4))
    rw, rh = x2 - x1, y2 - y1
    if ctm != "half_pixel":  # legacy mode clamps tiny rois to 1px
        rw, rh = rw.clamp_min(1.0), rh.clamp_min(1.0)
    ty = _table(ctx, ("roi_offsets", oh, sr), dev, lambda: _roi_offsets(oh, sr))
    tx = _table(ctx, ("roi_offsets", ow, sr), dev, lambda: _roi_offsets(ow, sr))
    ylo, yhi, fy, oy = _roi_axis(y1[:, None] + ty * _div(rh, oh)[:, None], h)
    xlo, xhi, fx, ox = _roi_axis(x1[:, None] + tx * _div(rw, ow)[:, None], w)
    pixels = x.permute(0, 2, 3, 1).reshape(n * h * w, c)
    base = bidx[:, None, None] * (h * w)

    def g2(yy, xx):                                  # [R, oh*sr, ow*sr, C]
        idx = base + yy[:, :, None] * w + xx[:, None, :]
        return pixels.index_select(0, idx.reshape(-1)).reshape(
            idx.shape + (c,))

    fx, fy = fx[:, None, :, None], fy[:, :, None, None]
    top = g2(ylo, xlo) * (1 - fx) + g2(ylo, xhi) * fx
    bot = g2(yhi, xlo) * (1 - fx) + g2(yhi, xhi) * fx
    val = top * (1 - fy) + bot * fy
    val = torch.where((oy[:, :, None] | ox[:, None, :])[..., None], 0.0, val)
    val = val.reshape(-1, oh, sr, ow, sr, c)
    val = val.amax((2, 4)) if mode == "max" else val.mean((2, 4))
    return val.permute(0, 3, 1, 2).contiguous()                  # [R, C, oh, ow]


# the largest masked piece of the feature map MaxRoiPool makes at once
_ROI_POOL_PIECE_BYTES = 1 << 28


def _roi_bins(lo, extent, n_bins: int, size: int) -> torch.Tensor:
    """``[R, n_bins, size]`` membership of each pixel in each quantized
    bin (the reference's clipped floor/ceil bins, in float32)."""
    b = torch.arange(n_bins, dtype=torch.float32, device=lo.device)
    bin_sz = _div(extent, n_bins)[:, None]
    start = (torch.floor(b * bin_sz) + lo[:, None]).clamp(0, size)
    end = (torch.ceil((b + 1) * bin_sz) + lo[:, None]).clamp(0, size)
    pix = torch.arange(size, dtype=torch.float32, device=lo.device)
    return (pix >= start[..., None]) & (pix < end[..., None])


@op("MaxRoiPool")
def _max_roi_pool(ctx, x, rois):
    """MaxRoiPool (Caffe/Fast R-CNN ROIPooling): hard-quantized roi bins
    (``round``, half to even, of the roi and its batch column), max-pooled
    as two masked per-axis maxes; an empty bin gives 0, a NaN propagates.
    The reference masks ``[R, C, ph, H, W]`` at once; the port takes the
    same maxes a few rois at a time, so no piece passes
    ``_ROI_POOL_PIECE_BYTES`` (any order of a max is exact)."""
    ph, pw = [int(v) for v in ctx.attr("pooled_shape")]
    scale = float(np.float32(ctx.attr("spatial_scale", 1.0)))
    x = _tensor(x).to(torch.float32)
    rois = _tensor(rois, x.device).to(torch.float32)
    n, c, h, w = x.shape
    bidx = _wrap_clamp(_int32_of(torch.round(rois[:, 0])), n)
    x1, y1, x2, y2 = (torch.round(rois[:, k] * scale) for k in range(1, 5))
    mh = _roi_bins(y1, (y2 - y1 + 1.0).clamp_min(1.0), ph, h)   # [R, ph, H]
    mw = _roi_bins(x1, (x2 - x1 + 1.0).clamp_min(1.0), pw, w)   # [R, pw, W]
    step = max(1, _ROI_POOL_PIECE_BYTES
               // (4 * c * max(h * w, ph * pw * w)))
    out = []
    for r in range(0, rois.shape[0], step):
        part = slice(r, r + step)
        fmap = x.index_select(0, bidx[part])                    # [r, C, H, W]
        t = torch.stack([
            torch.where(mh[part, k, None, :, None], fmap, -math.inf).amax(2)
            for k in range(ph)], 2)                             # [r, C, ph, W]
        out.append(torch.where(mw[part, None, None], t[:, :, :, None],
                               -math.inf).amax(4))              # [r, C, ph, pw]
    out = torch.cat(out) if out else x.new_zeros((0, c, ph, pw))
    return torch.where(torch.isneginf(out), 0.0, out)


def _deform_base(kh, kw, oh, ow, strides, dil, pads) -> np.ndarray:
    """DeformConv's sampling grid before the offsets, ``[2, k, p]`` (y, x)
    as float32."""
    ker_y = (np.arange(kh)[:, None] * dil[0]).repeat(kw, 1).reshape(-1)
    ker_x = np.tile(np.arange(kw) * dil[1], kh)
    return np.stack([
        ker_y[:, None] + (np.arange(oh) * strides[0]
                          - pads[0]).repeat(ow)[None, :],
        ker_x[:, None] + np.tile(np.arange(ow) * strides[1]
                                 - pads[1], oh)[None, :]]).astype(np.float32)


@op("DeformConv")
def _deform_conv(ctx, x, w, offset, b=None, mask=None):
    """DeformConv (opset 19, torchvision ``deform_conv2d`` semantics), 2-D
    only: offsets ``(dy, dx)`` interleaved per kernel point and offset
    group, bilinear sampling with zero padding through the corners'
    validity test (in the reference's corner order), the optional
    modulation mask, then the grouped contraction as one float32
    ``einsum`` (IEEE float32 under :func:`_ieee_float32`, never TF32)."""
    if len(x.shape) != 4:
        raise NotImplementedError("DeformConv supports 2-D (NCHW) only")
    x = _tensor(x).to(torch.float32)
    dev = x.device
    w = _tensor(w, dev).to(torch.float32)
    offset = _tensor(offset, dev).to(torch.float32)
    n, c, h, wd = x.shape
    oc, cg_w, kh, kw = w.shape
    strides = [int(v) for v in ctx.attr("strides", [1, 1])]
    dil = [int(v) for v in ctx.attr("dilations", [1, 1])]
    pads = [int(v) for v in ctx.attr("pads", [0, 0, 0, 0])]
    group = int(ctx.attr("group", 1))
    og = int(ctx.attr("offset_group", 1))
    oh, ow = offset.shape[2], offset.shape[3]
    k, p, cg = kh * kw, oh * ow, c // og
    shape = (kh, kw, oh, ow, tuple(strides), tuple(dil), tuple(pads[:2]))
    base = _table(ctx, ("deform_base",) + shape, dev,
                  lambda: _deform_base(kh, kw, oh, ow, strides, dil, pads))
    off = offset.reshape(n, og, k, 2, p)
    py = base[0] + off[:, :, :, 0]                            # [N, og, k, p]
    px = base[1] + off[:, :, :, 1]
    y0, x0 = torch.floor(py), torch.floor(px)
    fy, fx = py - y0, px - x0
    x_r = x.reshape(n, og, cg, h * wd)

    def corner(yy, xx):
        valid = (yy >= 0) & (yy <= h - 1) & (xx >= 0) & (xx <= wd - 1)
        idx = (_int32_of(yy.clamp(0, h - 1)) * wd
               + _int32_of(xx.clamp(0, wd - 1)))
        g = x_r.gather(3, idx.reshape(n, og, 1, k * p).expand(
            n, og, cg, k * p)).reshape(n, og, cg, k, p)
        return g * valid.to(x.dtype).reshape(n, og, 1, k, p)

    samp = (corner(y0, x0) * ((1 - fy) * (1 - fx))[:, :, None]
            + corner(y0, x0 + 1) * ((1 - fy) * fx)[:, :, None]
            + corner(y0 + 1, x0) * (fy * (1 - fx))[:, :, None]
            + corner(y0 + 1, x0 + 1) * (fy * fx)[:, :, None])
    if mask is not None:
        samp = samp * _tensor(mask, dev).to(torch.float32).reshape(
            n, og, 1, k, p)
    samp = samp.reshape(n, group, c // group, k, p)
    w_g = w.reshape(group, oc // group, cg_w, k)
    out = torch.einsum("ngckp,gock->ngop", samp, w_g).reshape(n, oc, oh, ow)
    if b is not None:
        out = out + _tensor(b, dev).to(torch.float32)[None, :, None, None]
    return out


@op("GridSample")
def _grid_sample(ctx, x, grid):
    """Bilinear/nearest sampling of ``[N, C, H, W]`` at a [-1, 1] grid, as
    the reference's ``jax.scipy.ndimage.map_coordinates`` computes it, not
    ``F.grid_sample``: ``nearest`` rounds half away from zero; a corner's
    weight is the product of its per-axis weights, the corners summed in
    ``itertools.product`` order; an index is the saturated int32 cast of
    its coordinate (a NaN one reads cell 0), ``border`` clamps it,
    ``zeros`` zeroes a corner whose index is out of range; an integer
    input is rounded half away from zero and cast back."""
    mode = ctx.attr("mode", "bilinear")
    padding = ctx.attr("padding_mode", "zeros")
    align = bool(ctx.attr("align_corners", 0))
    if mode not in ("bilinear", "linear", "nearest"):
        raise NotImplementedError(f"GridSample mode {mode!r}")
    if padding not in ("zeros", "border"):
        raise NotImplementedError(f"GridSample padding_mode {padding!r}")
    if len(x.shape) != 4:
        raise NotImplementedError(
            "GridSample: only 4-D [N,C,H,W] input is supported "
            f"(got {len(x.shape)}-D)")
    x = _tensor(x)
    grid = _tensor(grid, x.device)
    n, c, h, w = x.shape
    zeros = padding == "zeros"

    def unnorm(g, size):
        if align:
            return (g + 1.0) * (size - 1) / 2.0
        return ((g + 1.0) * size - 1.0) / 2.0

    def nodes(coord, size):
        """(index for the gather, validity or None, weight or None)."""
        if mode == "nearest":
            pairs = [(_int32_of(_round_away(coord)), None)]
        else:
            lower = torch.floor(coord)
            upper = coord - lower
            index = _int32_of(lower)
            pairs = [(index, 1 - upper), (_wrap_int32(index + 1), upper)]
        return [(i.clamp(0, size - 1),
                 (i >= 0) & (i < size) if zeros else None, wt)
                for i, wt in pairs]

    planes = x.reshape(n, c, h * w)
    out_dt = torch.promote_types(x.dtype, torch.float32)
    result = None
    for (iy, vy, wy), (ix, vx, wx) in itertools.product(
            nodes(unnorm(grid[..., 1], h), h),
            nodes(unnorm(grid[..., 0], w), w)):
        flat = (iy * w + ix).reshape(n, 1, -1).expand(n, c, -1)
        got = planes.gather(2, flat).reshape((n, c) + iy.shape[1:])
        if zeros:
            got = torch.where((vy & vx)[:, None], got, 0)
        term = got.to(out_dt) * (1.0 if wy is None else (wy * wx)[:, None])
        result = term if result is None else result + term
    if x.is_floating_point():
        return result.to(x.dtype)
    result = _round_away(result)
    if x.dtype in (torch.int32, torch.int64):
        return _int32_of(result).to(x.dtype)
    info = torch.iinfo(x.dtype)
    return torch.nan_to_num(result, nan=0.0).clamp(info.min, info.max).to(
        x.dtype)


def _linspace_axis(n: int) -> np.ndarray:
    """``jnp.linspace(-1, 1, n)`` in float32 as XLA:CPU evaluates it outside
    its vectorized loop body (every point below 353 points): step ``k *
    fl(1 / (n - 1))``, ``1 - step`` rounded, the sum with ``stop * step``
    one FMA (emulated in float64); the last point is 1."""
    f32 = np.float32
    d = n - 1
    k = np.arange(d, dtype=f32)
    r = f32(1) / f32(d)
    one_minus = (1 - (k * r).astype(np.float64)).astype(f32)
    out = (k.astype(np.float64) * np.float64(r) - one_minus).astype(f32)
    return np.concatenate([out, np.ones(1, f32)])


def _affine_axis(n: int, align: bool) -> np.ndarray:
    """AffineGrid's base coordinates along an axis of ``n`` points, float32:
    ``linspace(-1, 1, n)`` under ``align_corners``, else the half-step
    formula ``-1 + step / 2 + step * k`` (the sum of the first two in
    float64, as the reference's Python floats are, then float32)."""
    if align:
        return _linspace_axis(n) if n > 1 else np.zeros((1,), np.float32)
    step = 2.0 / n
    return np.float32(-1.0 + step / 2) + np.float32(step) * np.arange(
        n, dtype=np.float32)


def _affine_points(spatial, align: bool) -> np.ndarray:
    """``[*spatial, rank + 1]`` homogeneous base points (x, y[, z], 1)."""
    mesh = np.meshgrid(*[_affine_axis(s, align) for s in spatial],
                       indexing="ij")
    return np.stack(list(reversed(mesh)) + [np.ones_like(mesh[0])], -1)


@op("AffineGrid")
def _affine_grid(ctx, theta, size):
    """Sampling-grid generator (opset 20), the ``F.affine_grid`` export, for
    4-D and 5-D sizes: the base points built on the host once per size
    (``_table``), then one float32 contraction with ``theta`` (IEEE)."""
    dims = _static_int_list(size, "AffineGrid size")
    align = bool(ctx.attr("align_corners", 0))
    theta = _tensor(theta).to(torch.float32)
    spatial = dims[2:]
    if len(spatial) not in (2, 3):
        raise NotImplementedError("AffineGrid supports 4-D/5-D sizes")
    pts = _table(ctx, ("affine_points", tuple(spatial), align), theta.device,
                 lambda: _affine_points(spatial, align))
    return torch.einsum("...k,njk->n...j", pts, theta)


@op("ImageDecoder")
def _image_decoder(ctx, encoded):
    """ImageDecoder (opset 20): host-side decode of an encoded image byte
    stream to ``[H, W, C]`` uint8 via PIL (RGB, BGR or Grayscale). Decoding
    is host work: a device tensor is refused."""
    if not _is_host(encoded):
        raise NotImplementedError(
            "ImageDecoder needs host bytes: image decoding cannot run on "
            "the device — decode ahead of the graph or feed host values")
    import io as _io

    try:
        from PIL import Image
    except ImportError as e:
        raise NotImplementedError(
            "ImageDecoder requires PIL for this codec") from e
    data = np.asarray(encoded, np.uint8).tobytes()
    img = Image.open(_io.BytesIO(data))
    fmt = str(ctx.attr("pixel_format", "RGB"))
    if fmt == "Grayscale":
        return np.asarray(img.convert("L"), np.uint8)[:, :, None]
    rgb = np.asarray(img.convert("RGB"), np.uint8)
    return rgb[:, :, ::-1] if fmt == "BGR" else rgb


# ---------------------------------------------------------------------------
# Random ops: RandomNormal, RandomNormalLike, RandomUniform,
# RandomUniformLike, Bernoulli, Multinomial, Dropout
# ---------------------------------------------------------------------------
# The draws are ``jax.random``'s (:mod:`synapseml_tpu_torch.onnx.random`),
# keyed per node as the reference keys them, so a bound graph draws the
# same numbers at every call, as the reference's does. Where the spec
# asks for a 64-bit type (``dtype`` 11, Multinomial's 7) the port keeps
# it; the reference, with JAX's 64-bit mode off, gives float32 and int32
# of the same values.

def _node_seed(ctx) -> int:
    """The reference's ``_node_key`` seed: the ``seed`` attribute, read as
    a float (an integral one masked to 31 bits, any other bit-cast through
    float32), else the crc32 of ``"name|op_type"``, masked alike."""
    seed = ctx.attr("seed")
    if seed is None:
        seed = zlib.crc32(f"{ctx.name}|{ctx.op_type}".encode())
    if float(seed).is_integer():
        return int(seed) & 0x7FFFFFFF
    return int(np.float32(seed).view(np.uint32))


def _node_key(ctx, dev: torch.device) -> torch.Tensor:
    """The node's ``PRNGKey`` on ``dev``, copied there once (a bound
    forward and a CUDA-graph capture copy nothing)."""
    return _table(ctx, "prng_key", dev,
                  lambda: np.array([0, _node_seed(ctx)], np.int64))


def _random_dtype(ctx, like=None) -> torch.dtype:
    """The ``dtype`` attribute's type, else ``like``'s, else float32."""
    dt = ctx.attr("dtype")
    if dt is not None:
        return _torch_dtype(proto.TENSOR_DTYPES[int(dt)])
    if isinstance(like, torch.Tensor):
        return like.dtype
    if like is not None:
        return _torch_dtype(_canonical(np.asarray(like).dtype))
    return torch.float32


def _random_normal_of(ctx, shape, dt: torch.dtype, dev) -> torch.Tensor:
    # the affine is two float32 steps, as the reference's eager forward
    # takes them (under jit XLA would fuse them)
    z = _random.normal(_node_key(ctx, dev), shape)
    return (z * float(ctx.attr("scale", 1.0))
            + float(ctx.attr("mean", 0.0))).to(dt)


def _random_uniform_of(ctx, shape, dt: torch.dtype, dev) -> torch.Tensor:
    return _random.uniform(_node_key(ctx, dev), shape,
                           float(ctx.attr("low", 0.0)),
                           float(ctx.attr("high", 1.0))).to(dt)


@op("RandomNormal")
def _random_normal(ctx):
    shape = tuple(int(s) for s in ctx.attr("shape"))
    return _random_normal_of(ctx, shape, _random_dtype(ctx), _device_of(()))


@op("RandomNormalLike")
def _random_normal_like(ctx, x):
    return _random_normal_of(ctx, tuple(np.shape(x)), _random_dtype(ctx, x),
                             _device_of((x,)))


@op("RandomUniform")
def _random_uniform(ctx):
    shape = tuple(int(s) for s in ctx.attr("shape"))
    return _random_uniform_of(ctx, shape, _random_dtype(ctx), _device_of(()))


@op("RandomUniformLike")
def _random_uniform_like(ctx, x):
    return _random_uniform_of(ctx, tuple(np.shape(x)),
                              _random_dtype(ctx, x), _device_of((x,)))


@op("Bernoulli")
def _bernoulli(ctx, x):
    x = _tensor(x)
    draws = _random.uniform(_node_key(ctx, x.device), tuple(x.shape))
    return (draws < x.float()).to(_random_dtype(ctx, x))


@op("Multinomial")
def _multinomial(ctx, x):
    """Multinomial: ``sample_size`` draws per batch row from unnormalized
    log-probabilities, ``jax.random.categorical``'s Gumbel-max: the first
    index of the largest ``x + gumbel`` over ``[B, n, C]`` noise in
    ``x``'s dtype (float32 for a 64-bit input, as the reference's)."""
    n = int(ctx.attr("sample_size", 1))
    dt = _torch_dtype(proto.TENSOR_DTYPES[int(ctx.attr("dtype", 6))])
    x = _tensor(x)
    if x.dtype not in (torch.float16, torch.bfloat16):
        x = x.float()
    noise = _random.gumbel(_node_key(ctx, x.device),
                           (x.shape[0], n, x.shape[1]), x.dtype)
    return torch.argmax(noise + x[:, None, :], dim=-1).to(dt)


@op("Dropout")
def _dropout(ctx, x, ratio=None, training_mode=None):
    """Dropout as the reference runs it: a pass-through (and an all-true
    mask where asked) whatever ``ratio`` and ``training_mode`` say."""
    if ctx.n_outputs > 1:
        return x, torch.ones(tuple(np.shape(x)), dtype=torch.bool,
                             device=_device_of((x,)))
    return x


# ---------------------------------------------------------------------------
# Signal ops: DFT, STFT, HannWindow, HammingWindow, BlackmanWindow,
# MelWeightMatrix
# ---------------------------------------------------------------------------
# A transform is one batched ``torch.fft`` call in complex64, as the
# reference's ``jnp.fft`` computes it: a half-precision input is widened
# first (cuFFT has float16 only at power-of-two lengths, the CPU none), a
# 64-bit one narrowed as JAX's 32-bit mode narrows it, and the spectrum is
# cast to the type the spec asks for. Where the spec asks for a 64-bit
# type (a float64 signal, ``output_datatype`` 11) the port keeps it,
# holding the reference's float32 values. The windows are host numpy
# constants, as in the reference; ``MelWeightMatrix`` is a device value,
# built on the host and copied once a node and device (``_table``).

def _spectrum(spec: torch.Tensor, dt: torch.dtype) -> torch.Tensor:
    """A complex64 spectrum as ``[..., 2]`` (re, im) in ``dt`` (the
    inverse of a real input comes back as a lazy conjugate: resolved)."""
    out = torch.view_as_real(spec.resolve_conj())
    return out if out.dtype == dt else out.to(dt)


def _narrow(x: torch.Tensor) -> torch.Tensor:
    """A float64 tensor as the float32 the reference computes in."""
    return x.to(torch.float32) if x.dtype == torch.float64 else x


@op("DFT")
def _dft(ctx, x, dft_length=None, axis=None):
    """Discrete Fourier transform (opset 17's ``axis`` attribute, default
    1; opset 20's ``axis`` input, default -2): axes count over the full
    rank, the trailing re/im dimension included. A real ``[..., n, 1]``
    or complex ``[..., n, 2]`` input; ``[..., m, 2]`` out in the input's
    float type (float32 for an integer input). The reference's refusals
    are kept: a complex input that is not float32 or float64
    (``lax.complex``), inverse with onesided, onesided on a complex
    input."""
    x = _tensor(x)
    if axis is not None:
        (ax,) = _static_int_list(axis, "DFT axis")
    else:
        ax = ctx.attr("axis", -2 if ctx.opset >= 20 else 1)
    ax = ax % x.ndim
    if ax == x.ndim - 1:
        raise ValueError("DFT cannot transform the trailing re/im dim")
    n_fft = None
    if dft_length is not None:
        (n_fft,) = _static_int_list(dft_length, "DFT dft_length")
    inverse = bool(ctx.attr("inverse", 0))
    onesided = bool(ctx.attr("onesided", 0))
    complex_in = x.shape[-1] == 2
    if complex_in:
        if x.dtype not in (torch.float32, torch.float64):
            raise TypeError(f"DFT: a complex input must be float32 or "
                            f"float64, got {x.dtype}")
        re = _narrow(x)
        sig = torch.complex(re[..., 0], re[..., 1])
    elif x.shape[-1] == 1:
        sig = x[..., 0].to(torch.float32)
    else:
        raise ValueError("DFT input must end in a [1|2] re/im dimension")
    if inverse:
        if onesided:
            raise NotImplementedError("DFT: inverse+onesided")
        spec = torch.fft.ifft(sig, n=n_fft, dim=ax)
    elif onesided:
        if complex_in:
            raise ValueError(
                "DFT: onesided=1 requires a real signal ([..., 1]); a "
                "complex input's spectrum is not conjugate-symmetric")
        spec = torch.fft.rfft(sig, n=n_fft, dim=ax)
    else:
        spec = torch.fft.fft(sig, n=n_fft, dim=ax)
    return _spectrum(spec, x.dtype if x.is_floating_point()
                     else torch.float32)


@op("STFT")
def _stft(ctx, signal, frame_step, window=None, frame_length=None):
    """STFT (opset 17): frames of a ``[B, L, 1]`` or ``[B, L]`` signal,
    ``1 + (L - frame_length) // frame_step`` of them (none where the
    signal is shorter than a frame), as a strided view, weighted by the
    window cast to the signal's type (all ones without one) and
    transformed in one batched (r)fft; ``[B, frames, bins, 2]`` out,
    float32 but for a float64 signal. The reference's refusals are kept: a
    complex signal, a window whose length is not ``frame_length``, a
    half-precision signal with ``onesided`` (``jnp.fft.rfft``)."""
    (step,) = _static_int_list(frame_step, "STFT frame_step")
    sig = _tensor(signal)
    out_dt = torch.float64 if sig.dtype == torch.float64 else torch.float32
    sig = _narrow(sig)
    if sig.ndim == 3:  # [B, length, 1]
        if sig.shape[-1] != 1:
            raise NotImplementedError(
                "STFT: complex input signals are not supported")
        sig = sig[..., 0]
    if window is not None:
        flen = int(np.shape(window)[0])
        if frame_length is not None:
            (fl2,) = _static_int_list(frame_length, "STFT frame_length")
            if fl2 != flen:
                raise ValueError(
                    f"STFT: window length {flen} != frame_length {fl2}")
    else:
        if frame_length is None:
            raise ValueError("STFT needs window and/or frame_length")
        (flen,) = _static_int_list(frame_length, "STFT frame_length")
    if window is None:
        win = None                  # all ones: x * 1 is x, bit for bit
    elif _is_host(window):
        host = np.asarray(window)
        win = _table(ctx, ("stft_window", host.dtype.str, host.tobytes()),
                     sig.device, lambda: host, dtype=sig.dtype)
    else:
        win = window.to(sig.dtype)
    onesided = bool(ctx.attr("onesided", 1))
    if onesided and sig.dtype in (torch.float16, torch.bfloat16):
        raise ValueError(f"STFT: RFFT input must be float32 or float64, "
                         f"got {sig.dtype}")          # as jnp.fft.rfft
    frames = 1 + (sig.shape[-1] - flen) // step
    if frames <= 0:
        bins = flen // 2 + 1 if onesided else flen
        return torch.zeros(*sig.shape[:-1], 0, bins, 2, dtype=out_dt,
                           device=sig.device)
    framed = sig.unfold(-1, flen, step)          # [B, frames, flen] view
    if win is not None:
        framed = framed * win
    framed = framed.to(torch.float32)
    spec = torch.fft.rfft(framed) if onesided else torch.fft.fft(framed)
    return _spectrum(spec, out_dt)


def _cosine_window(name: str, coeffs):
    """Opset-17 generalized-cosine window family, the reference's host
    arithmetic: ``periodic=1`` (default) divides by N, symmetric by N - 1
    (at least 1), in float64, then cast to ``output_datatype``; a host
    numpy constant."""
    def impl(ctx, size):
        (n,) = _static_int_list(size, f"{name} size")
        dt = proto.TENSOR_DTYPES[int(ctx.attr("output_datatype", 1))]
        denom = n if int(ctx.attr("periodic", 1)) else n - 1
        k = 2.0 * np.pi * np.arange(n) / max(denom, 1)
        w = np.zeros(n, np.float64)
        for j, a in enumerate(coeffs):
            w += a * np.cos(j * k) * (-1.0 if j % 2 else 1.0)
        return np.asarray(w, dt)
    return impl


_REGISTRY["HannWindow"] = _cosine_window("HannWindow", (0.5, 0.5))
_REGISTRY["HammingWindow"] = _cosine_window(
    "HammingWindow", (25.0 / 46.0, 21.0 / 46.0))
_REGISTRY["BlackmanWindow"] = _cosine_window(
    "BlackmanWindow", (0.42, 0.5, 0.08))


def _mel_weights(n_mel: int, n_dft: int, sr: float, lo: float,
                 hi: float) -> np.ndarray:
    """The triangular HTK-mel filterbank, ``[n_dft // 2 + 1, n_mel]``
    float64: edges quantised to bins as ``floor((n_dft + 1) * hz / sr)``,
    the reference's arithmetic."""
    def hz_to_mel(f):
        return 2595.0 * np.log10(1.0 + np.asarray(f) / 700.0)

    def mel_to_hz(m):
        return 700.0 * (10.0 ** (np.asarray(m) / 2595.0) - 1.0)

    edges_hz = mel_to_hz(
        np.linspace(hz_to_mel(lo), hz_to_mel(hi), n_mel + 2))
    bins = np.floor((n_dft + 1) * edges_hz / sr).astype(np.int64)
    left, center, right = bins[:-2], bins[1:-1], bins[2:]
    f = np.arange(n_dft // 2 + 1)[:, None].astype(np.float64)
    up = (f - left) / np.maximum(center - left, 1)
    down = (right - f) / np.maximum(right - center, 1)
    return np.maximum(0.0, np.minimum(up, down))


@op("MelWeightMatrix")
def _mel_weight_matrix(ctx, num_mel_bins, dft_length, sample_rate,
                       lower_edge_hertz, upper_edge_hertz):
    """MelWeightMatrix (opset 17): ``[dft_length // 2 + 1, num_mel_bins]``
    on the device, cast to ``output_datatype`` as the reference casts it
    (float64 rounded through float32; int64 kept where the reference
    narrows it to int32)."""
    (n_mel,) = _static_int_list(num_mel_bins, "MelWeightMatrix bins")
    (n_dft,) = _static_int_list(dft_length, "MelWeightMatrix dft_length")
    sr, lo, hi = (float(np.asarray(v).reshape(()))
                  for v in (sample_rate, lower_edge_hertz, upper_edge_hertz))
    dt = proto.TENSOR_DTYPES[int(ctx.attr("output_datatype", 1))]
    return _table(
        ctx, ("mel", n_mel, n_dft, sr, lo, hi, np.dtype(dt).str),
        _device_of(()),
        lambda: _mel_weights(n_mel, n_dft, sr, lo, hi).astype(dt),
        dtype=torch.float64 if np.dtype(dt) == np.float64 else None)


# ---------------------------------------------------------------------------
# Optional, sequence and string ops
# ---------------------------------------------------------------------------
# An optional is the value or None, as in the reference. A sequence is a
# Python ``list`` (never a tuple: ``_run_nodes`` reads a tuple as a node's
# several outputs) whose length and positions are static host ints, so a
# graph of device elements runs with no host read and captures into a
# CUDA graph. String values stay host numpy ``object`` arrays: a string op
# handed a device tensor raises, as the reference's ``_host_strings`` does.

_REGISTRY["Optional"] = lambda ctx, x=None: x
_REGISTRY["OptionalHasElement"] = lambda ctx, x=None: np.bool_(
    x is not None)


@op("OptionalGetElement")
def _optional_get_element(ctx, x=None):
    if x is None:
        raise ValueError("OptionalGetElement on an empty optional")
    return x


_REGISTRY["SequenceEmpty"] = lambda ctx: []
_REGISTRY["SequenceConstruct"] = lambda ctx, *xs: list(xs)
_REGISTRY["SequenceLength"] = lambda ctx, seq: np.int64(len(seq))


def _seq_pos(pos, n: int, what: str) -> int:
    (p,) = _static_int_list(pos, what)
    if not -n <= p <= n - 1:
        raise ValueError(f"{what}: position {p} out of range for a "
                         f"{n}-element sequence")
    return p


@op("SequenceAt")
def _sequence_at(ctx, seq, pos):
    return seq[_seq_pos(pos, len(seq), "SequenceAt position")]


@op("SequenceInsert")
def _sequence_insert(ctx, seq, tensor, pos=None):
    """Python's ``insert``, as the reference's: ``-1`` places the value
    before the last element, ``len(seq)`` after it."""
    out = list(seq)
    if pos is None:
        out.append(tensor)
        return out
    (p,) = _static_int_list(pos, "SequenceInsert position")
    if not -len(seq) <= p <= len(seq):
        raise ValueError(f"SequenceInsert: position {p} out of range for a "
                         f"{len(seq)}-element sequence")
    out.insert(p, tensor)
    return out


@op("SequenceErase")
def _sequence_erase(ctx, seq, pos=None):
    out = list(seq)
    del out[-1 if pos is None
            else _seq_pos(pos, len(seq), "SequenceErase position")]
    return out


@op("ConcatFromSequence")
def _concat_from_sequence(ctx, seq):
    """An all-host sequence stays numpy (the ``Concat`` convention);
    otherwise the elements go to the device in JAX's promoted dtype."""
    axis = ctx.attr("axis")
    if axis is None:
        raise ValueError("ConcatFromSequence needs an axis attribute")
    axis, stack = int(axis), bool(ctx.attr("new_axis", 0))
    if _all_host(seq):
        fn = np.stack if stack else np.concatenate
        return fn(list(seq), axis=axis)
    fn = torch.stack if stack else torch.cat
    return fn(_operands(list(seq), scalars=False), dim=axis)


@op("SplitToSequence")
def _split_to_sequence(ctx, x, split=None):
    """Without ``split``, one element a position along ``axis`` (squeezed
    where ``keepdims`` is 0); a scalar ``split`` gives chunks of that size
    and a smaller last one; a list gives its sizes. Host values stay
    host; device parts are views of ``x``."""
    host = _is_host(x)
    x = np.asarray(x) if host else _tensor(x)
    axis = int(ctx.attr("axis", 0)) % x.ndim
    n = x.shape[axis]
    if split is None:
        if host:
            parts = [np.take(x, [i], axis=axis) for i in range(n)]
            return (parts if ctx.attr("keepdims", 1)
                    else [np.squeeze(p, axis=axis) for p in parts])
        if ctx.attr("keepdims", 1):
            return [x.narrow(axis, i, 1) for i in range(n)]
        return [x.select(axis, i) for i in range(n)]
    sizes = _static_int_list(split, "SplitToSequence split")
    if len(sizes) == 1 and np.ndim(split) == 0:
        size = sizes[0]
        sizes = [size] * (n // size) + ([n % size] if n % size else [])
    bounds = np.cumsum(sizes)[:-1].tolist()
    if host:
        return list(np.split(x, bounds, axis=axis))
    return list(torch.tensor_split(x, bounds, dim=axis))


@op("SequenceMap")
def _sequence_map(ctx, seq, *extra, env=None):
    """The body once per element of ``seq``: a tensor extra input is
    passed whole to every run, a sequence one element by element. One
    output gives a list; several give a tuple of lists (the node's
    outputs)."""
    body = ctx.attrs["__lowered_body__"]
    outs: List[List[Any]] = [[] for _ in body.output_names]
    for i in range(len(seq)):
        vals = [seq[i]] + [e[i] if isinstance(e, list) else e
                           for e in extra]
        for acc, r in zip(outs, body.run(env or {}, dict(zip(
                body.input_names, vals)))):
            acc.append(r)
    return tuple(outs) if len(outs) > 1 else outs[0]


_sequence_map._needs_env = True


def _host_strings(x, opname: str) -> np.ndarray:
    if not _is_host(x):
        raise NotImplementedError(
            f"{opname} operates on host string arrays; a device tensor "
            "cannot hold strings: feed them as a host (numpy) input")
    return np.asarray(x, dtype=object)


@op("StringConcat")
def _string_concat(ctx, a, b):
    a = _host_strings(a, "StringConcat")
    b = _host_strings(b, "StringConcat")
    return np.frompyfunc(
        lambda s, t: str(s) + str(t), 2, 1)(a, b).astype(object)


@op("StringSplit")
def _string_split(ctx, x):
    """Each string's tokens, padded with ``""`` to the most tokens of any
    string, and their int64 counts. With a ``delimiter`` the empty tokens
    between two separators are kept; without one, runs of whitespace
    separate and no token is empty."""
    x = _host_strings(x, "StringSplit")
    delim = ctx.attr("delimiter", None)
    maxsplit = ctx.attr("maxsplit", None)
    ms = -1 if maxsplit is None else int(maxsplit)
    toks = []
    for s in x.reshape(-1):
        s = str(s)
        if delim:
            toks.append(s.split(delim, ms) if ms >= 0 else s.split(delim))
        else:
            toks.append(s.split(None, ms) if ms >= 0 else s.split())
    width = max((len(t) for t in toks), default=0)
    out = np.full((len(toks), width), "", dtype=object)
    for i, t in enumerate(toks):
        out[i, :len(t)] = t
    counts = np.asarray([len(t) for t in toks], np.int64).reshape(x.shape)
    return out.reshape(x.shape + (width,)), counts


@op("StringNormalizer")
def _string_normalizer(ctx, x):
    """Stop-word filtering, then case folding, of a ``[C]`` or ``[1, C]``
    string array; an input with every string filtered out gives one empty
    string. Python's case mapping: ``locale`` is not read."""
    x = _host_strings(x, "StringNormalizer")
    two_d = x.ndim == 2
    if two_d and x.shape[0] != 1:
        raise ValueError(
            f"StringNormalizer input must be [C] or [1, C], got {x.shape}")
    flat = [str(s) for s in x.reshape(-1)]
    action = str(ctx.attr("case_change_action", "NONE")).upper()
    stop = ctx.attr("stopwords") or []
    if stop:
        if int(ctx.attr("is_case_sensitive", 0)):
            stops = set(stop)
            keep = [s for s in flat if s not in stops]
        else:
            lowered = {w.lower() for w in stop}
            keep = [s for s in flat if s.lower() not in lowered]
    else:
        keep = flat
    if action == "LOWER":
        keep = [s.lower() for s in keep]
    elif action == "UPPER":
        keep = [s.upper() for s in keep]
    out = np.asarray(keep or [""], dtype=object)
    return out.reshape(1, -1) if two_d else out


@op("RegexFullMatch")
def _regex_full_match(ctx, x):
    """Whether each string matches ``pattern`` whole, in Python ``re``
    syntax (the spec's RE2 shares its common subset)."""
    import re

    x = _host_strings(x, "RegexFullMatch")
    pattern = ctx.attr("pattern")
    if pattern is None:
        raise ValueError("RegexFullMatch needs a pattern attribute")
    rx = re.compile(pattern)
    return np.frompyfunc(
        lambda s: rx.fullmatch(str(s)) is not None, 1, 1)(x).astype(bool)


# elements of one [rows, windows, grams] comparison of TfIdfVectorizer
_TFIDF_PIECE = 1 << 26


def _tfidf_plan(ctx) -> dict:
    """TfIdfVectorizer's host tables, built once a node: per pool level
    (``n``-grams from ``ngram_counts[n - 1]``) its grams ``[n_grams, n]``
    and their output columns, and the weight of each output column."""
    plan = ctx.attrs.get("__tfidf_plan__")
    if plan is not None:
        return plan
    pool = np.asarray(ctx.attr("pool_int64s"), np.int64)
    starts = [int(v) for v in ctx.attr("ngram_counts")]
    indexes = np.asarray(ctx.attr("ngram_indexes"), np.int64)
    n_out = int(indexes.max()) + 1 if indexes.size else 0
    levels, cursor = [], 0
    for level, (lo, hi) in enumerate(zip(starts, starts[1:] + [len(pool)])):
        n = level + 1
        n_grams = (hi - lo) // n
        if n_grams == 0:
            continue
        levels.append((n, pool[lo:hi].reshape(n_grams, n),
                       indexes[cursor:cursor + n_grams]))
        cursor += n_grams
    weights = np.ones(n_out, np.float32)
    if ctx.attr("weights") is not None:
        weights[indexes] = np.asarray(ctx.attr("weights"), np.float32)
    plan = ctx.attrs["__tfidf_plan__"] = {
        "levels": levels, "n_out": n_out, "weights": weights}
    return plan


@op("TfIdfVectorizer")
def _tfidf_vectorizer(ctx, x):
    """N-gram counts of integer token rows over ``pool_int64s``, on the
    device. Skip-grams take their items at equal stride ``s + 1`` for each
    ``s`` up to ``max_skip_count`` (onnxruntime's reading, the
    reference's). Each (level, skip) is one ``windows == grams``
    comparison over ``[rows, windows, grams]``, in pieces of at most
    ``_TFIDF_PIECE`` elements; the counts are integers held in float32,
    so every piece size gives the same bits. The grams, their columns and
    the weights go to the device once a node (:func:`_table`): a run
    copies only the token ids."""
    mode = str(ctx.attr("mode", "TF"))
    if ctx.attr("pool_int64s") is None or \
            ctx.attr("pool_strings") is not None:
        raise NotImplementedError(
            "TfIdfVectorizer: only pool_int64s token pools are supported")
    if mode not in ("TF", "IDF", "TFIDF"):
        raise ValueError(f"TfIdfVectorizer mode {mode!r}")
    min_n = int(ctx.attr("min_gram_length", 1))
    max_n = int(ctx.attr("max_gram_length", 1))
    max_skip = int(ctx.attr("max_skip_count", 0))
    plan = _tfidf_plan(ctx)
    x = _tensor(x)
    squeeze = x.ndim == 1
    if squeeze:
        x = x[None, :]
    rows, seq = x.shape
    dev = x.device
    out = torch.zeros((rows, plan["n_out"]), dtype=torch.float32, device=dev)
    for n, grams_np, cols_np in plan["levels"]:
        if not min_n <= n <= max_n:
            continue
        grams = _table(ctx, ("tfidf_grams", n), dev, lambda: grams_np)
        cols = _table(ctx, ("tfidf_cols", n), dev, lambda: cols_np)
        n_grams = grams.shape[0]
        counts = torch.zeros((rows, n_grams), dtype=torch.float32,
                             device=dev)
        for s in (range(max_skip + 1) if n > 1 else (0,)):
            span = (n - 1) * (s + 1) + 1
            if span > seq:
                continue
            windows = x.unfold(1, span, 1)[:, :, ::s + 1]   # [rows, W, n]
            w = windows.shape[1]
            piece = max(1, min(n_grams, _TFIDF_PIECE // max(rows * w, 1)))
            for c0 in range(0, n_grams, piece):
                g = grams[c0:c0 + piece]
                # matches as float16 0/1, summed in float32: a bool or int
                # sum would first cast the whole comparison
                hit = torch.empty((rows, w, g.shape[0]), dtype=torch.float16,
                                  device=dev)
                torch.eq(windows[:, :, 0, None], g[None, None, :, 0],
                         out=hit)
                for k in range(1, n):
                    hit.mul_(windows[:, :, k, None] == g[None, None, :, k])
                counts[:, c0:c0 + piece] += hit.sum(1, dtype=torch.float32)
        out.index_add_(1, cols, counts)
    if mode != "TF":
        wv = _table(ctx, "tfidf_weights", dev, lambda: plan["weights"])
        out = (torch.where(out > 0, wv, 0.0) if mode == "IDF"
               else out * wv)
    return out[0] if squeeze else out


# ---------------------------------------------------------------------------
# Graph import
# ---------------------------------------------------------------------------

def _lower_nodes(nodes, opset: int):
    """Pre-extract (impl, ctx, inputs, outputs) per node, so apply() does
    no proto work per call. Control-flow bodies are lowered here too, so
    an op outside the registry inside a branch fails at import."""
    lowered = []
    for node in nodes:
        impl = _REGISTRY.get(node.op_type)
        if impl is None:
            raise NotImplementedError(
                f"ONNX op {node.op_type!r} (node {node.name!r}) is not "
                f"supported by the importer; supported: "
                f"{sorted(_REGISTRY)}")
        # positional arity: through the last *used* output slot — ONNX
        # marks skipped optional outputs with "" placeholders
        arity = max((i + 1 for i, o in enumerate(node.output) if o),
                    default=0)
        ctx = OpContext(node_attrs(node), opset,
                        node.name or (node.output[0] if node.output else ""),
                        node.op_type, arity)
        if node.op_type == "If":
            ctx.attrs["__lowered__"] = (
                _Subgraph(ctx.attr("then_branch"), opset),
                _Subgraph(ctx.attr("else_branch"), opset))
        elif node.op_type in ("Loop", "Scan", "SequenceMap"):
            ctx.attrs["__lowered_body__"] = _Subgraph(ctx.attr("body"),
                                                      opset)
        lowered.append((impl, ctx, list(node.input), list(node.output)))
    return lowered


def _subgraphs_of(ctx) -> List["_Subgraph"]:
    body = ctx.attrs.get("__lowered_body__")
    return [*ctx.attrs.get("__lowered__", ()),
            *([body] if body is not None else [])]


def _reads(ctx, in_names) -> List[str]:
    """The names a node reads: its inputs and, for control flow, every
    outer name its bodies capture."""
    out = [n for n in in_names if n]
    for sub in _subgraphs_of(ctx):
        out.extend(sub.captured)
    return out


def _last_uses(lowered, keep: Sequence[str]) -> List[Tuple[str, ...]]:
    """For each node, the values that no later node reads and that are not
    in ``keep`` (the graph's outputs): ``_run_nodes`` drops them from the
    environment after the node, so an intermediate lives only until its
    last consumer, and a CUDA graph's capture records the live peak, not
    every activation of the forward. A value that a control-flow body
    captures counts as read by the control-flow node."""
    last: Dict[str, int] = {}
    for i, (_, ctx, in_names, out_names) in enumerate(lowered):
        for n in (*_reads(ctx, in_names), *out_names):
            if n:
                last[n] = i
    keep = set(keep)
    drops: List[List[str]] = [[] for _ in lowered]
    for n, i in last.items():
        if n not in keep:
            drops[i].append(n)
    return [tuple(d) for d in drops]


def _run_nodes(lowered, env: Dict[str, Any],
               drops: Sequence[Tuple[str, ...]]):
    for (impl, ctx, in_names, out_names), dead in zip(lowered, drops):
        args = [env[n] if n else None for n in in_names]
        if getattr(impl, "_needs_env", False):
            # control flow: the bodies read outer names beyond the inputs
            out = impl(ctx, *args, env=env)
        else:
            out = impl(ctx, *args)
        if not isinstance(out, tuple):
            out = (out,)
        for name, val in zip(out_names, out):
            if name:  # "" marks a skipped optional output
                env[name] = val
        del args, out
        for name in dead:
            env.pop(name, None)


# ---------------------------------------------------------------------------
# Control flow: If, Loop, Scan
# ---------------------------------------------------------------------------

class _Subgraph:
    """A branch or loop body, lowered once at import time.

    ``inits`` are the body's initializers: host numpy as imported; in a
    bound graph (:meth:`bound`) the float ones that feed no shape slot are
    tensors on the card, uncast, so a step copies nothing to the card.
    ``captured`` are the outer names the body reads. A run sees those, the
    values bound to the body's inputs and the initializers, in that order
    of precedence, and drops each value after its last use."""

    def __init__(self, graph: Msg, opset: int):
        self.inits: Dict[str, Any] = {
            t.name: tensor_to_numpy(t) for t in graph.initializer}
        self.lowered = _lower_nodes(graph.node, opset)
        self.input_names = [vi.name for vi in graph.input]
        self.output_names = [vi.name for vi in graph.output]
        self.captured = frozenset(self.captured_names())
        self.drops = _last_uses(self.lowered, self.output_names)

    def captured_names(self) -> set:
        """Names read from the outer scope: node inputs not produced
        inside the subgraph (recursively through nested control flow)."""
        produced = set(self.input_names) | set(self.inits)
        captured = set()
        for _, ctx, in_names, out_names in self.lowered:
            for nm in in_names:
                if nm and nm not in produced:
                    captured.add(nm)
            for sub in _subgraphs_of(ctx):
                captured |= sub.captured - produced
            produced.update(n for n in out_names if n)
        return captured

    def bound(self, dev: torch.device) -> "_Subgraph":
        """A copy whose float, non-shape initializers live on ``dev`` (not
        cast: the reference's ``bind`` never casts a body's constants) and
        whose nested bodies are bound likewise. The original is left as
        it is, so every bind of a graph gets its own body values."""
        out = _Subgraph.__new__(_Subgraph)
        out.__dict__.update(self.__dict__)
        static = _static_names(
            [(ctx.op_type, in_names) for _, ctx, in_names, _ in self.lowered],
            self.inits)
        out.inits = {k: v if k in static else _tensor(v, dev)
                     for k, v in self.inits.items()}
        out.lowered = [_bound_node(node, dev) for node in self.lowered]
        return out

    def run(self, env: Dict[str, Any], bindings: Dict[str, Any]):
        sub_env = {n: env[n] for n in self.captured if n in env}
        sub_env.update(bindings)
        sub_env.update(self.inits)
        _run_nodes(self.lowered, sub_env, self.drops)
        return tuple(sub_env[n] for n in self.output_names)


def _bound_node(node, dev: torch.device):
    """``node`` with its bodies and its device constants bound to ``dev``
    (a new context; the imported one is shared by every bind). An op with
    ``_constants`` (the ``ai.onnx.ml`` ops: tree tables, support vectors,
    weights) gets their copies on ``dev`` under ``__bound__``, made once
    here, so a bound forward copies nothing to the card."""
    impl, ctx, in_names, out_names = node
    constants = getattr(impl, "_constants", None)
    if not _subgraphs_of(ctx) and constants is None:
        return node
    # the host constants first: they are cached on the imported context,
    # which the bound one copies
    bound = None if constants is None else {
        k: _tensor(v, dev) for k, v in constants(ctx).items()}
    attrs = dict(ctx.attrs)
    if bound is not None:
        attrs["__bound__"] = bound
    if "__lowered__" in attrs:
        attrs["__lowered__"] = tuple(s.bound(dev)
                                     for s in attrs["__lowered__"])
    if "__lowered_body__" in attrs:
        attrs["__lowered_body__"] = attrs["__lowered_body__"].bound(dev)
    return (impl, OpContext(attrs, ctx.opset, ctx.name, ctx.op_type,
                            ctx.n_outputs), in_names, out_names)


def _single(out: tuple):
    return out if len(out) != 1 else out[0]


def _truth(x) -> bool:
    """A 0-d or one-element condition read on the host (a sync for a
    device tensor)."""
    return bool(np.asarray(x).reshape(()) if _is_host(x) else x.reshape(()))


@op("If")
def _if(ctx, cond, env=None):
    """then/else subgraphs with outer capture. A host condition picks one
    branch; a device condition runs both and selects elementwise (no read
    of the condition on the host, so the op can be captured)."""
    then_b, else_b = ctx.attrs["__lowered__"]
    env = env or {}
    if _is_host(cond):
        branch = then_b if _truth(cond) else else_b
        return _single(branch.run(env, {}))
    t_out = then_b.run(env, {})
    e_out = else_b.run(env, {})
    c = _tensor(cond).reshape(())
    return _single(tuple(torch.where(c, *_operands((t, e), scalars=False))
                         for t, e in zip(t_out, e_out)))


_if._needs_env = True


def _stack(values: list, axis: int = 0):
    """Scan outputs stacked on a new leading axis, then moved to ``axis``:
    host values stay host; otherwise tensors in their promoted dtype."""
    if _all_host(values):
        st = np.stack([np.asarray(v) for v in values])
        return np.moveaxis(st, 0, axis % st.ndim)
    st = torch.stack(_operands(values, scalars=False))
    return torch.movedim(st, 0, axis % st.ndim)


@op("Loop")
def _loop(ctx, max_trip, cond, *v_initial, env=None):
    """ONNX Loop. A host trip count and condition (the exported for-range
    pattern) run as a host loop with scan outputs. A device trip count or
    condition (the scripted-while pattern) runs as a while loop over
    device carries (:func:`_loop_via_while`)."""
    body = ctx.attrs["__lowered_body__"]
    if max_trip is None and cond is None:
        raise ValueError("Loop needs a trip count or a condition")
    n_carried = len(v_initial)
    n_scan = len(body.output_names) - 1 - n_carried
    if ((max_trip is not None and not _is_host(max_trip))
            or (cond is not None and not _is_host(cond))):
        return _loop_via_while(body, env, max_trip, cond, v_initial, n_scan)
    trips = int(np.asarray(max_trip).reshape(())) \
        if max_trip is not None else None
    keep_going = True if cond is None else _truth(cond)
    carried = list(v_initial)
    scan_acc: List[List[Any]] = [[] for _ in range(n_scan)]
    i = 0
    while keep_going and (trips is None or i < trips):
        outs = body.run(env, dict(zip(
            body.input_names, [np.int64(i), np.bool_(True), *carried])))
        cond_out, outs = outs[0], outs[1:]
        carried = list(outs[:n_carried])
        for acc, s in zip(scan_acc, outs[n_carried:]):
            acc.append(s)
        if not _is_host(cond_out):
            # the body decides on the device: start again as a while loop
            # (the body is functional, the host iterations left no trace)
            return _loop_via_while(body, env, max_trip, cond, v_initial,
                                   n_scan)
        keep_going = _truth(cond_out)
        i += 1
    if i == 0 and n_scan > 0:
        # a zero-trip loop still owes empty scan outputs: one probe run of
        # the body gives their shapes (its values are discarded)
        probe = body.run(env, dict(zip(
            body.input_names, [np.int64(0), np.bool_(True), *v_initial])))
        stacked = [np.zeros((0,) + np.shape(p), np.asarray(p).dtype)
                   if _is_host(p) else
                   torch.zeros((0,) + tuple(p.shape), dtype=p.dtype,
                               device=p.device)
                   for p in probe[1 + n_carried:]]
    else:
        stacked = [_stack(a) for a in scan_acc]
    return _single(tuple(carried) + tuple(stacked))


_loop._needs_env = True


def _loop_via_while(body, env, max_trip, cond, v_initial, n_scan: int):
    """A device trip count or condition: continue while ``i < M`` and the
    condition holds, carries on the device, each cast back to its initial
    dtype. The condition is read on the host every iteration (a sync), so
    such a graph cannot be captured into a CUDA graph: under capture this
    raises before the first read, which leaves the capture intact to end,
    and a warmup reports the bucket ``"error"`` and serves it eagerly.
    INT64_MAX or a negative device trip count means unbounded."""
    if n_scan > 0:
        raise NotImplementedError(
            "Loop: scan outputs with a data-dependent trip count have a "
            "data-dependent shape, which the reference's static-shape "
            "model cannot express; restructure the model to a static trip "
            "count or carried accumulators")
    dev = _device_of([max_trip, cond, *v_initial])
    if dev.type == "cuda" and torch.cuda.is_current_stream_capturing():
        raise RuntimeError(
            "Loop with a device trip count or condition reads it on the "
            "host every iteration; it cannot be captured into a CUDA graph "
            "(this bucket runs eagerly)")
    trips = None
    if max_trip is not None:
        host = _is_host(max_trip)
        m = int(np.asarray(max_trip).reshape(()) if host
                else max_trip.reshape(()))
        # torch exports `while cond:` as M = INT64_MAX, which the
        # reference reads as unbounded on the host and, narrowed to int32,
        # as a negative count on the device
        trips = None if m >= 2**31 - 1 or (m < 0 and not host) else m
    keep = True if cond is None else _truth(cond)
    carried0 = [_tensor(v, dev) for v in v_initial]
    carried = carried0
    i = 0
    while keep and (trips is None or i < trips):
        vals = [torch.full((), i, dtype=torch.int64, device=dev),
                torch.full((), keep, dtype=torch.bool, device=dev),
                *carried]
        outs = body.run(env, dict(zip(body.input_names, vals)))
        keep = _truth(outs[0])
        carried = [_tensor(o, dev).to(c.dtype)
                   for o, c in zip(outs[1:], carried0)]
        i += 1
    return _single(tuple(carried))


@op("Scan")
def _scan(ctx, *inputs, env=None):
    """Scan (opset 9 and later): per-step slices of the scan inputs drive
    the body, state variables carry across steps, scan outputs stack on
    ``scan_output_axes``; input and output directions may be reversed.
    One step loop serves every length (the reference switches to
    ``lax.scan`` above 16 steps, with the same arithmetic). Host scan
    inputs stay host. A step of a bound graph issues no host sync and no
    copy to the card, so a warm bucket is one replay."""
    if ctx.opset < 9:
        raise NotImplementedError(
            "Scan: the opset-8 layout (sequence_lens input, batch axis) "
            "is not supported; re-export at opset >= 9")
    body = ctx.attrs["__lowered_body__"]
    m = int(ctx.attr("num_scan_inputs"))
    n_state = len(inputs) - m
    state = list(inputs[:n_state])
    scans = list(inputs[n_state:])
    in_axes = list(ctx.attr("scan_input_axes", [0] * m))
    in_dirs = list(ctx.attr("scan_input_directions", [0] * m))
    n_scan_out = len(body.output_names) - n_state
    out_axes = list(ctx.attr("scan_output_axes", [0] * n_scan_out))
    out_dirs = list(ctx.attr("scan_output_directions", [0] * n_scan_out))
    if _all_host(scans):
        scans = [np.moveaxis(np.asarray(s), in_axes[j] % np.ndim(s), 0)
                 for j, s in enumerate(scans)]
    else:
        scans = [torch.movedim(_tensor(s), in_axes[j] % np.ndim(s), 0)
                 for j, s in enumerate(scans)]
    length = int(scans[0].shape[0]) if scans else 0
    acc: List[List[Any]] = [[] for _ in range(n_scan_out)]
    for i in range(length):
        vals = state + [s[length - 1 - i] if in_dirs[j] else s[i]
                        for j, s in enumerate(scans)]
        outs = body.run(env, dict(zip(body.input_names, vals)))
        state = list(outs[:n_state])
        for a, s in zip(acc, outs[n_state:]):
            a.append(s)
    stacked = [_stack(a[::-1] if out_dirs[j] else a, out_axes[j])
               for j, a in enumerate(acc)]
    return _single(tuple(state) + tuple(stacked))


_scan._needs_env = True


def _run(lowered, env: Dict[str, Any], dev: torch.device,
         drops: Sequence[Tuple[str, ...]]):
    with _running_on(dev), _ieee_float32():
        _run_nodes(lowered, env, drops)


# Shape-consuming initializers (Reshape targets, Slice starts, Resize
# scales, masks...) must stay STATIC host values: a device tensor cannot
# give a shape. Static = every non-float initializer, plus any initializer
# (float included — Resize scales/roi) feeding a shape-position input slot.
# Float weights are the params, which bind() moves to the device and may
# cast. The slot table is the reference's, so both packages split a graph
# alike.
_SHAPE_SLOTS = {
    "Reshape": (1,), "Expand": (1,), "Tile": (1,),
    "Slice": (1, 2, 3, 4), "Resize": (1, 2, 3), "Upsample": (1,),
    "ConstantOfShape": (0,), "Range": (0, 1, 2), "TopK": (1,),
    "OneHot": (1,), "Pad": (1, 2, 3), "Unsqueeze": (1,),
    "Squeeze": (1,), "Split": (1,), "Trilu": (1,),
    "ReduceSum": (1,), "ReduceMean": (1,), "ReduceMax": (1,),
    "ReduceMin": (1,), "ReduceProd": (1,), "CenterCropPad": (1,),
    "ReduceSumSquare": (1,), "ReduceL1": (1,), "ReduceL2": (1,),
    "ReduceLogSum": (1,), "ReduceLogSumExp": (1,),
    "MelWeightMatrix": (0, 1, 2, 3, 4), "STFT": (1, 3),
    "HannWindow": (0,), "HammingWindow": (0,),
    "BlackmanWindow": (0,), "MaxUnpool": (2,),
    "NonMaxSuppression": (2, 3, 4),
    "DFT": (1, 2), "Col2Im": (1, 2), "AffineGrid": (1,),
    "Unique": (0,), "Compress": (0, 1),
}
# ...while packed-integer WEIGHT slots stay params though non-float
_WEIGHT_SLOTS = {"MatMulNBits": (1, 3)}


def _static_names(nodes, inits: Dict[str, np.ndarray]) -> set:
    """The initializers of ``inits`` that stay host values, given the
    graph's ``(op_type, input names)`` pairs."""
    shape_fed = set()
    weight_fed = set()
    for op_type, inputs in nodes:
        for target, slots in ((shape_fed, _SHAPE_SLOTS.get(op_type)),
                              (weight_fed, _WEIGHT_SLOTS.get(op_type))):
            for i in slots or ():
                if i < len(inputs) and inputs[i]:
                    target.add(inputs[i])
    weight_fed -= shape_fed  # shape use wins: it needs host values
    return {k for k, v in inits.items()
            if (not np.issubdtype(v.dtype, np.floating) or k in shape_fed)
            and k not in weight_fed}


class ImportedGraph:
    """An ONNX graph lowered to torch ops.

    ``params`` holds the float initializers (host numpy); ``static_params``
    the shape-consuming and non-float ones, which stay host numpy.
    ``apply(params, *inputs)`` returns outputs in graph-output order;
    ``bind`` moves the params to the card once and returns the forward.
    """

    def __init__(self, graph: Msg, opset: int, optimize: bool = False):
        if optimize:
            from synapseml_tpu_torch.onnx.optimize import optimize_graph

            graph = optimize_graph(graph, opset)
        self.graph = graph
        self.opset = opset
        all_inits = {t.name: tensor_to_numpy(t) for t in graph.initializer}
        static = _static_names(
            [(node.op_type, list(node.input)) for node in graph.node],
            all_inits)
        self.static_params: Dict[str, np.ndarray] = {
            k: v for k, v in all_inits.items() if k in static}
        self.params: Dict[str, np.ndarray] = {
            k: v for k, v in all_inits.items() if k not in self.static_params
        }
        init_names = set(all_inits)
        self.input_names: List[str] = [
            vi.name for vi in graph.input if vi.name not in init_names
        ]
        self.output_names: List[str] = [vi.name for vi in graph.output]
        self.input_info: Dict[str, Tuple[Optional[Any], List[Optional[int]]]] = {}
        for vi in graph.input:
            if vi.name in init_names or vi.type is None or vi.type.tensor_type is None:
                continue
            tt = vi.type.tensor_type
            dtype = proto.TENSOR_DTYPES.get(int(tt.elem_type or 0))
            shape: List[Optional[int]] = []
            if tt.shape is not None:
                for d in tt.shape.dim:
                    shape.append(int(d.dim_value) if d.dim_value else None)
            self.input_info[vi.name] = (dtype, shape)
        # pre-extract node metadata so apply() does no proto work per call
        self._nodes = _lower_nodes(graph.node, opset)

    def _env(self, params, inputs, named_inputs) -> Dict[str, Any]:
        env: Dict[str, Any] = dict(self.static_params)
        env.update(params)
        for name, val in zip(self.input_names, inputs):
            env[name] = val
        env.update(named_inputs)
        missing = [n for n in self.input_names if n not in env]
        if missing:
            raise ValueError(f"missing graph inputs: {missing}")
        return env

    def apply(self, params: Dict[str, Any], *inputs, **named_inputs):
        """Run the graph. Inputs positional (graph order) or by name.

        Host values (numpy) are welcome; the run takes place on the device
        of the first tensor among the params and inputs, and on the
        default device ("cuda", which raises without CUDA) if none is a
        tensor."""
        env = self._env(params, inputs, named_inputs)
        dev = next((v.device for v in (*params.values(), *inputs,
                                       *named_inputs.values())
                    if isinstance(v, torch.Tensor)), None)
        _run(self._nodes, env, dev if dev is not None
             else device_policy.resolve(),
             _last_uses(self._nodes, self.output_names))
        return tuple(env[n] for n in self.output_names)

    def bind(self, cast_dtype=None,
             device: str | torch.device = device_policy.DEFAULT_DEVICE):
        """Return ``fn(*inputs)`` with params closed over (optionally cast).

        The float params go to ``device`` once, here (cast to
        ``cast_dtype``, a torch or numpy dtype, where given), and each
        BatchNormalization whose statistics are params is folded here
        into a scale and a bias. Control-flow bodies are bound for this
        call alone: their float initializers go to ``device`` uncast, as
        the reference never casts them (:meth:`_Subgraph.bound`). ``fn``
        runs under
        ``torch.inference_mode()``; numpy inputs are copied to the device
        by the first op that needs them there. ``device`` is "cuda" by
        default and raises without CUDA."""
        dev = device_policy.resolve(device)
        dt = _torch_dtype(cast_dtype) if cast_dtype is not None else None
        params: Dict[str, torch.Tensor] = {}
        for k, v in self.params.items():
            t = _tensor(v, dev)
            if dt is not None and t.is_floating_point():
                t = t.to(dt)
            params[k] = t
        nodes = []
        with torch.inference_mode():
            for node in self._nodes:
                impl, ctx, in_names, out_names = node
                stats = in_names[1:5]
                if (impl is _batch_norm and len(stats) == 4
                        and all(n in self.params for n in stats)):
                    w32, b32 = _bn_fold(*(params[n] for n in stats),
                                        ctx.attr("epsilon", 1e-5))
                    act = dt if dt is not None else params[stats[0]].dtype
                    keys = [f"{out_names[0]}::bn_{k}"
                            for k in ("w", "b", "w32", "b32")]
                    params.update(zip(keys, (w32.to(act), b32.to(act),
                                             w32, b32)))
                    node = (_batch_norm_bound, ctx, in_names[:1] + keys,
                            out_names)
                nodes.append(_bound_node(node, dev))
        drops = _last_uses(nodes, self.output_names)

        def fn(*inputs):
            env = self._env(params, inputs, {})
            with torch.inference_mode():
                _run(nodes, env, dev, drops)
            return tuple(env[n] for n in self.output_names)
        return fn

    def param_bytes(self) -> int:
        return (sum(v.nbytes for v in self.params.values())
                + sum(v.nbytes for v in self.static_params.values()))

    def truncated(self, cut_layers: int = 1) -> "ImportedGraph":
        """Headless copy with the last ``cut_layers`` nodes removed — the
        transfer-learning hook. The new graph's output is the last
        surviving node's first output; unused initializers are dropped."""
        if not 0 <= cut_layers < len(self._nodes):
            raise ValueError(f"cut_layers={cut_layers} out of range "
                             f"(graph has {len(self._nodes)} nodes)")
        out = ImportedGraph.__new__(ImportedGraph)
        out.graph = self.graph
        out.opset = self.opset
        out._nodes = self._nodes[: len(self._nodes) - cut_layers]
        out.input_names = list(self.input_names)
        out.input_info = dict(self.input_info)
        out.output_names = [out._nodes[-1][3][0]] if cut_layers else list(self.output_names)
        used = set()
        for _, ctx, in_names, _ in out._nodes:
            # a body's captured names count: dropping their params would
            # break the run
            used.update(_reads(ctx, in_names))
        out.params = {k: v for k, v in self.params.items() if k in used}
        out.static_params = {
            k: v for k, v in self.static_params.items() if k in used
        }
        return out

    def __repr__(self):
        return (f"ImportedGraph(inputs={self.input_names}, "
                f"outputs={self.output_names}, nodes={len(self._nodes)}, "
                f"params={len(self.params)}, opset={self.opset})")


def import_model(path_or_bytes, optimize: bool = False,
                 base_dir: Optional[str] = None) -> ImportedGraph:
    """Parse a ``.onnx`` file/bytes and lower it to an :class:`ImportedGraph`.

    ``optimize`` applies proto-level graph rewrites (parallel-MatMul/QKV
    packing — see :mod:`synapseml_tpu_torch.onnx.optimize`) before lowering;
    off by default, as in the reference.

    Models saved with external data resolve their sidecar files relative
    to the model's directory; pass ``base_dir`` when supplying raw bytes."""
    model = proto.load_model(path_or_bytes, base_dir=base_dir)
    if model.graph is None:
        raise ValueError("ONNX model has no graph")
    opset = 13
    for osi in model.opset_import:
        if not osi.domain:  # default ai.onnx domain
            opset = int(osi.version or opset)
    return ImportedGraph(model.graph, opset, optimize=optimize)


def supported_ops() -> List[str]:
    return sorted(_REGISTRY)


# ai.onnx.ml domain ops register themselves on import (bottom import keeps
# the circular edge harmless: everything ml_ops needs is defined above)
from synapseml_tpu_torch.onnx import ml_ops  # noqa: E402,F401

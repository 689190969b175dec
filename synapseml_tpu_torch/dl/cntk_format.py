"""CNTK v2 binary ``.model`` reader: protobuf Dictionary -> ONNX -> jax.

The reference executes native ``.model`` files through the CNTK 2.4 JNI
runtime (ref: deep-learning/src/main/scala/com/microsoft/ml/spark/cntk/
SerializableFunction.scala:85-143 — ``Function.load`` on broadcast
bytes). That runtime is dead and CUDA/CPU-only, so here the *format*
is parsed directly: CNTK-2.x model files are a serialized ``Dictionary``
protobuf (the CNTKv2LibraryDll ``CNTK.proto`` schema — NDShape/Axis/
NDArrayView/Vector/Dictionary/DictionaryValue messages) holding a
``CompositeFunction``: a vector of primitive functions wired by variable
uids (outputs follow the ``<func_uid>_Output_<k>`` convention) plus the
parameter/constant payloads. The graph is re-emitted as ONNX and lowered
through the standard importer, so every op lands on the same jit path as
user ONNX files.

Format notes (why the reshapes below look reversed): CNTK NDShapes store
dimensions fastest-varying first and tensors column-major; reading the
flat payload row-major with the dims REVERSED yields the numpy/ONNX
layout directly (a conv kernel ``(kW,kH,Cin,Cout)`` becomes
``(Cout,Cin,kH,kW)``). The batch axis is a dynamic axis — absent from
shapes — and maps to the leading "N" dim; a CNTK static axis index k
(0 = fastest) maps to negative numpy axis ``-(k+1)``.

Supported op surface: the feedforward model-zoo diet (Times/Plus/
activation chains, Convolution, Pooling, BatchNormalization, Reshape,
Splice, Slice, TransposeAxes, ReduceElements, Clip, Dropout/NoOp
passthrough, Combine) plus RECURRENT graphs: PastValue/FutureValue
cycles lower to ONNX Scan -> ``lax.scan`` with everything outside the
cycle vectorized over the sequence (see :func:`_recurrent_to_onnx`;
bidirectional = two cycles = two Scans), and OptimizedRNNStack (the
fused cuDNN op GPU-trained models carry) unpacks its packed weight blob
into standard ONNX LSTM/GRU/RNN nodes (:func:`_emit_optimized_rnn`).
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from synapseml_tpu_torch.onnx import proto
from synapseml_tpu_torch.onnx.builder import GraphBuilder
from synapseml_tpu_torch.onnx.proto import F, Msg

# This module is the reference package's dl/cntk_format.py with only the
# imports renamed, so both write the same CNTK v2 bytes and the same ONNX
# bytes (the producer string included). Its docstrings describe the
# reference's lowering: in this package a Scan runs as the importer's step
# loop over torch ops (synapseml_tpu_torch/onnx/importer.py ``_scan``).

# ---------------------------------------------------------------------------
# CNTK.proto subset (field numbers frozen by protobuf compatibility)
# ---------------------------------------------------------------------------

_CNTK_SCHEMAS = {
    "CntkNDShape": [F(1, "shape_dim", "int64", repeated=True)],
    "CntkAxis": [
        F(1, "static_axis_idx", "int64"),
        F(2, "name", "string"),
        F(3, "is_ordered_dynamic_axis", "int64"),
    ],
    "CntkFloatValues": [F(1, "value", "float", repeated=True)],
    "CntkDoubleValues": [F(1, "value", "double", repeated=True)],
    "CntkNDArrayView": [
        F(1, "data_type", "int64"),      # 1 = Float, 2 = Double
        F(2, "storage_format", "int64"),  # 0 = Dense
        F(3, "shape", "message", message="CntkNDShape"),
        F(4, "float_values", "message", message="CntkFloatValues"),
        F(5, "double_values", "message", message="CntkDoubleValues"),
    ],
    "CntkVector": [
        F(1, "value", "message", repeated=True,
          message="CntkDictionaryValue"),
    ],
    "CntkDictionary": [
        F(1, "version", "int64"),
        F(2, "data", "message", repeated=True,
          message="CntkDictionaryEntry"),
    ],
    "CntkDictionaryEntry": [  # protobuf map<string, DictionaryValue> entry
        F(1, "key", "string"),
        F(2, "value", "message", message="CntkDictionaryValue"),
    ],
    "CntkDictionaryValue": [
        F(1, "version", "int64"),
        F(2, "bool_value", "int64"),
        F(3, "int_value", "int64"),
        F(4, "size_t_value", "int64"),
        F(5, "float_value", "float"),
        F(6, "double_value", "double"),
        F(7, "string_value", "string"),
        F(8, "nd_shape_value", "message", message="CntkNDShape"),
        F(9, "axis_value", "message", message="CntkAxis"),
        F(10, "vector_value", "message", message="CntkVector"),
        F(11, "dictionary_value", "message", message="CntkDictionary"),
        F(12, "nd_array_view_value", "message", message="CntkNDArrayView"),
    ],
}
proto._SCHEMAS.update(_CNTK_SCHEMAS)

_INFERRED = (1 << 64) - 1  # NDShape::InferredDimension, wraps to -1 signed


class CntkAxisRef:
    __slots__ = ("static_axis_idx", "name")

    def __init__(self, idx: int, name: str = ""):
        self.static_axis_idx = int(idx)
        self.name = name


def _shape_dims(shape_msg: Msg) -> List[int]:
    return [int(d) for d in (shape_msg.shape_dim or [])]


def _ndarray_to_numpy(view: Msg) -> np.ndarray:
    dims = _shape_dims(view.shape) if view.shape is not None else []
    if int(view.storage_format or 0) != 0:
        raise NotImplementedError(
            "sparse NDArrayView payloads are not supported")
    if view.float_values is not None:
        flat = np.asarray(view.float_values.value, np.float32)
    elif view.double_values is not None:
        flat = np.asarray(view.double_values.value, np.float64)
    else:
        flat = np.zeros(0, np.float32)
    # CNTK stores column-major with fastest-varying dim first; reversing
    # the dims makes the row-major read correct
    return flat.reshape(tuple(reversed(dims))) if dims else flat


def _numpy_to_ndarray(arr: np.ndarray) -> Msg:
    view = Msg("CntkNDArrayView")
    view.data_type = 2 if arr.dtype == np.float64 else 1
    view.storage_format = 0
    shp = Msg("CntkNDShape")
    shp.shape_dim = [int(d) for d in reversed(arr.shape)]
    view.shape = shp
    vals = Msg("CntkDoubleValues" if arr.dtype == np.float64
               else "CntkFloatValues")
    vals.value = [float(v) for v in np.asarray(arr).reshape(-1)]
    if arr.dtype == np.float64:
        view.double_values = vals
    else:
        view.float_values = vals
    return view


def value_to_py(v: Msg) -> Any:
    """DictionaryValue -> python (dict / list / ndarray / scalar)."""
    if v.dictionary_value is not None:
        return dict_to_py(v.dictionary_value)
    if v.vector_value is not None:
        return [value_to_py(e) for e in v.vector_value.value]
    if v.nd_array_view_value is not None:
        return _ndarray_to_numpy(v.nd_array_view_value)
    if v.nd_shape_value is not None:
        return _shape_dims(v.nd_shape_value)
    if v.axis_value is not None:
        return CntkAxisRef(v.axis_value.static_axis_idx or 0,
                           v.axis_value.name or "")
    if v.string_value is not None:
        return v.string_value
    if v.float_value is not None:
        return float(v.float_value)
    if v.double_value is not None:
        return float(v.double_value)
    if v.size_t_value is not None:
        return int(v.size_t_value) & ((1 << 64) - 1)
    if v.int_value is not None:
        return int(v.int_value)
    if v.bool_value is not None:
        return bool(v.bool_value)
    return None  # proto3 default (False / 0 / "") never reaches the wire


def dict_to_py(d: Msg) -> Dict[str, Any]:
    return {e.key: value_to_py(e.value) for e in (d.data or [])}


def py_to_value(v: Any) -> Msg:
    out = Msg("CntkDictionaryValue")
    out.version = 1
    if isinstance(v, dict):
        out.dictionary_value = py_to_dict(v)
    elif isinstance(v, (list, tuple)) and not isinstance(v, str):
        if v and all(isinstance(x, (int, np.integer)) for x in v):
            shp = Msg("CntkNDShape")
            shp.shape_dim = [int(x) for x in v]
            out.nd_shape_value = shp
        else:
            vec = Msg("CntkVector")
            vec.value = [py_to_value(x) for x in v]
            out.vector_value = vec
    elif isinstance(v, np.ndarray):
        out.nd_array_view_value = _numpy_to_ndarray(v)
    elif isinstance(v, CntkAxisRef):
        ax = Msg("CntkAxis")
        ax.static_axis_idx = v.static_axis_idx
        ax.name = v.name
        out.axis_value = ax
    elif isinstance(v, bool):
        out.bool_value = int(v)
    elif isinstance(v, (int, np.integer)):
        # CNTK keeps signed attribute ints (slice begin/end) in
        # int_value; size_t_value is unsigned and would mask negatives
        # into 2^64-range garbage on the read side
        if int(v) < 0:
            out.int_value = int(v)
        else:
            out.size_t_value = int(v)
    elif isinstance(v, float):
        out.double_value = v
    elif isinstance(v, str):
        out.string_value = v
    else:
        raise TypeError(f"cannot serialize {type(v)} into a CNTK "
                        f"DictionaryValue")
    return out


def py_to_dict(d: Dict[str, Any]) -> Msg:
    out = Msg("CntkDictionary")
    out.version = 1
    entries = []
    for k, v in d.items():
        e = Msg("CntkDictionaryEntry")
        e.key = k
        e.value = py_to_value(v)
        entries.append(e)
    out.data = entries
    return out


def load_model_dictionary(payload: bytes) -> Dict[str, Any]:
    return dict_to_py(proto.decode("CntkDictionary", payload))


# ---------------------------------------------------------------------------
# PrimitiveOpType (CNTK 2.x PrimitiveOpType.h enum order)
# ---------------------------------------------------------------------------

OP_NEGATE, OP_SIGMOID, OP_TANH, OP_RELU, OP_EXP, OP_LOG, OP_SQRT = range(7)
OP_FLOOR, OP_ABS, OP_RECIPROCAL, OP_SOFTMAX, OP_HARDMAX = 7, 8, 9, 10, 11
OP_TRANSPOSE_AXES, OP_WHERE, OP_SLICE, OP_DROPOUT, OP_RESHAPE = 12, 13, 14, 15, 16
OP_POOLING, OP_SUM_ALL, OP_PLUS, OP_LOG_PLUS, OP_MINUS = 17, 18, 19, 20, 21
OP_ELEMENT_TIMES, OP_EQUAL, OP_NOT_EQUAL, OP_LESS = 22, 23, 24, 25
OP_LESS_EQUAL, OP_GREATER, OP_GREATER_EQUAL = 26, 27, 28
OP_TIMES, OP_TRANSPOSE_TIMES, OP_CONVOLUTION = 32, 33, 34
OP_PAST_VALUE, OP_FUTURE_VALUE, OP_REDUCE_ELEMENTS = 38, 39, 40
OP_BATCH_NORM, OP_CLIP, OP_SELECT, OP_SPLICE, OP_COMBINE = 41, 42, 43, 44, 45
OP_OPTIMIZED_RNN = 50
OP_LOG_SOFTMAX, OP_NO_OP, OP_STOP_GRADIENT, OP_ELU = 52, 56, 58, 59

_UNARY = {
    OP_NEGATE: "Neg", OP_SIGMOID: "Sigmoid", OP_TANH: "Tanh",
    OP_RELU: "Relu", OP_EXP: "Exp", OP_LOG: "Log", OP_SQRT: "Sqrt",
    OP_FLOOR: "Floor", OP_ABS: "Abs", OP_RECIPROCAL: "Reciprocal",
    OP_ELU: "Elu",
}
_BINARY = {OP_PLUS: "Add", OP_MINUS: "Sub", OP_ELEMENT_TIMES: "Mul"}


class _Var:
    __slots__ = ("uid", "kind", "shape", "value", "name")

    def __init__(self, d: Dict[str, Any]):
        self.uid = d["uid"]
        self.kind = int(d.get("kind", 0))
        self.shape = [int(s) for s in d.get("shape", [])]
        self.value = d.get("value")
        self.name = d.get("name", "")


VAR_INPUT, VAR_OUTPUT, VAR_PARAMETER, VAR_CONSTANT, VAR_PLACEHOLDER = range(5)


class _Emitter:
    """Lowers CNTK primitive functions into one GraphBuilder.

    Reused by the recurrent path for Scan bodies: ``alias`` pre-maps
    tensor uids onto existing onnx names (state inputs / per-timestep
    scan slices), and ``seq_inputs`` marks model inputs that carry a
    sequence axis (declared ``[N, T, ...]`` instead of ``[N, ...]``)."""

    def __init__(self, g: GraphBuilder, variables: Dict[str, "_Var"],
                 seq_inputs: frozenset = frozenset()):
        self.g = g
        self.variables = variables
        self.seq_inputs = seq_inputs
        self.names: Dict[Any, str] = {}
        self.last_output: Optional[str] = None

    def alias(self, tensor_uid: str, onnx_name: str):
        self.names[(tensor_uid, False)] = onnx_name

    def resolve(self, uid: str, transpose_param: bool = False) -> str:
        # a shared parameter may be consumed in BOTH orientations
        # (weight tying): the cache key carries the flip
        key = (uid, transpose_param)
        if key in self.names:
            return self.names[key]
        var = self.variables.get(uid)
        if var is None:
            raise KeyError(f"dangling variable uid {uid!r}")
        g = self.g
        if var.kind in (VAR_PARAMETER, VAR_CONSTANT):
            arr = np.asarray(var.value)
            if transpose_param:
                arr = np.ascontiguousarray(arr.T)
            nm = g.add_initializer(g.fresh(var.name or uid), arr)
        elif var.kind == VAR_INPUT:
            if transpose_param:
                raise NotImplementedError(
                    "Times with a non-parameter weight operand needs a "
                    "runtime transpose; export to ONNX with the cntk "
                    "package for this graph")
            dyn = ["N", "T"] if uid in self.seq_inputs else ["N"]
            nm = g.add_input(var.name or uid, np.float32,
                             dyn + list(reversed(var.shape)))
        else:
            raise ValueError(f"unresolvable variable {uid!r} "
                             f"(kind={var.kind})")
        self.names[key] = nm
        return nm

    @staticmethod
    def np_axis(attr) -> int:
        k = attr.static_axis_idx if isinstance(attr, CntkAxisRef) \
            else int(attr)
        return -(k + 1)

    def is_param(self, uid: str) -> bool:
        v = self.variables.get(uid)
        return v is not None and v.kind in (VAR_PARAMETER, VAR_CONSTANT)

    def emit(self, fd: Dict[str, Any]) -> Optional[str]:
        g, names = self.g, self.names
        resolve, np_axis, is_param = self.resolve, self.np_axis, self.is_param
        variables = self.variables
        op = int(fd["op"])
        uid = fd["uid"]
        ins: List[str] = list(fd.get("inputs", []))
        attrs: Dict[str, Any] = fd.get("attributes", {}) or {}
        out_name = f"{uid}_Output_0"

        if op in _UNARY:
            y = g.add_node(_UNARY[op], [resolve(ins[0])])
        elif op in _BINARY:
            y = g.add_node(_BINARY[op], [resolve(ins[0]), resolve(ins[1])])
        elif op in (OP_SOFTMAX, OP_LOG_SOFTMAX):
            y = g.add_node("Softmax" if op == OP_SOFTMAX else "LogSoftmax",
                           [resolve(ins[0])], axis=-1)
        elif op in (OP_TIMES, OP_TRANSPOSE_TIMES):
            # Times(x, W): y[o] = sum_i x[i] W[i,o]; the reversed-dims
            # numpy read gives W_np[o,i], so the initializer transposes
            # back. Times(W, x) (C++ arg order, W (out,in) -> W_np (in,
            # out)) multiplies directly. TransposeTimes flips once more.
            if int(attrs.get("outputRank", 1)) != 1:
                raise NotImplementedError("Times with outputRank != 1")
            p_right = is_param(ins[1]) and not is_param(ins[0])
            if p_right:
                x_uid, w_uid = ins[0], ins[1]
            else:
                w_uid, x_uid = ins[0], ins[1]
            flip = p_right != (op == OP_TRANSPOSE_TIMES)
            y = g.add_node("MatMul", [resolve(x_uid),
                                      resolve(w_uid, transpose_param=flip)])
        elif op == OP_CONVOLUTION:
            w_uid, x_uid = ins[0], ins[1]
            strides = list(reversed(attrs.get("strides", [1, 1])))
            auto = attrs.get("autoPadding", [True])
            kern = np.asarray(variables[w_uid].value)  # (Cout,Cin,kH,kW)
            kw = dict(strides=[int(s) for s in strides[-2:]] or [1, 1],
                      kernel_shape=[int(k) for k in kern.shape[2:]])
            if any(bool(a) for a in auto):
                kw["auto_pad"] = "SAME_UPPER"
            y = g.add_node("Conv", [resolve(x_uid), resolve(w_uid)], **kw)
        elif op == OP_POOLING:
            window = list(reversed(attrs.get("poolingWindowShape", [])))
            strides = list(reversed(attrs.get("strides", window)))
            auto = attrs.get("autoPadding", [False])
            kw = dict(kernel_shape=[int(k) for k in window],
                      strides=[int(s) for s in strides] or None)
            if kw["strides"] is None:
                kw.pop("strides")
            if any(bool(a) for a in auto):
                kw["auto_pad"] = "SAME_UPPER"
            pool = "MaxPool" if int(attrs.get("poolingType", 0)) == 0 \
                else "AveragePool"
            y = g.add_node(pool, [resolve(ins[0])], **kw)
        elif op == OP_BATCH_NORM:
            # CNTK input order: (x, scale, bias, runMean, runVar[, count])
            y = g.add_node(
                "BatchNormalization",
                [resolve(ins[0]), resolve(ins[1]), resolve(ins[2]),
                 resolve(ins[3]), resolve(ins[4])],
                epsilon=float(attrs.get("epsilon", 1e-5)))
        elif op == OP_RESHAPE:
            new_shape = [int(s) for s in attrs.get("newShape", [])]
            tgt = [0] + [(-1 if s in (_INFERRED, -1) else s)
                         for s in reversed(new_shape)]
            shp = g.add_initializer(
                g.fresh("reshape_target"), np.asarray(tgt, np.int64))
            y = g.add_node("Reshape", [resolve(ins[0]), shp])
        elif op == OP_SPLICE:
            y = g.add_node("Concat", [resolve(i) for i in ins],
                           axis=np_axis(attrs.get("axis", 0)))
        elif op == OP_SLICE:
            ax = np_axis(attrs.get("axis", 0))
            end = int(attrs.get("endIndex", 0))
            # CNTK convention: endIndex 0 means "through the end of the
            # axis" (negative ends count from the end, like ONNX)
            if end == 0:
                end = np.iinfo(np.int64).max
            starts = g.add_initializer(g.fresh("sl_s"), np.asarray(
                [int(attrs.get("beginIndex", 0))], np.int64))
            ends = g.add_initializer(g.fresh("sl_e"), np.asarray(
                [end], np.int64))
            axes = g.add_initializer(g.fresh("sl_a"), np.asarray(
                [ax], np.int64))
            y = g.add_node("Slice", [resolve(ins[0]), starts, ends, axes])
        elif op == OP_TRANSPOSE_AXES:
            a1 = np_axis(attrs.get("axis1", 0))
            a2 = np_axis(attrs.get("axis2", 1))
            var = variables.get(ins[0])
            if var is None:
                raise NotImplementedError(
                    "TransposeAxes on intermediate tensors needs shape "
                    "propagation; re-export via ONNX for this graph")
            # only data INPUTS carry the implicit leading batch dim;
            # parameters/constants are emitted at their own rank
            rank = len(var.shape) + (1 if var.kind == VAR_INPUT else 0)
            perm = list(range(rank))
            perm[a1 % rank], perm[a2 % rank] = perm[a2 % rank], perm[a1 % rank]
            y = g.add_node("Transpose", [resolve(ins[0])], perm=perm)
        elif op == OP_REDUCE_ELEMENTS:
            red = {"Sum": "ReduceSum", "Mean": "ReduceMean",
                   "Max": "ReduceMax", "Min": "ReduceMin"}.get(
                str(attrs.get("reductionOpName", "Sum")))
            if red is None:
                raise NotImplementedError(
                    f"ReduceElements op "
                    f"{attrs.get('reductionOpName')!r}")
            axes = g.add_initializer(g.fresh("red_axes"), np.asarray(
                [np_axis(attrs.get("axis", 0))], np.int64))
            y = g.add_node(
                red, [resolve(ins[0]), axes],
                keepdims=int(bool(attrs.get("reductionKeepDimensions",
                                            True))))
        elif op == OP_CLIP:
            y = g.add_node("Clip", [resolve(ins[0]), resolve(ins[1]),
                                    resolve(ins[2])])
        elif op in (OP_DROPOUT, OP_NO_OP, OP_STOP_GRADIENT):
            y = g.add_node("Identity", [resolve(ins[0])])
        elif op == OP_OPTIMIZED_RNN:
            y = _emit_optimized_rnn(self, ins, attrs)
        elif op == OP_COMBINE:
            for j, i_uid in enumerate(ins):
                names[(f"{uid}_Output_{j}", False)] = resolve(i_uid)
            self.last_output = names[(f"{uid}_Output_0", False)]
            return self.last_output
        elif op in (OP_PAST_VALUE, OP_FUTURE_VALUE):
            raise AssertionError(
                "recurrent state nodes must be handled by the Scan "
                "lowering, never emitted directly")
        else:
            raise NotImplementedError(
                f"CNTK primitive op code {op} ({fd.get('name') or uid}) "
                f"is outside the supported feedforward surface; export "
                f"to ONNX with the cntk package for full coverage")
        names[(out_name, False)] = y
        self.last_output = y
        return y


def _emit_optimized_rnn(em: "_Emitter", ins: List[str],
                        attrs: Dict[str, Any]) -> str:
    """OptimizedRNNStack: the fused cuDNN RNN op GPU-trained CNTK models
    carry (the zoo BiLSTM family). The single packed weight Parameter is
    unpacked per the cuDNN canonical layout — all gate matrices for every
    pseudo-layer (layer-major, direction-minor; W blocks then R blocks,
    gate order i,f,c,o for LSTM / r,u,c for GRU), followed by all bias
    vectors (bW then bR per pseudo-layer) — and re-emitted as standard
    ONNX LSTM/GRU/RNN nodes per layer, which the importer lowers to
    ``lax.scan`` (gate reorder to ONNX's i,o,f,c / z,r,h; cuDNN's
    recurrent-side GRU reset placement maps to linear_before_reset=1).
    The blob size must factor exactly as that layout demands — a
    mismatch raises rather than mis-slicing weights.
    """
    g = em.g
    if em.is_param(ins[0]) and not em.is_param(ins[1]):
        w_uid, x_uid = ins[0], ins[1]
    else:
        x_uid, w_uid = ins[0], ins[1]
    wv = em.variables.get(w_uid)
    if wv is None or wv.value is None:
        raise NotImplementedError(
            "OptimizedRNNStack needs its weights as a stored Parameter")
    blob = np.asarray(wv.value, np.float32).reshape(-1)
    H = int(attrs.get("hiddenSize", 0))
    L = int(attrs.get("numLayers", 1))
    bidir = bool(attrs.get("bidirectional", False))
    rec_op = str(attrs.get("recurrentOp", "lstm"))
    dirs = 2 if bidir else 1
    G = {"lstm": 4, "gru": 3, "rnnTanh": 1, "rnnReLU": 1}.get(rec_op)
    if G is None:
        raise NotImplementedError(
            f"OptimizedRNNStack recurrentOp {rec_op!r}")
    if H <= 0:
        raise ValueError("OptimizedRNNStack without hiddenSize")
    # solve the input width E from the blob size (layer 0 consumes E,
    # deeper layers consume H*dirs)
    rest = (L - 1) * dirs * G * H * (H * dirs + H + 2)
    den = dirs * G * H
    num = blob.size - rest
    if num <= 0 or num % den or num // den - H - 2 <= 0:
        raise ValueError(
            f"OptimizedRNNStack weight blob of {blob.size} floats does "
            f"not factor for hiddenSize={H} numLayers={L} dirs={dirs} "
            f"op={rec_op!r} under the cuDNN canonical layout")
    E = num // den - H - 2

    # onnx gate order from cudnn order
    reorder = {"lstm": [0, 3, 1, 2],   # i,f,c,o -> i,o,f,c
               "gru": [1, 0, 2]}.get(rec_op, [0])  # r,u,c -> z,r,h
    onnx_op = {"lstm": "LSTM", "gru": "GRU"}.get(rec_op, "RNN")

    pos = 0

    def take(n):
        nonlocal pos
        out = blob[pos:pos + n]
        pos += n
        return out

    mats = []   # per pseudo-layer: (W [G,H,in], R [G,H,H])
    for layer in range(L):
        in_l = E if layer == 0 else H * dirs
        for _ in range(dirs):
            wg = np.stack([take(H * in_l).reshape(H, in_l)
                           for _ in range(G)])
            rg = np.stack([take(H * H).reshape(H, H) for _ in range(G)])
            mats.append((wg, rg))
    biases = []  # per pseudo-layer: (bW [G,H], bR [G,H])
    for _ in range(L * dirs):
        bw = np.stack([take(H) for _ in range(G)])
        br = np.stack([take(H) for _ in range(G)])
        biases.append((bw, br))
    assert pos == blob.size

    # [N, T, E] -> [T, N, E] once; stay [T, N, *] between layers
    x = g.add_node("Transpose", [em.resolve(x_uid)], perm=[1, 0, 2])
    for layer in range(L):
        W = np.stack([mats[layer * dirs + d][0][reorder].reshape(
            G * H, -1) for d in range(dirs)])
        R = np.stack([mats[layer * dirs + d][1][reorder].reshape(
            G * H, H) for d in range(dirs)])
        B = np.stack([np.concatenate(
            [biases[layer * dirs + d][0][reorder].reshape(-1),
             biases[layer * dirs + d][1][reorder].reshape(-1)])
            for d in range(dirs)])
        kw: Dict[str, Any] = dict(
            hidden_size=H,
            direction="bidirectional" if bidir else "forward")
        if rec_op == "gru":
            kw["linear_before_reset"] = 1
        if rec_op == "rnnReLU":
            kw["activations"] = ["Relu"] * dirs
        y = g.add_node(
            onnx_op,
            [x,
             g.add_initializer(g.fresh("rnn_w"), W.astype(np.float32)),
             g.add_initializer(g.fresh("rnn_r"), R.astype(np.float32)),
             g.add_initializer(g.fresh("rnn_b"), B.astype(np.float32))],
            **kw)
        # Y [T, dirs, N, H] -> [T, N, dirs*H] for the next layer
        y = g.add_node("Transpose", [y], perm=[0, 2, 1, 3])
        shp = g.add_initializer(g.fresh("rnn_shape"),
                                np.asarray([0, 0, dirs * H], np.int64))
        x = g.add_node("Reshape", [y, shp])
    # back to the [N, T, feat] convention
    return g.add_node("Transpose", [x], perm=[1, 0, 2])


def cntk_to_onnx(payload: bytes,
                 parsed: Optional[Dict[str, Any]] = None) -> bytes:
    """Parse ``.model`` bytes and re-emit the graph as ONNX bytes.
    ``parsed`` skips the (pure-Python, weight-heavy) protobuf decode when
    the caller already holds the Dictionary from the sniff. Recurrent
    graphs (PastValue/FutureValue cycles) lower through ONNX Scan — see
    :func:`_recurrent_to_onnx`."""
    top = parsed if parsed is not None else load_model_dictionary(payload)
    if top.get("type") != "CompositeFunction":
        raise ValueError(
            f"not a CNTK v2 CompositeFunction dictionary "
            f"(type={top.get('type')!r})")
    variables = {v["uid"]: _Var(v) for v in top.get("inputs", [])}
    functions = top.get("primitive_functions", [])
    root = top.get("root")

    g = GraphBuilder(name=top.get("name") or "cntk_model", opset=17)
    if any(int(fd["op"]) in (OP_PAST_VALUE, OP_FUTURE_VALUE,
                             OP_OPTIMIZED_RNN)
           for fd in functions):
        # sequence-model path: inputs feeding recurrences carry [N, T]
        return _recurrent_to_onnx(g, variables, functions, root)

    em = _Emitter(g, variables)
    for fd in functions:
        em.emit(fd)
    out_uid = f"{root}_Output_0" if root else None
    out_name = em.names.get((out_uid, False), em.last_output)
    if out_name is None:
        raise ValueError("model has no computable output")
    g.add_output(out_name, np.float32, None)
    return g.to_bytes(producer="synapseml_tpu.dl.cntk_format")


def _recurrent_to_onnx(g: GraphBuilder, variables: Dict[str, _Var],
                       functions: List[Dict[str, Any]],
                       root: Optional[str]) -> bytes:
    """Lower a CNTK v2 graph whose PastValue/FutureValue nodes form
    recurrence cycles.

    TPU-native design: each cycle becomes ONE ONNX ``Scan`` node, which
    the importer lowers to ``lax.scan`` (one compiled body — no
    per-timestep Python); everything OUTSIDE the cycles stays vectorized
    over the whole ``[N, T, ...]`` sequence, so the input projection
    ``x_t @ W`` for all t is a single MXU matmul instead of T small ones.
    The reference executes these graphs natively via ``Function.load``
    (deep-learning/.../cntk/SerializableFunction.scala:85-143 — the
    BiLSTM zoo); here the sequence convention is: every model INPUT that
    (transitively) feeds a recurrence carries CNTK's default
    [batch, time] dynamic-axis pair, other inputs just [batch].

    Supported: offset-1 Past/FutureValue, any number of state variables
    per cycle (LSTM h+c merge into one body), stacked and backward
    recurrences. A cycle mixing Past and Future (a true bidirectional
    loop, not two separate cycles) cannot be a single scan and raises.
    """
    fns = {fd["uid"]: fd for fd in functions}
    producer: Dict[str, str] = {}
    for fd in functions:
        n_out = len(fd.get("inputs", [])) \
            if int(fd["op"]) == OP_COMBINE else 1
        for j in range(n_out):
            producer[f"{fd['uid']}_Output_{j}"] = fd["uid"]
    consumers: Dict[str, List[str]] = {}
    for fd in functions:
        for i in fd.get("inputs", []):
            p = producer.get(i)
            if p is not None:
                consumers.setdefault(p, []).append(fd["uid"])

    def ancestors_of(tensor: str) -> set:
        out: set = set()
        stack = [producer[tensor]] if tensor in producer else []
        while stack:
            u = stack.pop()
            if u in out:
                continue
            out.add(u)
            for i in fns[u].get("inputs", []):
                p = producer.get(i)
                if p is not None and p not in out:
                    stack.append(p)
        return out

    def descendants_of(uid: str) -> set:
        out: set = set()
        stack = [uid]
        while stack:
            for c in consumers.get(stack.pop(), []):
                if c not in out:
                    out.add(c)
                    stack.append(c)
        return out

    pvs = [fd for fd in functions
           if int(fd["op"]) in (OP_PAST_VALUE, OP_FUTURE_VALUE)]
    for pv in pvs:
        if int((pv.get("attributes") or {}).get("offset", 1)) != 1:
            raise NotImplementedError(
                "PastValue/FutureValue with offset != 1 is not supported")

    # one group per recurrence cycle; overlapping cycles merge (LSTM's
    # h and c share a body). ``order`` fixes the serialization order so
    # set iteration can never leak into the emitted bytes.
    order = {fd["uid"]: i for i, fd in enumerate(functions)}
    groups: List[Dict[str, Any]] = []
    for pv in pvs:
        cyc = descendants_of(pv["uid"]) & ancestors_of(pv["inputs"][0])
        cyc.add(pv["uid"])
        groups.append({"nodes": cyc, "pvs": [pv], "order": order})
    merged = True
    while merged:
        merged = False
        for i in range(len(groups)):
            for j in range(i + 1, len(groups)):
                if groups[i]["nodes"] & groups[j]["nodes"]:
                    groups[i]["nodes"] |= groups[j]["nodes"]
                    groups[i]["pvs"] += groups[j]["pvs"]
                    del groups[j]
                    merged = True
                    break
            if merged:
                break
    in_group: Dict[str, Dict[str, Any]] = {}
    for grp in groups:
        for u in grp["nodes"]:
            in_group[u] = grp

    # model inputs feeding any cycle (or a fused cuDNN RNN stack) carry
    # the sequence axis
    seq_inputs: set = set()
    rnn_stacks = [fd["uid"] for fd in functions
                  if int(fd["op"]) == OP_OPTIMIZED_RNN]
    for grp in groups + ([{"nodes": set(rnn_stacks)}] if rnn_stacks
                         else []):
        seen: set = set()
        stack = list(grp["nodes"])
        while stack:
            u = stack.pop()
            if u in seen:
                continue
            seen.add(u)
            for i in fns[u].get("inputs", []):
                p = producer.get(i)
                if p is not None:
                    stack.append(p)
                else:
                    v = variables.get(i)
                    if v is not None and v.kind == VAR_INPUT:
                        seq_inputs.add(i)

    outer = _Emitter(g, variables, seq_inputs=frozenset(seq_inputs))

    def infer_last_dim(tensor: str,
                       _seen: Optional[set] = None) -> Optional[int]:
        """Static trailing dim (state width) — needed when a scalar
        initial_state must Expand to [N, H]. ``_seen`` breaks the
        recurrence back-edge (the walk re-enters the cycle through the
        state node and must answer from a sibling operand instead)."""
        _seen = set() if _seen is None else _seen
        if tensor in _seen:
            return None
        _seen.add(tensor)
        v = variables.get(tensor)
        if v is not None:
            shape = tuple(reversed(v.shape))
            return int(shape[-1]) if shape else None
        u = producer.get(tensor)
        if u is None:
            return None
        fd = fns[u]
        op, ins = int(fd["op"]), list(fd.get("inputs", []))
        if op in _UNARY or op in (OP_PAST_VALUE, OP_FUTURE_VALUE,
                                  OP_DROPOUT, OP_NO_OP, OP_STOP_GRADIENT,
                                  OP_SOFTMAX, OP_LOG_SOFTMAX):
            return infer_last_dim(ins[0], _seen)
        if op in _BINARY:
            for i in ins:
                d = infer_last_dim(i, _seen)
                if d is not None and d != 1:
                    return d
            return None
        if op in (OP_TIMES, OP_TRANSPOSE_TIMES):
            p_right = (variables.get(ins[1]) is not None
                       and variables[ins[1]].kind in (VAR_PARAMETER,
                                                      VAR_CONSTANT)
                       and not (variables.get(ins[0]) is not None
                                and variables[ins[0]].kind in
                                (VAR_PARAMETER, VAR_CONSTANT)))
            w_uid = ins[1] if p_right else ins[0]
            wv = variables.get(w_uid)
            if wv is None or wv.value is None:
                return None
            w = np.asarray(wv.value)
            flip = p_right != (op == OP_TRANSPOSE_TIMES)
            w = w.T if flip else w
            return int(w.shape[-1])
        return None

    def resolvable(tensor: str) -> bool:
        return tensor in variables or (tensor, False) in outer.names

    root_tensor = f"{root}_Output_0" if root else None
    pending_fns = [fd for fd in functions if fd["uid"] not in in_group]
    pending_groups = list(groups)
    while pending_fns or pending_groups:
        progress = False
        for fd in list(pending_fns):
            if all(resolvable(i) for i in fd.get("inputs", [])):
                outer.emit(fd)
                pending_fns.remove(fd)
                progress = True
        for grp in list(pending_groups):
            if _group_ready(grp, fns, producer, variables, outer,
                            in_group):
                _emit_scan_group(g, outer, grp, fns, functions, producer,
                                 consumers, variables, infer_last_dim,
                                 root_tensor, in_group)
                pending_groups.remove(grp)
                progress = True
        if not progress:
            raise NotImplementedError(
                "could not schedule the recurrent graph: a dependency "
                "cycle crosses recurrence bodies in an unsupported way")

    out_name = outer.names.get((root_tensor, False), outer.last_output)
    if out_name is None:
        raise ValueError("model has no computable output")
    g.add_output(out_name, np.float32, None)
    return g.to_bytes(producer="synapseml_tpu.dl.cntk_format")


def _has_seq_ancestry(tensor: str, fns, producer, variables,
                      in_group) -> bool:
    """True when ``tensor`` transitively depends on a model INPUT or on
    another recurrence's output — i.e. it carries the [N, T] axes. A
    purely parameter-derived tensor (e.g. a bias combined outside the
    cycle) does NOT, and scanning it would slice its feature axis as if
    it were time."""
    seen: set = set()
    stack = [tensor]
    while stack:
        t = stack.pop()
        if t in seen:
            continue
        seen.add(t)
        v = variables.get(t)
        if v is not None:
            if v.kind == VAR_INPUT:
                return True
            continue  # parameter/constant
        u = producer.get(t)
        if u is None:
            continue
        if u in in_group:
            return True  # another cycle's scan output: [N, T, ...]
        stack.extend(fns[u].get("inputs", []))
    return False


def _group_crossing(grp, fns, producer, variables,
                    in_group) -> Tuple[List[str], List[str]]:
    """Split tensors consumed inside the cycle but produced outside it
    into (per-timestep scan inputs, static outer-scope captures).
    Parameters/constants resolve inside the body; state-node inputs are
    handled separately. Static tensors (param-derived, no [N, T] axes)
    ride as outer-scope name captures — ONNX subgraphs see enclosing
    names, and the importer's body env carries them."""
    crossing: List[str] = []
    captured: List[str] = []
    nodes = grp["nodes"]
    pv_uids = {pv["uid"] for pv in grp["pvs"]}
    # deterministic order (serialization order, not set order): scan-input
    # ordering decides the emitted bytes and the Shape source tensor
    ordered = sorted(nodes, key=grp["order"].__getitem__)
    for fd in (fns[u] for u in ordered):
        if fd["uid"] in pv_uids:
            continue
        for i in fd.get("inputs", []):
            p = producer.get(i)
            if p is not None and p in nodes:
                continue  # internal to the body
            v = variables.get(i)
            if v is not None and v.kind in (VAR_PARAMETER, VAR_CONSTANT):
                continue  # body-local initializer
            if i in crossing or i in captured:
                continue
            if _has_seq_ancestry(i, fns, producer, variables, in_group):
                crossing.append(i)
            else:
                captured.append(i)
    return crossing, captured


def _group_ready(grp, fns, producer, variables, outer, in_group) -> bool:
    crossing, captured = _group_crossing(grp, fns, producer, variables,
                                         in_group)
    return all(t in variables or (t, False) in outer.names
               for t in crossing + captured)


def _emit_scan_group(g, outer, grp, fns, functions, producer, consumers,
                     variables, infer_last_dim, root_tensor, in_group):
    """Emit one recurrence cycle as an ONNX Scan node."""
    pvs = grp["pvs"]
    nodes = grp["nodes"]
    pv_ops = {int(pv["op"]) for pv in pvs}
    if len(pv_ops) > 1:
        raise NotImplementedError(
            "a single recurrence cycle mixes PastValue and FutureValue "
            "(a true bidirectional loop); split the graph or export via "
            "ONNX")
    backward = OP_FUTURE_VALUE in pv_ops
    pv_uids = {pv["uid"] for pv in pvs}
    body_fns = [fd for fd in functions
                if fd["uid"] in nodes and fd["uid"] not in pv_uids]
    crossing, captured = _group_crossing(grp, fns, producer, variables,
                                         in_group)
    if not crossing:
        raise NotImplementedError(
            "autonomous recurrence (no sequence input feeds the cycle) "
            "has no scan length; not supported")

    # -- body graph: inputs [states..., x_t slices...] -------------------
    body_name = g.fresh("scan_body")
    # prefix namespaces body tensor names: a bare body-local name (e.g.
    # 'add_3') could shadow an identically-named captured outer tensor
    body_g = GraphBuilder(name=body_name, opset=17,
                          name_prefix=f"{body_name}__")
    body_em = _Emitter(body_g, variables)
    for k, pv in enumerate(pvs):
        st = body_g.add_input(f"state_{k}")
        body_em.alias(f"{pv['uid']}_Output_0", st)
    for j, t in enumerate(crossing):
        xt = body_g.add_input(f"xt_{j}")
        body_em.alias(t, xt)
    for t in captured:
        # static (param-derived) outer tensor: reference the OUTER name
        # from inside the body — ONNX outer-scope capture, which the
        # importer's body env provides
        body_em.alias(t, outer.resolve(t) if t in variables
                      else outer.names[(t, False)])
    remaining = list(body_fns)
    while remaining:
        progress = False
        for fd in list(remaining):
            if all((i, False) in body_em.names or i in variables
                   for i in fd.get("inputs", [])):
                body_em.emit(fd)
                remaining.remove(fd)
                progress = True
        if not progress:
            raise NotImplementedError(
                "unschedulable recurrence body (unexpected internal "
                "dependency shape)")

    # outputs: next-state per pv, then the tensors consumed downstream
    for pv in pvs:
        nm = body_em.names.get((pv["inputs"][0], False))
        if nm is None:
            raise NotImplementedError(
                f"recurrent input {pv['inputs'][0]!r} was not computed "
                "inside the cycle body")
        body_g.add_output(body_g.add_node("Identity", [nm]),
                          np.float32, None)
    scan_out_tensors: List[str] = []
    for fd in body_fns + pvs:
        n_out = len(fd.get("inputs", [])) \
            if int(fd["op"]) == OP_COMBINE else 1
        for j in range(n_out):
            t = f"{fd['uid']}_Output_{j}"
            used_outside = any(c not in nodes
                               for c in consumers.get(fd["uid"], []))
            if (used_outside or t == root_tensor) \
                    and t not in scan_out_tensors:
                scan_out_tensors.append(t)
    for t in scan_out_tensors:
        nm = body_em.names.get((t, False))
        if nm is None:
            raise NotImplementedError(
                f"cycle tensor {t!r} consumed downstream was not emitted")
        body_g.add_output(body_g.add_node("Identity", [nm]),
                          np.float32, None)

    # -- outer: initial states broadcast to [N, H] -----------------------
    def outer_name(t: str) -> str:
        return outer.resolve(t) if t in variables \
            else outer.names[(t, False)]

    first_seq = outer_name(crossing[0])
    init_names = []
    for pv in pvs:
        init_uid = pv["inputs"][1] if len(pv["inputs"]) > 1 else None
        iv = variables.get(init_uid) if init_uid else None
        if iv is None or iv.value is None:
            raise NotImplementedError(
                "PastValue initial state must be a constant/parameter")
        arr = np.asarray(iv.value, np.float32)
        declared = tuple(reversed(iv.shape))  # the DECLARED cntk shape:
        # scalar values decode as (1,) arrays, so arr.ndim can't tell
        # a scalar init apart from a genuine width-1 state
        if not declared:
            h = infer_last_dim(pv["inputs"][0])
            if h is None:
                raise NotImplementedError(
                    "cannot infer the state width for a scalar "
                    "initial_state; save the model with a full-shape "
                    "initial state")
            feat = np.asarray([h], np.int64)
            arr = arr.reshape(())  # Expand needs the scalar rank
        else:
            feat = np.asarray(list(declared), np.int64)
        init_c = g.add_initializer(g.fresh("rec_init"), arr)
        shp = g.add_node("Shape", [first_seq])
        n0 = g.add_node("Gather", [shp, g.add_initializer(
            g.fresh("idx0"), np.asarray([0], np.int64))], axis=0)
        tgt = g.add_node("Concat", [n0, g.add_initializer(
            g.fresh("rec_shape"), feat)], axis=0)
        init_names.append(g.add_node("Expand", [init_c, tgt]))

    scan_ins = [outer_name(t) for t in crossing]
    m, k_out = len(crossing), len(scan_out_tensors)
    node_outs = [g.fresh("rec_final") for _ in pvs] \
        + [g.fresh("rec_seq") for _ in scan_out_tensors]
    d = 1 if backward else 0
    g.add_node("Scan", init_names + scan_ins, outputs=node_outs,
               body=body_g.build().graph,
               num_scan_inputs=m,
               scan_input_axes=[1] * m,
               scan_output_axes=[1] * k_out,
               scan_input_directions=[d] * m,
               scan_output_directions=[d] * k_out)
    for t, nm in zip(scan_out_tensors, node_outs[len(pvs):]):
        outer.alias(t, nm)
        outer.last_output = nm


def sniff_cntk_v2(payload: bytes) -> Optional[Dict[str, Any]]:
    """Decode-and-sniff: the parsed Dictionary when the bytes are a v2
    CompositeFunction, else None. Returning the dict lets the caller
    skip a second full (pure-Python, weight-heavy) decode."""
    try:
        top = load_model_dictionary(payload)
    except Exception:  # noqa: BLE001 - any parse failure means "not cntk"
        return None
    return top if top.get("type") == "CompositeFunction" else None


def looks_like_cntk_v2(payload: bytes) -> bool:
    return sniff_cntk_v2(payload) is not None


# ---------------------------------------------------------------------------
# Authoring half (the publishing/export story + test vectors)
# ---------------------------------------------------------------------------

class CntkModelBuilder:
    """Compose a CNTK v2 ``.model`` byte blob (the serialization
    conventions the reader consumes: uid-wired primitive functions,
    ``_Output_k`` naming, reversed-dim NDShapes, column-major payloads).
    Used by the round-trip tests and available as an export target."""

    def __init__(self, name: str = "model"):
        self.name = name
        self._vars: List[Dict[str, Any]] = []
        self._funcs: List[Dict[str, Any]] = []
        self._n = 0

    def _uid(self, tag: str) -> str:
        self._n += 1
        return f"{tag}{self._n}"

    def add_input(self, sample_shape_np: Tuple[int, ...],
                  name: str = "features") -> str:
        uid = self._uid("Input")
        self._vars.append({
            "version": 1, "uid": uid, "kind": VAR_INPUT,
            "data_type": 1, "is_sparse": False, "name": name,
            "needs_gradient": False,
            "shape": [int(s) for s in reversed(sample_shape_np)],
        })
        return uid

    def add_parameter(self, arr_np: np.ndarray, name: str = "") -> str:
        """``arr_np`` in numpy layout; stored reversed/column-major."""
        uid = self._uid("Parameter")
        self._vars.append({
            "version": 1, "uid": uid, "kind": VAR_PARAMETER,
            "data_type": 1, "is_sparse": False,
            "name": name or uid, "needs_gradient": True,
            "shape": [int(s) for s in reversed(arr_np.shape)],
            "value": np.asarray(arr_np, np.float32),
        })
        return uid

    def add_op(self, op: int, inputs: List[str],
               attributes: Optional[Dict[str, Any]] = None,
               name: str = "") -> str:
        uid = self._uid("Func")
        self._funcs.append({
            "version": 1, "uid": uid, "op": int(op),
            "inputs": list(inputs),
            "attributes": dict(attributes or {}), "name": name,
        })
        return f"{uid}_Output_0"

    def set_input(self, func_output: str, idx: int, new_input: str):
        """Patch a function's input after the fact — how a recurrence
        cycle is closed (CNTK builds PastValue against a placeholder and
        rewires it to the step output; the serialized file stores the
        cyclic uid reference)."""
        uid = func_output.rsplit("_Output_", 1)[0]
        for f in self._funcs:
            if f["uid"] == uid:
                f["inputs"][idx] = new_input
                return
        raise KeyError(f"no function {uid!r}")

    def to_bytes(self, root_output: str) -> bytes:
        root = root_output.rsplit("_Output_", 1)[0]
        top = {
            "version": 1,
            "type": "CompositeFunction",
            "root": root,
            "uid": self._uid("Composite"),
            "name": self.name,
            "inputs": self._vars,
            "primitive_functions": self._funcs,
        }
        return proto.encode(py_to_dict(top))


def build_optimized_rnn_model(input_dim: int, hidden: int,
                              num_layers: int = 1,
                              bidirectional: bool = True,
                              cell: str = "lstm", seed: int = 0,
                              scale: float = 0.2,
                              bias_scale: float = 0.05) -> bytes:
    """Random-initialized OptimizedRNNStack ``.model`` bytes.

    Packs seeded weights in the cuDNN canonical blob layout (all (W, R)
    gate matrices per pseudo-layer first, then all (bW, bR) biases —
    the layout torch-oracle-verified in tests/test_cntk_format.py) and
    wraps them in a one-op CNTK v2 graph. The demo/e2e helper behind the
    speech scenario's recurrent stage; for real models, load the bytes
    CNTK wrote.
    """
    gates = {"lstm": 4, "gru": 3, "rnnTanh": 1, "rnnReLU": 1}[cell]
    rng = np.random.default_rng(seed)
    dirs = 2 if bidirectional else 1
    mats: List[np.ndarray] = []
    biases: List[np.ndarray] = []
    in_w = input_dim
    for _layer in range(num_layers):
        for _d in range(dirs):
            mats.append((rng.normal(size=(gates * hidden, in_w))
                         * scale).astype(np.float32).ravel())
            mats.append((rng.normal(size=(gates * hidden, hidden))
                         * scale).astype(np.float32).ravel())
            biases.append((rng.normal(size=gates * hidden)
                           * bias_scale).astype(np.float32))
            biases.append((rng.normal(size=gates * hidden)
                           * bias_scale).astype(np.float32))
        in_w = hidden * dirs
    b = CntkModelBuilder("optimized_rnn")
    x = b.add_input((input_dim,))
    y = b.add_op(OP_OPTIMIZED_RNN,
                 [x, b.add_parameter(np.concatenate(mats + biases))],
                 {"hiddenSize": hidden, "numLayers": num_layers,
                  "bidirectional": bidirectional, "recurrentOp": cell})
    return b.to_bytes(y)

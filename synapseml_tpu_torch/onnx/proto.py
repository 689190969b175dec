"""Self-contained ONNX protobuf wire codec (no ``onnx``/``protobuf`` deps).

The reference executes ONNX graphs through the onnxruntime JNI
(ref: deep-learning/src/main/scala/com/microsoft/ml/spark/onnx/ONNXModel.scala:173-193);
this package instead *imports* the graph and runs it as PyTorch ops
(see :mod:`synapseml_tpu_torch.onnx.importer`). That requires parsing the ``.onnx``
protobuf container, which this module does with a hand-rolled wire-format
codec: protobuf field numbers are frozen forever by compatibility rules, so the
small schema below (ModelProto / GraphProto / NodeProto / TensorProto /
AttributeProto / ValueInfoProto and friends) is stable across every ONNX
release. Both directions (decode for import, encode for export/test fixtures)
are supported.
"""
from __future__ import annotations

import struct
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

# ---------------------------------------------------------------------------
# Wire-format primitives
# ---------------------------------------------------------------------------

_WIRE_VARINT = 0
_WIRE_FIXED64 = 1
_WIRE_LEN = 2
_WIRE_FIXED32 = 5


def _read_varint(buf: bytes, pos: int) -> Tuple[int, int]:
    result = 0
    shift = 0
    while True:
        b = buf[pos]
        pos += 1
        result |= (b & 0x7F) << shift
        if not b & 0x80:
            return result, pos
        shift += 7
        if shift > 70:
            raise ValueError("malformed varint")


def _write_varint(out: bytearray, value: int):
    if value < 0:
        value &= (1 << 64) - 1  # two's-complement 64-bit, 10-byte encoding
    while True:
        b = value & 0x7F
        value >>= 7
        if value:
            out.append(b | 0x80)
        else:
            out.append(b)
            return


def _zigzag_signed(value: int) -> int:
    """Interpret an up-to-64-bit varint as a signed int64 (not zigzag —
    protobuf int64 fields use plain two's complement)."""
    value &= (1 << 64) - 1
    if value >= 1 << 63:
        value -= 1 << 64
    return value


# ---------------------------------------------------------------------------
# Declarative message schema
# ---------------------------------------------------------------------------

class F:
    """Field spec: wire number -> (python name, kind, repeated)."""

    __slots__ = ("num", "name", "kind", "repeated", "message")

    def __init__(self, num: int, name: str, kind: str, repeated: bool = False,
                 message: Optional[str] = None):
        self.num = num
        self.name = name
        self.kind = kind  # int64 | float | double | bytes | string | message
        self.repeated = repeated
        self.message = message  # schema key for kind == "message"


_SCHEMAS: Dict[str, List[F]] = {
    "ModelProto": [
        F(1, "ir_version", "int64"),
        F(2, "producer_name", "string"),
        F(3, "producer_version", "string"),
        F(4, "domain", "string"),
        F(5, "model_version", "int64"),
        F(6, "doc_string", "string"),
        F(7, "graph", "message", message="GraphProto"),
        F(8, "opset_import", "message", repeated=True, message="OperatorSetIdProto"),
    ],
    "OperatorSetIdProto": [
        F(1, "domain", "string"),
        F(2, "version", "int64"),
    ],
    "GraphProto": [
        F(1, "node", "message", repeated=True, message="NodeProto"),
        F(2, "name", "string"),
        F(5, "initializer", "message", repeated=True, message="TensorProto"),
        F(10, "doc_string", "string"),
        F(11, "input", "message", repeated=True, message="ValueInfoProto"),
        F(12, "output", "message", repeated=True, message="ValueInfoProto"),
        F(13, "value_info", "message", repeated=True, message="ValueInfoProto"),
    ],
    "NodeProto": [
        F(1, "input", "string", repeated=True),
        F(2, "output", "string", repeated=True),
        F(3, "name", "string"),
        F(4, "op_type", "string"),
        F(5, "attribute", "message", repeated=True, message="AttributeProto"),
        F(6, "doc_string", "string"),
        F(7, "domain", "string"),
    ],
    "AttributeProto": [
        F(1, "name", "string"),
        F(2, "f", "float"),
        F(3, "i", "int64"),
        F(4, "s", "bytes"),
        F(5, "t", "message", message="TensorProto"),
        F(6, "g", "message", message="GraphProto"),
        F(7, "floats", "float", repeated=True),
        F(8, "ints", "int64", repeated=True),
        F(9, "strings", "bytes", repeated=True),
        F(10, "tensors", "message", repeated=True, message="TensorProto"),
        F(11, "graphs", "message", repeated=True, message="GraphProto"),
        F(20, "type", "int64"),
    ],
    "TensorProto": [
        F(1, "dims", "int64", repeated=True),
        F(2, "data_type", "int64"),
        F(4, "float_data", "float", repeated=True),
        F(5, "int32_data", "int64", repeated=True),
        F(6, "string_data", "bytes", repeated=True),
        F(7, "int64_data", "int64", repeated=True),
        F(8, "name", "string"),
        F(9, "raw_data", "bytes"),
        F(10, "double_data", "double", repeated=True),
        F(11, "uint64_data", "int64", repeated=True),
        F(12, "doc_string", "string"),
        F(13, "external_data", "message", repeated=True,
          message="StringStringEntryProto"),
        F(14, "data_location", "int64"),  # 0 DEFAULT, 1 EXTERNAL
    ],
    "StringStringEntryProto": [
        F(1, "key", "string"),
        F(2, "value", "string"),
    ],
    "ValueInfoProto": [
        F(1, "name", "string"),
        F(2, "type", "message", message="TypeProto"),
        F(3, "doc_string", "string"),
    ],
    "TypeProto": [
        F(1, "tensor_type", "message", message="TypeProto.Tensor"),
    ],
    "TypeProto.Tensor": [
        F(1, "elem_type", "int64"),
        F(2, "shape", "message", message="TensorShapeProto"),
    ],
    "TensorShapeProto": [
        F(1, "dim", "message", repeated=True, message="TensorShapeProto.Dimension"),
    ],
    "TensorShapeProto.Dimension": [
        F(1, "dim_value", "int64"),
        F(2, "dim_param", "string"),
    ],
}

# AttributeProto.type enum values (onnx AttributeProto.AttributeType)
ATTR_FLOAT, ATTR_INT, ATTR_STRING, ATTR_TENSOR, ATTR_GRAPH = 1, 2, 3, 4, 5
ATTR_FLOATS, ATTR_INTS, ATTR_STRINGS, ATTR_TENSORS, ATTR_GRAPHS = 6, 7, 8, 9, 10


class Msg:
    """Generic decoded protobuf message; fields become attributes."""

    __slots__ = ("_schema", "__dict__")

    def __init__(self, schema: str, **kwargs):
        self._schema = schema
        for f in _SCHEMAS[schema]:
            setattr(self, f.name, [] if f.repeated else None)
        for k, v in kwargs.items():
            setattr(self, k, v)

    def __repr__(self):
        body = {f.name: getattr(self, f.name) for f in _SCHEMAS[self._schema]
                if getattr(self, f.name) not in (None, [])}
        return f"{self._schema}({body})"


# ---------------------------------------------------------------------------
# Decode
# ---------------------------------------------------------------------------

def decode(schema: str, buf: bytes) -> Msg:
    fields = {f.num: f for f in _SCHEMAS[schema]}
    msg = Msg(schema)
    pos, end = 0, len(buf)
    while pos < end:
        tag, pos = _read_varint(buf, pos)
        num, wire = tag >> 3, tag & 7
        f = fields.get(num)
        if f is None:  # unknown field: skip
            pos = _skip(buf, pos, wire)
            continue
        if f.kind == "message":
            assert wire == _WIRE_LEN
            ln, pos = _read_varint(buf, pos)
            sub = decode(f.message, buf[pos:pos + ln])
            pos += ln
            _store(msg, f, sub)
        elif f.kind in ("bytes", "string"):
            assert wire == _WIRE_LEN
            ln, pos = _read_varint(buf, pos)
            raw = buf[pos:pos + ln]
            pos += ln
            _store(msg, f, raw.decode("utf-8", "replace") if f.kind == "string" else bytes(raw))
        elif f.kind == "int64":
            if wire == _WIRE_LEN:  # packed repeated
                ln, pos = _read_varint(buf, pos)
                stop = pos + ln
                while pos < stop:
                    v, pos = _read_varint(buf, pos)
                    _store(msg, f, _zigzag_signed(v))
            else:
                v, pos = _read_varint(buf, pos)
                _store(msg, f, _zigzag_signed(v))
        elif f.kind == "float":
            if wire == _WIRE_LEN:
                ln, pos = _read_varint(buf, pos)
                vals = struct.unpack_from(f"<{ln // 4}f", buf, pos)
                pos += ln
                for v in vals:
                    _store(msg, f, v)
            else:
                (v,) = struct.unpack_from("<f", buf, pos)
                pos += 4
                _store(msg, f, v)
        elif f.kind == "double":
            if wire == _WIRE_LEN:
                ln, pos = _read_varint(buf, pos)
                vals = struct.unpack_from(f"<{ln // 8}d", buf, pos)
                pos += ln
                for v in vals:
                    _store(msg, f, v)
            else:
                (v,) = struct.unpack_from("<d", buf, pos)
                pos += 8
                _store(msg, f, v)
        else:
            raise ValueError(f"unhandled kind {f.kind}")
    return msg


def _store(msg: Msg, f: F, value: Any):
    if f.repeated:
        getattr(msg, f.name).append(value)
    else:
        setattr(msg, f.name, value)


def _skip(buf: bytes, pos: int, wire: int) -> int:
    if wire == _WIRE_VARINT:
        _, pos = _read_varint(buf, pos)
    elif wire == _WIRE_FIXED64:
        pos += 8
    elif wire == _WIRE_FIXED32:
        pos += 4
    elif wire == _WIRE_LEN:
        ln, pos = _read_varint(buf, pos)
        pos += ln
    else:
        raise ValueError(f"cannot skip wire type {wire}")
    return pos


# ---------------------------------------------------------------------------
# Encode
# ---------------------------------------------------------------------------

def encode(msg: Msg) -> bytes:
    out = bytearray()
    for f in _SCHEMAS[msg._schema]:
        val = getattr(msg, f.name)
        if val is None or (f.repeated and not val):
            continue
        values = val if f.repeated else [val]
        if f.kind == "message":
            for v in values:
                payload = encode(v)
                _write_varint(out, (f.num << 3) | _WIRE_LEN)
                _write_varint(out, len(payload))
                out.extend(payload)
        elif f.kind in ("bytes", "string"):
            for v in values:
                raw = v.encode("utf-8") if isinstance(v, str) else bytes(v)
                _write_varint(out, (f.num << 3) | _WIRE_LEN)
                _write_varint(out, len(raw))
                out.extend(raw)
        elif f.kind == "int64":
            if f.repeated and len(values) > 1:
                payload = bytearray()
                for v in values:
                    _write_varint(payload, int(v))
                _write_varint(out, (f.num << 3) | _WIRE_LEN)
                _write_varint(out, len(payload))
                out.extend(payload)
            else:
                for v in values:
                    _write_varint(out, (f.num << 3) | _WIRE_VARINT)
                    _write_varint(out, int(v))
        elif f.kind == "float":
            if f.repeated:
                payload = struct.pack(f"<{len(values)}f", *values)
                _write_varint(out, (f.num << 3) | _WIRE_LEN)
                _write_varint(out, len(payload))
                out.extend(payload)
            else:
                _write_varint(out, (f.num << 3) | _WIRE_FIXED32)
                out.extend(struct.pack("<f", values[0]))
        elif f.kind == "double":
            if f.repeated:
                payload = struct.pack(f"<{len(values)}d", *values)
                _write_varint(out, (f.num << 3) | _WIRE_LEN)
                _write_varint(out, len(payload))
                out.extend(payload)
            else:
                _write_varint(out, (f.num << 3) | _WIRE_FIXED64)
                out.extend(struct.pack("<d", values[0]))
    return bytes(out)


# ---------------------------------------------------------------------------
# TensorProto <-> numpy
# ---------------------------------------------------------------------------

# onnx TensorProto.DataType enum
TENSOR_DTYPES: Dict[int, Any] = {
    1: np.float32, 2: np.uint8, 3: np.int8, 4: np.uint16, 5: np.int16,
    6: np.int32, 7: np.int64, 9: np.bool_, 10: np.float16, 11: np.float64,
    12: np.uint32, 13: np.uint64,
}
NP_TO_ONNX = {np.dtype(v): k for k, v in TENSOR_DTYPES.items()}
_NP_TO_ONNX = NP_TO_ONNX  # back-compat alias
DTYPE_STRING = 8
DTYPE_BFLOAT16 = 16

try:  # numpy bfloat16 tensors need ml_dtypes where it is installed
    import ml_dtypes
    TENSOR_DTYPES[DTYPE_BFLOAT16] = ml_dtypes.bfloat16
    _NP_TO_ONNX[np.dtype(ml_dtypes.bfloat16)] = DTYPE_BFLOAT16
except ImportError:  # pragma: no cover
    pass


def tensor_to_numpy(t: Msg) -> np.ndarray:
    if int(t.data_location or 0) == 1:  # EXTERNAL, unresolved
        raise ValueError(
            f"tensor {t.name!r} stores its data in an external file "
            f"({dict((e.key, e.value) for e in t.external_data)}); load the "
            "model via import_model(path)/load_model(path) so sidecar files "
            "resolve relative to the model directory, or pass base_dir=")
    dims = tuple(int(d) for d in t.dims)
    dt = int(t.data_type or 0)
    if dt == DTYPE_STRING:
        arr = np.array([s.decode("utf-8", "replace") for s in t.string_data],
                       dtype=object)
        return arr.reshape(dims)
    np_dtype = TENSOR_DTYPES.get(dt)
    if np_dtype is None:
        raise ValueError(f"unsupported tensor data_type {dt}")
    if t.raw_data:
        return np.frombuffer(t.raw_data, dtype=np_dtype).reshape(dims).copy()
    # typed repeated fields
    if dt == 1:
        data = np.asarray(t.float_data, dtype=np.float32)
    elif dt == 11:
        data = np.asarray(t.double_data, dtype=np.float64)
    elif dt == 7:
        data = np.asarray(t.int64_data, dtype=np.int64)
    elif dt in (12, 13):
        data = np.asarray(t.uint64_data, dtype=np.uint64).astype(np_dtype)
    elif dt == 10:  # float16 stored bit-cast in int32_data
        data = np.asarray(t.int32_data, dtype=np.uint16).view(np.float16)
    elif dt == DTYPE_BFLOAT16:
        data = np.asarray(t.int32_data, dtype=np.uint16).view(np_dtype)
    else:  # int32/int16/int8/uint8/uint16/bool ride int32_data
        data = np.asarray(t.int32_data, dtype=np.int64).astype(np_dtype)
    return data.reshape(dims)


def numpy_to_tensor(arr: np.ndarray, name: str = "") -> Msg:
    arr = np.asarray(arr)  # NOT ascontiguousarray: that promotes 0-d to 1-d
    t = Msg("TensorProto")
    t.name = name
    t.dims = list(arr.shape)
    if arr.dtype == object or arr.dtype.kind in ("U", "S"):
        t.data_type = DTYPE_STRING
        t.string_data = [str(s).encode("utf-8") for s in arr.reshape(-1)]
        return t
    dt = _NP_TO_ONNX.get(arr.dtype)
    if dt is None:
        raise ValueError(f"unsupported numpy dtype {arr.dtype}")
    t.data_type = dt
    t.raw_data = arr.tobytes()
    return t


# ---------------------------------------------------------------------------
# Attribute helpers
# ---------------------------------------------------------------------------

def attr_value(a: Msg) -> Any:
    """Extract the python value of an AttributeProto."""
    # proto3 serializers omit zero-valued scalar fields entirely, so a typed
    # attribute may arrive with its value field unset: default, don't crash.
    ty = int(a.type or 0)
    if ty == ATTR_FLOAT:
        return float(a.f or 0.0)
    if ty == ATTR_INT:
        return int(a.i or 0)
    if ty == ATTR_STRING:
        return (a.s or b"").decode("utf-8", "replace")
    if ty == ATTR_TENSOR:
        return tensor_to_numpy(a.t)
    if ty == ATTR_GRAPH:
        return a.g
    if ty == ATTR_FLOATS:
        return [float(v) for v in a.floats]
    if ty == ATTR_INTS:
        return [int(v) for v in a.ints]
    if ty == ATTR_STRINGS:
        return [s.decode("utf-8", "replace") for s in a.strings]
    if ty == ATTR_TENSORS:
        return [tensor_to_numpy(t) for t in a.tensors]
    # untyped (some emitters omit .type): best effort
    if a.floats:
        return list(a.floats)
    if a.ints:
        return list(a.ints)
    if a.s:
        return a.s.decode("utf-8", "replace")
    if a.t is not None:
        return tensor_to_numpy(a.t)
    if a.i is not None:
        return int(a.i)
    if a.f is not None:
        return float(a.f)
    return None


def node_attrs(node: Msg) -> Dict[str, Any]:
    return {a.name: attr_value(a) for a in node.attribute}


def make_attr(name: str, value: Any) -> Msg:
    a = Msg("AttributeProto")
    a.name = name
    if isinstance(value, bool):
        a.type, a.i = ATTR_INT, int(value)
    elif isinstance(value, int):
        a.type, a.i = ATTR_INT, value
    elif isinstance(value, float):
        a.type, a.f = ATTR_FLOAT, value
    elif isinstance(value, str):
        a.type, a.s = ATTR_STRING, value.encode("utf-8")
    elif isinstance(value, np.ndarray):
        a.type, a.t = ATTR_TENSOR, numpy_to_tensor(value)
    elif isinstance(value, Msg) and value._schema == "GraphProto":
        a.type, a.g = ATTR_GRAPH, value
    elif isinstance(value, (list, tuple)):
        if value and isinstance(value[0], float):
            a.type, a.floats = ATTR_FLOATS, [float(v) for v in value]
        elif value and isinstance(value[0], str):
            a.type, a.strings = ATTR_STRINGS, [v.encode() for v in value]
        else:
            a.type, a.ints = ATTR_INTS, [int(v) for v in value]
    else:
        raise TypeError(f"cannot encode attribute {name}={value!r}")
    return a


# ---------------------------------------------------------------------------
# Model container helpers
# ---------------------------------------------------------------------------

def _walk_tensors(graph: Msg):
    """Yield every TensorProto reachable from ``graph`` (initializers and
    attribute tensors, recursing through subgraphs)."""
    for t in graph.initializer:
        yield t
    for node in graph.node:
        for a in node.attribute or []:
            if a.t is not None:
                yield a.t
            for t in a.tensors or []:
                yield t
            if a.g is not None:
                yield from _walk_tensors(a.g)
            for sg in a.graphs or []:
                yield from _walk_tensors(sg)


def resolve_external_data(model: Msg, base_dir: str) -> int:
    """Load ``data_location: EXTERNAL`` tensor payloads from their sidecar
    files into ``raw_data`` in place (the layout ``onnx.save_model(...,
    save_as_external_data=True)`` and large torch exports produce: per-tensor
    ``location``/``offset``/``length`` entries naming a file relative to the
    model directory). Returns the number of tensors resolved. Parity target:
    the reference hands arbitrary user model files to onnxruntime, which
    resolves sidecars natively (deep-learning/.../onnx/ONNXModel.scala:173-193).
    """
    import os

    # realpath: a symlink inside the model dir must not smuggle reads out
    base_dir = os.path.realpath(base_dir or ".")
    handles: Dict[str, Any] = {}
    resolved = 0
    try:
        for t in _walk_tensors(model.graph) if model.graph is not None else ():
            if int(t.data_location or 0) != 1:
                continue
            info = {e.key: e.value for e in t.external_data}
            loc = info.get("location")
            if not loc:
                raise ValueError(
                    f"external tensor {t.name!r} has no location entry")
            full = os.path.realpath(os.path.join(base_dir, loc))
            if not (full == base_dir
                    or full.startswith(base_dir + os.sep)):
                raise ValueError(
                    f"external tensor {t.name!r} location {loc!r} escapes "
                    f"the model directory {base_dir!r}")
            fh = handles.get(full)
            if fh is None:
                fh = handles[full] = open(full, "rb")
            offset = int(info.get("offset", 0) or 0)
            length = info.get("length")
            fh.seek(offset)
            data = fh.read(int(length)) if length is not None else fh.read()
            if length is not None and len(data) != int(length):
                raise ValueError(
                    f"external tensor {t.name!r}: wanted {length} bytes at "
                    f"offset {offset} of {loc!r}, file had {len(data)}")
            t.raw_data = data
            t.data_location = 0
            t.external_data = []
            resolved += 1
    finally:
        for fh in handles.values():
            fh.close()
    return resolved


def load_model(path_or_bytes, base_dir: Optional[str] = None) -> Msg:
    """Parse a ``.onnx`` file (or raw bytes) into a ModelProto Msg.

    External-data tensors are resolved against the model's own directory
    (or ``base_dir`` when raw bytes are given)."""
    import os

    if isinstance(path_or_bytes, (bytes, bytearray)):
        data = bytes(path_or_bytes)
    else:
        with open(path_or_bytes, "rb") as fh:
            data = fh.read()
        if base_dir is None:
            base_dir = os.path.dirname(os.path.abspath(path_or_bytes))
    model = decode("ModelProto", data)
    if base_dir is not None:
        resolve_external_data(model, base_dir)
    return model


def save_model(model: Msg, path: str, external_data_threshold: Optional[int] = None):
    """Serialize ``model`` to ``path``. With ``external_data_threshold``,
    initializers of at least that many payload bytes move to one sidecar
    ``<model>.data`` file (the standard ``save_as_external_data`` layout:
    location/offset/length entries, 64-byte-aligned offsets)."""
    import os

    undo = []  # (tensor, raw, external_data, data_location) — the caller's
    # in-memory model must come back untouched after serialization
    try:
        if external_data_threshold is not None and model.graph is not None:
            loc = os.path.basename(path) + ".data"
            sidecar = os.path.join(os.path.dirname(os.path.abspath(path)), loc)
            offset = 0
            chunks = []
            for t in _walk_tensors(model.graph):
                if not t.raw_data or len(t.raw_data) < external_data_threshold:
                    continue
                offset = (offset + 63) & ~63  # align like onnx's writer
                entries = []
                for k, v in (("location", loc), ("offset", str(offset)),
                             ("length", str(len(t.raw_data)))):
                    e = Msg("StringStringEntryProto")
                    e.key, e.value = k, v
                    entries.append(e)
                chunks.append((offset, t.raw_data))
                offset += len(t.raw_data)
                undo.append((t, t.raw_data, t.external_data, t.data_location))
                t.external_data = entries
                t.data_location = 1
                t.raw_data = b""
            if chunks:
                with open(sidecar, "wb") as fh:
                    for off, payload in chunks:
                        fh.seek(off)
                        fh.write(payload)
        with open(path, "wb") as fh:
            fh.write(encode(model))
    finally:
        for t, raw, ext, dl in undo:
            t.raw_data, t.external_data, t.data_location = raw, ext, dl

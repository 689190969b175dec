"""ONNX graph builder: programmatic construction of ``.onnx`` models.

Used three ways:
- test fixtures (build a graph, serialize through real protobuf bytes, then
  re-import via :mod:`synapseml_tpu_torch.onnx.importer` and compare against an
  independent runtime),
- the bundled model zoo (:mod:`synapseml_tpu_torch.onnx.zoo` builds ResNet-family
  graphs in the exact node layout standard exporters emit),
- an export path for models trained in this framework, so they can be consumed
  by any ONNX runtime (the reverse of the reference's import-only ONNXModel,
  ref: deep-learning/src/main/scala/com/microsoft/ml/spark/onnx/ONNXModel.scala:422-427).
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence, Union

import numpy as np

from synapseml_tpu_torch.onnx import proto
from synapseml_tpu_torch.onnx.proto import Msg, make_attr, numpy_to_tensor

_ONNX_DTYPE = proto.NP_TO_ONNX  # single source of truth for dtype codes


def _value_info(name: str, dtype, shape: Sequence[Optional[Union[int, str]]]) -> Msg:
    vi = Msg("ValueInfoProto")
    vi.name = name
    tp = Msg("TypeProto")
    tt = Msg("TypeProto.Tensor")
    tt.elem_type = _ONNX_DTYPE[np.dtype(dtype)]
    shp = Msg("TensorShapeProto")
    dims = []
    for d in shape:
        dim = Msg("TensorShapeProto.Dimension")
        if isinstance(d, str) or d is None:
            dim.dim_param = d or "N"
        else:
            dim.dim_value = int(d)
        dims.append(dim)
    shp.dim = dims
    tt.shape = shp
    tp.tensor_type = tt
    vi.type = tp
    return vi


class GraphBuilder:
    """Accumulates nodes/initializers and emits a ModelProto."""

    def __init__(self, name: str = "graph", opset: int = 17,
                 name_prefix: str = ""):
        """``name_prefix`` namespaces every ``fresh`` tensor name —
        REQUIRED for subgraph bodies, whose names would otherwise collide
        with outer-scope tensors they capture (ONNX name resolution is
        lexical: a body-local name shadows the outer one)."""
        self.name = name
        self.opset = opset
        self.name_prefix = name_prefix
        self._nodes: List[Msg] = []
        self._initializers: List[Msg] = []
        self._inputs: List[Msg] = []
        self._outputs: List[Msg] = []
        self._domains: set = set()
        self._counter = 0

    def fresh(self, prefix: str = "t") -> str:
        self._counter += 1
        return f"{self.name_prefix}{prefix}_{self._counter}"

    def add_input(self, name: str, dtype=None, shape=None) -> str:
        """``dtype=None`` emits a bare ValueInfo (name only) — the form
        subgraph bodies use, where types flow in from the outer scope."""
        if dtype is None:
            vi = Msg("ValueInfoProto")
            vi.name = name
            self._inputs.append(vi)
            return name
        self._inputs.append(_value_info(name, dtype, shape))
        return name

    def add_output(self, name: str, dtype, shape) -> str:
        """``shape=None`` emits an untyped ValueInfo (legal ONNX: shape
        inference fills it; converters without shape propagation use it)."""
        if shape is None:
            vi = Msg("ValueInfoProto")
            vi.name = name
            self._outputs.append(vi)
        else:
            self._outputs.append(_value_info(name, dtype, shape))
        return name

    def add_initializer(self, name: str, array: np.ndarray) -> str:
        self._initializers.append(numpy_to_tensor(np.asarray(array), name))
        return name

    def add_node(self, op_type: str, inputs: Sequence[str],
                 outputs: Optional[Sequence[str]] = None,
                 name: Optional[str] = None, domain: str = "",
                 **attrs) -> Union[str, List[str]]:
        """Append a node; returns its (single) output name or list of names.
        ``domain="ai.onnx.ml"`` marks classical-ML ops; the matching
        opset_import entry is added at build()."""
        if outputs is None:
            outputs = [self.fresh(op_type.lower())]
        node = Msg("NodeProto")
        node.input = list(inputs)
        node.output = list(outputs)
        node.op_type = op_type
        node.name = name or self.fresh(f"n_{op_type.lower()}")
        if domain:
            node.domain = domain
            self._domains.add(domain)
        node.attribute = [make_attr(k, v) for k, v in attrs.items()
                          if v is not None]
        self._nodes.append(node)
        return outputs[0] if len(outputs) == 1 else list(outputs)

    # convenience wrappers for the common layers ------------------------
    def conv(self, x: str, w: np.ndarray, b: Optional[np.ndarray] = None,
             strides=(1, 1), pads=(0, 0, 0, 0), group: int = 1,
             dilations=(1, 1), prefix: str = "conv") -> str:
        wn = self.add_initializer(self.fresh(f"{prefix}_w"), w)
        ins = [x, wn]
        if b is not None:
            ins.append(self.add_initializer(self.fresh(f"{prefix}_b"), b))
        return self.add_node(
            "Conv", ins, strides=list(strides), pads=list(pads),
            group=group, dilations=list(dilations),
            kernel_shape=list(w.shape[2:]))

    def batch_norm(self, x: str, scale, bias, mean, var,
                   epsilon: float = 1e-5, prefix: str = "bn") -> str:
        names = [self.add_initializer(self.fresh(f"{prefix}_{s}"), np.asarray(v))
                 for s, v in [("scale", scale), ("bias", bias),
                              ("mean", mean), ("var", var)]]
        return self.add_node("BatchNormalization", [x] + names, epsilon=epsilon)

    def gemm(self, x: str, w: np.ndarray, b: Optional[np.ndarray] = None,
             trans_b: int = 1, prefix: str = "fc") -> str:
        wn = self.add_initializer(self.fresh(f"{prefix}_w"), w)
        ins = [x, wn]
        if b is not None:
            ins.append(self.add_initializer(self.fresh(f"{prefix}_b"), b))
        return self.add_node("Gemm", ins, transB=trans_b)

    def relu(self, x: str) -> str:
        return self.add_node("Relu", [x])

    def build(self, producer: str = "synapseml_tpu") -> Msg:
        g = Msg("GraphProto")
        g.name = self.name
        g.node = self._nodes
        g.initializer = self._initializers
        g.input = self._inputs
        g.output = self._outputs
        m = Msg("ModelProto")
        m.ir_version = 8
        m.producer_name = producer
        osi = Msg("OperatorSetIdProto")
        osi.domain = ""
        osi.version = self.opset
        m.opset_import = [osi]
        for dom in sorted(getattr(self, "_domains", ())):
            extra = Msg("OperatorSetIdProto")
            extra.domain = dom
            extra.version = 3 if dom == "ai.onnx.ml" else 1
            m.opset_import.append(extra)
        m.graph = g
        return m

    def to_bytes(self, producer: str = "synapseml_tpu") -> bytes:
        return proto.encode(self.build(producer))

    def save(self, path: str, producer: str = "synapseml_tpu"):
        with open(path, "wb") as fh:
            fh.write(self.to_bytes(producer))

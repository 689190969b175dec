"""ONNX subsystem of the port: protobuf codec, graph builder and zoo, and
the graph -> PyTorch importer (``import_model(...).bind()`` scores a graph
on the card) and ``ONNXModel``, the pipeline transformer that scores a
table's columns through the batched executor.

The counterpart of the reference package's ``onnx/``; ``convert_lightgbm``
(which needs the ``ai.onnx.ml`` ops) is not ported yet.
"""
from synapseml_tpu_torch.onnx.builder import GraphBuilder
from synapseml_tpu_torch.onnx.importer import (
    ImportedGraph, import_model, supported_ops,
)
from synapseml_tpu_torch.onnx.model import ONNXModel
from synapseml_tpu_torch.onnx import proto, zoo

__all__ = [
    "GraphBuilder", "ImportedGraph", "ONNXModel", "import_model",
    "supported_ops",
    "proto", "zoo",
]

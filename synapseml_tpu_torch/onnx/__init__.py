"""ONNX subsystem of the port: protobuf codec, graph builder and zoo, the
graph -> PyTorch importer (``import_model(...).bind()`` scores a graph on
the card) with the ``ai.onnx.ml`` ops, ``convert_lightgbm`` (a trained
LightGBM model as an ONNX tree-ensemble graph) and ``ONNXModel``, the
pipeline transformer that scores a table's columns through the batched
executor.

The counterpart of the reference package's ``onnx/``.
"""
from synapseml_tpu_torch.onnx.builder import GraphBuilder
from synapseml_tpu_torch.onnx.convert import convert_lightgbm
from synapseml_tpu_torch.onnx.importer import (
    ImportedGraph, import_model, supported_ops,
)
from synapseml_tpu_torch.onnx.model import ONNXModel
from synapseml_tpu_torch.onnx import proto, zoo

__all__ = [
    "GraphBuilder", "ImportedGraph", "ONNXModel", "convert_lightgbm",
    "import_model", "supported_ops",
    "proto", "zoo",
]

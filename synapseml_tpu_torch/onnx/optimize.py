"""Proto-level graph optimizations applied at import time.

The role of onnxruntime's transformer optimizer in the reference stack
(ORT fuses attention subgraphs before CUDA execution; ref ONNXModel
delegates wholesale to ORT, deep-learning/.../onnx/ONNXModel.scala:173).
Here the optimizations rewrite the ONNX graph itself before lowering, so
they are exporter-agnostic and inspectable.

Currently one pass — **parallel-MatMul packing**: N MatMul nodes that
share the same activation input and multiply 2-D weight initializers of
matching inner dimension (the q/k/v projections every transformer export
carries) become ONE MatMul against the concatenated weight followed by a
Split: three [M,D]x[D,D] GEMM launches become one [M,D]x[D,3D] launch
with triple the arithmetic intensity per weight load. The rewrite is the
reference package's, byte for byte, so ``import_model(optimize=True)``
means the same graph in both.
"""
from __future__ import annotations

from typing import Dict, List

import numpy as np

from synapseml_tpu_torch.onnx.proto import Msg, numpy_to_tensor, tensor_to_numpy


def _attr_int(node: Msg, name: str, default: int) -> int:
    for a in node.attribute or []:
        if a.name == name:
            return int(a.i)
    return default


def pack_parallel_matmuls(graph: Msg, opset: int = 13,
                          min_group: int = 2) -> int:
    """Rewrite groups of parallel MatMuls in place; returns #groups packed.

    A group: MatMul nodes whose input[0] is the same tensor, whose
    input[1] is a float 2-D initializer with a common inner dim and dtype,
    and whose weights feed nothing else. The packed MatMul + Split are
    spliced at the earliest group position, so every original output name
    is produced no later than before.
    """
    inits: Dict[str, Msg] = {t.name: t for t in graph.initializer}
    uses: Dict[str, int] = {}
    for node in graph.node:
        for i in node.input or []:
            uses[i] = uses.get(i, 0) + 1
    for vi in graph.output:
        uses[vi.name] = uses.get(vi.name, 0) + 1
    # names referenced inside If/Loop/Scan subgraphs capture outer tensors
    # without appearing in top-level node inputs — never touch those
    def _subgraph_refs(g: Msg, out: set):
        for node in g.node or []:
            for i in node.input or []:
                out.add(i)
            for a in node.attribute or []:
                if a.g is not None:
                    _subgraph_refs(a.g, out)
                for sg in a.graphs or []:
                    _subgraph_refs(sg, out)

    sub_refs: set = set()
    for node in graph.node:
        for a in node.attribute or []:
            if a.g is not None:
                _subgraph_refs(a.g, sub_refs)
            for sg in a.graphs or []:
                _subgraph_refs(sg, sub_refs)
    for name in sub_refs:
        uses[name] = uses.get(name, 0) + 1

    # collect candidate groups keyed by (activation, inner_dim, dtype)
    groups: Dict[tuple, List[int]] = {}
    for idx, node in enumerate(graph.node):
        if node.op_type != "MatMul" or len(node.input) != 2:
            continue
        x, w = node.input
        if x in inits or w not in inits:
            continue
        # an initializer that also appears in graph.input is an
        # overridable feed — packing would bake it in and delete the
        # override point for other consumers of the rewritten graph
        if any(vi.name == w for vi in graph.input):
            continue
        t = inits[w]
        dims = [int(d) for d in (t.dims or [])]
        if len(dims) != 2 or uses.get(w, 0) != 1:
            continue
        # graph outputs must keep their producing node's exact identity
        if any(vi.name == node.output[0] for vi in graph.output):
            continue
        groups.setdefault((x, dims[0], int(t.data_type)), []).append(idx)

    packed = 0
    remove_nodes: set = set()
    remove_inits: set = set()
    splices: Dict[int, List[Msg]] = {}  # insert-before position -> nodes
    for (x, inner, _), idxs in groups.items():
        if len(idxs) < min_group:
            continue
        ws = [tensor_to_numpy(inits[graph.node[i].input[1]]) for i in idxs]
        sizes = [w.shape[1] for w in ws]
        w_pack = np.concatenate(ws, axis=1)
        base = graph.node[idxs[0]].output[0]
        pack_w_name = f"{base}__packed_w"
        pack_out = f"{base}__packed"
        split_sizes_name = f"{base}__packed_sizes"
        graph.initializer.append(numpy_to_tensor(w_pack, pack_w_name))

        mm = Msg("NodeProto")
        mm.op_type = "MatMul"
        mm.name = f"{base}__packed_matmul"
        mm.input = [x, pack_w_name]
        mm.output = [pack_out]
        mm.attribute = []
        sp = Msg("NodeProto")
        sp.op_type = "Split"
        sp.name = f"{base}__packed_split"
        sp.output = [graph.node[i].output[0] for i in idxs]
        ax = Msg("AttributeProto")
        ax.name = "axis"
        ax.type = 2  # INT
        ax.i = -1
        sp.attribute = [ax]
        if opset >= 13:  # sizes ride as an input tensor
            graph.initializer.append(numpy_to_tensor(
                np.asarray(sizes, np.int64), split_sizes_name))
            sp.input = [pack_out, split_sizes_name]
        else:            # pre-13 layout: sizes are an attribute
            sp.input = [pack_out]
            sz = Msg("AttributeProto")
            sz.name = "split"
            sz.type = 7  # INTS
            sz.ints = [int(s) for s in sizes]
            sp.attribute.append(sz)

        splices[min(idxs)] = [mm, sp]
        remove_nodes.update(idxs)
        remove_inits.update(graph.node[i].input[1] for i in idxs)
        packed += 1

    if not packed:
        return 0
    new_nodes: List[Msg] = []
    for idx, node in enumerate(graph.node):
        if idx in splices:
            new_nodes.extend(splices[idx])
        if idx not in remove_nodes:
            new_nodes.append(node)
    graph.node = new_nodes
    graph.initializer = [
        t for t in graph.initializer if t.name not in remove_inits
    ]
    return packed


def optimize_graph(graph: Msg, opset: int = 13) -> Msg:
    """All passes, in order. Mutates and returns ``graph``."""
    pack_parallel_matmuls(graph, opset)
    return graph

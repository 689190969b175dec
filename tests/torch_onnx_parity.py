"""Helpers of the port's ONNX parity tests (``tests/test_torch_onnx_*.py``).

One graph's bytes go through the JAX package's importer and through the
port's, on the CPU, on the same numpy inputs; the outputs are compared
value by value and dtype by dtype. Only tests import this module.
"""
from __future__ import annotations

from typing import Dict, Optional, Sequence

import jax.numpy as jnp
import numpy as np
import torch

from synapseml_tpu.onnx import import_model as jax_import_model
from synapseml_tpu_torch.onnx import GraphBuilder, import_model

# the reference narrows 64-bit integers to 32 bits on the device (JAX's
# 64-bit mode is off); the port keeps them, which is the one dtype
# difference allowed
_NARROWED = {np.dtype(np.int64): np.dtype(np.int32),
             np.dtype(np.uint64): np.dtype(np.uint32)}


def one_node(op_type: str, feeds: Dict[str, np.ndarray],
             inits: Optional[Dict[str, np.ndarray]] = None,
             consts: Optional[Dict[str, np.ndarray]] = None,
             node_inputs: Optional[Sequence[str]] = None, n_out: int = 1,
             opset: int = 17, **attrs) -> bytes:
    """A graph of one ``op_type`` node. ``feeds`` are graph inputs,
    ``inits`` initializers, ``consts`` Constant nodes (host values in both
    packages); the node reads them in that order unless ``node_inputs``
    says otherwise ("" for a skipped optional input)."""
    g = GraphBuilder(opset=opset)
    for name, a in feeds.items():
        g.add_input(name, a.dtype, list(a.shape))
    for name, a in (inits or {}).items():
        g.add_initializer(name, a)
    for name, a in (consts or {}).items():
        g.add_node("Constant", [], outputs=[name], value=np.asarray(a))
    if node_inputs is None:
        node_inputs = [*feeds, *(inits or {}), *(consts or {})]
    outs = [f"y{i}" for i in range(n_out)]
    g.add_node(op_type, list(node_inputs), outputs=outs, **attrs)
    for o in outs:
        g.add_output(o, np.float32, None)
    return g.to_bytes()


def run_both(blob: bytes, feeds: Sequence[np.ndarray], host: bool = False,
             cast=None, optimize: bool = False):
    """(port outputs, JAX outputs) of the graph on ``feeds``: bound on the
    CPU in the port, through ``bind`` in the reference. ``host`` feeds
    numpy to both (the host paths); otherwise device arrays (torch
    tensors, jax arrays). ``cast`` is a bind's ``cast_dtype`` ("bfloat16")."""
    port = import_model(blob, optimize=optimize).bind(
        cast_dtype=None if cast is None else getattr(torch, cast),
        device="cpu")
    ref = jax_import_model(blob, optimize=optimize).bind(
        cast_dtype=None if cast is None else getattr(jnp, cast))
    if host:
        return port(*feeds), ref(*feeds)
    return (port(*[to_torch(f) for f in feeds]),
            ref(*[jnp.asarray(f) for f in feeds]))


def to_torch(a: np.ndarray) -> torch.Tensor:
    a = np.array(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.uint16)).view(torch.bfloat16)
    return torch.from_numpy(a)


def to_numpy(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        x = x.detach()
        return (x.float() if x.dtype == torch.bfloat16 else x).numpy()
    a = np.asarray(x)
    return a.astype(np.float32) if a.dtype.name == "bfloat16" else a


def dtype_name(x) -> str:
    if isinstance(x, torch.Tensor):
        return str(x.dtype).replace("torch.", "")
    return np.asarray(x).dtype.name


def same_dtype(port, ref) -> bool:
    """Equal dtypes, but for a 64-bit integer the reference narrows."""
    p, r = dtype_name(port), dtype_name(ref)
    if p == r:
        return True
    return p in ("int64", "uint64") and \
        _NARROWED[np.dtype(p)] == np.dtype(r)


def assert_parity(port_outs, ref_outs, rtol: float = 1e-5,
                  atol: float = 1e-5) -> None:
    assert len(port_outs) == len(ref_outs)
    for p, r in zip(port_outs, ref_outs):
        assert same_dtype(p, r), (dtype_name(p), dtype_name(r))
        pn, rn = to_numpy(p), to_numpy(r)
        assert pn.shape == rn.shape, (pn.shape, rn.shape)
        if pn.dtype.kind in "biu":
            np.testing.assert_array_equal(pn, rn)
        else:
            np.testing.assert_allclose(pn, rn, rtol=rtol, atol=atol)

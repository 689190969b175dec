"""The five committed torch-exported graphs through the port's importer, on
the CPU: against the JAX package's importer on the same bytes (float32
outputs within rtol=atol=1e-5, dtypes equal) and against the torch outputs
recorded at export time (``*_io.npz``) at the tolerances of the
reference's own tests in ``tests/test_onnx_foreign.py``: 1e-5 for cnn,
gru, transformer and kv_decoder; for quant_cnn 2 output quantization
steps, with more than 95% of outputs within one step.

The bf16 binds compare output dtypes only: JAX's promotion decides where
a graph leaves bf16 (a float32 constant or initial state promotes), and
the port must decide the same way.
"""
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from synapseml_tpu.onnx import import_model as jax_import_model
from synapseml_tpu_torch.onnx import import_model
from torch_onnx_parity import (assert_parity, dtype_name, same_dtype,
                               to_numpy, to_torch)

FIXTURES = os.path.join(os.path.dirname(__file__), "fixtures")
NAMES = ["torch_cnn", "torch_gru", "torch_transformer", "torch_quant_cnn",
         "torch_kv_decoder"]


def _load(name):
    path = os.path.join(FIXTURES, f"{name}.onnx")
    io = np.load(os.path.join(FIXTURES, f"{name}_io.npz"))
    if name == "torch_kv_decoder":
        feeds = [io["input_ids"], io["past_key"], io["past_value"]]
        want = [io["logits"], io["present_key"], io["present_value"]]
    else:
        feeds, want = [io["input"]], [io["expected"]]
    return path, io, feeds, want


def _port(path, feeds, cast=None):
    fn = import_model(path).bind(cast_dtype=cast, device="cpu")
    return fn(*[to_torch(f) for f in feeds])


@pytest.mark.parametrize("name", NAMES)
def test_fixture_against_the_jax_importer_and_torch(name):
    path, io, feeds, want = _load(name)
    port = _port(path, feeds)
    jg = jax_import_model(path)
    ref = jg.apply(jg.params, *feeds)       # as test_onnx_foreign runs it
    assert_parity(port, ref)
    got = [to_numpy(p) for p in port]
    if name == "torch_quant_cnn":
        step = float(io["out_scale"])
        err = np.abs(got[0] - want[0])
        assert got[0].shape == want[0].shape
        assert err.max() <= 2.0 * step + 1e-7, (err.max(), step)
        assert (err <= step + 1e-7).mean() > 0.95
    else:
        for g, w in zip(got, want):
            np.testing.assert_allclose(g, w, atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("name", NAMES)
def test_fixture_bf16_bind_output_dtypes_are_the_references(name):
    path, _, feeds, _ = _load(name)
    cast = [f.astype(jnp.bfloat16) if f.dtype == np.float32 else f
            for f in feeds]
    port = _port(path, cast, cast=torch.bfloat16)
    ref = jax_import_model(path).bind(cast_dtype=jnp.bfloat16)(
        *[jnp.asarray(f) for f in cast])
    assert [same_dtype(p, r) for p, r in zip(port, ref)] == \
        [True] * len(ref), ([dtype_name(p) for p in port],
                            [dtype_name(r) for r in ref])


@pytest.mark.parametrize("name,batch", [("torch_cnn", 5), ("torch_cnn", 1),
                                        ("torch_transformer", 6)])
def test_fixture_dynamic_batch(name, batch):
    """The exported batch dim is symbolic: the Shape chains resolve on the
    host per call at batch sizes never seen at export."""
    path, io, feeds, want = _load(name)
    x = np.concatenate([feeds[0]] * 2, axis=0)[:batch]
    got = to_numpy(_port(path, [x])[0])
    n = min(batch, want[0].shape[0])
    np.testing.assert_allclose(got[:n], want[0][:n], atol=1e-5, rtol=1e-5)


def test_kv_decoder_incremental_round_trip():
    """Feeding the prompt one token at a time, and in mixed chunks, each
    step consuming the previous present_* as past_*, gives the full-sequence
    logits at every position (1e-4, as the reference's test)."""
    path, io, _, _ = _load("torch_kv_decoder")
    fn = import_model(path).bind(device="cpu")
    ids, want = io["full_ids"], io["full_logits"]
    empty = torch.zeros((1, 2, 0, 8))
    full, _, _ = fn(torch.from_numpy(ids), empty, empty)
    np.testing.assert_allclose(full.numpy(), want, atol=1e-5, rtol=1e-5)
    for chunks in ([1] * ids.shape[1], [3, 1, 5, 3]):
        k, v, t, rows = empty, empty, 0, []
        for n in chunks:
            lo, k, v = fn(torch.from_numpy(ids[:, t:t + n]), k, v)
            rows.append(lo.numpy())
            t += n
        assert k.shape[2] == ids.shape[1]
        np.testing.assert_allclose(np.concatenate(rows, axis=1), want,
                                   atol=1e-4, rtol=1e-4)

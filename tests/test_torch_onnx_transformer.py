"""The zoo's transformer and recurrent graphs through the port's importer,
on the CPU, against the JAX package's importer on the same bytes:
``zoo.transformer_encoder(causal=True)`` (the ``Trilu`` mask),
``zoo.tiny_decoder`` (GroupQueryAttention over the shared KV buffer with
internal rotary: a prefill, then decode steps through the returned
buffers) and ``zoo.bilstm_tagger`` (bidirectional ``LSTM``), small widths;
then the committed fixture ``tests/fixtures/transformer_graphs.npz``
(from ``tests/fixtures/make_transformer_fixtures.py``): the BERT-base
causal encoder (110 M params, 2 x 128 tokens; ~5 s: the zoo's seeded
weights, the parse, and the float32 and bf16 forwards), the
default ``tiny_decoder``'s decode stream and the example-width tagger.

Tolerances: float32 outputs within rtol=atol=1e-5 of the reference's at
the small widths (the decoder's incremental logits within rtol=atol=1e-5
of one full forward of the same tokens, in the port); at BERT-base width
within rtol=atol=1e-3 of the JAX fixture (a 768- and 3,072-wide product
sums in another order 12 layers deep); bf16 outputs within 5% of the
float32 output's largest magnitude (the reference's verify rule for a cast
lane), the port's bf16 within rtol=atol=5e-2 of JAX's bf16 at small width.
"""
import os
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from synapseml_tpu.onnx import import_model as jax_import_model
from synapseml_tpu_torch.convert import graph_params_from_arrays
from synapseml_tpu_torch.onnx import GraphBuilder, import_model, zoo
from torch_onnx_parity import (assert_parity, dtype_name, run_both,
                               to_numpy, to_torch)

FIXTURES = os.path.join(os.path.dirname(__file__), "fixtures")
sys.path.insert(0, FIXTURES)
import make_transformer_fixtures as fx  # noqa: E402


def within_bf16_rule(got: np.ndarray, want: np.ndarray) -> bool:
    span = max(1e-6, float(np.abs(want.astype(np.float64)).max()))
    return float(np.abs(got.astype(np.float64) - want).max()) <= 0.05 * span


def _tokens(seed, shape, vocab):
    return np.random.default_rng(seed).integers(0, vocab, shape).astype(
        np.int64)


SMALL_ENCODER = dict(vocab=50, d_model=32, n_heads=4, ffn_dim=64,
                     n_layers=2, seq_len=8, causal=True, seed=3)


def test_causal_encoder_against_jax_float32_and_bf16():
    blob = zoo.transformer_encoder(**SMALL_ENCODER)
    ids = _tokens(0, (3, 8), 50)
    port32, ref32 = run_both(blob, [ids])
    assert_parity(port32, ref32)
    port16, ref16 = run_both(blob, [ids], cast="bfloat16")
    assert dtype_name(port16[0]) == dtype_name(ref16[0]) == "bfloat16"
    assert_parity(port16, ref16, rtol=5e-2, atol=5e-2)
    assert within_bf16_rule(to_numpy(port16[0]), to_numpy(ref32[0]))


def test_causal_encoder_is_causal():
    """A later token moves no earlier position's output."""
    fn = import_model(zoo.transformer_encoder(**SMALL_ENCODER)).bind(
        device="cpu")
    ids = _tokens(1, (2, 8), 50)
    moved = ids.copy()
    moved[:, 5] = (moved[:, 5] + 1) % 50
    a, b = fn(torch.from_numpy(ids))[0], fn(torch.from_numpy(moved))[0]
    np.testing.assert_array_equal(a[:, :5].numpy(), b[:, :5].numpy())
    assert float((a[:, 5:] - b[:, 5:]).abs().max()) > 1e-3


def _decoder_zeros(b, t, kv_heads=2, head=8, layers=2):
    return [np.zeros((b, kv_heads, t, head), np.float32)
            for _ in range(2 * layers)]


def test_tiny_decoder_prefill_and_decode_steps_against_jax():
    """A right-padded prefill (row 1 has 3 valid tokens of 5) and three
    steps through the shared buffers, every output of each call."""
    blob = zoo.tiny_decoder()
    port_fn = import_model(blob).bind(device="cpu")
    ref_fn = jax_import_model(blob).bind()
    ids = _tokens(2, (2, 8), 64)
    lens = np.asarray([4, 2], np.int32)
    port_bufs = ref_bufs = _decoder_zeros(2, 16)
    for start, stop, seqlens in ((0, 5, lens), (5, 6, lens + 1),
                                 (6, 7, lens + 2), (7, 8, lens + 3)):
        chunk = ids[:, start:stop]
        port = port_fn(torch.from_numpy(chunk), torch.from_numpy(seqlens),
                       *map(to_torch, port_bufs))
        ref = ref_fn(jnp.asarray(chunk), jnp.asarray(seqlens),
                     *map(jnp.asarray, ref_bufs))
        assert_parity(port, ref)
        port_bufs = [p.numpy() for p in port[1:]]
        ref_bufs = [np.asarray(r) for r in ref[1:]]


def test_tiny_decoder_incremental_equals_one_full_forward():
    """The certification of ``examples/quantized_llm_decode.py``: each
    decode step's logits equal those of one forward of the whole token
    stream, in every row."""
    blob = zoo.tiny_decoder()
    fn = import_model(blob).bind(device="cpu")
    ids = fx.decoder_tokens()
    b, n = ids.shape
    zeros = [torch.from_numpy(z) for z in _decoder_zeros(b, 32)]
    steps = fx.decode_stream(fn, ids, zeros, 2, torch.from_numpy)
    full = fn(torch.from_numpy(ids),
              torch.full((b,), n - 1, dtype=torch.int32), *zeros)[0]
    np.testing.assert_allclose(steps, full.numpy(), rtol=1e-5, atol=1e-5)


def test_tiny_decoder_bf16_bind_against_jax():
    blob = zoo.tiny_decoder()
    ids = _tokens(3, (2, 6), 64)
    feeds = [ids, np.asarray([5, 5], np.int32)] + _decoder_zeros(2, 8)
    port, ref = run_both(blob, feeds, cast="bfloat16")
    assert [dtype_name(p) for p in port] == [dtype_name(r) for r in ref]
    assert_parity(port, ref, rtol=5e-2, atol=5e-2)


def test_bilstm_tagger_against_jax_float32_and_bf16():
    blob = zoo.bilstm_tagger(vocab=20, embed=8, hidden=6, n_tags=4,
                             seq_len=10, seed=1)
    ids = _tokens(4, (5, 10), 20)
    port32, ref32 = run_both(blob, [ids])
    assert_parity(port32, ref32)
    port16, ref16 = run_both(blob, [ids], cast="bfloat16")
    assert dtype_name(port16[0]) == dtype_name(ref16[0]) == "bfloat16"
    assert_parity(port16, ref16, rtol=5e-2, atol=5e-2)


# -- the committed fixture: JAX's outputs at full width ---------------------

@pytest.fixture(scope="module")
def fixture():
    return np.load(os.path.join(FIXTURES, "transformer_graphs.npz"))


def test_bert_base_causal_encoder_against_the_jax_fixture(fixture):
    g = import_model(zoo.transformer_encoder(**fx.ENCODER))
    assert sum(v.size for v in g.params.values()) > 100_000_000
    ids = torch.from_numpy(fx.encoder_tokens())
    got = g.bind(device="cpu")(ids)[0]
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), fixture["enc_f32"], rtol=1e-3,
                               atol=1e-3)
    got16 = g.bind(cast_dtype=torch.bfloat16, device="cpu")(ids)[0]
    assert got16.dtype == torch.bfloat16
    assert within_bf16_rule(got16.float().numpy(), fixture["enc_f32"])
    assert within_bf16_rule(fixture["enc_bf16"], fixture["enc_f32"])


def test_tiny_decoder_stream_against_the_jax_fixture(fixture):
    fn = import_model(zoo.tiny_decoder()).bind(device="cpu")
    zeros = [torch.from_numpy(z) for z in _decoder_zeros(
        fx.DECODER_BATCH, fx.DECODER_BUFFER)]
    got = fx.decode_stream(fn, fx.decoder_tokens(), zeros, 2,
                           torch.from_numpy)
    np.testing.assert_allclose(got, fixture["dec_logits"], rtol=1e-5,
                               atol=1e-5)


def test_bilstm_tagger_at_the_example_width_against_the_jax_fixture(
        fixture):
    fn = import_model(zoo.bilstm_tagger(**fx.TAGGER)).bind(device="cpu")
    got = fn(torch.from_numpy(fx.tagger_tokens()))[0]
    assert tuple(got.shape) == (fx.TAGGER_BATCH, 16, 4)
    np.testing.assert_allclose(got.numpy(), fixture["lstm_out"], rtol=1e-5,
                               atol=1e-5)


# -- weights carried from the JAX package -----------------------------------

def _int4_block() -> bytes:
    """MatMulNBits (uint8 packed weights and zero points) feeding
    GroupQueryAttention: a graph whose params include integer arrays."""
    rng = np.random.default_rng(8)
    g = GraphBuilder(opset=21)
    x = g.add_input("x", np.float32, [2, 4, 32])

    def proj(name, n):
        packed = rng.integers(0, 256, (n, 2, 8)).astype(np.uint8)
        return g.add_node("MatMulNBits", [
            x, g.add_initializer(f"{name}_w", packed),
            g.add_initializer(f"{name}_s", (rng.random(n * 2) * 0.1).astype(
                np.float32)),
            g.add_initializer(f"{name}_z", rng.integers(
                0, 256, n).astype(np.uint8))],
            domain="com.microsoft", K=32, N=n, bits=4, block_size=16)

    y = g.add_node("GroupQueryAttention", [proj("q", 32), proj("k", 16),
                                           proj("v", 16)],
                   domain="com.microsoft", num_heads=4, kv_num_heads=2)
    g.add_output(y, np.float32, None)
    return g.to_bytes()


GRAPHS = {
    "causal_encoder": (lambda: zoo.transformer_encoder(**SMALL_ENCODER),
                       lambda: [_tokens(5, (2, 8), 50)]),
    "tiny_decoder": (zoo.tiny_decoder, lambda: [
        _tokens(6, (2, 3), 64), np.asarray([2, 2], np.int32),
        *_decoder_zeros(2, 8)]),
    "bilstm_tagger": (lambda: zoo.bilstm_tagger(**fx.TAGGER),
                      lambda: [fx.tagger_tokens()[:3]]),
    "int4_decoder_block": (_int4_block, lambda: [
        np.random.default_rng(9).standard_normal((2, 4, 32)).astype(
            np.float32)]),
}


@pytest.mark.parametrize("name", list(GRAPHS))
def test_graph_params_from_arrays_carries_the_jax_params(name):
    build, feeds = GRAPHS[name]
    blob = build()
    g, jg = import_model(blob), jax_import_model(blob)
    params = graph_params_from_arrays(g, jg.params, device="cpu")
    assert set(params) == set(g.params) == set(jg.params)
    for k, v in params.items():
        assert v.dtype == torch.from_numpy(np.asarray(jg.params[k])).dtype
    if name == "int4_decoder_block":
        assert params["q_w"].dtype == params["q_z"].dtype == torch.uint8
    xs = feeds()
    assert_parity(g.apply(params, *map(to_torch, xs)),
                  jg.apply(jg.params, *xs))

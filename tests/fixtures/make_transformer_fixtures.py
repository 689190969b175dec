"""Generate the transformer, decoder and BiLSTM fixture of the imported-ONNX
path.

Runs the JAX package's ``import_model(...).bind(...)`` on the CPU, eagerly
(the reference's bound forward, as the parity tests run it), on three of
``zoo``'s graphs, and writes ``transformer_graphs.npz``:

- ``enc_f32``, ``enc_bf16``: the BERT-base causal encoder
  (``zoo.transformer_encoder(30522, 768, 12, 3072, 12, seq_len=128,
  causal=True, seed=0)``) on the 2 sequences of :func:`encoder_tokens`,
  through the float32 bind and the bf16 bind (widened exactly to float32);
- ``dec_logits``: ``zoo.tiny_decoder()`` at its defaults over the 16
  tokens of :func:`decoder_tokens` (batch 2): an 8-token prefill against
  zeroed ``[2, 2, 32, 8]`` shared buffers, then 8 teacher-forced decode
  steps of one token through the returned buffers (``seqlens_k`` = valid
  keys - 1); ``[2, 16, 64]``, the prefill's 8 positions then a step each;
- ``lstm_out``: ``zoo.bilstm_tagger(vocab=64, embed=16, hidden=16,
  n_tags=4, seq_len=16)`` (``examples/bilstm_entity_extraction.py``'s
  width) on the 16 rows of :func:`tagger_tokens`.

Inputs and weights are not stored: both come back from their seeds. The
port's tests and ``chip_smoke.py`` hold the port's forwards to these
outputs.

Run from the repo root:  python tests/fixtures/make_transformer_fixtures.py
"""
from __future__ import annotations

import os
import sys
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
OUT = os.path.join(HERE, "transformer_graphs.npz")

ENCODER = dict(vocab=30522, d_model=768, n_heads=12, ffn_dim=3072,
               n_layers=12, seq_len=128, causal=True, seed=0)
DECODER_BATCH, DECODER_PREFILL, DECODER_STEPS, DECODER_BUFFER = 2, 8, 8, 32
TAGGER = dict(vocab=64, embed=16, hidden=16, n_tags=4, seq_len=16)
TAGGER_BATCH = 16


def encoder_tokens() -> np.ndarray:
    return np.random.default_rng(0).integers(
        0, ENCODER["vocab"], (2, ENCODER["seq_len"])).astype(np.int64)


def decoder_tokens() -> np.ndarray:
    return np.random.default_rng(1).integers(
        0, 64, (DECODER_BATCH, DECODER_PREFILL + DECODER_STEPS)).astype(
            np.int64)


def tagger_tokens() -> np.ndarray:
    return np.random.default_rng(2).integers(
        0, TAGGER["vocab"], (TAGGER_BATCH, TAGGER["seq_len"])).astype(
            np.int64)


def decode_stream(fn, tokens: np.ndarray, zeros, layers: int, asarray,
                  to_host=np.asarray):
    """Logits of ``tokens`` through a ``tiny_decoder`` forward ``fn``: one
    prefill chunk of ``DECODER_PREFILL`` tokens against ``zeros`` buffers
    (``2 * layers`` of them), then one teacher-forced step a token through
    the presents; ``asarray`` makes each host input a device value and
    ``to_host`` a device value numpy. Returns the ``[B, S, vocab]`` logits
    as numpy (float32)."""
    b = tokens.shape[0]
    pre = DECODER_PREFILL
    outs = fn(asarray(tokens[:, :pre]),
              asarray(np.full((b,), pre - 1, np.int32)), *zeros)
    logits = [to_host(outs[0]).astype(np.float32)]
    buffers = list(outs[1:1 + 2 * layers])
    for i in range(pre, tokens.shape[1]):
        outs = fn(asarray(tokens[:, i:i + 1]),
                  asarray(np.full((b,), i, np.int32)), *buffers)
        logits.append(to_host(outs[0]).astype(np.float32))
        buffers = list(outs[1:1 + 2 * layers])
    return np.concatenate(logits, axis=1)


def main() -> None:
    sys.path.insert(0, os.path.dirname(HERE))
    sys.path.insert(0, os.path.dirname(os.path.dirname(HERE)))
    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    import jax
    import jax.numpy as jnp

    jax.config.update("jax_platforms", "cpu")
    from synapseml_tpu.onnx import import_model, zoo

    start = time.perf_counter()
    enc = import_model(zoo.transformer_encoder(**ENCODER))
    ids = encoder_tokens()
    enc_f32 = np.asarray(enc.bind()(jnp.asarray(ids))[0])
    enc_bf16 = np.asarray(
        enc.bind(cast_dtype=jnp.bfloat16)(jnp.asarray(ids))[0]).astype(
            np.float32)
    del enc
    dec = import_model(zoo.tiny_decoder())
    zeros = [jnp.zeros((DECODER_BATCH, 2, DECODER_BUFFER, 8), jnp.float32)
             for _ in range(4)]
    dec_logits = decode_stream(dec.bind(), decoder_tokens(), zeros, 2,
                               jnp.asarray)
    tagger = import_model(zoo.bilstm_tagger(**TAGGER))
    lstm_out = np.asarray(tagger.bind()(jnp.asarray(tagger_tokens()))[0])
    for a in (enc_f32, enc_bf16, dec_logits, lstm_out):
        assert np.isfinite(a).all()
    np.savez_compressed(OUT, enc_f32=enc_f32, enc_bf16=enc_bf16,
                        dec_logits=dec_logits, lstm_out=lstm_out,
                        jax_version=np.asarray(jax.__version__))
    span = float(np.abs(enc_f32).max())
    print(f"wrote {OUT} ({os.path.getsize(OUT)} bytes) in "
          f"{time.perf_counter() - start:.1f} s; encoder |y| <= {span:.3f}, "
          f"bf16 max gap {np.abs(enc_bf16 - enc_f32).max() / span:.4f} of "
          "it")


if __name__ == "__main__":
    main()

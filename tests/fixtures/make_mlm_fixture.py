"""Generate the masked-LM head fixture, ``mlm_head_io.npz``.

Runs the JAX package on the CPU, eagerly (its bound forwards): the
BERT-base-width bidirectional encoder (``mlm_head.ENCODER``:
``zoo.transformer_encoder(30522, 768, 12, 3072, 12, seq_len=128,
causal=False, seed=0)``) over the ``mlm_head.N`` = 8 sequences of
``mlm_head.batch`` (seed 0, 20 masked positions each), then the head of
``mlm_head.head_graph`` (built with the JAX package's ``GraphBuilder``,
its projection tied to the encoder's ``tok_emb``) over the hidden states.

Stores only the head's outputs (``top_values``, ``top_ids``, ``loss``,
``label_logit``, ``filled``), the masked ``positions``, the gaps between
neighbouring ranks of the top 6 logits (``gaps``, ``[8, 20, 5]``: the
near-tie rule of ``mlm_head.held``) and the largest |logit| (``span``,
in float64 from the encoder's states). Tokens and weights come back from
their seeds.

Run from the repo root:  python tests/fixtures/make_mlm_fixture.py
"""
from __future__ import annotations

import os
import sys
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)
import mlm_head  # noqa: E402


def main() -> None:
    sys.path.insert(0, os.path.dirname(os.path.dirname(HERE)))
    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    import jax
    import jax.numpy as jnp

    jax.config.update("jax_platforms", "cpu")
    from synapseml_tpu.onnx import GraphBuilder, import_model, zoo

    start = time.perf_counter()
    cfg = mlm_head.ENCODER
    enc = import_model(zoo.transformer_encoder(**cfg))
    tok_emb = np.asarray(enc.params["tok_emb"])
    b = mlm_head.batch(mlm_head.N, cfg["seq_len"], cfg["vocab"],
                       mlm_head.MASKED)
    hidden = np.asarray(enc.bind()(jnp.asarray(b["tokens"]))[0])
    del enc
    out = {}
    for k in (mlm_head.TOPK, mlm_head.TOPK + 1):
        head = import_model(mlm_head.head_graph(
            GraphBuilder, tok_emb, cfg["seq_len"], mlm_head.MASKED, k=k))
        res = head.bind()(jnp.asarray(hidden), *[
            jnp.asarray(a) for a in mlm_head.head_inputs(b)])
        out[k] = [np.asarray(r) for r in res]
    values6 = out[mlm_head.TOPK + 1][0]
    rows = np.arange(mlm_head.N)[:, None]
    logits = (hidden[rows, b["positions"]].astype(np.float64)
              @ tok_emb.T.astype(np.float64)
              + mlm_head.mlm_bias(cfg["vocab"]))
    arrays = dict(zip(mlm_head.OUTPUTS, out[mlm_head.TOPK]))
    arrays["top_ids"] = arrays["top_ids"].astype(np.int64)
    arrays["filled"] = arrays["filled"].astype(np.int64)
    for a in arrays.values():
        assert np.isfinite(a).all()
    np.savez_compressed(
        mlm_head.OUT, **arrays, positions=b["positions"],
        gaps=(values6[..., :-1] - values6[..., 1:]).astype(np.float32),
        span=np.float64(np.abs(logits).max()),
        jax_version=np.asarray(jax.__version__))
    print(f"wrote {mlm_head.OUT} ({os.path.getsize(mlm_head.OUT)} bytes) in "
          f"{time.perf_counter() - start:.1f} s; |logit| <= "
          f"{np.abs(logits).max():.4f}, smallest top-6 gap "
          f"{(values6[..., :-1] - values6[..., 1:]).min():.3e}")


if __name__ == "__main__":
    main()

"""The masked-LM head of the fill-mask and MLM-scoring use, for either
package: a graph built by the caller's ``GraphBuilder`` over the hidden
states of ``zoo.transformer_encoder`` (``causal=False``), and its seeded
batches.

The head (:func:`head_graph`), per sequence of ``S`` positions and ``M``
masked ones:

- ``GatherND(hidden, Unsqueeze(positions, -1), batch_dims=1)`` — the
  masked positions' states, ``[N, M, D]``;
- ``MatMul`` with the encoder's ``tok_emb`` transposed (``[D, V]``, tied
  as in BERT), ``Add`` a seeded bias — the logits, ``[N, M, V]``;
- ``TopK(k, axis=-1)`` — ``top_values`` and ``top_ids``, ``[N, M, k]``;
- ``SoftmaxCrossEntropyLoss(Transpose(logits, [0, 2, 1]), labels,
  reduction="none")`` — ``loss``, ``[N, M]``;
- ``GatherElements(logits, Unsqueeze(labels, -1), axis=-1)`` —
  ``label_logit``, ``[N, M, 1]``;
- ``ScatterND(tokens, scatter_idx, CastLike(top_ids[..., 0], tokens))`` —
  ``filled``, the sequence with each masked position's top-1 id, ``[N, S]``.

:func:`batch` masks ``M`` distinct positions a sequence (``MASK_ID``,
BERT's ``[MASK]``) of seeded tokens; the labels are the tokens they held.
``tests/fixtures/make_mlm_fixture.py`` runs the JAX package's encoder and
head at BERT-base width on ``batch(N)`` into ``mlm_head_io.npz``; the
port's tests and ``chip_smoke.py`` hold the port to it. This module
imports neither package and no JAX.
"""
import os

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
OUT = os.path.join(HERE, "mlm_head_io.npz")
ENCODER = dict(vocab=30522, d_model=768, n_heads=12, ffn_dim=3072,
               n_layers=12, seq_len=128, causal=False, seed=0)
SMALL_ENCODER = dict(vocab=1000, d_model=64, n_heads=4, ffn_dim=128,
                     n_layers=2, seq_len=32, causal=False, seed=0)
N = 8                 # the fixture's sequences
MASKED = 20           # ~15% of 128 positions, BERT's masking rate
SMALL_MASKED = 5
TOPK = 5
MASK_ID = 103
HEAD_SEED = 7
BATCH_SEED = 0
OUTPUTS = ("top_values", "top_ids", "loss", "label_logit", "filled")


def mlm_bias(vocab: int, seed: int = HEAD_SEED) -> np.ndarray:
    return np.random.default_rng(seed).normal(0, 0.02, vocab).astype(
        np.float32)


def head_graph(graph_cls, tok_emb: np.ndarray, seq_len: int, masked: int,
               k: int = TOPK, seed: int = HEAD_SEED) -> bytes:
    """The head's ONNX bytes, built with ``graph_cls`` (either package's
    ``GraphBuilder``) over ``tok_emb`` ``[V, D]``."""
    vocab, d = tok_emb.shape
    g = graph_cls(name="mlm_head", opset=17)
    hidden = g.add_input("hidden", np.float32, ["N", seq_len, d])
    positions = g.add_input("positions", np.int64, ["N", masked])
    labels = g.add_input("labels", np.int64, ["N", masked])
    tokens = g.add_input("tokens", np.int64, ["N", seq_len])
    scatter_idx = g.add_input("scatter_idx", np.int64, ["N", masked, 2])
    last = g.add_initializer("last_axis", np.array([-1], np.int64))
    emb_t = g.add_initializer("tok_emb_t", np.ascontiguousarray(tok_emb.T))
    bias = g.add_initializer("mlm_bias", mlm_bias(vocab, seed))
    top_k = g.add_initializer("top_k", np.array([k], np.int64))
    first = g.add_initializer("first", np.array(0, np.int64))

    picked = g.add_node("GatherND", [
        hidden, g.add_node("Unsqueeze", [positions, last])], batch_dims=1)
    logits = g.add_node("Add", [g.add_node("MatMul", [picked, emb_t]), bias])
    g.add_node("TopK", [logits, top_k], outputs=["top_values", "top_ids"],
               axis=-1)
    by_class = g.add_node("Transpose", [logits], perm=[0, 2, 1])
    g.add_node("SoftmaxCrossEntropyLoss", [by_class, labels],
               outputs=["loss"], reduction="none")
    g.add_node("GatherElements",
               [logits, g.add_node("Unsqueeze", [labels, last])],
               outputs=["label_logit"], axis=-1)
    top1 = g.add_node("Gather", ["top_ids", first], axis=2)
    g.add_node("ScatterND", [tokens, scatter_idx,
                             g.add_node("CastLike", [top1, tokens])],
               outputs=["filled"])
    g.add_output("top_values", np.float32, ["N", masked, k])
    g.add_output("top_ids", np.int64, ["N", masked, k])
    g.add_output("loss", np.float32, ["N", masked])
    g.add_output("label_logit", np.float32, ["N", masked, 1])
    g.add_output("filled", np.int64, ["N", seq_len])
    return g.to_bytes()


def batch(n: int, seq_len: int, vocab: int, masked: int,
          seed: int = BATCH_SEED) -> dict:
    """``n`` seeded sequences with ``masked`` distinct positions each set
    to ``MASK_ID``: ``tokens`` (the encoder's and the head's input),
    ``positions`` (sorted), ``labels`` (the tokens they held) and
    ``scatter_idx`` (``(row, position)`` pairs), all int64."""
    rng = np.random.default_rng(seed)
    original = rng.integers(0, vocab, (n, seq_len)).astype(np.int64)
    positions = np.sort(np.stack([rng.permutation(seq_len)[:masked]
                                  for _ in range(n)]), axis=1).astype(
                                      np.int64)
    rows = np.broadcast_to(np.arange(n)[:, None], positions.shape)
    labels = original[rows, positions]
    tokens = original.copy()
    tokens[rows, positions] = MASK_ID
    return {"tokens": tokens, "positions": positions, "labels": labels,
            "scatter_idx": np.stack([rows, positions], -1).astype(np.int64)}


def head_inputs(b: dict) -> list:
    """The batch's arrays the head reads after ``hidden``, in graph
    order."""
    return [b["positions"], b["labels"], b["tokens"], b["scatter_idx"]]


def held(got: dict, want: dict, tol: float) -> dict:
    """The head's outputs ``got`` against the fixture ``want`` (numpy
    dicts): floats within ``tol``; ``top_ids`` equal, and ``filled`` equal,
    but at a near-tie: a masked position where the reference's logits
    leave a gap below ``tol`` between neighbouring ranks up to rank k + 1
    (``want["gaps"]``). Returns the worst float gaps, the near-ties and
    the ids that differ at them, and whether it all held."""
    ties = (want["gaps"] < tol).any(-1)                     # [N, M]
    ids_differ = (got["top_ids"] != want["top_ids"]).any(-1)
    rows = np.broadcast_to(np.arange(ties.shape[0])[:, None], ties.shape)
    at_tie = np.zeros(want["filled"].shape, bool)
    at_tie[rows, want["positions"]] = ties
    filled_differ = got["filled"] != want["filled"]
    errs = {k: float(np.abs(got[k] - want[k]).max())
            for k in ("top_values", "loss", "label_logit")}
    floats_ok = all(np.allclose(got[k], want[k], rtol=0, atol=tol)
                    for k in errs)
    return {"max_abs_err": errs, "tolerance": tol,
            "near_tie_positions": int(ties.sum()),
            "ids_differ_at_near_ties": int((ids_differ & ties).sum()),
            "filled_differ_at_near_ties": int((filled_differ & at_tie).sum()),
            "ok": bool(floats_ok and not (ids_differ & ~ties).any()
                       and not (filled_differ & ~at_tie).any())}

"""Generate ``tests/fixtures/cntk_tagger_io.npz``: the CNTK 202 slot tagger.

CNTK 202, "Language Understanding with Recurrent Networks" (the ATIS slot
tagger), bidirectional variant: a 943-word vocabulary, ``Embedding(150)``,
``BiRecurrence(LSTM(150), LSTM(150))`` spliced to 300, ``Dense(129)``, all
under ``default_options(initial_state=0.1)``. :func:`build` writes it with a
``CntkModelBuilder`` from the primitives CNTK's ``Recurrence(LSTM)`` writes:
``b + times(x, W) + times(dh, H)``, four ``Slice``s in CNTK's gate order
(i, c~, f, o), ``Sigmoid``, ``Tanh`` and ``ElementTimes``, ``PastValue`` for
h and c forward and ``FutureValue`` backward. The embedding is ``Times``
over a 943-wide one-hot input.

What is not CNTK's: the weights are random (glorot-uniform, CNTK's default
init, from a numpy seed), because the tutorial's trained ATIS weights are
not in the repository; and each initial state is a ``[150]`` constant of
0.1 where CNTK writes a scalar 0.1, because the reader cannot infer an LSTM
state's width from a scalar (its width walk stops at ``Slice``); the values
are the same.

The npz holds the model bytes' sha256, eight sequences of 64 token ids
(int32) and the JAX package's float32 outputs for them (``[8, 64, 129]``).
:func:`build` takes the ``cntk_format`` module to write with, so the port's
builder writes the same bytes from the same seed; it and :func:`tokens`
import no JAX.

Run from the repo root (JAX on the CPU, ~1 min):
    python tests/fixtures/make_cntk_tagger_fixture.py
"""
import hashlib
import os
import sys

import numpy as np

VOCAB, EMBED, HIDDEN, LABELS = 943, 150, 150, 129
SEQ_LEN, ROWS, SEED = 64, 8, 202
INITIAL_STATE = 0.1
HERE = os.path.dirname(os.path.abspath(__file__))
OUT = os.path.join(HERE, "cntk_tagger_io.npz")


def _glorot(rng, fan_in: int, fan_out: int, shape) -> np.ndarray:
    s = np.sqrt(6.0 / (fan_in + fan_out))
    return rng.uniform(-s, s, size=shape).astype(np.float32)


def weights(vocab=VOCAB, embed=EMBED, hidden=HIDDEN, labels=LABELS,
            seed=SEED) -> dict:
    """The tagger's weights in numpy layout (``x @ W``)."""
    rng = np.random.default_rng(seed)
    out = {"E": _glorot(rng, vocab, embed, (vocab, embed))}
    for d in ("fwd", "bwd"):
        out[f"W_{d}"] = _glorot(rng, embed, 4 * hidden, (embed, 4 * hidden))
        out[f"H_{d}"] = _glorot(rng, hidden, 4 * hidden,
                                (hidden, 4 * hidden))
        out[f"b_{d}"] = np.zeros(4 * hidden, np.float32)
    out["Wd"] = _glorot(rng, 2 * hidden, labels, (2 * hidden, labels))
    out["bd"] = np.zeros(labels, np.float32)
    return out


def _lstm(cf, b, x, w, d: str, hidden: int, backward: bool):
    """CNTK's ``Recurrence(LSTM(hidden))`` over ``x``: returns h."""
    from_state = cf.OP_FUTURE_VALUE if backward else cf.OP_PAST_VALUE
    init = np.full((hidden,), INITIAL_STATE, np.float32)
    dh = b.add_op(from_state, ["__h__", b.add_parameter(init)],
                  {"offset": 1})
    dc = b.add_op(from_state, ["__c__", b.add_parameter(init)],
                  {"offset": 1})
    proj = b.add_op(cf.OP_PLUS, [
        b.add_parameter(w[f"b_{d}"]),
        b.add_op(cf.OP_TIMES, [x, b.add_parameter(w[f"W_{d}"].T)],
                 {"outputRank": 1})])
    proj4 = b.add_op(cf.OP_PLUS, [
        proj, b.add_op(cf.OP_TIMES, [dh, b.add_parameter(w[f"H_{d}"].T)],
                       {"outputRank": 1})])
    it_p, bit_p, ft_p, ot_p = (
        b.add_op(cf.OP_SLICE, [proj4], {
            "axis": cf.CntkAxisRef(0), "beginIndex": k * hidden,
            "endIndex": (k + 1) * hidden})
        for k in range(4))
    it = b.add_op(cf.OP_SIGMOID, [it_p])
    bit = b.add_op(cf.OP_ELEMENT_TIMES, [it, b.add_op(cf.OP_TANH, [bit_p])])
    ft = b.add_op(cf.OP_SIGMOID, [ft_p])
    bft = b.add_op(cf.OP_ELEMENT_TIMES, [ft, dc])
    ct = b.add_op(cf.OP_PLUS, [bft, bit])
    ot = b.add_op(cf.OP_SIGMOID, [ot_p])
    ht = b.add_op(cf.OP_ELEMENT_TIMES, [ot, b.add_op(cf.OP_TANH, [ct])])
    b.set_input(dh, 0, ht)
    b.set_input(dc, 0, ct)
    return ht


def build(cf, vocab=VOCAB, embed=EMBED, hidden=HIDDEN, labels=LABELS,
          seed=SEED) -> bytes:
    """The tagger's CNTK v2 ``.model`` bytes, written with ``cf``'s
    ``CntkModelBuilder`` (either package's ``dl.cntk_format``)."""
    w = weights(vocab, embed, hidden, labels, seed)
    b = cf.CntkModelBuilder("atis_bilstm_slot_tagger")
    x = b.add_input((vocab,), name="query")
    e = b.add_op(cf.OP_TIMES, [x, b.add_parameter(w["E"].T)],
                 {"outputRank": 1})
    hf = _lstm(cf, b, e, w, "fwd", hidden, backward=False)
    hb = _lstm(cf, b, e, w, "bwd", hidden, backward=True)
    h = b.add_op(cf.OP_SPLICE, [hf, hb], {"axis": cf.CntkAxisRef(0)})
    z = b.add_op(cf.OP_TIMES, [h, b.add_parameter(w["Wd"].T)],
                 {"outputRank": 1})
    z = b.add_op(cf.OP_PLUS, [z, b.add_parameter(w["bd"])])
    return b.to_bytes(z)


def tokens(rows: int, seq_len: int = SEQ_LEN, vocab: int = VOCAB,
           seed: int = SEED) -> np.ndarray:
    """``[rows, seq_len]`` int32 token ids from a numpy seed."""
    return np.random.default_rng(seed).integers(
        0, vocab, (rows, seq_len)).astype(np.int32)


def one_hot(ids: np.ndarray, vocab: int = VOCAB) -> np.ndarray:
    """The float32 one-hot rows the embedding's ``Times`` reads."""
    out = np.zeros(ids.shape + (vocab,), np.float32)
    np.put_along_axis(out, ids[..., None].astype(np.int64), 1.0, axis=-1)
    return out


def lstm_reference(x, w, d: str, backward: bool) -> np.ndarray:
    """A numpy loop of CNTK's LSTM over ``x [N, T, embed]``."""
    n, t, _ = x.shape
    hidden = w[f"H_{d}"].shape[0]
    h = np.full((n, hidden), INITIAL_STATE, np.float32)
    c = np.full((n, hidden), INITIAL_STATE, np.float32)
    out = np.zeros((n, t, hidden), np.float32)
    sig = lambda v: 1.0 / (1.0 + np.exp(-v))  # noqa: E731
    for s in (range(t - 1, -1, -1) if backward else range(t)):
        p = w[f"b_{d}"] + x[:, s] @ w[f"W_{d}"] + h @ w[f"H_{d}"]
        i, g, f, o = np.split(p, 4, axis=-1)
        c = sig(f) * c + sig(i) * np.tanh(g)
        h = sig(o) * np.tanh(c)
        out[:, s] = h
    return out


def reference(ids: np.ndarray, w: dict) -> np.ndarray:
    """The tagger's forward as a numpy loop: ``[N, T, labels]``."""
    e = w["E"][ids]
    h = np.concatenate([lstm_reference(e, w, "fwd", False),
                        lstm_reference(e, w, "bwd", True)], axis=-1)
    return h @ w["Wd"] + w["bd"]


def main():
    sys.path.insert(0, os.path.dirname(os.path.dirname(HERE)))
    import jax

    jax.config.update("jax_platforms", "cpu")
    from synapseml_tpu.dl import cntk_format as cf
    from synapseml_tpu.onnx import import_model

    blob = build(cf)
    ids = tokens(ROWS)
    g = import_model(cf.cntk_to_onnx(blob))
    out = np.asarray(g.apply(g.params, one_hot(ids))[0], np.float32)
    np.savez(OUT, sha256=np.array(hashlib.sha256(blob).hexdigest()),
             model_bytes=np.int64(len(blob)), tokens=ids, expected=out,
             jax_version=np.array(jax.__version__))
    gap = np.abs(out - reference(ids, weights())).max()
    print(f"wrote {OUT}: {len(blob)} model bytes, expected {out.shape}, "
          f"max |JAX - numpy loop| {gap:.3g}")


if __name__ == "__main__":
    main()

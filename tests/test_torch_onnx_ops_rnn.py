"""The port's recurrent ONNX ops ``LSTM`` and ``RNN`` against the JAX
package's importer (one-node graphs, the same bytes and seeded numpy inputs
through both, on the CPU), and ``LSTM`` against ``torch.nn.LSTM`` as the
reference's own test (``tests/test_onnx.py``
``test_lstm_bidirectional_matches_torch``) holds it.

Both packages ignore ``seq_lens``, the peepholes, ``clip``,
``input_forget`` and ``layout`` (every sequence runs its full length):
the port keeps parity with that.

Tolerance: float32 outputs within rtol=atol=1e-5 of the reference's
(within rtol=atol=1e-4 of ``torch.nn.LSTM``, the reference test's bound);
bf16 binds within rtol=atol=2e-2 (a step's state is rounded to bf16 each
time step in both, so roundings accumulate over the sequence); output
dtypes equal.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_onnx_parity import assert_parity, dtype_name, one_node, run_both

F32 = np.float32
SEQ, BATCH, EMBED, HIDDEN = 7, 3, 5, 4


def _rng(seed):
    return np.random.default_rng(seed)


def _weights(seed, gates, dirs, bias=True):
    rng = _rng(seed)
    w = (rng.standard_normal((dirs, gates * HIDDEN, EMBED)) * 0.4).astype(F32)
    r = (rng.standard_normal((dirs, gates * HIDDEN, HIDDEN)) * 0.4).astype(F32)
    inits = {"w": w, "r": r}
    if bias:
        inits["b"] = (rng.standard_normal((dirs, 2 * gates * HIDDEN))
                      * 0.2).astype(F32)
    return inits


def _x(seed):
    return _rng(seed).standard_normal((SEQ, BATCH, EMBED)).astype(F32)


def _states(seed, dirs):
    return (_rng(seed).standard_normal((dirs, BATCH, HIDDEN)) * 0.5).astype(
        F32)


def _graph(op, gates, direction, seed, bias=True, init=(), n_out=1,
           **attrs):
    """One ``op`` node: ``x`` fed, W/R/B initializers, optional initial
    states (``init`` of "h" and "c") fed after ``x``."""
    dirs = 2 if direction == "bidirectional" else 1
    inits = _weights(seed, gates, dirs, bias)
    feeds = {"x": _x(seed + 100)}
    for i, name in enumerate(init):
        feeds[name] = _states(seed + 200 + i, dirs)
    node_inputs = ["x", "w", "r", "b" if bias else ""]
    if init:
        node_inputs += ["", *init]      # seq_lens left out
    blob = one_node(op, feeds, inits=inits, node_inputs=node_inputs,
                    n_out=n_out, hidden_size=HIDDEN, direction=direction,
                    **attrs)
    return blob, list(feeds.values())


LSTM_CASES = [
    ("forward", dict(direction="forward")),
    ("reverse", dict(direction="reverse")),
    ("bidirectional", dict(direction="bidirectional")),
    ("bidirectional_three_outputs", dict(direction="bidirectional",
                                         n_out=3)),
    ("no_bias_two_outputs", dict(direction="forward", bias=False, n_out=2)),
    ("initial_states", dict(direction="bidirectional", init=("h", "c"),
                            n_out=3)),
]


@pytest.mark.parametrize("case", LSTM_CASES, ids=[c[0] for c in LSTM_CASES])
def test_lstm_matches_jax(case):
    kw = dict(case[1])
    blob, feeds = _graph("LSTM", 4, kw.pop("direction"), seed=1, **kw)
    assert_parity(*run_both(blob, feeds))


def test_lstm_bf16_bind_matches_jax():
    blob, feeds = _graph("LSTM", 4, "bidirectional", seed=2, n_out=3)
    port, ref = run_both(blob, [feeds[0].astype(jnp.bfloat16)],
                         cast="bfloat16")
    assert all(dtype_name(p) == "bfloat16" for p in port)
    assert_parity(port, ref, rtol=2e-2, atol=2e-2)


def test_lstm_bidirectional_matches_torch():
    """The reference's test: ``torch.nn.LSTM``'s weights reordered from
    torch's gate order (i, f, g, o) to ONNX's (i, o, f, c)."""
    torch.manual_seed(0)
    hidden, embed, seq, batch = 16, 8, 12, 3
    lstm = torch.nn.LSTM(embed, hidden, bidirectional=True).eval()

    def reorder(w):
        i, f, g, o = np.split(w, 4, axis=0)
        return np.concatenate([i, o, f, g], axis=0)

    ws, rs, bs = [], [], []
    for sfx in ("", "_reverse"):
        def get(name):
            return getattr(lstm, f"{name}_l0{sfx}").detach().numpy()
        ws.append(reorder(get("weight_ih")))
        rs.append(reorder(get("weight_hh")))
        bs.append(np.concatenate([reorder(get("bias_ih")),
                                  reorder(get("bias_hh"))]))
    x = _rng(4).normal(size=(seq, batch, embed)).astype(F32)
    blob = one_node("LSTM", {"x": x}, inits={
        "w": np.stack(ws), "r": np.stack(rs), "b": np.stack(bs)},
        hidden_size=hidden, direction="bidirectional")
    port, ref = run_both(blob, [x])
    assert_parity(port, ref)
    with torch.no_grad():
        want, _ = lstm(torch.from_numpy(x))          # (seq, batch, 2*hidden)
    want = want.numpy().reshape(seq, batch, 2, hidden).transpose(0, 2, 1, 3)
    np.testing.assert_allclose(port[0].numpy(), want, rtol=1e-4, atol=1e-4)


def test_lstm_ignores_sequence_lengths_as_the_reference_does():
    """``seq_lens`` shorter than the sequence changes nothing in either
    package (the reference's fault, kept for parity)."""
    blob, feeds = _graph("LSTM", 4, "forward", seed=5)
    lens = np.array([2, 7, 4], np.int32)
    blob_lens = one_node(
        "LSTM", {"x": feeds[0], "l": lens}, inits=_weights(5, 4, 1),
        node_inputs=["x", "w", "r", "b", "l"], hidden_size=HIDDEN)
    port, ref = run_both(blob_lens, [feeds[0], lens])
    assert_parity(port, ref)
    plain, _ = run_both(blob, feeds)
    np.testing.assert_array_equal(port[0].numpy(), plain[0].numpy())


RNN_CASES = [
    ("tanh_forward", dict(direction="forward")),
    ("tanh_reverse", dict(direction="reverse")),
    ("relu_bidirectional", dict(direction="bidirectional",
                                activations=["Relu", "Relu"])),
    ("sigmoid_forward", dict(direction="forward", activations=["Sigmoid"])),
    ("no_bias_two_outputs", dict(direction="bidirectional", bias=False,
                                 n_out=2)),
    ("initial_state", dict(direction="bidirectional", init=("h",),
                           n_out=2)),
]


@pytest.mark.parametrize("case", RNN_CASES, ids=[c[0] for c in RNN_CASES])
def test_rnn_matches_jax(case):
    kw = dict(case[1])
    blob, feeds = _graph("RNN", 1, kw.pop("direction"), seed=6, **kw)
    assert_parity(*run_both(blob, feeds))


@pytest.mark.parametrize("acts", [["Tanh", "Relu"], ["Elu"]])
def test_rnn_refuses_what_the_reference_refuses(acts):
    from synapseml_tpu.onnx import import_model as jax_import_model
    from synapseml_tpu_torch.onnx import import_model

    direction = "bidirectional" if len(acts) == 2 else "forward"
    blob, feeds = _graph("RNN", 1, direction, seed=7, activations=acts)
    with pytest.raises(NotImplementedError, match="RNN"):
        import_model(blob).bind(device="cpu")(feeds[0])
    jg = jax_import_model(blob)
    with pytest.raises(NotImplementedError, match="RNN"):
        jg.apply(jg.params, feeds[0])

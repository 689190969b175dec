"""The port's CNTK v2 reader (``dl/cntk_format.py``) and ``CNTKModel``
against the JAX package's.

Each model of the reference's ``tests/test_cntk_format.py`` is written by
both packages' ``CntkModelBuilder`` (the CNTK v2 bytes must be equal),
converted by both readers (the ONNX bytes must be equal) and run through
both importers on the CPU on the same seeded numpy inputs; each is also
held to that test's own numpy or torch reference at its tolerance. The
errors the reference raises are raised alike. ``CNTKModel``'s cases of
``tests/test_profiling_cntk.py`` run through both packages' class; a
stage directory the JAX package saved loads into the port's class. The
CNTK 202 slot tagger (``tests/fixtures/make_cntk_tagger_fixture.py``) runs
at a small width against JAX and a numpy LSTM loop, and at its published
width against the JAX fixture.

Tolerance: float32 outputs within rtol=atol=1e-5 of the reference's (one
Scan step adds no arithmetic of its own); bf16 binds within rtol=atol=2e-2
of the reference's bf16 (a state is rounded each step in both); the
committed fixtures within rtol=atol=2e-5 of their expected outputs (the
reference test's bound), the tagger's bf16 rows within 5% of the largest
|value| of the float32 fixture (``PERF.md`` §2's bf16 gate).
"""
import hashlib
import os
import shutil
import subprocess
import sys
import zlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import test_cntk_format as ref_tests
from synapseml_tpu.data.table import Table as JaxTable
from synapseml_tpu.dl import cntk_format as jcf
from synapseml_tpu.dl.cntk import CNTKModel as JaxCNTKModel
from synapseml_tpu.onnx import import_model as jax_import_model
from synapseml_tpu.onnx import zoo
from synapseml_tpu_torch.core.pipeline import PipelineStage
from synapseml_tpu_torch.data.table import Table
from synapseml_tpu_torch.dl import cntk_format as pcf
from synapseml_tpu_torch.dl.cntk import CNTKModel
from synapseml_tpu_torch.onnx import import_model, proto
from torch_onnx_parity import assert_parity, run_both, to_numpy

FIXTURES = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "fixtures")
sys.path.insert(0, FIXTURES)
import make_cntk_tagger_fixture as tagger  # noqa: E402

F32 = np.float32


def _normal(seed, shape, scale=1.0):
    return (np.random.default_rng(seed).normal(size=shape)
            * scale).astype(F32)


# -- the reference's models, written by either package's builder ---------

def _mlp(cf):
    rng = np.random.default_rng(0)
    w1 = rng.normal(size=(8, 16)).astype(F32)
    b1 = rng.normal(size=(16,)).astype(F32)
    w2 = rng.normal(size=(16, 3)).astype(F32)
    b2 = rng.normal(size=(3,)).astype(F32)
    b = cf.CntkModelBuilder("mlp")
    x = b.add_input((8,))
    h = b.add_op(cf.OP_TIMES, [x, b.add_parameter(w1.T)], {"outputRank": 1})
    h = b.add_op(cf.OP_PLUS, [h, b.add_parameter(b1)])
    h = b.add_op(cf.OP_RELU, [h])
    z = b.add_op(cf.OP_TIMES, [h, b.add_parameter(w2.T)], {"outputRank": 1})
    z = b.add_op(cf.OP_PLUS, [z, b.add_parameter(b2)])
    xv = _normal(1, (5, 8))
    logits = np.maximum(xv @ w1 + b1, 0.0) @ w2 + b2
    e = np.exp(logits - logits.max(-1, keepdims=True))
    return (b.to_bytes(b.add_op(cf.OP_SOFTMAX, [z])), xv,
            e / e.sum(-1, keepdims=True), 1e-5)


def _times_cpp_order(cf):
    w = _normal(3, (4, 6))
    b = cf.CntkModelBuilder()
    x = b.add_input((4,))
    y = b.add_op(cf.OP_TIMES, [b.add_parameter(w), x], {"outputRank": 1})
    xv = _normal(4, (3, 4))
    return b.to_bytes(y), xv, xv @ w, 1e-5


def _transpose_times(cf):
    w = _normal(5, (6, 4))
    b = cf.CntkModelBuilder()
    x = b.add_input((4,))
    y = b.add_op(cf.OP_TRANSPOSE_TIMES, [b.add_parameter(w), x],
                 {"outputRank": 1})
    xv = _normal(6, (3, 4))
    return b.to_bytes(y), xv, xv @ w.T, 1e-5


def _conv_pool_bn(cf):
    torch.manual_seed(0)
    conv = torch.nn.Conv2d(3, 8, 3, padding=1, bias=False).eval()
    bn = torch.nn.BatchNorm2d(8).eval()
    with torch.no_grad():
        bn.running_mean.normal_(0, 0.5)
        bn.running_var.uniform_(0.5, 2.0)
        bn.weight.normal_(1, 0.2)
        bn.bias.normal_(0, 0.2)
    net = torch.nn.Sequential(conv, bn, torch.nn.ReLU(),
                              torch.nn.MaxPool2d(2)).eval()
    b = cf.CntkModelBuilder("cnn")
    x = b.add_input((3, 8, 8))
    y = b.add_op(cf.OP_CONVOLUTION,
                 [b.add_parameter(conv.weight.detach().numpy()), x],
                 {"strides": [1, 1], "autoPadding": [True, True]})
    y = b.add_op(cf.OP_BATCH_NORM, [
        y, b.add_parameter(bn.weight.detach().numpy()),
        b.add_parameter(bn.bias.detach().numpy()),
        b.add_parameter(bn.running_mean.numpy()),
        b.add_parameter(bn.running_var.numpy()),
    ], {"epsilon": float(bn.eps), "spatial": True})
    y = b.add_op(cf.OP_RELU, [y])
    y = b.add_op(cf.OP_POOLING, [y], {"poolingType": 0,
                                      "poolingWindowShape": [2, 2],
                                      "strides": [2, 2],
                                      "autoPadding": [False, False]})
    xv = _normal(5, (2, 3, 8, 8))
    with torch.no_grad():
        want = net(torch.from_numpy(xv)).numpy()
    return b.to_bytes(y), xv, want, 1e-4


def _reshape_splice_slice(cf):
    b = cf.CntkModelBuilder()
    x = b.add_input((2, 6))
    y = b.add_op(cf.OP_RESHAPE, [x], {"newShape": [4, 3]})
    y = b.add_op(cf.OP_SLICE, [y], {"axis": cf.CntkAxisRef(0),
                                    "beginIndex": 0, "endIndex": 2})
    y2 = b.add_op(cf.OP_DROPOUT, [y])
    cat = b.add_op(cf.OP_SPLICE, [y, y2], {"axis": cf.CntkAxisRef(0)})
    lo = b.add_parameter(np.float32(-0.5).reshape(()))
    hi = b.add_parameter(np.float32(0.5).reshape(()))
    out = b.add_op(cf.OP_COMBINE, [b.add_op(cf.OP_CLIP, [cat, lo, hi])])
    xv = _normal(7, (3, 2, 6))
    part = xv.reshape(3, 3, 4)[:, :, :2]
    want = np.clip(np.concatenate([part, part], axis=-1), -0.5, 0.5)
    return b.to_bytes(out), xv, want, 1e-6


def _slice_end(begin, end, want_slice):
    def make(cf):
        b = cf.CntkModelBuilder()
        x = b.add_input((6,))
        y = b.add_op(cf.OP_SLICE, [x], {"axis": cf.CntkAxisRef(0),
                                        "beginIndex": begin,
                                        "endIndex": end})
        xv = np.arange(12, dtype=F32).reshape(2, 6)
        return b.to_bytes(y), xv, xv[:, want_slice], 0.0
    return make


def _shared_parameter(cf):
    w = _normal(9, (4, 4))
    b = cf.CntkModelBuilder()
    x = b.add_input((4,))
    wp = b.add_parameter(w)
    h = b.add_op(cf.OP_TIMES, [x, wp], {"outputRank": 1})
    y = b.add_op(cf.OP_TRANSPOSE_TIMES, [wp, h], {"outputRank": 1})
    xv = _normal(10, (3, 4))
    return b.to_bytes(y), xv, (xv @ w.T) @ w.T, 1e-4


def _rnn(seed, backward, scalar_init, x_seed, x_shape):
    def make(cf):
        feat, hidden = 6, 5
        rng = np.random.default_rng(seed)
        W = (rng.normal(size=(feat, hidden)) * 0.4).astype(F32)
        R = (rng.normal(size=(hidden, hidden)) * 0.4).astype(F32)
        bias = rng.normal(size=(hidden,)).astype(F32) * 0.1
        b = cf.CntkModelBuilder("rnn")
        x = b.add_input((feat,))
        wx = b.add_op(cf.OP_TIMES, [x, b.add_parameter(W.T)],
                      {"outputRank": 1})
        init = b.add_parameter(np.zeros((), F32) if scalar_init
                               else np.zeros((hidden,), F32))
        pv = b.add_op(cf.OP_FUTURE_VALUE if backward else cf.OP_PAST_VALUE,
                      ["__patched__", init], {"offset": 1})
        rh = b.add_op(cf.OP_TIMES, [pv, b.add_parameter(R.T)],
                      {"outputRank": 1})
        s = b.add_op(cf.OP_PLUS, [b.add_op(cf.OP_PLUS, [wx, rh]),
                                  b.add_parameter(bias)])
        h = b.add_op(cf.OP_TANH, [s])
        b.set_input(pv, 0, h)
        xv = _normal(x_seed, x_shape)
        return (b.to_bytes(h), xv,
                ref_tests._rnn_reference(xv, W, R, bias, backward), 2e-5)
    return make


def _two_state(cf):
    feat = hidden = 4
    W = _normal(5, (feat, hidden), 0.5)
    b = cf.CntkModelBuilder("two_state")
    x = b.add_input((feat,))
    wx = b.add_op(cf.OP_TIMES, [x, b.add_parameter(W.T)], {"outputRank": 1})
    half = b.add_parameter(np.float32(0.5).reshape(()))
    point3 = b.add_parameter(np.float32(0.3).reshape(()))
    zero = b.add_parameter(np.zeros((hidden,), F32))
    pv_c = b.add_op(cf.OP_PAST_VALUE, ["__c__", zero], {"offset": 1})
    pv_h = b.add_op(cf.OP_PAST_VALUE, ["__h__", zero], {"offset": 1})
    c = b.add_op(cf.OP_PLUS, [b.add_op(cf.OP_ELEMENT_TIMES, [half, pv_c]),
                              wx])
    c = b.add_op(cf.OP_PLUS, [c, b.add_op(cf.OP_ELEMENT_TIMES,
                                          [point3, pv_h])])
    h = b.add_op(cf.OP_TANH, [c])
    b.set_input(pv_c, 0, c)
    b.set_input(pv_h, 0, h)
    xv = _normal(6, (2, 6, feat))
    cc = np.zeros((2, hidden), F32)
    hh = np.zeros((2, hidden), F32)
    want = np.zeros((2, 6, hidden), F32)
    for i in range(6):
        cc = 0.5 * cc + xv[:, i] @ W + 0.3 * hh
        hh = np.tanh(cc)
        want[:, i] = hh
    return b.to_bytes(h), xv, want, 2e-5


def _stacked(cf):
    feat = 4
    rng = np.random.default_rng(7)
    W1 = (rng.normal(size=(feat, feat)) * 0.4).astype(F32)
    W2 = (rng.normal(size=(feat, feat)) * 0.4).astype(F32)
    b = cf.CntkModelBuilder("stacked")
    x = b.add_input((feat,))
    zero = b.add_parameter(np.zeros((feat,), F32))
    hs = []
    src = x
    for w in (W1, W2):
        wx = b.add_op(cf.OP_TIMES, [src, b.add_parameter(w.T)],
                      {"outputRank": 1})
        pv = b.add_op(cf.OP_PAST_VALUE, ["__s__", zero], {"offset": 1})
        h = b.add_op(cf.OP_TANH, [b.add_op(cf.OP_PLUS, [wx, pv])])
        b.set_input(pv, 0, h)
        hs.append(h)
        src = h
    xv = _normal(8, (2, 5, feat))
    h1 = np.zeros((2, feat), F32)
    h2 = np.zeros((2, feat), F32)
    want = np.zeros((2, 5, feat), F32)
    for i in range(5):
        h1 = np.tanh(xv[:, i] @ W1 + h1)
        h2 = np.tanh(h1 @ W2 + h2)
        want[:, i] = h2
    return b.to_bytes(hs[-1]), xv, want, 2e-5


def _captured_bias(cf):
    feat, hidden = 3, 4
    rng = np.random.default_rng(9)
    W = (rng.normal(size=(feat, hidden)) * 0.4).astype(F32)
    b1 = rng.normal(size=(hidden,)).astype(F32) * 0.1
    b2 = rng.normal(size=(hidden,)).astype(F32) * 0.1
    b = cf.CntkModelBuilder("captured_bias")
    x = b.add_input((feat,))
    wx = b.add_op(cf.OP_TIMES, [x, b.add_parameter(W.T)], {"outputRank": 1})
    bias = b.add_op(cf.OP_PLUS, [b.add_parameter(b1), b.add_parameter(b2)])
    zero = b.add_parameter(np.zeros((hidden,), F32))
    pv = b.add_op(cf.OP_PAST_VALUE, ["__h__", zero], {"offset": 1})
    s = b.add_op(cf.OP_PLUS, [b.add_op(cf.OP_PLUS, [wx, pv]), bias])
    h = b.add_op(cf.OP_TANH, [s])
    b.set_input(pv, 0, h)
    xv = _normal(10, (2, 5, feat))
    hh = np.zeros((2, hidden), F32)
    want = np.zeros((2, 5, hidden), F32)
    for i in range(5):
        hh = np.tanh(xv[:, i] @ W + hh + (b1 + b2))
        want[:, i] = hh
    return b.to_bytes(h), xv, want, 2e-5


def _shadow(cf):
    feat, hidden = 2, 3
    b = cf.CntkModelBuilder("shadow")
    bias = b.add_op(cf.OP_PLUS, [
        b.add_parameter(np.full((hidden,), 10.0, F32)),
        b.add_parameter(np.full((hidden,), 10.0, F32))])
    x = b.add_input((feat,))
    wx = b.add_op(cf.OP_TIMES, [x, b.add_parameter(
        np.zeros((feat, hidden), F32).T)], {"outputRank": 1})
    zero = b.add_parameter(np.zeros((hidden,), F32))
    pv = b.add_op(cf.OP_PAST_VALUE, ["__h__", zero], {"offset": 1})
    s = b.add_op(cf.OP_PLUS, [b.add_op(cf.OP_PLUS, [wx, pv]), bias])
    h = b.add_op(cf.OP_TANH, [s])
    b.set_input(pv, 0, h)
    xv = np.zeros((1, 2, feat), F32)
    h1 = np.tanh(F32(20.0))
    want = np.stack([np.full((1, hidden), h1),
                     np.full((1, hidden), np.tanh(h1 + 20.0))], 1)
    return b.to_bytes(h), xv, want.astype(F32), 1e-5


def _state_first(cf):
    feat, hidden = 3, 5
    W = _normal(12, (feat, hidden), 0.4)
    b = cf.CntkModelBuilder("swapped")
    x = b.add_input((feat,))
    wx = b.add_op(cf.OP_TIMES, [x, b.add_parameter(W.T)], {"outputRank": 1})
    init = b.add_parameter(np.zeros((), F32))
    pv = b.add_op(cf.OP_PAST_VALUE, ["__h__", init], {"offset": 1})
    h = b.add_op(cf.OP_TANH, [b.add_op(cf.OP_PLUS, [pv, wx])])
    b.set_input(pv, 0, h)
    xv = _normal(13, (2, 4, feat))
    hh = np.zeros((2, hidden), F32)
    want = np.zeros((2, 4, hidden), F32)
    for i in range(4):
        hh = np.tanh(hh + xv[:, i] @ W)
        want[:, i] = hh
    return b.to_bytes(h), xv, want, 2e-5


def _rnn_stack(cf, blob, feat, attrs):
    b = cf.CntkModelBuilder("opt_rnn")
    x = b.add_input((feat,))
    y = b.add_op(cf.OP_OPTIMIZED_RNN, [x, b.add_parameter(blob)], attrs)
    return b.to_bytes(y)


def _cudnn_lstm(cf):
    feat, H = 3, 4
    rng = np.random.default_rng(30)
    W = (rng.normal(size=(4, H, feat)) * 0.4).astype(F32)
    R = (rng.normal(size=(4, H, H)) * 0.4).astype(F32)
    bW = (rng.normal(size=(4, H)) * 0.1).astype(F32)
    bR = (rng.normal(size=(4, H)) * 0.1).astype(F32)
    blob = ref_tests._pack_cudnn_blob([(W, R, bW, bR)])
    xv = _normal(31, (2, 5, feat))
    return (_rnn_stack(cf, blob, feat, {
        "hiddenSize": H, "numLayers": 1, "bidirectional": False,
        "recurrentOp": "lstm"}), xv,
        ref_tests._cudnn_lstm_ref(xv, W, R, bW, bR), 2e-5)


def _cudnn_bidi_gru(cf):
    feat, H = 3, 3
    rng = np.random.default_rng(32)

    def mk():
        return ((rng.normal(size=(3, H, feat)) * 0.4).astype(F32),
                (rng.normal(size=(3, H, H)) * 0.4).astype(F32),
                (rng.normal(size=(3, H)) * 0.1).astype(F32),
                (rng.normal(size=(3, H)) * 0.1).astype(F32))

    fwd, bwd = mk(), mk()
    blob = ref_tests._pack_cudnn_blob([fwd, bwd])
    xv = _normal(33, (2, 6, feat))
    want = np.concatenate([ref_tests._cudnn_gru_ref(xv, *fwd),
                           ref_tests._cudnn_gru_ref(xv, *bwd, reverse=True)],
                          axis=-1)
    return (_rnn_stack(cf, blob, feat, {
        "hiddenSize": H, "numLayers": 1, "bidirectional": True,
        "recurrentOp": "gru"}), xv, want, 2e-5)


def _two_layer_relu_layers():
    feat, H = 4, 3
    rng = np.random.default_rng(34)

    def mk(in_w):
        return ((rng.normal(size=(1, H, in_w)) * 0.4).astype(F32),
                (rng.normal(size=(1, H, H)) * 0.4).astype(F32),
                (rng.normal(size=(1, H)) * 0.1).astype(F32),
                (rng.normal(size=(1, H)) * 0.1).astype(F32))

    return feat, H, mk(feat), mk(H)


RELU_ATTRS = {"numLayers": 2, "bidirectional": False,
              "recurrentOp": "rnnReLU"}


def _cudnn_two_layer_relu(cf):
    feat, H, l0, l1 = _two_layer_relu_layers()
    blob = ref_tests._pack_cudnn_blob([l0, l1])
    xv = _normal(35, (2, 4, feat))
    h1 = np.zeros((2, H), F32)
    h2 = np.zeros((2, H), F32)
    want = np.zeros((2, 4, H), F32)
    for s in range(4):
        h1 = np.maximum(xv[:, s] @ l0[0][0].T + h1 @ l0[1][0].T + l0[2][0]
                        + l0[3][0], 0.0)
        h2 = np.maximum(h1 @ l1[0][0].T + h2 @ l1[1][0].T + l1[2][0]
                        + l1[3][0], 0.0)
        want[:, s] = h2
    return (_rnn_stack(cf, blob, feat, {"hiddenSize": H, **RELU_ATTRS}),
            xv, want, 2e-5)


def _cudnn_torch(kind, bidi, layers):
    def make(cf):
        feat, H, n, t = 3, 5, 2, 7
        torch.manual_seed(zlib.crc32(f"{kind}|{bidi}|{layers}".encode()))
        if kind == "lstm":
            mod, gates = torch.nn.LSTM(feat, H, num_layers=layers,
                                       bidirectional=bidi,
                                       batch_first=True), 4
        elif kind == "gru":
            mod, gates = torch.nn.GRU(feat, H, num_layers=layers,
                                      bidirectional=bidi,
                                      batch_first=True), 3
        else:
            mod, gates = torch.nn.RNN(
                feat, H, num_layers=layers, bidirectional=bidi,
                batch_first=True,
                nonlinearity="tanh" if kind == "rnnTanh" else "relu"), 1
        blob = ref_tests._torch_cudnn_blob(mod, gates)
        xv = _normal(40, (n, t, feat))
        with torch.no_grad():
            want = mod(torch.from_numpy(xv))[0].numpy()
        return (_rnn_stack(cf, blob, feat, {
            "hiddenSize": H, "numLayers": layers, "bidirectional": bidi,
            "recurrentOp": kind}), xv, want, 3e-5)
    return make


MODELS = {
    "mlp": _mlp,
    "times_cpp_arg_order": _times_cpp_order,
    "transpose_times": _transpose_times,
    "conv_pool_bn": _conv_pool_bn,
    "reshape_splice_slice_clip_dropout_combine": _reshape_splice_slice,
    "slice_end_zero": _slice_end(2, 0, slice(2, None)),
    "slice_negative_end": _slice_end(1, -2, slice(1, -2)),
    "shared_parameter_both_orientations": _shared_parameter,
    "past_value_scalar_init": _rnn(0, False, True, 1, (3, 7, 6)),
    "future_value_backward": _rnn(3, True, False, 2, (2, 5, 6)),
    "two_state_cycle": _two_state,
    "stacked_recurrences": _stacked,
    "param_derived_capture": _captured_bias,
    "body_names_do_not_shadow": _shadow,
    "scalar_init_state_first": _state_first,
    "optimized_rnn_lstm": _cudnn_lstm,
    "optimized_rnn_bidi_gru": _cudnn_bidi_gru,
    "optimized_rnn_two_layer_relu": _cudnn_two_layer_relu,
    **{f"optimized_rnn_torch_{k}_{'bi' if b else 'uni'}_{n}":
       _cudnn_torch(k, b, n) for k, b, n in [
           ("lstm", False, 1), ("lstm", True, 1), ("lstm", False, 2),
           ("lstm", True, 2), ("gru", False, 1), ("gru", True, 1),
           ("gru", False, 2), ("rnnTanh", False, 1), ("rnnTanh", True, 1),
           ("rnnReLU", False, 2)]},
}

SCANS = {"two_state_cycle": 1, "stacked_recurrences": 2}


@pytest.mark.parametrize("host", [True, False], ids=["host", "device"])
@pytest.mark.parametrize("name", list(MODELS))
def test_cntk_model_through_both_readers(name, host):
    blob, xv, want, tol = MODELS[name](pcf)
    assert blob == MODELS[name](jcf)[0]
    assert pcf.looks_like_cntk_v2(blob)
    onnx_bytes = pcf.cntk_to_onnx(blob)
    assert onnx_bytes == jcf.cntk_to_onnx(blob)
    if name in SCANS:
        model = proto.load_model(onnx_bytes)
        assert sum(n.op_type == "Scan"
                   for n in model.graph.node) == SCANS[name]
    port, ref = run_both(onnx_bytes, [xv], host=host)
    assert_parity(port, ref, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(to_numpy(port[0]), want, rtol=tol,
                               atol=tol)


def test_dictionary_round_trip_and_bytes():
    top = {"version": 1, "type": "CompositeFunction", "name": "m",
           "shape": [3, 4], "flag": True, "lr": 0.5,
           "axis": pcf.CntkAxisRef(1, "a"),
           "arr": np.arange(6, dtype=F32).reshape(2, 3),
           "nested": {"k": "v", "vec": ["a", "b"], "neg": -3}}
    blob = proto.encode(pcf.py_to_dict(top))
    jtop = dict(top, axis=jcf.CntkAxisRef(1, "a"))
    from synapseml_tpu.onnx import proto as jproto
    assert blob == jproto.encode(jcf.py_to_dict(jtop))
    back = pcf.load_model_dictionary(blob)
    assert back["type"] == "CompositeFunction"
    assert back["shape"] == [3, 4]
    assert back["flag"] is True and back["lr"] == 0.5
    assert back["axis"].static_axis_idx == 1
    np.testing.assert_array_equal(back["arr"], top["arr"])
    assert back["nested"]["vec"] == ["a", "b"]
    assert back["nested"]["neg"] == -3


def test_unknown_op_and_unfactored_blob_are_refused_alike():
    for cf in (pcf, jcf):
        b = cf.CntkModelBuilder()
        blob = b.to_bytes(b.add_op(999, [b.add_input((4,))]))
        with pytest.raises(NotImplementedError, match="op code 999"):
            cf.cntk_to_onnx(blob)
        feat, H, l0, l1 = _two_layer_relu_layers()
        short = ref_tests._pack_cudnn_blob([l0, l1])[:-1]
        with pytest.raises(ValueError, match="does not factor"):
            cf.cntk_to_onnx(_rnn_stack(cf, short, feat,
                                       {"hiddenSize": H, **RELU_ATTRS}))


def test_malformed_composite_raises_value_error_with_recipe():
    top = {"version": 1, "type": "CompositeFunction", "root": "F1",
           "uid": "c", "name": "bad", "inputs": [],
           "primitive_functions": [{
               "version": 1, "uid": "F1", "op": pcf.OP_RELU,
               "inputs": ["nosuchvar"], "attributes": {}, "name": ""}]}
    blob = proto.encode(pcf.py_to_dict(top))
    for cls in (CNTKModel, JaxCNTKModel):
        with pytest.raises(ValueError, match="reader said"):
            cls(model_bytes=blob)


@pytest.mark.skipif(shutil.which("protoc") is None,
                    reason="protoc not installed")
def test_wire_format_cross_checked_with_protoc(tmp_path):
    """protoc decodes the port's bytes under CNTK.proto, and its
    re-encoding converts to the same ONNX in both readers."""
    protoc = shutil.which("protoc")
    (tmp_path / "cntk.proto").write_text(ref_tests.CNTK_PROTO)
    blob = _mlp(pcf)[0]
    r = subprocess.run([protoc, f"--proto_path={tmp_path}",
                        "--decode=CNTK.proto.Dictionary", "cntk.proto"],
                       input=blob, capture_output=True, timeout=120)
    assert r.returncode == 0, r.stderr.decode()
    assert "primitive_functions" in r.stdout.decode()
    r2 = subprocess.run([protoc, f"--proto_path={tmp_path}",
                         "--encode=CNTK.proto.Dictionary", "cntk.proto"],
                        input=r.stdout, capture_output=True, timeout=120)
    assert r2.returncode == 0, r2.stderr.decode()
    assert pcf.load_model_dictionary(r2.stdout)["type"] == \
        "CompositeFunction"
    assert pcf.cntk_to_onnx(r2.stdout) == jcf.cntk_to_onnx(r2.stdout)


def test_build_optimized_rnn_model_bytes_equal():
    kw = dict(input_dim=5, hidden=4, num_layers=2, bidirectional=True,
              cell="gru", seed=3)
    assert pcf.build_optimized_rnn_model(**kw) == \
        jcf.build_optimized_rnn_model(**kw)


# -- CNTKModel -----------------------------------------------------------

def _both(blob, jax_kw=None, port_kw=None):
    return (CNTKModel(model_bytes=blob, **(port_kw or {})),
            JaxCNTKModel(model_bytes=blob, **(jax_kw or port_kw or {})))


def _column(model, table, col, jax=False):
    out = model.transform(table) if jax else model.transform(table,
                                                             device="cpu")
    return np.asarray(out[col])


@pytest.mark.parametrize("fixture", ["cntk_rnn"])
def test_committed_recurrent_fixture_through_cntk_model(fixture):
    io = np.load(os.path.join(FIXTURES, f"{fixture}_io.npz"))
    path = os.path.join(FIXTURES, f"{fixture}.model")
    m, jm = CNTKModel(model_path=path), JaxCNTKModel(model_path=path)
    for model in (m, jm):
        md = model.model_metadata()
        model.set(feed_dict={list(md["inputs"])[0]: "x"},
                  fetch_dict={"y": md["outputs"][0]})
    got = _column(m, Table({"x": io["input"]}), "y")
    np.testing.assert_allclose(got, io["expected"], rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(
        got, _column(jm, JaxTable({"x": io["input"]}), "y", jax=True),
        rtol=1e-5, atol=1e-5)


def test_cntk_model_consumes_raw_model_bytes():
    blob, xv, want, _ = _mlp(pcf)
    m, jm = _both(blob, port_kw={"mini_batch_size": 16})
    for model in (m, jm):
        model.set(feed_dict={model.graph.input_names[0]: "features"})
    out = m.graph.output_names[0]
    got = _column(m, Table({"features": xv}), out)
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(
        got, _column(jm, JaxTable({"features": xv}), out, jax=True),
        rtol=1e-5, atol=1e-5)


def test_cntk_model_onnx_path_and_port_selection():
    blob = zoo.mlp([6, 12], num_classes=4, seed=1)
    x = _normal(0, (5, 6))
    m, jm = _both(blob)
    for model in (m, jm):
        model.set_input_node(0, column="feats").set_output_node(
            0, column="probs")
    got = _column(m, Table({"feats": x}), "probs")
    assert got.shape == (5, 4)
    np.testing.assert_allclose(
        got, _column(jm, JaxTable({"feats": x}), "probs", jax=True),
        rtol=1e-5, atol=1e-5)
    m2 = CNTKModel(model_bytes=blob).set_input_node(
        m.graph.input_names[0], column="feats")
    m2.set_output_node(m.graph.output_names[0], column="probs")
    np.testing.assert_allclose(_column(m2, Table({"feats": x}), "probs"),
                               got, rtol=1e-6)
    with pytest.raises(KeyError):
        m.set_output_node("nonexistent")


NATIVE = "BCNTK".encode("utf-16-le") + b"\x00" * 64
RECIPE = "ONNX export with the CNTK python package"


def test_cntk_native_model_rejected_with_recipe():
    for cls in (CNTKModel, JaxCNTKModel):
        with pytest.raises(ValueError, match=RECIPE):
            cls(model_bytes=NATIVE)
        m = cls()
        m.set(model_payload=NATIVE)   # the Param path
        with pytest.raises(ValueError, match=RECIPE):
            _ = m.graph


def _images():
    return _normal(0, (2, 3, 24, 24))


def test_cntk_cut_output_layers_headless():
    blob = zoo.tiny_resnet(image_size=24)
    kw = {"feed_dict": {"data": "img"}, "fetch_dict": None}
    m, jm = _both(blob, port_kw=kw)
    m.cut_output_layers(1)
    jm.cut_output_layers(1)
    out = m.graph.output_names[0]
    assert out == jm.graph.output_names[0]
    feats = _column(m, Table({"img": _images()}), out)
    assert feats.ndim == 2 and feats.shape[0] == 2 and feats.shape[1] > 4
    np.testing.assert_allclose(
        feats, _column(jm, JaxTable({"img": _images()}), out, jax=True),
        rtol=1e-5, atol=1e-5)


def test_cntk_truncation_survives_serde_and_copy(tmp_path):
    blob = zoo.tiny_resnet(image_size=24)
    m = CNTKModel(model_bytes=blob, feed_dict={"data": "img"},
                  fetch_dict=None).cut_output_layers(1)
    out = m.graph.output_names[0]
    feats = _column(m, Table({"img": _images()}), out)
    m.save(str(tmp_path / "cntk"))
    m2 = PipelineStage.load(str(tmp_path / "cntk"))
    assert isinstance(m2, CNTKModel) and m2.cut_layers == 1
    np.testing.assert_allclose(
        _column(m2, Table({"img": _images()}), m2.graph.output_names[0]),
        feats, rtol=1e-5)
    m3 = m.copy()
    np.testing.assert_allclose(
        _column(m3, Table({"img": _images()}), m3.graph.output_names[0]),
        feats, rtol=1e-5)


def test_jax_saved_cntk_model_loads_in_the_port(tmp_path):
    """A stage directory the JAX package saved (CNTK v2 bytes converted,
    a cut) loads into the port's class and scores what it scores."""
    path = os.path.join(FIXTURES, "cntk_rnn.model")
    io = np.load(os.path.join(FIXTURES, "cntk_rnn_io.npz"))
    jm = JaxCNTKModel(model_path=path, mini_batch_size=4)
    jm.set(feed_dict={jm.graph.input_names[0]: "x"})
    jm.cut_output_layers(1)   # drop the head's bias Add
    jm.save(str(tmp_path / "jax_cntk"))
    m = PipelineStage.load(str(tmp_path / "jax_cntk"))
    assert type(m) is CNTKModel
    assert m.cut_layers == 1 and m.mini_batch_size == 4
    out = m.graph.output_names[0]
    assert out == jm.graph.output_names[0]
    np.testing.assert_allclose(
        _column(m, Table({"x": io["input"]}), out),
        _column(jm, JaxTable({"x": io["input"]}), out, jax=True),
        rtol=1e-5, atol=1e-5)


def test_cntk_multi_input_feed_merge():
    from synapseml_tpu_torch.onnx import GraphBuilder

    g = GraphBuilder(name="two_in", opset=17)
    a = g.add_input("a", F32, ["N", 3])
    b = g.add_input("b", F32, ["N", 3])
    g.add_output(g.add_node("Add", [a, b]), F32, ["N", 3])
    m = CNTKModel(model_bytes=g.to_bytes())
    m.set_input_node(0, column="left").set_input_node(1, column="right")
    m.set_output_node(0, column="sum")
    x = np.ones((2, 3), F32)
    np.testing.assert_allclose(
        _column(m, Table({"left": x, "right": x * 2}), "sum"), x * 3)


def test_cntk_cut_via_param_api_refreshes_executor():
    blob = zoo.tiny_resnet(image_size=24)
    m = CNTKModel(model_bytes=blob, feed_dict={"data": "img"},
                  fetch_dict=None)
    full = _column(m, Table({"img": _images()}), m.graph.output_names[0])
    m.set(cut_layers=1)
    feats = _column(m, Table({"img": _images()}), m.graph.output_names[0])
    assert feats.shape != full.shape


def test_payload_swap_refreshes_graph():
    m = CNTKModel(model_bytes=zoo.mlp([6, 12], num_classes=2, seed=9))
    x = _normal(0, (3, 6))
    assert _column(m, Table({"input": x}),
                   m.graph.output_names[0]).shape == (3, 2)
    m.set(model_payload=zoo.mlp([6, 12], num_classes=4, seed=9))
    assert _column(m, Table({"input": x}),
                   m.graph.output_names[0]).shape == (3, 4)
    m.set(model_payload=NATIVE)
    with pytest.raises(ValueError, match=RECIPE):
        _ = m.graph


# -- the CNTK 202 slot tagger ---------------------------------------------

SMALL = dict(vocab=17, embed=6, hidden=5, labels=4, seed=3)


@pytest.mark.parametrize("seq_len", [7, 20])
def test_tagger_small_width_against_jax_and_a_numpy_loop(seq_len):
    blob = tagger.build(pcf, **SMALL)
    assert blob == tagger.build(jcf, **SMALL)
    onnx_bytes = pcf.cntk_to_onnx(blob)
    assert onnx_bytes == jcf.cntk_to_onnx(blob)
    ids = tagger.tokens(3, seq_len, SMALL["vocab"], seed=seq_len)
    x = tagger.one_hot(ids, SMALL["vocab"])
    port, ref = run_both(onnx_bytes, [x])
    assert_parity(port, ref, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(
        port[0].numpy(), tagger.reference(ids, tagger.weights(**SMALL)),
        rtol=2e-5, atol=2e-5)


def test_tagger_bf16_within_a_few_steps_matches_jax():
    blob = pcf.cntk_to_onnx(tagger.build(pcf, **SMALL))
    x = tagger.one_hot(tagger.tokens(3, 7, SMALL["vocab"], seed=1),
                       SMALL["vocab"])
    port, ref = run_both(blob, [x.astype(jnp.bfloat16)], cast="bfloat16")
    assert_parity(port, ref, rtol=2e-2, atol=2e-2)


def test_tagger_bf16_past_16_steps_runs_where_the_reference_raises():
    """The reference runs a Scan above 16 steps as ``lax.scan``, whose
    carry may not change dtype: a bf16 bind's state turns float32 at the
    first step (the body's recurrent weight is not cast), so it raises.
    The port's one step loop runs it; its output is held to the float32
    reference's within the bf16 gate."""
    blob = pcf.cntk_to_onnx(tagger.build(pcf, **SMALL))
    x = tagger.one_hot(tagger.tokens(3, 20, SMALL["vocab"], seed=2),
                       SMALL["vocab"])
    g = jax_import_model(blob)
    with pytest.raises(TypeError, match="carry"):
        g.bind(jnp.bfloat16)(jnp.asarray(x, jnp.bfloat16))
    got = import_model(blob).bind(cast_dtype=torch.bfloat16, device="cpu")(
        torch.from_numpy(x).to(torch.bfloat16))[0].float().numpy()
    want = np.asarray(g.bind()(jnp.asarray(x))[0])
    assert np.abs(got - want).max() <= 0.05 * np.abs(want).max()


def test_tagger_published_width_against_the_jax_fixture():
    """The port's builder writes the fixture's bytes; the port's
    CNTKModel scores rows 0-7 on the CPU within 2e-5 of JAX's."""
    io = np.load(tagger.OUT)
    blob = tagger.build(pcf)
    assert hashlib.sha256(blob).hexdigest() == str(io["sha256"])
    m = CNTKModel(model_bytes=blob, mini_batch_size=8)
    m.set(feed_dict={m.graph.input_names[0]: "query"})
    out = m.graph.output_names[0]
    got = _column(m, Table({"query": tagger.one_hot(io["tokens"])}), out)
    assert got.shape == (8, tagger.SEQ_LEN, tagger.LABELS)
    np.testing.assert_allclose(got, io["expected"], rtol=2e-5, atol=2e-5)

"""Bundled ONNX model constructors (ResNet family).

The reference ships a ModelDownloader that fetches pretrained CNTK graphs from
a remote repo (ref: deep-learning/src/main/scala/com/microsoft/ml/spark/cntk/downloader/ModelDownloader.scala:197-265).
This environment has no network egress, so the zoo *constructs* the standard
torchvision-layout ResNet graphs as real ``.onnx`` protobuf bytes with seeded
He-initialized weights — the import / execution path exercised is byte-for-byte
the same one a user's downloaded ResNet-50 file takes: protobuf parse ->
node-by-node lowering -> torch ops. Weight dicts can also be supplied to build an
ONNX file from externally-trained parameters (the export story).
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np

from synapseml_tpu_torch.onnx.builder import GraphBuilder


class _Rng:
    def __init__(self, seed: int):
        self.rng = np.random.default_rng(seed)

    def conv_w(self, out_c, in_c, kh, kw):
        fan_in = in_c * kh * kw
        std = np.sqrt(2.0 / fan_in)
        return self.rng.normal(0, std, (out_c, in_c, kh, kw)).astype(np.float32)

    def fc(self, out_f, in_f):
        std = np.sqrt(1.0 / in_f)
        w = self.rng.uniform(-std, std, (out_f, in_f)).astype(np.float32)
        b = self.rng.uniform(-std, std, (out_f,)).astype(np.float32)
        return w, b

    def bn(self, c):
        # running stats of a trained net are not identity; randomize mildly so
        # numerical-equivalence tests exercise the real BN math
        return (np.abs(self.rng.normal(1, 0.1, c)).astype(np.float32),
                self.rng.normal(0, 0.1, c).astype(np.float32),
                self.rng.normal(0, 0.5, c).astype(np.float32),
                np.abs(self.rng.normal(1, 0.2, c)).astype(np.float32) + 0.1)


def _bn_relu(g: GraphBuilder, r: _Rng, x: str, c: int, relu: bool = True) -> str:
    s, b, m, v = r.bn(c)
    y = g.batch_norm(x, s, b, m, v)
    return g.relu(y) if relu else y


def _basic_block(g, r, x, in_c, out_c, stride):
    y = g.conv(x, r.conv_w(out_c, in_c, 3, 3), strides=(stride, stride),
               pads=(1, 1, 1, 1))
    y = _bn_relu(g, r, y, out_c)
    y = g.conv(y, r.conv_w(out_c, out_c, 3, 3), pads=(1, 1, 1, 1))
    y = _bn_relu(g, r, y, out_c, relu=False)
    if stride != 1 or in_c != out_c:
        sc = g.conv(x, r.conv_w(out_c, in_c, 1, 1), strides=(stride, stride))
        sc = _bn_relu(g, r, sc, out_c, relu=False)
    else:
        sc = x
    return g.relu(g.add_node("Add", [y, sc]))


def _bottleneck(g, r, x, in_c, mid_c, stride):
    out_c = mid_c * 4
    y = g.conv(x, r.conv_w(mid_c, in_c, 1, 1))
    y = _bn_relu(g, r, y, mid_c)
    y = g.conv(y, r.conv_w(mid_c, mid_c, 3, 3), strides=(stride, stride),
               pads=(1, 1, 1, 1))
    y = _bn_relu(g, r, y, mid_c)
    y = g.conv(y, r.conv_w(out_c, mid_c, 1, 1))
    y = _bn_relu(g, r, y, out_c, relu=False)
    if stride != 1 or in_c != out_c:
        sc = g.conv(x, r.conv_w(out_c, in_c, 1, 1), strides=(stride, stride))
        sc = _bn_relu(g, r, sc, out_c, relu=False)
    else:
        sc = x
    return g.relu(g.add_node("Add", [y, sc]))


def build_resnet(depths: Sequence[int], bottleneck: bool, num_classes: int = 1000,
                 width: int = 64, image_size: int = 224, seed: int = 0,
                 batch_dim="N") -> bytes:
    """Emit a torchvision-layout ResNet as ONNX bytes."""
    g = GraphBuilder(name=f"resnet{'_bn' if bottleneck else ''}", opset=17)
    r = _Rng(seed)
    x = g.add_input("data", np.float32, [batch_dim, 3, image_size, image_size])
    y = g.conv(x, r.conv_w(width, 3, 7, 7), strides=(2, 2), pads=(3, 3, 3, 3))
    y = _bn_relu(g, r, y, width)
    y = g.add_node("MaxPool", [y], kernel_shape=[3, 3], strides=[2, 2],
                   pads=[1, 1, 1, 1])
    in_c = width
    chan = width
    for stage, n_blocks in enumerate(depths):
        for blk in range(n_blocks):
            stride = 2 if (stage > 0 and blk == 0) else 1
            if bottleneck:
                y = _bottleneck(g, r, y, in_c, chan, stride)
                in_c = chan * 4
            else:
                y = _basic_block(g, r, y, in_c, chan, stride)
                in_c = chan
        chan *= 2
    y = g.add_node("GlobalAveragePool", [y])
    y = g.add_node("Flatten", [y], axis=1)
    w, b = r.fc(num_classes, in_c)
    y = g.gemm(y, w, b)
    g.add_output(y, np.float32, [batch_dim, num_classes])
    return g.to_bytes()


def resnet50(num_classes: int = 1000, image_size: int = 224, seed: int = 0) -> bytes:
    return build_resnet([3, 4, 6, 3], bottleneck=True, num_classes=num_classes,
                        image_size=image_size, seed=seed)


def resnet18(num_classes: int = 1000, image_size: int = 224, seed: int = 0) -> bytes:
    return build_resnet([2, 2, 2, 2], bottleneck=False, num_classes=num_classes,
                        image_size=image_size, seed=seed)


def tiny_resnet(num_classes: int = 10, image_size: int = 32, seed: int = 0) -> bytes:
    """Small ResNet for tests: same op inventory as resnet50, tiny shapes."""
    return build_resnet([1, 1], bottleneck=True, num_classes=num_classes,
                        width=8, image_size=image_size, seed=seed)


def mlp(layer_sizes: Sequence[int], num_classes: int, seed: int = 0,
        activation: str = "Relu") -> bytes:
    """Plain MLP with a trailing Softmax — the classical-ML ONNX shape."""
    g = GraphBuilder(name="mlp", opset=17)
    r = _Rng(seed)
    x = g.add_input("input", np.float32, ["N", layer_sizes[0]])
    y = x
    dims = list(layer_sizes[1:]) + [num_classes]
    prev = layer_sizes[0]
    for i, d in enumerate(dims):
        w, b = r.fc(d, prev)
        y = g.gemm(y, w, b)
        if i < len(dims) - 1:
            y = g.add_node(activation, [y])
        prev = d
    probs = g.add_node("Softmax", [y], axis=-1)
    g.add_output(probs, np.float32, ["N", num_classes])
    return g.to_bytes()


def bilstm_tagger(vocab: int, embed: int, hidden: int, n_tags: int,
                  seq_len: int = 64, seed: int = 0) -> bytes:
    """Bidirectional-LSTM token tagger (the reference's BiLSTM medical-entity
    config, BASELINE config #5) as an ONNX graph: Gather(embedding) -> LSTM
    (bidirectional) -> Gemm per token."""
    g = GraphBuilder(name="bilstm_tagger", opset=17)
    r = _Rng(seed)
    ids = g.add_input("tokens", np.int64, ["N", seq_len])
    emb = g.add_initializer(
        "embedding", r.rng.normal(0, 0.1, (vocab, embed)).astype(np.float32))
    x = g.add_node("Gather", [emb, ids], axis=0)          # (N, S, E)
    x = g.add_node("Transpose", [x], perm=[1, 0, 2])      # (S, N, E)
    w = g.add_initializer("lstm_w", np.stack([
        r.rng.normal(0, 0.1, (4 * hidden, embed)).astype(np.float32)
        for _ in range(2)]))
    rr = g.add_initializer("lstm_r", np.stack([
        r.rng.normal(0, 0.1, (4 * hidden, hidden)).astype(np.float32)
        for _ in range(2)]))
    b = g.add_initializer(
        "lstm_b", np.zeros((2, 8 * hidden), dtype=np.float32))
    y = g.add_node("LSTM", [x, w, rr, b], outputs=["lstm_y", "lstm_h", "lstm_c"],
                   hidden_size=hidden, direction="bidirectional")
    y = y[0] if isinstance(y, list) else y
    y = g.add_node("Transpose", [y], perm=[2, 0, 1, 3])   # (N, S, dirs, H)
    shp = g.add_initializer("flat_shape", np.array([0, seq_len, 2 * hidden],
                                                   dtype=np.int64))
    y = g.add_node("Reshape", [y, shp])
    wf, bf = r.fc(n_tags, 2 * hidden)
    wn = g.add_initializer("head_w", np.ascontiguousarray(wf.T))
    bn = g.add_initializer("head_b", bf)
    y = g.add_node("MatMul", [y, wn])
    y = g.add_node("Add", [y, bn])
    g.add_output(y, np.float32, ["N", seq_len, n_tags])
    return g.to_bytes()


def transformer_encoder(vocab: int, d_model: int, n_heads: int,
                        ffn_dim: int, n_layers: int, seq_len: int = 32,
                        causal: bool = False, seed: int = 0) -> bytes:
    """Pre-LN transformer encoder as an ONNX graph (the BERT-era op diet:
    Gather embeddings, MatMul/Transpose/Softmax attention,
    LayerNormalization, Gelu FFN, Trilu causal mask when requested) —
    exercises the importer on modern-architecture graphs the way resnet50
    exercises the CNN opset."""
    assert d_model % n_heads == 0
    hd = d_model // n_heads
    # opset 20: Gelu joined the default ai.onnx domain at 20 (Trilu needs
    # >=14, LayerNormalization >=17) — a lower opset would be spec-invalid
    g = GraphBuilder(name="transformer_encoder", opset=20)
    r = _Rng(seed)

    ids = g.add_input("tokens", np.int64, ["N", seq_len])
    emb = g.add_initializer(
        "tok_emb", r.rng.normal(0, 0.05, (vocab, d_model)).astype(np.float32))
    pos = g.add_initializer(
        "pos_emb", r.rng.normal(0, 0.05, (seq_len, d_model)).astype(np.float32))
    x = g.add_node("Gather", [emb, ids], axis=0)          # (N, S, D)
    x = g.add_node("Add", [x, pos])

    if causal:
        ones = g.add_initializer(
            "mask_ones", np.ones((seq_len, seq_len), np.float32))
        upper = g.add_node("Trilu", [ones], upper=1)
        diag = g.add_node("Trilu", [upper], upper=0)      # identity diag
        strict_upper = g.add_node("Sub", [upper, diag])
        neg = g.add_initializer("neg_inf", np.float32(-1e9))
        causal_bias = g.add_node("Mul", [strict_upper, neg])  # (S, S)

    def lin(x, out_f, in_f, name):
        w, b = r.fc(out_f, in_f)
        wn = g.add_initializer(f"{name}_w", np.ascontiguousarray(w.T))
        bn = g.add_initializer(f"{name}_b", b)
        y = g.add_node("MatMul", [x, wn])
        return g.add_node("Add", [y, bn])

    def layer_norm(x, name):
        s = g.add_initializer(f"{name}_s", np.ones(d_model, np.float32))
        b = g.add_initializer(f"{name}_b", np.zeros(d_model, np.float32))
        return g.add_node("LayerNormalization", [x, s, b], axis=-1)

    heads_shape = g.add_initializer(
        "heads_shape", np.array([0, seq_len, n_heads, hd], np.int64))
    merge_shape = g.add_initializer(
        "merge_shape", np.array([0, seq_len, d_model], np.int64))
    scale = g.add_initializer("attn_scale",
                              np.float32(1.0 / np.sqrt(hd)))

    for li in range(n_layers):
        ln1 = layer_norm(x, f"l{li}_ln1")
        q = lin(ln1, d_model, d_model, f"l{li}_q")
        k = lin(ln1, d_model, d_model, f"l{li}_k")
        v = lin(ln1, d_model, d_model, f"l{li}_v")

        def split_heads(t):
            t = g.add_node("Reshape", [t, heads_shape])   # (N, S, H, hd)
            return g.add_node("Transpose", [t], perm=[0, 2, 1, 3])

        qh, kh, vh = split_heads(q), split_heads(k), split_heads(v)
        kt = g.add_node("Transpose", [kh], perm=[0, 1, 3, 2])
        logits = g.add_node("MatMul", [qh, kt])           # (N, H, S, S)
        logits = g.add_node("Mul", [logits, scale])
        if causal:
            logits = g.add_node("Add", [logits, causal_bias])
        attn = g.add_node("Softmax", [logits], axis=-1)
        ctxv = g.add_node("MatMul", [attn, vh])           # (N, H, S, hd)
        ctxv = g.add_node("Transpose", [ctxv], perm=[0, 2, 1, 3])
        ctxv = g.add_node("Reshape", [ctxv, merge_shape])
        proj = lin(ctxv, d_model, d_model, f"l{li}_o")
        x = g.add_node("Add", [x, proj])

        ln2 = layer_norm(x, f"l{li}_ln2")
        h = lin(ln2, ffn_dim, d_model, f"l{li}_ff1")
        h = g.add_node("Gelu", [h])
        h = lin(h, d_model, ffn_dim, f"l{li}_ff2")
        x = g.add_node("Add", [x, h])

    x = layer_norm(x, "final_ln")
    g.add_output(x, np.float32, ["N", seq_len, d_model])
    return g.to_bytes()


def tiny_decoder(vocab: int = 64, d_model: int = 32, n_heads: int = 4,
                 kv_heads: int = 2, n_layers: int = 2,
                 max_seq: int = 128, seed: int = 0) -> bytes:
    """Decoder-only LM in the ORT-GenAI serving-cache layout: packed-QKV
    GroupQueryAttention with ``past_present_share_buffer=1`` and internal
    rotary, pre-LN FFN blocks, LM head. Every attention input/output is
    symbolic in B/S/T, so ONE file serves every (batch, chunk, buffer)
    geometry the decode scheduler compiles — prefill feeds S=chunk
    against a zeroed buffer, decode feeds S=1 against the live buffer,
    and ``seqlens_k`` (ORT convention: total valid keys - 1) carries each
    row's write position. ``max_seq`` caps the rope cache, so every KV
    buffer bucket must satisfy T <= max_seq."""
    assert d_model % n_heads == 0 and n_heads % kv_heads == 0
    hd = d_model // n_heads
    g = GraphBuilder(name="tiny_decoder", opset=21)
    r = _Rng(seed)

    ids = g.add_input("input_ids", np.int64, ["B", "S"])
    seqlens = g.add_input("seqlens_k", np.int32, ["B"])
    emb = g.add_initializer(
        "tok_emb", r.rng.normal(0, 0.05, (vocab, d_model)).astype(
            np.float32))
    x = g.add_node("Gather", [emb, ids], axis=0)          # (B, S, D)

    inv = 10000.0 ** (np.arange(hd // 2) / (hd // 2))
    ang = np.arange(max_seq)[:, None] / inv
    cos = g.add_initializer("rope_cos", np.cos(ang).astype(np.float32))
    sin = g.add_initializer("rope_sin", np.sin(ang).astype(np.float32))

    def lin(x, out_f, in_f, name):
        w, b = r.fc(out_f, in_f)
        wn = g.add_initializer(f"{name}_w", np.ascontiguousarray(w.T))
        bn = g.add_initializer(f"{name}_b", b)
        y = g.add_node("MatMul", [x, wn])
        return g.add_node("Add", [y, bn])

    def layer_norm(x, name):
        s = g.add_initializer(f"{name}_s", np.ones(d_model, np.float32))
        b = g.add_initializer(f"{name}_b", np.zeros(d_model, np.float32))
        return g.add_node("LayerNormalization", [x, s, b], axis=-1)

    presents: List[str] = []
    for li in range(n_layers):
        ln1 = layer_norm(x, f"l{li}_ln1")
        qkv = lin(ln1, (n_heads + 2 * kv_heads) * hd, d_model,
                  f"l{li}_qkv")
        pk = g.add_input(f"past_key_{li}", np.float32,
                         ["B", kv_heads, "T", hd])
        pv = g.add_input(f"past_value_{li}", np.float32,
                         ["B", kv_heads, "T", hd])
        att, prk, prv = g.add_node(
            "GroupQueryAttention",
            [qkv, "", "", pk, pv, seqlens, "", cos, sin],
            outputs=[f"att_{li}", f"present_key_{li}",
                     f"present_value_{li}"],
            domain="com.microsoft", num_heads=n_heads,
            kv_num_heads=kv_heads, do_rotary=1,
            past_present_share_buffer=1)
        presents += [prk, prv]
        proj = lin(att, d_model, n_heads * hd, f"l{li}_o")
        x = g.add_node("Add", [x, proj])

        ln2 = layer_norm(x, f"l{li}_ln2")
        h = lin(ln2, 2 * d_model, d_model, f"l{li}_ff1")
        h = g.add_node("Gelu", [h])
        h = lin(h, d_model, 2 * d_model, f"l{li}_ff2")
        x = g.add_node("Add", [x, h])

    x = layer_norm(x, "final_ln")
    logits = lin(x, vocab, d_model, "lm_head")
    g.add_output(logits, np.float32, ["B", "S", vocab])
    for p in presents:
        g.add_output(p, np.float32, None)
    return g.to_bytes()

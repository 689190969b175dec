"""The port's com.microsoft transformer ops against the JAX package's
importer, on the CPU: ``MatMulNBits`` and ``RotaryEmbedding``,
``GroupQueryAttention`` (separate and packed QKV, ``seqlens_k``, the
concatenated KV cache, internal rotary, the shared max-length buffer),
the int4 decoder block they make together, the standard opset-23
``Attention``, ``MultiHeadAttention``, com.microsoft ``Attention``, and the
fusion family (``FusedMatMul``, ``BiasGelu``, ``FastGelu``, ``QuickGelu``,
``SimplifiedLayerNormalization``/``RMSNormalization``,
``SkipSimplifiedLayerNormalization``, ``SkipLayerNormalization``,
``EmbedLayerNormalization``). The cases mirror the reference's own
(``tests/test_onnx.py``: ``test_matmul_nbits_and_rotary_embedding``,
``test_group_query_attention``,
``test_quantized_llm_decoder_block_end_to_end``,
``test_contrib_attention_masks_causal_and_past``,
``test_fusion_family_matches_unfused_and_torch``,
``test_embed_layer_normalization_bert_frontend``,
``test_fused_encoder_layer_equals_unfused_composition``,
``test_standard_attention_opset23_matches_torch_sdpa``,
``test_multi_head_attention_matches_torch``), with the JAX package as the
oracle.

Tolerance: float32 outputs within rtol=atol=1e-5 of the reference's
(2e-5 where a product over the int4 decoder block's 32 features sums in
another order); integer outputs equal; bf16 outputs within
rtol=atol=2e-2; output dtypes equal.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from synapseml_tpu.onnx import import_model as jax_import_model
from synapseml_tpu_torch.onnx import GraphBuilder, import_model
from torch_onnx_parity import (assert_parity, dtype_name, one_node,
                               run_both, to_torch)

F32, I32, I64 = np.float32, np.int32, np.int64
MS = "com.microsoft"


def _n(seed, *shape, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape)
            * scale).astype(F32)


def _check(blob, feeds, **tol):
    port, ref = run_both(blob, feeds)
    assert_parity(port, ref, **tol)
    return port, ref


# -- MatMulNBits and RotaryEmbedding ---------------------------------------

def _int4(seed, n, k, block):
    rng = np.random.default_rng(seed)
    q = rng.integers(0, 16, (n, k)).astype(np.uint8)
    nb = k // block
    scales = (rng.random((n, nb)) * 0.2 + 0.05).astype(F32)
    packed = (q[:, 0::2] | (q[:, 1::2] << 4)).reshape(n, nb, block // 2)
    zp = rng.integers(0, 16, (n, nb)).astype(np.uint8)
    zp_packed = (zp[:, 0::2] | ((zp[:, 1::2] << 4) if nb > 1 else 0)).astype(
        np.uint8)
    return q, packed, scales, zp, zp_packed.reshape(-1)


@pytest.mark.parametrize("zero_points", ["default", "packed", "float"])
@pytest.mark.parametrize("k,block", [(32, 16), (64, 32), (48, 16)])
def test_matmul_nbits_matches_jax(zero_points, k, block):
    n = 6
    q, packed, scales, zp, zp_packed = _int4(3, n, k, block)
    a = _n(4, 2, 3, k)
    inits = {"b": packed, "sc": scales.reshape(-1)}
    if zero_points == "packed":
        inits["zp"] = zp_packed
    elif zero_points == "float":
        inits["zp"] = zp.astype(F32).reshape(-1)
    blob = one_node("MatMulNBits", {"a": a}, inits=inits, domain=MS, K=k,
                    N=n, bits=4, block_size=block)
    g = import_model(blob)
    # the packed weights (and packed zero points) are params, not static
    assert "b" in g.params and "b" not in g.static_params
    port, _ = _check(blob, [a])
    zpv = 8.0 if zero_points == "default" else zp.astype(F32).repeat(
        block, 1)
    w = ((q.astype(F32) - zpv).reshape(n, k // block, block)
         * scales[..., None]).reshape(n, k)
    np.testing.assert_allclose(port[0].numpy(), a @ w.T, rtol=2e-5,
                               atol=2e-5)


def test_matmul_nbits_bf16_bind_keeps_the_packed_weights_integers():
    n, k, block = 8, 32, 16
    _, packed, scales, _, zp_packed = _int4(5, n, k, block)
    blob = one_node("MatMulNBits", {"a": _n(6, 3, k)}, inits={
        "b": packed, "sc": scales.reshape(-1), "zp": zp_packed},
        domain=MS, K=k, N=n, bits=4, block_size=block)
    fn = import_model(blob)
    bound = fn.bind(cast_dtype=torch.bfloat16, device="cpu")
    a = _n(6, 3, k).astype(jnp.bfloat16)
    port, ref = run_both(blob, [a], cast="bfloat16")
    assert dtype_name(port[0]) == "bfloat16"
    assert_parity(port, ref, rtol=2e-2, atol=2e-2)
    assert fn.params["b"].dtype == np.uint8
    assert bound(to_torch(a))[0].dtype == torch.bfloat16


_COS = np.cos(_n(7, 16, 4)).astype(F32)
_SIN = np.sin(_n(8, 16, 4)).astype(F32)
_POS = np.random.default_rng(9).integers(0, 16, (2, 5)).astype(I64)


@pytest.mark.parametrize("case", [
    ("4d_half_split", dict(), _n(10, 2, 3, 5, 8), _POS),
    ("4d_interleaved", dict(interleaved=1), _n(10, 2, 3, 5, 8), _POS),
    ("start_offset", dict(), _n(11, 2, 3, 5, 8), np.asarray([4], I64)),
    ("3d_num_heads", dict(num_heads=3), _n(12, 2, 5, 24), _POS),
    ("partial_rotary_dim", dict(rotary_embedding_dim=4),
     _n(13, 2, 3, 5, 8), _POS),
    ("one_position_row", dict(), _n(14, 2, 3, 5, 8), _POS[0]),
], ids=lambda c: c[0])
def test_rotary_embedding_matches_jax(case):
    _, attrs, x, pos = case
    cos, sin = _COS, _SIN
    if attrs.get("rotary_embedding_dim"):
        cos, sin = _COS[:, :2].copy(), _SIN[:, :2].copy()
    blob = one_node("RotaryEmbedding", {"x": x}, inits={
        "pos": pos, "cos": cos, "sin": sin}, domain=MS, **attrs)
    _check(blob, [x])


# -- GroupQueryAttention ---------------------------------------------------

B, S, HQ, HKV, D = 2, 6, 4, 2, 8


def _gqa(packed=False, past_t=None, seqlens=None, rotary=False, n_out=1,
         share=False, b=B, s=S):
    """A GroupQueryAttention graph and its feed names: q (or packed qkv),
    k, v; ``past_t`` adds past_key/past_value inputs of that length;
    ``seqlens`` (``"input"`` or an array initializer) adds seqlens_k."""
    g = GraphBuilder(opset=21)
    if packed:
        ins = [g.add_input("q", F32, [b, s, (HQ + 2 * HKV) * D]), "", ""]
    else:
        ins = [g.add_input("q", F32, [b, s, HQ * D]),
               g.add_input("k", F32, [b, s, HKV * D]),
               g.add_input("v", F32, [b, s, HKV * D])]
    if past_t is not None:
        ins += [g.add_input("pk", F32, [b, HKV, past_t, D]),
                g.add_input("pv", F32, [b, HKV, past_t, D])]
    else:
        ins += ["", ""]
    if isinstance(seqlens, str):
        ins.append(g.add_input("sl", I32, [b]))
    elif seqlens is not None:
        ins.append(g.add_initializer("sl", seqlens))
    elif rotary:
        ins.append("")
    if rotary:
        ins += ["", g.add_initializer("cos", np.cos(_n(20, 32, D // 2))),
                g.add_initializer("sin", np.sin(_n(21, 32, D // 2)))]
    outs = ["y", "prk", "prv"][:n_out]
    g.add_node("GroupQueryAttention", ins, outputs=outs, domain=MS,
               num_heads=HQ, kv_num_heads=HKV, do_rotary=int(rotary),
               past_present_share_buffer=int(share))
    for o in outs:
        g.add_output(o, F32, None)
    return g.to_bytes()


def _qkv(seed, b=B, s=S):
    return (_n(seed, b, s, HQ * D), _n(seed + 1, b, s, HKV * D),
            _n(seed + 2, b, s, HKV * D))


GQA_CASES = [
    ("prefill", dict(), False),
    ("prefill_rotary", dict(rotary=True), False),
    ("packed_qkv", dict(packed=True), True),
    ("seqlens_bound_keys", dict(seqlens=np.asarray([3, 5], I32)), False),
    ("past_cache_three_outputs", dict(past_t=4, n_out=3), False),
    ("past_cache_rotary", dict(past_t=4, n_out=3, rotary=True), False),
    ("packed_rotary_seqlens", dict(packed=True, rotary=True,
                                   seqlens=np.asarray([5, 2], I32)), True),
]


@pytest.mark.parametrize("case", GQA_CASES, ids=[c[0] for c in GQA_CASES])
def test_group_query_attention_matches_jax(case):
    _, kw, packed = case
    q, k, v = _qkv(30)
    feeds = [np.concatenate([q, k, v], -1)] if packed else [q, k, v]
    if kw.get("past_t"):
        feeds += [_n(33, B, HKV, kw["past_t"], D),
                  _n(34, B, HKV, kw["past_t"], D)]
    _check(_gqa(**kw), feeds)


def test_group_query_attention_two_step_decode_equals_full_attention():
    """The reference's cache contract: a prefill's presents, then two
    tokens through the cache, equal the full sequence's last outputs."""
    q, k, v = _qkv(40, s=S + 2)
    full = import_model(_gqa(s=S + 2)).bind(device="cpu")(
        *map(torch.from_numpy, (q, k, v)))[0]
    _, pk, pv = import_model(_gqa(n_out=3)).bind(device="cpu")(
        *[torch.from_numpy(a[:, :S].copy()) for a in (q, k, v)])
    step = import_model(_gqa(past_t=S, n_out=3, s=2)).bind(device="cpu")
    out, pk2, _ = step(*[torch.from_numpy(a[:, S:].copy())
                         for a in (q, k, v)], pk, pv)
    np.testing.assert_allclose(out.numpy(), full[:, S:].numpy(),
                               rtol=1e-5, atol=1e-5)
    assert tuple(pk2.shape) == (B, HKV, S + 2, D)


# -- the shared max-length buffer -------------------------------------------

T_BUF = 8
# one row each: a decode prefix, an idle row (seqlens_k = 0), a
# right-padded prefill row (2 valid tokens of 3), a row whose write ends
# at the buffer's end, and one past it (its write start clamped to T - S,
# its rotary and causal frontier not)
SHARE_ROWS = np.asarray([4, 0, 1, 7, 9], I32)


@pytest.mark.parametrize("s", [3, 1])
@pytest.mark.parametrize("packed", [False, True])
def test_shared_buffer_rows_match_jax_and_leave_the_inputs(s, packed):
    b = len(SHARE_ROWS)
    blob = _gqa(packed=packed, past_t=T_BUF, seqlens="input", rotary=True,
                n_out=3, share=True, b=b, s=s)
    q, k, v = _qkv(50, b=b, s=s)
    feeds = ([np.concatenate([q, k, v], -1)] if packed else [q, k, v]) + [
        _n(53, b, HKV, T_BUF, D), _n(54, b, HKV, T_BUF, D), SHARE_ROWS]
    port, ref = _check(blob, feeds)
    # the write positions: max(seqlens_k + 1 - S, 0), clamped to T - S
    start = np.minimum(np.maximum(SHARE_ROWS + 1 - s, 0), T_BUF - s)
    pk = port[1].numpy()
    for row, st in enumerate(start):
        kept = np.ones(T_BUF, bool)
        kept[st:st + s] = False
        np.testing.assert_array_equal(pk[row][:, kept],
                                      feeds[-3][row][:, kept])
    # the caller's buffers are not written: present_* are new tensors
    tensors = [to_torch(f) for f in feeds]
    before = [t.clone() for t in tensors]
    out = import_model(blob).bind(device="cpu")(*tensors)
    for t, was in zip(tensors, before):
        assert torch.equal(t, was)
    assert out[1].data_ptr() != tensors[-3].data_ptr()


def test_shared_buffer_decode_steps_equal_one_prefill():
    """Through the shared buffer, a 4-token prefill then one token a step
    gives the logits of one 6-token prefill of the same tokens, in every
    row; per-row offsets (one row two tokens behind) included."""
    b = 2
    q, k, v = _qkv(60, b=b, s=6)
    zeros = np.zeros((b, HKV, T_BUF, D), F32)
    chunk = import_model(_gqa(past_t=T_BUF, seqlens="input", rotary=True,
                              n_out=3, share=True, b=b, s=6)).bind(
        device="cpu")
    whole = chunk(*map(torch.from_numpy, (q, k, v, zeros, zeros)),
                  torch.tensor([5, 5], dtype=torch.int32))[0]
    pre = import_model(_gqa(past_t=T_BUF, seqlens="input", rotary=True,
                            n_out=3, share=True, b=b, s=4)).bind(
        device="cpu")
    _, pk, pv = pre(*[torch.from_numpy(a[:, :4].copy()) for a in (q, k, v)],
                    torch.from_numpy(zeros), torch.from_numpy(zeros),
                    torch.tensor([3, 3], dtype=torch.int32))
    step = import_model(_gqa(past_t=T_BUF, seqlens="input", rotary=True,
                             n_out=3, share=True, b=b, s=1)).bind(
        device="cpu")
    for i in (4, 5):
        out, pk, pv = step(*[torch.from_numpy(a[:, i:i + 1].copy())
                             for a in (q, k, v)], pk, pv,
                           torch.tensor([i, i], dtype=torch.int32))
        np.testing.assert_allclose(out.numpy(), whole[:, i:i + 1].numpy(),
                                   rtol=1e-5, atol=1e-5)


def test_rope_cache_shorter_than_the_buffer_raises_in_both():
    blob = _gqa(past_t=40, seqlens="input", rotary=True, n_out=3,
                share=True, s=1)                # 32 rope rows < T = 40
    q, k, v = _qkv(70, s=1)
    feeds = [q, k, v, _n(71, B, HKV, 40, D), _n(72, B, HKV, 40, D),
             np.asarray([3, 4], I32)]
    with pytest.raises(ValueError, match="rope cache"):
        import_model(blob).bind(device="cpu")(*map(to_torch, feeds))
    with pytest.raises(ValueError, match="rope cache"):
        jax_import_model(blob).bind()(*feeds)


# -- the int4 decoder block ------------------------------------------------

def test_quantized_decoder_block_matches_jax():
    """MatMulNBits projections -> GroupQueryAttention (internal rotary,
    KV cache outputs) -> MatMulNBits out-projection + residual."""
    b, s, hidden = 2, 4, HQ * D
    g = GraphBuilder(opset=21)
    xn = g.add_input("x", F32, [b, s, hidden])

    def proj(name, n_out, seed, src=xn):
        _, packed, scales, _, _ = _int4(seed, n_out, hidden, 16)
        return g.add_node(
            "MatMulNBits", [src, g.add_initializer(f"{name}_w", packed),
                            g.add_initializer(f"{name}_s",
                                              scales.reshape(-1))],
            domain=MS, K=hidden, N=n_out, bits=4, block_size=16)

    qp, kp, vp = proj("q", HQ * D, 1), proj("k", HKV * D, 2), \
        proj("v", HKV * D, 3)
    att = g.add_node(
        "GroupQueryAttention",
        [qp, kp, vp, "", "", "", "",
         g.add_initializer("cos", np.cos(_n(4, 32, D // 2))),
         g.add_initializer("sin", np.sin(_n(5, 32, D // 2)))],
        outputs=["att", "prk", "prv"], domain=MS, num_heads=HQ,
        kv_num_heads=HKV, do_rotary=1)
    y = g.add_node("Add", [xn, proj("o", hidden, 6, src=att[0])])
    g.add_output(y, F32, [b, s, hidden])
    g.add_output("prk", F32, None)
    g.add_output("prv", F32, None)
    blob = g.to_bytes()
    assert {"q_w", "k_w", "v_w", "o_w"} <= set(import_model(blob).params)
    x = _n(7, b, s, hidden)
    port, _ = _check(blob, [x], rtol=2e-5, atol=2e-5)
    # causal: the last token's input moves only the last position
    x2 = x.copy()
    x2[:, -1] += 1.0
    port2, _ = run_both(blob, [x2])
    np.testing.assert_allclose(port[0].numpy()[:, :-1],
                               port2[0].numpy()[:, :-1], atol=1e-6)


# -- standard Attention (opset 23), MultiHeadAttention, Attention ----------

def _attention23(q, k, v, mask=None, mask_init=False, **attrs):
    feeds = {"q": q, "k": k, "v": v}
    inits = {}
    if mask is not None:
        (inits if mask_init else feeds)["m"] = mask
    return one_node("Attention", feeds, inits=inits, opset=23,
                    **attrs), list(feeds.values())


_Q4, _K4, _V4 = _n(80, 2, 4, 5, 8), _n(81, 2, 2, 5, 8), _n(82, 2, 2, 5, 8)
_Q3, _K3, _V3 = _n(83, 2, 5, 32), _n(84, 2, 5, 16), _n(85, 2, 5, 16)
STANDARD = [
    ("gqa_causal_4d", lambda: _attention23(_Q4, _K4, _V4, is_causal=1)),
    ("causal_cross_length", lambda: _attention23(
        _Q4[:, :, :3].copy(), _K4, _V4, is_causal=1)),
    ("3d_bool_mask", lambda: _attention23(
        _Q3, _K3, _V3, np.random.default_rng(86).random((2, 1, 5, 5)) > 0.3,
        q_num_heads=4, kv_num_heads=2)),
    ("scale_softcap_additive_mask", lambda: _attention23(
        _Q4, _K4, _V4, _n(87, 5, 5, scale=2.0), mask_init=True, scale=0.25,
        softcap=5.0)),
    ("value_head_size_differs", lambda: _attention23(
        _Q4, _K4, _n(88, 2, 2, 5, 4))),
    ("per_head_bool_mask_fully_masked_row", lambda: _attention23(
        _Q4, _K4, _V4, np.tile(np.arange(5)[None, :] < np.array(
            [0, 1, 2, 3, 4])[:, None], (2, 4, 1, 1)))),
]


@pytest.mark.parametrize("case", STANDARD, ids=[c[0] for c in STANDARD])
def test_standard_attention_opset23_matches_jax(case):
    blob, feeds = case[1]()
    _check(blob, feeds)


def test_rms_normalization_opset23_matches_jax():
    x = _n(89, 2, 5, 32)
    blob = one_node("RMSNormalization", {"x": x},
                    inits={"sc": _n(90, 32)}, opset=23, epsilon=1e-6)
    _check(blob, [x])


_MQ, _MK, _MV = _n(91, 2, 4, 24), _n(92, 2, 6, 24), _n(93, 2, 6, 24)


def _mha(nodes_in, feeds, inits=None, n_out=1, **attrs):
    return one_node("MultiHeadAttention", feeds, inits=inits,
                    node_inputs=nodes_in, n_out=n_out, domain=MS,
                    num_heads=3, **attrs), list(feeds.values())


MHA = [
    ("cross_bias_lengths", lambda: _mha(
        ["q", "k", "v", "b", "m"],
        {"q": _MQ, "k": _MK, "v": _MV, "m": np.asarray([6, 3], I32)},
        inits={"b": _n(94, 72)})),
    ("key_mask_2d_attention_bias", lambda: _mha(
        ["q", "k", "v", "", "m", "ab"],
        {"q": _MQ, "k": _MK, "v": _MV,
         "m": (np.arange(6)[None] < np.array([[4], [6]])).astype(I32),
         "ab": _n(95, 1, 3, 4, 6)})),
    ("causal_decode_cache", lambda: _mha(
        ["q", "q", "q", "", "", "", "pk", "pv"],
        {"q": _n(96, 2, 1, 24), "pk": _n(97, 2, 3, 5, 8),
         "pv": _n(98, 2, 3, 5, 8)}, n_out=3, unidirectional=1)),
]


@pytest.mark.parametrize("case", MHA, ids=[c[0] for c in MHA])
def test_multi_head_attention_matches_jax(case):
    blob, feeds = case[1]()
    _check(blob, feeds)


_AX, _AW, _AB = _n(100, 2, 5, 24), _n(101, 24, 72, scale=0.3), _n(102, 72)


def _contrib(nodes_in, feeds, n_out=1, **attrs):
    return one_node("Attention", feeds, inits={"w": _AW, "b": _AB},
                    node_inputs=nodes_in, n_out=n_out, domain=MS,
                    num_heads=3, **attrs), list(feeds.values())


CONTRIB = [
    ("length_mask", lambda: _contrib(
        ["x", "w", "b", "m"], {"x": _AX, "m": np.asarray([5, 3], I32)})),
    ("causal_past_present", lambda: _contrib(
        ["x", "w", "b", "", "p"], {"x": _AX, "p": _n(103, 2, 2, 3, 3, 8)},
        n_out=2, unidirectional=1)),
    ("key_mask_2d", lambda: _contrib(
        ["x", "w", "b", "m"], {"x": _AX, "m": (np.arange(5)[None] < np.array(
            [[5], [3]])).astype(I32)})),
    ("key_mask_3d_filter_value", lambda: _contrib(
        ["x", "w", "b", "m"], {"x": _AX, "m": np.tril(np.ones(
            (2, 5, 5), I32))}, mask_filter_value=-50.0)),
    ("attention_bias", lambda: _contrib(
        ["x", "w", "b", "", "", "ab"], {"x": _AX, "ab": _n(104, 2, 3, 5, 5)})),
]


@pytest.mark.parametrize("case", CONTRIB, ids=[c[0] for c in CONTRIB])
def test_contrib_attention_matches_jax(case):
    blob, feeds = case[1]()
    _check(blob, feeds)


def test_attention_refuses_a_shared_buffer_and_a_padding_format():
    x = _AX
    for blob, feeds, match in (
            (_contrib(["x", "w", "b"], {"x": x},
                      past_present_share_buffer=1)[0], [x], "share"),
            (_contrib(["x", "w", "b", "m"],
                      {"x": x, "m": np.asarray([5, 3, 0, 0], I32)})[0],
             [x, np.asarray([5, 3, 0, 0], I32)], "left-padding")):
        with pytest.raises(NotImplementedError, match=match):
            import_model(blob).bind(device="cpu")(*map(to_torch, feeds))
        with pytest.raises(NotImplementedError, match=match):
            jax_import_model(blob).bind()(*feeds)


# -- the fusion family -----------------------------------------------------

_FX, _FS = _n(110, 2, 4, 16), _n(111, 2, 4, 16)
_FI = {"ga": _n(112, 16), "be": _n(113, 16), "bi": _n(114, 16),
       "w": _n(115, 16, 16)}


def _fused(op, node_inputs, n_out=1, **attrs):
    return one_node(op, {"x": _FX, "s": _FS}, inits=_FI,
                    node_inputs=node_inputs, n_out=n_out, domain=MS, **attrs)


FUSION = [
    ("skip_layer_norm", lambda: _fused(
        "SkipLayerNormalization", ["x", "s", "ga", "be", "bi"])),
    ("skip_layer_norm_four_outputs", lambda: _fused(
        "SkipLayerNormalization", ["x", "s", "ga", "be", "bi"], n_out=4)),
    ("skip_simplified_layer_norm", lambda: _fused(
        "SkipSimplifiedLayerNormalization", ["x", "s", "ga"])),
    ("skip_simplified_four_outputs", lambda: _fused(
        "SkipSimplifiedLayerNormalization", ["x", "s", "ga", "bi"],
        n_out=4, epsilon=1e-6)),
    ("bias_gelu", lambda: _fused("BiasGelu", ["x", "bi"])),
    ("fast_gelu", lambda: _fused("FastGelu", ["x", "bi"])),
    ("fast_gelu_no_bias", lambda: _fused("FastGelu", ["x"])),
    ("quick_gelu", lambda: _fused("QuickGelu", ["x"])),
    ("quick_gelu_alpha", lambda: _fused("QuickGelu", ["x"], alpha=1.5)),
    ("fused_matmul_alpha_transb", lambda: _fused(
        "FusedMatMul", ["x", "w"], alpha=0.5, transB=1)),
    ("fused_matmul_transa", lambda: _fused(
        "FusedMatMul", ["s", "x"], transA=1)),
    ("simplified_layer_norm", lambda: _fused(
        "SimplifiedLayerNormalization", ["x", "ga"], epsilon=1e-6)),
    ("simplified_layer_norm_two_outputs", lambda: _fused(
        "SimplifiedLayerNormalization", ["x", "ga"], n_out=2, axis=1)),
]


@pytest.mark.parametrize("case", FUSION, ids=[c[0] for c in FUSION])
def test_fusion_family_matches_jax(case):
    _check(case[1](), [_FX, _FS])


@pytest.mark.parametrize("case", ["skip_layer_norm", "bias_gelu",
                                  "simplified_layer_norm"])
def test_fusion_family_bf16_bind_matches_jax(case):
    blob = dict(FUSION)[case]()
    feeds = [_FX.astype(jnp.bfloat16), _FS.astype(jnp.bfloat16)]
    port, ref = run_both(blob, feeds, cast="bfloat16")
    assert_parity(port, ref, rtol=2e-2, atol=2e-2)


def _embed_graph(with_segments=True, with_mask=True, with_positions=False,
                 n_out=2):
    b, s, h = 2, 6, 16
    rng = np.random.default_rng(2)
    feeds = {"ids": rng.integers(0, 40, (b, s)).astype(I32)}
    if with_segments:
        feeds["sids"] = rng.integers(0, 2, (b, s)).astype(I32)
    if with_mask:
        feeds["mask"] = (np.arange(s)[None] < np.array([[6], [4]])).astype(
            I32)
    inits = {"we": _n(120, 40, h), "pe": _n(121, 12, h), "ga": _n(123, h),
             "bt": _n(124, h)}
    if with_segments:
        inits["se"] = _n(122, 2, h)
    if with_positions:
        inits["pid"] = np.asarray([[5, 4, 3, 2, 1, 0]], I64)
    node_inputs = ["ids", "sids" if with_segments else "", "we", "pe",
                   "se" if with_segments else "", "ga", "bt",
                   "mask" if with_mask else "",
                   "pid" if with_positions else ""]
    return one_node("EmbedLayerNormalization", feeds, inits=inits,
                    node_inputs=node_inputs, n_out=n_out, domain=MS,
                    epsilon=1e-12), list(feeds.values())


@pytest.mark.parametrize("kw", [
    dict(), dict(n_out=3), dict(with_segments=False, with_mask=False),
    dict(with_positions=True)], ids=["bert_frontend", "embedding_output",
                                     "words_only", "position_ids"])
def test_embed_layer_normalization_matches_jax(kw):
    blob, feeds = _embed_graph(**kw)
    port, _ = _check(blob, feeds)
    assert port[1].dtype == torch.int32
    if kw.get("with_mask", True):
        np.testing.assert_array_equal(port[1].numpy(), [6, 4])


def test_fused_encoder_layer_matches_jax_and_the_unfused_layer():
    """The reference's fused encoder layer (Attention, SkipLayerNorm,
    FusedMatMul, BiasGelu) against JAX, and in the port against the same
    layer written with raw MatMul/Add/LayerNormalization/Gelu nodes."""
    b, s, h, n = 2, 6, 32, 4
    x = _n(130, b, s, h)
    w = {"aw": _n(131, h, 3 * h, scale=0.2), "ab": _n(132, 3 * h),
         "g1": _n(133, h), "b1": _n(134, h),
         "fw": _n(135, h, 4 * h, scale=0.2), "fb": _n(136, 4 * h),
         "fw2": _n(137, 4 * h, h, scale=0.2), "g2": _n(138, h),
         "b2": _n(139, h)}
    lens = np.asarray([6, 4], I32)
    gf = GraphBuilder(opset=17)
    xi, mi = gf.add_input("x", F32, [b, s, h]), gf.add_input("m", I32, [b])
    i = {k: gf.add_initializer(k, v) for k, v in w.items()}
    att = gf.add_node("Attention", [xi, i["aw"], i["ab"], mi], domain=MS,
                      num_heads=n)
    s1 = gf.add_node("SkipLayerNormalization", [att, xi, i["g1"], i["b1"]],
                     domain=MS)
    ff = gf.add_node("FusedMatMul", [s1, i["fw"]], domain=MS)
    gl = gf.add_node("BiasGelu", [ff, i["fb"]], domain=MS)
    fo = gf.add_node("FusedMatMul", [gl, i["fw2"]], domain=MS)
    s2 = gf.add_node("SkipLayerNormalization", [fo, s1, i["g2"], i["b2"]],
                     domain=MS)
    gf.add_output(s2, F32, None)
    fused, _ = _check(gf.to_bytes(), [x, lens])

    att_only = one_node("Attention", {"x": x, "m": lens},
                        inits={"aw": w["aw"], "ab": w["ab"]},
                        node_inputs=["x", "aw", "ab", "m"], domain=MS,
                        num_heads=n)
    want_att = import_model(att_only).bind(device="cpu")(
        torch.from_numpy(x), torch.from_numpy(lens))[0]
    gr = GraphBuilder(opset=17)
    ai, xi2 = gr.add_input("att", F32, [b, s, h]), gr.add_input(
        "x", F32, [b, s, h])
    r = {k: gr.add_initializer(k, v) for k, v in w.items()
         if k not in ("aw", "ab")}
    ln1 = gr.add_node("LayerNormalization",
                      [gr.add_node("Add", [ai, xi2]), r["g1"], r["b1"]])
    ge = gr.add_node("Gelu", [gr.add_node("Add", [
        gr.add_node("MatMul", [ln1, r["fw"]]), r["fb"]])])
    ln2 = gr.add_node("LayerNormalization", [gr.add_node("Add", [
        gr.add_node("MatMul", [ge, r["fw2"]]), ln1]), r["g2"], r["b2"]])
    gr.add_output(ln2, F32, None)
    raw = import_model(gr.to_bytes()).bind(device="cpu")(
        want_att, torch.from_numpy(x))[0]
    np.testing.assert_allclose(fused[0].numpy(), raw.numpy(), atol=2e-4)

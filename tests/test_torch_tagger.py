"""The port's sequence tagger (``dl/tagger.py``, ``parallel/moe.py``,
``parallel/ring_attention.py``, ``parallel/mesh.py``) against the JAX
package's, on the CPU.

Both packages start from the same numpy weights (``init_params`` draws
them from numpy) and the same seeded numpy inputs, at the example's width
(``examples/bilstm_entity_extraction.py``: vocab 64, 4 tags, d_model 32,
4 heads of 8, ffn 64, 2 stages) and, where the MoE's top-k matters, the
same width with 4 experts top-2. The reference's attention with a mesh is
its ring (or Ulysses) body on ``single_device_mesh()``; without one,
dense: each port path is held to its own counterpart.

Tolerances: float32 outputs within rtol=atol=1e-5 (the same arithmetic
summed in another order); bf16 logits within 5% of the largest |logit|
(``PERF.md`` §2's bf16 gate: the port's fused tanh-GELU rounds once where
``jax.nn.gelu`` rounds each of its steps in bf16, and attention amplifies
those last-bit differences). The gradients of one float32 step within
1e-4 of each leaf's largest |gradient|; after three AdamW steps the
losses within rtol 1e-5 and every parameter within 0.01·lr of the
reference's (optax decays as ``-lr·(u + wd·p)`` and torch as ``p·(1 -
lr·wd)`` then ``-lr·u``: the same update rounded in another order, plus
the gradients' own differences amplified where a gradient is near 0).
"""
import contextlib
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from synapseml_tpu.dl import tagger as jt
from synapseml_tpu.parallel import mesh as jmesh
from synapseml_tpu.parallel import moe as jmoe
from synapseml_tpu.parallel import ring_attention as jra
from synapseml_tpu_torch.dl import tagger as pt
from synapseml_tpu_torch.parallel import mesh as pmesh
from synapseml_tpu_torch.parallel import moe as pmoe
from synapseml_tpu_torch.parallel import ring_attention as pra

EXAMPLE = dict(vocab_size=64, num_tags=4, d_model=32, head_dim=8,
               ffn_dim=64, max_seq_len=16)
WIDTHS = {"example": {}, "experts4": dict(num_experts=4)}
DTYPES = {"float32": (torch.float32, jnp.float32),
          "bfloat16": (torch.bfloat16, jnp.bfloat16)}
F32_TOL = 1e-5
BF16_GATE = 0.05
LR = 1e-3


def configs(dtype="float32", width="example", **kw):
    """The port's and the reference's config, built alike by ``for_mesh``
    on a world of one."""
    tdt, jdt = DTYPES[dtype]
    over = {**EXAMPLE, **WIDTHS[width], **kw}
    return (pt.TaggerConfig.for_mesh(pmesh.single_device_mesh(), dtype=tdt,
                                     **over),
            jt.TaggerConfig.for_mesh(jmesh.single_device_mesh(), dtype=jdt,
                                     **over))


def meshes(path):
    if path == "dense":
        return None, None
    return pmesh.single_device_mesh(), jmesh.single_device_mesh()


def to_t(a, dtype=torch.float32):
    return torch.tensor(np.asarray(a, np.float32)).to(dtype)


def to_j(a, dtype=jnp.float32):
    return jnp.asarray(np.asarray(a, np.float32), dtype)


def host(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def normal(seed, shape, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape)
            * scale).astype(np.float32)


def batch(cfg, seed, b=2, s=16):
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int32)
    labels = rng.integers(0, cfg.num_tags, (b, s)).astype(np.int32)
    mask = rng.random((b, s)) < 0.75
    return tokens, labels, mask


def assert_close(got, want, dtype):
    got, want = host(got), host(want)
    if dtype == "float32":
        np.testing.assert_allclose(got, want, rtol=F32_TOL, atol=F32_TOL)
    else:
        gap = np.abs(got - want).max()
        assert gap <= BF16_GATE * np.abs(want).max(), gap


# -- parallel/moe.py -----------------------------------------------------

@pytest.mark.parametrize("case", ["random", "tie_at_k", "all_tied"])
def test_topk_gating_matches_the_reference(case):
    if case == "random":
        logits = normal(0, (3, 5, 4), 2.0)
    elif case == "tie_at_k":
        # the 2nd and 3rd largest tie: the threshold keeps three experts
        logits = np.array([[[3.0, 1.5, 1.5, -1.0], [0.5, 2.0, 2.0, 2.0]]],
                          np.float32)
    else:
        logits = np.zeros((1, 2, 4), np.float32)
    got = host(pmoe.topk_gating(to_t(logits), 2))
    want = host(jmoe.topk_gating(to_j(logits), 2))
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)
    if case != "random":
        assert ((got > 0).sum(-1) > 2).all()
        assert ((want > 0).sum(-1) == (got > 0).sum(-1)).all()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("experts", [2, 4])
def test_moe_ffn_and_aux_match_the_reference(dtype, experts):
    tdt, jdt = DTYPES[dtype]
    x = normal(1, (2, 12, 32))
    gate = normal(2, (32, experts), 32 ** -0.5)
    w1 = normal(3, (experts, 32, 64), 32 ** -0.5)
    w2 = normal(4, (experts, 64, 32), 64 ** -0.5)
    got, got_aux = pmoe.moe_ffn(*(to_t(a, tdt) for a in (x, gate, w1, w2)),
                                top_k=2, expert_spec=object())
    want, want_aux = jmoe.moe_ffn(*(to_j(a, jdt) for a in (x, gate, w1, w2)),
                                  top_k=2)
    assert got.dtype == tdt and got_aux.dtype == torch.float32
    assert_close(got, want, dtype)
    np.testing.assert_allclose(float(got_aux), float(want_aux),
                               rtol=F32_TOL if dtype == "float32" else 0.05)


# -- parallel/ring_attention.py ------------------------------------------

def qkv(seed, b=2, s=12, h=4, d=8):
    return [normal(seed + i, (b, s, h, d)) for i in range(3)]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("causal", [False, True])
def test_dense_attention_matches_the_reference(dtype, causal):
    tdt, jdt = DTYPES[dtype]
    q, k, v = qkv(5)
    got = pra.dense_attention(*(to_t(a, tdt) for a in (q, k, v)),
                              causal=causal)
    want = jra.dense_attention(*(to_j(a, jdt) for a in (q, k, v)),
                               causal=causal)
    assert got.dtype == tdt
    assert_close(got, want, dtype)


@pytest.mark.parametrize("masked", [False, True])
def test_block_step_matches_the_reference(masked):
    q, k, v = qkv(7, s=6)
    rng = np.random.default_rng(8)
    m = rng.standard_normal((2, 4, 6)).astype(np.float32)
    l = rng.random((2, 4, 6)).astype(np.float32) + 0.5
    o = normal(9, (2, 6, 4, 8))
    mask = rng.random((6, 6)) < 0.7 if masked else None
    got = pra._block_step(*(to_t(a) for a in (q, k, v, m, l, o)),
                          None if mask is None else torch.tensor(mask))
    want = jra._block_step(*(to_j(a) for a in (q, k, v, m, l, o)),
                           None if mask is None else jnp.asarray(mask))
    for g, w in zip(got, want):
        np.testing.assert_allclose(host(g), host(w), rtol=F32_TOL,
                                   atol=F32_TOL)


@pytest.mark.parametrize("kind", ["ring", "ulysses", "serving_ring"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("causal", [False, True])
def test_world_of_one_attention_matches_the_reference(kind, dtype, causal):
    tdt, jdt = DTYPES[dtype]
    pm, jm = pmesh.single_device_mesh(), jmesh.single_device_mesh()
    if kind == "ring":
        pf = pra.make_ring_attention(pm, causal=causal)
        jf = jra.make_ring_attention(jm, causal=causal)
    elif kind == "ulysses":
        pf = pra.make_ulysses_attention(pm, causal=causal)
        jf = jra.make_ulysses_attention(jm, causal=causal)
    else:
        pf = pra.make_serving_ring_attention(pm, causal=causal)
        jf = jra.make_serving_ring_attention(jm, causal=causal)
    q, k, v = qkv(11)
    got = pf(*(to_t(a, tdt) for a in (q, k, v)))
    want = jax.jit(jf)(*(to_j(a, jdt) for a in (q, k, v)))
    assert got.dtype == tdt
    assert_close(got, want, dtype)


def test_ring_gradients_match_the_reference():
    q, k, v = qkv(13, s=8)
    ring = pra.make_ring_attention(pmesh.single_device_mesh())
    tq, tk, tv = (to_t(a).requires_grad_() for a in (q, k, v))
    (ring(tq, tk, tv) ** 2).sum().backward()
    jring = jra.make_ring_attention(jmesh.single_device_mesh())
    grads = jax.jit(jax.grad(lambda a, b, c: (jring(a, b, c) ** 2).sum(),
                             argnums=(0, 1, 2)))(*(to_j(a) for a in (q, k, v)))
    for t, g in zip((tq, tk, tv), grads):
        np.testing.assert_allclose(host(t.grad), host(g), rtol=1e-4,
                                   atol=1e-5)


# -- dl/tagger.py ----------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rope_matches_the_reference(dtype):
    tdt, jdt = DTYPES[dtype]
    x = normal(15, (2, 20, 4, 8), 2.0)
    got = pt._rope(to_t(x, tdt), torch.arange(20))
    want = jt._rope(to_j(x, jdt), jnp.arange(20))
    assert got.dtype == tdt
    assert_close(got, want, dtype)


@contextlib.contextmanager
def recorded_routes(moe_module):
    """The experts each token is routed to, one ``[B, S, E]`` boolean
    array a layer, recorded around ``moe_module.topk_gating`` (the port's,
    or the reference's through an ordered ``jax.debug.callback``; trace
    the reference inside the block)."""
    seen = []
    inner = moe_module.topk_gating

    def record(gate_logits, top_k):
        gates = inner(gate_logits, top_k)
        if isinstance(gates, torch.Tensor):
            seen.append(host(gates) > 0)
        else:
            jax.debug.callback(lambda g: seen.append(np.asarray(g) > 0),
                               gates, ordered=True)
        return gates

    moe_module.topk_gating = record
    try:
        yield seen
    finally:
        moe_module.topk_gating = inner


def routed_alike(got, want):
    """``[B, S]``: True where a token went to the same experts in every
    layer of both runs."""
    assert len(got) == len(want)
    return np.all([(g == w).all(-1) for g, w in zip(got, want)], axis=0)


@pytest.mark.parametrize("width", ["example", "experts4"])
@pytest.mark.parametrize("path", ["dense", "ring", "ulysses"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_forward_matches_the_reference(width, path, dtype):
    """Float32 routes every token alike and holds every logit to the
    reference. In bf16 a token whose k-th and (k+1)-th gate logits are a
    last-bit tie can go to other experts in either package (the reference's
    dense and ring paths differ so at the default width, PERF.md §6): such
    tokens are counted, and every token routed alike is held to the bf16
    gate."""
    attention = "dense" if path == "dense" else path
    pcfg, jcfg = configs(dtype, width, attention=attention)
    pm, jm = meshes(path)
    params = pt.init_params(pcfg, 3)
    tokens, _, _ = batch(pcfg, 4, b=3, s=16)
    with recorded_routes(pmoe) as got_routes, torch.no_grad():
        logits, aux = pt.make_apply(pcfg, pm, device="cpu")(
            pt.params_from_numpy(params, "cpu"), tokens)
    with recorded_routes(jmoe) as want_routes:
        want_logits, want_aux = jax.jit(jt.make_apply(jcfg, jm))(
            jax.tree_util.tree_map(jnp.asarray, params), jnp.asarray(tokens))
        jax.effects_barrier()
    assert logits.dtype == torch.float32 and logits.shape == (3, 16, 4)
    alike = routed_alike(got_routes, want_routes)
    if dtype == "float32":
        assert alike.all()
        assert_close(logits, want_logits, dtype)
    else:
        assert alike.mean() >= 0.95, alike.mean()
        want = host(want_logits)
        gap = np.abs(host(logits) - want).max(-1)[alike]
        assert gap.max() <= BF16_GATE * np.abs(want).max()
    np.testing.assert_allclose(
        float(aux), float(want_aux),
        rtol=F32_TOL if dtype == "float32" else BF16_GATE)


def test_tagging_loss_matches_the_reference():
    logits = normal(17, (3, 10, 5), 2.0)
    rng = np.random.default_rng(18)
    labels = rng.integers(0, 5, (3, 10)).astype(np.int32)
    for mask in (rng.random((3, 10)) < 0.6, np.zeros((3, 10), bool)):
        got = pt.tagging_loss(to_t(logits), torch.tensor(labels),
                              torch.tensor(mask), torch.tensor(0.7))
        want = jt.tagging_loss(to_j(logits), jnp.asarray(labels),
                               jnp.asarray(mask), 0.7)
        np.testing.assert_allclose(float(got), float(want), rtol=F32_TOL)


@pytest.fixture(scope="module")
def three_steps():
    """Three AdamW steps of both packages from the same weights on one
    batch with a partial mask (float32, 4 experts top-2), the port's
    first-step gradients and the reference's."""
    pcfg, jcfg = configs("float32", "experts4")
    tokens, labels, mask = batch(pcfg, 21, b=4, s=16)
    step, init_state, place = pt.make_train_step(pcfg, learning_rate=LR,
                                                 device="cpu")
    params, opt = init_state(0)
    losses, grads = [], None
    for _ in range(3):
        params, opt, loss = step(params, opt, place(tokens), place(labels),
                                 mask)
        losses.append(float(loss))
        if grads is None:
            grads = {n: p.grad.numpy().copy()
                     for n, p in params.named_parameters()}
    japply = jt.make_apply(jcfg, jmesh.single_device_mesh())

    def jloss(p):
        logits, aux = japply(p, tokens)
        return jt.tagging_loss(logits, labels, mask, aux)

    jgrads = jax.jit(jax.grad(jloss))(
        jax.tree_util.tree_map(jnp.asarray, jt.init_params(jcfg, 0)))
    jstep, jinit, jshard = jt.make_train_step(jcfg, jmesh.single_device_mesh(),
                                              learning_rate=LR)
    jparams, jopt = jinit(0)
    jlosses = []
    for _ in range(3):
        jparams, jopt, jloss = jstep(jparams, jopt, tokens, labels, mask)
        jlosses.append(float(jloss))
    return dict(params=pt.params_to_numpy(params), grads=grads, losses=losses,
                jparams=jax.tree_util.tree_map(np.asarray, jparams),
                jgrads=jax.tree_util.tree_map(np.asarray, jgrads),
                jlosses=jlosses)


def leaves(tree):
    out = {k: v for k, v in tree.items() if k != "stages"}
    out.update({f"stages.{k}": v for k, v in tree["stages"].items()})
    return out


def test_gradients_of_one_step_match_the_reference(three_steps):
    want = leaves(three_steps["jgrads"])
    got = three_steps["grads"]
    assert sorted(got) == sorted(want)
    for name, g in got.items():
        scale = np.abs(want[name]).max()
        assert scale > 0, name
        assert np.abs(g - want[name]).max() <= 1e-4 * scale, name


def test_three_adamw_steps_match_the_reference(three_steps):
    np.testing.assert_allclose(three_steps["losses"], three_steps["jlosses"],
                               rtol=F32_TOL)
    assert three_steps["losses"][-1] < three_steps["losses"][0]
    got, want = leaves(three_steps["params"]), leaves(three_steps["jparams"])
    for name in want:
        assert np.abs(got[name] - want[name]).max() <= 0.01 * LR, name


@pytest.mark.parametrize("width", ["example", "experts4", "default"])
def test_init_params_bitwise(width):
    if width == "default":
        pcfg, jcfg = pt.TaggerConfig(), jt.TaggerConfig()
    else:
        pcfg, jcfg = configs("float32", width)
    got = leaves(pt.init_params(pcfg, 5))
    want = leaves(jt.init_params(jcfg, 5))
    assert sorted(got) == sorted(want)
    for name in want:
        assert got[name].dtype == want[name].dtype == np.float32
        assert np.array_equal(got[name], want[name]), name
    if width == "default":
        assert sum(a.size for a in want.values()) == 427_840


def test_params_round_trip_bitwise():
    params = pt.init_params(pt.TaggerConfig(), 1)
    module = pt.params_from_numpy(params, "cpu")
    assert {n: tuple(p.shape) for n, p in module.named_parameters()} == {
        n: a.shape for n, a in leaves(params).items()}
    back = pt.params_to_numpy(module)
    for name, a in leaves(params).items():
        assert np.array_equal(leaves(back)[name], a), name
    with pytest.raises(KeyError):
        pt.params_from_numpy({**params, "stages": {"wq": params["stages"]
                                                   ["wq"]}}, "cpu")


def test_param_specs_match_the_reference():
    want = jt.param_specs(jt.TaggerConfig())
    got = pt.param_specs(pt.TaggerConfig())
    assert leaves(got) == {n: tuple(s) for n, s in leaves(want).items()}


# -- parallel/mesh.py ----------------------------------------------------

@pytest.mark.parametrize("n,want", [
    (1, None), (2, None), (4, None), (8, None), (6, None), (12, None),
    (8, {"pp": 2}), (8, {"sp": 4, "dp": 2}), (16, {"ep": 2}), (9, {"tp": 3}),
])
def test_factor_axes_matches_the_reference(n, want):
    assert pmesh.factor_axes(n, want) == jmesh.factor_axes(n, want)
    assert pmesh.AXES == jmesh.AXES


def test_factor_axes_refuses_what_the_reference_refuses():
    for mod in (pmesh, jmesh):
        with pytest.raises(ValueError, match="does not divide"):
            mod.factor_axes(6, {"tp": 4})


@pytest.mark.parametrize("overrides", [
    {}, EXAMPLE, dict(num_heads=6, num_experts=3, num_stages=1),
])
def test_for_mesh_on_a_world_of_one(overrides):
    for mesh in (pmesh.build_mesh(), pmesh.single_device_mesh()):
        assert mesh.shape == {a: 1 for a in pmesh.AXES}
        assert tuple(mesh.axis_names) == pmesh.AXES
        got = dataclasses.asdict(pt.TaggerConfig.for_mesh(mesh, **overrides))
        want = dataclasses.asdict(jt.TaggerConfig.for_mesh(
            jmesh.single_device_mesh(), **overrides))
        assert got.pop("dtype") == torch.bfloat16
        assert want.pop("dtype") == jnp.bfloat16
        assert got == want


# -- refusals ----------------------------------------------------------------

def test_out_of_range_token_is_refused_where_the_reference_clamps():
    pcfg, jcfg = configs("float32")
    params = pt.init_params(pcfg, 0)
    tokens = np.array([[5, 63, 7]], np.int32)
    clamped = tokens.copy()
    clamped[0, 1] = 70    # past the vocabulary: JAX's gather reads row 63
    japply = jt.make_apply(jcfg, None)
    jp = jax.tree_util.tree_map(jnp.asarray, params)
    np.testing.assert_array_equal(host(japply(jp, clamped)[0]),
                                  host(japply(jp, tokens)[0]))
    apply = pt.make_apply(pcfg, device="cpu")
    module = pt.params_from_numpy(params, "cpu")
    for bad in (clamped, torch.tensor(clamped), -tokens):
        with pytest.raises(ValueError, match="outside"):
            apply(module, bad)
    step, init_state, place = pt.make_train_step(pcfg, device="cpu")
    module, opt = init_state(0)
    before = pt.params_to_numpy(module)
    with pytest.raises(ValueError, match="labels outside"):
        step(module, opt, tokens, np.array([[0, 4, 1]]), np.ones((1, 3), bool))
    assert np.array_equal(pt.params_to_numpy(module)["embed"],
                          before["embed"])


def test_wider_meshes_raise_and_name_the_roadmap_item():
    """Sequence parallelism runs over ranks (item 4b): in a process without
    a world of the mesh's size it raises ``RuntimeError`` saying what world
    it needs. Heads or weights over tp, and pp or ep, stay item 4c."""
    pcfg, _ = configs("float32")
    with pytest.raises(RuntimeError, match="world of 2 ranks"):
        pmesh.build_mesh(want={"sp": 2})
    with pytest.raises(RuntimeError, match="world of 2 ranks"):
        pmesh.build_mesh(devices=[0, 1])
    for want in ({"pp": 2}, {"ep": 2}, {"sp": 2, "pp": 2}):
        with pytest.raises(NotImplementedError, match="4c"):
            pmesh.build_mesh(want=want)
    sp2 = pmesh.Mesh({"sp": 2})
    tp2 = pmesh.Mesh({"tp": 2, "dp": 2})
    for build in (pra.make_ring_attention, pra.make_ulysses_attention,
                  pra.make_serving_ring_attention):
        with pytest.raises(RuntimeError, match="world of 2 ranks"):
            build(sp2)
    for build in (pra.make_ring_attention, pra.make_ulysses_attention):
        with pytest.raises(NotImplementedError, match="4c"):
            build(tp2)
    with pytest.raises(RuntimeError, match="world of 4 ranks"):
        pra.make_serving_ring_attention(tp2)
    with pytest.raises(RuntimeError, match="world of 2 ranks"):
        pt.make_apply(pcfg, sp2, device="cpu")
    with pytest.raises(NotImplementedError, match="4c"):
        pt.make_apply(dataclasses.replace(pcfg, attention="dense"), tp2,
                      device="cpu")
    with pytest.raises(RuntimeError, match="world of 2 ranks"):
        pt.make_train_step(pcfg, sp2, device="cpu")
    with pytest.raises(NotImplementedError, match="4c"):
        pt.make_train_step(pcfg, pmesh.Mesh({"ep": 2}), device="cpu")
    with pytest.raises(ValueError, match="unknown mesh axes"):
        pmesh.Mesh({"xp": 2})


def test_entry_points_default_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    pcfg, _ = configs("float32")
    for build in (pt.make_apply, pt.make_train_step):
        with pytest.raises(RuntimeError, match="CUDA"):
            build(pcfg)
    with pytest.raises(RuntimeError, match="CUDA"):
        pt.params_from_numpy(pt.init_params(pcfg, 0))
    apply = pt.make_apply(pcfg, device="cpu")
    meta = pt.Tagger(pt.init_params(pcfg, 0), torch.device("meta"))
    with pytest.raises(ValueError, match="lie on"):
        apply(meta, np.zeros((1, 2), np.int32))


def test_the_example_flow_learns_on_the_cpu():
    """``examples/bilstm_entity_extraction.py``'s training and held-out
    checks, with the port's modules: 200 steps at batch 16 x 16."""
    import os
    import sys
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    from examples.bilstm_entity_extraction import entity_batches

    mesh = pmesh.build_mesh()
    cfg = pt.TaggerConfig.for_mesh(mesh, **EXAMPLE)
    step, init_state, place = pt.make_train_step(cfg, mesh,
                                                 learning_rate=3e-3,
                                                 device="cpu")
    params, opt = init_state()
    rng = np.random.default_rng(0)
    losses = []
    for _ in range(200):
        tokens, labels = entity_batches(rng, cfg.vocab_size, cfg.num_tags,
                                        16, 16)
        params, opt, loss = step(params, opt, place(tokens), place(labels),
                                 place(np.ones((16, 16), bool)))
        losses.append(float(loss))
    assert losses[-1] < losses[0] * 0.6
    tokens, labels = entity_batches(rng, cfg.vocab_size, cfg.num_tags, 16, 16)
    with torch.no_grad():
        logits, _ = pt.make_apply(cfg, mesh, device="cpu")(params, tokens)
    assert (logits.argmax(-1).numpy() == labels).mean() > 0.8

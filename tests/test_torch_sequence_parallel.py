"""Sequence parallelism over ranks (``parallel/mesh.py``,
``parallel/ring_attention.py``, ``parallel/moe.py``'s aux shares and the
tagger's dp × sp path in ``dl/tagger.py``) against the JAX package, on
the CPU.

The port's ranks are gloo CPU processes (``tests/torch_dp_worker.py``'s
``run_ranks``, ``call`` cases running ``tests/torch_sp_cases.py``); each
builds the mesh over its world, cuts its block out of the same global
numpy arrays and returns its blocks with its coordinates. The JAX side
runs in this process over the same mesh on the virtual CPU devices
``tests/conftest.py`` gives it (``build_mesh(jax.devices()[:n],
want=...)``), fed the global arrays. Three launches (8, 4 and 2 ranks)
run in a background thread while JAX compiles.

Tolerances: gathered attention outputs and gradients within rtol = atol
= 1e-5 of the reference's over the same mesh (the same arithmetic summed
in another order), and within the reference's own 2e-4 of dense
attention (``tests/test_parallel.py:28-79``). The tagger at
``tests/test_torch_tagger.py``'s ``EXAMPLE`` width with 4 experts, as
that file holds it: forward logits within 1e-5, the first step's
gradients within 1e-4 of each leaf's largest, three AdamW steps' losses
within rtol 1e-5 and every parameter within 0.01·lr, and the parameters
bitwise equal on every rank.
"""
import concurrent.futures
import os
import sys

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
from synapseml_tpu_torch.parallel import collectives
from synapseml_tpu_torch.parallel import mesh as pmesh
from synapseml_tpu_torch.parallel import moe as pmoe
from synapseml_tpu_torch.parallel import ring_attention as pra

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from torch_dp_worker import run_ranks  # noqa: E402
from torch_sp_cases import gather  # noqa: E402

F32_TOL = 1e-5
DENSE_TOL = 2e-4              # the reference's own, ring against dense
LR = 1e-3
EXAMPLE = dict(vocab_size=64, num_tags=4, d_model=32, head_dim=8,
               ffn_dim=64, max_seq_len=16, num_experts=4)
SP4_DP2 = {"sp": 4, "dp": 2}

# (name, kind, mesh, causal, seed, [B, S, H, D]): the reference's tests'
# shapes and seeds (tests/test_parallel.py:28-79, :578-597)
ATTENTION_8 = [
    ("ring", "ring", SP4_DP2, False, 0, (2, 16, 4, 8)),
    ("ring_causal", "ring", SP4_DP2, True, 0, (2, 16, 4, 8)),
    ("ring_grads", "ring", SP4_DP2, False, 1, (2, 8, 2, 4)),
    ("ring_grads_causal", "ring", SP4_DP2, True, 1, (2, 8, 2, 4)),
    ("ulysses", "ulysses", SP4_DP2, False, 2, (2, 16, 4, 8)),
    ("serving_ring", "serving_ring", {"dp": 2, "tp": 4}, True, 0,
     (2, 16, 4, 8)),
]
ATTENTION_2 = [
    ("ring2", "ring", {"sp": 2}, False, 3, (2, 12, 4, 8)),
    ("ring2_causal", "ring", {"sp": 2}, True, 3, (2, 12, 4, 8)),
    ("ulysses2", "ulysses", {"sp": 2}, True, 4, (2, 12, 4, 8)),
]
TAGGER_MESHES = {"sp4": {"sp": 4}, "dp2_sp2": {"dp": 2, "sp": 2}}
TAGGER_CASES = [(m, a) for m in TAGGER_MESHES for a in ("ring", "ulysses")]


def qkv(seed, shape):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(shape).astype(np.float32) for _ in range(3)]


def tagger_batch():
    rng = np.random.default_rng(21)
    tokens = rng.integers(0, EXAMPLE["vocab_size"], (4, 16)).astype(np.int32)
    labels = rng.integers(0, EXAMPLE["num_tags"], (4, 16)).astype(np.int32)
    mask = rng.random((4, 16)) < 0.75
    return tokens, labels, mask


def attention_cases(table, world):
    return [{"name": name, "kind": "call",
             "fn": "torch_sp_cases:attention",
             "args": [[kind, shape, causal, *qkv(seed, dims)]] * world}
            for name, kind, shape, causal, seed, dims in table]


def tagger_cases():
    tokens, labels, mask = tagger_batch()
    cases = [{"name": f"{m}_{a}", "kind": "call",
              "fn": "torch_sp_cases:tagger",
              "args": [[EXAMPLE, TAGGER_MESHES[m], a, "float32", tokens,
                        labels, mask, 3, LR, 0, "cpu", tokens]] * 4}
             for m, a in TAGGER_CASES]
    grid = np.arange(4 * 16).reshape(4, 16)
    cases.append({"name": "placement", "kind": "call",
                  "fn": "torch_sp_cases:placement",
                  "args": [[{"dp": 2, "sp": 2},
                            [grid, grid[:3], grid[:, :15]]]] * 4})
    # Ulysses over 4 sequence ranks with 2 heads
    cases.append({"name": "ulysses_heads", "kind": "call",
                  "fn": "torch_sp_cases:attention",
                  "args": [["ulysses", {"sp": 4}, False,
                            *qkv(5, (1, 8, 2, 4))]] * 4})
    return cases


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """The three launches, run one after another in a background thread;
    ``ranks[world]()`` waits for that launch's per-rank results."""
    root = tmp_path_factory.mktemp("sp_ranks")
    pool = concurrent.futures.ThreadPoolExecutor(1)
    futures = {
        8: pool.submit(run_ranks, str(root / "w8"), 8,
                       attention_cases(ATTENTION_8, 8), 240.0),
        4: pool.submit(run_ranks, str(root / "w4"), 4, tagger_cases(),
                       240.0),
        2: pool.submit(run_ranks, str(root / "w2"), 2,
                       attention_cases(ATTENTION_2, 2), 240.0)}
    yield {w: f.result for w, f in futures.items()}
    pool.shutdown(wait=True)


def results(ranks, world, name):
    per_rank = [r[name] for r in ranks[world]()]
    for r, res in enumerate(per_rank):
        assert "error" not in res, f"rank {r}: {res['error']}"
    return per_rank


def reference_fn(kind, shape, causal):
    if kind == "serving_ring":
        from jax.sharding import Mesh
        n = shape["dp"] * shape["tp"]
        mesh = Mesh(np.array(jax.devices()[:n]).reshape(shape["dp"],
                                                        shape["tp"]),
                    ("dp", "tp"))
        return jra.make_serving_ring_attention(mesh, causal=causal), mesh
    n = int(np.prod(list(shape.values())))
    mesh = jmesh.build_mesh(jax.devices()[:n], want=shape)
    build = (jra.make_ring_attention if kind == "ring"
             else jra.make_ulysses_attention)
    return build(mesh, causal=causal), mesh


def reference_attention(kind, shape, causal, q, k, v):
    """The JAX package's output over the same mesh and its gradients of
    ``(out ** 2).sum()``, and dense attention's output."""
    fn, mesh = reference_fn(kind, shape, causal)
    with mesh:
        out = jax.jit(fn)(q, k, v)
        grads = jax.jit(jax.grad(lambda a, b, c: (fn(a, b, c) ** 2).sum(),
                                 argnums=(0, 1, 2)))(q, k, v)
    dense = jra.dense_attention(*(jnp.asarray(a) for a in (q, k, v)),
                                causal=causal)
    return (np.asarray(out), [np.asarray(g) for g in grads],
            np.asarray(dense))


def check_attention(ranks, world, table, name):
    _, kind, shape, causal, seed, dims = next(c for c in table
                                              if c[0] == name)
    q, k, v = qkv(seed, dims)
    per_rank = results(ranks, world, name)
    seq = "tp" if kind == "serving_ring" else "sp"
    axes = ("dp", seq)
    got = gather(per_rank, "out", axes, dims)
    want, want_grads, dense = reference_attention(kind, shape, causal,
                                                  q, k, v)
    np.testing.assert_allclose(got, want, rtol=F32_TOL, atol=F32_TOL)
    np.testing.assert_allclose(got, dense, rtol=DENSE_TOL, atol=DENSE_TOL)
    for i, g in enumerate(want_grads):
        np.testing.assert_allclose(gather(per_rank, "grads", axes, dims, i),
                                   g, rtol=F32_TOL, atol=F32_TOL)
    return per_rank


# -- unit cases: no ranks ----------------------------------------------------

@pytest.mark.parametrize("n,want", [
    (8, SP4_DP2), (8, {"dp": 2, "tp": 4}), (8, {"dp": 2, "sp": 2, "tp": 2}),
    (8, {"sp": 8}), (4, {"sp": 4}), (4, {"dp": 2, "sp": 2}), (2, None),
])
def test_rank_layout_is_the_references_reshape(n, want):
    """Rank r sits where the reference's ``build_mesh`` puts device r."""
    jm = jmesh.build_mesh(jax.devices()[:n], want=want)
    ids = np.vectorize(lambda d: d.id)(jm.devices)
    shape = dict(jm.shape)
    assert pmesh.factor_axes(n, want) == shape
    for r in range(n):
        at = tuple(int(c) for c in np.argwhere(ids == jax.devices()[r].id)[0])
        assert tuple(pmesh.coords_of(r, shape)[a] for a in pmesh.AXES) == at
        assert pmesh.coords_of(r, shape) == dict(zip(
            pmesh.AXES, (int(c) for c in np.unravel_index(
                r, tuple(shape[a] for a in pmesh.AXES)))))


def test_a_mesh_wider_than_the_world_raises_and_says_what_it_needs():
    cfg = pt.TaggerConfig(**EXAMPLE)
    wide = pmesh.Mesh({"dp": 2, "sp": 2})
    assert not wide.bound and wide.shape["sp"] == 2
    for run in (lambda: pra.make_ring_attention(wide),
                lambda: pra.make_ulysses_attention(wide),
                lambda: pra.make_serving_ring_attention(
                    pmesh.Mesh({"dp": 2, "tp": 2})),
                lambda: pt.make_apply(cfg, wide, device="cpu"),
                lambda: pt.make_train_step(cfg, wide, device="cpu"),
                lambda: wide.block(np.zeros((4, 4)), ("dp", "sp")),
                lambda: pmesh.build_mesh(want={"sp": 4}),
                lambda: pmesh.build_mesh(devices=[0, 1])):
        with pytest.raises(RuntimeError, match="world of [24] ranks"):
            run()


def test_aux_shares_sum_to_the_reference_aux(monkeypatch):
    """On a batch split in 2 x 2 blocks, the four ranks' shares sum to the
    reference's aux of the whole batch, where a sum of per-block products
    does not. The exchange is stood in for by the whole batch's counts."""
    rng = np.random.default_rng(7)
    x = rng.standard_normal((4, 12, 32)).astype(np.float32)
    gate = (rng.standard_normal((32, 4)) * 32 ** -0.5).astype(np.float32)
    w1 = (rng.standard_normal((4, 32, 64)) * 32 ** -0.5).astype(np.float32)
    w2 = (rng.standard_normal((4, 64, 32)) * 64 ** -0.5).astype(np.float32)
    _, want = jmoe.moe_ffn(*(jnp.asarray(a) for a in (x, gate, w1, w2)),
                           top_k=2)
    weights = [torch.tensor(a) for a in (gate, w1, w2)]
    gates = pmoe.topk_gating(torch.einsum("bsd,de->bse", torch.tensor(x),
                                          weights[0]), 2)
    whole = torch.cat([(gates > 0).sum(dim=(0, 1)), torch.tensor([4 * 12])])
    monkeypatch.setattr(pmoe.collectives, "all_reduce_sum",
                        lambda counts, group: whole)
    shares, products = [], []
    for bi in range(2):
        for si in range(2):
            blk = torch.tensor(x[2 * bi:2 * bi + 2, 6 * si:6 * si + 6])
            shares.append(float(pmoe.moe_ffn(blk, *weights, top_k=2,
                                             token_group=object())[1]))
            products.append(float(pmoe.moe_ffn(blk, *weights, top_k=2)[1]))
    np.testing.assert_allclose(sum(shares), float(want), rtol=F32_TOL)
    assert abs(sum(products) - float(want)) > 100 * F32_TOL * float(want)


def test_tp_pp_ep_still_raise_naming_4c():
    cfg = pt.TaggerConfig(**EXAMPLE)
    for shape in ({"tp": 2}, {"pp": 2}, {"ep": 2}, {"sp": 2, "tp": 2}):
        mesh = pmesh.Mesh(shape)
        for build in (pt.make_apply, pt.make_train_step):
            with pytest.raises(NotImplementedError, match="4c"):
                build(cfg, mesh, device="cpu")
    for build in (pra.make_ring_attention, pra.make_ulysses_attention):
        with pytest.raises(NotImplementedError, match="4c"):
            build(pmesh.Mesh({"sp": 2, "tp": 2}))
    # the serving ring's tp carries the sequence, not the heads
    with pytest.raises(RuntimeError, match="world of 4"):
        pra.make_serving_ring_attention(pmesh.Mesh({"dp": 2, "tp": 2}))


# -- attention over ranks ----------------------------------------------------

@pytest.mark.parametrize("name", [c[0] for c in ATTENTION_8])
def test_attention_over_eight_ranks_matches_the_reference(ranks, name):
    per_rank = check_attention(ranks, 8, ATTENTION_8, name)
    kind = next(c[1] for c in ATTENTION_8 if c[0] == name)
    calls = per_rank[0]["collectives"]
    if kind == "ulysses":   # q, k, v in one exchange; the output; backward
        assert calls["all_to_all"]["calls"] == 4 and "rotate" not in calls
    else:                   # n - 1 rotations forward, as many backward
        n = 4
        assert calls["rotate"]["calls"] == 2 * (n - 1)


@pytest.mark.parametrize("name", [c[0] for c in ATTENTION_2])
def test_attention_over_two_ranks_matches_the_reference(ranks, name):
    check_attention(ranks, 2, ATTENTION_2, name)


def test_ulysses_refuses_heads_that_do_not_split(ranks):
    for res in [r["ulysses_heads"] for r in ranks[4]()]:
        assert "requires H % (sp*tp) == 0" in res["error"]


# -- the tagger over dp x sp ranks -------------------------------------------

@pytest.fixture(scope="module")
def reference_tagger():
    """The JAX package's forward, first-step gradients and three steps
    over each mesh and attention path, from ``init_params(cfg, 0)``."""
    tokens, labels, mask = tagger_batch()
    out = {}
    for m, a in TAGGER_CASES:
        cfg = jt.TaggerConfig(dtype=jnp.float32, attention=a, **EXAMPLE)
        mesh = jmesh.build_mesh(jax.devices()[:4], want=TAGGER_MESHES[m])
        apply = jt.make_apply(cfg, mesh)
        p0 = jax.tree_util.tree_map(jnp.asarray, jt.init_params(cfg, 0))
        logits, aux = jax.jit(apply)(p0, tokens)

        def loss(p):
            lg, ax = apply(p, tokens)
            return jt.tagging_loss(lg, labels, mask, ax)

        grads = jax.jit(jax.grad(loss))(p0)
        step, init_state, _ = jt.make_train_step(cfg, mesh, learning_rate=LR)
        params, opt = init_state(0)
        losses = []
        for _ in range(3):
            params, opt, value = step(params, opt, tokens, labels, mask)
            losses.append(float(value))
        out[f"{m}_{a}"] = dict(
            logits=np.asarray(logits), aux=float(aux), losses=losses,
            grads=leaves(jax.tree_util.tree_map(np.asarray, grads)),
            params=leaves(jax.tree_util.tree_map(np.asarray, params)))
    return out


def leaves(tree):
    out = {k: v for k, v in tree.items() if k != "stages"}
    out.update({f"stages.{k}": v for k, v in tree["stages"].items()})
    return out


CASE_IDS = [f"{m}_{a}" for m, a in TAGGER_CASES]


@pytest.mark.parametrize("case", CASE_IDS)
def test_tagger_forward_over_ranks_matches_the_reference(
        ranks, reference_tagger, case):
    per_rank = results(ranks, 4, case)
    want = reference_tagger[case]
    got = gather(per_rank, "logits", ("dp", "sp"), want["logits"].shape)
    np.testing.assert_allclose(got, want["logits"], rtol=F32_TOL,
                               atol=F32_TOL)
    # the aux shares, summed in rank order, are the reference's global aux
    total = 0.0
    for res in per_rank:
        total += res["aux"]
    np.testing.assert_allclose(total, want["aux"], rtol=F32_TOL)


@pytest.mark.parametrize("case", CASE_IDS)
def test_tagger_first_step_gradients_over_ranks(ranks, reference_tagger,
                                                case):
    per_rank = results(ranks, 4, case)
    want = reference_tagger[case]["grads"]
    for res in per_rank:
        assert sorted(res["grads"]) == sorted(want)
        for name, g in res["grads"].items():
            scale = np.abs(want[name]).max()
            assert scale > 0, name
            assert np.abs(g - want[name]).max() <= 1e-4 * scale, name


@pytest.mark.parametrize("case", CASE_IDS)
def test_tagger_three_steps_over_ranks_match_the_reference(
        ranks, reference_tagger, case):
    per_rank = results(ranks, 4, case)
    want = reference_tagger[case]
    for res in per_rank:
        np.testing.assert_allclose(res["losses"], want["losses"],
                                   rtol=F32_TOL)
    assert per_rank[0]["losses"][-1] < per_rank[0]["losses"][0]
    for name, w in want["params"].items():
        assert np.abs(per_rank[0]["params"][name] - w).max() <= 0.01 * LR, \
            name


@pytest.mark.parametrize("case", CASE_IDS)
def test_tagger_parameters_are_bitwise_equal_on_every_rank(ranks, case):
    per_rank = results(ranks, 4, case)
    assert len({res["digest"] for res in per_rank}) == 1
    for res in per_rank[1:]:
        for name, p in res["params"].items():
            assert np.array_equal(p, per_rank[0]["params"][name]), name
        assert res["losses"] == per_rank[0]["losses"]
    # one exchange a step for the gradients, plus the mask's count and
    # each of the 2 MoE layers' routing counts
    assert per_rank[0]["collectives"]["exchange"]["calls"] == 3 * (1 + 1 + 2)


def test_batch_placement_cuts_the_dp_sp_block_and_refuses_the_rest(ranks):
    grid = np.arange(4 * 16).reshape(4, 16)
    per_rank = results(ranks, 4, "placement")
    for res in per_rank:
        c = res["coords"]
        assert len(res["blocks"]) == 1 and len(res["errors"]) == 2
        np.testing.assert_array_equal(
            res["blocks"][0],
            grid[2 * c["dp"]:2 * c["dp"] + 2, 8 * c["sp"]:8 * c["sp"] + 8])
        assert "dimension 0" in res["errors"][0] and "'dp'" in res["errors"][0]
        assert "dimension 1" in res["errors"][1] and "'sp'" in res["errors"][1]
    assert sorted((r["coords"]["dp"], r["coords"]["sp"])
                  for r in per_rank) == [(0, 0), (0, 1), (1, 0), (1, 1)]


def test_collectives_count_rotations_and_all_to_alls_by_kind():
    stats = collectives.CollectiveStats()
    stats.record("rotate", 10, 0.5)
    stats.record("rotate", 6, 0.25)
    stats.record("exchange", 4, 0.0)
    assert (stats.calls, stats.bytes, stats.seconds) == (3, 20, 0.75)
    assert stats.kinds == {"rotate": {"calls": 2, "bytes": 16,
                                      "seconds": 0.75},
                           "exchange": {"calls": 1, "bytes": 4,
                                        "seconds": 0.0}}
    stats.reset()
    assert stats.kinds == {} and stats.calls == 0
    x = torch.arange(6.0).reshape(2, 3)
    assert collectives.rotate(x, collectives.ALONE, 0, 0) is x
    assert collectives.all_to_all(x, collectives.ALONE, 0, 1) is x

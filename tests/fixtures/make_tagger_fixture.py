"""Generate ``tests/fixtures/tagger_io.npz``: the sequence tagger at its
default width, recorded by the JAX package.

``synapseml_tpu/dl/tagger.py``'s ``TaggerConfig()`` (vocab 4,096, 16 tags,
d_model 64, 4 heads of 16, ffn 128, 2 stages of 1 layer, 4 experts top-2;
427,840 parameters) from ``init_params(cfg, SEED)``, run by JAX on the
CPU:

- ``tokens``: ``[2, 512]`` seeded ids; ``logits_{float32,bfloat16}_{dense,
  ring}`` (``[2, 512, 16]`` float32), ``aux_...`` and ``routes_...`` (the
  experts each token went to, ``[layers, 2, 512, experts]`` booleans, from
  ``topk_gating``): the forward without a mesh (dense attention) and on
  ``single_device_mesh()`` (the ring path);
- ``train_tokens``, ``train_labels``, ``train_mask`` (``[2, 128]``, about
  10% of the mask off): one batch, three steps of ``make_train_step(cfg,
  single_device_mesh(), learning_rate=LR)`` in each dtype from the same
  weights: ``losses_<dtype>`` (3), ``grad_norm_<dtype>`` (the first step's
  gradient L2 norm a leaf), ``leaf_sum_<dtype>`` and ``leaf_abs_sum_<dtype>``
  (each leaf after the steps), ``update_sum_<dtype>`` and
  ``update_abs_sum_<dtype>`` (of the leaf after the steps less the leaf
  before them); leaves in the order of ``leaf_names``.

The port's test on the card (``tests/test_torch_cuda.py``) and
``chip_smoke.py`` phase 31 hold the card to it.

Run from the repo root (JAX on the CPU, ~30 s):
    python tests/fixtures/make_tagger_fixture.py
"""
import os
import sys

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
OUT = os.path.join(HERE, "tagger_io.npz")
SEED = 0                 # init_params
DATA_SEED = 17           # tokens, labels, mask
FWD_SHAPE = (2, 512)
TRAIN_SHAPE = (2, 128)
LR = 1e-3
STEPS = 3


def leaf_names(params) -> list:
    """``embed``, ``head``, ``ln_f`` and ``stages.<leaf>``, sorted: the
    order of the npz's per-leaf arrays."""
    names = [k for k in params if k != "stages"]
    names += [f"stages.{k}" for k in params["stages"]]
    return sorted(names)


def leaf(params, name: str):
    if name.startswith("stages."):
        return params["stages"][name[len("stages."):]]
    return params[name]


def batches(vocab: int, tags: int):
    """The forward's tokens and the train batch, from ``DATA_SEED``."""
    rng = np.random.default_rng(DATA_SEED)
    tokens = rng.integers(0, vocab, FWD_SHAPE).astype(np.int32)
    train_tokens = rng.integers(0, vocab, TRAIN_SHAPE).astype(np.int32)
    train_labels = rng.integers(0, tags, TRAIN_SHAPE).astype(np.int32)
    train_mask = rng.random(TRAIN_SHAPE) < 0.9
    return tokens, train_tokens, train_labels, train_mask


def main():
    sys.path.insert(0, os.path.dirname(os.path.dirname(HERE)))
    import jax
    import jax.numpy as jnp

    jax.config.update("jax_platforms", "cpu")
    from synapseml_tpu.dl import tagger
    from synapseml_tpu.parallel import moe
    from synapseml_tpu.parallel.mesh import single_device_mesh

    routes = []
    topk_gating = moe.topk_gating

    def recorded(gate_logits, top_k):
        gates = topk_gating(gate_logits, top_k)
        jax.debug.callback(lambda g: routes.append(np.asarray(g) > 0),
                           gates, ordered=True)
        return gates

    out = {"lr": np.float32(LR), "seed": np.int32(SEED),
           "jax_version": np.array(jax.__version__)}
    base = tagger.TaggerConfig()
    p0 = tagger.init_params(base, SEED)
    names = leaf_names(p0)
    out["leaf_names"] = np.array(names)
    tokens, tt, tl, tm = batches(base.vocab_size, base.num_tags)
    out.update(tokens=tokens, train_tokens=tt, train_labels=tl,
               train_mask=tm)
    mesh = single_device_mesh()
    for dname, dtype in (("float32", jnp.float32),
                         ("bfloat16", jnp.bfloat16)):
        cfg = tagger.TaggerConfig(dtype=dtype)
        params = jax.tree_util.tree_map(jnp.asarray, p0)
        for path, m in (("dense", None), ("ring", mesh)):
            routes.clear()
            moe.topk_gating = recorded
            try:
                logits, aux = jax.jit(tagger.make_apply(cfg, m))(params,
                                                                 tokens)
                jax.effects_barrier()
            finally:
                moe.topk_gating = topk_gating
            out[f"logits_{dname}_{path}"] = np.asarray(logits, np.float32)
            out[f"aux_{dname}_{path}"] = np.float32(aux)
            out[f"routes_{dname}_{path}"] = np.stack(routes)
        apply = tagger.make_apply(cfg, mesh)

        def loss_fn(p):
            logits, aux = apply(p, tt)
            return tagger.tagging_loss(logits, tl, tm, aux)

        grads = jax.jit(jax.grad(loss_fn))(params)
        out[f"grad_norm_{dname}"] = np.array(
            [np.linalg.norm(np.asarray(leaf(grads, n), np.float64))
             for n in names], np.float32)
        step, init_state, _ = tagger.make_train_step(cfg, mesh,
                                                     learning_rate=LR)
        params, opt_state = init_state(SEED)
        losses = []
        for _ in range(STEPS):
            params, opt_state, loss = step(params, opt_state, tt, tl, tm)
            losses.append(float(loss))
        out[f"losses_{dname}"] = np.array(losses, np.float32)
        after = jax.tree_util.tree_map(np.asarray, params)
        for key, fn in (("leaf_sum", lambda n: leaf(after, n)),
                        ("leaf_abs_sum", lambda n: np.abs(leaf(after, n))),
                        ("update_sum",
                         lambda n: leaf(after, n) - leaf(p0, n)),
                        ("update_abs_sum",
                         lambda n: np.abs(leaf(after, n) - leaf(p0, n)))):
            out[f"{key}_{dname}"] = np.array(
                [fn(n).astype(np.float64).sum() for n in names])
        print(f"{dname}: losses {losses}")
    np.savez(OUT, **out)
    print(f"wrote {OUT} ({os.path.getsize(OUT)} bytes)")


if __name__ == "__main__":
    main()

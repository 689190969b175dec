"""Generate ``tests/fixtures/tagger_sp_io.npz``: the sequence tagger at its
default width trained over sequence-parallel meshes, recorded by the JAX
package.

``synapseml_tpu/dl/tagger.py``'s ``TaggerConfig(dtype=float32)`` (vocab
4,096, 16 tags, d_model 64, 4 heads of 16, ffn 128, 2 stages of 1 layer,
4 experts top-2; 427,840 parameters) from ``init_params(cfg, SEED)``, run
by JAX on the CPU over ``build_mesh(jax.devices()[:4], want=...)`` for
``{"sp": 4}`` (``sp4``) and ``{"dp": 2, "sp": 2}`` (``dp2_sp2``), with
ring and with Ulysses attention:

- ``tokens``, ``labels``, ``mask``: one ``[4, 512]`` global batch (about
  10% of the mask off), from ``DATA_SEED``;
- ``logits_<mesh>_<attention>`` (``[4, 512, 16]`` float32) and
  ``aux_<mesh>_<attention>``: ``make_apply(cfg, mesh)``'s forward of the
  batch's tokens from the initial weights;
- ``losses_<mesh>_<attention>``: three steps of ``make_train_step(cfg,
  mesh, learning_rate=LR)`` on the batch; ``leaf_sum_...``,
  ``leaf_abs_sum_...``, ``update_sum_...`` and ``update_abs_sum_...``:
  each leaf after the steps, and it less the leaf before them, summed in
  float64, leaves in the order of ``leaf_names``.

``chip_smoke.py`` phase 42 and ``tests/test_torch_cuda.py`` hold the
port's ranks on the card to it.

Run from the repo root (JAX on 4 of 8 virtual CPU devices, ~40 s):
    python tests/fixtures/make_tagger_sp_fixture.py
"""
import os
import sys

os.environ["JAX_PLATFORMS"] = "cpu"
os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "")
                           + " --xla_force_host_platform_device_count=8")

import numpy as np  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
OUT = os.path.join(HERE, "tagger_sp_io.npz")
SEED = 0                 # init_params
DATA_SEED = 42           # tokens, labels, mask
SHAPE = (4, 512)
LR = 1e-3
STEPS = 3
MESHES = {"sp4": {"sp": 4}, "dp2_sp2": {"dp": 2, "sp": 2}}
ATTENTION = ("ring", "ulysses")


def leaf_names(params) -> list:
    """``embed``, ``head``, ``ln_f`` and ``stages.<leaf>``, sorted."""
    names = [k for k in params if k != "stages"]
    names += [f"stages.{k}" for k in params["stages"]]
    return sorted(names)


def leaf(params, name: str):
    if name.startswith("stages."):
        return params["stages"][name[len("stages."):]]
    return params[name]


def batch(vocab: int, tags: int):
    rng = np.random.default_rng(DATA_SEED)
    tokens = rng.integers(0, vocab, SHAPE).astype(np.int32)
    labels = rng.integers(0, tags, SHAPE).astype(np.int32)
    mask = rng.random(SHAPE) < 0.9
    return tokens, labels, mask


def main():
    sys.path.insert(0, os.path.dirname(os.path.dirname(HERE)))
    import jax
    import jax.numpy as jnp

    jax.config.update("jax_platforms", "cpu")
    from synapseml_tpu.dl import tagger
    from synapseml_tpu.parallel.mesh import build_mesh

    devices = jax.devices()
    assert len(devices) >= 4, "needs 4 CPU devices (XLA_FLAGS)"
    out = {"lr": np.float32(LR), "seed": np.int32(SEED),
           "jax_version": np.array(jax.__version__)}
    p0 = tagger.init_params(tagger.TaggerConfig(), SEED)
    names = leaf_names(p0)
    out["leaf_names"] = np.array(names)
    cfg0 = tagger.TaggerConfig()
    tokens, labels, mask = batch(cfg0.vocab_size, cfg0.num_tags)
    out.update(tokens=tokens, labels=labels, mask=mask)
    for mname, want in MESHES.items():
        mesh = build_mesh(devices[:4], want=want)
        for attention in ATTENTION:
            key = f"{mname}_{attention}"
            cfg = tagger.TaggerConfig(dtype=jnp.float32, attention=attention)
            params = jax.tree_util.tree_map(jnp.asarray, p0)
            logits, aux = jax.jit(tagger.make_apply(cfg, mesh))(params,
                                                                tokens)
            out[f"logits_{key}"] = np.asarray(logits, np.float32)
            out[f"aux_{key}"] = np.float32(aux)
            step, init_state, _ = tagger.make_train_step(cfg, mesh,
                                                         learning_rate=LR)
            params, opt_state = init_state(SEED)
            losses = []
            for _ in range(STEPS):
                params, opt_state, loss = step(params, opt_state, tokens,
                                               labels, mask)
                losses.append(float(loss))
            out[f"losses_{key}"] = np.array(losses, np.float32)
            after = jax.tree_util.tree_map(np.asarray, params)
            for stat, fn in (
                    ("leaf_sum", lambda n: leaf(after, n)),
                    ("leaf_abs_sum", lambda n: np.abs(leaf(after, n))),
                    ("update_sum", lambda n: leaf(after, n) - leaf(p0, n)),
                    ("update_abs_sum",
                     lambda n: np.abs(leaf(after, n) - leaf(p0, n)))):
                out[f"{stat}_{key}"] = np.array(
                    [fn(n).astype(np.float64).sum() for n in names])
            print(f"{key}: losses {losses} aux {float(aux)}")
    np.savez_compressed(OUT, **out)
    print(f"wrote {OUT} ({os.path.getsize(OUT)} bytes)")


if __name__ == "__main__":
    main()

"""How far the port's tagger drifts from the JAX package's after AdamW
updates, on one rank: the reason phase 42 holds the later losses of the
sequence-parallel fixture (``tagger_sp_io.npz``) at 1e-3 and only the
first at 1e-5.

On the fixture's 4 x 512 batch at ``TaggerConfig(dtype=float32)`` width,
the port (one rank, ring attention, on the CPU) and the JAX package (one
device, ``single_device_mesh()``) start from the same ``init_params``.
This script prints:

1. both packages' three losses and their relative gaps;
2. for each leaf, the largest gap of the first step's gradients over the
   leaf's largest |gradient|, the largest gap of the first update in lr,
   and how many parameters' first updates differ by more than 0.1·lr,
   with the |gradient| of each package at the largest gap (Adam's first
   step moves a parameter by ``lr · g / (|g| + eps)``, so a gradient
   within rounding of 0 can move it either way by up to lr).

Run from the repo root (JAX and the port on the CPU, ~20 s):
    python tests/fixtures/witness_tagger_drift.py
"""
import os
import sys

os.environ["JAX_PLATFORMS"] = "cpu"

import numpy as np  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
LR = 1e-3


def main():
    sys.path.insert(0, os.path.dirname(os.path.dirname(HERE)))
    sys.path.insert(0, HERE)
    import jax
    import jax.numpy as jnp
    import torch

    jax.config.update("jax_platforms", "cpu")
    import make_tagger_sp_fixture as fx
    from synapseml_tpu.dl import tagger as jt
    from synapseml_tpu.parallel.mesh import single_device_mesh
    from synapseml_tpu_torch.dl import tagger as pt

    io = np.load(os.path.join(HERE, "tagger_sp_io.npz"))
    tokens, labels, mask = io["tokens"], io["labels"], io["mask"]
    jcfg = jt.TaggerConfig(dtype=jnp.float32, attention="ring")
    mesh = single_device_mesh()
    p0 = jt.init_params(jcfg, int(io["seed"]))
    apply = jt.make_apply(jcfg, mesh)

    def loss(p):
        logits, aux = apply(p, tokens)
        return jt.tagging_loss(logits, labels, mask, aux)

    jgrads = jax.jit(jax.grad(loss))(jax.tree_util.tree_map(jnp.asarray, p0))
    step, init_state, _ = jt.make_train_step(jcfg, mesh, learning_rate=LR)
    jp, jo = init_state(int(io["seed"]))
    jlosses, jfirst = [], None
    for _ in range(3):
        jp, jo, value = step(jp, jo, tokens, labels, mask)
        jlosses.append(float(value))
        if jfirst is None:
            jfirst = jax.tree_util.tree_map(np.asarray, jp)

    pcfg = pt.TaggerConfig(dtype=torch.float32, attention="ring")
    pstep, pinit, place = pt.make_train_step(pcfg, learning_rate=LR,
                                             device="cpu")
    params, opt = pinit(int(io["seed"]))
    batch = [place(a) for a in (tokens, labels, mask)]
    plosses, pgrads, pfirst = [], None, None
    for _ in range(3):
        params, opt, value = pstep(params, opt, *batch)
        plosses.append(float(value))
        if pgrads is None:
            pgrads = {n: p.grad.numpy().copy()
                      for n, p in params.named_parameters()}
            pfirst = {n: p.detach().numpy().copy()
                      for n, p in params.named_parameters()}
    print("losses port", plosses)
    print("losses jax ", jlosses)
    print("relative gaps", [abs(a - b) / abs(b)
                            for a, b in zip(plosses, jlosses)])
    moved = 0
    for name in fx.leaf_names(p0):
        jg = np.asarray(fx.leaf(jgrads, name))
        gap_u = np.abs((fx.leaf(jfirst, name) - fx.leaf(p0, name))
                       - (pfirst[name] - fx.leaf(p0, name)))
        at = int(np.argmax(gap_u))
        over = int((gap_u > 0.1 * LR).sum())
        moved += over
        print(f"{name}: grad gap {np.abs(pgrads[name] - jg).max() / np.abs(jg).max():.3e}"
              f" of the leaf's largest; first update gap {gap_u.max() / LR:.4f}"
              f" lr; {over} of {gap_u.size} above 0.1 lr; |g| there"
              f" {abs(jg.flat[at]):.3e} (JAX), {abs(pgrads[name].flat[at]):.3e}"
              f" (port)")
    print(f"parameters whose first update differs by more than 0.1 lr: "
          f"{moved}")


if __name__ == "__main__":
    main()

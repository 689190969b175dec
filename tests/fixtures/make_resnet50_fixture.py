"""Generate the ResNet-50 224x224 logits fixture of the imported-ONNX path.

Runs the JAX package's ``import_model(zoo.resnet50(num_classes=1000))``
(seed 0, 224x224) on ``__graft_entry__.entry()``'s images
(``np.random.default_rng(0).standard_normal((8, 3, 224, 224))``) on the
CPU, jitted, twice:

- float32: ``graph.bind()`` on the float32 images;
- bf16: ``graph.bind(cast_dtype=bfloat16)`` on the images cast to bf16,
  exactly as ``entry()``'s forward runs it;

and writes ``resnet50_224_logits.npz`` with the two [8, 1000] logit arrays
(``logits_f32``; ``logits_bf16`` widened exactly to float32) and the JAX
version. The images and the weights are not stored: both come back from
their seeds (:func:`images`, ``zoo.resnet50``). The port's tests and
``chip_smoke.py`` hold the port's forward to these logits.

Run from the repo root:  python tests/fixtures/make_resnet50_fixture.py
"""
from __future__ import annotations

import os
import sys
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
OUT = os.path.join(HERE, "resnet50_224_logits.npz")
BATCH, IMAGE, CLASSES, SEED = 8, 224, 1000, 0


def images(batch: int = BATCH) -> np.ndarray:
    """``entry()``'s images: the first ``batch`` of them."""
    return np.random.default_rng(0).standard_normal(
        (BATCH, 3, IMAGE, IMAGE)).astype(np.float32)[:batch]


def main() -> None:
    sys.path.insert(0, os.path.dirname(HERE))
    sys.path.insert(0, os.path.dirname(os.path.dirname(HERE)))
    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    import jax
    import jax.numpy as jnp

    jax.config.update("jax_platforms", "cpu")
    from synapseml_tpu.onnx import import_model, zoo

    start = time.perf_counter()
    graph = import_model(zoo.resnet50(num_classes=CLASSES, image_size=IMAGE,
                                      seed=SEED))
    x = images()
    f32 = jax.jit(lambda im: graph.bind()(im)[0])
    bf16_fwd = graph.bind(cast_dtype=jnp.bfloat16)
    bf16 = jax.jit(lambda im: bf16_fwd(im.astype(jnp.bfloat16))[0])
    logits_f32 = np.asarray(f32(x))
    logits_bf16 = np.asarray(bf16(x)).astype(np.float32)
    assert logits_f32.shape == logits_bf16.shape == (BATCH, CLASSES)
    assert np.isfinite(logits_f32).all() and np.isfinite(logits_bf16).all()
    np.savez_compressed(OUT, logits_f32=logits_f32, logits_bf16=logits_bf16,
                        jax_version=np.asarray(jax.__version__))
    span = float(logits_f32.max() - logits_f32.min())
    print(f"wrote {OUT} in {time.perf_counter() - start:.1f} s; float32 "
          f"span {span:.3f}, bf16 max gap "
          f"{np.abs(logits_bf16 - logits_f32).max() / span:.4f} of it")


if __name__ == "__main__":
    main()

"""Generate the VAE encoder fixture, ``vae_encoder_io.npz``.

Runs the JAX package on the CPU, eagerly (its bound forward): Stable
Diffusion v1's VAE encoder at its published width (``vae_encoder.FULL``,
34.2 M parameters from ``vae_encoder.WEIGHT_SEED``; the graph built with
the JAX package's ``GraphBuilder``) over ``vae_encoder.FIXTURE_IMAGES``
images of ``vae_encoder.images`` at 256 x 256, in one batch. Stores the
sampled ``latent``, ``mean``, the clipped ``logvar`` and the draw ``eps``,
the largest |value| of each (``span_<name>``), the seeds and the jax
version; the images and the weights come back from their seeds.

Run from the repo root:  python tests/fixtures/make_vae_encoder_fixture.py
"""
from __future__ import annotations

import os
import sys
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)
import vae_encoder  # noqa: E402


def main() -> None:
    sys.path.insert(0, os.path.dirname(os.path.dirname(HERE)))
    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    import jax
    import jax.numpy as jnp

    jax.config.update("jax_platforms", "cpu")
    from synapseml_tpu.onnx import GraphBuilder, import_model

    start = time.perf_counter()
    fn = import_model(vae_encoder.encoder_graph(GraphBuilder)).bind()
    images = vae_encoder.images(vae_encoder.FIXTURE_IMAGES,
                                vae_encoder.FIXTURE_SIZE)
    out = {k: np.asarray(v) for k, v in zip(vae_encoder.OUTPUTS,
                                             fn(jnp.asarray(images)))}
    side = vae_encoder.FIXTURE_SIZE // 8
    for k, v in out.items():
        assert v.shape == (len(images), 4, side, side), (k, v.shape)
        assert np.isfinite(v).all(), k
    np.savez_compressed(
        vae_encoder.OUT, **out,
        **{f"span_{k}": np.float64(np.abs(v).max()) for k, v in out.items()},
        weight_seed=np.int64(vae_encoder.WEIGHT_SEED),
        image_seed=np.int64(vae_encoder.IMAGE_SEED),
        jax_version=np.asarray(jax.__version__))
    print(f"wrote {vae_encoder.OUT} ({os.path.getsize(vae_encoder.OUT)} "
          f"bytes) in {time.perf_counter() - start:.1f} s; |latent| <= "
          f"{np.abs(out['latent']).max():.4f}")


if __name__ == "__main__":
    main()

"""Generate the VAE decoder fixture, ``vae_decoder_io.npz``.

Runs the JAX package on the CPU, eagerly (its bound forward): Stable
Diffusion v1's VAE decoder at its published width (``vae_decoder.FULL``,
49.5 M parameters from ``vae_decoder.WEIGHT_SEED``; the graph built with
the JAX package's ``GraphBuilder``) over ``vae_decoder.FIXTURE_LATENTS``
latents of ``vae_decoder.latents`` at 32 x 32, one at a time, into
256 x 256 images. Stores the images, the latents, the largest |value|
(``span``), the seeds and the jax version; the weights come back from
their seed.

Run from the repo root:  python tests/fixtures/make_vae_fixture.py
"""
from __future__ import annotations

import os
import sys
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)
import vae_decoder  # noqa: E402


def main() -> None:
    sys.path.insert(0, os.path.dirname(os.path.dirname(HERE)))
    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    import jax
    import jax.numpy as jnp

    jax.config.update("jax_platforms", "cpu")
    from synapseml_tpu.onnx import GraphBuilder, import_model

    start = time.perf_counter()
    fn = import_model(vae_decoder.decoder_graph(GraphBuilder)).bind()
    lat = vae_decoder.latents(vae_decoder.FIXTURE_LATENTS,
                              vae_decoder.FIXTURE_SIZE)
    image = np.concatenate([np.asarray(fn(jnp.asarray(lat[i:i + 1]))[0])
                            for i in range(len(lat))])
    assert image.shape == (len(lat), 3, 8 * vae_decoder.FIXTURE_SIZE,
                           8 * vae_decoder.FIXTURE_SIZE)
    assert np.isfinite(image).all()
    np.savez_compressed(
        vae_decoder.OUT, image=image, latents=lat,
        span=np.float64(np.abs(image).max()),
        weight_seed=np.int64(vae_decoder.WEIGHT_SEED),
        latent_seed=np.int64(vae_decoder.LATENT_SEED),
        jax_version=np.asarray(jax.__version__))
    print(f"wrote {vae_decoder.OUT} ({os.path.getsize(vae_decoder.OUT)} "
          f"bytes) in {time.perf_counter() - start:.1f} s; |image| <= "
          f"{np.abs(image).max():.4f}")


if __name__ == "__main__":
    main()

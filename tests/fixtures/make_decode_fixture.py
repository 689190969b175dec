"""Generate ``tests/fixtures/decode_streams.npz``: the decode scheduler's
greedy token streams on ``zoo.tiny_decoder()``, recorded by the JAX
package's ``synapseml_tpu.runtime.decode.DecodeScheduler`` on the CPU.

The sequences, the geometry and the file's arrays are those of
``tests/fixtures/decode_streams.py``, whose :func:`record` runs them
through either package; this file adds only the JAX run.

Run from the repo root (JAX on the CPU, ~20 s):
    python tests/fixtures/make_decode_fixture.py
"""
import os
import sys

import numpy as np

from decode_streams import OUT, maker, record

HERE = os.path.dirname(os.path.abspath(__file__))

def main() -> None:
    import jax

    jax.config.update("jax_platforms", "cpu")
    sys.path.insert(0, os.path.dirname(os.path.dirname(HERE)))
    from synapseml_tpu.onnx import zoo
    from synapseml_tpu.onnx.importer import import_model
    from synapseml_tpu.runtime import telemetry
    from synapseml_tpu.runtime.decode import DecodeScheduler
    from synapseml_tpu.runtime.kvcache import PagedKVCache

    graph = import_model(zoo.tiny_decoder())
    out = record(maker(DecodeScheduler, PagedKVCache, graph), telemetry)
    assert (out["evict"] == out["evict_solo"]).all()
    assert out["evictions"] >= 1 and out["recomputes"] >= 1
    out["jax_version"] = np.array(jax.__version__)
    np.savez_compressed(OUT, **out)
    print(f"wrote {OUT}: " + ", ".join(
        f"{k} {v.shape}" for k, v in out.items()))


if __name__ == "__main__":
    main()

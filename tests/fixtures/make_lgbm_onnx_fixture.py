"""Generate the JAX package's ONNX scores of the Adult fixture model.

Loads ``lgbm_adult_100x31.txt`` (100 trees, 31 leaves, 14 features) with
the JAX package, converts it with its ``convert_lightgbm`` and scores the
1,024 rows of ``lgbm_adult_100x31_io.npz`` through its ``ONNXModel``
(``feed_dict={"input": "features"}``, ``mini_batch_size=128``, float32) on
the CPU, and writes ``lgbm_adult_100x31_onnx.npz``: the ``label`` output
(int8: the labels are 0 and 1) and the ``probabilities`` output (float32,
[1024, 2]), with the jax version. The port's card run holds its own
converted model to these without importing JAX (``chip_smoke.py`` phase
30).

Run from the repo root:  python tests/fixtures/make_lgbm_onnx_fixture.py
"""
from __future__ import annotations

import os
import sys

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(os.path.dirname(HERE)))
os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

from synapseml_tpu.data.table import Table  # noqa: E402
from synapseml_tpu.gbdt.boosting import Booster  # noqa: E402
from synapseml_tpu.onnx import ONNXModel, convert_lightgbm  # noqa: E402

MODEL = os.path.join(HERE, "lgbm_adult_100x31.txt")
IO = os.path.join(HERE, "lgbm_adult_100x31_io.npz")
OUT = os.path.join(HERE, "lgbm_adult_100x31_onnx.npz")


def main() -> None:
    with open(MODEL) as fh:
        booster = Booster.load_string(fh.read())
    x = np.load(IO)["x"]
    scorer = ONNXModel(model_bytes=convert_lightgbm(booster),
                       feed_dict={"input": "features"}, mini_batch_size=128)
    out = scorer.transform(Table({"features": x}))
    label = np.asarray(out["label"])
    probs = np.asarray(out["probabilities"], np.float32)
    assert set(np.unique(label)) <= {0, 1} and probs.shape == (len(x), 2)
    np.savez_compressed(OUT, label=label.astype(np.int8),
                        probabilities=probs, jax_version=jax.__version__)
    print(f"wrote {OUT} ({os.path.getsize(OUT)} bytes): {len(x)} rows, "
          f"{int(label.sum())} positive")


if __name__ == "__main__":
    main()

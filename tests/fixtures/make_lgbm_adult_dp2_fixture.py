"""Generate the data-parallel Adult fixture: the JAX package's fit on a
2-device CPU mesh.

Trains the Adult-census configuration of ``make_lgbm_adult_fixture.py``
(``bench.py`` ``bench_gbdt_train``: 32,561 x 14 seeded rows; the
BoostParams of ``LightGBMClassifier(num_iterations=100, num_leaves=31,
learning_rate=0.1)``) through ``boosting.train(..., mesh=Mesh(2 CPU
devices, ("dp",)))``, the reference's data-parallel path, and writes:

- ``lgbm_adult_100x31_dp2.txt``: the model in LightGBM's native text
  format;
- ``lgbm_adult_100x31_dp2_io.npz``: the 1,024 seeded query rows of the
  single-device fixture, the raw margins and probabilities of the model
  LOADED back from the text file, its training logloss over the 32,561
  rows (float64, as ``chip_smoke.py`` computes it), the BoostParams as
  JSON (``params``) and the jax version.

The XLA device count is set before jax is imported. Run from the repo
root:  python tests/fixtures/make_lgbm_adult_dp2_fixture.py  (~20 s)
"""
from __future__ import annotations

import dataclasses
import json
import os
import sys
import time

os.environ["JAX_PLATFORMS"] = "cpu"
os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "")
                           + " --xla_force_host_platform_device_count=2")

import numpy as np  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(os.path.dirname(HERE)))
sys.path.insert(0, HERE)

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

from jax.sharding import Mesh  # noqa: E402

from make_lgbm_adult_fixture import adult_rows, query_rows  # noqa: E402
from synapseml_tpu.gbdt.boosting import Booster, train  # noqa: E402
from synapseml_tpu.gbdt.estimators import LightGBMClassifier  # noqa: E402

MODEL = os.path.join(HERE, "lgbm_adult_100x31_dp2.txt")
IO = os.path.join(HERE, "lgbm_adult_100x31_dp2_io.npz")


def logloss(raw: np.ndarray, y: np.ndarray) -> float:
    p = 1.0 / (1.0 + np.exp(-raw.astype(np.float64)))
    p = np.clip(p, 1e-15, 1 - 1e-15)
    return float(-(y * np.log(p) + (1 - y) * np.log(1 - p)).mean())


def main():
    devices = jax.devices()
    assert len(devices) >= 2, "needs 2 CPU devices (XLA_FLAGS)"
    x, y = adult_rows()
    p = LightGBMClassifier(num_iterations=100, num_leaves=31,
                           learning_rate=0.1)._boost_params("binary")
    t0 = time.time()
    booster = train(p, x, y.astype(np.float64),
                    mesh=Mesh(np.asarray(devices[:2]), ("dp",)))
    print(f"fit {time.time() - t0:.1f}s, trees={booster.num_trees}")
    with open(MODEL, "w") as fh:
        fh.write(booster.save_string())
    with open(MODEL) as fh:
        loaded = Booster.load_string(fh.read())
    q = query_rows()
    np.savez(IO, x=q, raw=loaded.predict_raw(q), prob=loaded.predict(q),
             train_logloss=logloss(loaded.predict_raw(x), y),
             params=json.dumps(dataclasses.asdict(p)),
             jax_version=jax.__version__)
    print(f"wrote {MODEL} and {IO}")


if __name__ == "__main__":
    main()

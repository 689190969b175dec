"""Generate the sampled Adult-census GBDT fixture: the repo's Adult
configuration with row bagging and feature sampling, trained by the JAX
package on the CPU.

The fit is ``make_lgbm_adult_fixture.py``'s (32,561 x 14 seeded rows,
``LightGBMClassifier(num_iterations=100, num_leaves=31,
learning_rate=0.1)``) with ``bagging_fraction=0.8, bagging_freq=1,
feature_fraction=0.8, seed=0``: every tree's rows and features are drawn
from ``jax.random``'s threefry stream, which the PyTorch port reproduces
bit for bit. It writes:

- ``lgbm_adult_100x31_bag08_ff08.txt``: the model in LightGBM's native
  text format;
- ``lgbm_adult_100x31_bag08_ff08_io.npz``: the same 1,024 query rows as
  the unsampled fixture, the JAX package's ``predict_raw`` and ``predict``
  outputs for them from the model loaded back from the text file, and the
  jax version and ``jax_threefry_partitionable`` setting that drew the
  masks (the bits depend on both).

Run from the repo root:  python tests/fixtures/make_lgbm_adult_sampled_fixture.py
"""
from __future__ import annotations

import os
import sys
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(os.path.dirname(HERE)))
sys.path.insert(0, HERE)
os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

from make_lgbm_adult_fixture import adult_rows, query_rows  # noqa: E402
from synapseml_tpu.data.table import Table  # noqa: E402
from synapseml_tpu.gbdt.estimators import (  # noqa: E402
    LightGBMClassificationModel, LightGBMClassifier)

MODEL = os.path.join(HERE, "lgbm_adult_100x31_bag08_ff08.txt")
IO = os.path.join(HERE, "lgbm_adult_100x31_bag08_ff08_io.npz")
PARAMS = dict(num_iterations=100, num_leaves=31, learning_rate=0.1,
              bagging_fraction=0.8, bagging_freq=1, feature_fraction=0.8,
              seed=0)


def main():
    x, y = adult_rows()
    t0 = time.time()
    model = LightGBMClassifier(**PARAMS).fit(Table({"features": x,
                                                    "label": y}))
    print(f"fit {time.time() - t0:.1f}s, trees={model.booster.num_trees}")
    model.save_native_model(MODEL)
    loaded = LightGBMClassificationModel.load_native_model(MODEL)
    q = query_rows()
    np.savez(IO, x=q,
             raw=loaded.booster.predict_raw(q),
             prob=loaded.booster.predict(q),
             jax_version=np.array(jax.__version__),
             jax_threefry_partitionable=np.array(
                 bool(jax.config.jax_threefry_partitionable)))
    print(f"wrote {MODEL} and {IO}")


if __name__ == "__main__":
    main()

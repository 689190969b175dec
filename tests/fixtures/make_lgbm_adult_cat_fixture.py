"""Generate the categorical Adult-census GBDT fixture, trained by the JAX
package on the CPU.

The rows have the UCI Adult census layout: 32,561 rows of 14 columns, 6
numeric and 8 categorical (columns 1, 3, 5, 6, 7, 8, 9 and 13, with
Adult's category counts 9, 16, 7, 15, 6, 5, 2 and 42), seeded, with 2% NaN
in the occupation column (6, Adult's "?"). The fit is
``LightGBMClassifier(num_iterations=100, num_leaves=31, learning_rate=0.1,
categorical_slot_indexes=[1, 3, 5, 6, 7, 8, 9, 13])``. It writes:

- ``lgbm_adult_cat_100x31.txt``: the model in LightGBM's native text
  format;
- ``lgbm_adult_cat_100x31_io.npz``: 1,024 seeded query rows (NaN and
  categories unseen in training among them), the JAX package's
  ``predict_raw`` and ``predict`` outputs for them from the model loaded
  back from the text file, and the jax version.

``adult_cat_rows`` and ``query_rows`` import no JAX, so ``chip_smoke.py``
and the tests make the same rows from them.

Run from the repo root:  python tests/fixtures/make_lgbm_adult_cat_fixture.py
"""
from __future__ import annotations

import os
import sys
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
MODEL = os.path.join(HERE, "lgbm_adult_cat_100x31.txt")
IO = os.path.join(HERE, "lgbm_adult_cat_100x31_io.npz")
CARD = {1: 9, 3: 16, 5: 7, 6: 15, 7: 6, 8: 5, 9: 2, 13: 42}  # UCI Adult
CATEGORICAL = sorted(CARD)
PARAMS = dict(num_iterations=100, num_leaves=31, learning_rate=0.1,
              categorical_slot_indexes=CATEGORICAL)


def adult_cat_rows(n=32561, seed=0):
    """Seeded rows of the Adult layout and a binary label."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, 14)).astype(np.float32)
    for j, c in CARD.items():
        x[:, j] = rng.integers(0, c, size=n)
    x[rng.random(n) < 0.02, 6] = np.nan             # occupation "?"
    eff = {j: rng.normal(size=c) for j, c in CARD.items()}
    logit = x[:, 0] - 0.5 * x[:, 2] + sum(
        eff[j][np.nan_to_num(x[:, j]).astype(int)] for j in CARD)
    y = (logit + rng.normal(scale=0.5, size=n) > 0).astype(np.int32)
    return x, y


def query_rows(n=1024, seed=1):
    """Seeded rows of the same layout: every 16th row holds a category of
    column 3 unseen in training (16 to 20), every 20th a negative one in
    column 13, every 25th NaN in column 1."""
    x, _ = adult_cat_rows(n, seed)
    rows = np.arange(n)
    x[rows % 16 == 0, 3] = 16 + rows[rows % 16 == 0] % 5
    x[rows % 20 == 0, 13] = -1
    x[rows % 25 == 0, 1] = np.nan
    return x


def main():
    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    sys.path.insert(0, os.path.dirname(os.path.dirname(HERE)))
    import jax

    jax.config.update("jax_platforms", "cpu")
    from synapseml_tpu.data.table import Table
    from synapseml_tpu.gbdt.estimators import (
        LightGBMClassificationModel, LightGBMClassifier)

    x, y = adult_cat_rows()
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
             jax_version=np.array(jax.__version__))
    print(f"wrote {MODEL} and {IO}")


if __name__ == "__main__":
    main()

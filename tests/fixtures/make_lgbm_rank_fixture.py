"""Generate the lambdarank GBDT fixture, trained by the JAX package on the
CPU.

The rows have MSLR-WEB10K's width (Microsoft's learning-to-rank set:
136 features a document, graded relevance 0-4), seeded: 300 queries of
40-200 documents, 36,666 rows at ``SEED``. The query sizes (uniform, at
most 200) and the label mix (mostly 1 and 2) are this generator's, not
MSLR's; the query count is cut so that the fit runs on a CPU in a few
minutes.

``SEED`` is 1, not 0. At seed 0 the port's fit on the H100 and this
fit part at tree 74 (a split on another feature, gains 101.4911 and
101.4768): their first 74 trees agree but for the last bits of their
leaf values, and those roundings of the margins move a near-tied split.
``witness_rank_seed0.py`` shows it: continued one iteration from either
fit's first 74 trees, both packages grow that fit's tree 74. From there
the ensembles differ (mean margin gap 0.056 on the query rows), which a
check of the port against this fixture cannot tell from a fault.
At seed 1 the two fits differ only where one leaf's rows split alike at
two thresholds (empty bins between them). The fit is
``LightGBMRanker(num_iterations=100, num_leaves=31, learning_rate=0.1)``
(lambdarank, NDCG truncated at ``max_position=30``). It writes:

- ``lgbm_rank_mslr136_100x31.txt``: the model in LightGBM's native text
  format;
- ``lgbm_rank_mslr136_100x31_io.npz``: the JAX package's ``predict_raw``
  of the model loaded back from the text file on the query rows
  (``rank_rows(QUERY_QUERIES, seed=QUERY_SEED)``), the mean NDCG@30 of its
  margins on the training rows (``rank_rows(seed=SEED)``), and the jax
  version. The rows themselves are not stored: ``rank_rows`` makes them
  again from the seed.

``rank_rows`` imports no JAX, so ``chip_smoke.py`` and the tests make the
same rows from it.

Run from the repo root:  python tests/fixtures/make_lgbm_rank_fixture.py
"""
from __future__ import annotations

import os
import sys
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
MODEL = os.path.join(HERE, "lgbm_rank_mslr136_100x31.txt")
IO = os.path.join(HERE, "lgbm_rank_mslr136_100x31_io.npz")
PARAMS = dict(num_iterations=100, num_leaves=31, learning_rate=0.1)
MAX_POSITION = 30
SEED = 1
QUERY_QUERIES, QUERY_SEED = 100, 2


def rank_rows(n_queries=300, f=136, seed=0):      # MSLR-WEB10K's width
    """Seeded (features [N, f] float32, labels 0-4, query ids), each
    query's documents contiguous."""
    rng = np.random.default_rng(seed)
    sizes = rng.integers(40, 201, size=n_queries)  # documents a query
    group = np.repeat(np.arange(n_queries), sizes)
    x = rng.normal(size=(len(group), f)).astype(np.float32)
    t = (x[:, :8] @ rng.normal(size=8) + 0.5 * np.sin(2 * x[:, 8]) * x[:, 9]
         + rng.normal(scale=0.5, size=len(group)))
    label = np.clip(np.floor((t - t.mean()) / t.std() + 2), 0, 4)
    return x, label, group


def main():
    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    sys.path.insert(0, os.path.dirname(os.path.dirname(HERE)))
    import jax

    jax.config.update("jax_platforms", "cpu")
    from synapseml_tpu.data.table import Table
    from synapseml_tpu.gbdt.boosting import _ndcg_score
    from synapseml_tpu.gbdt.estimators import (
        LightGBMRanker, LightGBMRankerModel)

    x, label, group = rank_rows(seed=SEED)
    t0 = time.time()
    model = LightGBMRanker(**PARAMS).fit(
        Table({"features": x, "label": label, "query": group}))
    print(f"fit {time.time() - t0:.1f}s, rows={len(label)}, "
          f"trees={model.booster.num_trees}")
    model.save_native_model(MODEL)
    loaded = LightGBMRankerModel.load_native_model(MODEL)
    q, _, _ = rank_rows(QUERY_QUERIES, seed=QUERY_SEED)
    train_ndcg = _ndcg_score(loaded.booster.predict_raw(x), label, group,
                             MAX_POSITION)
    np.savez(IO, raw=loaded.booster.predict_raw(q),
             train_ndcg30=np.float64(train_ndcg),
             jax_version=np.array(jax.__version__))
    print(f"train NDCG@{MAX_POSITION} {train_ndcg:.6f}; wrote {MODEL} "
          f"and {IO}")


if __name__ == "__main__":
    main()

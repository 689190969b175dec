"""Why the ranker fixture is not trained at seed 0: a witness that the fits
part where their margins differ in the last bits, and not where the port's
gradient or grower differs from the reference's.

At seed 0 the port's lambdarank fit and the JAX package's (both on the
CPU here, the port's equal to its fit on the card) grow the same first K
trees, whose leaf values may still differ by a rounding, and then part at
tree K. This script:

1. fits both packages for ``N_ITER`` iterations at seed 0 and finds K, the
   first tree whose structure or thresholds differ;
2. cuts each fit to its first K trees and continues each cut model for one
   iteration (``init_model``) in BOTH packages. Each continuation grows
   tree K from the cut model's margins, as ``predict_raw`` gives them;
3. prints, for each of the four continuations, whether the new tree is the
   port's tree K, the reference's tree K, or neither, and how far the two
   cut models' margins are apart (rows that differ, largest gap in float32
   ulps).

The controls are a package continued from its own cut model: each must
grow its own tree K. The witness is the crossed pair: the reference
continued from the port's margins grows the port's tree K, and the port
continued from the reference's margins grows the reference's.

Run from the repo root (JAX and the port on the CPU, ~10 minutes):
    python tests/fixtures/witness_rank_seed0.py
"""
from __future__ import annotations

import dataclasses
import json
import os
import sys
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)
sys.path.insert(0, os.path.dirname(HERE))
sys.path.insert(0, os.path.dirname(os.path.dirname(HERE)))

from make_lgbm_rank_fixture import (  # noqa: E402
    MAX_POSITION, PARAMS, rank_rows)

SEED = 0
N_ITER = 80
TREE_FIELDS = ("trees_feature", "trees_threshold", "trees_left",
               "trees_right", "trees_value", "trees_cover", "trees_gain")
STRUCTURE = ("trees_feature", "trees_threshold", "trees_left", "trees_right")


def same_structure(a, i, b, j) -> bool:
    return all(np.array_equal(getattr(a, f)[i], getattr(b, f)[j])
               for f in STRUCTURE)


def cut(booster, k, booster_cls, params):
    """The first ``k`` trees of ``booster`` as a ``booster_cls`` (either
    package's Booster: their tree fields are the same)."""
    m = booster.trees_feature.shape[1]
    return booster_cls(
        **{f: np.array(getattr(booster, f)[:k, :m]) for f in TREE_FIELDS},
        tree_weights=np.array(booster.tree_weights[:k]), params=params,
        init_score=float(booster.init_score), num_class=1,
        num_features=booster.num_features)


def ulps(a: np.ndarray, b: np.ndarray) -> int:
    ia = a.astype(np.float32).view(np.int32).astype(np.int64)
    ib = b.astype(np.float32).view(np.int32).astype(np.int64)
    ia = np.where(ia < 0, -(ia & 0x7FFFFFFF), ia)
    ib = np.where(ib < 0, -(ib & 0x7FFFFFFF), ib)
    return int(np.abs(ia - ib).max())


def main():
    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    import jax

    jax.config.update("jax_platforms", "cpu")
    from synapseml_tpu.data.table import Table as JTable
    from synapseml_tpu.gbdt import boosting as jb
    from synapseml_tpu.gbdt.estimators import LightGBMRanker as JRanker
    from synapseml_tpu_torch.data.table import Table as TTable
    from synapseml_tpu_torch.gbdt import boosting as tb
    from synapseml_tpu_torch.gbdt.estimators import LightGBMRanker as TRanker

    x, label, group = rank_rows(seed=SEED)
    kw = dict(PARAMS, num_iterations=N_ITER, max_position=MAX_POSITION)
    t0 = time.time()
    ref = JRanker(**kw).fit(
        JTable({"features": x, "label": label, "query": group})).booster
    t_ref = time.time() - t0
    t0 = time.time()
    port = TRanker(**kw).fit(
        TTable({"features": x, "label": label, "query": group}),
        device="cpu").booster
    t_port = time.time() - t0
    same = [same_structure(ref, i, port, i) for i in range(N_ITER)]
    out = {"seed": SEED, "rows": len(label), "iterations": N_ITER,
           "fit_s": {"jax": t_ref, "port_cpu": t_port},
           "identical_trees": int(sum(same))}
    if all(same):
        out["first_difference"] = None
        print(json.dumps(out))
        return
    k = same.index(False)
    node = int(np.nonzero(
        (ref.trees_feature[k] != port.trees_feature[k])
        | (ref.trees_threshold[k] != port.trees_threshold[k]))[0][0])
    out["first_difference"] = {
        "tree": k, "node": node,
        "feature": {"jax": int(ref.trees_feature[k, node]),
                    "port": int(port.trees_feature[k, node])},
        "gain": {"jax": float(ref.trees_gain[k, node]),
                 "port": float(port.trees_gain[k, node])}}
    m = min(ref.trees_feature.shape[1], port.trees_feature.shape[1])
    out["leaf_values_differing_in_first_k_trees"] = int(
        (ref.trees_value[:k, :m] != port.trees_value[:k, :m]).sum())

    # both cut models in both packages, with each package's fit params
    jp = dataclasses.replace(ref.params, num_iterations=1)
    tp = dataclasses.replace(port.params, num_iterations=1)
    cuts = {"jax": ref, "port": port}
    margins = {}
    grown = {}
    for name, full in cuts.items():
        j_init = cut(full, k, jb.Booster, jp)
        t_init = cut(full, k, tb.Booster, tp)
        margins[name] = j_init.predict_raw(x)
        t_margins = t_init.predict_raw(x, device="cpu")
        out.setdefault("cut_margins_port_vs_jax_predict_max_gap", {})[name] = (
            float(np.abs(t_margins - margins[name]).max()))
        grown[("jax", name)] = jb.train(jp, x, label, None, group,
                                        init_model=j_init)
        grown[("port", name)] = tb.train(tp, x, label, None, group,
                                         init_model=t_init, device="cpu")
    diff = margins["jax"] != margins["port"]
    out["cut_margins"] = {
        "rows_differing": int(diff.sum()),
        "max_abs_gap": float(np.abs(margins["jax"] - margins["port"]).max()),
        "max_ulps": ulps(margins["jax"], margins["port"])}
    out["continuations"] = {}
    for (pkg, start), b in grown.items():
        assert b.num_trees == k + 1
        out["continuations"][f"{pkg} from {start}'s {k} trees"] = {
            "grows jax's tree K": same_structure(b, k, ref, k),
            "grows port's tree K": same_structure(b, k, port, k),
            "feature at node": int(b.trees_feature[k, node]),
            "gain at node": float(b.trees_gain[k, node])}
    print(json.dumps(out, indent=1))


if __name__ == "__main__":
    main()

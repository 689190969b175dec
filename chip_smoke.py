#!/usr/bin/env python3
"""Drive the PyTorch port on one NVIDIA GPU and check it end to end.

Run from the repo root:  python3 chip_smoke.py

Phases, each printed as one JSON line; any failed check exits non-zero
before the last line:

1. device  — requires CUDA, prints the card's name and power limit;
2. build   — builds every kernel in synapseml_tpu_torch/csrc with nvcc
   (one nvcc per source, all started together) and prints ptxas' lines;
3. kernel_vs_plain — each kernel against its plain PyTorch version at the
   shapes the main paths give it: the forest traversal (K2) on the card,
   bitwise, with the isolation forest's trees staged in several tiles;
   the histogram (K1) bitwise against its plain version run on the CPU
   from the same inputs (on the card ``index_add_`` adds with atomics, in
   no fixed order), on a bin index built in the call and on one given,
   with 90% of the rows in one bin and with one NaN grad; the card's bin
   index equal to the CPU's; five K1 launches bitwise identical;
4. main_path — LightGBMClassificationModel.load_native_model on the
   100-tree, 31-leaf Adult fixture and ``transform`` of 65,536 and
   1,048,576 rows on the card, with the kernels' launch counts read around
   the run, and the fixture's recorded JAX outputs matched;
5. iforest — IsolationForest(100 trees, 256 samples) fitted on the host
   from seeded 65,536 x 14 rows, scored on the card through the strict
   traversal, matched against the plain version on the CPU;
6. train   — the training path: LightGBMClassifier(100 iterations, 31
   leaves).fit on the 32,561 x 14 Adult rows on the card, with the
   kernels' launch counts and the bin index's builds (one a fit) read
   around the fit and ``transform``; the result held to the JAX-trained
   fixture (training logloss within 1e-4, margins on the fixture's rows
   within 1e-3); then a 3-class fit, an L2 regressor fit and an
   early-stopped fit, each on the card and on the CPU with the same port
   code;
7. train_sampled_adult — the same Adult fit with bagging_fraction=0.8,
   bagging_freq=1, feature_fraction=0.8 on the card, the kernels' counts
   and the per-tree masked indexes read around it, held tree by tree to
   the JAX-trained sampled fixture at the tolerances of phase 6;
8. train_modes_card_vs_cpu — goss (binary, L2 regression, 3 classes), rf,
   dart (uniform, weighted, xgboost_dart_mode, 3 classes) and pos/neg
   bagging, 20 iterations each, fitted on the card and on the CPU by the
   same port code: bitwise, GOSS binary and 3-class within the margin
   tolerance (a GOSS near-tie may flip a split);
9. train_categorical_adult — LightGBMClassifier(100 iterations, 31
   leaves, 8 categorical columns) on the categorical Adult rows (32,561 x
   14, UCI Adult's layout and category counts, 2% NaN occupation) on the
   card, held to the JAX-trained fixture at phase 6's tolerances; its
   first 30 iterations fitted on the card and on the CPU, bitwise;
10. train_ranker — LightGBMRanker(100 iterations, 31 leaves) on rows
   at MSLR-WEB10K's width (300 queries, 36,666 x 136, labels 0-4) on the
   card, held to the JAX-trained fixture (mean margin gap on its query
   rows within 1e-3, training NDCG@30 within 1e-3);
11. train_ranker_card_vs_cpu — rankers fitted on the card and on the CPU
   by the same port code (blocked and dense lambdarank, rank_xendcg,
   weights, GOSS, bagging with feature_fraction, early stopping on a
   grouped validation set), each bitwise or within 1e-4;
12. times   — kernel, plain-version and library-call times (CUDA events
   around calls queued behind a device-side spin, median of repeats after
   a warm-up; the inputs stay in L2), K1's host time a call, the
   kernels' bounds, the bin index's build time, the transform's rows/s,
   the fit's wall seconds and rows*iterations/s, a breakdown of one fit
   and the card's kernel time during one fit (torch.profiler); then the
   sampled fit's seconds, rows*iterations/s and kernel time, and the host
   time a tree's key stream and masks take; then the ranker fit's and the
   categorical fit's seconds and rows*iterations/s, the ranker fit's
   breakdown with the LambdaRank gradient as its own part and its device
   busy share, and the gradient's device ms at the fit's shape.

13. train_dp_adult — the Adult fit of phase 6 through
   ``boosting.train(mesh=)`` on two gloo ranks that share the card, each
   growing on its 16,281 rows (one launch of ``tests/torch_dp_worker.py``
   ranks, with a timeout): held to the JAX package's 2-device fixture at
   phase 6's tolerances, the two ranks' boosters bitwise equal, each
   rank's K1 launches and its validation tracker's K2 launches counted;
   the fit's seconds and rows*iterations/s beside the single-device fit's,
   and its reductions, their bytes and their synchronised seconds;
14. train_dp_card_vs_cpu — gbdt, bagging with feature_fraction, goss, rf,
   dart, 3 classes, lambdarank, L1, voting (top_k=2) and
   ``train_row_sharded`` (each rank its own rows) on two card ranks and on
   two CPU ranks of the same launch: bitwise;
15. train_nccl_one_rank — a one-rank NCCL group on the card trains
   bitwise what a one-rank gloo group does;
16. partitions_rendezvous_adult — the data plane: two worker processes
   sharing the card each stream their half of the Adult rows (3 and 4
   record batches, dicts and Tables) into
   ``data.partitions.fit_partitions(rendezvous=..., backend gloo)``,
   joining through a ``DriverRendezvous`` run here on loopback; routed to
   ``train_row_sharded``: both ranks' boosters bitwise equal and bitwise
   phase 13's, each rank's K1 and K2 launches counted, the rendezvous and
   fit seconds and the reductions reported;
17. partitions_gather_ranker — a lambdarank fit on the gather route
   (``row_sharded=False``), each rank numbering its queries from 0: two
   card ranks bitwise two CPU ranks of the same launch;
18. rendezvous_nccl_one_rank — a world of one joined through the
   rendezvous with ``backend="nccl"``: its row-sharded fit bitwise phase
   15's NCCL fit of the same rows;
19. launch_smoke — ``python -m synapseml_tpu_torch.parallel.launch`` on
   the card, single process: exits 0 and prints its accuracy.

Between phases 3 and 4: prng_card_vs_cpu (the threefry key stream on the
card equal to the CPU's, bitwise) and masked_index (K1 on a
feature_fraction index equal to K1 on a fresh index of the moved bins and
to the plain version, bitwise).

Then the kernel summary line, the ``nvidia-smi`` name/power line, and
last ``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import tempfile
import time
import types

import numpy as np
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
FIXTURE = os.path.join(HERE, "tests", "fixtures", "lgbm_adult_100x31.txt")
FIXTURE_IO = os.path.join(HERE, "tests", "fixtures",
                          "lgbm_adult_100x31_io.npz")
SAMPLED = os.path.join(HERE, "tests", "fixtures",
                       "lgbm_adult_100x31_bag08_ff08.txt")
SAMPLED_IO = os.path.join(HERE, "tests", "fixtures",
                          "lgbm_adult_100x31_bag08_ff08_io.npz")
SAMPLED_PARAMS = dict(bagging_fraction=0.8, bagging_freq=1,
                      feature_fraction=0.8, seed=0)
FIXTURES = os.path.join(HERE, "tests", "fixtures")
HBM_BYTES_PER_S = 3.35e12     # H100 SXM device memory
FP32_OPS_PER_S = 67e12        # H100 SXM float32 outside the tensor cores
N_MAIN, N_LARGE = 65_536, 1_048_576
PROB_ATOL = 1e-7              # only if numpy's exp differs from the fixture's
LOGLOSS_TOL = 1e-4            # training logloss, port fit vs JAX fixture
MARGIN_TOL_FIXTURE = 1e-3     # mean |margin| gap on the fixture's rows
MARGIN_TOL_CPU = 1e-4         # card fit vs CPU fit of the same port code
NDCG_TOL = 1e-3               # training NDCG@30, port ranker vs JAX fixture
CAT_CPU_ITERATIONS = 30       # the categorical fit held card against CPU


T0 = time.perf_counter()


def emit(obj) -> None:
    """One JSON line; a phase's line also carries the seconds since the
    script started (``t_s``)."""
    if "phase" in obj:
        obj = {**obj, "t_s": time.perf_counter() - T0}
    print(json.dumps(obj), flush=True)


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise SystemExit(f"chip_smoke: FAILED: {msg}")


def query_rows(n: int, d: int = 14, seed: int = 1) -> np.ndarray:
    """Seeded rows; every 10th row has NaN in one random column."""
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(n, d)).astype(np.float32)
    nan_rows = np.arange(0, n, 10)
    q[nan_rows, rng.integers(0, d, nan_rows.size)] = np.nan
    return q


def random_forest(rng, t: int, m: int, f: int):
    """A valid ensemble of complete binary trees with m nodes each."""
    idx = np.arange(m)
    internal = 2 * idx + 2 < m
    feat = np.where(internal[None, :], rng.integers(0, f, (t, m)), -1)
    thr = np.where(internal[None, :], rng.normal(size=(t, m)), 0.0)
    left = np.broadcast_to(np.where(internal, 2 * idx + 1, 0), (t, m))
    right = np.broadcast_to(np.where(internal, 2 * idx + 2, 0), (t, m))
    value = np.where(internal[None, :], 0.0, rng.normal(size=(t, m)))
    return (feat.astype(np.int32), thr.astype(np.float32),
            left.astype(np.int32), right.astype(np.int32),
            value.astype(np.float32))


def on_card(arrays, dtypes=(np.int32, np.float32, np.int32, np.int32,
                            np.float32)):
    return tuple(torch.from_numpy(np.ascontiguousarray(a, dt)).cuda()
                 for a, dt in zip(arrays, dtypes))


def adult_rows(n: int = 32561, d: int = 14, seed: int = 0):
    """The seeded Adult-census rows of ``bench.py`` ``bench_gbdt_train``
    (as ``tests/fixtures/make_lgbm_adult_fixture.py`` makes them)."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, d)).astype(np.float32)
    logits = x @ rng.normal(size=(d,)) + 0.5 * np.sin(3 * x[:, 0]) * x[:, 1]
    y = (logits + rng.normal(scale=0.5, size=n) > 0).astype(np.int32)
    return x, y


def synth_rows(n: int, d: int, seed: int, classes: int = 0):
    """Seeded rows with a nonlinear target: regression, or ``classes``
    classes cut from it at its quantiles."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, d)).astype(np.float32)
    t = (x[:, 0] + np.sin(2 * x[:, 1]) + 0.5 * x[:, 2] * x[:, 3]
         + rng.normal(scale=0.3, size=n))
    if classes:
        cuts = np.quantile(t, np.linspace(0, 1, classes + 1)[1:-1])
        return x, np.searchsorted(cuts, t).astype(np.float64)
    return x, t


def logloss(raw: np.ndarray, y: np.ndarray) -> float:
    p = 1.0 / (1.0 + np.exp(-raw.astype(np.float64)))
    p = np.clip(p, 1e-15, 1 - 1e-15)
    return float(-(y * np.log(p) + (1 - y) * np.log(1 - p)).mean())


def same_trees(a, b) -> list:
    """Per tree: are structure and thresholds identical?"""
    names = ("trees_feature", "trees_threshold", "trees_left", "trees_right")
    if a.trees_feature.shape != b.trees_feature.shape:
        return [False] * max(a.num_trees, b.num_trees)
    return [all(np.array_equal(getattr(a, f)[i], getattr(b, f)[i])
                for f in names) for i in range(a.num_trees)]


def first_difference(a, b, same: list) -> dict:
    """Where the first differing tree departs, and the two split gains
    chosen there (a near-tie shows as a tiny relative gap)."""
    if all(same):
        return {}
    if a.trees_feature.shape != b.trees_feature.shape:
        return {"shapes": [list(a.trees_feature.shape),
                           list(b.trees_feature.shape)]}
    t = same.index(False)
    diff = ((a.trees_feature[t] != b.trees_feature[t])
            | (a.trees_threshold[t] != b.trees_threshold[t]))
    node = int(np.nonzero(diff)[0][0])
    ga, gb = float(a.trees_gain[t, node]), float(b.trees_gain[t, node])
    return {"tree": t, "node": node,
            "feature": [int(a.trees_feature[t, node]),
                        int(b.trees_feature[t, node])],
            "gain": [ga, gb],
            "gain_gap_rel": abs(ga - gb) / max(abs(ga), abs(gb), 1e-30)}


def fit_breakdown(fit) -> dict:
    """Host-clock seconds of one fit by part, each part's calls wrapped
    with a synchronise before and after: the per-fit bin index, K1
    launches, the rest of the per-leaf histogram (the [N, 3] data), the
    split search, the row partition, the host syncs (device-to-host copies
    of each split's numbers), a sampled fit's row sampling (bagging or
    GOSS) and feature sampling (the permutation and the masked index), a
    ranker's LambdaRank gradient, and everything else; plus the number of
    host syncs."""
    from synapseml_tpu_torch.gbdt import boosting, grower, kernels, objectives

    parts = {"bin_index": 0.0, "k1": 0.0, "histogram_data": 0.0,
             "split_search": 0.0, "partition": 0.0, "host_syncs": 0.0,
             "row_sampling": 0.0, "feature_sampling": 0.0,
             "lambdarank_grad": 0.0}
    count = {"host_syncs": 0}
    originals = {}

    def wrap(module, name, part, counted=False):
        fn = getattr(module, name)
        originals[(module, name)] = fn

        def timed(*args, **kw):
            torch.cuda.synchronize()
            start = time.perf_counter()
            out = fn(*args, **kw)
            torch.cuda.synchronize()
            parts[part] += time.perf_counter() - start
            if counted:
                count[part] += 1
            return out
        for counter in ("launches", "builds"):   # the wrapped one counts here
            if hasattr(fn, counter):
                setattr(timed, counter, getattr(fn, counter))
        setattr(module, name, timed)

    wrap(kernels, "bin_index", "bin_index")
    wrap(kernels, "histogram", "k1")
    wrap(grower, "histogram", "histogram_data")
    wrap(grower, "best_split", "split_search")
    wrap(grower, "_partition", "partition")
    wrap(grower, "_to_host", "host_syncs", counted=True)
    wrap(boosting, "_sample_rows", "row_sampling")
    wrap(boosting, "_feature_keep", "feature_sampling")
    wrap(kernels, "mask_features", "feature_sampling")
    wrap(objectives, "lambdarank_grad_blocked", "lambdarank_grad")
    wrap(objectives, "lambdarank_grad", "lambdarank_grad")
    try:
        torch.cuda.synchronize()
        start = time.perf_counter()
        fit()
        torch.cuda.synchronize()
        total = time.perf_counter() - start
    finally:
        for (module, name), fn in originals.items():
            setattr(module, name, fn)
    parts["histogram_data"] -= parts["k1"]   # grower.histogram wraps K1
    parts["other"] = total - sum(parts.values())
    return {"total_s": total, "parts_s": parts,
            "host_syncs": count["host_syncs"]}


SPIN_CYCLES = 50_000_000      # ~28 ms of device spin ahead of a timing


def cuda_ms(fn, reps: int = 5, inner: int = 20) -> float:
    """Median over ``reps`` of the mean ms of ``inner`` back-to-back calls,
    timed with CUDA events after one warm-up call. Each run is queued
    behind a device-side spin, so the calls reach the card back to back
    and the time is the device's, not the host's launch overhead."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(SPIN_CYCLES)
        start.record()
        for _ in range(inner):
            fn()
        stop.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(stop) / inner)
    return statistics.median(times)


def host_ms(fn, calls: int = 100) -> float:
    """Host wall ms a call of ``fn`` takes to return (argument checks,
    allocation, launch) while the card is busy, so the host never waits."""
    fn()
    torch.cuda.synchronize()
    torch.cuda._sleep(SPIN_CYCLES)
    start = time.perf_counter()
    for _ in range(calls):
        fn()
    host = time.perf_counter() - start
    torch.cuda.synchronize()
    return host / calls * 1e3


def device_busy(fn) -> dict:
    """Wall seconds of ``fn()`` under ``torch.profiler`` (CUDA activity
    only) and the seconds the card spent in kernels meanwhile, with the
    kernels that took most of it. A failure of ``fn`` propagates; one of
    the profiler is reported in the result, as it is not part of the
    checks."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    try:
        prof = profile(activities=[ProfilerActivity.CUDA])
        prof.start()
    except Exception as exc:
        prof, error = None, f"{type(exc).__name__}: {exc}"
    start = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    wall = time.perf_counter() - start
    if prof is None:
        return {"wall_s": wall, "error": error}
    try:
        prof.stop()
        by_name = {}
        for e in prof.events():
            if e.device_type == torch.autograd.DeviceType.CUDA:
                s, c = by_name.get(e.name, (0.0, 0))
                by_name[e.name] = (s + e.time_range.elapsed_us() * 1e-6, c + 1)
    except Exception as exc:
        return {"wall_s": wall, "error": f"{type(exc).__name__}: {exc}"}
    busy = sum(s for s, _ in by_name.values())
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:8]
    return {"wall_s": wall, "kernel_s": busy,
            "busy_share": busy / wall if wall else None,
            "kernels": sum(c for _, c in by_name.values()),
            "top": [{"name": n[:90], "s": s, "count": c}
                    for n, (s, c) in top]}


def node_depths(feat, left, right) -> np.ndarray:
    """[T, M] depth of every node reachable from the root (0 elsewhere)."""
    t, m = feat.shape
    depth = np.zeros((t, m), np.int64)
    for ti in range(t):
        stack = [0]
        while stack:
            nid = stack.pop()
            if feat[ti, nid] >= 0:
                for c in (left[ti, nid], right[ti, nid]):
                    depth[ti, c] = depth[ti, nid] + 1
                    stack.append(c)
    return depth


def transform_breakdown(model, table, planes) -> dict:
    """Host-clock seconds of each step of one classification transform,
    run step by step with a synchronise after each device step."""
    from synapseml_tpu_torch.gbdt.boosting import objective_transform
    from synapseml_tpu_torch.gbdt.kernels import forest_traverse

    marks = [("start", time.perf_counter())]

    def mark(name):
        torch.cuda.synchronize()
        marks.append((name, time.perf_counter()))

    feats = model._features(table)
    mark("features_f64")
    x = np.asarray(feats, np.float32)
    mark("to_f32")
    xd = torch.from_numpy(x).cuda()
    mark("h2d")
    out = forest_traverse(xd, *planes, k=1)
    mark("kernel")
    raw = out.cpu().numpy()[:, 0] + model.booster.init_score
    mark("d2h")
    probs = objective_transform(model.booster.params, raw)
    _ = (np.column_stack([1 - probs, probs]), np.column_stack([-raw, raw]))
    mark("objective_and_columns")
    return {name: t - marks[i][1] for i, (name, t) in enumerate(marks[1:])}


DP_FIXTURE = os.path.join(FIXTURES, "lgbm_adult_100x31_dp2.txt")
DP_FIXTURE_IO = os.path.join(FIXTURES, "lgbm_adult_100x31_dp2_io.npz")
DP_TIMEOUT_S = 600            # the one launch of the two data-parallel ranks


def equal_boosters(a, b) -> bool:
    return all(getattr(a, f).tobytes() == getattr(b, f).tobytes()
               for f in ("trees_feature", "trees_threshold", "trees_left",
                         "trees_right", "trees_value", "tree_weights")
               ) and a.init_score == b.init_score


def dp_cases(x_adult, y_adult, dp_params) -> list:
    """The data-parallel cases, run in one launch of two gloo ranks that
    share the card (``tests/torch_dp_worker.py``): the Adult fit through
    ``boosting.train(mesh=)`` twice (checked; then timed, its collectives
    synchronised and timed), each mode on the card and on the CPU, and a
    one-rank NCCL group against a one-rank gloo group."""
    adult = dict(p=dp_params, x=x_adult, y=y_adult.astype(np.float64),
                 valid_sets=[(x_adult[:4096], y_adult[:4096])])
    cases = [{"name": "adult", "kind": "train", "devices": ["cuda"],
              "kw": adult},
             {"name": "adult_collectives", "kind": "train",
              "devices": ["cuda"], "kw": dict(adult, time_collectives=True)}]
    xb, yb = synth_rows(20_000, 10, seed=6, classes=2)
    x3, y3 = synth_rows(20_000, 10, seed=3, classes=3)
    xr, yr = synth_rows(20_000, 10, seed=4)
    sys.path.insert(0, FIXTURES)
    import make_lgbm_rank_fixture as rank_fx
    xq, yq, gq = rank_fx.rank_rows(60, 20, seed=3)
    base = dict(num_iterations=15, num_leaves=31)
    modes = {
        "gbdt": (dict(objective="binary"), xb, yb, {}),
        "bagging_feature_fraction": (dict(
            objective="binary", bagging_fraction=0.8, bagging_freq=1,
            feature_fraction=0.8), xb, yb, {}),
        "goss": (dict(objective="binary", boosting_type="goss"), xb, yb, {}),
        "rf": (dict(objective="binary", boosting_type="rf",
                    bagging_fraction=0.7, bagging_freq=1), xb, yb, {}),
        "dart": (dict(objective="binary", boosting_type="dart",
                      drop_rate=0.2, skip_drop=0.3), xb, yb, {}),
        "multiclass_3": (dict(objective="multiclass", num_class=3), x3, y3,
                         {}),
        "lambdarank": (dict(objective="lambdarank"), xq, yq,
                       dict(group=gq)),
        "regression_l1": (dict(objective="regression_l1"), xr, yr, {}),
        "voting_top_k_2": (dict(objective="binary",
                                tree_learner="voting_parallel",
                                voting_top_k=2), xb, yb, {}),
    }
    for name, (pkw, x, y, extra) in modes.items():
        cases.append({"name": name, "kind": "train",
                      "devices": ["cuda", "cpu"],
                      "kw": dict(p={**base, **pkw}, x=x, y=y, **extra)})
    half = len(yb) // 2
    cases.append({"name": "row_sharded", "kind": "row_sharded",
                  "devices": ["cuda", "cpu"],
                  "kw": dict(p={**base, "objective": "binary"},
                             x_parts=[xb[:half], xb[half:]],
                             y_parts=[yb[:half], yb[half:]])})
    cases.append({"name": "one_rank", "kind": "one_rank",
                  "devices": ["cuda"],
                  "kw": dict(p={**base, "objective": "binary"}, x=xb, y=yb,
                             backends=["nccl", "gloo"])})
    return cases


def dp_query(name: str, cases: list) -> np.ndarray:
    """Rows to score a card-against-CPU case's boosters on."""
    kw = next(c["kw"] for c in cases if c["name"] == name)
    return (kw["x"] if "x" in kw else kw["x_parts"][0])[:2000]


def dp_phases(x_adult, y_adult, fit_s, fit_median, smi) -> list:
    """Phases 13-15: one launch of two gloo ranks that share the card
    (``tests/torch_dp_worker.py``, with a timeout; a rank that fails fails
    the launch) runs every case of :func:`dp_cases`; then the checks.
    Returns each rank's K1 and K2 launches of the Adult fit."""
    from synapseml_tpu_torch.gbdt.boosting import Booster
    sys.path.insert(0, os.path.join(HERE, "tests"))
    from torch_dp_worker import run_ranks

    with open(DP_FIXTURE) as fh:
        dp_fixture = Booster.load_string(fh.read())
    dp_io = np.load(DP_FIXTURE_IO)
    dp_params = json.loads(str(dp_io["params"]))
    dp_params["categorical_features"] = tuple(
        dp_params["categorical_features"])
    cases = dp_cases(x_adult, y_adult, dp_params)
    start = time.perf_counter()
    with tempfile.TemporaryDirectory() as work:
        try:
            ranks = run_ranks(work, 2, cases, timeout=DP_TIMEOUT_S,
                              threads=4)
        except RuntimeError as exc:
            raise SystemExit(
                f"chip_smoke: FAILED: data-parallel ranks: {exc}")
    dp_launch_s = time.perf_counter() - start
    for name in [c["name"] for c in cases]:
        for r, res in enumerate(ranks):
            check("error" not in res[name],
                  f"{name} failed on rank {r}: {res[name].get('error')}")

    # 13. the Adult fit at dp=2, held to the JAX 2-device fixture
    fits = [res["adult"]["cuda"] for res in ranks]
    dp_b = fits[0]["booster"]
    dp_ranks_equal = equal_boosters(dp_b, fits[1]["booster"])
    dp_splits = int((dp_b.trees_feature >= 0).sum())
    dp_rt = Booster.load_string(dp_b.save_string())
    same_dp = same_trees(dp_rt, dp_fixture)
    ll_dp = logloss(dp_b.predict_raw(x_adult, device="cuda"), y_adult)
    ll_dp_fixture = float(dp_io["train_logloss"])
    dp_gap = np.abs(dp_b.predict_raw(dp_io["x"], device="cuda") - dp_io["raw"])
    wall = [res["adult_collectives"]["cuda"]["seconds"] for res in ranks]
    timed = ranks[0]["adult_collectives"]["cuda"]
    dp_counts = [{"histogram": f["k1_launches"],
                  "forest_traverse": f["k2_launches"]} for f in fits]
    emit({"phase": "train_dp_adult",
          "config": "boosting.train(BoostParams of LightGBMClassifier("
                    "num_iterations=100, num_leaves=31, learning_rate=0.1), "
                    "mesh=2-rank gloo group), two ranks sharing one card; "
                    "valid set: the first 4,096 rows",
          "rows": list(x_adult.shape), "rows_per_rank": -(-len(y_adult) // 2),
          "fixture_jax_version": str(dp_io["jax_version"]),
          "launches_per_rank": dp_counts, "splits": dp_splits,
          "trees": len(same_dp),
          "identical_trees_vs_jax_fixture": sum(same_dp),
          "first_difference": first_difference(dp_rt, dp_fixture, same_dp),
          "ranks_bitwise_equal": dp_ranks_equal,
          "train_logloss": ll_dp, "train_logloss_jax_fixture": ll_dp_fixture,
          "margin_gap_mean": float(dp_gap.mean()),
          "margin_gap_max": float(dp_gap.max()),
          "fit_first_s": [f["seconds"] for f in fits],
          "fit_s": wall,
          "fit_rows_iterations_per_s": len(y_adult) * 100 / max(wall),
          "single_device_fit_s": fit_s,
          "single_device_rows_iterations_per_s":
              len(y_adult) * 100 / fit_median,
          "reductions_per_fit": timed["collective_calls"],
          "reduction_bytes_per_fit_per_rank": timed["collective_bytes"],
          "collective_s": timed["collective_s"],
          "collective_share": timed["collective_s"] / timed["seconds"],
          "launch_s": dp_launch_s, "nvidia_smi": smi})
    check(dp_ranks_equal, "the two ranks' Adult boosters differ")
    for c in dp_counts:
        check(c["histogram"] == 100 + dp_splits,
              f"{c['histogram']} K1 launches on a rank for {dp_splits} "
              "splits")
        check(c["forest_traverse"] >= 100,
              f"the dp fit's tracker launched K2 {c['forest_traverse']} "
              "times")
    check(abs(ll_dp - ll_dp_fixture) <= LOGLOSS_TOL,
          f"dp training logloss {ll_dp} vs the JAX fixture's {ll_dp_fixture}")
    check(float(dp_gap.mean()) <= MARGIN_TOL_FIXTURE,
          f"dp mean margin gap {dp_gap.mean()} to the JAX fixture")
    check(not all(same_dp) or float(dp_gap.max()) <= MARGIN_TOL_FIXTURE,
          f"dp max margin gap {dp_gap.max()} with all trees identical")

    # 14. every mode, two card ranks against two CPU ranks: bitwise
    dp_modes = []
    for case in cases[2:-1]:
        name = case["name"]
        card_b = ranks[0][name]["cuda"]["booster"]
        cpu_b = ranks[0][name]["cpu"]["booster"]
        query = dp_query(name, cases)
        gap = float(np.abs(card_b.predict_raw(query, device="cuda")
                           - cpu_b.predict_raw(query, device="cpu")).max())
        same_dev = same_trees(card_b, cpu_b)
        dp_modes.append({
            "fit": name, "kind": case["kind"],
            "trees": len(same_dev), "identical_trees": sum(same_dev),
            "bitwise": equal_boosters(card_b, cpu_b) and gap == 0.0,
            "ranks_bitwise_equal": all(equal_boosters(
                ranks[1][name][d]["booster"], ranks[0][name][d]["booster"])
                for d in ("cuda", "cpu")),
            "first_difference": first_difference(card_b, cpu_b, same_dev),
            "margin_max_gap": gap,
            "k1_launches_card": ranks[0][name]["cuda"]["k1_launches"],
            "fit_s": {d: ranks[0][name][d]["seconds"]
                      for d in ("cuda", "cpu")}})
    emit({"phase": "train_dp_card_vs_cpu", "tolerance": "bitwise",
          "fits": dp_modes})
    for m in dp_modes:
        check(m["bitwise"] and m["ranks_bitwise_equal"],
              f"dp {m['fit']}: two card ranks differ from two CPU ranks or "
              "from each other")
        check(m["k1_launches_card"] > 0, f"dp {m['fit']} did not launch K1")

    # 15. a one-rank NCCL group on the card against a one-rank gloo group
    one = ranks[0]["one_rank"]
    nccl_ok = equal_boosters(one["nccl"]["booster"], one["gloo"]["booster"])
    emit({"phase": "train_nccl_one_rank",
          "fit": "binary, 15 iterations of 31 leaves, 20,000 x 10",
          "bitwise_vs_gloo": nccl_ok,
          "reductions": one["nccl"]["collective_calls"],
          "fit_s": {b: one[b]["seconds"] for b in ("nccl", "gloo")},
          "k1_launches": one["nccl"]["k1_launches"]})
    check(nccl_ok, "the one-rank NCCL fit differs from the one-rank gloo fit")
    check(one["nccl"]["collective_calls"] > 0
          and one["nccl"]["k1_launches"] > 0, "the NCCL fit did not reduce")

    return {"counts": dp_counts, "params": dp_params, "adult": dp_b,
            "adult_same_fixture":
            sum(same_dp), "fixture": dp_fixture,
            "nccl_one_rank": one["nccl"]["booster"], "one_rank_case":
            next(c for c in cases if c["name"] == "one_rank")["kw"]}


PART_TIMEOUT_S = 600          # each launch of the partition-stream ranks
LAUNCH_TIMEOUT_S = 300        # the launcher's smoke fit


def adult_batches(x_adult, y_adult, cols):
    """Rank 0's rows 0-16,280 as 3 record batches, rank 1's rows
    16,281-32,560 as 4, dicts and Tables in turn."""
    from synapseml_tpu_torch.data.table import Table
    n = len(y_adult)
    half = -(-n // 2)
    spans = [[0, 5_000, 11_000, half], [half, 20_000, 24_000, 28_500, n]]
    parts = []
    for bounds in spans:
        batches = []
        for i, (lo, hi) in enumerate(zip(bounds[:-1], bounds[1:])):
            d = {c: x_adult[lo:hi, j] for j, c in enumerate(cols)}
            d["label"] = y_adult[lo:hi].astype(np.float64)
            batches.append(Table(d) if i % 2 else d)
        parts.append(batches)
    return parts


def partition_phases(x_adult, y_adult, dp_params, dp, smi) -> list:
    """Phases 16-19: ``data.partitions.fit_partitions`` through the
    driver rendezvous (a ``DriverRendezvous`` in this process on loopback,
    each rank joining through ``fit_partitions(rendezvous=...)``): two
    gloo ranks sharing the card (the Adult fit, then a ranker on the
    gather route, on the card and on the CPU), one NCCL rank; then the
    launcher's smoke fit. Each launch has a timeout that kills its
    workers. Returns each rank's K1 and K2 launches of the Adult fit."""
    from synapseml_tpu_torch.gbdt.boosting import Booster
    sys.path.insert(0, os.path.join(HERE, "tests"))
    from torch_dp_worker import run_ranks
    import make_lgbm_rank_fixture as rank_fx

    cols = [f"f{j}" for j in range(x_adult.shape[1])]
    xq, yq, gq = rank_fx.rank_rows(60, 20, seed=3)
    qcols = [f"q{j}" for j in range(xq.shape[1])]
    first = gq < 30
    rank_parts = [[{**{c: xq[m, j] for j, c in enumerate(qcols)},
                    "label": yq[m], "qid": q}]   # each rank numbers 0..29
                  for m, q in ((first, gq[first]), (~first, gq[~first] - 30))]
    cases = [
        {"name": "adult", "kind": "partitions", "devices": ["cuda"],
         "kw": dict(p=dp_params, batches_parts=adult_batches(
             x_adult, y_adult, cols), feature_cols=cols,
             valid_sets=[(x_adult[:4096], y_adult[:4096])],
             rendezvous=True)},
        {"name": "gather_ranker", "kind": "partitions",
         "devices": ["cuda", "cpu"],
         "kw": dict(p=dict(objective="lambdarank", num_iterations=15,
                           num_leaves=31), batches_parts=rank_parts,
                    feature_cols=qcols, group_col="qid", row_sharded=False)}]
    start = time.perf_counter()
    with tempfile.TemporaryDirectory() as work:
        try:
            ranks = run_ranks(work, 2, cases, timeout=PART_TIMEOUT_S,
                              threads=4, init="rendezvous", backend="gloo")
        except RuntimeError as exc:
            raise SystemExit(
                f"chip_smoke: FAILED: partition-stream ranks: {exc}")
    launch_s = time.perf_counter() - start
    for name in [c["name"] for c in cases]:
        for r, res in enumerate(ranks):
            check("error" not in res[name],
                  f"{name} failed on rank {r}: {res[name].get('error')}")

    # 16. the Adult fit streamed from two ranks' record batches
    fits = [res["adult"]["cuda"] for res in ranks]
    b = fits[0]["booster"]
    splits = int((b.trees_feature >= 0).sum())
    # through the text format, as phase 13 holds its booster to the fixture
    same = same_trees(Booster.load_string(b.save_string()), dp["fixture"])
    counts = [{"histogram": f["k1_launches"],
               "forest_traverse": f["k2_launches"]} for f in fits]
    stats = [f["stats_out"] for f in fits]
    ranks_equal = equal_boosters(b, fits[1]["booster"])
    equal_dp = equal_boosters(b, dp["adult"])
    emit({"phase": "partitions_rendezvous_adult",
          "config": "fit_partitions(BoostParams of train_dp_adult, 3 and 4 "
                    "record batches (dicts, Tables) a rank, rendezvous="
                    "DriverRendezvous on loopback, backend gloo, "
                    "device cuda): two ranks sharing one card, routed to "
                    "train_row_sharded",
          "rows_per_rank": [s["n_local"] for s in stats],
          "path": [s["path"] for s in stats],
          "backend": [f["backend"] for f in fits],
          "sample_rows_gathered": [s["sample_rows_gathered"] for s in stats],
          "launches_per_rank": counts, "splits": splits,
          "ranks_bitwise_equal": ranks_equal,
          "bitwise_train_dp_adult": equal_dp,
          "identical_trees_vs_jax_fixture": sum(same),
          "rendezvous_s": [s["rendezvous_s"] for s in stats],
          "aggregate_s": [s["aggregate_s"] for s in stats],
          "fit_s": [f["seconds"] for f in fits],
          "reductions_per_fit": [f["collective_calls"] for f in fits],
          "reduction_bytes_per_fit_per_rank":
              [f["collective_bytes"] for f in fits],
          "launch_s": launch_s, "nvidia_smi": smi})
    check(ranks_equal, "the two ranks' partition-stream boosters differ")
    check(equal_dp, "the partition-stream Adult booster is not bitwise the "
          "train_dp_adult booster")
    check(sum(same) == dp["adult_same_fixture"],
          f"{sum(same)} trees of the dp fixture, train_dp_adult has "
          f"{dp['adult_same_fixture']}")
    for s, f in zip(stats, fits):
        check(s["path"] == "row_sharded" and f["backend"] == "gloo",
              f"partition fit routed to {s['path']} over {f['backend']}")
        check(s["sample_rows_gathered"] == len(y_adult),
              f"{s['sample_rows_gathered']} bin-sample rows gathered")
    for c, c_dp in zip(counts, dp["counts"]):
        check(c == c_dp and c["histogram"] == 100 + splits
              and c["forest_traverse"] == 100,
              f"partition fit launches {c} a rank (train_dp_adult {c_dp}, "
              f"{splits} splits)")

    # 17. a ranker on the gather route: two card ranks against two CPU ranks
    g = ranks[0]["gather_ranker"]
    card_b, cpu_b = g["cuda"]["booster"], g["cpu"]["booster"]
    q_rows = xq[:2000]
    gap = float(np.abs(card_b.predict_raw(q_rows, device="cuda")
                       - cpu_b.predict_raw(q_rows, device="cpu")).max())
    g_bitwise = equal_boosters(card_b, cpu_b) and gap == 0.0
    g_ranks = all(equal_boosters(ranks[1]["gather_ranker"][d]["booster"],
                                 g[d]["booster"]) for d in ("cuda", "cpu"))
    emit({"phase": "partitions_gather_ranker",
          "fit": "lambdarank, 15 iterations of 31 leaves, 60 queries "
                 f"({len(yq)} x {xq.shape[1]}), 30 a rank numbered 0..29 "
                 "on each, row_sharded=False",
          "path": g["cuda"]["stats_out"]["path"], "tolerance": "bitwise",
          "bitwise_vs_cpu_ranks": g_bitwise, "ranks_bitwise_equal": g_ranks,
          "margin_max_gap": gap, "trees": card_b.num_trees,
          "k1_launches_card": g["cuda"]["k1_launches"],
          "fit_s": {d: g[d]["seconds"] for d in ("cuda", "cpu")}})
    check(g["cuda"]["stats_out"]["path"] == "gather",
          f"ranker routed to {g['cuda']['stats_out']['path']}")
    check(g_bitwise and g_ranks, "the gather-route ranker: card ranks differ "
          "from CPU ranks or from each other")
    check(g["cuda"]["k1_launches"] > 0, "the gather-route ranker did not "
          "launch K1")

    # 18. one NCCL rank with an explicit coordinator, against phase 15's
    # one-rank NCCL group fit of the same rows
    one = dp["one_rank_case"]
    half = len(one["y"]) // 2
    one_parts = [[{**{f"f{j}": one["x"][lo:hi, j]
                      for j in range(one["x"].shape[1])},
                   "label": one["y"][lo:hi]}
                  for lo, hi in ((0, half), (half, len(one["y"])))]]
    nccl_case = {"name": "nccl", "kind": "partitions", "devices": ["cuda"],
                 "kw": dict(p=one["p"], batches_parts=one_parts,
                            feature_cols=[f"f{j}" for j in range(
                                one["x"].shape[1])],
                            row_sharded=True, rendezvous=True)}
    with tempfile.TemporaryDirectory() as work:
        try:
            res = run_ranks(work, 1, [nccl_case], timeout=PART_TIMEOUT_S,
                            threads=4, init="rendezvous", backend="nccl",
                            local_device=0)[0]["nccl"]
        except RuntimeError as exc:
            raise SystemExit(f"chip_smoke: FAILED: one NCCL rank: {exc}")
    check("error" not in res, f"one NCCL rank failed: {res.get('error')}")
    fit = res["cuda"]
    nccl_equal = equal_boosters(fit["booster"], dp["nccl_one_rank"])
    emit({"phase": "rendezvous_nccl_one_rank",
          "fit": "fit_partitions(row_sharded=True) of train_nccl_one_rank's "
                 "rows in 2 batches, a world of one, backend nccl, "
                 "local_device 0",
          "backend": fit["backend"], "path": fit["stats_out"]["path"],
          "bitwise_vs_train_nccl_one_rank": nccl_equal,
          "reductions": fit["collective_calls"],
          "rendezvous_s": fit["stats_out"]["rendezvous_s"],
          "fit_s": fit["seconds"], "k1_launches": fit["k1_launches"]})
    check(fit["backend"] == "nccl" and fit["stats_out"]["path"]
          == "row_sharded", "the one-rank fit did not run row-sharded over "
          "NCCL")
    check(nccl_equal, "the one-rank NCCL partition fit differs from "
          "train_nccl_one_rank's")
    check(fit["collective_calls"] > 0 and fit["k1_launches"] > 0,
          "the one-rank NCCL partition fit did not reduce or launch K1")

    # 19. the launcher's built-in smoke fit on the card, single process
    env = dict(os.environ, PYTHONPATH=HERE)
    for var in ("SYNAPSEML_COORDINATOR", "SYNAPSEML_NUM_PROCESSES",
                "SYNAPSEML_PROCESS_ID"):
        env.pop(var, None)
    start = time.perf_counter()
    try:
        run = subprocess.run(
            [sys.executable, "-m", "synapseml_tpu_torch.parallel.launch"],
            env=env, cwd=HERE, capture_output=True, text=True,
            timeout=LAUNCH_TIMEOUT_S)
    except subprocess.TimeoutExpired:
        raise SystemExit("chip_smoke: FAILED: the launcher did not finish "
                         f"within {LAUNCH_TIMEOUT_S} s") from None
    acc = [ln.split("acc=")[-1] for ln in run.stdout.splitlines()
           if "smoke-fit acc=" in ln]
    emit({"phase": "launch_smoke",
          "command": "python -m synapseml_tpu_torch.parallel.launch",
          "returncode": run.returncode, "smoke_fit_acc": acc,
          "seconds": time.perf_counter() - start,
          "stdout": run.stdout.strip().splitlines()[-2:]})
    check(run.returncode == 0 and acc and "device=cuda" in run.stdout,
          f"the launcher exited {run.returncode}: {run.stderr[-2000:]}")
    return counts


def main() -> int:
    # -- 1. device ------------------------------------------------------
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the GPU",
              file=sys.stderr)
        return 2
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()[0]
    sys.path.insert(0, HERE)
    from synapseml_tpu_torch import _build
    from synapseml_tpu_torch.data.table import Table
    sys.path.insert(0, FIXTURES)
    import make_lgbm_adult_cat_fixture as cat_fx
    import make_lgbm_rank_fixture as rank_fx
    from synapseml_tpu_torch.gbdt import boosting, grower, objectives, prng
    from synapseml_tpu_torch.gbdt.binning import BinMapper
    from synapseml_tpu_torch.gbdt.boosting import Booster
    from synapseml_tpu_torch.gbdt.estimators import (
        LightGBMClassificationModel, LightGBMClassifier, LightGBMRanker,
        LightGBMRegressor)
    from synapseml_tpu_torch.gbdt.kernels import (
        bin_index, forest_traverse, forest_traverse_reference, histogram,
        histogram_reference, mask_features)
    from synapseml_tpu_torch.isolationforest import IsolationForest

    def reset_counts():
        forest_traverse.launches = 0
        histogram.launches = 0
        bin_index.builds = 0
        mask_features.builds = 0

    def read_counts() -> dict:
        return {"forest_traverse": forest_traverse.launches,
                "histogram": histogram.launches,
                "bin_index_builds": bin_index.builds,
                "mask_features_builds": mask_features.builds}

    torch.cuda.set_device(0)
    kind = torch.cuda.get_device_name(0)
    emit({"phase": "device", "kind": kind, "count": torch.cuda.device_count(),
          "nvidia_smi": smi, "torch": torch.__version__,
          "cuda": torch.version.cuda})

    # -- 2. build -------------------------------------------------------
    build_s = _build.build_all()
    ptxas = {name: [ln.strip() for ln in log.splitlines()
                    if "registers" in ln or "spill" in ln]
             for name, log in _build.build_log.items()}
    emit({"phase": "build", "seconds": build_s, "sources": _build.sources(),
          "ptxas": ptxas})

    # -- 3. kernel against plain on the card ----------------------------
    with open(FIXTURE) as fh:
        booster = Booster.load_string(fh.read())
    rng = np.random.default_rng(0)
    x_main = query_rows(N_MAIN)
    xd_main = torch.from_numpy(x_main).cuda()
    fx_planes = on_card((booster.trees_feature, booster.trees_threshold,
                         booster.trees_left, booster.trees_right,
                         booster.trees_value * booster.tree_weights[:, None]))
    if_x = rng.normal(size=(N_MAIN, 14)).astype(np.float32)
    if_x[:64] += 5.0
    if_model = IsolationForest(num_estimators=100, max_samples=256,
                               random_seed=1).fit(
        Table({"features": if_x}), device="cuda")
    if_planes = on_card(if_model.trees)
    if_depth = int(if_model.max_depth) + 1
    mc_planes = on_card(random_forest(rng, 30, 63, 10))
    mc_x = torch.from_numpy(query_rows(20_000, 10, seed=3)).cuda()
    bins = torch.from_numpy(
        rng.integers(0, 256, (N_MAIN, 14)).astype(np.uint8)).cuda()
    b_feat, _, b_left, b_right, b_value = random_forest(rng, 1, 61, 14)
    b_thr = rng.integers(0, 255, (1, 61)).astype(np.float32)
    bin_planes = on_card((b_feat, b_thr, b_left, b_right, b_value))
    cases = [
        ("fixture_k1", xd_main, fx_planes, dict(k=1)),
        ("multiclass_k3", mc_x, mc_planes, dict(k=3)),
        ("single_tree_binned", bins.float(), bin_planes, dict(k=1)),
        ("iforest_strict", torch.from_numpy(if_x).cuda(), if_planes,
         dict(k=1, depth=if_depth, strict=True)),
    ]
    results = []
    for name, x, planes, kw in cases:
        if name == "single_tree_binned":
            got = grower.predict_tree_binned(
                tuple(p[0] for p in planes), bins)[:, None]
        else:
            got = forest_traverse(x, *planes, **kw)
        want = forest_traverse_reference(x, *planes, **kw)
        torch.cuda.synchronize()
        err = float((got - want).abs().max()) if got.numel() else 0.0
        results.append({"case": name, "shape": list(x.shape),
                        "trees": list(planes[0].shape), **{
                            k: v for k, v in kw.items() if k != "strict"},
                        "strict": bool(kw.get("strict", False)),
                        "bitwise": bool(torch.equal(got, want)),
                        "max_abs_err": err})
    emit({"phase": "kernel_vs_plain", "kernel": "forest_traverse",
          "tolerance": "bitwise (torch.equal)", "cases": results})
    check(all(r["bitwise"] for r in results),
          "forest_traverse differs from its plain version")
    max_err = max(r["max_abs_err"] for r in results)

    # K1 at the training path's shapes: Adult bins from the port's
    # BinMapper, (grad, hess) of the binary logloss at the init score
    x_adult, y_adult = adult_rows()
    mapper = BinMapper(max_bin=255).fit(x_adult.astype(np.float64))
    adult_bins = mapper.transform(x_adult.astype(np.float64))
    n_bins = mapper.total_bins
    p0 = float(y_adult.mean())
    g0 = (p0 - y_adult).astype(np.float32)
    h0 = np.full(len(y_adult), p0 * (1 - p0), np.float32)

    def hist_data(mask):
        w = mask.astype(np.float32)
        return np.stack([g0 * w, h0 * w, w], 1)

    skewed_bins = adult_bins.copy()       # 90% of the rows in one bin
    skewed_bins[rng.random(skewed_bins.shape) < 0.9] = 200
    nan_data = np.zeros((len(y_adult), 3), np.float32)
    nan_data[17_000, 0] = np.nan          # all zero but one NaN grad
    k1_cases = [
        ("adult_full_mask", adult_bins,
         hist_data(np.ones(len(y_adult), bool)), n_bins),
        ("adult_leaf_30pct", adult_bins,
         hist_data(rng.random(len(y_adult)) < 0.3), n_bins),
        ("adult_zero_mask", adult_bins,
         hist_data(np.zeros(len(y_adult), bool)), n_bins),
        ("adult_skewed_90pct", skewed_bins,
         hist_data(rng.random(len(y_adult)) < 0.7), n_bins),
        ("adult_one_nan_grad", adult_bins, nan_data, n_bins),
        ("uint16_b1024", rng.integers(0, 1024, (10_007, 5)).astype(np.uint16),
         rng.normal(size=(10_007, 3)).astype(np.float32), 1024),
        ("f1_n1", np.array([[3]], np.uint8),
         np.array([[1.5, 2.0, 1.0]], np.float32), 8),
        ("n0", np.zeros((0, 4), np.uint8), np.zeros((0, 3), np.float32), 16),
    ]
    k1_results = []
    for name, b, d, nb in k1_cases:
        want = histogram_reference(torch.from_numpy(b), torch.from_numpy(d),
                                   nb)
        bd, dd = torch.from_numpy(b).cuda(), torch.from_numpy(d).cuda()
        index = bin_index(bd, nb)
        cpu_index = bin_index(torch.from_numpy(b), nb)
        index_ok = bool(torch.equal(index.order.cpu(), cpu_index.order)
                        and torch.equal(index.start.cpu(), cpu_index.start))
        for route, got in (("index_built_in_call", histogram(bd, dd, nb)),
                           ("index_given", histogram(bd, dd, nb,
                                                     index=index))):
            torch.cuda.synchronize()
            got = got.cpu()
            nan_same = bool(torch.equal(torch.isnan(got), torch.isnan(want)))
            bits_same = bool(torch.equal(
                got.nan_to_num(7.0).view(torch.int32),
                want.nan_to_num(7.0).view(torch.int32)))
            diff = (got - want).abs().nan_to_num(0.0)
            k1_results.append({
                "case": name, "route": route, "shape": list(b.shape),
                "dtype": str(b.dtype), "n_bins": nb,
                "bitwise": nan_same and bits_same,
                "nan_entries": int(torch.isnan(want).sum()),
                "index_equals_cpu_index": index_ok,
                "max_abs_err": float(diff.max()) if diff.numel() else 0.0})
    zero = [r for r in k1_results if r["case"] == "adult_zero_mask"]
    adult_bd = torch.from_numpy(adult_bins).cuda()
    adult_dd = torch.from_numpy(k1_cases[0][2]).cuda()
    adult_index = bin_index(adult_bd, n_bins)
    repeats = [histogram(adult_bd, adult_dd, n_bins, index=adult_index)
               for _ in range(5)]
    deterministic = all(torch.equal(repeats[0], r) for r in repeats[1:])
    emit({"phase": "kernel_vs_plain", "kernel": "histogram",
          "tolerance": "bitwise (int32 views equal; NaN where the plain "
                       "version has NaN) against the plain version run on "
                       "the CPU from the same inputs",
          "cases": k1_results, "five_launches_bitwise_identical":
          deterministic})
    check(all(r["bitwise"] for r in k1_results),
          "histogram differs from its plain version")
    check(all(r["index_equals_cpu_index"] for r in k1_results),
          "the bin index built on the card differs from the CPU's")
    check(all(r["max_abs_err"] == 0.0 for r in zero),
          "an all-zero mask does not give exact zeros")
    check(all(r["nan_entries"] == 14 for r in k1_results
              if r["case"] == "adult_one_nan_grad"),
          "the one NaN grad does not reach every feature's histogram")
    check(deterministic, "five histogram launches are not bitwise equal")
    k1_max_err = max(r["max_abs_err"] for r in k1_results)

    # the threefry key stream: the card's draws are the CPU's, bitwise (the
    # CPU's are jax.random's: tests/test_torch_prng.py)
    prng_results = []
    for seed in (0, 42):
        keys = {dev: prng.prng_key(seed, dev) for dev in ("cuda", "cpu")}
        chain_same = True
        for _ in range(100):        # a 100-tree fit's rng chain
            for dev, key in keys.items():
                keys[dev] = prng.split(key)[0]
            chain_same &= torch.equal(keys["cuda"].cpu(), keys["cpu"])
        folded = {dev: prng.fold_in(prng.split(key)[1], 2 ** 31 - 1)
                  for dev, key in keys.items()}
        for n in (14, 32_561, N_LARGE):
            draws = {dev: (prng.uniform(key, n), prng.permutation(key, n))
                     for dev, key in folded.items()}
            (gu, gp), (cu, cp) = draws["cuda"], draws["cpu"]
            prng_results.append({
                "seed": seed, "n": n, "key_chain_equal": bool(chain_same),
                "uniform_bitwise": bool(torch.equal(
                    gu.cpu().view(torch.int32), cu.view(torch.int32))),
                "permutation_equal": bool(torch.equal(gp.cpu(), cp)),
                "on_card": gu.is_cuda and gp.is_cuda})
    emit({"phase": "prng_card_vs_cpu", "tolerance": "bitwise",
          "cases": prng_results})
    check(all(r["key_chain_equal"] and r["uniform_bitwise"]
              and r["permutation_equal"] and r["on_card"]
              for r in prng_results),
          "the key stream on the card differs from the CPU's")

    # K1 on feature_fraction's per-tree index (feature 0, whose histogram
    # gives the leaf totals, moved to the last bin)
    keep = torch.ones(adult_bins.shape[1], dtype=torch.bool)
    keep[[0, 5, 9]] = False
    bag = hist_data(rng.random(len(y_adult)) < 0.8)
    card_bins = torch.from_numpy(adult_bins).cuda()
    moved, masked = mask_features(bin_index(card_bins, n_bins), card_bins,
                                  keep.cuda())
    cpu_moved, cpu_masked = mask_features(
        bin_index(torch.from_numpy(adult_bins), n_bins),
        torch.from_numpy(adult_bins), keep)
    fresh = bin_index(moved, n_bins)
    bag_d = torch.from_numpy(bag).cuda()
    on_masked = histogram(moved, bag_d, n_bins, index=masked).cpu()
    on_fresh = histogram(moved, bag_d, n_bins, index=fresh).cpu()
    plain_moved = histogram_reference(cpu_moved, torch.from_numpy(bag),
                                      n_bins)
    masked_result = {
        "shape": list(adult_bins.shape), "moved_features": [0, 5, 9],
        "index_equals_fresh_index": bool(
            torch.equal(masked.order, fresh.order)
            and torch.equal(masked.start, fresh.start)),
        "index_equals_cpu": bool(
            torch.equal(masked.order.cpu(), cpu_masked.order)
            and torch.equal(masked.start.cpu(), cpu_masked.start)
            and torch.equal(moved.cpu(), cpu_moved)),
        "k1_masked_vs_k1_fresh_bitwise": bool(torch.equal(
            on_masked.view(torch.int32), on_fresh.view(torch.int32))),
        "k1_masked_vs_plain_bitwise": bool(torch.equal(
            on_masked.view(torch.int32), plain_moved.view(torch.int32)))}
    emit({"phase": "masked_index", "tolerance": "bitwise", **masked_result})
    check(all(v for k, v in masked_result.items() if k not in (
        "shape", "moved_features")), "K1 on the feature_fraction index")

    # -- 4. main path ---------------------------------------------------
    model = LightGBMClassificationModel.load_native_model(FIXTURE)
    io = np.load(FIXTURE_IO)
    x_large = query_rows(N_LARGE, seed=2)
    reset_counts()
    out_main = model.transform(Table({"features": x_main}), device="cuda")
    start = time.perf_counter()
    out_large = model.transform(Table({"features": x_large}), device="cuda")
    large_s = time.perf_counter() - start
    out_io = model.transform(Table({"features": io["x"]}), device="cuda")
    counts = read_counts()
    launches = counts["forest_traverse"]
    check(launches >= 3, f"main path launched the kernel {launches} times")
    for out, n in ((out_main, N_MAIN), (out_large, N_LARGE)):
        raw, prob = out["rawPrediction"], out["probability"]
        check(raw.shape == (n, 2) and prob.shape == (n, 2),
              f"output shapes {raw.shape} {prob.shape}")
        check(bool(np.isfinite(raw).all() and np.isfinite(prob).all()),
              "non-finite scores")
        check(bool(np.allclose(prob.sum(1), 1.0, atol=1e-6)),
              "probabilities do not sum to 1")
    raw_ok = bool(np.array_equal(out_io["rawPrediction"][:, 1], io["raw"]))
    prob_err = float(np.abs(out_io["probability"][:, 1] - io["prob"]).max())
    prob_bitwise = bool(np.array_equal(out_io["probability"][:, 1],
                                       io["prob"]))
    emit({"phase": "main_path", "rows": [N_MAIN, N_LARGE, len(io["x"])],
          "launches": counts, "raw_bitwise_vs_jax_fixture": raw_ok,
          "prob_bitwise_vs_jax_fixture": prob_bitwise,
          "prob_max_abs_err": prob_err, "prob_atol": PROB_ATOL,
          "large_transform_s": large_s})
    check(raw_ok, "raw margins differ from the JAX package's recorded ones")
    check(prob_err <= PROB_ATOL, f"probabilities off by {prob_err}")

    # -- 5. isolation forest -------------------------------------------
    reset_counts()
    scores = if_model.transform(Table({"features": if_x}),
                                device="cuda")["outlierScore"]
    if_launches = read_counts()["forest_traverse"]
    plain = if_model.transform(Table({"features": if_x}),
                               device="cpu")["outlierScore"]
    if_ok = bool(np.array_equal(scores, plain))
    emit({"phase": "iforest", "rows": N_MAIN, "trees": 100,
          "launches": if_launches, "bitwise_vs_plain_cpu": if_ok,
          "mean_score_outliers": float(scores[:64].mean()),
          "mean_score_inliers": float(scores[64:].mean())})
    check(if_launches >= 1, "isolation forest scoring did not launch K2")
    check(if_ok, "isolation-forest scores differ from the plain version")
    check(bool(scores[:64].mean() > scores[64:].mean()),
          "outliers do not score higher than inliers")

    # -- 6. train -------------------------------------------------------
    adult = Table({"features": x_adult, "label": y_adult})

    def adult_fit():
        return LightGBMClassifier(num_iterations=100, num_leaves=31,
                                  learning_rate=0.1).fit(adult, device="cuda")

    reset_counts()
    torch.cuda.synchronize()
    start = time.perf_counter()
    fitted = adult_fit()
    torch.cuda.synchronize()
    fit_first_s = time.perf_counter() - start
    out_fit = fitted.transform(Table({"features": io["x"]}), device="cuda")
    train_counts = read_counts()
    splits = int((fitted.booster.trees_feature >= 0).sum())
    # the fixture was written in LightGBM's text format and read back, so
    # the fitted booster takes the same round trip before the comparison
    port_rt = Booster.load_string(fitted.booster.save_string())
    same = same_trees(port_rt, booster)
    ll_port = logloss(fitted.booster.predict_raw(x_adult, device="cuda"),
                      y_adult)
    ll_fixture = logloss(booster.predict_raw(x_adult, device="cuda"), y_adult)
    raw_fit = out_fit["rawPrediction"]
    gap = np.abs(raw_fit[:, 1] - io["raw"])
    emit({"phase": "train", "config": "LightGBMClassifier(num_iterations="
                                      "100, num_leaves=31, learning_rate=0.1)",
          "rows": list(x_adult.shape), "device_bins": n_bins,
          "launches": train_counts, "splits": splits, "trees": len(same),
          "identical_trees_vs_jax_fixture": sum(same),
          "first_difference": first_difference(port_rt, booster, same),
          "train_logloss": ll_port, "train_logloss_jax_fixture": ll_fixture,
          "margin_gap_mean": float(gap.mean()),
          "margin_gap_max": float(gap.max()),
          "fit_first_s": fit_first_s})
    check(train_counts["histogram"] == 100 + splits,
          f"{train_counts['histogram']} K1 launches for {splits} splits")
    check(train_counts["histogram"] >= 3000,
          f"the fit launched K1 {train_counts['histogram']} times")
    check(train_counts["bin_index_builds"] == 1,
          f"the fit built {train_counts['bin_index_builds']} bin indexes")
    check(train_counts["forest_traverse"] >= 1,
          "transform of the fitted model did not launch K2")
    check(raw_fit.shape == (len(io["x"]), 2)
          and bool(np.isfinite(raw_fit).all()), "fitted model's margins")
    check(abs(ll_port - ll_fixture) <= LOGLOSS_TOL,
          f"training logloss {ll_port} vs the JAX fixture's {ll_fixture}")
    check(float(gap.mean()) <= MARGIN_TOL_FIXTURE,
          f"mean margin gap {gap.mean()} to the JAX fixture")
    check(not all(same) or float(gap.max()) <= MARGIN_TOL_FIXTURE,
          f"max margin gap {gap.max()} with all trees identical")

    # -- 7. the sampled Adult fit (bagging and feature_fraction) ----------
    with open(SAMPLED) as fh:
        sampled_fixture = Booster.load_string(fh.read())
    sampled_io = np.load(SAMPLED_IO)

    def sampled_fit():
        return LightGBMClassifier(num_iterations=100, num_leaves=31,
                                  learning_rate=0.1, **SAMPLED_PARAMS).fit(
            adult, device="cuda")

    reset_counts()
    torch.cuda.synchronize()
    start = time.perf_counter()
    sampled = sampled_fit()
    torch.cuda.synchronize()
    sampled_first_s = time.perf_counter() - start
    out_sampled = sampled.transform(Table({"features": sampled_io["x"]}),
                                    device="cuda")
    sampled_counts = read_counts()
    sampled_splits = int((sampled.booster.trees_feature >= 0).sum())
    sampled_rt = Booster.load_string(sampled.booster.save_string())
    same_sampled = same_trees(sampled_rt, sampled_fixture)
    ll_sampled = logloss(sampled.booster.predict_raw(x_adult, device="cuda"),
                         y_adult)
    ll_sampled_fixture = logloss(
        sampled_fixture.predict_raw(x_adult, device="cuda"), y_adult)
    raw_sampled = out_sampled["rawPrediction"]
    sampled_gap = np.abs(raw_sampled[:, 1] - sampled_io["raw"])
    emit({"phase": "train_sampled_adult",
          "config": "LightGBMClassifier(num_iterations=100, num_leaves=31, "
                    "learning_rate=0.1, bagging_fraction=0.8, "
                    "bagging_freq=1, feature_fraction=0.8, seed=0)",
          "fixture_jax_version": str(sampled_io["jax_version"]),
          "rows": list(x_adult.shape), "launches": sampled_counts,
          "splits": sampled_splits, "trees": len(same_sampled),
          "identical_trees_vs_jax_fixture": sum(same_sampled),
          "first_difference": first_difference(sampled_rt, sampled_fixture,
                                               same_sampled),
          "train_logloss": ll_sampled,
          "train_logloss_jax_fixture": ll_sampled_fixture,
          "margin_gap_mean": float(sampled_gap.mean()),
          "margin_gap_max": float(sampled_gap.max()),
          "fit_first_s": sampled_first_s})
    check(sampled_counts["histogram"] == 100 + sampled_splits,
          f"{sampled_counts['histogram']} K1 launches for {sampled_splits} "
          "splits")
    check(sampled_counts["bin_index_builds"] == 1
          and sampled_counts["mask_features_builds"] == 100,
          f"the sampled fit's indexes: {sampled_counts}")
    check(sampled_counts["forest_traverse"] >= 1,
          "transform of the sampled model did not launch K2")
    check(raw_sampled.shape == (len(sampled_io["x"]), 2)
          and bool(np.isfinite(raw_sampled).all()), "sampled margins")
    check(abs(ll_sampled - ll_sampled_fixture) <= LOGLOSS_TOL,
          f"sampled training logloss {ll_sampled} vs the JAX fixture's "
          f"{ll_sampled_fixture}")
    check(float(sampled_gap.mean()) <= MARGIN_TOL_FIXTURE,
          f"sampled mean margin gap {sampled_gap.mean()}")
    check(not all(same_sampled)
          or float(sampled_gap.max()) <= MARGIN_TOL_FIXTURE,
          f"sampled max margin gap {sampled_gap.max()} with all trees "
          "identical")

    def card_and_cpu(name, make, table, query, bitwise=False):
        """Fit with the same port code on the card and on the CPU; with
        ``bitwise``, every tree and margin must be identical."""
        boosters = {dev: make().fit(table, device=dev).booster
                    for dev in ("cuda", "cpu")}
        raw = {dev: b.predict_raw(query, device=dev)
               for dev, b in boosters.items()}
        same_dev = same_trees(boosters["cuda"], boosters["cpu"])
        gap = float(np.abs(raw["cuda"] - raw["cpu"]).max())
        result = {
            "fit": name, "rows": list(table["features"].shape),
            "trees": len(same_dev), "identical_trees": sum(same_dev),
            "bitwise": bool(all(same_dev) and gap == 0.0 and np.array_equal(
                boosters["cuda"].trees_value, boosters["cpu"].trees_value)),
            "first_difference": first_difference(
                boosters["cuda"], boosters["cpu"], same_dev),
            "margin_max_gap": gap,
            "tree_weights_equal": bool(np.array_equal(
                boosters["cuda"].tree_weights, boosters["cpu"].tree_weights)),
            "best_iteration": {d: b.best_iteration
                               for d, b in boosters.items()},
            "eval_history_equal": (boosters["cuda"].eval_history
                                   == boosters["cpu"].eval_history),
            "eval_history_max_gap": max(
                [abs(a - b) for k, h in boosters["cuda"].eval_history.items()
                 for a, b in zip(h, boosters["cpu"].eval_history[k])],
                default=0.0),
            "bitwise_required": bitwise}
        check(result["margin_max_gap"] <= MARGIN_TOL_CPU,
              f"{name}: card and CPU margins differ by "
              f"{result['margin_max_gap']}")
        check(not bitwise or (all(same_dev) and result["tree_weights_equal"]
                              and result["margin_max_gap"] == 0.0),
              f"{name}: card and CPU fits are not bitwise equal")
        return result

    x3, y3 = synth_rows(20_000, 10, seed=3, classes=3)
    xr, yr = synth_rows(20_000, 10, seed=4)
    xe, ye = synth_rows(20_000, 10, seed=5, classes=2)
    valid = np.zeros(len(ye), bool)
    valid[15_000:] = True
    versus_cpu = [
        card_and_cpu("multiclass_3", lambda: LightGBMClassifier(
            num_iterations=20, num_leaves=31),
            Table({"features": x3, "label": y3}), x3[:2000]),
        card_and_cpu("regression_l2", lambda: LightGBMRegressor(
            num_iterations=30, num_leaves=31),
            Table({"features": xr, "label": yr}), xr[:2000]),
        card_and_cpu("binary_early_stopping", lambda: LightGBMClassifier(
            num_iterations=200, num_leaves=31, learning_rate=0.3,
            early_stopping_round=10, validation_indicator_col="valid"),
            Table({"features": xe, "label": ye, "valid": valid}),
            xe[15_000:]),
    ]
    emit({"phase": "train_card_vs_cpu", "margin_tol": MARGIN_TOL_CPU,
          "fits": versus_cpu})
    best = versus_cpu[2]["best_iteration"]
    check(best["cuda"] == best["cpu"] and 0 <= best["cuda"] < 199,
          f"early stopping: best_iteration {best}")

    # -- 8. every boosting mode, card against CPU --------------------------
    xb, yb = synth_rows(20_000, 10, seed=6, classes=2)
    binary_t = Table({"features": xb, "label": yb})
    regression_t = Table({"features": xr, "label": yr})
    three_t = Table({"features": x3, "label": y3})

    def clf(**kw):
        return lambda: LightGBMClassifier(num_leaves=31, num_iterations=20,
                                          **kw)

    dart = dict(boosting_type="dart", drop_rate=0.2, skip_drop=0.3)
    modes = [
        # GOSS binary / 3-class: a near-tie of gradient groups or gains can
        # flip a split, so these are held within the margin tolerance
        ("goss_binary", clf(boosting_type="goss"), binary_t, xb[:2000],
         False),
        ("goss_l2", lambda: LightGBMRegressor(
            num_iterations=20, num_leaves=31, boosting_type="goss"),
         regression_t, xr[:2000], True),
        ("goss_multiclass_3", clf(boosting_type="goss"), three_t, x3[:2000],
         False),
        ("rf_bagging_feature_fraction", clf(
            boosting_type="rf", bagging_fraction=0.7, bagging_freq=1,
            feature_fraction=0.8), binary_t, xb[:2000], True),
        ("pos_neg_bagging_seed", clf(
            pos_bagging_fraction=0.7, neg_bagging_fraction=0.5,
            bagging_freq=1, bagging_seed=7), binary_t, xb[:2000], True),
        ("dart_uniform", clf(uniform_drop=True, **dart), binary_t,
         xb[:2000], True),
        ("dart_weighted", clf(**dart), binary_t, xb[:2000], True),
        ("dart_xgboost_mode", clf(xgboost_dart_mode=True, **dart), binary_t,
         xb[:2000], True),
        ("dart_multiclass_3", clf(**dart), three_t, x3[:2000], True),
    ]
    mode_results = [card_and_cpu(*m) for m in modes]
    emit({"phase": "train_modes_card_vs_cpu", "margin_tol": MARGIN_TOL_CPU,
          "fits": mode_results})

    # -- 9. categorical Adult fit ------------------------------------------
    x_cat, y_cat = cat_fx.adult_cat_rows()
    cat_table = Table({"features": x_cat, "label": y_cat})
    with open(cat_fx.MODEL) as fh:
        cat_fixture = Booster.load_string(fh.read())
    cat_io = np.load(cat_fx.IO)

    def cat_fit(device="cuda", iterations=100):
        return LightGBMClassifier(**{**cat_fx.PARAMS,
                                     "num_iterations": iterations}).fit(
            cat_table, device=device)

    reset_counts()
    torch.cuda.synchronize()
    start = time.perf_counter()
    cat_model = cat_fit()
    torch.cuda.synchronize()
    cat_first_s = time.perf_counter() - start
    out_cat = cat_model.transform(Table({"features": cat_io["x"]}),
                                  device="cuda")
    cat_counts = read_counts()
    cat_splits = int((cat_model.booster.trees_feature >= 0).sum())
    cat_rt = Booster.load_string(cat_model.booster.save_string())
    same_cat = same_trees(cat_rt, cat_fixture)
    ll_cat = logloss(cat_model.booster.predict_raw(x_cat, device="cuda"),
                     y_cat)
    ll_cat_fixture = logloss(cat_fixture.predict_raw(x_cat, device="cuda"),
                             y_cat)
    raw_cat = out_cat["rawPrediction"]
    cat_gap = np.abs(raw_cat[:, 1] - cat_io["raw"])
    # card against CPU at 30 of the 100 iterations (the CPU fit's time)
    cat_card = cat_fit("cuda", CAT_CPU_ITERATIONS).booster
    cat_cpu = cat_fit("cpu", CAT_CPU_ITERATIONS).booster
    same_cat_cpu = same_trees(cat_card, cat_cpu)
    cat_bitwise_cpu = bool(
        all(same_cat_cpu)
        and np.array_equal(cat_card.trees_value, cat_cpu.trees_value)
        and np.array_equal(cat_card.predict_raw(cat_io["x"], device="cuda"),
                           cat_cpu.predict_raw(cat_io["x"], device="cpu")))
    emit({"phase": "train_categorical_adult",
          "config": "LightGBMClassifier(num_iterations=100, num_leaves=31, "
                    "learning_rate=0.1, categorical_slot_indexes="
                    f"{cat_fx.CATEGORICAL})",
          "fixture_jax_version": str(cat_io["jax_version"]),
          "rows": list(x_cat.shape), "launches": cat_counts, "splits": cat_splits,
          "trees": len(same_cat),
          "identical_trees_vs_jax_fixture": sum(same_cat),
          "first_difference": first_difference(cat_rt, cat_fixture,
                                               same_cat),
          "splits_on_categorical_columns": int(np.isin(
              cat_model.booster.trees_feature, cat_fx.CATEGORICAL).sum()),
          "train_logloss": ll_cat, "train_logloss_jax_fixture": ll_cat_fixture,
          "margin_gap_mean": float(cat_gap.mean()),
          "margin_gap_max": float(cat_gap.max()),
          "cpu_fit_iterations": CAT_CPU_ITERATIONS,
          "identical_trees_vs_cpu_fit": sum(same_cat_cpu),
          "bitwise_vs_cpu_fit": cat_bitwise_cpu, "fit_first_s": cat_first_s})
    check(cat_counts["histogram"] == 100 + cat_splits,
          f"{cat_counts['histogram']} K1 launches for {cat_splits} splits")
    check(cat_counts["bin_index_builds"] == 1,
          f"the categorical fit built {cat_counts['bin_index_builds']} "
          "bin indexes")
    check(cat_counts["forest_traverse"] >= 1,
          "transform of the categorical model did not launch K2")
    check(raw_cat.shape == (len(cat_io["x"]), 2)
          and bool(np.isfinite(raw_cat).all()), "categorical margins")
    check(abs(ll_cat - ll_cat_fixture) <= LOGLOSS_TOL,
          f"categorical training logloss {ll_cat} vs the JAX fixture's "
          f"{ll_cat_fixture}")
    check(float(cat_gap.mean()) <= MARGIN_TOL_FIXTURE,
          f"categorical mean margin gap {cat_gap.mean()}")
    check(not all(same_cat) or float(cat_gap.max()) <= MARGIN_TOL_FIXTURE,
          f"categorical max margin gap {cat_gap.max()} with all trees "
          "identical")
    check(cat_bitwise_cpu, "the categorical card fit is not bitwise the "
          "CPU fit")

    # -- 10. the ranker ------------------------------------------------------
    x_rank, y_rank, g_rank = rank_fx.rank_rows(seed=rank_fx.SEED)
    rank_table = Table({"features": x_rank, "label": y_rank,
                        "query": g_rank})
    with open(rank_fx.MODEL) as fh:
        rank_fixture = Booster.load_string(fh.read())
    rank_io = np.load(rank_fx.IO)
    q_rank, _, _ = rank_fx.rank_rows(rank_fx.QUERY_QUERIES,
                                     seed=rank_fx.QUERY_SEED)

    def rank_fit():
        return LightGBMRanker(**rank_fx.PARAMS).fit(rank_table,
                                                    device="cuda")

    reset_counts()
    torch.cuda.synchronize()
    start = time.perf_counter()
    ranker = rank_fit()
    torch.cuda.synchronize()
    rank_first_s = time.perf_counter() - start
    out_rank = ranker.transform(Table({"features": q_rank}),
                                device="cuda")["prediction"]
    rank_counts = read_counts()
    rank_splits = int((ranker.booster.trees_feature >= 0).sum())
    rank_rt = Booster.load_string(ranker.booster.save_string())
    same_rank = same_trees(rank_rt, rank_fixture)
    rank_gap = np.abs(out_rank - rank_io["raw"])
    ndcg = boosting._ndcg_score(
        ranker.booster.predict_raw(x_rank, device="cuda"), y_rank, g_rank,
        rank_fx.MAX_POSITION)
    ndcg_fixture = float(rank_io["train_ndcg30"])
    qidx, qmask, _ = objectives.build_query_blocks(g_rank)
    emit({"phase": "train_ranker",
          "config": "LightGBMRanker(num_iterations=100, num_leaves=31, "
                    "learning_rate=0.1, max_position=30)",
          "fixture_jax_version": str(rank_io["jax_version"]),
          "rows": list(x_rank.shape), "queries": int(qidx.shape[0]),
          "max_query": int(qidx.shape[1]), "query_rows": len(q_rank),
          "launches": rank_counts, "splits": rank_splits,
          "trees": len(same_rank),
          "identical_trees_vs_jax_fixture": sum(same_rank),
          "first_difference": first_difference(rank_rt, rank_fixture,
                                               same_rank),
          "train_ndcg30": ndcg, "train_ndcg30_jax_fixture": ndcg_fixture,
          "ndcg_tol": NDCG_TOL,
          "margin_gap_mean": float(rank_gap.mean()),
          "margin_gap_max": float(rank_gap.max()),
          "fit_first_s": rank_first_s})
    check(rank_counts["histogram"] == 100 + rank_splits,
          f"{rank_counts['histogram']} K1 launches for {rank_splits} splits")
    check(rank_counts["bin_index_builds"] == 1,
          f"the ranker fit built {rank_counts['bin_index_builds']} bin "
          "indexes")
    check(rank_counts["forest_traverse"] >= 1,
          "transform of the ranker did not launch K2")
    check(out_rank.shape == (len(q_rank),)
          and bool(np.isfinite(out_rank).all()), "ranker margins")
    check(float(rank_gap.mean()) <= MARGIN_TOL_FIXTURE,
          f"ranker mean margin gap {rank_gap.mean()} to the JAX fixture")
    check(abs(ndcg - ndcg_fixture) <= NDCG_TOL,
          f"ranker training NDCG@30 {ndcg} vs the JAX fixture's "
          f"{ndcg_fixture}")
    check(not all(same_rank) or float(rank_gap.max()) <= MARGIN_TOL_FIXTURE,
          f"ranker max margin gap {rank_gap.max()} with all trees identical")

    # -- 11. rankers, card against CPU ----------------------------------------
    def fit_xendcg(table, device):
        """rank_xendcg through ``boosting.train``: ``LightGBMRanker``, as
        the reference's, always trains lambdarank."""
        return types.SimpleNamespace(booster=boosting.train(
            boosting.BoostParams(objective="rank_xendcg", num_iterations=15,
                                 num_leaves=31),
            table["features"], table["label"], None, table["query"],
            device=device))

    xr1, yr1, gr1 = rank_fx.rank_rows(165, 20, seed=3)
    rank_small = Table({"features": xr1, "label": yr1, "query": gr1})
    weighted_small = rank_small.with_column(
        "w", np.random.default_rng(4).random(len(yr1)) + 0.5)
    # early stopping runs ~100 iterations: fewer rows keep its CPU fit short
    xr2, yr2, gr2 = rank_fx.rank_rows(70, 20, seed=6)
    valid_small = Table({"features": xr2, "label": yr2, "query": gr2,
                         "valid": gr2 % 5 == 0})
    # one query of 5,000 documents among 500 of two: the dense form
    rng_d = np.random.default_rng(5)
    g_dense = np.concatenate([np.zeros(5000, np.int64),
                              1 + np.arange(1000) // 2])
    x_dense = rng_d.normal(size=(6000, 20)).astype(np.float32)
    y_dense = np.clip(np.floor(x_dense[:, 0] + rng_d.normal(size=6000) + 2),
                      0, 4)
    q_d, gmax_d = objectives.build_query_blocks(g_dense)[0].shape
    check(q_d * gmax_d * gmax_d > len(g_dense) ** 2,
          "the skewed ranker rows do not take the dense form")
    dense_table = Table({"features": x_dense, "label": y_dense,
                         "query": g_dense})

    def rank_est(**kw):
        return lambda: LightGBMRanker(num_leaves=31, **kw)

    rank_modes = [
        ("lambdarank_blocked", rank_est(num_iterations=15), rank_small,
         xr1[:2000]),
        ("lambdarank_dense_skewed", rank_est(num_iterations=10), dense_table,
         x_dense[:2000]),
        ("rank_xendcg", lambda: types.SimpleNamespace(fit=fit_xendcg),
         rank_small, xr1[:2000]),
        ("weighted", rank_est(num_iterations=15, weight_col="w"),
         weighted_small, xr1[:2000]),
        ("goss", rank_est(num_iterations=15, boosting_type="goss"),
         rank_small, xr1[:2000]),
        ("bagging_feature_fraction", rank_est(
            num_iterations=15, bagging_fraction=0.8, bagging_freq=1,
            feature_fraction=0.8), rank_small, xr1[:2000]),
        ("early_stopping_grouped_valid", rank_est(
            num_iterations=200, learning_rate=0.3, early_stopping_round=10,
            validation_indicator_col="valid"), valid_small,
         xr2[gr2 % 5 == 0]),
    ]
    rank_results = [card_and_cpu(*m) for m in rank_modes]
    emit({"phase": "train_ranker_card_vs_cpu", "margin_tol": MARGIN_TOL_CPU,
          "fits": rank_results})
    stopped = rank_results[-1]
    check(stopped["best_iteration"]["cuda"] == stopped["best_iteration"]["cpu"]
          and 0 <= stopped["best_iteration"]["cuda"] < 199,
          f"ranker early stopping: best_iteration {stopped['best_iteration']}")
    check(stopped["eval_history_max_gap"] <= 1e-6 and len(
        rank_results) == len(rank_modes),
          "the early-stopped ranker's NDCG history differs card to CPU by "
          f"{stopped['eval_history_max_gap']}")

    # -- 9. times -------------------------------------------------------
    ms = cuda_ms(lambda: forest_traverse(xd_main, *fx_planes, k=1))
    xd_large = torch.from_numpy(x_large).cuda()
    ms_large = cuda_ms(lambda: forest_traverse(xd_large, *fx_planes, k=1))
    plain_ms = cuda_ms(
        lambda: forest_traverse_reference(xd_main, *fx_planes, k=1),
        reps=3, inner=1)
    iforest_ms = cuda_ms(lambda: forest_traverse(
        cases[3][1], *if_planes, k=1, depth=if_depth, strict=True))
    transform_s = []
    table_large = Table({"features": x_large})
    for _ in range(3):
        torch.cuda.synchronize()
        start = time.perf_counter()
        model.transform(table_large, device="cuda")
        transform_s.append(time.perf_counter() - start)
    breakdown = transform_breakdown(model, table_large, fx_planes)
    t_trees, m_nodes = booster.trees_feature.shape
    n_bytes = (x_main.nbytes + N_MAIN * 1 * 4
               + t_trees * m_nodes * (3 * 4 + 2 * 4))
    # operations this data needs: one compare per internal node on each
    # row's path, plus one add per (row, tree)
    leaves = booster.predict_leaf(x_main, device="cuda")
    depth = node_depths(booster.trees_feature, booster.trees_left,
                        booster.trees_right)
    n_ops = int(depth[np.arange(t_trees)[None, :], leaves].sum()
                + N_MAIN * t_trees)
    bytes_ms = n_bytes / HBM_BYTES_PER_S * 1e3
    ops_ms = n_ops / FP32_OPS_PER_S * 1e3
    bound_ms = max(bytes_ms, ops_ms)
    bound_by = "bytes" if bytes_ms >= ops_ms else "operations"
    emit({"phase": "times", "shape": {"n": N_MAIN, "f": 14, "t": t_trees,
                                      "m": m_nodes, "k": 1},
          "kernel_ms": ms, "kernel_ms_1m_rows": ms_large,
          "plain_ms": plain_ms, "iforest_kernel_ms": iforest_ms,
          "bound_ms": bound_ms, "bound_bytes": n_bytes, "bound_ops": n_ops,
          "bytes_ms": bytes_ms, "ops_ms": ops_ms, "bound_by": bound_by,
          "transform_1m_s": transform_s,
          "transform_rows_per_s": N_LARGE / statistics.median(transform_s),
          "transform_1m_breakdown_s": breakdown, "nvidia_smi": smi})

    # K1 at the main shape (the Adult root histogram, on the fit's index)
    # and at 1M rows, spread evenly over the bins and with 90% in one bin
    k1_ms = cuda_ms(lambda: histogram(adult_bd, adult_dd, n_bins,
                                      index=adult_index))
    k1_ms_building_index = cuda_ms(
        lambda: histogram(adult_bd, adult_dd, n_bins))
    k1_host_ms = host_ms(lambda: histogram(adult_bd, adult_dd, n_bins,
                                           index=adult_index))
    index_ms = cuda_ms(lambda: bin_index(adult_bd, n_bins))
    skewed_bd = torch.from_numpy(skewed_bins).cuda()
    skewed_index = bin_index(skewed_bd, n_bins)
    k1_ms_skewed = cuda_ms(lambda: histogram(skewed_bd, adult_dd, n_bins,
                                             index=skewed_index))
    big_np = rng.integers(0, 256, (N_LARGE, 14)).astype(np.uint8)
    big_bins = torch.from_numpy(big_np).cuda()
    big_np[rng.random(big_np.shape) < 0.9] = 200
    big_skewed = torch.from_numpy(big_np).cuda()
    big_data = torch.from_numpy(rng.normal(
        size=(N_LARGE, 3)).astype(np.float32)).cuda()
    big_index = bin_index(big_bins, 256)
    big_skewed_index = bin_index(big_skewed, 256)
    k1_ms_1m = cuda_ms(lambda: histogram(big_bins, big_data, 256,
                                         index=big_index), reps=3, inner=5)
    k1_ms_1m_skewed = cuda_ms(lambda: histogram(
        big_skewed, big_data, 256, index=big_skewed_index), reps=3, inner=5)
    index_ms_1m = cuda_ms(lambda: bin_index(big_bins, 256), reps=3, inner=5)
    k1_plain_ms = cuda_ms(
        lambda: histogram_reference(adult_bd, adult_dd, n_bins))
    n_adult, f_adult = adult_bins.shape

    def library_ms(bins, data, b):
        """One index_add_ (atomic) over the same flat ids and rows."""
        f = bins.shape[1]
        ids = (bins.long() + torch.arange(f, device="cuda")[None, :]
               * b).reshape(-1)
        flat = data[:, None, :].expand(-1, f, 3).reshape(-1, 3).contiguous()
        acc = torch.zeros((f * b, 3), device="cuda")
        return cuda_ms(lambda: acc.index_add_(0, ids, flat))

    k1_library_ms = library_ms(adult_bd, adult_dd, n_bins)
    k1_library_ms_1m = library_ms(big_bins, big_data, 256)
    k1_library_ms_1m_skewed = library_ms(big_skewed, big_data, 256)

    def k1_bound(n, f, bin_bytes, b):
        n_bytes = n * f * bin_bytes + n * 3 * 4 + f * b * 3 * 4
        n_ops = n * f * 3          # one add per (row, feature, column)
        bytes_ms = n_bytes / HBM_BYTES_PER_S * 1e3
        ops_ms = n_ops / FP32_OPS_PER_S * 1e3
        return {"bytes": n_bytes, "ops": n_ops,
                "bound_ms": max(bytes_ms, ops_ms),
                "bound_by": "bytes" if bytes_ms >= ops_ms else "operations"}

    k1_main = k1_bound(n_adult, f_adult, adult_bins.itemsize, n_bins)
    k1_large = k1_bound(N_LARGE, 14, 1, 256)
    fit_s = [fit_first_s]
    for _ in range(2):
        reset_counts()
        torch.cuda.synchronize()
        start = time.perf_counter()
        adult_fit()
        torch.cuda.synchronize()
        fit_s.append(time.perf_counter() - start)
        check(bin_index.builds == 1,
              f"a timed fit built {bin_index.builds} bin indexes")
    fit_median = statistics.median(fit_s)
    emit({"phase": "times_train", "k1_shape": {
              "n": n_adult, "f": f_adult, "b": n_bins, "bins": "uint8"},
          "k1_ms": k1_ms, "k1_ms_building_index": k1_ms_building_index,
          "k1_host_ms_per_call": k1_host_ms,
          "k1_ms_skewed_90pct": k1_ms_skewed,
          "k1_ms_1m_rows": k1_ms_1m, "k1_ms_1m_rows_skewed_90pct":
          k1_ms_1m_skewed, "bin_index_ms": index_ms,
          "bin_index_ms_1m_rows": index_ms_1m,
          "k1_plain_ms": k1_plain_ms, "k1_library_ms": k1_library_ms,
          "k1_library_ms_1m_rows": k1_library_ms_1m,
          "k1_library_ms_1m_rows_skewed_90pct": k1_library_ms_1m_skewed,
          "k1_bound": k1_main, "k1_bound_1m_rows": k1_large,
          "fit_s": fit_s,
          "fit_rows_iterations_per_s": n_adult * 100 / fit_median,
          "k1_launches_per_fit": train_counts["histogram"],
          "bin_index_builds_per_fit": train_counts["bin_index_builds"],
          "fit_breakdown": fit_breakdown(adult_fit),
          "fit_device_busy": device_busy(adult_fit), "nvidia_smi": smi})

    # the sampled fit, and the key stream and masks of one of its trees
    # (two splits of the key, the bagging draw, the feature permutation and
    # the masked index) on the card, host wall with a synchronise at the end
    sampled_s = [sampled_first_s]
    for _ in range(2):
        reset_counts()
        torch.cuda.synchronize()
        start = time.perf_counter()
        sampled_fit()
        torch.cuda.synchronize()
        sampled_s.append(time.perf_counter() - start)
    sp = boosting.BoostParams(**SAMPLED_PARAMS)
    g_card, h_card = torch.from_numpy(g0).cuda(), torch.from_numpy(h0).cuda()
    y_card = torch.from_numpy(y_adult.astype(np.float32)).cuda()
    card_index = bin_index(card_bins, n_bins)
    stream = {"rng": prng.prng_key(0, "cuda")}

    def tree_sampling():
        stream["rng"], key = prng.split(stream["rng"])
        row_key, feature_key = prng.split(key)
        boosting._sample_rows(sp, g_card, h_card, y_card, row_key)
        mask_features(card_index, card_bins, boosting._feature_keep(
            sp, card_bins.shape[1], feature_key))

    def wall_ms(fn, calls: int = 100) -> float:
        fn()
        torch.cuda.synchronize()
        start = time.perf_counter()
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
        return (time.perf_counter() - start) / calls * 1e3

    sampled_median = statistics.median(sampled_s)
    emit({"phase": "times_sampled", "config": SAMPLED_PARAMS,
          "fit_s": sampled_s,
          "fit_rows_iterations_per_s": n_adult * 100 / sampled_median,
          "plain_fit_s": fit_s,
          "sampled_over_plain_median": sampled_median / fit_median,
          "sampling_ms_per_tree": wall_ms(tree_sampling),
          "key_split_ms": wall_ms(lambda: prng.split(stream["rng"])),
          "fit_breakdown": fit_breakdown(sampled_fit),
          "fit_device_busy": device_busy(sampled_fit), "nvidia_smi": smi})

    # the ranker and the categorical fit: seconds, rows*iterations/s, the
    # ranker's breakdown and busy share, and the gradient at its shape
    rank_s = [rank_first_s]
    cat_s = [cat_first_s]
    for _ in range(2):
        for fit, times_s in ((rank_fit, rank_s), (cat_fit, cat_s)):
            reset_counts()
            torch.cuda.synchronize()
            start = time.perf_counter()
            fit()
            torch.cuda.synchronize()
            times_s.append(time.perf_counter() - start)
            check(bin_index.builds == 1,
                  f"a timed fit built {bin_index.builds} bin indexes")
    qidx_d, qmask_d, qinv_d = (torch.from_numpy(a).cuda() for a in
                               objectives.build_query_blocks(g_rank))
    margins_d = torch.from_numpy(ranker.booster.predict_raw(
        x_rank, device="cuda").astype(np.float32)).cuda()
    labels_d = torch.from_numpy(y_rank.astype(np.float32)).cuda()
    grad_ms = cuda_ms(lambda: objectives.lambdarank_grad_blocked(
        margins_d, labels_d, qidx_d, qmask_d, qinv_d), reps=3, inner=5)
    zero_ms = cuda_ms(lambda: objectives.lambdarank_grad_blocked(
        torch.zeros_like(margins_d), labels_d, qidx_d, qmask_d, qinv_d),
        reps=3, inner=5)
    rank_median = statistics.median(rank_s)
    cat_median = statistics.median(cat_s)
    n_rank = len(y_rank)
    emit({"phase": "times_ranker",
          "rows": list(x_rank.shape), "queries": int(qidx.shape[0]),
          "pairs_per_gradient": int(qidx.shape[0] * qidx.shape[1] ** 2),
          "fit_s": rank_s,
          "fit_rows_iterations_per_s": n_rank * 100 / rank_median,
          "k1_launches_per_fit": rank_counts["histogram"],
          "lambdarank_grad_ms": grad_ms,
          "lambdarank_grad_ms_at_init_margins": zero_ms,
          "fit_breakdown": fit_breakdown(rank_fit),
          "fit_device_busy": device_busy(rank_fit),
          "categorical_fit_s": cat_s,
          "categorical_fit_rows_iterations_per_s":
              len(y_cat) * 100 / cat_median,
          "categorical_over_plain_median": cat_median / fit_median,
          "nvidia_smi": smi})

    # -- 13-15. data-parallel training: two ranks sharing the card --------
    dp = dp_phases(x_adult, y_adult, fit_s, fit_median, smi)
    dp_counts = dp["counts"]

    # -- 16-19. the data plane: partition streams, rendezvous, launcher ---
    part_counts = partition_phases(x_adult, y_adult, dp["params"], dp, smi)

    emit({"kernels": [{
        "name": "forest_traverse", "route": "cuda",
        "source": "synapseml_tpu_torch/csrc/forest_traverse.cu",
        "replaces": "synapseml_tpu/gbdt/pallas_kernels.py:179",
        "launches": launches, "launches_ranker_fit":
        rank_counts["forest_traverse"], "launches_categorical_fit":
        cat_counts["forest_traverse"], "launches_dp_fit_per_rank":
        [c["forest_traverse"] for c in dp_counts],
        "launches_partitions_fit_per_rank":
        [c["forest_traverse"] for c in part_counts],
        "max_abs_err": max_err, "bitwise": True,
        "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
        "bound_by": bound_by, "library_ms": None}, {
        "name": "histogram", "route": "cuda",
        "source": "synapseml_tpu_torch/csrc/histogram.cu",
        "replaces": "synapseml_tpu/gbdt/pallas_kernels.py:79",
        "launches": train_counts["histogram"],
        "launches_sampled_fit": sampled_counts["histogram"],
        "launches_ranker_fit": rank_counts["histogram"],
        "launches_categorical_fit": cat_counts["histogram"],
        "launches_dp_fit_per_rank": [c["histogram"] for c in dp_counts],
        "launches_partitions_fit_per_rank":
        [c["histogram"] for c in part_counts],
        "max_abs_err": k1_max_err,
        "bitwise": True, "ms": k1_ms, "plain_ms": k1_plain_ms,
        "bound_ms": k1_main["bound_ms"], "bound_by": k1_main["bound_by"],
        "library_ms": k1_library_ms}]})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())

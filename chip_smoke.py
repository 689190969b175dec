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
   bitwise; the histogram (K1) bitwise against its plain version run on
   the CPU from the same inputs (on the card ``index_add_`` adds with
   atomics, in no fixed order), and five K1 launches bitwise identical;
4. main_path — LightGBMClassificationModel.load_native_model on the
   100-tree, 31-leaf Adult fixture and ``transform`` of 65,536 and
   1,048,576 rows on the card, with the kernels' launch counts read around
   the run, and the fixture's recorded JAX outputs matched;
5. iforest — IsolationForest(100 trees, 256 samples) fitted on the host
   from seeded 65,536 x 14 rows, scored on the card through the strict
   traversal, matched against the plain version on the CPU;
6. train   — the training path: LightGBMClassifier(100 iterations, 31
   leaves).fit on the 32,561 x 14 Adult rows on the card, with the
   kernels' launch counts read around the fit and ``transform``; the
   result held to the JAX-trained fixture (training logloss within 1e-4,
   margins on the fixture's rows within 1e-3); then a 3-class fit, an L2
   regressor fit and an early-stopped fit, each on the card and on the CPU
   with the same port code;
7. times   — kernel, plain-version and library-call times (CUDA events,
   median of repeats after a warm-up), the kernels' bounds, the
   transform's rows/s, the fit's wall seconds and rows*iterations/s, and
   a breakdown of one fit.

Then the kernel summary line, the ``nvidia-smi`` name/power line, and
last ``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
FIXTURE = os.path.join(HERE, "tests", "fixtures", "lgbm_adult_100x31.txt")
FIXTURE_IO = os.path.join(HERE, "tests", "fixtures",
                          "lgbm_adult_100x31_io.npz")
HBM_BYTES_PER_S = 3.35e12     # H100 SXM device memory
FP32_OPS_PER_S = 67e12        # H100 SXM float32 outside the tensor cores
N_MAIN, N_LARGE = 65_536, 1_048_576
PROB_ATOL = 1e-7              # only if numpy's exp differs from the fixture's
LOGLOSS_TOL = 1e-4            # training logloss, port fit vs JAX fixture
MARGIN_TOL_FIXTURE = 1e-3     # mean |margin| gap on the fixture's rows
MARGIN_TOL_CPU = 1e-4         # card fit vs CPU fit of the same port code


def emit(obj) -> None:
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
    with a synchronise before and after: K1 launches, the rest of the
    per-leaf histogram (the [N, 3] data), the split search, the row
    partition, the host syncs (device-to-host copies of each split's
    numbers) and everything else; plus the number of host syncs."""
    from synapseml_tpu_torch.gbdt import grower, kernels

    parts = {"k1": 0.0, "histogram_data": 0.0, "split_search": 0.0,
             "partition": 0.0, "host_syncs": 0.0}
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
        if hasattr(fn, "launches"):   # the wrapped kernel counts here
            timed.launches = fn.launches
        setattr(module, name, timed)

    wrap(kernels, "histogram", "k1")
    wrap(grower, "histogram", "histogram_data")
    wrap(grower, "best_split", "split_search")
    wrap(grower, "_partition", "partition")
    wrap(grower, "_to_host", "host_syncs", counted=True)
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


def cuda_ms(fn, reps: int = 5, inner: int = 20) -> float:
    """Median over ``reps`` of the mean ms of ``inner`` back-to-back calls,
    timed with CUDA events after one warm-up call."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(inner):
            fn()
        stop.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(stop) / inner)
    return statistics.median(times)


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
    from synapseml_tpu_torch.gbdt import grower
    from synapseml_tpu_torch.gbdt.binning import BinMapper
    from synapseml_tpu_torch.gbdt.boosting import Booster
    from synapseml_tpu_torch.gbdt.estimators import (
        LightGBMClassificationModel, LightGBMClassifier, LightGBMRegressor)
    from synapseml_tpu_torch.gbdt.kernels import (
        forest_traverse, forest_traverse_reference, histogram,
        histogram_reference)
    from synapseml_tpu_torch.isolationforest import IsolationForest

    def reset_counts():
        forest_traverse.launches = 0
        histogram.launches = 0

    def read_counts() -> dict:
        return {"forest_traverse": forest_traverse.launches,
                "histogram": histogram.launches}

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

    k1_cases = [
        ("adult_full_mask", adult_bins,
         hist_data(np.ones(len(y_adult), bool)), n_bins),
        ("adult_leaf_30pct", adult_bins,
         hist_data(rng.random(len(y_adult)) < 0.3), n_bins),
        ("adult_zero_mask", adult_bins,
         hist_data(np.zeros(len(y_adult), bool)), n_bins),
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
        got = histogram(torch.from_numpy(b).cuda(), torch.from_numpy(d).cuda(),
                        nb)
        torch.cuda.synchronize()
        got = got.cpu()
        k1_results.append({
            "case": name, "shape": list(b.shape), "dtype": str(b.dtype),
            "n_bins": nb, "bitwise": bool(torch.equal(got, want)),
            "max_abs_err": float((got - want).abs().max())})
    zero = k1_results[2]
    adult_bd = torch.from_numpy(adult_bins).cuda()
    adult_dd = torch.from_numpy(k1_cases[0][2]).cuda()
    repeats = [histogram(adult_bd, adult_dd, n_bins) for _ in range(5)]
    deterministic = all(torch.equal(repeats[0], r) for r in repeats[1:])
    emit({"phase": "kernel_vs_plain", "kernel": "histogram",
          "tolerance": "bitwise (torch.equal) against the plain version run "
                       "on the CPU from the same inputs",
          "cases": k1_results, "five_launches_bitwise_identical":
          deterministic})
    check(all(r["bitwise"] for r in k1_results),
          "histogram differs from its plain version")
    check(zero["max_abs_err"] == 0.0 and zero["bitwise"],
          "an all-zero mask does not give exact zeros")
    check(deterministic, "five histogram launches are not bitwise equal")
    k1_max_err = max(r["max_abs_err"] for r in k1_results)

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

    def card_and_cpu(name, make, table, query):
        """Fit with the same port code on the card and on the CPU."""
        boosters = {dev: make().fit(table, device=dev).booster
                    for dev in ("cuda", "cpu")}
        raw = {dev: b.predict_raw(query, device=dev)
               for dev, b in boosters.items()}
        same_dev = same_trees(boosters["cuda"], boosters["cpu"])
        result = {
            "fit": name, "rows": list(table["features"].shape),
            "trees": len(same_dev), "identical_trees": sum(same_dev),
            "first_difference": first_difference(
                boosters["cuda"], boosters["cpu"], same_dev),
            "margin_max_gap": float(np.abs(raw["cuda"] - raw["cpu"]).max()),
            "best_iteration": {d: b.best_iteration
                               for d, b in boosters.items()}}
        check(result["margin_max_gap"] <= MARGIN_TOL_CPU,
              f"{name}: card and CPU margins differ by "
              f"{result['margin_max_gap']}")
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

    # -- 7. times -------------------------------------------------------
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

    # K1 at the main shape (the Adult root histogram) and at 1M rows
    k1_ms = cuda_ms(lambda: histogram(adult_bd, adult_dd, n_bins))
    big_bins = torch.from_numpy(rng.integers(
        0, 256, (N_LARGE, 14)).astype(np.uint8)).cuda()
    big_data = torch.from_numpy(rng.normal(
        size=(N_LARGE, 3)).astype(np.float32)).cuda()
    k1_ms_1m = cuda_ms(lambda: histogram(big_bins, big_data, 256),
                       reps=3, inner=5)
    k1_plain_ms = cuda_ms(
        lambda: histogram_reference(adult_bd, adult_dd, n_bins))
    n_adult, f_adult = adult_bins.shape
    ids = (adult_bd.long() + torch.arange(f_adult, device="cuda")[None, :]
           * n_bins).reshape(-1)
    flat = adult_dd[:, None, :].expand(-1, f_adult, 3).reshape(-1, 3)
    flat = flat.contiguous()
    acc = torch.zeros((f_adult * n_bins, 3), device="cuda")
    k1_library_ms = cuda_ms(lambda: acc.index_add_(0, ids, flat))

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
        torch.cuda.synchronize()
        start = time.perf_counter()
        adult_fit()
        torch.cuda.synchronize()
        fit_s.append(time.perf_counter() - start)
    fit_median = statistics.median(fit_s)
    emit({"phase": "times_train", "k1_shape": {
              "n": n_adult, "f": f_adult, "b": n_bins, "bins": "uint8"},
          "k1_ms": k1_ms, "k1_ms_1m_rows": k1_ms_1m,
          "k1_plain_ms": k1_plain_ms, "k1_library_ms": k1_library_ms,
          "k1_bound": k1_main, "k1_bound_1m_rows": k1_large,
          "fit_s": fit_s,
          "fit_rows_iterations_per_s": n_adult * 100 / fit_median,
          "k1_launches_per_fit": train_counts["histogram"],
          "fit_breakdown": fit_breakdown(adult_fit), "nvidia_smi": smi})

    emit({"kernels": [{
        "name": "forest_traverse", "route": "cuda",
        "source": "synapseml_tpu_torch/csrc/forest_traverse.cu",
        "replaces": "synapseml_tpu/gbdt/pallas_kernels.py:179",
        "launches": launches, "max_abs_err": max_err, "bitwise": True,
        "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
        "bound_by": bound_by, "library_ms": None}, {
        "name": "histogram", "route": "cuda",
        "source": "synapseml_tpu_torch/csrc/histogram.cu",
        "replaces": "synapseml_tpu/gbdt/pallas_kernels.py:79",
        "launches": train_counts["histogram"], "max_abs_err": k1_max_err,
        "bitwise": True, "ms": k1_ms, "plain_ms": k1_plain_ms,
        "bound_ms": k1_main["bound_ms"], "bound_by": k1_main["bound_by"],
        "library_ms": k1_library_ms}]})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())

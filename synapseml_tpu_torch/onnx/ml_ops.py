"""``ai.onnx.ml`` domain ops on PyTorch — the classical-ML opset.

The counterpart of the reference package's ``onnx/ml_ops.py``. Converted
LightGBM and scikit-learn graphs (``convert_lightgbm``, skl2onnx) are built
from these ops: TreeEnsembleClassifier/Regressor, ZipMap, Scaler, the SVM
family and friends. The same 19 ops register through the importer's ``op``
decorator, with the reference's semantics and refusals.

Design notes:
- **Tree ensembles are two GEMMs**, as in the reference (the GEMM
  tree-inference form): every node's test is one elementwise pass over
  ``x[:, feat]``, leaf membership is ``einsum(decisions, path) + c0 ==
  plen`` with ``path[t, m, l]`` in {+1, -1, 0}, and the leaf weights apply
  through a second einsum. The first product is a sum of small integers,
  so ``reached`` is exact and equals the reference's bitwise; the second
  sums in matmul order, not tree order, and runs in IEEE float32 (every
  graph run turns TF32 off, ``importer._ieee_float32``). K2, the booster's
  forest traversal, is not used here: parity is with the reference's form.
- **Tables are built once, on the host, and bound once to the device.**
  The host tables of a node (``_TreeTables``, the SVM's support vectors,
  ``LabelEncoder``'s sorted keys, the linear ops' weights) are built at the
  node's first use and kept on the imported node's context, under a lock.
  ``ImportedGraph.bind`` puts their device copies into the bound node
  (``_bound_node`` reads each op's ``_constants``), so a bound forward and
  a CUDA-graph replay copy nothing to the card. An unbound ``apply`` copies
  them on each call.
- **Host-only values** (string labels, ``CategoryMapper``, the string side
  of ``LabelEncoder``, ``DictVectorizer``'s dict rows, ``CastMap``'s dict
  form) stay numpy object arrays: device tensors cannot hold strings.
- **Dtypes** follow the reference's, but for int64, which the reference
  narrows to int32 on the device and the port keeps.
- **Departure:** a tree ensemble refuses an input narrower than the
  features its splits read (``ValueError``); the reference's gather clamps
  the column index and scores the row from the wrong feature.
"""
from __future__ import annotations

import threading
import types
import warnings
from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch

from synapseml_tpu_torch.onnx.importer import (
    _device_of, _is_host, _operands, _result_dtype, _tensor, op)

# branch-mode codes for the vectorized comparator
_MODES = {"BRANCH_LEQ": 0, "BRANCH_LT": 1, "BRANCH_GTE": 2, "BRANCH_GT": 3,
          "BRANCH_EQ": 4, "BRANCH_NEQ": 5, "LEAF": 6}

# the dense GEMM formulation trades memory for throughput; these bound
# the [T, M, n_leaves] path tensor (see _TreeTables)
_PATH_WARN_BYTES = 256 << 20
_PATH_GUARD_BYTES = 2 << 30

# builds of host tables, once per imported node (re-entrant: a node's
# constants read its cached tables)
_BUILD_LOCK = threading.RLock()


def _cached(ctx, key: str, build: Callable[[], Any]):
    """Host-side preprocessing cached on the node's attr dict — runs once
    per imported graph, whichever thread gets there first."""
    got = ctx.attrs.get(key)
    if got is None:
        with _BUILD_LOCK:
            got = ctx.attrs.get(key)
            if got is None:
                got = build()
                ctx.attrs[key] = got
    return got


def _constants(host: Callable[[Any], Dict[str, np.ndarray]]):
    """Declare an op's device constants: ``host(ctx)`` gives them as numpy
    (cached on the imported node); ``bind`` moves them to its device once
    (``importer._bound_node``)."""
    def deco(fn):
        fn._constants = lambda ctx: _cached(ctx, "__host_constants__",
                                            lambda: host(ctx))
        return fn
    return deco


def _on(ctx, fn, dev: torch.device) -> Dict[str, torch.Tensor]:
    """``fn``'s constants on ``dev``: the bound copies, or (an unbound
    ``apply``, or a bound node run on another device) copies made for
    this call."""
    bound = ctx.attrs.get("__bound__")
    if bound is not None:
        first = next(iter(bound.values()), None)
        if first is None or (first.device.type == dev.type and dev.index
                             in (None, first.device.index)):
            return bound
    return {k: _tensor(v, dev) for k, v in fn._constants(ctx).items()}


def _dev_tensor(x) -> torch.Tensor:
    """``jnp.asarray(x)``: a host value becomes a tensor on the run's
    device."""
    return x if isinstance(x, torch.Tensor) else _tensor(x)


def _host_array(x) -> np.ndarray:
    """``np.asarray(x)`` of a host value or a tensor (a copy to the host)."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


class _TreeTables:
    """GEMM-ified ensemble from the flat (treeid, nodeid) attributes.

    Every node's test evaluates as one elementwise pass, and leaf
    membership becomes a batched matmul: a sample reaches leaf l of tree t
    iff its path-consistent decision count equals the path length, i.e.
    ``einsum(decisions, P) + c0 == plen`` with P[t,m,l] in {+1,-1,0};
    leaf values then apply through a second einsum. The only gather is
    ``x[:, feat_ids]`` with constant indices.
    """

    def __init__(self, ctx, weight_prefix: str, n_out: int):
        a = ctx.attrs
        tree_ids = np.asarray(a["nodes_treeids"], np.int64)
        node_ids = np.asarray(a["nodes_nodeids"], np.int64)
        modes = [str(m) for m in a["nodes_modes"]]
        trees = np.unique(tree_ids)
        t_index = {t: i for i, t in enumerate(trees)}
        tn = self.n_trees = len(trees)
        m = int(node_ids.max()) + 1 if len(node_ids) else 1

        feat = np.zeros((tn, m), np.int64)
        thresh = np.full((tn, m), np.inf, np.float32)
        left = np.zeros((tn, m), np.int32)
        right = np.zeros((tn, m), np.int32)
        mode = np.full((tn, m), _MODES["LEAF"], np.int8)
        miss_true = np.zeros((tn, m), np.bool_)

        missing = a.get("nodes_missing_value_tracks_true") or []
        feats_attr = np.asarray(a["nodes_featureids"], np.int64)
        vals_attr = np.asarray(a["nodes_values"], np.float64)
        true_ids = np.asarray(a["nodes_truenodeids"], np.int64)
        false_ids = np.asarray(a["nodes_falsenodeids"], np.int64)

        referenced = [set() for _ in range(tn)]
        present = [set() for _ in range(tn)]
        for i in range(len(tree_ids)):
            t = t_index[tree_ids[i]]
            n = node_ids[i]
            md = _MODES.get(modes[i])
            if md is None:
                raise NotImplementedError(
                    f"TreeEnsemble node mode {modes[i]!r} not supported")
            mode[t, n] = md
            present[t].add(int(n))
            if md != _MODES["LEAF"]:
                feat[t, n] = feats_attr[i]
                thresh[t, n] = vals_attr[i]
                left[t, n] = true_ids[i]
                right[t, n] = false_ids[i]
                referenced[t].add(int(true_ids[i]))
                referenced[t].add(int(false_ids[i]))
                if i < len(missing):
                    miss_true[t, n] = bool(missing[i])

        # leaf -> output weights, scattered at (tree, node, out_id)
        w_tree = np.asarray(a[f"{weight_prefix}_treeids"], np.int64)
        w_node = np.asarray(a[f"{weight_prefix}_nodeids"], np.int64)
        w_id = np.asarray(a[f"{weight_prefix}_ids"], np.int64)
        w_val = np.asarray(a[f"{weight_prefix}_weights"], np.float64)
        uniq_ids = np.unique(w_id) if len(w_id) else np.array([], np.int64)
        self.distinct_out_ids = len(uniq_ids)
        # the single accumulated column for binary one-score ensembles —
        # spec-valid graphs may scatter into id 1, not 0
        self.single_out_id = int(uniq_ids[0]) if len(uniq_ids) == 1 else None
        node_weights = np.zeros((tn, m, n_out), np.float64)
        for i in range(len(w_tree)):
            node_weights[t_index[w_tree[i]], w_node[i], w_id[i]] += w_val[i]

        # per-tree DFS from the root: collect each leaf's (must-true,
        # must-false) ancestor sets
        leaves_per_tree: List[List] = []
        for t in range(tn):
            root_cand = sorted(present[t] - referenced[t])
            root = root_cand[0] if root_cand else 0
            leaves = []  # (leaf_node, pos_nodes, neg_nodes)
            stack = [(root, [], [])]
            while stack:
                n, pos, neg = stack.pop()
                if mode[t, n] == _MODES["LEAF"]:
                    leaves.append((n, pos, neg))
                else:
                    stack.append((int(left[t, n]), pos + [n], neg))
                    stack.append((int(right[t, n]), pos, neg + [n]))
            leaves_per_tree.append(leaves)
        n_leaves = max(len(lv) for lv in leaves_per_tree)

        # the dense [T, M, n_leaves] path tensor scales as trees x nodes x
        # leaves: fine at notebook scale, but a 1000-tree deep ensemble
        # would allocate gigabytes at import — surface that before numpy
        # does it silently
        path_bytes = tn * m * n_leaves * 4
        if path_bytes > _PATH_GUARD_BYTES:
            raise MemoryError(
                f"tree-ensemble path tensor would allocate "
                f"{path_bytes / (1 << 30):.1f} GiB "
                f"({tn} trees x {m} nodes x {n_leaves} leaves); this "
                f"GEMM formulation targets notebook-scale ensembles — "
                f"score via the native GBDT predictor instead")
        if path_bytes > _PATH_WARN_BYTES:
            warnings.warn(
                f"tree-ensemble path tensor allocates "
                f"{path_bytes / (1 << 20):.0f} MiB "
                f"({tn} trees x {m} nodes x {n_leaves} leaves)",
                RuntimeWarning, stacklevel=2)

        path = np.zeros((tn, m, n_leaves), np.float32)   # +1 / -1 / 0
        c0 = np.zeros((tn, n_leaves), np.float32)        # sum of negatives
        plen = np.full((tn, n_leaves), -1.0, np.float32)  # pad: unreachable
        leaf_w = np.zeros((tn, n_leaves, n_out), np.float32)
        for t, leaves in enumerate(leaves_per_tree):
            for li, (n, pos, neg) in enumerate(leaves):
                path[t, pos, li] = 1.0
                path[t, neg, li] = -1.0
                c0[t, li] = len(neg)
                plen[t, li] = len(pos) + len(neg)
                leaf_w[t, li] = node_weights[t, n]

        self.feat_flat = feat.reshape(-1)                # [T*M] constant
        self.thresh_flat = thresh.reshape(-1)
        self.mode_flat = mode.reshape(-1)
        self.miss_flat = miss_true.reshape(-1)
        self.all_leq = bool(np.all(
            (mode == _MODES["LEAF"]) | (mode == _MODES["BRANCH_LEQ"])))
        self.any_missing_true = bool(miss_true.any())
        self.path, self.c0, self.plen = path, c0, plen
        self.weights = leaf_w
        self.m = m
        # the narrowest input the splits can read
        internal = mode.reshape(-1) != _MODES["LEAF"]
        self.width = int(self.feat_flat[internal].max()) + 1 \
            if internal.any() else 0

    def host(self) -> Dict[str, np.ndarray]:
        """The device constants of :meth:`scores`, as numpy."""
        out = {"feat": self.feat_flat, "thresh": self.thresh_flat,
               "path": self.path, "c0": self.c0, "plen": self.plen,
               "weights": self.weights}
        if self.any_missing_true:
            out["miss"] = self.miss_flat
        if not self.all_leq:
            for code in range(6):
                sel = self.mode_flat == code
                if sel.any():
                    out[f"sel{code}"] = sel
        return out

    def nbytes(self) -> int:
        return sum(v.nbytes for v in self.host().values())

    def reached(self, x, c: Dict[str, torch.Tensor]) -> torch.Tensor:
        """[N, T, n_leaves] float32 leaf membership (1.0 where a row ends in
        that leaf): the decision pass and the first, exact, einsum."""
        x = _dev_tensor(x)
        if x.ndim == 1:
            x = x[None, :]
        if x.shape[-1] < self.width:
            raise ValueError(
                f"tree ensemble reads feature {self.width - 1}, but its "
                f"input has {x.shape[-1]} columns")
        n = x.shape[0]
        xv = x.index_select(1, c["feat"]).to(torch.float32)  # [N, T*M]
        thr = c["thresh"]
        if self.all_leq:
            cond = xv <= thr
        else:
            conds = (torch.le, torch.lt, torch.ge, torch.gt, torch.eq,
                     torch.ne)
            cond = torch.zeros_like(xv, dtype=torch.bool)
            for code in range(6):
                sel = c.get(f"sel{code}")
                if sel is not None:
                    cond = torch.where(sel, conds[code](xv, thr), cond)
        nan = torch.isnan(xv)
        if self.any_missing_true:
            cond = torch.where(nan, c["miss"], cond)
        else:
            cond = cond & ~nan
        d = cond.to(torch.float32).reshape(n, self.n_trees, self.m)
        count = torch.einsum("ntm,tml->ntl", d, c["path"])
        return (count + c["c0"][None] == c["plen"][None]).to(torch.float32)

    def scores(self, x, c: Dict[str, torch.Tensor]) -> torch.Tensor:
        """[N, n_out] summed leaf weights, two einsums + elementwise."""
        return torch.einsum("ntl,tlk->nk", self.reached(x, c), c["weights"])


def _post_transform(scores, kind: str):
    if kind in ("NONE", ""):
        return scores
    if kind == "LOGISTIC":
        return torch.sigmoid(scores)
    if kind == "SOFTMAX":
        return torch.softmax(scores, dim=-1)
    if kind == "SOFTMAX_ZERO":
        # softmax over nonzero entries; zeros stay zero (an all-zero row
        # divides by the 1e-30 clamp: zeros, as in the reference)
        nz = scores != 0
        top = torch.where(nz, scores, -torch.inf).amax(-1, keepdim=True)
        e = torch.where(nz, torch.exp(scores - top), 0.0)
        return e / torch.clamp(e.sum(-1, keepdim=True), min=1e-30)
    raise NotImplementedError(f"post_transform {kind!r} not supported")


def _classifier_outputs(ctx, scores, labels: torch.Tensor):
    """(label, probabilities) with the single-score binary expansion
    (onnxruntime's binary_case: one accumulated score, two labels).
    ``labels`` are the int64 class labels on the scores' device. As in the
    reference, a SOFTMAX binary single score is not transformed: the
    probabilities are ``[1 - s, s]`` of the raw score."""
    if ctx.attr("classlabels_strings"):
        raise NotImplementedError(
            "string class labels need host-side mapping; use int64 labels")
    pt = str(ctx.attr("post_transform", "NONE"))
    if labels.shape[0] == 2 and scores.shape[-1] == 1:
        p = _post_transform(scores[..., 0], pt if pt != "SOFTMAX" else "NONE")
        probs = torch.stack([1.0 - p, p], dim=-1)
    else:
        probs = _post_transform(scores, pt)
    return labels[torch.argmax(probs, dim=-1)], probs


def _labels_i(ctx) -> np.ndarray:
    labels_i = ctx.attr("classlabels_int64s")
    return np.asarray(labels_i if labels_i else [0, 1], np.int64)


# -- tree ensembles -----------------------------------------------------------

def _classifier_tables(ctx) -> _TreeTables:
    labels = ctx.attr("classlabels_int64s") or ctx.attr(
        "classlabels_strings") or [0, 1]
    k = len(labels)

    def build():
        t = _TreeTables(ctx, "class", k)
        # single-output binary ensembles accumulate one score column
        # (whichever out_id it was scattered into)
        if k == 2 and t.distinct_out_ids <= 1:
            col = t.single_out_id or 0
            t.weights = np.ascontiguousarray(t.weights[..., col:col + 1])
        return t
    return _cached(ctx, "__tables__", build)


def _tree_classifier_host(ctx) -> Dict[str, np.ndarray]:
    tables = _classifier_tables(ctx)
    out = dict(tables.host(), labels=_labels_i(ctx))
    base = ctx.attr("base_values")
    if base:
        out["base"] = np.asarray(base, np.float32)[: tables.weights.shape[-1]]
    return out


@_constants(_tree_classifier_host)
@op("TreeEnsembleClassifier")
def _tree_classifier(ctx, x):
    tables = _classifier_tables(ctx)
    c = _on(ctx, _tree_classifier, _device_of((x,)))
    scores = tables.scores(x, c)
    if "base" in c:
        scores = scores + c["base"]
    return _classifier_outputs(ctx, scores, c["labels"])


def _regressor_tables(ctx) -> _TreeTables:
    n_targets = int(ctx.attr("n_targets", 1))
    return _cached(ctx, "__tables__",
                   lambda: _TreeTables(ctx, "target", n_targets))


def _tree_regressor_host(ctx) -> Dict[str, np.ndarray]:
    out = dict(_regressor_tables(ctx).host())
    base = ctx.attr("base_values")
    if base:
        out["base"] = np.asarray(base, np.float32)
    return out


@_constants(_tree_regressor_host)
@op("TreeEnsembleRegressor")
def _tree_regressor(ctx, x):
    tables = _regressor_tables(ctx)
    c = _on(ctx, _tree_regressor, _device_of((x,)))
    agg = str(ctx.attr("aggregate_function", "SUM"))
    if agg == "AVERAGE":
        scores = tables.scores(x, c) / max(tables.n_trees, 1)
    elif agg == "SUM":
        scores = tables.scores(x, c)
    else:
        raise NotImplementedError(f"aggregate_function {agg!r}")
    if "base" in c:
        scores = scores + c["base"]
    return _post_transform(scores, str(ctx.attr("post_transform", "NONE")))


# new-style TreeEnsemble (ai.onnx.ml opset 5) integer codes
_V5_MODES = {0: "BRANCH_LEQ", 1: "BRANCH_LT", 2: "BRANCH_GTE",
             3: "BRANCH_GT", 4: "BRANCH_EQ", 5: "BRANCH_NEQ"}
_V5_POST = {0: "NONE", 1: "SOFTMAX", 2: "LOGISTIC", 3: "SOFTMAX_ZERO"}


def _v5_tables(ctx) -> _TreeTables:
    """The opset-5 compact encoding — internal nodes and leaves in separate
    arrays, child pointers tagged by nodes_trueleafs/falseleafs flags —
    unrolled into the flat (treeid, nodeid) form."""
    def build():
        a = ctx.attrs
        roots = [int(r) for r in a["tree_roots"]]
        modes = np.asarray(a["nodes_modes"]).reshape(-1)
        splits = np.asarray(a["nodes_splits"], np.float64).reshape(-1)
        feats = [int(v) for v in a["nodes_featureids"]]
        tru = [int(v) for v in a["nodes_truenodeids"]]
        fal = [int(v) for v in a["nodes_falsenodeids"]]
        tru_leaf = [int(v) for v in a["nodes_trueleafs"]]
        fal_leaf = [int(v) for v in a["nodes_falseleafs"]]
        miss = a.get("nodes_missing_value_tracks_true") or []
        leaf_tid = [int(v) for v in a["leaf_targetids"]]
        leaf_w = np.asarray(a["leaf_weights"], np.float64).reshape(-1)
        if any(int(m) == 6 for m in modes):
            raise NotImplementedError(
                "TreeEnsemble BRANCH_MEMBER (set membership via "
                "membership_values) is not supported; re-export with "
                "equality splits")
        old: Dict[str, list] = {k: [] for k in (
            "nodes_treeids", "nodes_nodeids", "nodes_modes",
            "nodes_featureids", "nodes_values", "nodes_truenodeids",
            "nodes_falsenodeids", "nodes_missing_value_tracks_true",
            "target_treeids", "target_nodeids", "target_ids",
            "target_weights")}

        for t, root in enumerate(roots):
            # explicit-stack unroll (deep unpruned trees must not hit
            # Python's recursion limit at import); children patch their
            # parent's child-pointer slot once their own id is assigned
            nid = 0
            stack = [(root, False, None, None)]
            while stack:
                idx, is_leaf, patch_pos, child_slot = stack.pop()
                if patch_pos is not None:
                    old[child_slot][patch_pos] = nid
                old["nodes_treeids"].append(t)
                old["nodes_nodeids"].append(nid)
                if is_leaf:
                    old["nodes_modes"].append("LEAF")
                    old["nodes_featureids"].append(0)
                    old["nodes_values"].append(0.0)
                    old["nodes_missing_value_tracks_true"].append(0)
                    old["nodes_truenodeids"].append(0)
                    old["nodes_falsenodeids"].append(0)
                    old["target_treeids"].append(t)
                    old["target_nodeids"].append(nid)
                    old["target_ids"].append(leaf_tid[idx])
                    old["target_weights"].append(float(leaf_w[idx]))
                else:
                    old["nodes_modes"].append(_V5_MODES[int(modes[idx])])
                    old["nodes_featureids"].append(feats[idx])
                    old["nodes_values"].append(float(splits[idx]))
                    old["nodes_missing_value_tracks_true"].append(
                        int(miss[idx]) if idx < len(miss) else 0)
                    pos = len(old["nodes_truenodeids"])
                    old["nodes_truenodeids"].append(-1)  # patched above
                    old["nodes_falsenodeids"].append(-1)
                    stack.append((fal[idx], bool(fal_leaf[idx]), pos,
                                  "nodes_falsenodeids"))
                    stack.append((tru[idx], bool(tru_leaf[idx]), pos,
                                  "nodes_truenodeids"))
                nid += 1
        n_out = int(ctx.attr("n_targets", 0)) or (max(leaf_tid) + 1)
        return _TreeTables(
            types.SimpleNamespace(attrs=old), "target", n_out)
    return _cached(ctx, "__tables__", build)


@_constants(lambda ctx: _v5_tables(ctx).host())
@op("TreeEnsemble")
def _tree_ensemble_v5(ctx, x):
    """ai.onnx.ml opset-5 TreeEnsemble (the regressor/classifier merger
    that new converters emit), through the same GEMM tables."""
    tables = _v5_tables(ctx)
    c = _on(ctx, _tree_ensemble_v5, _device_of((x,)))
    agg = int(ctx.attr("aggregate_function", 1))
    if agg == 0:
        scores = tables.scores(x, c) / max(tables.n_trees, 1)
    elif agg == 1:
        scores = tables.scores(x, c)
    else:
        raise NotImplementedError(
            f"TreeEnsemble aggregate_function={agg} (MIN/MAX) is not "
            "supported; converters emit SUM/AVERAGE")
    pt = int(ctx.attr("post_transform", 0))
    if pt not in _V5_POST:
        raise NotImplementedError(f"TreeEnsemble post_transform={pt}")
    return _post_transform(scores, _V5_POST[pt])


# -- maps, scalers and the linear models --------------------------------------

@op("ZipMap")
def _zipmap(ctx, probs):
    # seq<map<label, score>> lowered to the dense tensor: the reference
    # flattens the maps back into a vector column immediately
    # (ONNXModel.scala:156-171,255-263), so downstream semantics match.
    return probs


@op("CastMap")
def _cast_map(ctx, x):
    """CastMap: map<int64, T> -> tensor. A python dict (a genuine map
    value) is densified per map_form/max_map on the host; the ZipMap
    lowering's dense vector just casts."""
    cast_to = str(ctx.attr("cast_to", "TO_FLOAT"))
    if isinstance(x, dict):
        keys = sorted(int(k) for k in x)
        if str(ctx.attr("map_form", "DENSE")) == "DENSE":
            arr = np.asarray([x[k] for k in keys])
        else:
            max_map = int(ctx.attr("max_map", 0))
            arr = np.zeros(max_map)
            for k in keys:
                if 0 <= k < max_map:
                    arr[k] = x[k]
        arr = arr.reshape(1, -1)  # spec output is [1, C] per map
    else:
        arr = np.asarray(x) if _is_host(x) else x
    if cast_to == "TO_FLOAT":
        return (np.asarray(arr, np.float32) if _is_host(arr)
                else arr.to(torch.float32))
    if cast_to == "TO_INT64":
        return (np.asarray(arr, np.int64) if _is_host(arr)
                else arr.to(torch.int64))
    if cast_to == "TO_STRING":
        if not _is_host(arr):
            raise NotImplementedError(
                "CastMap TO_STRING needs host values (strings cannot be "
                "device tensors)")
        return np.asarray([str(v) for v in
                           np.asarray(arr).reshape(-1)],
                          dtype=object).reshape(np.shape(arr))
    raise ValueError(f"CastMap cast_to {cast_to!r}")


def _scaler_host(ctx) -> Dict[str, np.ndarray]:
    return {"offset": np.asarray(ctx.attr("offset", [0.0]), np.float32),
            "scale": np.asarray(ctx.attr("scale", [1.0]), np.float32)}


@_constants(_scaler_host)
@op("Scaler")
def _scaler(ctx, x):
    if _is_host(x):
        h = _scaler._constants(ctx)
        return (np.asarray(x, np.float32) - h["offset"]) * h["scale"]
    c = _on(ctx, _scaler, x.device)
    x, offset, scale = _operands((x, c["offset"], c["scale"]))
    return (x - offset) * scale


@op("Normalizer")
def _normalizer(ctx, x):
    kind = str(ctx.attr("norm", "MAX"))
    x = _dev_tensor(x)
    if not x.is_floating_point():
        x = x.to(torch.float32)
    if kind == "MAX":
        d = x.abs().amax(-1, keepdim=True)
    elif kind == "L1":
        d = x.abs().sum(-1, keepdim=True)
    elif kind == "L2":
        d = torch.sqrt((x * x).sum(-1, keepdim=True))
    else:
        raise NotImplementedError(f"Normalizer norm {kind!r}")
    return x / torch.clamp(d, min=1e-30)


def _linear_host(ctx) -> Dict[str, np.ndarray]:
    out = {"coeff": np.asarray(ctx.attr("coefficients"), np.float32),
           "inter": np.asarray(ctx.attr("intercepts", [0.0]), np.float32)}
    if ctx.op_type == "LinearClassifier":
        out["labels"] = _linear_labels(ctx)
    return out


def _linear_labels(ctx) -> np.ndarray:
    """The reference aliases ``classlabels_ints`` into the shared
    ``classlabels_int64s`` (a ``setdefault``) and reads the latter."""
    labels = ctx.attr("classlabels_ints") or ctx.attr(
        "classlabels_int64s") or [0, 1]
    eff = ctx.attrs["classlabels_int64s"] \
        if "classlabels_int64s" in ctx.attrs else list(labels)
    return np.asarray(eff if eff else [0, 1], np.int64)


def _affine(x, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    x, w = _operands((_dev_tensor(x), w))
    return torch.matmul(x, w.T) + b


@_constants(_linear_host)
@op("LinearClassifier")
def _linear_classifier(ctx, x):
    """As in the reference, the class count is the coefficients' size over
    the input's width: an input of the wrong width is not refused."""
    c = _on(ctx, _linear_classifier, _device_of((x,)))
    width = int(np.shape(x)[-1]) if _is_host(x) else int(x.shape[-1])
    k = c["coeff"].numel() // (max(1, width) if _is_host(x) else width)
    scores = _affine(x, c["coeff"].reshape(k, -1), c["inter"])
    return _classifier_outputs(ctx, scores, c["labels"])


@_constants(_linear_host)
@op("LinearRegressor")
def _linear_regressor(ctx, x):
    c = _on(ctx, _linear_regressor, _device_of((x,)))
    targets = int(ctx.attr("targets", 1))
    y = _affine(x, c["coeff"].reshape(targets, -1), c["inter"])
    return _post_transform(y, str(ctx.attr("post_transform", "NONE")))


def _imputer_host(ctx) -> Dict[str, np.ndarray]:
    imputed = ctx.attr("imputed_value_floats")
    if imputed is None:
        imputed = ctx.attr("imputed_value_int64s")
    imputed = np.asarray(imputed, np.float32)
    return {"fill": imputed if imputed.size > 1 else imputed[0]}


@_constants(_imputer_host)
@op("Imputer")
def _imputer(ctx, x):
    replaced = ctx.attr("replaced_value_float",
                        ctx.attr("replaced_value_int64"))
    x = _dev_tensor(x)
    fill = _on(ctx, _imputer, x.device)["fill"]
    if replaced is None or (isinstance(replaced, float)
                            and np.isnan(replaced)):
        bad = torch.isnan(x)
    else:
        # a concrete replaced_value leaves NaNs untouched (ORT semantics)
        bad = x == replaced
    dt = _result_dtype((x, fill))
    return torch.where(bad, fill.to(dt), x.to(dt))


@op("Binarizer")
def _binarizer(ctx, x):
    thr = float(ctx.attr("threshold", 0.0))
    x = _dev_tensor(x)
    return (x > thr).to(x.dtype)


@op("ArrayFeatureExtractor")
def _array_feature_extractor(ctx, x, idx):
    if _is_host(x):
        return np.asarray(x)[..., np.asarray(idx, np.int64).reshape(-1)]
    if isinstance(idx, torch.Tensor):
        return x[..., idx.reshape(-1).long()]
    # a host index: slices of its consecutive runs (JAX's gather: negative
    # indices wrap, others clamp), so a forward copies no index to the card
    n = x.shape[-1]
    i = np.asarray(idx, np.int64).reshape(-1)
    i = np.clip(np.where(i < 0, i + n, i), 0, n - 1)
    if i.size == 0:
        return x[..., :0]
    cuts = np.flatnonzero(np.diff(i) != 1) + 1
    parts = [x[..., int(r[0]):int(r[-1]) + 1] for r in np.split(i, cuts)]
    return parts[0] if len(parts) == 1 else torch.cat(parts, dim=-1)


@op("FeatureVectorizer")
def _feature_vectorizer(ctx, *xs):
    cols = [_dev_tensor(x) for x in xs if x is not None]
    cols = [c[:, None] if c.ndim == 1 else c.reshape(c.shape[0], -1)
            for c in cols]
    dt = _result_dtype(cols)
    return torch.cat([c.to(dt) for c in cols], dim=1)


def _label_encoder_host(ctx) -> Dict[str, np.ndarray]:
    keys_i = ctx.attr("keys_int64s")
    vals_i = ctx.attr("values_int64s")
    vals_f = ctx.attr("values_floats")
    if keys_i is None or (vals_i is None and vals_f is None):
        return {}
    keys = np.asarray(keys_i, np.int64)
    vals = np.asarray(vals_i if vals_i is not None else vals_f)
    default = ctx.attr("default_int64", ctx.attr("default_float", -1))
    order = np.argsort(keys)
    sv = vals[order]
    return {"keys": keys[order], "vals": sv,
            "default": np.asarray(default, sv.dtype)}


@_constants(_label_encoder_host)
@op("LabelEncoder")
def _label_encoder(ctx, x):
    # int->int / int->float lookup runs on device; string sides are
    # host-only (device tensors cannot hold strings)
    keys_i = ctx.attr("keys_int64s")
    vals_i = ctx.attr("values_int64s")
    vals_f = ctx.attr("values_floats")
    if keys_i is not None and (vals_i is not None or vals_f is not None):
        if _is_host(x):
            keys = np.asarray(keys_i, np.int64)
            vals = np.asarray(vals_i if vals_i is not None else vals_f)
            default = ctx.attr("default_int64",
                               ctx.attr("default_float", -1))
            lut = {int(k): v for k, v in zip(keys, vals)}
            flat = np.asarray(
                [lut.get(int(v), default)
                 for v in np.asarray(x).reshape(-1)])
            return flat.reshape(np.asarray(x).shape).astype(vals.dtype)
        # device path: searchsorted over the sorted keys bound at bind
        c = _on(ctx, _label_encoder, x.device)
        sk, sv = c["keys"], c["vals"]
        dt = torch.promote_types(sk.dtype, x.dtype)
        sk_d, xq = sk.to(dt), x.to(dt)
        pos = torch.clamp(torch.searchsorted(sk_d, xq.contiguous()), 0,
                          sk.shape[0] - 1)
        hit = sk_d[pos] == xq
        return torch.where(hit, sv[pos], c["default"])
    # string maps: host-only object arrays
    keys_s = ctx.attr("keys_strings")
    if keys_s is not None and _is_host(x):
        vals = (ctx.attr("values_int64s") or ctx.attr("values_floats")
                or ctx.attr("values_strings"))
        default = ctx.attr(
            "default_int64",
            ctx.attr("default_float", ctx.attr("default_string", "_Unused")))
        # built once a node: a text vocabulary's map is ~10^5 keys, and a
        # SequenceMap body runs the node once a document
        lut = _cached(ctx, "__string_map__", lambda: dict(zip(keys_s, vals)))
        arr = np.asarray(x, dtype=object).reshape(-1)
        out = np.asarray([lut.get(str(v), default) for v in arr])
        return out.reshape(np.asarray(x, dtype=object).shape)
    raise NotImplementedError(
        "LabelEncoder: string-keyed maps need host-side (object) inputs")


@op("CategoryMapper")
def _category_mapper(ctx, x):
    cats_i = np.asarray(ctx.attr("cats_int64s", []), np.int64)
    cats_s = ctx.attr("cats_strings", [])
    if _is_host(x) and np.asarray(x).dtype == object:
        lut = {str(s): int(i) for s, i in zip(cats_s, cats_i)}
        default = int(ctx.attr("default_int64", -1))
        arr = np.asarray(x, dtype=object).reshape(-1)
        return np.asarray([lut.get(str(v), default) for v in arr],
                          np.int64).reshape(np.asarray(x, object).shape)
    # int -> string direction is host-only as well
    lut_rev = {int(i): s for i, s in zip(cats_i, cats_s)}
    default_s = str(ctx.attr("default_string", "_Unused"))
    host = _host_array(x)
    arr = host.reshape(-1)
    out = np.empty(arr.shape, dtype=object)
    for j, v in enumerate(arr):
        out[j] = lut_rev.get(int(v), default_s)
    return out.reshape(host.shape)


def _one_hot_host(ctx) -> Dict[str, np.ndarray]:
    cats = ctx.attr("cats_int64s")
    return {} if cats is None else {"cats": np.asarray(cats, np.int64)}


@_constants(_one_hot_host)
@op("OneHotEncoder")
def _ml_one_hot(ctx, x):
    if ctx.attr("cats_int64s") is None:
        raise NotImplementedError(
            "OneHotEncoder: only cats_int64s is supported")
    x = _dev_tensor(x)
    cats = _on(ctx, _ml_one_hot, x.device)["cats"]
    # zeros=0 would demand an error on an unknown category; the reference
    # stays permissive (a row of zeros)
    return (x[..., None] == cats).to(torch.float32)


# -- SVM family (sklearn-converted exports) ------------------------------------

def _svm_kernel(x, sv, kind: str, gamma: float, coef0: float,
                degree: float):
    """Batched kernel matrix [N, S] — one gram matmul per call."""
    dot = x @ sv.T
    if kind == "LINEAR":
        return dot
    if kind == "POLY":
        return (gamma * dot + coef0) ** degree
    if kind == "RBF":
        d2 = ((x * x).sum(-1)[:, None] - 2.0 * dot
              + (sv * sv).sum(-1)[None, :])
        return torch.exp(-gamma * d2)
    if kind == "SIGMOID":
        return torch.tanh(gamma * dot + coef0)
    raise NotImplementedError(f"SVM kernel_type {kind!r}")


def _svm_params(ctx):
    kp = [float(v) for v in (ctx.attr("kernel_params") or [])]
    gamma = kp[0] if len(kp) > 0 else 1.0
    coef0 = kp[1] if len(kp) > 1 else 0.0
    degree = kp[2] if len(kp) > 2 else 3.0
    return str(ctx.attr("kernel_type", "LINEAR")), gamma, coef0, degree


def _svm_classifier_host(ctx) -> Dict[str, np.ndarray]:
    sv = np.asarray(ctx.attr("support_vectors") or [], np.float32)
    out = {"coefs": np.asarray(ctx.attr("coefficients"), np.float32),
           "rho": np.asarray(ctx.attr("rho"), np.float32)}
    labels_i = ctx.attr("classlabels_int64s")
    if sv.size == 0:
        out["labels"] = np.asarray(labels_i if labels_i else [0, 1],
                                   np.int64)
        return out
    vpc = np.asarray(ctx.attr("vectors_per_class"), np.int64)
    k = len(vpc)
    n_sv = int(vpc.sum())
    out.update(
        labels=np.asarray(labels_i if labels_i else list(range(k)),
                          np.int64),
        sv=sv.reshape(n_sv, -1),
        dual=out["coefs"].reshape(k - 1, n_sv))   # [k-1, n_sv] dual coefs
    return out


@_constants(_svm_classifier_host)
@op("SVMClassifier")
def _svm_classifier(ctx, x):
    """One-vs-one SVC (support-vector mode) or linear-weight mode.
    Outputs (label, scores): scores are the k*(k-1)/2 ovo decision
    values in (0,1),(0,2),..,(1,2).. order, with the libsvm/onnxruntime
    sign convention — positive votes the FIRST class of the pair."""
    if ctx.attr("prob_a"):
        raise NotImplementedError(
            "SVMClassifier Platt-scaled probabilities (prob_a/prob_b) "
            "are not supported; re-export without probability=True")
    if ctx.attr("classlabels_strings"):
        raise NotImplementedError(
            "string class labels need host-side mapping; use int64 labels")
    kind, gamma, coef0, degree = _svm_params(ctx)
    x = _dev_tensor(x).to(torch.float32)
    c = _on(ctx, _svm_classifier, x.device)
    labels = c["labels"]
    pt = str(ctx.attr("post_transform", "NONE"))

    if "sv" not in c:
        # linear-weight mode: the row count comes from the coefficient
        # size; a binary export carries ONE weight row whose raw decision
        # thresholds at 0 — expanded to (-s, s) so argmax is that
        # threshold
        coefs = c["coefs"]
        k_rows = max(1, coefs.numel() // int(x.shape[-1]))
        scores = x @ coefs.reshape(k_rows, -1).T + c["rho"]
        if k_rows == 1 and labels.shape[0] == 2:
            scores = torch.cat([-scores, scores], dim=-1)
        return (labels[torch.argmax(scores, dim=-1)],
                _post_transform(scores, pt))

    vpc = np.asarray(ctx.attr("vectors_per_class"), np.int64)
    k = len(vpc)
    starts = np.concatenate([[0], np.cumsum(vpc)])
    rho = np.asarray(ctx.attr("rho"), np.float32)
    dual = c["dual"]
    K = _svm_kernel(x, c["sv"], kind, gamma, coef0, degree)   # [N, n_sv]
    decisions = []
    votes = torch.zeros((x.shape[0], k), dtype=torch.int32, device=x.device)
    p = 0
    for i in range(k):
        for j in range(i + 1, k):
            si, ei = int(starts[i]), int(starts[i + 1])
            sj, ej = int(starts[j]), int(starts[j + 1])
            dec = (K[:, si:ei] @ dual[j - 1, si:ei]
                   + K[:, sj:ej] @ dual[i, sj:ej] + float(rho[p]))
            decisions.append(dec)
            win = dec > 0
            votes[:, i] += win.to(torch.int32)
            votes[:, j] += (~win).to(torch.int32)
            p += 1
    scores = torch.stack(decisions, dim=-1)       # [N, k*(k-1)/2]
    return labels[torch.argmax(votes, dim=-1)], _post_transform(scores, pt)


def _svm_regressor_host(ctx) -> Dict[str, np.ndarray]:
    out = {"coefs": np.asarray(ctx.attr("coefficients"),
                               np.float32).reshape(-1)}
    n_sup = int(ctx.attr("n_supports", 0))
    if n_sup:
        out["sv"] = np.asarray(ctx.attr("support_vectors"),
                               np.float32).reshape(n_sup, -1)
    return out


@_constants(_svm_regressor_host)
@op("SVMRegressor")
def _svm_regressor(ctx, x):
    kind, gamma, coef0, degree = _svm_params(ctx)
    rho = float(np.asarray(ctx.attr("rho"), np.float32).reshape(-1)[0])
    x = _dev_tensor(x).to(torch.float32)
    c = _on(ctx, _svm_regressor, x.device)
    if "sv" not in c:
        y = x @ c["coefs"] + rho
    else:
        y = _svm_kernel(x, c["sv"], kind, gamma, coef0, degree) \
            @ c["coefs"] + rho
    if int(ctx.attr("one_class", 0)):
        # OneClassSVM exports: onnxruntime maps the score to +/-1
        y = torch.where(y > 0, 1.0, -1.0)
    y = _post_transform(y, str(ctx.attr("post_transform", "NONE")))
    return y[:, None]


@op("DictVectorizer")
def _dict_vectorizer(ctx, x):
    """map<key, value> rows -> dense columns per the vocabulary order.
    Maps only exist host-side (object arrays of dicts)."""
    vocab = (ctx.attr("string_vocabulary")
             or ctx.attr("int64_vocabulary"))
    if vocab is None:
        raise ValueError("DictVectorizer needs a vocabulary attribute")
    if not _is_host(x):
        raise NotImplementedError(
            "DictVectorizer consumes map values, which only exist "
            "host-side; feed object rows of dicts")
    rows = np.asarray(x, dtype=object).reshape(-1)
    out = np.zeros((len(rows), len(vocab)), np.float32)
    index = {k: i for i, k in enumerate(vocab)}
    for r, d in enumerate(rows):
        for key, val in dict(d).items():
            i = index.get(key)
            if i is not None:
                out[r, i] = val
    return out


def tree_tables(ctx) -> Optional[_TreeTables]:
    """The host tables a tree-ensemble node was built with (None for any
    other node, or one not yet used): their size is what ``bind`` moves to
    the device."""
    return ctx.attrs.get("__tables__")

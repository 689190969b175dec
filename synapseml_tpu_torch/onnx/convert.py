"""Model -> ONNX converters (the onnxmltools role, in-framework).

The counterpart of the reference package's ``onnx/convert.py``: it walks
the port's :class:`~synapseml_tpu_torch.gbdt.boosting.Booster` (its numpy
tree arrays) and emits an ``ai.onnx.ml`` TreeEnsembleClassifier/Regressor
graph, consumed back by :mod:`synapseml_tpu_torch.onnx.ml_ops` (or by
onnxruntime anywhere else — the output is standard ONNX). For the same
model, the graph's nodes and attributes are the reference's; only the
``producer`` string names this package.

Semantics map 1:1: every split is ``BRANCH_LEQ`` with the false branch
taken on missing values (NaN comparisons are False in the engine —
see gbdt/kernels.py forest_traverse), leaf weights carry the tree weight
(rf averaging / dart renormalization folded in), ``base_values`` carries
the init score, and the LightGBM ``sigmoid`` parameter is folded into
weights so the standard LOGISTIC post-transform reproduces
``Booster.predict`` exactly.
"""
from __future__ import annotations

import warnings
from typing import Optional

import numpy as np

from synapseml_tpu_torch.gbdt.boosting import Booster
from synapseml_tpu_torch.onnx.builder import GraphBuilder


def _booster_of(model) -> Booster:
    if isinstance(model, Booster):
        return model
    booster = getattr(model, "booster", None)
    if booster is None:
        raise TypeError(
            f"expected a Booster or fitted LightGBM model, got {type(model)}")
    return booster


def convert_lightgbm(model, input_size: Optional[int] = None,
                     name: str = "lightgbm") -> bytes:
    """Serialize a trained GBDT model as an ONNX tree-ensemble graph.

    Matches ``Booster.predict`` (sigmoid/softmax probabilities for
    classifiers, raw scores for regressors — link functions like
    poisson's exp are not expressible in the ONNX tree ops and raise).
    Respects ``best_iteration`` the way ``predict`` does.
    """
    b = _booster_of(model)
    if getattr(b, "trees_cat", None) is not None:
        raise NotImplementedError(
            "ONNX tree ensembles cannot express LightGBM set-membership "
            "categorical splits; convert a numerically-split model")
    k = max(1, b.num_class)
    t_total = b.num_trees
    if b.best_iteration >= 0:
        t_total = min(t_total, (b.best_iteration + 1) * k)
    n_features = b.num_features if b.num_features > 0 else int(input_size or 0)
    if n_features <= 0:
        raise ValueError("input_size is required when the booster does not "
                         "record num_features")

    objective = b.params.objective
    is_classifier = objective in (
        "binary", "binary_logloss", "multiclass", "softmax")
    if objective in ("poisson", "tweedie"):
        raise NotImplementedError(
            f"{objective}: the exp link is not expressible in ONNX tree "
            f"ensembles; export raw scores via a regression objective")
    if objective == "multiclassova":
        raise NotImplementedError(
            "multiclassova: per-class sigmoid + renormalization has no "
            "ONNX post_transform equivalent (LOGISTIC does not renormalize)")
    sigmoid = float(getattr(b.params, "sigmoid", 1.0) or 1.0)
    scale = sigmoid if objective in ("binary", "binary_logloss") else 1.0

    nodes_treeids, nodes_nodeids, nodes_featureids = [], [], []
    nodes_modes, nodes_values = [], []
    nodes_true, nodes_false = [], []
    w_tree, w_node, w_id, w_val = [], [], [], []

    feat = np.asarray(b.trees_feature)
    thr = np.asarray(b.trees_threshold)
    left = np.asarray(b.trees_left)
    right = np.asarray(b.trees_right)
    value = np.asarray(b.trees_value)
    tw = np.asarray(b.tree_weights, dtype=np.float64).copy()
    if b.params.boosting_type == "rf" and t_total > 0:
        # rf margins average over the trees actually exported; a model
        # truncated at best_iteration must renormalize from 1/T_total to
        # 1/T_kept, exactly as Booster._raw_scores does
        tw[:] = 1.0 / max(t_total // k, 1)
    m = feat.shape[1]

    for t in range(t_total):
        out_id = (t % k) if (is_classifier and k > 1) else 0
        for n in range(m):
            nodes_treeids.append(t)
            nodes_nodeids.append(n)
            if feat[t, n] < 0:  # leaf
                nodes_featureids.append(0)
                nodes_modes.append("LEAF")
                nodes_values.append(0.0)
                nodes_true.append(n)
                nodes_false.append(n)
                w_tree.append(t)
                w_node.append(n)
                w_id.append(out_id)
                w_val.append(float(value[t, n]) * float(tw[t]) * scale)
            else:
                nodes_featureids.append(int(feat[t, n]))
                nodes_modes.append("BRANCH_LEQ")
                nodes_values.append(float(thr[t, n]))
                nodes_true.append(int(left[t, n]))
                nodes_false.append(int(right[t, n]))

    g = GraphBuilder(name=name, opset=17)
    x = g.add_input("input", np.float32, ["N", n_features])
    common = dict(
        nodes_treeids=nodes_treeids, nodes_nodeids=nodes_nodeids,
        nodes_featureids=nodes_featureids, nodes_modes=nodes_modes,
        nodes_values=[float(v) for v in nodes_values],
        nodes_truenodeids=nodes_true, nodes_falsenodeids=nodes_false,
        nodes_missing_value_tracks_true=[0] * len(nodes_treeids),
    )
    init = float(b.init_score)
    if is_classifier:
        n_labels = k if k > 1 else 2
        post = "SOFTMAX" if k > 1 else "LOGISTIC"
        base = [init] * k if k > 1 else [init * scale]
        # a fitted classification model remembers the original labels it
        # remapped to dense ids; export those so the ONNX 'label' output
        # agrees with model.transform's prediction column
        labels = list(range(n_labels))
        lv = getattr(model, "label_values", None)
        if lv is not None and len(lv) >= n_labels:
            if all(float(v) == int(v) for v in lv[:n_labels]):
                labels = [int(v) for v in lv[:n_labels]]
            else:
                warnings.warn(
                    f"label_values {list(lv[:n_labels])} are not integral; "
                    f"classlabels_int64s cannot express them, so the ONNX "
                    f"'label' output speaks dense indices 0..{n_labels - 1} "
                    f"instead of the original labels",
                    RuntimeWarning, stacklevel=2)
        g.add_node(
            "TreeEnsembleClassifier", [x],
            outputs=["label", "probabilities"], domain="ai.onnx.ml",
            class_treeids=w_tree, class_nodeids=w_node, class_ids=w_id,
            class_weights=[float(v) for v in w_val],
            classlabels_int64s=labels,
            post_transform=post, base_values=[float(v) for v in base],
            **common)
        g.add_output("label", np.int64, ["N"])
        g.add_output("probabilities", np.float32, ["N", n_labels])
    else:
        g.add_node(
            "TreeEnsembleRegressor", [x],
            outputs=["variable"], domain="ai.onnx.ml",
            target_treeids=w_tree, target_nodeids=w_node, target_ids=w_id,
            target_weights=[float(v) for v in w_val], n_targets=1,
            aggregate_function="SUM", post_transform="NONE",
            base_values=[init], **common)
        g.add_output("variable", np.float32, ["N", 1])
    return g.to_bytes(producer="synapseml_tpu_torch.onnx.convert")

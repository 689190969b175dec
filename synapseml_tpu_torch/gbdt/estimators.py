"""LightGBM-surface learners and models over the port's GBDT engine.

Counterpart of ``synapseml_tpu/gbdt/estimators.py``: the shared param
surface, the learners (``LightGBMClassifier``, ``LightGBMRegressor``),
the fitted-model base (native model load/save, importances, leaf
predict, SHAP) and the classification, regression and ranking models
(ref: lightgbm/.../LightGBMClassifier.scala, LightGBMRegressor.scala,
LightGBMRanker.scala) — same param names, same output columns
(rawPrediction / probability / prediction). ``fit`` and ``transform`` run
on the device they are given, the card unless the caller asks for the
CPU.
"""
from __future__ import annotations

import dataclasses
import logging
import os
from typing import List, Optional

import numpy as np

from synapseml_tpu_torch.core.param import ComplexParam, Param
from synapseml_tpu_torch.core.pipeline import Estimator, Model
from synapseml_tpu_torch.data.table import Table
from synapseml_tpu_torch.gbdt.boosting import (
    Booster, BoostParams, objective_transform, train)


class LightGBMDelegate:
    """User callback hooks around training
    (ref: lightgbm/.../LightGBMDelegate.scala:12-62).

    Subclass and override; attach via the estimator's ``delegate`` param.
    ``after_train_iteration`` fires after every boosting iteration, with
    the number of iterations completed so far. ``get_learning_rate`` is
    consulted once per iteration BEFORE the run to assemble a shrinkage
    schedule (it sees batch index, iteration and the previous rate — the
    same signature contract as the reference's dynamic-LR delegate).
    """

    def before_train_batch(self, batch_index: int, table: Table,
                           prev_model) -> None:
        """(ref: LightGBMDelegate.scala beforeTrainBatch:13)."""

    def after_train_batch(self, batch_index: int, table: Table,
                          model) -> None:
        """(ref: LightGBMDelegate.scala afterTrainBatch:18)."""

    def after_train_iteration(self, batch_index: int,
                              iterations_done: int) -> None:
        """(ref: LightGBMDelegate.scala afterTrainIteration:49)."""

    def get_learning_rate(self, batch_index: int, iteration: int,
                          previous_rate: float) -> float:
        """(ref: LightGBMDelegate.scala getLearningRate:57)."""
        return previous_rate


class _LightGBMParams:
    """Shared param surface (ref: lightgbm/.../params/LightGBMParams.scala)."""
    features_col = Param("features column (2-D) or None to use feature_cols",
                         default="features")
    feature_cols = Param("explicit list of scalar feature columns", default=None)
    label_col = Param("label column", default="label")
    weight_col = Param("sample weight column", default=None)
    validation_indicator_col = Param(
        "bool column marking validation rows", default=None)
    prediction_col = Param("prediction column", default="prediction")
    boosting_type = Param("gbdt|rf|dart|goss", default="gbdt")
    num_iterations = Param("boosting rounds", default=100)
    learning_rate = Param("shrinkage", default=0.1)
    num_leaves = Param("max leaves per tree", default=31)
    max_depth = Param("max depth, 0=unlimited", default=-1)
    lambda_l1 = Param("L1 regularization", default=0.0)
    lambda_l2 = Param("L2 regularization", default=0.0)
    min_data_in_leaf = Param("min rows per leaf", default=20)
    min_sum_hessian_in_leaf = Param("min hessian per leaf", default=1e-3)
    min_gain_to_split = Param("min split gain", default=0.0)
    max_bin = Param("histogram bins", default=255)
    bin_sample_count = Param(
        "rows sampled to construct bin boundaries (reference "
        "binSampleCount, TrainParams.scala:17); also caps the cross-host "
        "gather of the row-sharded multi-host fit", default=200_000)
    feature_fraction = Param("feature subsample per tree", default=1.0)
    bagging_fraction = Param("row subsample", default=1.0)
    bagging_freq = Param("bagging frequency", default=0)
    bagging_seed = Param(
        "independent seed for the bagging stream (reference baggingSeed); "
        "None derives it from seed", default=None)
    pos_bagging_fraction = Param(
        "per-iteration subsample of positive rows (binary only)",
        default=1.0)
    neg_bagging_fraction = Param(
        "per-iteration subsample of negative rows (binary only)",
        default=1.0)
    top_rate = Param("GOSS top rate", default=0.2)
    other_rate = Param("GOSS other rate", default=0.1)
    drop_rate = Param("DART per-tree drop probability", default=0.1)
    max_drop = Param("DART max trees dropped per iteration (<=0 = no "
                     "limit)", default=50)
    skip_drop = Param("DART probability of skipping dropout entirely",
                      default=0.5)
    uniform_drop = Param(
        "DART: True = uniform Bernoulli tree selection; False (LightGBM "
        "default) drops proportionally to current tree weight",
        default=False)
    xgboost_dart_mode = Param(
        "DART: normalize dropped rounds with lr/(k+lr) (xgboost's rule) "
        "instead of lr/(k+1)", default=False)
    boost_from_average = Param(
        "initialize scores from the label average (LightGBM "
        "boost_from_average)", default=True)
    early_stopping_round = Param("early stopping patience", default=0)
    improvement_tolerance = Param(
        "metric delta below which an iteration does not count as "
        "improved (reference improvementTolerance)", default=0.0)
    categorical_slot_indexes = Param("categorical feature slots", default=None)
    parallelism = Param(
        "distributed tree learner (ref LightGBMParams.scala:16-18): "
        "data_parallel (full-histogram dp psum) or voting_parallel "
        "(PV-tree top_k feature election; merges only elected "
        "features' histograms per split)",
        default="data_parallel",
        type_check=lambda v: v in ("data_parallel", "voting_parallel"))
    top_k = Param("voting_parallel features elected per split "
                  "(LightGBM top_k)", default=20)
    metric = Param("eval metric override", default=None)
    seed = Param("random seed", default=0)
    verbosity = Param("verbosity", default=-1)
    hist_backend = Param(
        "the reference's histogram formulation (auto / pallas / xla); "
        "accepted so stages saved by the JAX package load, not read: the "
        "port always builds histograms with its one kernel (K1)",
        default="auto",
        type_check=lambda v: v in ("auto", "pallas", "xla"))

    def _features(self, table: Table) -> np.ndarray:
        cols = self.feature_cols
        if cols:
            return np.column_stack(
                [np.asarray(table[c], np.float64) for c in cols])
        feats = table[self.features_col]
        if feats.ndim == 1 and feats.dtype == object:
            feats = np.stack([np.asarray(v, np.float64) for v in feats])
        return np.asarray(feats, np.float64)

    def _boost_params(self, objective: str, num_class: int = 1) -> BoostParams:
        return BoostParams(
            objective=objective,
            boosting_type=self.boosting_type,
            num_iterations=int(self.num_iterations),
            learning_rate=float(self.learning_rate),
            num_leaves=int(self.num_leaves),
            max_depth=max(0, int(self.max_depth)),
            lambda_l1=float(self.lambda_l1),
            lambda_l2=float(self.lambda_l2),
            min_data_in_leaf=int(self.min_data_in_leaf),
            min_sum_hessian_in_leaf=float(self.min_sum_hessian_in_leaf),
            min_gain_to_split=float(self.min_gain_to_split),
            max_bin=int(self.max_bin),
            bin_sample_count=int(self.bin_sample_count),
            feature_fraction=float(self.feature_fraction),
            bagging_fraction=float(self.bagging_fraction),
            bagging_freq=int(self.bagging_freq),
            bagging_seed=(None if self.get("bagging_seed") is None
                          else int(self.bagging_seed)),
            pos_bagging_fraction=float(self.pos_bagging_fraction),
            neg_bagging_fraction=float(self.neg_bagging_fraction),
            top_rate=float(self.top_rate),
            other_rate=float(self.other_rate),
            drop_rate=float(self.drop_rate),
            max_drop=int(self.max_drop),
            skip_drop=float(self.skip_drop),
            uniform_drop=bool(self.uniform_drop),
            xgboost_dart_mode=bool(self.xgboost_dart_mode),
            boost_from_average=bool(self.boost_from_average),
            early_stopping_round=int(self.early_stopping_round),
            improvement_tolerance=float(self.improvement_tolerance),
            num_class=num_class,
            metric=self.get("metric"),
            seed=int(self.seed),
            categorical_features=tuple(self.categorical_slot_indexes or ()),
            hist_backend=self.hist_backend,
            tree_learner=str(self.parallelism),
            voting_top_k=int(self.top_k),
        )

    def _make_model(self, model_cls, booster):
        model = model_cls(booster=booster)
        declared = model.params()
        model._paramMap.update(
            {k: v for k, v in self._paramMap.items() if k in declared})
        return model

    def _split_validation(self, table: Table):
        vcol = self.validation_indicator_col
        if vcol and vcol in table:
            mask = np.asarray(table[vcol], bool)
            return table.filter(~mask), table.filter(mask)
        return table, None


class _LightGBMModelBase(Model, _LightGBMParams):
    """Fitted model wrapper (ref model methods:
    lightgbm/.../LightGBMModelMethods.scala:12-116)."""

    def __init__(self, booster: Optional[Booster] = None, **kw):
        super().__init__(**kw)
        self.booster = booster

    def get_feature_importances(self, importance_type: str = "split") -> List[float]:
        imp = (self.booster.feature_importance_gain
               if importance_type == "gain"
               else self.booster.feature_importance_split)
        return list(np.asarray(imp, float))

    def predict_leaf(self, table: Table, device: str = "cuda") -> np.ndarray:
        return self.booster.predict_leaf(self._features(table), device=device)

    def shap_values(self, table: Table) -> np.ndarray:
        from synapseml_tpu_torch.gbdt.shap import tree_shap
        return tree_shap(self.booster, self._features(table))

    def get_feature_shaps(self, features) -> List[float]:
        """Per-feature SHAP values (+ expected value last) for ONE row,
        flattened to K*(F+1) floats for multiclass — the reference's
        flat-array contract
        (ref: LightGBMModelMethods.scala getFeatureShaps:27)."""
        from synapseml_tpu_torch.gbdt.shap import tree_shap
        row = np.asarray(features, np.float64).reshape(1, -1)
        return list(np.asarray(tree_shap(self.booster, row)[0],
                               float).ravel())

    # booster introspection getters
    # (ref: LightGBMModelMethods.scala:55-96)
    def get_booster_best_iteration(self) -> int:
        return int(self.booster.best_iteration)

    def get_booster_num_total_iterations(self) -> int:
        return int(self.booster.num_iterations)

    def get_booster_num_total_model(self) -> int:
        return int(self.booster.num_trees)

    def get_booster_num_features(self) -> int:
        return int(self.booster.num_features)

    def get_booster_num_classes(self) -> int:
        return int(self.booster.num_class)

    def save_native_model(self, path: str):
        """Write the booster in LightGBM's native text format
        (ref: LightGBMBooster.scala:454 saveNativeModel)."""
        with open(path, "w") as f:
            f.write(self.booster.save_string())

    @classmethod
    def load_native_model(cls, path: str, **kw):
        """Load a native LightGBM text model file into a fitted model
        (ref: LightGBMClassifier.scala loadNativeModelFromFile)."""
        with open(path) as f:
            return cls(booster=Booster.load_string(f.read()), **kw)

    # serde: booster goes to a side file (native LightGBM text format)
    def _save_extra(self, path: str):
        with open(os.path.join(path, "booster.txt"), "w") as f:
            f.write(self.booster.save_string())

    def _load_extra(self, path: str):
        p = os.path.join(path, "booster.txt")
        if not os.path.exists(p):  # round-1 artifacts
            p = os.path.join(path, "booster.json")
        with open(p) as f:
            self.booster = Booster.load_string(f.read())


class _LightGBMEstimatorBase(Estimator, _LightGBMParams):
    """Batch-training driver shared by the learners
    (ref: LightGBMBase.scala train:46-61 — randomSplit into numBatches,
    thread the booster via setModelString, before/afterTrainBatch hooks).

    ``num_batches``/``delegate`` live here, NOT on the shared param
    mixin: they are training-only knobs, and a fitted model must never
    pickle the user's callback object into its saved artifact.
    """

    num_batches = Param(
        "split training into N sequential batches, threading the booster "
        "from each into the next (ref: LightGBMBase.scala train:46-61)",
        default=0)
    delegate = ComplexParam(
        "optional LightGBMDelegate with batch/iteration/LR hooks")

    def _delegate_train_kwargs(self, batch_index: int) -> dict:
        """learning-rate schedule + iteration hook from the delegate."""
        d = self.get("delegate")
        out: dict = {}
        if d is None:
            return out
        if (type(d).get_learning_rate
                is not LightGBMDelegate.get_learning_rate):
            lrs, prev = [], float(self.learning_rate)
            for it in range(int(self.num_iterations)):
                prev = float(d.get_learning_rate(batch_index, it, prev))
                lrs.append(prev)
            out["learning_rates"] = np.asarray(lrs, np.float32)
        if (type(d).after_train_iteration
                is not LightGBMDelegate.after_train_iteration):
            out["iteration_hook"] = (
                lambda iters: d.after_train_iteration(batch_index, iters))
        return out

    def _batch_context(self, table: Table) -> dict:
        """Whole-dataset state every batch must share (e.g. the label
        mapping — a batch may not contain every class)."""
        return {}

    def _fit_single(self, table: Table, init_booster: Optional[Booster],
                    batch_index: int, ctx: dict, device: str):
        raise NotImplementedError

    def _fit(self, table: Table, device: str):
        nb = int(self.num_batches or 0)
        ctx = self._batch_context(table)
        if nb <= 1:
            return self._fit_single(table, None, 0, ctx, device)
        d = self.get("delegate")
        parts = table.random_split([1.0 / nb] * nb, seed=int(self.seed))
        model = None
        for bi, part in enumerate(parts):
            if part.num_rows == 0:
                continue  # tiny-table splits can leave an empty batch
            if d is not None:
                d.before_train_batch(bi, part, model)
            model = self._fit_single(
                part, model.booster if model is not None else None, bi, ctx,
                device)
            if d is not None:
                d.after_train_batch(bi, part, model)
        if model is None:
            raise ValueError("no non-empty training batch")
        return model


class LightGBMClassifier(_LightGBMEstimatorBase):
    """ref: lightgbm/.../LightGBMClassifier.scala:26-92."""

    objective = Param("binary|multiclass", default="binary")
    probability_col = Param("probability column", default="probability")
    raw_prediction_col = Param("raw margin column", default="rawPrediction")

    def _batch_context(self, table: Table) -> dict:
        # the class mapping must come from ALL batches' labels
        return {"classes": np.unique(
            np.asarray(table[self.label_col], np.float64))}

    def _fit_single(self, table: Table, init_booster, batch_index, ctx,
                    device) -> "LightGBMClassificationModel":
        train_t, valid_t = self._split_validation(table)
        x = self._features(train_t)
        y_raw = np.asarray(train_t[self.label_col], np.float64)
        # remap arbitrary class labels to dense 0..k-1; predictions map
        # back through label_values
        classes = ctx["classes"]
        y = np.searchsorted(classes, y_raw).astype(np.float64)
        num_class = len(classes)
        objective = self.objective
        if num_class > 2 and objective == "binary":
            objective = "multiclass"
        weight = (np.asarray(train_t[self.weight_col], np.float64)
                  if self.weight_col else None)
        valid = []
        if valid_t is not None and valid_t.num_rows:
            vy_raw = np.asarray(valid_t[self.label_col], np.float64)
            # rows whose label never appeared in training have no class
            # index; they are dropped from eval
            vpos = np.clip(np.searchsorted(classes, vy_raw), 0,
                           len(classes) - 1)
            known = classes[vpos] == vy_raw
            if not known.all():
                logging.getLogger("synapseml_tpu_torch").warning(
                    "dropping %d validation rows with labels unseen in "
                    "training", int((~known).sum()))
            if known.any():
                valid = [(self._features(valid_t)[known],
                          vpos[known].astype(np.float64))]
        booster = train(
            self._boost_params(objective,
                               num_class if objective != "binary" else 1),
            x, y, weight=weight, valid_sets=valid, init_model=init_booster,
            device=device, **self._delegate_train_kwargs(batch_index))
        model = self._make_model(LightGBMClassificationModel, booster)
        label_values = [float(c) for c in classes]
        while len(label_values) < 2:  # single-class fit still emits 2 prob cols
            label_values.append(label_values[-1] if label_values else 0.0)
        model.set(num_classes=max(num_class, 2), label_values=label_values)
        return model


class LightGBMRegressor(_LightGBMEstimatorBase):
    """ref: lightgbm/.../LightGBMRegressor.scala:38-154."""

    objective = Param(
        "regression|regression_l1|huber|fair|poisson|quantile|mape|tweedie",
        default="regression")
    alpha = Param("huber/quantile alpha", default=0.9)
    tweedie_variance_power = Param("tweedie power", default=1.5)

    def _fit_single(self, table: Table, init_booster, batch_index, ctx,
                    device) -> "LightGBMRegressionModel":
        train_t, valid_t = self._split_validation(table)
        x = self._features(train_t)
        y = np.asarray(train_t[self.label_col], np.float64)
        weight = (np.asarray(train_t[self.weight_col], np.float64)
                  if self.weight_col else None)
        valid = []
        if valid_t is not None and valid_t.num_rows:
            valid = [(self._features(valid_t),
                      np.asarray(valid_t[self.label_col], np.float64))]
        bp = dataclasses.replace(
            self._boost_params(self.objective),
            alpha=float(self.alpha),
            tweedie_variance_power=float(self.tweedie_variance_power))
        booster = train(bp, x, y, weight=weight, valid_sets=valid,
                        init_model=init_booster, device=device,
                        **self._delegate_train_kwargs(batch_index))
        return self._make_model(LightGBMRegressionModel, booster)


class LightGBMRanker(_LightGBMEstimatorBase):
    """ref: lightgbm/.../LightGBMRanker.scala:26-177."""

    objective = Param("lambdarank", default="lambdarank")
    group_col = Param("query/group id column", default="query")
    max_position = Param("NDCG truncation", default=30)
    evaluate_at = Param("eval positions", default=None)

    def _fit_single(self, table: Table, init_booster, batch_index, ctx,
                    device) -> "LightGBMRankerModel":
        # repartition-by-group analogue: a stable sort makes each query
        # contiguous (ref: repartitionByGroupingColumn, LightGBMBase.scala)
        table = table.sort(self.group_col)
        train_t, valid_t = self._split_validation(table)
        x = self._features(train_t)
        y = np.asarray(train_t[self.label_col], np.float64)
        _, group_ids = np.unique(np.asarray(train_t[self.group_col]),
                                 return_inverse=True)
        weight = (np.asarray(train_t[self.weight_col], np.float64)
                  if self.weight_col else None)
        valid = []
        if valid_t is not None and valid_t.num_rows:
            _, vgroup = np.unique(np.asarray(valid_t[self.group_col]),
                                  return_inverse=True)
            valid = [(self._features(valid_t),
                      np.asarray(valid_t[self.label_col], np.float64),
                      vgroup)]
        bp = dataclasses.replace(self._boost_params("lambdarank"),
                                 max_position=int(self.max_position))
        booster = train(bp, x, y, weight=weight, group=group_ids,
                        valid_sets=valid, init_model=init_booster,
                        device=device,
                        **self._delegate_train_kwargs(batch_index))
        return self._make_model(LightGBMRankerModel, booster)


class LightGBMClassificationModel(_LightGBMModelBase):
    probability_col = Param("probability column", default="probability")
    raw_prediction_col = Param("raw margin column", default="rawPrediction")
    num_classes = Param("number of classes", default=2)
    label_values = Param("original class labels in index order", default=None)

    def _transform(self, table: Table, device: str) -> Table:
        # the ensemble runs once: probabilities derive from the margins
        raw = self.booster.predict_raw(self._features(table), device=device)
        probs = objective_transform(self.booster.params, raw)
        if raw.ndim == 1:
            probs = np.column_stack([1 - probs, probs])
            raws = np.column_stack([-raw, raw])
        else:
            raws = raw
        pred_idx = probs.argmax(-1)
        if self.label_values is not None:
            pred = np.asarray(self.label_values, np.float64)[pred_idx]
        else:
            pred = pred_idx.astype(np.float64)
        return table.with_columns({
            self.raw_prediction_col: raws,
            self.probability_col: probs,
            self.prediction_col: pred,
        })


class LightGBMRegressionModel(_LightGBMModelBase):
    def _transform(self, table: Table, device: str) -> Table:
        pred = self.booster.predict(self._features(table), device=device)
        return table.with_column(self.prediction_col, pred.astype(np.float64))


class LightGBMRankerModel(_LightGBMModelBase):
    group_col = Param("query/group id column", default="query")

    def _transform(self, table: Table, device: str) -> Table:
        pred = self.booster.predict_raw(self._features(table), device=device)
        return table.with_column(self.prediction_col, pred.astype(np.float64))

"""Boosting loop and Booster model of the port's GBDT engine.

Counterpart of ``synapseml_tpu/gbdt/boosting.py``: ``BoostParams``, the
``Booster`` (a stack of flat tree arrays held on the host as numpy and
scored on a device) and ``train``, the single-device boosting loop for
``boosting_type="gbdt"``.

Scoring an ensemble is one launch of the forest-traversal kernel
(:func:`synapseml_tpu_torch.gbdt.kernels.forest_traverse`) with the tree
weights folded into the leaf values first. Models with categorical
splits (loaded native LightGBM models) and leaf-index predict run as
plain PyTorch ops on the same device; the reference has no kernel for
either.

Training keeps the binned rows, labels, scores and gradients on the
device it is given; each tree is grown by
:func:`synapseml_tpu_torch.gbdt.grower.build_tree` (kernel K1 per leaf)
and only its arrays come back to the host. The reference runs the loop
as ``lax.scan`` chunks on the TPU; here it is a plain Python loop over
iterations and classes, so early stopping and ``iteration_hook`` act
after every iteration.
"""
from __future__ import annotations

import dataclasses
import json
from functools import partial
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from synapseml_tpu_torch import device as device_policy
from synapseml_tpu_torch.gbdt import objectives as obj
from synapseml_tpu_torch.gbdt.binning import BinMapper
from synapseml_tpu_torch.gbdt.grower import (
    GrowerParams, Tree, build_tree, leaf_values, predict_tree)
from synapseml_tpu_torch.gbdt.kernels import forest_traverse


@dataclasses.dataclass(frozen=True)
class BoostParams:
    """Training parameters a Booster records (the reference's fields and
    defaults, so a model's ``parameters:`` section round-trips)."""
    objective: str = "binary"
    boosting_type: str = "gbdt"
    num_iterations: int = 100
    learning_rate: float = 0.1
    num_leaves: int = 31
    max_depth: int = 0
    lambda_l1: float = 0.0
    lambda_l2: float = 0.0
    min_data_in_leaf: int = 20
    min_sum_hessian_in_leaf: float = 1e-3
    min_gain_to_split: float = 0.0
    max_bin: int = 255
    bin_sample_count: int = 200_000
    feature_fraction: float = 1.0
    bagging_fraction: float = 1.0
    bagging_freq: int = 0
    pos_bagging_fraction: float = 1.0
    neg_bagging_fraction: float = 1.0
    top_rate: float = 0.2
    other_rate: float = 0.1
    drop_rate: float = 0.1
    max_drop: int = 50
    skip_drop: float = 0.5
    uniform_drop: bool = False
    xgboost_dart_mode: bool = False
    bagging_seed: Optional[int] = None
    improvement_tolerance: float = 0.0
    num_class: int = 1
    sigmoid: float = 1.0
    alpha: float = 0.9
    tweedie_variance_power: float = 1.5
    poisson_max_delta_step: float = 0.7
    boost_from_average: bool = True
    max_position: int = 30
    early_stopping_round: int = 0
    metric: Optional[str] = None
    seed: int = 0
    deterministic: bool = True
    categorical_features: Tuple[int, ...] = ()
    verbosity: int = -1
    hist_backend: str = "auto"
    tree_learner: str = "data_parallel"
    voting_top_k: int = 20

    def grower(self, device_bins: int) -> GrowerParams:
        """The grower's params, for ``device_bins`` histogram bins (the
        fitted BinMapper's ``total_bins``). ``hist_backend`` is carried,
        not read; voting (``voting_top_k``) is not ported, so it stays 0."""
        return GrowerParams(
            num_leaves=self.num_leaves,
            max_bin=device_bins,
            max_depth=self.max_depth,
            lambda_l1=self.lambda_l1,
            lambda_l2=self.lambda_l2,
            min_data_in_leaf=max(1, self.min_data_in_leaf),
            min_sum_hessian_in_leaf=self.min_sum_hessian_in_leaf,
            min_gain_to_split=self.min_gain_to_split,
            hist_backend=self.hist_backend,
        )


def _importances(b: "Booster", num_features: int):
    split = np.zeros(num_features, np.float64)
    gain = np.zeros(num_features, np.float64)
    internal = b.trees_feature >= 0
    np.add.at(split, b.trees_feature[internal], 1.0)
    np.add.at(gain, b.trees_feature[internal], b.trees_gain[internal])
    return split, gain


def objective_transform(p: BoostParams, raw: np.ndarray) -> np.ndarray:
    """Map raw margins to the objective's output scale (host numpy)."""
    o = p.objective
    if o in ("binary", "binary_logloss"):
        return 1.0 / (1.0 + np.exp(-p.sigmoid * raw))
    if o in ("multiclass", "softmax"):
        e = np.exp(raw - raw.max(axis=-1, keepdims=True))
        return e / e.sum(axis=-1, keepdims=True)
    if o == "multiclassova":
        s_ = 1.0 / (1.0 + np.exp(-p.sigmoid * raw))
        return s_ / s_.sum(axis=-1, keepdims=True)
    if o in ("poisson", "tweedie"):
        return np.exp(raw)
    return raw


def _on(a: np.ndarray, dtype: np.dtype, dev: torch.device) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a, dtype)).to(dev)


@dataclasses.dataclass
class Booster:
    """Trained model: stacked tree arrays + metadata, scored on a device."""
    trees_feature: np.ndarray    # [T, M]
    trees_threshold: np.ndarray  # [T, M]
    trees_left: np.ndarray       # [T, M]
    trees_right: np.ndarray      # [T, M]
    trees_value: np.ndarray      # [T, M] (already shrunk by learning rate)
    trees_cover: np.ndarray      # [T, M] training row count per node
    trees_gain: np.ndarray       # [T, M] split gain per internal node
    tree_weights: np.ndarray     # [T] (1.0 for gbdt; 1/T for rf; dart weights)
    params: BoostParams = dataclasses.field(default_factory=BoostParams)
    init_score: float = 0.0
    num_class: int = 1
    best_iteration: int = -1
    num_features: int = -1
    feature_names: Optional[List[str]] = None
    feature_importance_split: Optional[np.ndarray] = None
    feature_importance_gain: Optional[np.ndarray] = None
    eval_history: Dict[str, List[float]] = dataclasses.field(default_factory=dict)
    # categorical splits (native LightGBM interop): trees_cat[t, n] >= 0
    # marks node n of tree t as categorical, indexing into the global
    # bitset pool — int(x) in the set -> left child. None = all numeric.
    trees_cat: Optional[np.ndarray] = None       # [T, M] int32, -1 = numeric
    cat_bitsets: Optional[np.ndarray] = None     # [W] uint32 words
    cat_boundaries: Optional[np.ndarray] = None  # [S+1] int32 word offsets

    @property
    def num_trees(self) -> int:
        return self.trees_feature.shape[0]

    @property
    def num_iterations(self) -> int:
        """Boosting iterations = trees / classes (multiclass stacks K
        class trees per iteration)."""
        return self.num_trees // max(self.num_class, 1)

    def _raw_scores(self, x: np.ndarray, num_iteration: int = -1,
                    start_iteration: int = 0,
                    device: str = device_policy.DEFAULT_DEVICE) -> np.ndarray:
        """[N] or [N, K] raw margin scores, computed on ``device``.

        ``start_iteration``/``num_iteration`` select an iteration RANGE
        (lib_lightgbm's predict window) — the init score attaches only
        when the window starts at 0, matching LightGBM."""
        dev = device_policy.resolve(device)
        x = np.asarray(x, dtype=np.float32)
        if self.num_features > 0 and x.shape[1] != self.num_features:
            raise ValueError(
                f"feature width mismatch: model trained on "
                f"{self.num_features} features, got {x.shape[1]}")
        k = self.num_class
        if x.shape[0] == 0:
            out = np.zeros((0, k), np.float32)
            return out if k > 1 else out[:, 0]
        t = self.num_trees
        t0 = max(0, int(start_iteration)) * k
        if num_iteration and num_iteration > 0:
            t = min(t, t0 + num_iteration * k)
        elif self.best_iteration >= 0 and t0 == 0:
            # after early stopping, default to the best iteration — but
            # only for whole-model predicts: an explicit start window
            # with unset num_iteration means "all remaining trees"
            t = min(t, (self.best_iteration + 1) * k)
        t = max(t, t0)
        stack = (
            _on(self.trees_feature[t0:t], np.int32, dev),
            _on(self.trees_threshold[t0:t], np.float32, dev),
            _on(self.trees_left[t0:t], np.int32, dev),
            _on(self.trees_right[t0:t], np.int32, dev),
            _on(self.trees_value[t0:t], np.float32, dev),
        )
        weights = _on(self.tree_weights[t0:t], np.float32, dev)
        n_used = t - t0
        if self.params.boosting_type == "rf" and n_used > 0:
            # rf margins are averages over the trees actually used, so a
            # truncated predict (early stopping / num_iteration) must
            # renormalize from 1/T_total to 1/T_kept
            weights = torch.full((n_used,), 1.0 / max(n_used // k, 1),
                                 dtype=torch.float32, device=dev)
        xd = torch.from_numpy(x).to(dev)
        if self.trees_cat is not None:
            out = _predict_stack_cat(
                stack + (_on(self.trees_cat[t0:t], np.int64, dev),),
                weights, xd, _on(self.cat_bitsets, np.int64, dev),
                _on(self.cat_boundaries, np.int64, dev), k)
        else:
            out = _predict_stack(stack, weights, xd, k)
        out = out.cpu().numpy()
        if t0 == 0:
            out = out + self.init_score
        return out if k > 1 else out[:, 0]

    def predict_raw(self, x, num_iteration: int = -1,
                    start_iteration: int = 0,
                    device: str = device_policy.DEFAULT_DEVICE):
        return self._raw_scores(x, num_iteration, start_iteration, device)

    def predict(self, x, num_iteration: int = -1, start_iteration: int = 0,
                device: str = device_policy.DEFAULT_DEVICE):
        raw = self._raw_scores(x, num_iteration, start_iteration, device)
        return objective_transform(self.params, raw)

    def predict_leaf(self, x,
                     device: str = device_policy.DEFAULT_DEVICE) -> np.ndarray:
        """[N, T] leaf index per tree (parity with predictLeaf,
        ref: lightgbm/.../LightGBMModelMethods.scala)."""
        dev = device_policy.resolve(device)
        if self.trees_cat is not None:
            raise NotImplementedError(
                "predict_leaf is not implemented for models with "
                "categorical splits (loaded native LightGBM model)")
        x = np.asarray(x, dtype=np.float32)
        stack = (
            _on(self.trees_feature, np.int64, dev),
            _on(self.trees_threshold, np.float32, dev),
            _on(self.trees_left, np.int64, dev),
            _on(self.trees_right, np.int64, dev),
        )
        return _leaf_index_stack(stack, torch.from_numpy(x).to(dev)).cpu().numpy()

    # -- persistence ---------------------------------------------------
    def to_dict(self) -> Dict[str, Any]:
        return {
            "params": dataclasses.asdict(self.params),
            "init_score": self.init_score,
            "num_class": self.num_class,
            "best_iteration": self.best_iteration,
            "num_features": self.num_features,
            "feature_names": self.feature_names,
            "trees": {
                "feature": self.trees_feature.tolist(),
                "threshold": self.trees_threshold.tolist(),
                "left": self.trees_left.tolist(),
                "right": self.trees_right.tolist(),
                "value": self.trees_value.tolist(),
                "cover": self.trees_cover.tolist(),
                "gain": self.trees_gain.tolist(),
                "weights": self.tree_weights.tolist(),
            },
            **({"categorical": {
                "trees_cat": self.trees_cat.tolist(),
                "bitsets": self.cat_bitsets.tolist(),
                "boundaries": self.cat_boundaries.tolist(),
            }} if self.trees_cat is not None else {}),
        }

    @staticmethod
    def from_dict(d: Dict[str, Any]) -> "Booster":
        t = d["trees"]
        params = dict(d.get("params", {}))
        params["categorical_features"] = tuple(params.get("categorical_features", ()))
        return Booster(
            trees_feature=np.asarray(t["feature"], np.int32),
            trees_threshold=np.asarray(t["threshold"], np.float32),
            trees_left=np.asarray(t["left"], np.int32),
            trees_right=np.asarray(t["right"], np.int32),
            trees_value=np.asarray(t["value"], np.float32),
            trees_cover=np.asarray(t.get("cover", np.zeros_like(t["value"])), np.float32),
            trees_gain=np.asarray(t.get("gain", np.zeros_like(t["value"])), np.float32),
            tree_weights=np.asarray(t["weights"], np.float32),
            params=BoostParams(**params),
            init_score=d.get("init_score", 0.0),
            num_class=d.get("num_class", 1),
            best_iteration=d.get("best_iteration", -1),
            num_features=d.get("num_features", -1),
            feature_names=d.get("feature_names"),
            **({} if "categorical" not in d else {
                "trees_cat": np.asarray(
                    d["categorical"]["trees_cat"], np.int32),
                "cat_bitsets": np.asarray(
                    d["categorical"]["bitsets"], np.uint32),
                "cat_boundaries": np.asarray(
                    d["categorical"]["boundaries"], np.int32),
            }),
        )

    def save_string(self) -> str:
        """Serialize in LightGBM's native text model format (interoperable
        with lightgbm-python / SHAP tooling; ref LightGBMBooster.scala:454)."""
        from synapseml_tpu_torch.gbdt.lgbm_format import booster_to_native_string
        return booster_to_native_string(self)

    @staticmethod
    def load_string(s: str) -> "Booster":
        """Parse either the native LightGBM text format or the legacy
        JSON format, auto-detected."""
        if s.lstrip().startswith("{"):
            return Booster.from_dict(json.loads(s))
        from synapseml_tpu_torch.gbdt.lgbm_format import booster_from_native_string
        return booster_from_native_string(s)


def _predict_stack(stack, weights: torch.Tensor, x: torch.Tensor,
                   k: int) -> torch.Tensor:
    """[N, k] ensemble sum: one forest traversal with the tree weights
    folded into the leaf values first, so the traversal only adds."""
    feat, thr, left, right, value = stack
    return forest_traverse(x, feat, thr, left, right,
                           (value * weights[:, None]).contiguous(), k=k)


def _walk(x: torch.Tensor, rows: torch.Tensor, feat, thr, left, right,
          cat_left=None) -> torch.Tensor:
    """Final node per row of one tree ([M] planes), ``M // 2 + 1`` steps;
    ``cat_left(node, xv)`` overrides the numeric ``x <= thr`` decision."""
    n, f = x.shape
    m = feat.shape[0]
    node = torch.zeros(n, dtype=torch.long, device=x.device)
    for _ in range(m // 2 + 1):
        fi = feat[node]
        xv = x[rows, fi.clamp(0, f - 1)]
        go_left = xv <= thr[node]
        if cat_left is not None:
            go_left = cat_left(node, xv, go_left)
        nxt = torch.where(go_left, left[node], right[node])
        node = torch.where(fi < 0, node, nxt.clamp(0, m - 1))
    return node


def _predict_stack_cat(stack, weights: torch.Tensor, x: torch.Tensor,
                       bitsets: torch.Tensor, bounds: torch.Tensor,
                       k: int) -> torch.Tensor:
    """Ensemble sum for models with categorical splits: a cat node routes
    LEFT iff int(x) is in its bitset (LightGBM FindInBitset semantics);
    NaN, negative, and out-of-range categories go right. Bit operations
    are done in int64 (the uint32 words widened)."""
    feat, thr, left, right, value, cat = stack
    n = x.shape[0]
    n_words = bitsets.shape[0]
    rows = torch.arange(n, device=x.device)
    out = torch.zeros((n, k), dtype=torch.float32, device=x.device)
    for ti in range(feat.shape[0]):
        cat_t = cat[ti]

        def cat_left(node, xv, num_left):
            ci = cat_t[node]                      # [n] cat-set id or -1
            # int(x) truncating toward zero; NaN -> -1; huge magnitudes
            # clamp to values that route right just as the reference's
            # saturating cast does
            v = torch.nan_to_num(xv, nan=-1.0).clamp(-1.0, 2.0 ** 30).long()
            vc = v.clamp(min=0)
            cic = ci.clamp(min=0)
            start = bounds[cic]
            width = (bounds[cic + 1] - start) * 32
            word = bitsets[(start + vc // 32).clamp(0, n_words - 1)]
            in_set = ((word >> (vc % 32)) & 1).bool()
            in_range = in_set & (v >= 0) & (v < width)
            return torch.where(ci >= 0, in_range, num_left)

        node = _walk(x, rows, feat[ti].long(), thr[ti], left[ti].long(),
                     right[ti].long(), cat_left)
        out[:, ti % k] += value[ti][node] * weights[ti]
    return out


def _leaf_index_stack(stack, x: torch.Tensor) -> torch.Tensor:
    """[N, T] int32 final node of every row in every tree."""
    feat, thr, left, right = stack
    n = x.shape[0]
    rows = torch.arange(n, device=x.device)
    leaves = [_walk(x, rows, feat[ti], thr[ti], left[ti], right[ti])
              for ti in range(feat.shape[0])]
    if not leaves:
        return torch.zeros((n, 0), dtype=torch.int32, device=x.device)
    return torch.stack(leaves, dim=1).to(torch.int32)


# -- training ----------------------------------------------------------------

_MULTICLASS = ("multiclass", "softmax", "multiclassova")
_RANKING = ("lambdarank", "rank_xendcg")


def _not_ported(what: str, item: str = "1, GBDT training: what is left"
                ) -> NotImplementedError:
    return NotImplementedError(
        f"{what} is not ported to synapseml_tpu_torch yet (ROADMAP.md, "
        f"Queue 1 item {item})")


def _check_ported(p: BoostParams, mesh, checkpoint_dir) -> None:
    """Raise for every training option this port does not have yet;
    none is ignored silently."""
    if p.tree_learner not in ("data_parallel", "voting_parallel"):
        raise ValueError(
            f"tree_learner {p.tree_learner!r}: the reference's "
            "parallelism param offers data_parallel or "
            "voting_parallel (LightGBMParams.scala:16-18)")
    if p.boosting_type in ("goss", "rf", "dart"):
        raise _not_ported(f"boosting_type={p.boosting_type!r}")
    strat = p.pos_bagging_fraction < 1.0 or p.neg_bagging_fraction < 1.0
    if strat and p.objective not in ("binary", "binary_logloss"):
        # stratified bagging splits rows by label sign — only meaningful
        # (and only defined by LightGBM) for binary objectives
        raise ValueError(
            "pos_bagging_fraction/neg_bagging_fraction require a binary "
            f"objective, got {p.objective!r}")
    if p.bagging_freq > 0 and (p.bagging_fraction < 1.0 or strat):
        raise _not_ported("bagging (bagging_freq > 0 with a fraction < 1)")
    if p.feature_fraction < 1.0:
        raise _not_ported("feature_fraction < 1")
    if p.objective in _RANKING:
        raise _not_ported(f"the {p.objective} objective (LightGBMRanker)")
    if p.categorical_features:
        raise _not_ported("training with categorical features")
    if mesh is not None or p.tree_learner == "voting_parallel":
        raise _not_ported("mesh / voting_parallel training",
                          "2, GBDT multi-GPU")
    if checkpoint_dir is not None:
        raise _not_ported("step checkpointing (checkpoint_dir)")


def _objective_fn(p: BoostParams) -> Callable:
    o = p.objective
    if o in ("binary", "binary_logloss"):
        return partial(obj.binary_logloss_obj, sigmoid=p.sigmoid)
    if o in _MULTICLASS:
        return obj.softmax_obj
    if o == "huber":
        return partial(obj.huber_obj, alpha=p.alpha)
    if o == "quantile":
        return partial(obj.quantile_obj, alpha=p.alpha)
    if o == "tweedie":
        return partial(obj.tweedie_obj, rho=p.tweedie_variance_power)
    if o == "poisson":
        return partial(obj.poisson_obj, max_delta_step=p.poisson_max_delta_step)
    fn = obj.REGRESSION_OBJECTIVES.get(o)
    if fn is None:
        raise ValueError(f"unknown objective {o!r}")
    return fn


def _default_metric(p: BoostParams) -> str:
    if p.metric:
        return p.metric
    if p.objective in ("binary", "binary_logloss"):
        return "binary_logloss"
    if p.objective in _MULTICLASS:
        return "multi_logloss"
    if p.objective in _RANKING:
        return "ndcg"
    if p.objective in ("regression_l1", "l1", "mae"):
        return "mae"
    return "rmse"


class _ValidTracker:
    """Validation scoring and early stopping.

    The first validation set is scored, as in the reference. Each new tree
    scores its rows on the device (K2 with one tree) into a running margin
    sum; after every iteration the metric of ``init + sum`` is recorded.
    ``best_iteration`` is only exported when early stopping is on
    (LightGBM semantics: merely supplying eval data must not truncate
    predictions).
    """

    def __init__(self, p: BoostParams, k: int, init: float, valid_sets,
                 dev: torch.device):
        self.p, self.k, self.init, self.dev = p, k, init, dev
        self.metric_name = _default_metric(p)
        self.metric_fn, self.larger_better = obj.METRICS.get(
            self.metric_name, (None, False))
        self.enabled = bool(valid_sets) and self.metric_fn is not None
        if self.enabled:
            vx, vy = valid_sets[0]
            self.vx = torch.from_numpy(np.asarray(vx, np.float32)).to(dev)
            self.vy = torch.from_numpy(np.asarray(vy, np.float32)).to(dev)
            self.vsum = torch.zeros((len(vy), k), dtype=torch.float32,
                                    device=dev)
        self.best_score = -np.inf if self.larger_better else np.inf
        self.best_iter = -1
        self.history: Dict[str, List[float]] = {self.metric_name: []}

    def add_tree(self, tree: Tree, class_idx: int):
        """Add one tree's leaf values to the validation margins."""
        if self.enabled:
            arrays = tuple(torch.from_numpy(a).to(self.dev) for a in (
                tree.split_feature, tree.threshold, tree.left_child,
                tree.right_child, tree.leaf_value))
            self.vsum[:, class_idx] += predict_tree(arrays, self.vx)

    def step(self, it: int) -> bool:
        """Record the metric after iteration ``it``; True = stop early."""
        if not self.enabled:
            return False
        # the metric in float64, so the card and the CPU stop alike
        vscore = (self.vsum + self.init).to(torch.float64)
        if self.k > 1:
            m = self.metric_fn(vscore, self.vy.to(torch.int32))
        else:
            m = self.metric_fn(vscore[:, 0], self.vy.to(torch.float64))
        m = float(m)
        self.history[self.metric_name].append(m)
        tol = self.p.improvement_tolerance
        improved = (m - self.best_score > tol if self.larger_better
                    else m - self.best_score < tol)
        if improved:
            self.best_score, self.best_iter = m, it
            return False
        return (self.p.early_stopping_round > 0
                and it - self.best_iter >= self.p.early_stopping_round)

    def final_best_iter(self) -> int:
        return self.best_iter if self.p.early_stopping_round > 0 else -1


def _init_score(p: BoostParams, y: np.ndarray, weight: Optional[np.ndarray]):
    """boost_from_average analogue of LightGBM's ObtainAutomaticInitialScore."""
    if not p.boost_from_average:
        return 0.0
    w = weight if weight is not None else np.ones_like(y, dtype=np.float64)
    if p.objective in ("binary", "binary_logloss"):
        pbar = float(np.clip(np.average(y, weights=w), 1e-12, 1 - 1e-12))
        return float(np.log(pbar / (1 - pbar)) / p.sigmoid)
    if p.objective in ("poisson", "tweedie"):
        mean = max(float(np.average(y, weights=w)), 1e-12)
        return float(np.log(mean))
    if p.objective == "quantile":
        return float(np.quantile(y, p.alpha))
    if p.objective in ("regression_l1", "l1", "mae", "huber", "mape"):
        return float(np.median(y))
    if p.objective in _MULTICLASS + _RANKING:
        return 0.0
    return float(np.average(y, weights=w))


def _prepend_init_trees(init_model: Optional[Booster], stacked: Tree) -> Tree:
    """Prepend init_model's trees so the result is one whole booster
    (the batch-model threading / resume half)."""
    if init_model is None:
        return stacked
    m = max(stacked.split_feature.shape[1], init_model.trees_feature.shape[1])

    def cat(old, new, fill):
        return np.concatenate([
            np.pad(a, ((0, 0), (0, m - a.shape[1])), constant_values=fill)
            for a in (old, new)])

    return Tree(
        split_feature=cat(init_model.trees_feature, stacked.split_feature, -1),
        threshold=cat(init_model.trees_threshold, stacked.threshold, 0),
        threshold_bin=cat(np.zeros_like(init_model.trees_feature),
                          stacked.threshold_bin, 0),
        left_child=cat(init_model.trees_left, stacked.left_child, 0),
        right_child=cat(init_model.trees_right, stacked.right_child, 0),
        leaf_value=cat(init_model.trees_value
                       * init_model.tree_weights[:, None],
                       stacked.leaf_value, 0),
        cover=cat(init_model.trees_cover, stacked.cover, 0),
        gain=cat(init_model.trees_gain, stacked.gain, 0),
    )


def _attach_init_categoricals(booster: Booster,
                              init_model: Optional[Booster]) -> Booster:
    """Carry a categorical init_model's split sets into the combined
    booster: old nodes keep their set indices, new trees are numeric."""
    if init_model is None or init_model.trees_cat is None:
        return booster
    t_old, m_old = init_model.trees_cat.shape
    cat = np.full(booster.trees_feature.shape, -1, np.int32)
    cat[:t_old, :m_old] = init_model.trees_cat
    booster.trees_cat = cat
    booster.cat_bitsets = np.array(init_model.cat_bitsets, np.uint32)
    booster.cat_boundaries = np.array(init_model.cat_boundaries, np.int32)
    return booster


def _assemble_booster(stacked: Tree, p: BoostParams, k: int, init: float,
                      f: int, feature_names, tracker: _ValidTracker,
                      init_model: Optional[Booster] = None) -> Booster:
    booster = Booster(
        trees_feature=stacked.split_feature,
        trees_threshold=stacked.threshold,
        trees_left=stacked.left_child,
        trees_right=stacked.right_child,
        trees_value=stacked.leaf_value,
        trees_cover=stacked.cover,
        trees_gain=stacked.gain,
        tree_weights=np.ones(stacked.split_feature.shape[0], np.float32),
        params=p,
        init_score=init,
        num_class=k,
        best_iteration=tracker.final_best_iter(),
        num_features=f,
        feature_names=feature_names,
        eval_history=tracker.history,
    )
    booster.feature_importance_split, booster.feature_importance_gain = (
        _importances(booster, f))
    return _attach_init_categoricals(booster, init_model)


def _resume_state(p: BoostParams, init_model: Optional[Booster], k: int,
                  x: np.ndarray, default_init: float, device):
    """Validate ``init_model`` and return (init score, margins over x's
    rows). All of init_model's iterations are used, because
    _prepend_init_trees prepends all its trees."""
    if init_model is None:
        return default_init, None
    if init_model.num_class != k:
        raise ValueError("init_model num_class mismatch")
    margins = init_model.predict_raw(
        x, num_iteration=init_model.num_iterations,
        device=device).reshape(x.shape[0], k)
    return float(init_model.init_score), margins


def _validate_lr_schedule(p: BoostParams, learning_rates):
    if learning_rates is None:
        return None
    learning_rates = np.asarray(learning_rates, np.float32)
    if learning_rates.shape != (p.num_iterations,):
        raise ValueError(
            f"learning_rates must have shape ({p.num_iterations},), "
            f"got {learning_rates.shape}")
    return learning_rates


def _renew_leaves(tree: Tree, residual: torch.Tensor, row_slot, slot_value,
                  slot_node: np.ndarray, alpha: float):
    """L1-family leaf renewal (LightGBM RenewTreeOutput): a leaf's output
    becomes the alpha-quantile of the residuals of its rows."""
    nan = torch.full_like(residual, torch.nan)
    renewed = torch.stack([
        torch.nanquantile(torch.where(row_slot == s, residual, nan), alpha)
        for s in range(slot_value.shape[0])])
    slot_value = torch.where(torch.isnan(renewed), slot_value, renewed)
    tree = dataclasses.replace(tree, leaf_value=leaf_values(
        slot_node, slot_value.cpu().numpy(), tree.leaf_value.shape[0]))
    return tree, slot_value


def train(
    p: BoostParams,
    x: np.ndarray,
    y: np.ndarray,
    weight: Optional[np.ndarray] = None,
    valid_sets: Sequence[Tuple[np.ndarray, np.ndarray]] = (),
    feature_names: Optional[List[str]] = None,
    mesh=None,
    init_model: Optional[Booster] = None,
    checkpoint_dir: Optional[str] = None,
    learning_rates: Optional[np.ndarray] = None,
    iteration_hook: Optional[Callable[[int], None]] = None,
    device: str = device_policy.DEFAULT_DEVICE,
) -> Booster:
    """Train a Booster on ``device`` (the card unless the caller asks for
    the CPU).

    ``init_model`` continues boosting from an existing booster's margins
    (the reference's batch-model threading, LightGBMBase.scala:49-61).
    ``learning_rates`` is an optional per-iteration shrinkage schedule
    (the delegate's dynamic-LR hook, LightGBMDelegate.scala:57-61).
    ``iteration_hook(iters_done)`` fires after every iteration.
    ``mesh`` and ``checkpoint_dir`` are not ported and raise.
    """
    dev = device_policy.resolve(device)
    _check_ported(p, mesh, checkpoint_dir)
    if p.num_iterations < 1:
        raise ValueError(f"num_iterations must be >= 1, got {p.num_iterations}")
    x = np.asarray(x, dtype=np.float64)
    y = np.asarray(y, dtype=np.float32)
    n, f = x.shape
    k = p.num_class if p.objective in _MULTICLASS else 1

    mapper = BinMapper(max_bin=p.max_bin, subsample=p.bin_sample_count,
                       seed=p.seed).fit(x)
    binned = torch.from_numpy(mapper.transform(x)).to(dev)
    gp = p.grower(mapper.total_bins)
    thresholds = mapper.threshold_values().astype(np.float32)
    obj_fn = _objective_fn(p)
    init, init_margins = _resume_state(p, init_model, k, x,
                                       _init_score(p, y, weight), dev)
    learning_rates = _validate_lr_schedule(p, learning_rates)

    yd = torch.from_numpy(y).to(dev)
    wd = (torch.from_numpy(np.asarray(weight, np.float32)).to(dev)
          if weight is not None else None)
    if init_margins is not None:
        scores = torch.from_numpy(np.ascontiguousarray(
            init_margins if k > 1 else init_margins[:, 0], np.float32)).to(dev)
    else:
        scores = torch.full((n, k) if k > 1 else (n,), init,
                            dtype=torch.float32, device=dev)
    y_onehot = (torch.nn.functional.one_hot(yd.long(), k).to(torch.float32)
                if k > 1 else None)
    renew_alpha = None
    if k == 1 and p.objective in ("regression_l1", "l1", "mae"):
        renew_alpha = 0.5
    elif k == 1 and p.objective == "quantile":
        renew_alpha = p.alpha

    tracker = _ValidTracker(p, k, init, valid_sets, dev)
    if tracker.enabled and init_model is not None:
        # valid margins include the resumed model's whole stack
        vraw = init_model.predict_raw(
            tracker.vx.cpu().numpy(),
            num_iteration=init_model.num_iterations, device=dev)
        tracker.vsum = torch.from_numpy(np.ascontiguousarray(
            vraw.reshape(-1, k) - init, np.float32)).to(dev)

    row_mask = torch.ones(n, dtype=torch.bool, device=dev)
    trees: List[Tree] = []
    for it in range(p.num_iterations):
        lr = (learning_rates[it] if learning_rates is not None
              else p.learning_rate)
        for c in range(k):
            if k > 1:
                g, h = obj_fn(scores, y_onehot, wd)
                g, h = g[:, c].contiguous(), h[:, c].contiguous()
            else:
                g, h = obj_fn(scores, yd, wd)
            tree, row_slot, slot_value, slot_node = build_tree(
                binned, g, h, row_mask, thresholds, gp)
            if renew_alpha is not None:
                tree, slot_value = _renew_leaves(
                    tree, yd - scores, row_slot, slot_value, slot_node,
                    renew_alpha)
            delta = slot_value[row_slot.long()] * float(lr)
            if k > 1:
                scores[:, c] += delta
            else:
                scores = scores + delta
            tree = dataclasses.replace(
                tree, leaf_value=tree.leaf_value * np.float32(lr))
            trees.append(tree)
            tracker.add_tree(tree, c)
        stop = tracker.step(it)
        if iteration_hook is not None:
            iteration_hook(it + 1)
        if stop:
            break

    stacked = Tree(**{fld.name: np.stack([getattr(t, fld.name)
                                          for t in trees])
                      for fld in dataclasses.fields(Tree)})
    booster = _assemble_booster(
        _prepend_init_trees(init_model, stacked), p, k, init, f,
        feature_names, tracker, init_model=init_model)
    if init_model is not None and booster.best_iteration >= 0:
        # best_iteration indexes the combined tree stack
        booster.best_iteration += init_model.num_iterations
    return booster

"""Boosting loop and Booster model of the port's GBDT engine.

Counterpart of ``synapseml_tpu/gbdt/boosting.py``: ``BoostParams``, the
``Booster`` (a stack of flat tree arrays held on the host as numpy and
scored on a device), ``train``, the single-device boosting loop for every
``boosting_type`` (gbdt, goss, rf, dart) and objective (the ranking ones
over a query ``group``, with the NDCG validation metric), step
checkpoints (``save_checkpoint``/``load_checkpoint``), and data-parallel
training over a ``torch.distributed`` process group: ``train(...,
mesh=group)``, where every rank passes the same rows and grows on its
block of them, and ``train_row_sharded``, where each rank passes only its
own rows (both through ``_train_distributed``). Categorical features are
binned by category id and split like numeric ones, as in the reference.

Scoring an ensemble is one launch of the forest-traversal kernel
(:func:`synapseml_tpu_torch.gbdt.kernels.forest_traverse`) with the tree
weights folded into the leaf values first. Models with categorical
splits (loaded native LightGBM models) and leaf-index predict run as
plain PyTorch ops on the same device; the reference has no kernel for
either.

Training keeps the binned rows, labels, scores and gradients on the
device it is given; each tree is grown by
:func:`synapseml_tpu_torch.gbdt.grower.build_tree` (kernel K1 per leaf,
on the one :func:`~synapseml_tpu_torch.gbdt.kernels.bin_index` built per
fit, or under ``feature_fraction`` on the iteration's
:func:`~synapseml_tpu_torch.gbdt.kernels.mask_features` of it) and only
its arrays come back to the host. Bagging, GOSS and ``feature_fraction``
draw their masks on the rows' device from the reference's own key stream
(:mod:`synapseml_tpu_torch.gbdt.prng`, threefry bit for bit), so they
sample the same rows and features. The reference runs the loop as
``lax.scan`` chunks on the TPU; here it is a plain Python loop over
iterations and classes, so early stopping and ``iteration_hook`` act after
every iteration; checkpoints are written where the reference's chunks end.
"""
from __future__ import annotations

import dataclasses
import json
import os
import tempfile
from functools import partial
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from synapseml_tpu_torch import device as device_policy
from synapseml_tpu_torch.gbdt import kernels, objectives as obj, prng
from synapseml_tpu_torch.gbdt.binning import BinMapper
from synapseml_tpu_torch.gbdt.grower import (
    GrowerParams, Tree, build_tree, leaf_values, predict_tree)
from synapseml_tpu_torch.gbdt.kernels import forest_traverse
from synapseml_tpu_torch.parallel import collectives


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
        not read; ``voting_top_k`` is set for voting_parallel only."""
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
            voting_top_k=(max(1, int(self.voting_top_k))
                          if self.tree_learner == "voting_parallel" else 0),
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


def _check_params(p: BoostParams) -> None:
    """Raise for the parameter combinations the reference refuses."""
    if p.tree_learner not in ("data_parallel", "voting_parallel"):
        raise ValueError(
            f"tree_learner {p.tree_learner!r}: the reference's "
            "parallelism param offers data_parallel or "
            "voting_parallel (LightGBMParams.scala:16-18)")
    if _stratified(p) and p.objective not in ("binary", "binary_logloss"):
        # stratified bagging splits rows by label sign — only meaningful
        # (and only defined by LightGBM) for binary objectives
        raise ValueError(
            "pos_bagging_fraction/neg_bagging_fraction require a binary "
            f"objective, got {p.objective!r}")


def _stratified(p: BoostParams) -> bool:
    return p.pos_bagging_fraction < 1.0 or p.neg_bagging_fraction < 1.0


def _f32(v: float) -> float:
    """``v`` rounded to float32, as the reference's weakly typed Python
    scalars are against float32 arrays."""
    return float(np.float32(v))


def _sample_rows(p: BoostParams, grad: torch.Tensor, hess: torch.Tensor,
                 y: torch.Tensor, key: torch.Tensor):
    """Bagging or GOSS row selection from ``key`` (the reference's
    ``sample_mask_and_weights``): (mask, grad, hess)."""
    n = grad.shape[0]
    if p.boosting_type == "goss":
        a, b = p.top_rate, p.other_rate
        n_top = max(1, int(a * n))
        absg = grad.abs()
        thresh = torch.sort(absg, descending=True).values[n_top - 1]
        top = absg >= thresh
        small = ~top & (prng.uniform(key, n) < _f32(b))
        amp = _f32((1.0 - a) / max(b, 1e-12))
        return (top | small, torch.where(small, grad * amp, grad),
                torch.where(small, hess * amp, hess))
    is_rf = p.boosting_type == "rf"
    bkey = key if p.bagging_seed is None else prng.fold_in(key,
                                                           p.bagging_seed)
    u = prng.uniform(bkey, n)
    if _stratified(p) and not is_rf:
        # per-class subsampling (LightGBM pos/neg bagging: binary labels,
        # no gradient amplification)
        return (torch.where(y > 0, u < _f32(p.pos_bagging_fraction),
                            u < _f32(p.neg_bagging_fraction)), grad, hess)
    frac = (0.632 if is_rf and p.bagging_fraction >= 1.0
            else p.bagging_fraction)
    return u < _f32(frac), grad, hess


def _feature_keep(p: BoostParams, f: int, key: torch.Tensor) -> torch.Tensor:
    """[F] bool: the ``round(feature_fraction * F)`` features (at least
    one) this tree may split on (the reference's ``feature_mask``)."""
    keep = max(1, int(round(p.feature_fraction * f)))
    mask = torch.zeros(f, dtype=torch.bool, device=key.device)
    mask[prng.permutation(key, f)[:keep]] = True
    return mask


def _rank_objective(p: BoostParams, group: np.ndarray, n: int,
                    dev: torch.device) -> Callable:
    """LambdaRank's ``(preds, labels, weight) -> (grad, hess)`` over the
    queries of ``group``: the block-diagonal form where its ``[Q, G, G]``
    pair terms are no more than the dense ``[N, N]`` ones and the padded
    ``[Q, G]`` layout at most 8 N (the reference's rule), else the dense
    form. The weight multiplies after the hessian's clamp, as there."""
    qidx, qmask, qinv = obj.build_query_blocks(group)
    q, gmax = qidx.shape
    if q * gmax * gmax <= n * n and q * gmax <= 8 * n:
        grad_fn = partial(
            obj.lambdarank_grad_blocked,
            row_index=torch.from_numpy(qidx).to(dev),
            pad_mask=torch.from_numpy(qmask).to(dev),
            inv=torch.from_numpy(qinv).to(dev), max_dcg_pos=p.max_position)
    else:
        grad_fn = partial(
            obj.lambdarank_grad,
            group_ids=torch.from_numpy(np.asarray(group, np.int64)).to(dev),
            max_dcg_pos=p.max_position)

    def rank_obj(preds, labels, weight=None):
        return obj._weighted(*grad_fn(preds, labels), weight)
    return rank_obj


def _objective_fn(p: BoostParams, group: Optional[np.ndarray] = None,
                  dev: Optional[torch.device] = None) -> Callable:
    o = p.objective
    if o in _RANKING:
        if group is None:
            raise ValueError("ranking objectives need a group array")
        return _rank_objective(p, group, len(group), dev)
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


def _ndcg_score(scores: np.ndarray, labels: np.ndarray, group_ids: np.ndarray,
                at: int, blocks=None) -> float:
    """Mean NDCG@at over query groups — vectorized over [Q, Gmax] query
    blocks (this runs once per boosting iteration in the rank eval path;
    the per-query python loop dominated eval at large Q). Pass ``blocks``
    (from :func:`objectives.build_query_blocks`) to reuse the layout
    across iterations — the group array never changes during a fit."""
    scores = np.asarray(scores)
    labels = np.asarray(labels)
    if len(scores) == 0:
        return 0.0
    if blocks is None:
        blocks = obj.build_query_blocks(np.asarray(group_ids))
    row_index, pad_mask, _ = blocks
    if row_index.size > 8 * len(scores):
        # heavy group-size skew: dense [Q, Gmax] blocks would dwarf the
        # data — per-group loop is cheaper
        return _ndcg_score_loop(scores, labels, np.asarray(group_ids), at)
    s = np.where(pad_mask, scores[row_index], -np.inf)
    rel = np.where(pad_mask, labels[row_index], 0.0)
    gmax = s.shape[1]
    cols = min(at, gmax)
    # pads sort last (score -inf, gain 0): identical to per-group slicing
    order = np.argsort(-s, axis=1, kind="stable")[:, :cols]
    gains = np.take_along_axis(2.0 ** rel - 1.0, order, axis=1)
    disc = 1.0 / np.log2(np.arange(2, cols + 2))
    dcg = (gains * disc).sum(axis=1)
    ideal = -np.sort(-(2.0 ** rel - 1.0), axis=1)[:, :cols]
    idcg = (ideal * disc).sum(axis=1)
    valid = idcg > 0
    if not valid.any():
        return 0.0
    return float((dcg[valid] / idcg[valid]).mean())


def _ndcg_score_loop(scores, labels, group_ids, at: int) -> float:
    """Per-group fallback for pathologically skewed group sizes."""
    total, count = 0.0, 0
    for g in np.unique(group_ids):
        sel = group_ids == g
        rel = labels[sel]
        if len(rel) == 0:
            continue
        order = np.argsort(-scores[sel], kind="stable")[:at]
        discounts = 1.0 / np.log2(np.arange(2, len(order) + 2))
        dcg = float(np.sum((2.0 ** rel[order] - 1.0) * discounts))
        ideal = np.sort(rel)[::-1][:at]
        idcg = float(np.sum((2.0 ** ideal - 1.0)
                            / np.log2(np.arange(2, len(ideal) + 2))))
        if idcg > 0:
            total += dcg / idcg
            count += 1
    return total / max(count, 1)


class _ValidTracker:
    """Validation scoring and early stopping.

    Validation sets are ``(x, y)`` pairs or ``(x, y, group)`` triples; the
    first set is scored, as in the reference. Each new tree scores its
    rows on the device (K2 with one tree) into a running margin sum; after
    every iteration the metric of ``init + sum`` is recorded. The ``ndcg``
    metric (a ranker's default) needs the first set's group and reads the
    margin sum itself, as the reference's does, on the host.
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
        self.is_rank_metric = self.metric_name == "ndcg"
        if self.is_rank_metric:
            self.larger_better = True
        self.vg = None
        if valid_sets:
            vs = valid_sets[0]
            vx, vy = vs[0], vs[1]
            if len(vs) > 2 and vs[2] is not None:
                self.vg = np.asarray(vs[2])
        self.enabled = bool(valid_sets) and (
            self.metric_fn is not None
            or (self.is_rank_metric and self.vg is not None))
        if self.enabled:
            self.vy_host = np.asarray(vy, np.float32)
            self.vx = torch.from_numpy(np.asarray(vx, np.float32)).to(dev)
            self.vy = torch.from_numpy(self.vy_host).to(dev)
            self.vsum = torch.zeros((len(vy), k), dtype=torch.float32,
                                    device=dev)
        # the rank metric's query layout, built once, where the padded
        # layout is not much larger than the set (else _ndcg_score loops
        # over the groups)
        self.ndcg_blocks = None
        if self.enabled and self.is_rank_metric:
            _, counts = np.unique(self.vg, return_counts=True)
            if len(counts) * counts.max() <= 8 * len(self.vg):
                self.ndcg_blocks = obj.build_query_blocks(self.vg)
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
        vsum = self.vsum
        if self.is_rank_metric:
            # the reference ranks the float32 margin sum as it stands,
            # without the init score or rf's 1/T (one host copy)
            m = _ndcg_score(vsum[:, 0].cpu().numpy(), self.vy_host, self.vg,
                            self.p.max_position, blocks=self.ndcg_blocks)
            return self.record(m, it)
        if self.p.boosting_type == "rf":
            # rf margins are the average of the trees so far
            vsum = vsum * float(np.float32(1.0) / np.float32(it + 1))
        # the metric in float64, so the card and the CPU stop alike
        vscore = (vsum + self.init).to(torch.float64)
        if self.k > 1:
            m = self.metric_fn(vscore, self.vy.to(torch.int32))
        else:
            m = self.metric_fn(vscore[:, 0], self.vy.to(torch.float64))
        return self.record(float(m), it)

    def record(self, m: float, it: int) -> bool:
        """Record a metric value; True = stop early."""
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
                      init_model: Optional[Booster] = None,
                      compute_importances: bool = True,
                      tree_weights: Optional[np.ndarray] = None) -> Booster:
    t_total = stacked.split_feature.shape[0]
    is_rf = p.boosting_type == "rf"
    if tree_weights is None:
        tree_weights = np.full(
            t_total, 1.0 / (t_total / max(k, 1)) if is_rf else 1.0,
            np.float32)
    booster = Booster(
        trees_feature=stacked.split_feature,
        trees_threshold=stacked.threshold,
        trees_left=stacked.left_child,
        trees_right=stacked.right_child,
        trees_value=stacked.leaf_value,
        trees_cover=stacked.cover,
        trees_gain=stacked.gain,
        tree_weights=np.asarray(tree_weights[:t_total], np.float32),
        params=p,
        init_score=init,
        num_class=k,
        best_iteration=tracker.final_best_iter(),
        num_features=f,
        feature_names=feature_names,
        eval_history=tracker.history,
    )
    if compute_importances:
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
    if p.boosting_type in ("dart", "rf"):
        raise NotImplementedError(
            f"init_model continuation is not defined for "
            f"{p.boosting_type} (dart rescales past trees; rf averages)")
    if init_model.num_class != k:
        raise ValueError("init_model num_class mismatch")
    margins = init_model.predict_raw(
        x, num_iteration=init_model.num_iterations,
        device=device).reshape(x.shape[0], k)
    return float(init_model.init_score), margins


def _validate_loop_extras(p: BoostParams, checkpoint_dir) -> None:
    if checkpoint_dir is not None and p.boosting_type == "dart":
        raise NotImplementedError(
            "step checkpointing is not defined for dart (past trees "
            "are rescaled every round)")


def _validate_lr_schedule(p: BoostParams, learning_rates):
    if learning_rates is None:
        return None
    if p.boosting_type == "dart":
        raise NotImplementedError(
            "per-iteration learning_rates are not defined for dart "
            "(tree weights are renormalized every round)")
    if p.boosting_type == "rf":
        raise NotImplementedError(
            "rf averages unshrunk trees; a learning-rate schedule "
            "does not apply")
    learning_rates = np.asarray(learning_rates, np.float32)
    if learning_rates.shape != (p.num_iterations,):
        raise ValueError(
            f"learning_rates must have shape ({p.num_iterations},), "
            f"got {learning_rates.shape}")
    return learning_rates


def _checkpoint_every(p: BoostParams, tracker: _ValidTracker,
                      checkpoint_every: int) -> int:
    """Iterations between checkpoints: where the reference's scan chunks
    end (one chunk, or ``max(early_stopping_round, 16)`` iterations when
    early stopping can act), at most ``checkpoint_every``."""
    esr = p.early_stopping_round
    chunk = max(esr, 16) if (tracker.enabled and esr > 0) else p.num_iterations
    if tracker.enabled and tracker.is_rank_metric:
        # the reference's rank chunks hold <= 4M margins of snapshots
        chunk = min(chunk, max(1, 4_000_000 // max(1, len(tracker.vy_host))))
    chunk = max(1, min(chunk, p.num_iterations))
    if checkpoint_every > 0:
        chunk = min(chunk, int(checkpoint_every))
    return chunk


def _stack_trees(trees: List[Tree]) -> Tree:
    return Tree(**{fld.name: np.stack([getattr(t, fld.name) for t in trees])
                   for fld in dataclasses.fields(Tree)})


def save_checkpoint(path: str, booster: Booster, iterations_done: int,
                    total_iterations: int) -> None:
    """Atomic step checkpoint: ``checkpoint.json`` in ``path`` holding
    ``iterations_done``, ``total_iterations``, ``best_iteration`` and the
    whole tree stack in LightGBM's text format (the reference's payload,
    so either package loads the other's). One file, one ``os.replace``:
    metadata and model cannot disagree after a kill mid-write."""
    os.makedirs(path, exist_ok=True)
    # the full stack: the text writer truncates at best_iteration, which
    # would drop trees past the current best of an early-stopping run
    full = dataclasses.replace(booster, best_iteration=-1)
    payload = json.dumps({
        "iterations_done": int(iterations_done),
        "total_iterations": int(total_iterations),
        "best_iteration": int(booster.best_iteration),
        "model": full.save_string(),
    })
    fd, tmp = tempfile.mkstemp(dir=path)
    with os.fdopen(fd, "w") as fh:
        fh.write(payload)
    os.replace(tmp, os.path.join(path, "checkpoint.json"))


def load_checkpoint(path: str) -> Tuple[Booster, Dict[str, int]]:
    """Load a step checkpoint; resume with ``train(replace(p,
    num_iterations=total - done), x, y, init_model=booster)``."""
    with open(os.path.join(path, "checkpoint.json")) as fh:
        payload = json.load(fh)
    booster = Booster.load_string(payload.pop("model"))
    booster.best_iteration = int(payload.get("best_iteration", -1))
    return booster, payload


def _leaf_quantiles(residual: torch.Tensor, row_slot: torch.Tensor,
                    n_slots: int, alpha: float) -> torch.Tensor:
    """[n_slots] float32: each slot's alpha-quantile of its rows' non-NaN
    residuals, NaN for a slot without one (``jnp.nanquantile``'s linear
    method: position ``alpha * (count - 1)``, ``low * (1 - w) + high * w``
    in float32). One stable sort by (slot, residual) serves every slot;
    the interpolation is separate element-wise ops, so the card and the
    CPU round alike (a fused lerp could contract into an FMA)."""
    n = residual.shape[0]
    if n == 0:
        return torch.full((n_slots,), torch.nan, device=residual.device)
    slot = torch.where(torch.isnan(residual), n_slots, row_slot.long())
    order = torch.sort(residual, stable=True).indices     # NaN last
    order = order[torch.sort(slot[order], stable=True).indices]
    values = residual[order]
    counts = torch.bincount(slot, minlength=n_slots + 1)[:n_slots]
    starts = torch.cumsum(counts, 0) - counts
    cf = counts.to(torch.float32)
    q = torch.full_like(cf, _f32(alpha)) * (cf - 1.0)
    low, high = torch.floor(q), torch.ceil(q)
    high_w = q - low
    low_w = 1.0 - high_w

    def value(pos):   # the sorted residual at a slot's position
        pos = torch.clamp(torch.minimum(pos, cf - 1.0), min=0.0)
        return values[(starts + pos.long()).clamp(0, n - 1)]
    out = value(low) * low_w + value(high) * high_w
    return torch.where(counts > 0, out, torch.nan)


def _renew_leaves(tree: Tree, residual: torch.Tensor, row_slot, slot_value,
                  slot_node: np.ndarray, alpha: float):
    """L1-family leaf renewal (LightGBM RenewTreeOutput): a leaf's output
    becomes the alpha-quantile of the residuals of its rows (NaN residuals,
    a mesh's pad rows, are skipped)."""
    renewed = _leaf_quantiles(residual, row_slot, slot_value.shape[0], alpha)
    slot_value = torch.where(torch.isnan(renewed), slot_value, renewed)
    tree = dataclasses.replace(tree, leaf_value=leaf_values(
        slot_node, slot_value.cpu().numpy(), tree.leaf_value.shape[0]))
    return tree, slot_value


def _dart_select(rng, t: int, cur_weights, p: BoostParams) -> np.ndarray:
    """One DART iteration's drop set (host RNG, lib_lightgbm dart.hpp
    DroppingTrees): skip_drop gates the whole round; uniform mode is
    Bernoulli(drop_rate) per tree, weighted mode drops proportionally to
    each tree's current |weight| (normalized by the mean weight)."""
    if t == 0 or rng.random() < p.skip_drop:
        return np.empty(0, np.int64)
    w = np.abs(np.asarray(cur_weights[:t], np.float64))
    if p.uniform_drop or w.sum() <= 0:
        sel = rng.random(t) < p.drop_rate
    else:
        probs = np.minimum(1.0, p.drop_rate * t * w / w.sum())
        sel = rng.random(t) < probs
    dropped = np.nonzero(sel)[0]
    if p.max_drop > 0:  # LightGBM: max_drop <= 0 = no limit
        dropped = dropped[: p.max_drop]
    return dropped


def _dart_normalize(p: BoostParams, kd: int):
    """(new_tree_weight, dropped_scale) after a round that dropped
    ``kd`` trees: lr/(kd+1) classic, lr/(kd+lr) in xgboost_dart_mode."""
    if kd == 0:
        return p.learning_rate, 1.0
    if p.xgboost_dart_mode:
        return (p.learning_rate / (kd + p.learning_rate),
                kd / (kd + p.learning_rate))
    return p.learning_rate / (kd + 1.0), kd / (kd + 1.0)


def _weighted_sum(weights: np.ndarray, preds: List[torch.Tensor]
                  ) -> torch.Tensor:
    """``sum_i weights[i] * preds[i]`` (the reference's einsum) in float64,
    added in order and rounded once to float32: each product of two
    float32 values is exact, so the card and the CPU agree bitwise."""
    acc = torch.zeros_like(preds[0], dtype=torch.float64)
    for w, pred in zip(weights, preds):
        if w != 0.0:
            acc += float(w) * pred.to(torch.float64)
    return acc.to(torch.float32)


def _train_dart(p: BoostParams, binned: torch.Tensor,
                index: kernels.BinIndex, target: torch.Tensor, wd, obj_fn,
                gp: GrowerParams, thresholds: np.ndarray, init: float, k: int,
                f: int, feature_names) -> Booster:
    """DART boosting (Rashmi & Gilad-Bachrach), as the reference's
    ``_train_dart``: each round drops a random subset of the iterations so
    far (host RNG seeded with ``p.seed``), fits the new trees against the
    rest, then renormalizes (w_new = lr/(|D|+1), dropped *= |D|/(|D|+1)).
    An iteration's k class trees share one weight. Each iteration's train
    predictions stay on the device, so the reduced ensemble's score is a
    weighted sum, not a traversal. As in the reference, dart grows every
    tree on all rows and features (bagging, GOSS and feature_fraction do
    not apply), renews no leaves, and reads no validation set; the
    reference also splits a JAX key per tree that nothing reads."""
    n = binned.shape[0]
    dev = binned.device
    all_rows = torch.ones(n, dtype=torch.bool, device=dev)
    rng = np.random.default_rng(p.seed)
    trees: List[Tree] = []               # class-interleaved, t % k == class
    iter_preds: List[torch.Tensor] = []  # per iteration: [n] or [n, k]
    weights: List[float] = []            # one weight per iteration
    base = torch.full((n, k) if k > 1 else (n,), init, dtype=torch.float32,
                      device=dev)
    for _ in range(p.num_iterations):
        t = len(iter_preds)
        dropped = _dart_select(rng, t, np.asarray(weights, np.float64), p)
        w_used = np.asarray(weights, np.float32)
        w_used[dropped] = 0.0
        score_used = base + _weighted_sum(w_used, iter_preds) if t else base
        g, h = obj_fn(score_used, target, wd)
        preds = []
        for c in range(k):
            gc, hc = ((g[:, c].contiguous(), h[:, c].contiguous()) if k > 1
                      else (g, h))
            tree, row_slot, slot_value, _ = build_tree(
                binned, gc, hc, all_rows, thresholds, gp, index=index)
            trees.append(tree)
            preds.append(slot_value[row_slot.long()])
        iter_preds.append(torch.stack(preds, dim=1) if k > 1 else preds[0])
        new_w, scale = _dart_normalize(p, len(dropped))
        for d in dropped:
            weights[d] *= scale
        weights.append(float(new_w))

    stacked = _stack_trees(trees)
    booster = Booster(
        trees_feature=stacked.split_feature,
        trees_threshold=stacked.threshold,
        trees_left=stacked.left_child,
        trees_right=stacked.right_child,
        trees_value=stacked.leaf_value,
        trees_cover=stacked.cover,
        trees_gain=stacked.gain,
        # iteration weights expanded to the class-interleaved tree stack
        tree_weights=np.repeat(np.asarray(weights, np.float32), k),
        params=p, init_score=init, num_class=k, num_features=f,
        feature_names=feature_names)
    booster.feature_importance_split, booster.feature_importance_gain = (
        _importances(booster, f))
    return booster


def train(
    p: BoostParams,
    x: np.ndarray,
    y: np.ndarray,
    weight: Optional[np.ndarray] = None,
    group: Optional[np.ndarray] = None,
    valid_sets: Sequence[Tuple[np.ndarray, ...]] = (),
    feature_names: Optional[List[str]] = None,
    mesh=None,
    init_model: Optional[Booster] = None,
    checkpoint_dir: Optional[str] = None,
    checkpoint_every: int = 0,
    learning_rates: Optional[np.ndarray] = None,
    iteration_hook: Optional[Callable[[int], None]] = None,
    device: str = device_policy.DEFAULT_DEVICE,
) -> Booster:
    """Train a Booster on ``device`` (the card unless the caller asks for
    the CPU).

    ``group`` holds each row's query id for the ranking objectives
    (lambdarank, rank_xendcg); a query's rows need not be contiguous, and
    the rows are never reordered. ``valid_sets`` holds ``(x, y)`` pairs
    or ``(x, y, group)`` triples; the first is scored after every
    iteration (a ranker's ``ndcg`` needs its group).

    ``init_model`` continues boosting from an existing booster's margins
    (the reference's batch-model threading, LightGBMBase.scala:49-61, and
    the resume half of step checkpointing). ``checkpoint_dir`` (with
    ``checkpoint_every``) writes a loadable partial model where the
    reference's scan chunks end, at most every ``checkpoint_every``
    iterations (:func:`save_checkpoint`); a killed run resumes through
    :func:`load_checkpoint` and ``init_model``. ``learning_rates`` is an
    optional per-iteration shrinkage schedule (the delegate's dynamic-LR
    hook, LightGBMDelegate.scala:57-61). ``iteration_hook(iters_done)``
    fires after every iteration.

    ``mesh`` (a ``torch.distributed`` process group, the counterpart of
    the reference's 1-axis "dp" mesh; one rank per device, rank order is
    shard order) trains data-parallel: every rank passes the same ``x``,
    ``y`` (and ``weight``, ``group``, ``valid_sets``), bins all of it,
    and grows on its own block of the reference's row layout
    (:func:`_layout_rows`), its histograms reduced across the ranks; see
    :func:`_train_distributed` for the mesh's semantics, where checkpoints
    (rank 0 writes them) and ``iteration_hook`` come at the reference's
    chunk ends. Every rank returns the same booster.
    """
    dev = device_policy.resolve(device)
    _check_params(p)
    pg = collectives.check_group(mesh) if mesh is not None else None
    if (pg is None and p.objective in _RANKING
            and p.boosting_type == "dart"):
        # the reference fails here with a TypeError: its _train_dart calls
        # the objective function, which is None for ranking
        raise ValueError(
            f"boosting_type='dart' with the {p.objective} objective is not "
            "defined: dart has no ranking gradient")
    if p.num_iterations < 1:
        raise ValueError(f"num_iterations must be >= 1, got {p.num_iterations}")
    x = np.asarray(x, dtype=np.float64)
    y = np.asarray(y, dtype=np.float32)
    n, f = x.shape
    k = p.num_class if p.objective in _MULTICLASS else 1

    mapper = BinMapper(max_bin=p.max_bin,
                       categorical_features=p.categorical_features,
                       subsample=p.bin_sample_count, seed=p.seed).fit(x)
    binned_np = mapper.transform(x)
    gp = p.grower(mapper.total_bins)
    thresholds = mapper.threshold_values().astype(np.float32)
    init, init_margins = _resume_state(p, init_model, k, x,
                                       _init_score(p, y, weight), dev)
    _validate_loop_extras(p, checkpoint_dir)
    learning_rates = _validate_lr_schedule(p, learning_rates)
    if pg is not None:
        # before any copy of the whole matrix to the device: each rank
        # places only its block
        if p.objective in _RANKING and group is None:
            raise ValueError("ranking objectives need a group array")
        w_ranks = collectives.axis_size(pg)
        laid = _layout_rows(p.objective in _RANKING, w_ranks, binned_np, y,
                            weight, init_margins, group, gp.max_bin)
        per, r = laid[-1] // w_ranks, collectives.axis_index(pg)
        block = slice(r * per, (r + 1) * per)
        shard = _Shard(*(a[block] if a is not None else None
                         for a in laid[:-1]))
        return _train_distributed(
            p, pg, dev, shard, k, init, gp, thresholds, valid_sets,
            feature_names, init_model, checkpoint_dir, checkpoint_every,
            learning_rates, iteration_hook)
    binned = torch.from_numpy(binned_np).to(dev)
    index = kernels.bin_index(binned, gp.max_bin)  # every K1 launch reads it
    obj_fn = _objective_fn(p, group, dev)

    yd = torch.from_numpy(y).to(dev)
    wd = (torch.from_numpy(np.asarray(weight, np.float32)).to(dev)
          if weight is not None else None)
    y_onehot = (torch.nn.functional.one_hot(yd.long(), k).to(torch.float32)
                if k > 1 else None)

    def compute_grad(base: torch.Tensor, c: int):
        """(grad, hess) of class ``c`` at the margins ``base`` (the
        reference's ``compute_grad``)."""
        if k > 1:
            g, h = obj_fn(base, y_onehot, wd)
            return g[:, c].contiguous(), h[:, c].contiguous()
        return obj_fn(base, yd, wd)

    if p.boosting_type == "dart":
        return _train_dart(p, binned, index, y_onehot if k > 1 else yd, wd,
                           obj_fn, gp, thresholds, init, k, f, feature_names)
    if init_margins is not None:
        scores = torch.from_numpy(np.ascontiguousarray(
            init_margins if k > 1 else init_margins[:, 0], np.float32)).to(dev)
    else:
        scores = torch.full((n, k) if k > 1 else (n,), init,
                            dtype=torch.float32, device=dev)
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
    ckpt_every = (_checkpoint_every(p, tracker, checkpoint_every)
                  if checkpoint_dir is not None else 0)

    is_rf = p.boosting_type == "rf"
    sample_rows = (p.boosting_type == "goss" or is_rf or (
        p.bagging_freq > 0 and (p.bagging_fraction < 1.0 or _stratified(p))))
    sample_features = p.feature_fraction < 1.0
    # the reference's key stream: one split of PRNGKey(seed) a tree, then
    # one key for the rows and one for the features
    rng = (prng.prng_key(p.seed, dev) if sample_rows or sample_features
           else None)
    all_rows = torch.ones(n, dtype=torch.bool, device=dev)
    trees: List[Tree] = []
    for it in range(p.num_iterations):
        if is_rf:
            lr = 1.0
        elif learning_rates is not None:
            lr = learning_rates[it]
        else:
            lr = p.learning_rate
        for c in range(k):
            # rf fits every tree to the gradients at the init score
            base = torch.full_like(scores, init) if is_rf else scores
            g, h = compute_grad(base, c)
            row_mask, tree_bins, tree_index = all_rows, binned, index
            if rng is not None:
                rng, key = prng.split(rng)
                row_key, feature_key = prng.split(key)
                if sample_rows:
                    row_mask, g, h = _sample_rows(p, g, h, yd, row_key)
                if sample_features:
                    tree_bins, tree_index = kernels.mask_features(
                        index, binned, _feature_keep(p, f, feature_key))
            tree, row_slot, slot_value, slot_node = build_tree(
                tree_bins, g, h, row_mask, thresholds, gp, index=tree_index)
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
            break    # a stopped run writes no checkpoint past its last one
        done = it + 1
        if ckpt_every and (done % ckpt_every == 0
                           or done == p.num_iterations):
            save_checkpoint(checkpoint_dir, _combined_booster(
                trees, p, k, init, f, feature_names, tracker, init_model,
                compute_importances=False), done, p.num_iterations)

    return _combined_booster(trees, p, k, init, f, feature_names, tracker,
                             init_model)


def _combined_booster(trees: List[Tree], p: BoostParams, k: int,
                      init: float, f: int, feature_names,
                      tracker: _ValidTracker, init_model: Optional[Booster],
                      compute_importances: bool = True,
                      tree_weights: Optional[np.ndarray] = None) -> Booster:
    """The booster of ``init_model``'s trees followed by ``trees``."""
    booster = _assemble_booster(
        _prepend_init_trees(init_model, _stack_trees(trees)), p, k, init, f,
        feature_names, tracker, init_model=init_model,
        compute_importances=compute_importances, tree_weights=tree_weights)
    if init_model is not None and booster.best_iteration >= 0:
        # best_iteration indexes the combined tree stack
        booster.best_iteration += init_model.num_iterations
    return booster


# -- data-parallel training ---------------------------------------------------

def _pack_queries(group, n_shards):
    """Greedily pack whole queries onto the least-loaded of ``n_shards``
    shards, in first-appearance order. Returns (each shard's row indices,
    dense 0..nq-1 group ids, per-shard loads)."""
    group = np.asarray(group)
    if group.size == 0:  # an empty rank still takes part
        return ([np.zeros(0, np.int64) for _ in range(n_shards)],
                np.zeros(0, np.int64), np.zeros(n_shards, np.int64))
    sort_idx = np.argsort(group, kind="stable")
    sorted_g = group[sort_idx]
    bounds = np.nonzero(sorted_g[1:] != sorted_g[:-1])[0] + 1
    query_rows = np.split(sort_idx, bounds)
    query_rows.sort(key=lambda rows: int(rows.min()))
    shard_rows: List[List[np.ndarray]] = [[] for _ in range(n_shards)]
    loads = np.zeros(n_shards, np.int64)
    for rows in query_rows:
        tgt = int(np.argmin(loads))
        shard_rows[tgt].append(rows)
        loads[tgt] += len(rows)
    shard_idx = [np.concatenate(rs) if rs else np.zeros(0, np.int64)
                 for rs in shard_rows]
    # dense ids: user ids may be negative, and pad rows need the negatives
    _, dense_gid = np.unique(group, return_inverse=True)
    return shard_idx, dense_gid, loads


def _layout_shards(shard_idx, dense_gid, per, binned_np, y, weight,
                   init_margins, bdev, neg_base=0):
    """Each shard's rows followed by pad rows up to ``per``. Pad rows sit
    in bin ``bdev - 1`` with unique negative group ids (``neg_base``
    keeps several ranks' pads apart), so they form no pairs. Returns
    (binned, y, weight, init_margins, valid mask, group ids)."""
    n_shards = len(shard_idx)
    valid = np.ones(per * n_shards, bool)
    gids = np.full(per * n_shards, -1, np.int64)
    for s, rows in enumerate(shard_idx):
        gids[s * per:s * per + len(rows)] = dense_gid[rows]
        valid[s * per + len(rows):(s + 1) * per] = False

    def lay(arr, fill=0):
        out = np.full((per * n_shards,) + arr.shape[1:], fill, arr.dtype)
        for s, rows in enumerate(shard_idx):
            out[s * per:s * per + len(rows)] = arr[rows]
        return out
    binned_np = lay(binned_np, fill=bdev - 1)
    y = lay(y)
    weight = lay(weight) if weight is not None else None
    init_margins = lay(init_margins) if init_margins is not None else None
    pads = np.nonzero(~valid)[0]
    gids[pads] = -(np.arange(len(pads)) + 1 + neg_base)
    return binned_np, y, weight, init_margins, valid, gids


def _layout_rows(is_rank, n_shards, binned_np, y, weight, init_margins,
                 group, bdev):
    """The reference's row layout for ``n_shards`` ranks: ranking fits
    pack whole queries onto shards (:func:`_layout_shards`); every other
    fit pads zero-bin rows at the end up to a multiple of ``n_shards``.
    Returns (binned, y, weight, init_margins, valid mask, group ids or
    None, padded row count); shard ``r`` is block ``r``."""
    n0, f = binned_np.shape
    if is_rank:
        shard_idx, dense_gid, loads = _pack_queries(group, n_shards)
        per = int(loads.max())
        laid = _layout_shards(shard_idx, dense_gid, per, binned_np, y,
                              weight, init_margins, bdev)
        return laid + (per * n_shards,)
    pad = (-n0) % n_shards
    return (*(_pad_rows(a, pad) for a in (binned_np, y, weight,
                                          init_margins)),
            np.arange(n0 + pad) < n0, None, n0 + pad)


def _pad_rows(arr: Optional[np.ndarray], pad: int) -> Optional[np.ndarray]:
    """``arr`` with ``pad`` zero rows appended (bin 0 for bins)."""
    if arr is None or pad == 0:
        return arr
    return np.concatenate([arr, np.zeros((pad,) + arr.shape[1:], arr.dtype)])


@dataclasses.dataclass
class _Shard:
    """This rank's block of the row layout (host numpy)."""
    binned: np.ndarray             # [n_l, F] bins
    y: np.ndarray                  # [n_l] labels
    weight: Optional[np.ndarray]   # [n_l] row weights
    margins: Optional[np.ndarray]  # [n_l, k] init_model margins
    valid: np.ndarray              # [n_l] bool, False on pad rows
    gids: Optional[np.ndarray]     # [n_l] query ids (ranking)


_GOSS_BINS = 512


def _goss_global(p: BoostParams, g: torch.Tensor, h: torch.Tensor,
                 valid: torch.Tensor, key: torch.Tensor, pg):
    """GOSS with the mesh's global top-rate threshold (the reference's
    ``goss_select``): a rank-summed 512-bin |grad| histogram under the
    ranks' max |grad| gives the threshold, in the reference's float32
    operations; each rank draws the other rows from ``fold_in(key,
    rank)``. Returns (mask, grad, hess)."""
    absg = torch.where(valid, g.abs(), 0.0)
    gmax = collectives.all_reduce_max(absg.max(), pg) + _f32(1e-12)
    idx = (absg / gmax * _GOSS_BINS).to(torch.int32).clamp(0, _GOSS_BINS - 1)
    counts = torch.zeros(_GOSS_BINS, dtype=torch.float32, device=g.device)
    # counts below 2^24 add exactly in any order
    counts.index_add_(0, idx.long(), valid.to(torch.float32))
    hist = collectives.all_reduce_sum(counts, pg)
    total = collectives.all_reduce_sum(valid.sum().to(torch.float32), pg)
    n_top = torch.clamp(torch.floor(total * _f32(p.top_rate)), min=1.0)
    from_top = torch.flip(torch.cumsum(torch.flip(hist, (0,)), 0), (0,))
    tbin = torch.clamp((from_top >= n_top).sum() - 1, min=0)
    thresh = tbin.to(torch.float32) * gmax / _GOSS_BINS
    top = absg >= thresh
    rand = prng.uniform(prng.fold_in(key, collectives.axis_index(pg)),
                        g.shape[0]) < _f32(p.other_rate)
    amp = _f32((1.0 - p.top_rate) / max(p.other_rate, 1e-12))
    small = ~top & rand & valid
    return ((top | small) & valid, torch.where(small, g * amp, g),
            torch.where(small, h * amp, h))


def _mesh_chunk(p: BoostParams, tracker: _ValidTracker, k: int,
                checkpoint_dir, checkpoint_every: int) -> int:
    """Iterations a chunk of the reference's mesh loop, where its
    checkpoints are written and its ``iteration_hook`` fires: the
    single-device chunks, dart's at most ``256 // k`` iterations."""
    chunk = _checkpoint_every(
        p, tracker, checkpoint_every if checkpoint_dir is not None else 0)
    if p.boosting_type == "dart":
        chunk = min(chunk, max(1, 256 // max(1, k)))
    return chunk


def _train_distributed(p: BoostParams, pg, dev: torch.device, shard: _Shard,
                       k: int, init: float, gp: GrowerParams,
                       thresholds: np.ndarray, valid_sets, feature_names,
                       init_model: Optional[Booster], checkpoint_dir,
                       checkpoint_every: int, learning_rates,
                       iteration_hook) -> Booster:
    """Data-parallel boosting over the ranks of process group ``pg``: the
    reference's ``_train_distributed`` as a plain Python loop over
    iterations and classes. This rank holds ``shard``, its block of the
    row layout, on ``dev``, with one :func:`kernels.bin_index` a fit;
    every K1 launch runs on its rows and ``build_tree`` reduces across the
    ranks (data_parallel, or voting_parallel with ``gp.voting_top_k``), so
    every rank grows the same trees and returns the same booster.

    The mesh's semantics are the reference's mesh ones, not its
    single-device ones:
    - bagging and rf draw each rank's rows from ``fold_in(key, rank)``
      (then ``fold_in(bagging_seed)``); rf's fraction is 0.632 where
      ``bagging_fraction`` is 1;
    - goss takes a global threshold (:func:`_goss_global`);
    - ``feature_fraction`` keeps ``permutation(fold_in(key, 17), F)``'s
      first features on every rank;
    - dart keeps its drop schedule in float32 weights, an iteration's k
      class trees sharing one, and fits on all rows and features;
    - lambdarank and rank_xendcg both take the dense LambdaRank gradient
      on each rank's whole queries, times the weight; pad rows (unique
      negative query ids) get none;
    - L1 and quantile renewal gather the residuals (NaN on pad rows) and
      row slots of every rank and take each leaf's quantile globally.
    The validation set is replicated: every rank scores it and stops at
    the same iteration. Checkpoints and ``iteration_hook`` come where the
    reference's scan chunks end (:func:`_mesh_chunk`); rank 0 alone
    writes a checkpoint.
    """
    rank = collectives.axis_index(pg)
    is_rank_obj = p.objective in _RANKING
    is_dart = p.boosting_type == "dart"
    is_rf = p.boosting_type == "rf"
    use_goss = p.boosting_type == "goss"
    strat = _stratified(p)
    use_bagging = ((p.bagging_freq > 0 and (p.bagging_fraction < 1.0 or strat))
                   or is_rf) and not is_dart
    sample_features = p.feature_fraction < 1.0 and not is_dart
    renew_alpha = None
    if k == 1 and not is_dart:
        if p.objective in ("regression_l1", "l1", "mae"):
            renew_alpha = 0.5
        elif p.objective == "quantile":
            renew_alpha = p.alpha
    n_l, f = shard.binned.shape

    binned = torch.from_numpy(np.ascontiguousarray(shard.binned)).to(dev)
    index = kernels.bin_index(binned, gp.max_bin)  # every K1 launch reads it
    yd = _on(shard.y, np.float32, dev)
    wd = _on(shard.weight, np.float32, dev) if shard.weight is not None else None
    valid = _on(shard.valid, np.bool_, dev)
    y_onehot = (torch.nn.functional.one_hot(yd.long(), k).to(torch.float32)
                if k > 1 else None)
    if is_rank_obj:
        gids = _on(shard.gids, np.int64, dev)
        obj_fn = None
    else:
        obj_fn = _objective_fn(p)

    def grads(base: torch.Tensor):
        """(grad, hess) of every class at the margins ``base``."""
        if k > 1:
            return obj_fn(base, y_onehot, wd)
        if is_rank_obj:
            return obj._weighted(*obj.lambdarank_grad(
                base, yd, gids, max_dcg_pos=p.max_position), wd)
        return obj_fn(base, yd, wd)

    if shard.margins is not None:
        m = shard.margins if k > 1 else shard.margins[:, 0]
        scores = _on(m, np.float32, dev)
    else:
        scores = torch.full((n_l, k) if k > 1 else (n_l,), init,
                            dtype=torch.float32, device=dev)

    tracker = _ValidTracker(p, k, init, valid_sets, dev)
    track = tracker.enabled and not is_dart
    if track and init_model is not None:
        vraw = init_model.predict_raw(
            tracker.vx.cpu().numpy(),
            num_iteration=init_model.num_iterations, device=dev)
        tracker.vsum = torch.from_numpy(np.ascontiguousarray(
            vraw.reshape(-1, k) - init, np.float32)).to(dev)
    chunk = _mesh_chunk(p, tracker, k, checkpoint_dir, checkpoint_every)

    # dart: running float32 iteration weights (the reference's schedule)
    drng = np.random.default_rng(p.seed) if is_dart else None
    dart_w = np.zeros(p.num_iterations, np.float32)
    iter_preds: List[torch.Tensor] = []

    rng = prng.prng_key(p.seed, dev)
    trees: List[Tree] = []
    for it in range(p.num_iterations):
        if is_rf:
            lr = 1.0
        elif learning_rates is not None:
            lr = learning_rates[it]
        else:
            lr = p.learning_rate
        if is_dart:
            dropped = _dart_select(drng, it, dart_w, p)
            w_used = dart_w.copy()
            w_used[dropped] = 0.0
            base = torch.full_like(scores, init)
            if it:
                base = base + _weighted_sum(w_used[:it], iter_preds)
            g_all, h_all = grads(base)
            preds = []
        for c in range(k):
            rng, key = prng.split(rng)
            if is_dart:
                g, h = ((g_all[:, c].contiguous(), h_all[:, c].contiguous())
                        if k > 1 else (g_all, h_all))
            else:
                base = torch.full_like(scores, init) if is_rf else scores
                g, h = grads(base)
                if k > 1:
                    g, h = g[:, c].contiguous(), h[:, c].contiguous()
            row_mask = valid
            if use_goss:
                row_mask, g, h = _goss_global(p, g, h, valid, key, pg)
            elif use_bagging:
                bkey = prng.fold_in(key, rank)
                if p.bagging_seed is not None:
                    bkey = prng.fold_in(bkey, p.bagging_seed)
                u = prng.uniform(bkey, n_l)
                if strat and not is_rf:
                    row_mask = valid & torch.where(
                        yd > 0, u < _f32(p.pos_bagging_fraction),
                        u < _f32(p.neg_bagging_fraction))
                else:
                    frac = (p.bagging_fraction if p.bagging_fraction < 1.0
                            else 0.632)
                    row_mask = valid & (u < _f32(frac))
            tree_bins, tree_index = binned, index
            if sample_features:
                # the same key on every rank: the same features mesh-wide
                tree_bins, tree_index = kernels.mask_features(
                    index, binned,
                    _feature_keep(p, f, prng.fold_in(key, 17)))
            tree, row_slot, slot_value, slot_node = build_tree(
                tree_bins, g, h, row_mask, thresholds, gp, index=tree_index,
                group=pg)
            if renew_alpha is not None:
                residual = torch.where(valid, yd - scores, torch.nan)
                tree, slot_value = _renew_leaves(
                    tree, collectives.all_gather(residual, pg),
                    collectives.all_gather(row_slot, pg), slot_value,
                    slot_node, renew_alpha)
            if is_dart:
                preds.append(slot_value[row_slot.long()])
                trees.append(tree)
                continue
            delta = slot_value[row_slot.long()] * float(lr)
            if k > 1:
                scores[:, c] += delta
            else:
                scores = scores + delta
            tree = dataclasses.replace(
                tree, leaf_value=tree.leaf_value * np.float32(lr))
            trees.append(tree)
            if track:
                tracker.add_tree(tree, c)
        if is_dart:
            iter_preds.append(torch.stack(preds, dim=1) if k > 1
                              else preds[0])
            new_w, scale = _dart_normalize(p, len(dropped))
            dart_w[dropped] *= scale
            dart_w[it] = new_w
        if track and tracker.step(it):
            if iteration_hook is not None:
                iteration_hook(it + 1)
            break    # a stopped run writes no checkpoint past its last one
        done = it + 1
        if done % chunk == 0 or done == p.num_iterations:
            if checkpoint_dir is not None and rank == 0:
                save_checkpoint(checkpoint_dir, _combined_booster(
                    trees, p, k, init, f, feature_names, tracker, init_model,
                    compute_importances=False), done, p.num_iterations)
            if iteration_hook is not None:
                iteration_hook(done)

    return _combined_booster(
        trees, p, k, init, f, feature_names, tracker, init_model,
        tree_weights=np.repeat(dart_w, k) if is_dart else None)


def row_sharded_mesh_ok(mesh) -> bool:
    """Whether :func:`train_row_sharded` can take ``mesh``: None (the
    world group) or a process group. A rank is one device and rank order
    is process order, so the reference's device-layout conditions hold
    for every group."""
    return mesh is None or isinstance(mesh, dist.ProcessGroup)


def _init_score_sync(p: BoostParams, y, weight, pg,
                     dev: torch.device) -> float:
    """boost_from_average over every rank's rows from this rank's labels:
    the two float64 sums of each rank, or for the quantile family the
    float32 labels themselves (the feature rows never move)."""
    if not p.boost_from_average or p.objective in _MULTICLASS + _RANKING:
        return 0.0
    if p.objective in ("quantile", "regression_l1", "l1", "mae", "huber",
                       "mape"):
        y_g = collectives.gather_rows(np.asarray(y, np.float32), pg, dev)
        if p.objective == "quantile":
            return float(np.quantile(y_g, p.alpha))
        return float(np.median(y_g))
    y = np.asarray(y, np.float64)
    w = (np.asarray(weight, np.float64) if weight is not None
         else np.ones_like(y))
    sums = collectives.gather_rows(np.asarray(
        [[float(np.sum(w * y)), float(np.sum(w))]], np.float64), pg, dev)
    mean = float(sums[:, 0].sum()) / max(float(sums[:, 1].sum()), 1e-300)
    if p.objective in ("binary", "binary_logloss"):
        pbar = float(np.clip(mean, 1e-12, 1 - 1e-12))
        return float(np.log(pbar / (1 - pbar)) / p.sigmoid)
    if p.objective in ("poisson", "tweedie"):
        return float(np.log(max(mean, 1e-12)))
    return mean


def train_row_sharded(
    p: BoostParams,
    x: np.ndarray,
    y: np.ndarray,
    weight: Optional[np.ndarray] = None,
    group: Optional[np.ndarray] = None,
    valid_sets: Sequence[Tuple[np.ndarray, ...]] = (),
    feature_names: Optional[List[str]] = None,
    mesh=None,
    init_model: Optional[Booster] = None,
    checkpoint_dir: Optional[str] = None,
    checkpoint_every: int = 0,
    learning_rates: Optional[np.ndarray] = None,
    iteration_hook: Optional[Callable[[int], None]] = None,
    stats_out: Optional[Dict[str, Any]] = None,
    device: str = device_policy.DEFAULT_DEVICE,
) -> Booster:
    """Data-parallel training where each rank passes only ITS rows (the
    reference's ``tree_learner=data_parallel``: a task streams its own
    partition, LightGBMBase.scala:482-486, and only fixed-size histograms
    cross the network). ``mesh`` is the process group (default: the world
    group; where none is initialized, this process alone trains as a
    world of one rank, ``collectives.ALONE``, as the reference trains
    over its one process's devices); ``x``, ``y``, ``weight`` and
    ``group`` are this rank's rows, a query's rows all on one rank;
    ``valid_sets`` the same on every rank.

    What crosses the ranks: a bin-boundary sample of at most
    ``bin_sample_count`` rows in all (each rank's share proportional to
    its rows, drawn with ``default_rng(seed * 1000003 + rank)``; every row
    where the job fits the budget), the two float64 label sums of the init
    score (the float32 labels for the quantile family), query and row
    counts, and per split the reduced histograms. Where the job's rows fit
    the budget and the ranks hold consecutive blocks in rank order of
    equal size, the bins, the layout and so the booster are those of
    ``train(..., mesh=)`` on the whole rows. ``stats_out`` receives the
    reference's layout and traffic counts; ``addressable_row_bytes`` is
    the bytes of this rank's binned block on its device.
    """
    dev = device_policy.resolve(device)
    _check_params(p)
    pg = collectives.check_group(mesh)
    if p.num_iterations < 1:
        raise ValueError(
            f"num_iterations must be >= 1, got {p.num_iterations}")
    x = np.asarray(x, dtype=np.float64)
    y = np.asarray(y, dtype=np.float32)
    n_local, f = x.shape
    k = p.num_class if p.objective in _MULTICLASS else 1
    if weight is not None and len(weight) != n_local:
        raise ValueError("weight length != row count")
    rank = collectives.axis_index(pg)

    n_all = collectives.gather_rows(np.asarray([n_local], np.int64), pg, dev)
    n_total = int(n_all.sum())
    if n_total == 0:
        raise ValueError("no rows to fit: every rank's partition was empty")
    budget = max(int(p.bin_sample_count), 1)
    if n_total <= budget:
        sample = x
    else:
        share = max(1, int(budget * n_local / n_total))
        srng = np.random.default_rng(p.seed * 1000003 + rank)
        sample = x[np.sort(srng.choice(n_local, min(share, n_local),
                                       replace=False))]
    sample_g = collectives.gather_rows(sample, pg, dev)
    mapper = BinMapper(max_bin=p.max_bin,
                       categorical_features=p.categorical_features,
                       subsample=budget, seed=p.seed).fit(sample_g)
    binned_local = mapper.transform(x)
    bdev = mapper.total_bins
    thresholds = mapper.threshold_values().astype(np.float32)
    gp = p.grower(bdev)
    init = _init_score_sync(p, y, weight, pg, dev)
    init, init_margins = _resume_state(p, init_model, k, x, init, dev)
    _validate_loop_extras(p, checkpoint_dir)
    learning_rates = _validate_lr_schedule(p, learning_rates)

    if p.objective in _RANKING:
        if group is None:
            raise ValueError("ranking objectives need a group array")
        group = np.asarray(group)
        if group.shape[0] != n_local:
            raise ValueError("group length != row count")
        # disjoint dense query ids: a query must not span ranks
        uniq, inv = np.unique(group, return_inverse=True)
        q_counts = collectives.gather_rows(
            np.asarray([len(uniq)], np.int64), pg, dev)
        shard_idx, dense_gid, loads = _pack_queries(inv, 1)
        dense_gid = dense_gid + int(q_counts[:rank].sum())
        per_local = int(loads.max()) if len(loads) else 0
        per = max(1, int(collectives.gather_rows(
            np.asarray([per_local], np.int64), pg, dev).max()))
        shard = _Shard(*_layout_shards(
            shard_idx, dense_gid, per, binned_local, y, weight,
            init_margins, bdev, neg_base=rank * per))
    else:
        per = max(int(n_all.max()), 1)
        shard = _Shard(*(_pad_rows(a, per - n_local) for a in (
            binned_local, y, weight, init_margins)),
            valid=np.arange(per) < n_local, gids=None)

    if stats_out is not None:
        stats_out.update(
            path="row_sharded",
            n_local=int(n_local), n_total=n_total,
            n_global=per * collectives.axis_size(pg),
            per_host_rows=int(per), n_features=int(f),
            binned_local_shape=tuple(shard.binned.shape),
            sample_rows_sent=int(sample.shape[0]),
            sample_rows_gathered=int(sample_g.shape[0]),
            sample_gathered_bytes=int(sample_g.nbytes),
            addressable_row_bytes=int(shard.binned.nbytes),
            hist_backend=gp.hist_backend)
    return _train_distributed(
        p, pg, dev, shard, k, init, gp, thresholds, valid_sets,
        feature_names, init_model, checkpoint_dir, checkpoint_every,
        learning_rates, iteration_hook)

"""Carry a model's weights from the JAX reference package into the port.

Both take plain data (dicts, numpy arrays), never objects of the
reference package, so this module imports nothing of it:

- :func:`booster_from_arrays` takes a reference ``Booster.to_dict()`` (or
  a mapping of the Booster's field names to numpy arrays) and returns the
  port's :class:`~synapseml_tpu_torch.gbdt.boosting.Booster`;
- :func:`iforest_model_from_arrays` takes an isolation forest's stacked
  tree arrays and normaliser and returns the port's
  :class:`~synapseml_tpu_torch.isolationforest.IsolationForestModel`;
- :func:`graph_params_from_arrays` takes a reference ``ImportedGraph``'s
  ``params`` (initializer name -> numpy) and returns the port's params on
  the device, for the port's ``ImportedGraph.apply``.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Mapping, Sequence

import numpy as np
import torch

from synapseml_tpu_torch.device import DEFAULT_DEVICE, resolve
from synapseml_tpu_torch.gbdt.boosting import Booster, BoostParams
from synapseml_tpu_torch.isolationforest.iforest import IsolationForestModel
from synapseml_tpu_torch.onnx.importer import ImportedGraph

_ARRAY_DTYPES = {
    "trees_feature": np.int32, "trees_threshold": np.float32,
    "trees_left": np.int32, "trees_right": np.int32,
    "trees_value": np.float32, "trees_cover": np.float32,
    "trees_gain": np.float32, "tree_weights": np.float32,
    "trees_cat": np.int32, "cat_bitsets": np.uint32,
    "cat_boundaries": np.int32,
}


def booster_from_arrays(d: Mapping[str, Any]) -> Booster:
    """The port's Booster from a reference Booster's data.

    ``d`` is either the reference's ``Booster.to_dict()`` (the layout
    with a ``"trees"`` entry) or a mapping of Booster field names
    (``trees_feature``, ..., ``params``, ``init_score``, ...) to values,
    such as ``{f: getattr(b, f) for f in fields}``. ``params`` may be a
    dict or any dataclass with BoostParams' fields."""
    if "trees" in d:
        return Booster.from_dict(dict(d))
    fields = {f.name for f in dataclasses.fields(Booster)}
    unknown = set(d) - fields
    if unknown:
        raise ValueError(f"not Booster fields: {sorted(unknown)}")
    kw = {}
    for name, value in d.items():
        if name in _ARRAY_DTYPES and value is not None:
            value = np.array(value, _ARRAY_DTYPES[name])
        kw[name] = value
    params = kw.get("params")
    if params is not None and not isinstance(params, BoostParams):
        if dataclasses.is_dataclass(params):
            params = dataclasses.asdict(params)
        params = dict(params)
        params["categorical_features"] = tuple(
            params.get("categorical_features", ()))
        kw["params"] = BoostParams(**params)
    return Booster(**kw)


def iforest_model_from_arrays(trees: Sequence[np.ndarray], max_depth: int,
                              c_norm: float, threshold: float = 0.5,
                              **params: Any) -> IsolationForestModel:
    """The port's IsolationForestModel from stacked tree arrays
    ``(feature, threshold, left, right, depth_adj)`` [T, M] each, the
    fit-time depth cap and the c(sample) normaliser; ``params`` sets the
    model's column params (``features_col``, ``score_col``, ...)."""
    feat, thr, lft, rgt, dadj = trees
    arrays = (np.array(feat, np.int32), np.array(thr, np.float32),
              np.array(lft, np.int32), np.array(rgt, np.int32),
              np.array(dadj, np.float32))
    return IsolationForestModel(trees=arrays, max_depth=int(max_depth),
                                c_norm=float(c_norm),
                                threshold=float(threshold), **params)


def graph_params_from_arrays(graph: ImportedGraph,
                             arrays: Mapping[str, Any],
                             device: str | torch.device = DEFAULT_DEVICE
                             ) -> dict:
    """The port's params of ``graph`` (the port's ``ImportedGraph`` of the
    same model) from a reference ``ImportedGraph.params``: each array on
    ``device``, after its name, shape and dtype are checked against the
    port's own split of the initializers (``graph.params``)."""
    dev = resolve(device)
    missing = sorted(set(graph.params) - set(arrays))
    unknown = sorted(set(arrays) - set(graph.params))
    if missing or unknown:
        raise ValueError(f"params do not match the graph's: missing "
                         f"{missing}, not params of the graph {unknown}")
    out = {}
    for name, want in graph.params.items():
        a = np.asarray(arrays[name])
        if a.shape != want.shape or a.dtype != want.dtype:
            raise ValueError(
                f"param {name!r}: {a.dtype}{list(a.shape)}, the graph "
                f"holds {want.dtype}{list(want.shape)}")
        out[name] = torch.from_numpy(np.array(a, copy=True)).to(dev)
    return out

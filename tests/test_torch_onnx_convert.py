"""The port's ``convert_lightgbm`` against the JAX package's, on the CPU.

For the same trees (a JAX fit carried into the port through the
reference's ``Booster.to_dict``), the two converters' graphs decode to the
same nodes, attributes, inputs, outputs and opsets: only the ``producer``
string differs, since it names the package. Every refusal raises the
reference's exception with its message. No tolerance: the comparisons are
exact.
"""
import dataclasses
import os
import warnings

import numpy as np
import pytest

from synapseml_tpu.data.table import Table as JTable
from synapseml_tpu.gbdt.boosting import Booster as JBooster
from synapseml_tpu.gbdt.estimators import LightGBMClassifier as JClassifier
from synapseml_tpu.gbdt.estimators import LightGBMRegressor as JRegressor
from synapseml_tpu.onnx import convert_lightgbm as jconvert
from synapseml_tpu_torch.convert import booster_from_arrays
from synapseml_tpu_torch.gbdt.boosting import Booster
from synapseml_tpu_torch.gbdt.estimators import (LightGBMClassificationModel,
                                                 LightGBMRegressionModel)
from synapseml_tpu_torch.onnx import convert_lightgbm, proto
from test_lgbm_format import _cat_model_string

FIXTURES = os.path.join(os.path.dirname(__file__), "fixtures")
ADULT = os.path.join(FIXTURES, "lgbm_adult_100x31.txt")


def _binary_data(n=500, d=6, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, d)).astype(np.float32)
    y = (x[:, 0] - 0.5 * x[:, 1] + 0.2 * rng.normal(size=n) > 0).astype(
        np.float64)
    return x, y


def _models(kind):
    """(JAX model or Booster, the port's of the same trees)."""
    if kind == "adult_fixture":
        text = open(ADULT).read()
        return JBooster.load_string(text), Booster.load_string(text)
    if kind == "multiclass":
        rng = np.random.default_rng(3)
        x = rng.normal(size=(400, 5)).astype(np.float32)
        y = np.argmax(x[:, :3] + 0.1 * rng.normal(size=(400, 3)),
                      axis=1).astype(np.float64)
        jm = JClassifier(num_iterations=12, num_leaves=7,
                         objective="multiclass").fit(
            JTable({"features": x, "label": y}))
    elif kind == "regressor":
        rng = np.random.default_rng(5)
        x = rng.normal(size=(300, 4)).astype(np.float32)
        jm = JRegressor(num_iterations=15, num_leaves=15).fit(
            JTable({"features": x, "label": (x[:, 0] * 2 - x[:, 2])
                    .astype(np.float64)}))
    elif kind == "rf_best_iteration":
        x, y = _binary_data(seed=21)
        jm = JClassifier(num_iterations=10, num_leaves=7,
                         boosting_type="rf", bagging_fraction=0.8,
                         bagging_freq=1).fit(
            JTable({"features": x, "label": y}))
        jm.booster.best_iteration = 3
    elif kind == "goss_nan":
        x, y = _binary_data(seed=7)
        x[::17, 2] = np.nan
        jm = JClassifier(num_iterations=15, num_leaves=7,
                         boosting_type="goss").fit(
            JTable({"features": x, "label": np.where(y > 0.5, 7.0, 3.0)}))
    else:
        raise ValueError(kind)
    cls = (LightGBMClassificationModel if hasattr(jm, "label_values")
           else LightGBMRegressionModel)
    pm = cls(booster=booster_from_arrays(jm.booster.to_dict()))
    if getattr(jm, "label_values", None) is not None:
        pm.set(label_values=list(jm.label_values))
    return jm, pm


def _decoded(blob):
    m = proto.load_model(blob)
    g = m.graph
    nodes = [(n.op_type, n.domain, list(n.input), list(n.output),
              proto.node_attrs(n)) for n in g.node]
    values = [[(v.name, proto.encode(v)) for v in vs]
              for vs in (g.input, g.output)]
    opsets = [(o.domain, o.version) for o in m.opset_import]
    return m.producer_name, nodes, values, opsets, len(g.initializer)


@pytest.mark.parametrize("kind", ["adult_fixture", "multiclass", "regressor",
                                  "rf_best_iteration", "goss_nan"])
def test_converted_graph_nodes_equal_the_reference(kind):
    jm, pm = _models(kind)
    producer, nodes, values, opsets, n_init = _decoded(convert_lightgbm(pm))
    jproducer, jnodes, jvalues, jopsets, jn_init = _decoded(jconvert(jm))
    assert producer == "synapseml_tpu_torch.onnx.convert"
    assert jproducer == "synapseml_tpu.onnx.convert"
    assert nodes == jnodes
    assert values == jvalues and opsets == jopsets and n_init == jn_init
    (op_type, domain, _, outs, attrs), = nodes
    assert domain == "ai.onnx.ml"
    if kind == "regressor":
        assert op_type == "TreeEnsembleRegressor" and outs == ["variable"]
        return
    assert op_type == "TreeEnsembleClassifier"
    assert outs == ["label", "probabilities"]
    if kind == "rf_best_iteration":
        # rf renormalised at best_iteration: 4 trees of weight 1/4
        assert max(attrs["nodes_treeids"]) == 3
    if kind == "goss_nan":
        assert attrs["classlabels_int64s"] == [3, 7]
        assert set(attrs["nodes_missing_value_tracks_true"]) == {0}


def _replaced(pm, jm, **params):
    for m in (pm, jm):
        b = m.booster if hasattr(m, "booster") else m
        b.params = dataclasses.replace(b.params, **params)


@pytest.mark.parametrize("case", ["poisson", "tweedie", "multiclassova",
                                  "no_num_features", "categorical"])
def test_refusals_match_the_reference(case):
    """Every refusal of the reference, with its exception and message:
    the exp links, multiclassova, a booster without ``num_features`` and
    no ``input_size``, and categorical splits
    (``tests/test_lgbm_format.py:275-277``)."""
    if case == "categorical":
        pm = Booster.load_string(_cat_model_string())
        jm = JBooster.load_string(_cat_model_string())
        kw = dict(input_size=2)
    else:
        jm, pm = _models("multiclass" if case == "multiclassova"
                         else "adult_fixture")
        kw = {}
        if case == "no_num_features":
            pm.num_features = jm.num_features = -1
        else:
            _replaced(pm, jm, objective=case)
    err = ValueError if case == "no_num_features" else NotImplementedError
    with pytest.raises(err) as mine:
        convert_lightgbm(pm, **kw)
    with pytest.raises(err) as theirs:
        jconvert(jm, **kw)
    assert str(mine.value) == str(theirs.value)
    if case == "categorical":
        assert "categorical" in str(mine.value)
    if case == "no_num_features":
        assert _decoded(convert_lightgbm(pm, input_size=14))[1] == \
            _decoded(jconvert(jm, input_size=14))[1]


def test_non_integral_labels_warn_and_export_dense_indices():
    jm, pm = _models("goss_nan")
    for m in (jm, pm):
        m.set(label_values=[0.5, 1.5])
    with pytest.warns(RuntimeWarning, match="not integral") as mine:
        blob = convert_lightgbm(pm)
    with warnings.catch_warnings(record=True) as theirs:
        warnings.simplefilter("always")
        jblob = jconvert(jm)
    assert [str(w.message) for w in mine] == \
        [str(w.message) for w in theirs]
    assert _decoded(blob)[1] == _decoded(jblob)[1]
    assert _decoded(blob)[1][0][4]["classlabels_int64s"] == [0, 1]


def test_booster_of_refuses_what_is_not_a_model():
    with pytest.raises(TypeError, match="expected a Booster"):
        convert_lightgbm(object())

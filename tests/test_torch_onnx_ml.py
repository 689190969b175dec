"""The port's ``ai.onnx.ml`` ops against the JAX package's, on the CPU.

One case for each of the 18 tests of ``tests/test_onnx_ml.py``, the SVM
family and ``DictVectorizer`` of ``tests/test_onnx.py``, and the faults of
the reference that the port copies (ROADMAP Queue 3). Every graph's bytes
go through both importers (``tests/torch_onnx_parity.py``): the port bound
on the CPU, the reference through ``bind``, on the same numpy inputs.

Tolerances:
- tree leaf membership (``reached``: the decision pass and the first,
  integer, einsum) is bitwise the reference's;
- a tree ensemble's scores sum T reached leaves in matmul order in both
  packages, in different orders: row r within ``T · eps32 · Σ_t |w_t|``
  of the reference, the leaves it reached; its probabilities within that
  plus 4 eps32 (the logistic or softmax rounding); labels equal;
- a converted classifier's probabilities within 1e-5 of the port's
  ``Booster.predict`` (the reference's own bound, ``test_onnx_ml.py``) and
  a regressor's within 1e-4 (ditto);
- the other float ops within rtol=atol=1e-6 (one product or reduction:
  a few eps32 of their magnitudes), the SVM kernels within rtol=atol=1e-5
  (a gram product, then exp/tanh/pow), integers and host (numpy) outputs
  equal.
"""
import dataclasses
import os

import numpy as np
import pytest
import torch

import synapseml_tpu.onnx.ml_ops as jml
from synapseml_tpu.data.table import Table as JTable
from synapseml_tpu.gbdt.estimators import LightGBMClassifier as JClassifier
from synapseml_tpu.gbdt.estimators import LightGBMRegressor as JRegressor
from synapseml_tpu.onnx import ONNXModel as JONNXModel
from synapseml_tpu.onnx import convert_lightgbm as jconvert
from synapseml_tpu.onnx import import_model as jimport
from synapseml_tpu_torch.convert import booster_from_arrays
from synapseml_tpu_torch.data.table import Table
from synapseml_tpu_torch.gbdt.boosting import Booster
from synapseml_tpu_torch.gbdt.estimators import (LightGBMClassificationModel,
                                                 LightGBMRegressionModel)
from synapseml_tpu_torch.onnx import (GraphBuilder, ONNXModel,
                                      convert_lightgbm, import_model, ml_ops)
from torch_onnx_parity import assert_parity, run_both, to_numpy

EPS32 = float(np.finfo(np.float32).eps)
OP_TOL = 1e-6
SVM_TOL = 1e-5
BOOSTER_TOL = 1e-5
REGRESSOR_TOL = 1e-4
FIXTURES = os.path.join(os.path.dirname(__file__), "fixtures")
ADULT = os.path.join(FIXTURES, "lgbm_adult_100x31.txt")
ADULT_IO = os.path.join(FIXTURES, "lgbm_adult_100x31_io.npz")


def _binary_data(n=500, d=6, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, d)).astype(np.float32)
    y = (x[:, 0] - 0.5 * x[:, 1] + 0.2 * rng.normal(size=n) > 0).astype(
        np.float64)
    return x, y


def _port_model(jmodel):
    """The port's model of a JAX-fitted one: the same trees (the
    reference's ``Booster.to_dict``) and class labels."""
    cls = (LightGBMClassificationModel if hasattr(jmodel, "label_values")
           else LightGBMRegressionModel)
    model = cls(booster=booster_from_arrays(jmodel.booster.to_dict()))
    if getattr(jmodel, "label_values", None) is not None:
        model.set(label_values=list(jmodel.label_values))
    return model


class _Einsums:
    """Stands in for ``jnp`` in the reference's ``ml_ops`` and records each
    ``einsum``'s operands (the reference runs op by op: they are arrays)."""

    def __init__(self):
        import jax.numpy as jnp

        self._jnp = jnp
        self.calls = []

    def __getattr__(self, name):
        return getattr(self._jnp, name)

    def einsum(self, spec, *ops, **kw):
        self.calls.append((spec, [np.asarray(o) for o in ops]))
        return self._jnp.einsum(spec, *ops, **kw)


def _tree_parity(blob, x, monkeypatch):
    """Run ``blob``'s one tree-ensemble node in both packages on ``x``:
    ``reached`` bitwise, the scores' outputs within the matmul-order
    bound, labels equal. Returns the port's outputs."""
    port_g = import_model(blob)
    port = port_g.bind(device="cpu")(torch.from_numpy(x))
    cap = _Einsums()
    monkeypatch.setattr(jml, "jnp", cap)
    ref_g = jimport(blob)
    ref = ref_g.bind()(x)
    monkeypatch.undo()
    (_, jreached_ops), = [c for c in cap.calls if c[0] == "ntl,tlk->nk"]
    impl, ctx = port_g._nodes[-1][0], port_g._nodes[-1][1]
    tables = ml_ops.tree_tables(ctx)
    consts = ml_ops._on(ctx, impl, torch.device("cpu"))
    reached = tables.reached(torch.from_numpy(x), consts).numpy()
    np.testing.assert_array_equal(reached, jreached_ops[0])
    assert (reached.sum(-1) == 1).all()           # one leaf a tree
    bound = tables.n_trees * EPS32 * np.einsum(
        "ntl,tlk->nk", reached.astype(np.float64),
        np.abs(tables.weights.astype(np.float64))).max(-1)
    for p, r in zip(port, ref):
        pn, rn = to_numpy(p), np.asarray(r)
        if pn.dtype.kind in "iu":
            np.testing.assert_array_equal(pn, rn)
        else:
            gap = np.abs(pn - rn).reshape(len(x), -1).max(-1)
            assert (gap <= bound + 4 * EPS32).all(), (gap.max(), bound)
    return [to_numpy(p) for p in port]


# ---------------------------------------------------------------------------
# the notebook path: train -> convert -> import -> score (the JAX fit's
# trees in both packages; each side converts its own Booster)
# ---------------------------------------------------------------------------

def _fit(kind, seed=0):
    if kind == "binary":
        x, y = _binary_data(seed=seed)
        return x, JClassifier(num_iterations=20, num_leaves=15).fit(
            JTable({"features": x, "label": y}))
    if kind == "multiclass":
        rng = np.random.default_rng(3)
        x = rng.normal(size=(400, 5)).astype(np.float32)
        y = np.argmax(x[:, :3] + 0.1 * rng.normal(size=(400, 3)),
                      axis=1).astype(np.float64)
        return x, JClassifier(num_iterations=12, num_leaves=7,
                              objective="multiclass").fit(
            JTable({"features": x, "label": y}))
    if kind == "regressor":
        rng = np.random.default_rng(5)
        x = rng.normal(size=(300, 4)).astype(np.float32)
        y = (x[:, 0] * 2 - x[:, 2]).astype(np.float64)
        return x, JRegressor(num_iterations=15, num_leaves=15).fit(
            JTable({"features": x, "label": y}))
    if kind == "goss_nan":
        x, y = _binary_data(seed=7)
        x[::17, 2] = np.nan
        return x, JClassifier(num_iterations=15, num_leaves=7,
                              boosting_type="goss").fit(
            JTable({"features": x, "label": y}))
    if kind == "rf_best_iteration":
        x, y = _binary_data(seed=21)
        model = JClassifier(
            num_iterations=10, num_leaves=7, boosting_type="rf",
            bagging_fraction=0.8, bagging_freq=1).fit(
            JTable({"features": x, "label": y}))
        model.booster.best_iteration = 3  # early stopping at iteration 3
        return x, model
    if kind == "labels_3_7":
        x, y01 = _binary_data(seed=31)
        return x, JClassifier(num_iterations=10, num_leaves=7).fit(
            JTable({"features": x, "label": np.where(y01 > 0.5, 7.0, 3.0)}))
    raise ValueError(kind)


@pytest.mark.parametrize("kind", ["binary", "multiclass", "regressor",
                                  "goss_nan", "rf_best_iteration",
                                  "labels_3_7"])
def test_converted_lightgbm_matches_the_reference_and_the_booster(
        kind, monkeypatch):
    """``test_lightgbm_{binary,multiclass,regressor}_to_onnx_matches_booster``,
    ``test_goss_and_nan_features_roundtrip``,
    ``test_rf_truncated_at_best_iteration_matches_booster`` and
    ``test_converted_classifier_keeps_original_labels``: the port's
    converted graph against the reference's on the same trees, and
    against the port's own ``Booster.predict``."""
    x, jmodel = _fit(kind)
    model = _port_model(jmodel)
    outs = _tree_parity(convert_lightgbm(model), x, monkeypatch)
    want = model.booster.predict(x, device="cpu")
    if kind == "regressor":
        np.testing.assert_allclose(outs[0][:, 0], want, atol=REGRESSOR_TOL)
        return
    label, probs = outs
    assert label.dtype == np.int64 and probs.dtype == np.float32
    if kind == "multiclass":
        np.testing.assert_allclose(probs, want, atol=BOOSTER_TOL)
        np.testing.assert_array_equal(label, want.argmax(-1))
        return
    np.testing.assert_allclose(probs[:, 1], want, atol=BOOSTER_TOL)
    hi, lo = (7, 3) if kind == "labels_3_7" else (1, 0)
    np.testing.assert_array_equal(label, np.where(want > 0.5, hi, lo))


def test_adult_fixture_converted_matches_the_reference_and_k2(monkeypatch):
    """The 100-tree, 31-leaf Adult fixture at full width: ``reached``
    bitwise, probabilities within the bound of the reference's ONNX path
    and within 1e-5 of the port's ``Booster.predict``, labels equal."""
    booster = Booster.load_string(open(ADULT).read())
    x = np.load(ADULT_IO)["x"][:256]
    label, probs = _tree_parity(convert_lightgbm(booster), x, monkeypatch)
    want = booster.predict(x, device="cpu")
    np.testing.assert_allclose(probs[:, 1], want, atol=BOOSTER_TOL)
    np.testing.assert_array_equal(label, (want > 0.5).astype(np.int64))


def test_onnx_model_transformer_notebook_flow():
    """``test_onnx_model_transformer_notebook_flow`` with warmup on the CPU
    path: ``ONNXModel(feed_dict={"input": "features"})`` over a converted
    model, every bucket warmed, each dispatch a warm hit, rows bitwise an
    eager model's and within 1e-5 of ``Booster.predict`` and of the JAX
    ``ONNXModel``'s."""
    x, y = _binary_data(seed=11)
    jmodel = JClassifier(num_iterations=10, num_leaves=7).fit(
        JTable({"features": x, "label": y}))
    model = _port_model(jmodel)
    blob = convert_lightgbm(model)
    kw = dict(feed_dict={"input": "features"}, mini_batch_size=128)
    warm = ONNXModel(model_bytes=blob, **kw)
    rep = warm.warmup(device="cpu")
    assert rep.errors == [] and rep.compiled == len(rep.entries) > 0
    out = warm.transform(Table({"features": x}), device="cpu")
    assert warm._executor("cpu")._aot_hits == 4    # 500 rows: 3 x 128 + 116
    eager = ONNXModel(model_bytes=blob, **kw).transform(
        Table({"features": x}), device="cpu")
    for col in ("label", "probabilities"):
        np.testing.assert_array_equal(out[col], eager[col])
    assert out["label"].dtype == np.int64
    assert out["probabilities"].shape == (500, 2)
    probs = np.asarray(out["probabilities"])
    np.testing.assert_allclose(probs[:, 1],
                               model.booster.predict(x, device="cpu"),
                               atol=BOOSTER_TOL)
    ref = JONNXModel(model_bytes=jconvert(jmodel), **kw).transform(
        JTable({"features": x}))
    np.testing.assert_allclose(probs, np.asarray(ref["probabilities"]),
                               rtol=0, atol=BOOSTER_TOL)
    np.testing.assert_array_equal(out["label"], np.asarray(ref["label"]))


def test_bf16_compute_compares_the_rounded_features():
    """``compute_dtype="bfloat16"``: the executor stages the features in
    bf16, so the splits see rounded values, as in the reference. Both
    packages' ``ONNXModel`` agree, and equal float32 scoring of the
    features rounded to bf16."""
    booster = Booster.load_string(open(ADULT).read())
    x = np.load(ADULT_IO)["x"][:200]
    blob = convert_lightgbm(booster)
    kw = dict(feed_dict={"input": "features"}, mini_batch_size=64,
              compute_dtype="bfloat16")
    got = ONNXModel(model_bytes=blob, **kw).transform(
        Table({"features": x}), device="cpu")
    rounded = torch.from_numpy(x).to(torch.bfloat16).float().numpy()
    f32 = ONNXModel(model_bytes=blob, feed_dict=kw["feed_dict"]).transform(
        Table({"features": rounded}), device="cpu")
    np.testing.assert_array_equal(got["probabilities"], f32["probabilities"])
    np.testing.assert_array_equal(got["label"], f32["label"])
    assert not np.array_equal(
        got["probabilities"], ONNXModel(model_bytes=blob, feed_dict=kw[
            "feed_dict"]).transform(Table({"features": x}),
                                    device="cpu")["probabilities"])
    ref = JONNXModel(model_bytes=blob, **kw).transform(
        JTable({"features": x}))
    np.testing.assert_allclose(got["probabilities"],
                               np.asarray(ref["probabilities"]), rtol=0,
                               atol=BOOSTER_TOL)
    np.testing.assert_array_equal(got["label"], np.asarray(ref["label"]))


def test_multiclassova_conversion_raises():
    rng = np.random.default_rng(0)
    x = rng.normal(size=(120, 4)).astype(np.float32)
    y = rng.integers(0, 3, 120).astype(np.float64)
    jmodel = JClassifier(num_iterations=4, num_leaves=5,
                         objective="multiclass").fit(
        JTable({"features": x, "label": y}))
    model = _port_model(jmodel)
    model.booster.params = dataclasses.replace(
        model.booster.params, objective="multiclassova")
    jmodel.booster.params = dataclasses.replace(
        jmodel.booster.params, objective="multiclassova")
    with pytest.raises(NotImplementedError, match="multiclassova") as mine:
        convert_lightgbm(model)
    with pytest.raises(NotImplementedError) as theirs:
        jconvert(jmodel)
    assert str(mine.value) == str(theirs.value)


def test_tree_path_tensor_size_guard(monkeypatch):
    """The dense [T, M, n_leaves] path tensor refuses (not silently
    allocates) gigabytes: the reference's thresholds and messages, at the
    port's bind (where the tables are built and bound)."""
    x, y = _binary_data(n=200, seed=41)
    jmodel = JClassifier(num_iterations=4, num_leaves=7).fit(
        JTable({"features": x, "label": y}))
    blob = convert_lightgbm(_port_model(jmodel))
    assert ml_ops._PATH_WARN_BYTES == jml._PATH_WARN_BYTES == 256 << 20
    assert ml_ops._PATH_GUARD_BYTES == jml._PATH_GUARD_BYTES == 2 << 30
    for mod in (ml_ops, jml):
        monkeypatch.setattr(mod, "_PATH_WARN_BYTES", 16)
    with pytest.warns(RuntimeWarning, match="path tensor allocates") as w:
        import_model(blob).bind(device="cpu")(torch.from_numpy(x[:8]))
    with pytest.warns(RuntimeWarning) as jw:
        g = jimport(blob)
        g.apply(g.params, x[:8])
    assert str(w[0].message) == str(jw[0].message)
    for mod in (ml_ops, jml):
        monkeypatch.setattr(mod, "_PATH_GUARD_BYTES", 64)
    with pytest.raises(MemoryError, match="path tensor would allocate") as e:
        import_model(blob).bind(device="cpu")
    with pytest.raises(MemoryError) as je:
        g = jimport(blob)
        g.apply(g.params, x[:8])
    assert str(e.value) == str(je.value)


# ---------------------------------------------------------------------------
# classical-ML op cases
# ---------------------------------------------------------------------------

def _ml_graph(op, in_shape, out_shape, out_dtype=np.float32, n_outputs=1,
              extra_inputs=(), in_dtype=np.float32, **attrs) -> bytes:
    g = GraphBuilder(opset=17)
    x = g.add_input("x", in_dtype, list(in_shape))
    ins = [x]
    for nm, arr in extra_inputs:
        ins.append(g.add_initializer(nm, arr))
    outs = [f"o{i}" for i in range(n_outputs)]
    g.add_node(op, ins, outputs=outs, domain="ai.onnx.ml", **attrs)
    for o in outs:
        g.add_output(o, out_dtype, list(out_shape))
    return g.to_bytes()


_X3 = np.array([[1.0, -2.0, np.nan], [4.0, 0.0, 2.0]], np.float32)


@pytest.mark.parametrize("case", [
    ("Scaler", dict(offset=[1.0, 0.0, 0.0], scale=[2.0, 1.0, 1.0]), True),
    ("Imputer", dict(imputed_value_floats=[9.0, 9.0, 9.0]), False),
    ("Imputer", dict(imputed_value_floats=[7.5]), False),
    ("Binarizer", dict(threshold=0.5), True),
    ("Normalizer", dict(norm="L2"), True),
    ("Normalizer", dict(norm="L1"), True),
    ("Normalizer", dict(norm="MAX"), True),
], ids=lambda c: f"{c[0]}-{sorted(c[1].items())[0]}")
@pytest.mark.parametrize("host", [False, True])
def test_scaler_normalizer_binarizer_imputer(case, host):
    op_type, attrs, fill_nan = case
    x = np.nan_to_num(_X3) if fill_nan else _X3
    blob = _ml_graph(op_type, ["N", 3], ["N", 3], **attrs)
    port, ref = run_both(blob, [x], host=host)
    assert_parity(port, ref, rtol=OP_TOL, atol=OP_TOL)
    if op_type == "Scaler" and host:
        assert isinstance(port[0], np.ndarray)    # the host path stays numpy


def test_imputer_concrete_replaced_value_leaves_nan():
    blob = _ml_graph("Imputer", ["N", 3], ["N", 3],
                     imputed_value_floats=[9.0, 9.0, 9.0],
                     replaced_value_float=-1.0)
    x = np.array([[np.nan, -1.0, 3.0]], np.float32)
    port, ref = run_both(blob, [x])
    assert_parity(port, ref)
    out = port[0].numpy()[0]
    assert np.isnan(out[0]) and out[1] == 9.0 and out[2] == 3.0


_XL = np.array([[1.0, 0.0], [0.0, 2.0], [-1.0, -1.0]], np.float32)


@pytest.mark.parametrize("attrs, n_out", [
    (dict(coefficients=[1.0, -1.0], intercepts=[0.1],
          classlabels_int64s=[0, 1], post_transform="LOGISTIC"), 2),
    (dict(coefficients=[1.0, -1.0, 0.5, 2.0, -3.0, 1.0],
          intercepts=[0.1, 0.0, -0.2], classlabels_ints=[4, 5, 6],
          post_transform="SOFTMAX"), 2),
    (dict(coefficients=[2.0, 0.5], intercepts=[1.0]), 1),
    (dict(coefficients=[2.0, 0.5, 1.0, -1.0], intercepts=[1.0, 0.0],
          targets=2, post_transform="LOGISTIC"), 1),
])
def test_linear_classifier_and_regressor(attrs, n_out):
    op_type = "LinearClassifier" if n_out == 2 else "LinearRegressor"
    blob = _ml_graph(op_type, ["N", 2], ["N", 2], n_outputs=n_out, **attrs)
    port, ref = run_both(blob, [_XL])
    assert_parity(port, ref, rtol=OP_TOL, atol=OP_TOL)
    if op_type == "LinearClassifier" and len(attrs["intercepts"]) == 1:
        s = _XL @ np.array([1.0, -1.0], np.float32) + 0.1
        p = 1 / (1 + np.exp(-s))
        np.testing.assert_allclose(port[1].numpy()[:, 1], p, rtol=1e-5)
        np.testing.assert_array_equal(port[0].numpy(), (p > 0.5).astype(int))


def test_linear_classifier_takes_its_class_count_from_the_input_width():
    """A reference fault the port copies (ROADMAP Queue 3): the class count
    is the coefficients' size over the input's width, so a 3-class
    classifier of 2 features (6 coefficients) fed 6-wide rows scores them
    as a binary one-score model, unrefused."""
    blob = _ml_graph("LinearClassifier", ["N", 2], ["N", 2], n_outputs=2,
                     coefficients=[1.0, -1.0, 0.5, 2.0, -3.0, 1.0],
                     intercepts=[0.1, 0.0, -0.2], classlabels_ints=[4, 5, 6],
                     post_transform="SOFTMAX")
    wide = np.random.default_rng(0).normal(size=(4, 6)).astype(np.float32)
    port, ref = run_both(blob, [wide])
    assert_parity(port, ref, rtol=OP_TOL, atol=OP_TOL)
    assert port[1].shape == (4, 3)          # 3 labels, one score column


def test_array_feature_extractor_and_vectorizer():
    x = np.arange(12, dtype=np.float32).reshape(3, 4)
    for idx in ([2, 0], [1, 2, 3], [3, -1, 0, 1], [7]):
        blob = _ml_graph("ArrayFeatureExtractor", ["N", 4], ["N", 2],
                         extra_inputs=[("idx", np.array(idx, np.int64))])
        # past the width, numpy refuses a host index in both packages
        for host in (False, True) if max(idx) < 4 else (False,):
            assert_parity(*run_both(blob, [x], host=host))
    gb = GraphBuilder(opset=17)
    a = gb.add_input("a", np.float32, ["N", 2])
    b = gb.add_input("b", np.int64, ["N"])
    out = gb.add_node("FeatureVectorizer", [a, b], domain="ai.onnx.ml",
                      inputdimensions=[2, 1])
    gb.add_output(out, np.float32, ["N", 3])
    av = np.ones((2, 2), np.float32)
    bv = np.full((2,), 5, np.int64)
    port, ref = run_both(gb.to_bytes(), [av, bv])
    assert_parity(port, ref)
    np.testing.assert_allclose(port[0].numpy(), [[1, 1, 5]] * 2)


@pytest.mark.parametrize("host", [False, True])
def test_label_encoder_and_onehot(host):
    blob = _ml_graph("LabelEncoder", ["N"], ["N"], out_dtype=np.int64,
                     in_dtype=np.int64, keys_int64s=[30, 10, 20],
                     values_int64s=[2, 0, 1], default_int64=-1)
    x = np.array([20, 10, 99, 5, 30], np.int64)
    port, ref = run_both(blob, [x], host=host)
    assert_parity(port, ref)
    np.testing.assert_array_equal(to_numpy(port[0]), [1, 0, -1, -1, 2])
    blob = _ml_graph("LabelEncoder", ["N"], ["N"], in_dtype=np.int64,
                     keys_int64s=[1, 2], values_floats=[0.5, -1.5],
                     default_float=9.0)
    port, ref = run_both(blob, [np.array([2, 3, 1], np.int64)], host=host)
    assert_parity(port, ref)
    blob = _ml_graph("OneHotEncoder", ["N"], ["N", 3], in_dtype=np.int64,
                     cats_int64s=[3, 5, 7])
    x = np.array([5, 7, 4], np.int64)
    port, ref = run_both(blob, [x], host=host)
    assert_parity(port, ref)
    np.testing.assert_allclose(to_numpy(port[0]),
                               [[0, 1, 0], [0, 0, 1], [0, 0, 0]])


def test_string_maps_stay_host_values():
    """``LabelEncoder``'s string side and ``CategoryMapper`` take and give
    numpy object arrays through ``bind``, as the reference's do."""
    words = np.array(["b", "zz", "a"], dtype=object)
    blob = _ml_graph("LabelEncoder", ["N"], ["N"], out_dtype=np.int64,
                     keys_strings=["a", "b"], values_int64s=[7, 8],
                     default_int64=-1)
    port, ref = run_both(blob, [words], host=True)
    np.testing.assert_array_equal(port[0], ref[0])
    np.testing.assert_array_equal(port[0], [8, -1, 7])
    blob = _ml_graph("CategoryMapper", ["N"], ["N"], out_dtype=np.int64,
                     cats_strings=["a", "b"], cats_int64s=[1, 2],
                     default_int64=-5)
    port, ref = run_both(blob, [words], host=True)
    np.testing.assert_array_equal(port[0], ref[0])
    back = run_both(blob, [np.array([2, 1, 9], np.int64)])
    assert list(back[0][0]) == list(back[1][0]) == ["b", "a", "_Unused"]
    blob = _ml_graph("LabelEncoder", ["N"], ["N"], out_dtype=np.int64,
                     keys_strings=["a", "b"], values_int64s=[7, 8])
    with pytest.raises(NotImplementedError, match="string-keyed"):
        import_model(blob).bind(device="cpu")(torch.tensor([1, 2]))


def _one_tree(mode, miss=0, post=None, **extra):
    attrs = dict(
        nodes_treeids=[0, 0, 0], nodes_nodeids=[0, 1, 2],
        nodes_featureids=[0, 0, 0], nodes_modes=[mode, "LEAF", "LEAF"],
        nodes_values=[1.5, 0.0, 0.0],
        nodes_truenodeids=[1, 1, 2], nodes_falsenodeids=[2, 1, 2],
        nodes_missing_value_tracks_true=[miss, 0, 0],
        target_treeids=[0, 0], target_nodeids=[1, 2], target_ids=[0, 0],
        target_weights=[10.0, 20.0], n_targets=1, **extra)
    if post:
        attrs["post_transform"] = post
    return _ml_graph("TreeEnsembleRegressor", ["N", 1], ["N", 1], **attrs)


@pytest.mark.parametrize("mode", ["BRANCH_LEQ", "BRANCH_LT", "BRANCH_GTE",
                                  "BRANCH_GT", "BRANCH_EQ", "BRANCH_NEQ"])
@pytest.mark.parametrize("miss", [0, 1])
def test_tree_modes_beyond_leq(mode, miss, monkeypatch):
    """Every branch mode, with and without missing-tracks-true; the
    reference's case is BRANCH_GT with it (x>1.5 -> 10; else 20; NaN
    tracks true -> 10)."""
    x = np.array([[2.0], [1.5], [1.0], [np.nan]], np.float32)
    (out,) = _tree_parity(_one_tree(mode, miss), x, monkeypatch)
    test = {"BRANCH_LEQ": x <= 1.5, "BRANCH_LT": x < 1.5,
            "BRANCH_GTE": x >= 1.5, "BRANCH_GT": x > 1.5,
            "BRANCH_EQ": x == 1.5, "BRANCH_NEQ": x != 1.5}[mode][:, 0]
    test[3] = bool(miss)
    np.testing.assert_array_equal(out[:, 0], np.where(test, 10.0, 20.0))


def test_narrow_input_is_refused_where_the_reference_clamps():
    """A deliberate departure (ROADMAP Queue 3): the reference's gather
    clamps a column index past the input's width, so a 13-column row
    scores against the 14-feature Adult model; the port refuses it."""
    booster = Booster.load_string(open(ADULT).read())
    blob = convert_lightgbm(booster)
    x = np.load(ADULT_IO)["x"][:4]
    g = jimport(blob)
    assert np.asarray(g.apply(g.params, x[:, :13])[1]).shape == (4, 2)
    with pytest.raises(ValueError, match="reads feature 13"):
        import_model(blob).bind(device="cpu")(torch.from_numpy(x[:, :13]))


def _classifier_one_score(post, class_ids, weights=(-2.0, 2.0)):
    return _ml_graph(
        "TreeEnsembleClassifier", ["N", 1], ["N", 2], n_outputs=2,
        nodes_treeids=[0, 0, 0], nodes_nodeids=[0, 1, 2],
        nodes_featureids=[0, 0, 0],
        nodes_modes=["BRANCH_LEQ", "LEAF", "LEAF"],
        nodes_values=[0.0, 0.0, 0.0],
        nodes_truenodeids=[1, 1, 2], nodes_falsenodeids=[2, 1, 2],
        class_treeids=[0, 0], class_nodeids=[1, 2], class_ids=class_ids,
        class_weights=list(weights), classlabels_int64s=[0, 1],
        post_transform=post)


def test_binary_single_score_on_class_id_one(monkeypatch):
    """Spec-valid binary ensembles may scatter the single score into
    class_id 1."""
    x = np.array([[-1.0], [1.0]], np.float32)
    _, probs = _tree_parity(_classifier_one_score("LOGISTIC", [1, 1]), x,
                            monkeypatch)
    sig = 1 / (1 + np.exp(-np.array([-2.0, 2.0])))
    np.testing.assert_allclose(probs[:, 1], sig, rtol=1e-5)


def test_binary_single_score_softmax_is_the_raw_score(monkeypatch):
    """A reference fault the port copies (ROADMAP Queue 3): a binary
    one-score ensemble with ``SOFTMAX`` skips the transform, so its
    probabilities are ``[1 - s, s]`` of the raw score, outside [0, 1]."""
    x = np.array([[-1.0], [1.0]], np.float32)
    label, probs = _tree_parity(_classifier_one_score("SOFTMAX", [0, 0]), x,
                                monkeypatch)
    np.testing.assert_array_equal(probs, [[3.0, -2.0], [-1.0, 2.0]])
    np.testing.assert_array_equal(label, [0, 1])


def test_softmax_zero_keeps_zeros_and_clamps_an_all_zero_row():
    """A reference fault the port copies (ROADMAP Queue 3):
    ``SOFTMAX_ZERO`` divides by ``max(sum, 1e-30)``, so a row of zeros
    gives zeros (not 0/0)."""
    blob = _ml_graph("LinearRegressor", ["N", 2], ["N", 3],
                     coefficients=[1.0, 0.0, 0.0, 1.0, 0.0, 0.0],
                     intercepts=[0.0, 0.0, 0.0], targets=3,
                     post_transform="SOFTMAX_ZERO")
    x = np.array([[0.0, 0.0], [1.0, 0.0], [2.0, -1.0]], np.float32)
    port, ref = run_both(blob, [x])
    assert_parity(port, ref, rtol=OP_TOL, atol=OP_TOL)
    out = port[0].numpy()
    np.testing.assert_array_equal(out[0], [0.0, 0.0, 0.0])
    np.testing.assert_array_equal(out[1], [1.0, 0.0, 0.0])
    assert out[2, 2] == 0.0 and abs(out[2, :2].sum() - 1.0) < 1e-6


def test_string_class_labels_raise_at_the_first_run():
    blob = _ml_graph(
        "TreeEnsembleClassifier", ["N", 1], ["N", 2], n_outputs=2,
        nodes_treeids=[0], nodes_nodeids=[0], nodes_featureids=[0],
        nodes_modes=["LEAF"], nodes_values=[0.0], nodes_truenodeids=[0],
        nodes_falsenodeids=[0], class_treeids=[0], class_nodeids=[0],
        class_ids=[0], class_weights=[1.0],
        classlabels_strings=["no", "yes"])
    fn = import_model(blob).bind(device="cpu")
    with pytest.raises(NotImplementedError, match="string class labels"):
        fn(torch.zeros((2, 1)))
    with pytest.raises(NotImplementedError, match="string class labels"):
        jimport(blob).bind()(np.zeros((2, 1), np.float32))


_V5 = dict(
    tree_roots=[0, 2],
    # tree0: n0(f0<=0.5) -> leaf0 | n1(f1>2) -> leaf1|leaf2
    # tree1: n2(f1<1.5) -> leaf3 | leaf4
    nodes_modes=np.asarray([0, 3, 1], np.uint8),
    nodes_featureids=[0, 1, 1],
    nodes_splits=np.asarray([0.5, 2.0, 1.5], np.float32),
    nodes_truenodeids=[0, 1, 3], nodes_trueleafs=[1, 1, 1],
    nodes_falsenodeids=[1, 2, 4], nodes_falseleafs=[0, 1, 1],
    leaf_targetids=[0, 0, 0, 0, 0],
    leaf_weights=np.asarray([1.5, -1.0, 3.0, 0.25, -0.25], np.float32),
    n_targets=1)


def _v5(agg, post):
    g = GraphBuilder(opset=17)
    x = g.add_input("x", np.float32, [None, 2])
    y = g.add_node("TreeEnsemble", [x], domain="ai.onnx.ml",
                   aggregate_function=agg, post_transform=post, **_V5)
    g.add_output(y, np.float32, None)
    return g.to_bytes()


def test_tree_ensemble_v5_matches_old_style(monkeypatch):
    """The opset-5 TreeEnsemble against the old-style TreeEnsembleRegressor
    on the same two-tree ensemble, each against the reference, plus the
    hand-evaluated routes and the AVERAGE + LOGISTIC codes."""
    xv = np.array([[0.3, 5.0], [0.9, 5.0], [0.9, 1.0]], np.float32)
    (got,) = _tree_parity(_v5(1, 0), xv, monkeypatch)
    np.testing.assert_allclose(got.reshape(-1), [1.25, -1.25, 3.25],
                               atol=1e-6)
    g2 = GraphBuilder(opset=17)
    x2 = g2.add_input("x", np.float32, [None, 2])
    y2 = g2.add_node(
        "TreeEnsembleRegressor", [x2], domain="ai.onnx.ml",
        nodes_treeids=[0, 0, 0, 0, 0, 1, 1, 1],
        nodes_nodeids=[0, 1, 2, 3, 4, 0, 1, 2],
        nodes_modes=["BRANCH_LEQ", "LEAF", "BRANCH_GT", "LEAF", "LEAF",
                     "BRANCH_LT", "LEAF", "LEAF"],
        nodes_featureids=[0, 0, 1, 0, 0, 1, 0, 0],
        nodes_values=[0.5, 0., 2.0, 0., 0., 1.5, 0., 0.],
        nodes_truenodeids=[1, 0, 3, 0, 0, 1, 0, 0],
        nodes_falsenodeids=[2, 0, 4, 0, 0, 2, 0, 0],
        target_treeids=[0, 0, 0, 1, 1],
        target_nodeids=[1, 3, 4, 1, 2],
        target_ids=[0, 0, 0, 0, 0],
        target_weights=[1.5, -1.0, 3.0, 0.25, -0.25], n_targets=1)
    g2.add_output(y2, np.float32, None)
    (got2,) = _tree_parity(g2.to_bytes(), xv, monkeypatch)
    np.testing.assert_allclose(got, got2, atol=1e-6)
    (got3,) = _tree_parity(_v5(0, 2), xv, monkeypatch)
    np.testing.assert_allclose(got3, 1.0 / (1.0 + np.exp(-got / 2.0)),
                               atol=1e-6)


def test_cast_map_dense_and_dict_forms():
    """CastMap behind ZipMap (the sklearn-converter tail), plus the
    genuine-map form with SPARSE densification, in both packages."""
    g = GraphBuilder(opset=17)
    p = g.add_input("p", np.float32, [None, 3])
    z = g.add_node("ZipMap", [p], domain="ai.onnx.ml",
                   classlabels_int64s=[0, 1, 2])
    cm = g.add_node("CastMap", [z], domain="ai.onnx.ml", cast_to="TO_FLOAT")
    g.add_output(cm, np.float32, None)
    pv = np.array([[0.1, 0.7, 0.2]], np.float32)
    port, ref = run_both(g.to_bytes(), [pv])
    assert_parity(port, ref)
    np.testing.assert_array_equal(port[0].numpy(), pv)

    class _Ctx:
        def __init__(self, **attrs):
            self.attrs = attrs

        def attr(self, k, d=None):
            return self.attrs.get(k, d)

    for attrs, value in (
            (dict(map_form="SPARSE", max_map=5, cast_to="TO_FLOAT"),
             {1: 2.0, 3: 4.0, 9: 9.0}),
            (dict(cast_to="TO_INT64"), {0: 7.0, 1: 8.0}),
            (dict(cast_to="TO_STRING"), {1: 2.5, 0: 1.0})):
        got = ml_ops._cast_map(_Ctx(**attrs), value)
        want = jml._cast_map(_Ctx(**attrs), value)
        assert isinstance(got, np.ndarray)
        assert got.dtype == np.asarray(want).dtype
        np.testing.assert_array_equal(got, np.asarray(want))
    dense = ml_ops._cast_map(_Ctx(cast_to="TO_INT64"),
                             torch.tensor([[7.0, 8.0]]))
    assert dense.dtype == torch.int64


# ---------------------------------------------------------------------------
# the SVM family and DictVectorizer (tests/test_onnx.py)
# ---------------------------------------------------------------------------

def _svm_case(name):
    from sklearn.svm import SVC, SVR, LinearSVC, LinearSVR, OneClassSVM

    rng = np.random.default_rng(8)
    x = rng.normal(size=(120, 5))
    y3 = np.digitize(x[:, 0] + 0.7 * x[:, 1], [-0.4, 0.4])
    yb = (y3 > 0).astype(int)
    kernels = {"rbf": ("RBF", dict(gamma=0.3)),
               "poly": ("POLY", dict(gamma=0.25, coef0=1.0, degree=3)),
               "sigmoid": ("SIGMOID", dict(gamma=0.05, coef0=0.2)),
               "linear": ("LINEAR", {})}
    g = GraphBuilder(opset=21)
    xn = g.add_input("x", np.float32, ["N", 5])
    if name in kernels:
        kind, params = kernels[name]
        m = SVC(kernel=name, decision_function_shape="ovo",
                **params).fit(x, y3)
        outs = g.add_node(
            "SVMClassifier", [xn], outputs=["lab", "sc"],
            domain="ai.onnx.ml", kernel_type=kind,
            kernel_params=[float(m._gamma), float(params.get("coef0", 0.0)),
                           float(params.get("degree", 3))],
            support_vectors=m.support_vectors_.astype(
                np.float32).reshape(-1).tolist(),
            vectors_per_class=m.n_support_.tolist(),
            coefficients=m.dual_coef_.astype(np.float32).reshape(-1).tolist(),
            rho=m.intercept_.astype(np.float32).tolist(),
            classlabels_int64s=[int(c) for c in m.classes_])
    elif name == "binary_rbf":
        m = mb = SVC(kernel="rbf", gamma=0.3).fit(x, yb)
        outs = g.add_node(
            "SVMClassifier", [xn], outputs=["lab", "sc"],
            domain="ai.onnx.ml", kernel_type="RBF",
            kernel_params=[float(mb._gamma), 0.0, 3.0],
            support_vectors=mb.support_vectors_.astype(
                np.float32).reshape(-1).tolist(),
            vectors_per_class=mb.n_support_.tolist(),
            coefficients=(-mb.dual_coef_).astype(
                np.float32).reshape(-1).tolist(),
            rho=(-mb.intercept_).astype(np.float32).tolist(),
            classlabels_int64s=[int(c) for c in mb.classes_])
    elif name in ("linear_svc_binary", "linear_svc"):
        m = ml = LinearSVC().fit(x, yb if name.endswith("binary") else y3)
        outs = g.add_node(
            "SVMClassifier", [xn], outputs=["lab", "sc"],
            domain="ai.onnx.ml", kernel_type="LINEAR",
            coefficients=ml.coef_.astype(np.float32).reshape(-1).tolist(),
            rho=ml.intercept_.astype(np.float32).tolist(),
            classlabels_int64s=[int(c) for c in ml.classes_])
    elif name in ("svr", "one_class"):
        m = (SVR(kernel="rbf", gamma=0.2, C=2.0).fit(x, x[:, 0] * 2 + x[:, 1])
             if name == "svr" else
             OneClassSVM(kernel="rbf", gamma=0.2, nu=0.3).fit(x))
        outs = [g.add_node(
            "SVMRegressor", [xn], domain="ai.onnx.ml", kernel_type="RBF",
            kernel_params=[float(m._gamma), 0.0, 3.0],
            one_class=int(name == "one_class"),
            support_vectors=m.support_vectors_.astype(
                np.float32).reshape(-1).tolist(),
            n_supports=int(len(m.support_vectors_)),
            coefficients=m.dual_coef_.astype(np.float32).reshape(-1).tolist(),
            rho=m.intercept_.astype(np.float32).tolist())]
    elif name == "linear_svr":
        m = LinearSVR().fit(x, x[:, 0])
        outs = [g.add_node(
            "SVMRegressor", [xn], domain="ai.onnx.ml", kernel_type="LINEAR",
            n_supports=0,
            coefficients=m.coef_.astype(np.float32).reshape(-1).tolist(),
            rho=[float(m.intercept_[0])])]
    else:
        raise ValueError(name)
    for o in outs:
        g.add_output(o, np.float32, None)
    return g.to_bytes(), m


@pytest.mark.parametrize("name", [
    "rbf", "poly", "sigmoid", "linear", "binary_rbf", "svr", "one_class",
    "linear_svc_binary", "linear_svc", "linear_svr"])
def test_svm_family_matches_the_reference(name):
    """``test_svm_family_matches_sklearn``'s exports through both
    packages: ovo decision values, vote labels, the four kernels, SVR,
    OneClassSVM and the linear-weight modes; and sklearn's predictions
    where the reference's test holds them exactly."""
    blob, m = _svm_case(name)
    xq = np.random.default_rng(9).normal(size=(40, 5)).astype(np.float32)
    port, ref = run_both(blob, [xq])
    assert_parity(port, ref, rtol=SVM_TOL, atol=SVM_TOL)
    if name in ("binary_rbf", "one_class", "linear_svc_binary", "linear_svc"):
        got = to_numpy(port[0]).reshape(-1)
        np.testing.assert_array_equal(
            got, m.predict(xq.astype(np.float64)).astype(got.dtype))


def test_svm_refusals_match_the_reference():
    g = GraphBuilder(opset=21)
    xn = g.add_input("x", np.float32, ["N", 2])
    lab, sc = g.add_node("SVMClassifier", [xn], outputs=["lab", "sc"],
                         domain="ai.onnx.ml", kernel_type="LINEAR",
                         coefficients=[1.0, 2.0], rho=[0.0],
                         prob_a=[1.0], prob_b=[0.0])
    g.add_output(lab, np.int64, None)
    g.add_output(sc, np.float32, None)
    fn = import_model(g.to_bytes()).bind(device="cpu")
    with pytest.raises(NotImplementedError, match="Platt"):
        fn(torch.zeros((1, 2)))
    with pytest.raises(NotImplementedError, match="Platt"):
        jimport(g.to_bytes()).bind()(np.zeros((1, 2), np.float32))


def test_dict_vectorizer():
    g = GraphBuilder(opset=21)
    xn = g.add_input("x", np.float32, ["N"])  # dtype nominal: host objects
    y = g.add_node("DictVectorizer", [xn], domain="ai.onnx.ml",
                   string_vocabulary=["a", "b", "c"])
    g.add_output(y, np.float32, ["N", 3])
    rows = np.empty(2, dtype=object)
    rows[0] = {"a": 1.0, "c": 2.0, "zzz": 9.0}  # unknown keys ignored
    rows[1] = {"b": -1.0}
    port, ref = run_both(g.to_bytes(), [rows], host=True)
    assert isinstance(port[0], np.ndarray)
    np.testing.assert_array_equal(port[0], np.asarray(ref[0]))
    np.testing.assert_array_equal(port[0], [[1, 0, 2], [0, -1, 0]])
    with pytest.raises(NotImplementedError, match="host-side"):
        import_model(g.to_bytes()).bind(device="cpu")(torch.zeros(2))


# ---------------------------------------------------------------------------
# bound tables: built once, copied to the device once
# ---------------------------------------------------------------------------

def test_bind_builds_the_tables_once_and_a_bound_forward_copies_none():
    """The host tables are built once per imported node (every bind shares
    them), each bind holds its own device copies, and a bound forward
    reads them: it makes no tensor from host memory."""
    booster = Booster.load_string(open(ADULT).read())
    g = import_model(convert_lightgbm(booster))
    first, second = g.bind(device="cpu"), g.bind(device="cpu")
    ctx = g._nodes[0][1]
    tables = ml_ops.tree_tables(ctx)
    assert tables is not None and tables.n_trees == 100
    assert tables.path.shape == (100, 61, 31)
    x = torch.from_numpy(np.load(ADULT_IO)["x"][:64])
    made = []
    real = ml_ops._tensor

    def counted(v, dev=None):
        made.append(np.shape(v))
        return real(v, dev)
    ml_ops._tensor = counted
    try:
        a = first(x)
        b = second(x)
    finally:
        ml_ops._tensor = real
    assert made == []
    assert ml_ops.tree_tables(ctx) is tables
    for p, q in zip(a, b):
        assert torch.equal(p, q)


def test_committed_onnx_fixture_holds_the_port():
    """``lgbm_adult_100x31_onnx.npz`` (the JAX ``ONNXModel``'s scores of the
    1,024 Adult fixture rows, which the card run is held to): the port's
    ``ONNXModel`` on the CPU within 1e-5 and with equal labels; no row's
    probability lies within 1e-5 of 0.5, where a label could flip."""
    fx = np.load(os.path.join(FIXTURES, "lgbm_adult_100x31_onnx.npz"))
    x = np.load(ADULT_IO)["x"]
    booster = Booster.load_string(open(ADULT).read())
    out = ONNXModel(model_bytes=convert_lightgbm(booster),
                    feed_dict={"input": "features"}).transform(
        Table({"features": x}), device="cpu")
    np.testing.assert_allclose(out["probabilities"], fx["probabilities"],
                               rtol=0, atol=BOOSTER_TOL)
    np.testing.assert_array_equal(out["label"], fx["label"])
    assert np.abs(fx["probabilities"][:, 1] - 0.5).min() > BOOSTER_TOL


def test_converted_model_defaults_to_cuda_and_raises_without_it(monkeypatch):
    """``bind``, ``apply``, ``ONNXModel.transform`` and ``warmup`` of a
    converted model run on the card unless the caller asks for the CPU,
    and raise where CUDA is absent; nothing falls back."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    blob = convert_lightgbm(Booster.load_string(open(ADULT).read()))
    x = np.load(ADULT_IO)["x"][:4]
    g = import_model(blob)
    model = ONNXModel(model_bytes=blob, feed_dict={"input": "features"})
    for call in (lambda: g.bind(), lambda: g.apply(g.params, x),
                 lambda: model.transform(Table({"features": x})),
                 lambda: model.warmup()):
        with pytest.raises(RuntimeError, match="CUDA"):
            call()

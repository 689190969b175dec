"""The port's ``ONNXModel`` against the JAX package's, on the CPU.

The same graph bytes and the same seeded numpy table go through the JAX
``ONNXModel.transform(table)`` and the port's ``ONNXModel.transform(table,
"cpu")``: ``zoo.tiny_resnet()``, a small causal ``zoo.transformer_encoder``
(an integer graph input) and the torch-exported ``torch_cnn`` fixture.
float32 is held at rtol = atol = 1e-5 (``tests/torch_onnx_parity.py``'s
default), bf16 within 5% of the largest |value| of the reference's float32
output. Also: feed/fetch dicts, the softmax and argmax columns, a ragged
37-row tail at ``mini_batch_size=8``, the uint8 wire under ``input_norm``,
``model_path`` with external data, save/load (the port's own and a
directory the JAX package wrote), ``transform_stream``, the reference's
``input_norm`` errors, ``devices=`` over repeated CPU slots (and its bad
specs refused), the Params that are not ported raising
``NotImplementedError``, and ``compute_dtype="auto"`` (ported) scoring as
the dtype its measured lane resolves to.
"""
import os
import time

import numpy as np
import pytest
import torch

from synapseml_tpu.data.table import Table as JaxTable
from synapseml_tpu.onnx.model import ONNXModel as JaxONNXModel
from synapseml_tpu_torch.core.pipeline import PipelineStage
from synapseml_tpu_torch.data.table import Table
from synapseml_tpu_torch.onnx import ONNXModel, proto, zoo

RTOL = ATOL = 1e-5
BF16_SHARE = 0.05
FIXTURES = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "fixtures")
# ImageNet's per-channel mean and 1/std, in pixel units
NORM = {"mean": np.array([123.675, 116.28, 103.53]).reshape(3, 1, 1),
        "scale": 1.0 / np.array([58.395, 57.12, 57.375]).reshape(3, 1, 1)}


def _pair(blob, **params):
    return (JaxONNXModel(model_bytes=blob, **params),
            ONNXModel(model_bytes=blob, **params))


def _score(pair, cols):
    ref, port = pair
    want = ref.transform(JaxTable(dict(cols)))
    got = port.transform(Table(dict(cols)), "cpu")
    return got, want


def _close(got, want, bf16=False):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    if bf16:
        span = max(1e-6, float(np.abs(want).max()))
        assert float(np.abs(got - want).max()) <= BF16_SHARE * span
    else:
        np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


@pytest.fixture(scope="module")
def resnet():
    blob = zoo.tiny_resnet()
    x = np.random.default_rng(0).standard_normal(
        (37, 3, 32, 32)).astype(np.float32)
    return blob, x


@pytest.fixture(scope="module")
def encoder():
    blob = zoo.transformer_encoder(100, 32, 4, 64, 2, seq_len=16,
                                   causal=True, seed=1)
    ids = np.random.default_rng(1).integers(0, 100, (21, 16))
    return blob, ids


def test_feed_fetch_softmax_argmax_and_a_ragged_tail(resnet):
    """37 rows at mini_batch_size 8: four full buckets and a 5-row tail;
    a renamed input column, a renamed output column, softmax and argmax."""
    blob, x = resnet
    pair = _pair(blob, mini_batch_size=8, feed_dict={"data": "pixels"},
                 fetch_dict={"logits": "gemm_108"},
                 softmax_output_col="prob", argmax_output_col="label")
    got, want = _score(pair, {"pixels": x})
    assert got.columns == want.columns == ["pixels", "logits", "prob",
                                           "label"]
    _close(got["logits"], want["logits"])
    _close(got["prob"], want["prob"])
    assert got["logits"].dtype == np.float32
    assert got["prob"].dtype == np.float32 and got["label"].dtype == np.int64
    np.testing.assert_array_equal(got["label"],
                                  np.asarray(got["logits"]).argmax(-1))
    np.testing.assert_allclose(np.asarray(got["prob"]).sum(-1), 1.0,
                               rtol=1e-6)


def test_bf16_compute_within_the_bf16_gate(resnet):
    blob, x = resnet
    got, _ = _score(_pair(blob, mini_batch_size=8,
                          compute_dtype="bfloat16"), {"data": x})
    _, want32 = _score(_pair(blob, mini_batch_size=8), {"data": x})
    assert got["gemm_108"].dtype == np.float32
    _close(got["gemm_108"], want32["gemm_108"], bf16=True)


@pytest.mark.parametrize("compute", ["float32", "bfloat16"])
def test_uint8_wire_under_input_norm(resnet, compute):
    """uint8 pixels cross as 1 byte a value and are cast and normalised
    on the device: float32 within the float32 tolerance of the
    reference's uint8 wire, bf16 within the bf16 gate of the reference's
    float32 on host-normalised pixels."""
    blob, _ = resnet
    px = np.random.default_rng(2).integers(0, 256, (19, 3, 32, 32),
                                           dtype=np.uint8)
    pair = _pair(blob, mini_batch_size=8, compute_dtype=compute,
                 input_norm={"data": NORM})
    got, want = _score(pair, {"data": px})
    host = ((px.astype(np.float32) - NORM["mean"].astype(np.float32))
            * NORM["scale"].astype(np.float32))
    _, want_host = _score(_pair(blob, mini_batch_size=8), {"data": host})
    if compute == "float32":
        _close(got["gemm_108"], want["gemm_108"])
    else:
        _close(got["gemm_108"], want_host["gemm_108"], bf16=True)


def test_integer_graph_input_is_coerced_not_cast(encoder):
    """int64 token ids become int32 on the host (the reference's
    coercion) and reach the graph as integers; float32 and bf16 outputs
    against the reference."""
    blob, ids = encoder
    pair = _pair(blob, mini_batch_size=8)
    name = pair[1].graph.input_names[0]
    out = pair[1].graph.output_names[0]
    seen = []
    ex = pair[1]._executor("cpu")
    orig = ex._fn
    ex._fn = lambda *a: (seen.append(a[-1].dtype), orig(*a))[1]
    got, want = _score(pair, {name: ids})
    assert seen and set(seen) == {torch.int32}
    _close(got[out], want[out])
    got16, _ = _score(_pair(blob, mini_batch_size=8,
                            compute_dtype="bfloat16"), {name: ids})
    _close(got16[out], want[out], bf16=True)


def test_torch_exported_fixture(tmp_path):
    io = np.load(os.path.join(FIXTURES, "torch_cnn_io.npz"))
    path = os.path.join(FIXTURES, "torch_cnn.onnx")
    ref, port = JaxONNXModel(model_path=path), ONNXModel(model_path=path)
    assert port.model_payload == ref.model_payload
    name = port.graph.input_names[0]
    out = port.graph.output_names[0]
    got, want = _score((ref, port), {name: io["input"]})
    _close(got[out], want[out])
    _close(got[out], io["expected"])
    meta, ref_meta = port.model_metadata(), ref.model_metadata()
    for k in ("outputs", "n_nodes", "param_bytes", "opset"):
        assert meta[k] == ref_meta[k], k


def test_model_path_with_external_data_inlines_the_sidecar(tmp_path,
                                                           resnet):
    blob, x = resnet
    path = str(tmp_path / "tiny.onnx")
    proto.save_model(proto.load_model(blob), path,
                     external_data_threshold=1024)
    assert os.path.exists(path + ".data")
    ref, port = JaxONNXModel(model_path=path), ONNXModel(model_path=path)
    # self-contained: the payload scores without the sidecar
    os.remove(path + ".data")
    assert port.model_payload == ref.model_payload
    got, want = _score((ref, port), {"data": x[:9]})
    _close(got["gemm_108"], want["gemm_108"])
    base, _ = _score(_pair(blob), {"data": x[:9]})
    _close(got["gemm_108"], base["gemm_108"])


def test_save_load_round_trip_and_copy(tmp_path, resnet):
    blob, x = resnet
    m = ONNXModel(model_bytes=blob, mini_batch_size=8,
                  argmax_output_col="label")
    first = m.transform(Table({"data": x}), "cpu")
    m.save(str(tmp_path / "m"))
    loaded = PipelineStage.load(str(tmp_path / "m"))
    assert isinstance(loaded, ONNXModel)
    again = loaded.transform(Table({"data": x}), "cpu")
    np.testing.assert_array_equal(again["gemm_108"], first["gemm_108"])
    np.testing.assert_array_equal(again["label"], first["label"])
    copied = m.copy(mini_batch_size=16)
    assert copied._executor_cache == {}
    np.testing.assert_allclose(
        copied.transform(Table({"data": x}), "cpu")["gemm_108"],
        first["gemm_108"], rtol=RTOL, atol=ATOL)


def test_a_stage_the_jax_package_saved_loads_and_scores(tmp_path, resnet):
    """A directory the JAX package's ``ONNXModel.save`` wrote: the same
    metadata and pickled payload, loaded by the port into its own class."""
    blob, x = resnet
    ref = JaxONNXModel(model_bytes=blob, mini_batch_size=8,
                       softmax_output_col="prob")
    ref.save(str(tmp_path / "jax_model"))
    port = PipelineStage.load(str(tmp_path / "jax_model"))
    assert type(port) is ONNXModel and port.uid == ref.uid
    assert port.mini_batch_size == 8 and port.model_payload == blob
    want = ref.transform(JaxTable({"data": x}))
    got = port.transform(Table({"data": x}), "cpu")
    _close(got["gemm_108"], want["gemm_108"])
    _close(got["prob"], want["prob"])


def test_transform_stream_equals_transform(resnet):
    blob, x = resnet
    m = ONNXModel(model_bytes=blob, mini_batch_size=8)
    tables = [Table({"data": x[i:i + 7]}) for i in range(0, 35, 7)]
    streamed = list(m.transform_stream(iter(tables), "cpu"))
    assert len(streamed) == len(tables)
    for t, s in zip(tables, streamed):
        np.testing.assert_array_equal(
            s["gemm_108"], m.transform(t, "cpu")["gemm_108"])


@pytest.mark.parametrize("norm, err", [
    ({"nope": {"mean": 0.0}}, KeyError),
    ({"data": {"mean": 0.0, "std": 1.0}}, KeyError),
])
def test_input_norm_errors_are_the_references(resnet, norm, err):
    blob, x = resnet
    ref, port = _pair(blob, input_norm=norm)
    with pytest.raises(err) as want:
        ref.transform(JaxTable({"data": x[:2]}))
    with pytest.raises(err) as got:
        port.transform(Table({"data": x[:2]}), "cpu")
    assert str(got.value) == str(want.value)


def test_input_norm_on_an_integer_input_is_the_references_type_error(
        encoder):
    blob, ids = encoder
    ref, port = _pair(blob)
    name = port.graph.input_names[0]
    ref.set(input_norm={name: {"mean": 1.0}})
    port.set(input_norm={name: {"mean": 1.0}})
    with pytest.raises(TypeError) as want:
        ref.transform(JaxTable({name: ids}))
    with pytest.raises(TypeError) as got:
        port.transform(Table({name: ids}), "cpu")
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("params, item", [
    ({"compute_dtype": "auto"}, "1d"),
    ({"tensor_parallel": 2}, "item 4"),
    ({"partition_rules": "megatron"}, "item 4"),
])
def test_unported_params_raise_naming_their_roadmap_item(
        resnet, params, item, tmp_path, monkeypatch):
    """Item 4's Params raise, naming the item. Item 1d's case is ported:
    ``compute_dtype="auto"`` runs, scoring bitwise as the dtype the
    ``onnx_compute_dtype`` lane resolves it to, and the JAX model's
    columns within that dtype's tolerance."""
    blob, x = resnet
    m = ONNXModel(model_bytes=blob, **params)
    if item != "1d":
        with pytest.raises(NotImplementedError, match=item):
            m.transform(Table({"data": x[:2]}), "cpu")
        return
    from synapseml_tpu_torch.onnx.model import routed_compute_dtype

    monkeypatch.setenv("SYNAPSEML_TPU_CACHE_DIR", str(tmp_path))
    got = m.transform(Table({"data": x[:2]}), "cpu")
    cd = routed_compute_dtype(m.graph, blob, m.mini_batch_size, "cpu")
    assert cd in ("float32", "bfloat16")
    same = ONNXModel(model_bytes=blob, compute_dtype=cd).transform(
        Table({"data": x[:2]}), "cpu")
    want = JaxONNXModel(model_bytes=blob).transform(JaxTable({"data": x[:2]}))
    for col in got.columns:
        assert np.array_equal(got[col], same[col]), col
        if col != "data":
            _close(got[col], want[col], bf16=cd == "bfloat16")


@pytest.mark.parametrize("slots", [2, 3])
def test_devices_runs_the_slots_and_matches_one_slot(resnet, slots):
    """``devices=["cpu"] * n``: 2 slots shard each bucket of 8 rows, 3 run
    every bucket whole round robin (37 rows: 4 buckets and a 5-row tail).
    The columns equal the one-slot model's (bitwise round robin: the same
    program on the same rows) and the JAX model's."""
    blob, x = resnet
    ref, port = _pair(blob, mini_batch_size=8)
    multi = ONNXModel(model_bytes=blob, mini_batch_size=8,
                      devices=["cpu"] * slots)
    one = port.transform(Table({"data": x}), "cpu")
    got = multi.transform(Table({"data": x}), "cpu")
    want = ref.transform(JaxTable({"data": x}))
    ex = multi._executor("cpu")
    assert ex.n_devices == slots
    assert ex._layout(8) == ("shard" if slots == 2 else "rr")
    for col in one.columns:
        if slots == 3:
            np.testing.assert_array_equal(got[col], one[col])
        _close(got[col], one[col])
        if col in want.columns:
            _close(got[col], want[col])
    ex.close()


@pytest.mark.parametrize("spec, err, said", [
    ("all", RuntimeError, "CUDA"),
    (1, ValueError, "devices=1 but 0 CUDA devices"),
    ("everything", ValueError, "not understood"),
])
def test_bad_devices_spec_is_refused(resnet, monkeypatch, spec, err, said):
    """Without CUDA, ``"all"`` raises as every entry point does and an int
    finds no CUDA device; an unknown spec raises as the reference's."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 0)
    blob, x = resnet
    with pytest.raises(err, match=said):
        ONNXModel(model_bytes=blob, devices=spec).transform(
            Table({"data": x[:2]}), "cpu")


def test_transform_defaults_to_cuda_and_raises_without_it(resnet):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    blob, x = resnet
    with pytest.raises(RuntimeError, match="CUDA"):
        ONNXModel(model_bytes=blob).transform(Table({"data": x[:2]}))
    with pytest.raises(RuntimeError, match="CUDA"):
        next(ONNXModel(model_bytes=blob).transform_stream(
            [Table({"data": x[:2]})]))


def test_concurrent_first_transforms_build_one_executor(monkeypatch):
    """Scorer threads sharing one fresh model (a ``DistributedServer``'s
    channels, ``ContinuousServer(scoring_workers > 1)``): their first
    ``transform`` calls, released together, bind the weights once and
    build one executor, and score the same rows alike."""
    import threading

    from synapseml_tpu_torch.onnx.importer import ImportedGraph

    binds = []
    real_bind = ImportedGraph.bind

    def counting_bind(self, *args, **kwargs):
        binds.append(threading.get_ident())
        time.sleep(0.05)  # widen the window a racing build would use
        return real_bind(self, *args, **kwargs)

    monkeypatch.setattr(ImportedGraph, "bind", counting_bind)
    model = ONNXModel(model_bytes=zoo.mlp([6, 16], num_classes=4, seed=5))
    x = np.random.default_rng(0).normal(size=(5, 6)).astype(np.float32)
    barrier = threading.Barrier(4)
    outs, errors = [None] * 4, []

    def first_call(i):
        try:
            barrier.wait(timeout=30)
            out = model.transform(Table({"input": x}), "cpu")
            outs[i] = np.asarray(out[model.graph.output_names[0]])
        except Exception as e:  # noqa: BLE001 - reported below
            errors.append(repr(e))

    threads = [threading.Thread(target=first_call, args=(i,))
               for i in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    try:
        assert not errors and not any(t.is_alive() for t in threads), errors
        assert len(binds) == 1, f"{len(binds)} binds"
        assert len(model._executor_cache) == 1
        for out in outs[1:]:
            np.testing.assert_array_equal(out, outs[0])
    finally:
        for ex in model._executor_cache.values():
            ex.close()

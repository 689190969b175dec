"""The port's ONNX import surface against the JAX package's, on the CPU:
the protobuf codec, ``import_model(optimize=True)``, the registry, the
refusal of unsupported ops at import time, and the device policy of
``bind``/``apply`` (CUDA by default, raising where it is absent).

Tolerances: float32 outputs within rtol=atol=1e-5 of the reference's;
the packed (optimized) transformer within rtol=atol=1e-6 of the
unpacked one in the port, as the reference's own test holds its two.
"""
import os

import numpy as np
import pytest
import torch

from synapseml_tpu.onnx import import_model as jax_import_model
from synapseml_tpu.onnx import proto as jax_proto
from synapseml_tpu.onnx import supported_ops as jax_supported_ops
from synapseml_tpu_torch.onnx import (GraphBuilder, import_model, proto,
                                      supported_ops, zoo)
from torch_onnx_parity import assert_parity, one_node, run_both

FIXTURES = os.path.join(os.path.dirname(__file__), "fixtures")

# the ops of zoo.resnet50 and of the five torch-exported fixtures, plus
# Gelu and Split (the reference's transformer zoo, optimized)
RESNET_AND_FIXTURES = [
    "Conv", "BatchNormalization", "Relu", "MaxPool", "Add",
    "GlobalAveragePool", "Flatten", "Gemm", "AveragePool", "LogSoftmax",
    "Softmax", "Shape", "Constant", "ConstantOfShape", "Gather",
    "Unsqueeze", "Concat", "Transpose", "Reshape", "Sub", "GRU",
    "Identity", "Div", "Cast", "Slice", "Squeeze", "MatMul", "Mod", "Mul",
    "Sqrt", "LayerNormalization", "Gelu", "Split", "QuantizeLinear",
    "DequantizeLinear", "Tile", "Range", "Greater", "Where"]
# the ops a transformer or recurrent export reaches: the elementwise and
# reduction tables, the recurrent ops, the com.microsoft fusion family,
# the LLM weight and position ops and the attention ops
TRANSFORMER_AND_RECURRENT = [
    "Pow", "Equal", "Less", "GreaterOrEqual", "LessOrEqual", "And", "Or",
    "Xor", "Sigmoid", "Tanh", "Exp", "Log", "Reciprocal", "Neg", "Abs",
    "Floor", "Ceil", "Sign", "Erf", "Softplus", "Not", "Sin", "Cos", "Tan",
    "Asin", "Acos", "Atan", "Sinh", "Cosh", "Asinh", "Acosh", "Atanh",
    "Det", "IsNaN", "IsInf", "Softsign", "Round", "BitwiseAnd",
    "BitwiseOr", "BitwiseXor", "BitwiseNot", "Clip", "Min", "Max", "Sum",
    "Mean", "Trilu", "Einsum", "Expand", "CumSum", "ReduceMean",
    "ReduceSum", "ReduceMax", "ReduceMin", "ReduceProd", "ReduceL1",
    "ReduceL2", "ReduceLogSumExp", "ReduceLogSum", "ReduceSumSquare",
    "ArgMax", "ArgMin", "LSTM", "RNN", "FusedMatMul", "BiasGelu",
    "FastGelu", "QuickGelu", "SimplifiedLayerNormalization",
    "RMSNormalization", "SkipSimplifiedLayerNormalization",
    "SkipLayerNormalization", "EmbedLayerNormalization", "MatMulNBits",
    "RotaryEmbedding", "GroupQueryAttention", "MultiHeadAttention",
    "Attention"]
# control flow (the CNTK reader's recurrences arrive as Scan) and the
# activation family (CNTK's Elu among them)
CONTROL_FLOW_AND_ACTIVATIONS = [
    "If", "Loop", "Scan", "LeakyRelu", "PRelu", "Elu", "Selu",
    "HardSigmoid", "HardSwish", "Mish", "Celu", "Affine", "ThresholdedRelu",
    "Shrink", "BitShift"]
# the ai.onnx.ml domain (converted LightGBM and scikit-learn graphs)
ONNX_ML = [
    "TreeEnsembleClassifier", "TreeEnsembleRegressor", "TreeEnsemble",
    "ZipMap", "CastMap", "Scaler", "Normalizer", "LinearClassifier",
    "LinearRegressor", "Imputer", "Binarizer", "ArrayFeatureExtractor",
    "FeatureVectorizer", "LabelEncoder", "CategoryMapper", "OneHotEncoder",
    "SVMClassifier", "SVMRegressor", "DictVectorizer"]
# indexing and the rest, and the two losses (detection and retrieval
# heads, fill-mask top-k, label-carrying exports)
INDEXING_AND_LOSSES = [
    "TopK", "Hardmax", "OneHot", "NonZero", "Unique", "Size", "EyeLike",
    "CastLike", "Compress", "ReverseSequence", "GatherElements", "GatherND",
    "Scatter", "ScatterElements", "ScatterND", "NegativeLogLikelihoodLoss",
    "SoftmaxCrossEntropyLoss"]
# the dense-image ops (segmentation, super-resolution and generative
# decoders)
DENSE_IMAGE = [
    "ConvTranspose", "Resize", "Upsample", "Pad", "DepthToSpace",
    "SpaceToDepth", "GlobalMaxPool", "GlobalLpPool", "LpPool", "MaxUnpool",
    "LRN", "InstanceNormalization", "GroupNormalization",
    "MeanVarianceNormalization", "LpNormalization", "Col2Im",
    "CenterCropPad"]
# the sampling and detection family (Faster R-CNN, SSD, YOLO and DCNv2
# exports, spatial transformers)
DETECTION = [
    "NonMaxSuppression", "RoiAlign", "MaxRoiPool", "DeformConv",
    "GridSample", "AffineGrid", "ImageDecoder"]
# the random family (VAE latent sampling, token sampling heads, exported
# training graphs' Dropout)
RANDOM = [
    "RandomNormal", "RandomNormalLike", "RandomUniform", "RandomUniformLike",
    "Bernoulli", "Multinomial", "Dropout"]
# the sequence, optional and string family (torch list and Optional
# exports, text pipelines' tokenizing and n-gram counting)
SEQUENCE_AND_STRING = [
    "SequenceAt", "SequenceConstruct", "SequenceEmpty", "SequenceErase",
    "SequenceInsert", "SequenceLength", "SplitToSequence",
    "ConcatFromSequence", "SequenceMap", "Optional", "OptionalGetElement",
    "OptionalHasElement", "StringConcat", "StringNormalizer", "StringSplit",
    "RegexFullMatch", "TfIdfVectorizer"]
# the signal family (speech and audio front ends: framing, FFTs, windows
# and the mel filterbank)
SIGNAL = [
    "DFT", "STFT", "HannWindow", "HammingWindow", "BlackmanWindow",
    "MelWeightMatrix"]
# the QLinear and int8 family (the quantized-model compute, over the int8
# lane of onnx/quant_route.py)
QLINEAR = [
    "QLinearConv", "QLinearMatMul", "QGemm", "QLinearAdd", "QLinearMul",
    "QLinearConcat", "QLinearSigmoid", "QLinearLeakyRelu",
    "QLinearGlobalAveragePool", "ConvInteger", "MatMulInteger",
    "DynamicQuantizeLinear"]
PORTED = sorted(RESNET_AND_FIXTURES + TRANSFORMER_AND_RECURRENT
                + CONTROL_FLOW_AND_ACTIVATIONS + ONNX_ML
                + INDEXING_AND_LOSSES + DENSE_IMAGE + DETECTION + RANDOM
                + SEQUENCE_AND_STRING + SIGNAL + QLINEAR)


def test_registry_is_the_ported_op_set():
    assert supported_ops() == PORTED
    assert len(PORTED) == 234 and len(ONNX_ML) == 19
    assert len(SEQUENCE_AND_STRING) == 17 and len(SIGNAL) == 6
    assert len(QLINEAR) == 12
    assert supported_ops() == jax_supported_ops()


@pytest.mark.parametrize("name", ["torch_cnn", "torch_transformer"])
def test_proto_decodes_and_encodes_as_the_reference(name):
    with open(os.path.join(FIXTURES, f"{name}.onnx"), "rb") as fh:
        blob = fh.read()
    mine = proto.load_model(blob)
    theirs = jax_proto.load_model(blob)
    assert mine.producer_name == theirs.producer_name == "pytorch"
    assert proto.encode(mine) == jax_proto.encode(theirs)
    init = mine.graph.initializer[0]
    np.testing.assert_array_equal(
        proto.tensor_to_numpy(init),
        jax_proto.tensor_to_numpy(theirs.graph.initializer[0]))


def test_external_data_resolves_beside_the_model(tmp_path):
    blob = zoo.tiny_resnet(seed=4)
    path = str(tmp_path / "tiny.onnx")
    proto.save_model(proto.load_model(blob), path,
                     external_data_threshold=1024)
    assert len(os.listdir(tmp_path)) > 1            # sidecar files written
    x = np.random.default_rng(0).standard_normal((2, 3, 32, 32)).astype(
        np.float32)
    jg = jax_import_model(path)
    got = import_model(path).bind(device="cpu")(torch.from_numpy(x))
    assert_parity(got, jg.apply(jg.params, x))
    with open(path, "rb") as fh:
        with pytest.raises(ValueError, match="external"):
            import_model(fh.read())


def test_optimize_packs_the_transformer_as_the_reference():
    blob = zoo.transformer_encoder(100, 64, 4, 128, 2, seq_len=16, seed=0)
    plain = import_model(blob)
    packed = import_model(blob, optimize=True)
    ref_packed = jax_import_model(blob, optimize=True)
    assert len(packed._nodes) == len(plain._nodes) - 2
    assert [c.op_type for _, c, _, _ in packed._nodes] == \
        [c.op_type for _, c, _, _ in ref_packed._nodes]
    assert set(packed.params) == set(ref_packed.params)
    ids = np.random.default_rng(0).integers(0, 100, (3, 16))
    a = plain.bind(device="cpu")(torch.from_numpy(ids))[0]
    b = packed.bind(device="cpu")(torch.from_numpy(ids))[0]
    np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-6, atol=1e-6)
    assert_parity(*run_both(blob, [ids], optimize=True))


def test_causal_transformer_needs_an_op_not_ported_yet():
    """The causal encoder needed ``Trilu``, which the port now has: the
    graph imports and its float32 output matches the reference's."""
    blob = zoo.transformer_encoder(50, 32, 4, 64, 1, seq_len=8, causal=True)
    assert "Trilu" in {c.op_type for _, c, _, _ in import_model(blob)._nodes}
    ids = np.random.default_rng(2).integers(0, 50, (2, 8))
    assert_parity(*run_both(blob, [ids]))


def test_unsupported_op_raises_at_import():
    """An op outside the port's registry is refused when the graph is
    imported, with the reference's message; nothing falls back. Every op
    of the reference is in the registry now, so the refused op is one
    neither package has."""
    blob = one_node("NoSuchQuantizeLinear",
                    {"x": np.zeros((1, 8), np.float32)}, n_out=3, opset=17)
    with pytest.raises(NotImplementedError) as want:
        jax_import_model(blob)
    with pytest.raises(NotImplementedError, match="'NoSuchQuantizeLinear'"
                       ".*not supported by the importer") as got:
        import_model(blob)
    assert str(got.value) == str(want.value)
    import_model(one_node("DynamicQuantizeLinear",   # the 12th QLinear op
                          {"x": np.zeros((1, 8), np.float32)}, n_out=3,
                          opset=17))
    g = GraphBuilder(opset=17)
    g.add_input("x", np.float32, [2])
    y = g.add_node("Relu", ["x"])
    z = g.add_node("NoSuchOp", [y])
    g.add_output(z, np.float32, [2])
    with pytest.raises(NotImplementedError, match="'NoSuchOp'"):
        import_model(g.to_bytes())


def test_bind_and_apply_run_on_cuda_by_default():
    """No device argument means the card: where CUDA is absent, both raise
    instead of running on the CPU."""
    g = import_model(zoo.tiny_resnet())
    x = np.zeros((1, 3, 32, 32), np.float32)
    if torch.cuda.is_available():
        out = g.bind()(x)[0]
        assert out.device.type == "cuda"
        return
    with pytest.raises(RuntimeError, match="CUDA"):
        g.bind()
    with pytest.raises(RuntimeError, match="CUDA"):
        g.apply(g.params, x)            # numpy only: nothing names a device
    out = g.bind(device="cpu")(x)[0]    # asked for: the CPU
    assert out.device.type == "cpu"


def test_bind_folds_batch_norm_once_and_casts_the_params(monkeypatch):
    """Each BatchNormalization is folded at bind, none in a forward; the
    bf16 bind's forward is bf16 end to end."""
    from synapseml_tpu_torch.onnx import importer

    folds = []
    real = importer._bn_fold
    monkeypatch.setattr(importer, "_bn_fold",
                        lambda *a: folds.append(1) or real(*a))
    g = import_model(zoo.tiny_resnet())
    n_bn = sum(c.op_type == "BatchNormalization" for _, c, _, _ in g._nodes)
    fn = g.bind(cast_dtype=torch.bfloat16, device="cpu")
    assert len(folds) == n_bn > 0
    out = fn(torch.zeros((2, 3, 32, 32), dtype=torch.bfloat16))[0]
    assert len(folds) == n_bn
    assert out.dtype == torch.bfloat16
    g.apply({k: torch.from_numpy(v) for k, v in g.params.items()},
            torch.zeros((1, 3, 32, 32)))
    assert len(folds) == 2 * n_bn          # apply folds in the call


@pytest.mark.parametrize("cut", [0, 2])
def test_intermediates_are_dropped_after_their_last_consumer(monkeypatch,
                                                              cut):
    """A forward drops each value after the last node that reads it (a
    captured CUDA graph then holds the live peak, not every activation):
    after a run no value a node wrote is left in the environment but the
    graph's outputs, and the outputs, of the whole graph and of one
    truncated to an intermediate, are the reference's within
    rtol=atol=1e-5."""
    from synapseml_tpu_torch.onnx import importer

    envs = []
    real = importer._run_nodes

    def spy(lowered, env, drops):
        real(lowered, env, drops)
        envs.append(set(env))

    monkeypatch.setattr(importer, "_run_nodes", spy)
    blob = zoo.tiny_resnet(seed=2)
    x = np.random.default_rng(2).standard_normal(
        (2, 3, 32, 32)).astype(np.float32)
    g = import_model(blob).truncated(cut)
    ref = jax_import_model(blob).truncated(cut)
    written = {o for *_, outs in g._nodes for o in outs if o}
    got = g.bind(device="cpu")(torch.from_numpy(x))
    assert len(envs) == 1 and envs[0] & written == set(g.output_names)
    assert len(got) == len(ref.output_names) == 1
    want = ref.bind()(x)
    assert_parity(got, want, rtol=1e-5, atol=1e-5)
    applied = g.apply({k: torch.from_numpy(v) for k, v in g.params.items()},
                      torch.from_numpy(x))
    assert envs[-1] & written == set(g.output_names)
    torch.testing.assert_close(applied[0], got[0], rtol=1e-5, atol=1e-5)


def test_float64_input_is_float32_on_the_device():
    """A float64 numpy input reaches the device as float32, as JAX's
    default 32-bit mode makes it."""
    x = np.random.default_rng(1).standard_normal((2, 3, 32, 32))
    blob = zoo.tiny_resnet(seed=1)
    port, ref = run_both(blob, [x], host=True)
    assert port[0].dtype == torch.float32
    assert_parity(port, ref, rtol=1e-4, atol=1e-4)


def test_shape_from_a_device_tensor_raises():
    """A shape must be a host value; a device tensor is refused, as a
    traced value is in the reference."""
    blob = one_node("Reshape", {"x": np.zeros((2, 3), np.float32),
                                "s": np.array([3, 2], np.int64)})
    fn = import_model(blob).bind(device="cpu")
    with pytest.raises(ValueError, match="statically known"):
        fn(torch.zeros(2, 3), torch.tensor([3, 2]))
    out = fn(torch.zeros(2, 3), np.array([3, 2]))[0]
    assert tuple(out.shape) == (3, 2)

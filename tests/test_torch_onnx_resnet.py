"""The imported ResNet family through the port's importer, on the CPU,
against the JAX package's importer on the same ``zoo`` bytes.

Tolerances: float32 logits within rtol=atol=1e-4 of the reference's at
32x32; bf16 logits within 5% of the float32 output's largest magnitude
(the reference's own verify rule for a cast lane,
``synapseml_tpu/onnx/model.py`` ``_dtype_verify``); at 224x224 the
port's float32 forward within rtol=atol=1e-3 of the JAX package's
(``tests/fixtures/resnet50_224_logits.npz``, from
``tests/fixtures/make_resnet50_fixture.py``), the tolerance of the
reference's own 224 test (``tests/test_onnx.py``
``test_resnet50_full_network_parity_vs_torch_224``).
"""
import os
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from synapseml_tpu.onnx import import_model as jax_import_model
from synapseml_tpu.onnx import zoo as jax_zoo
from synapseml_tpu_torch.convert import graph_params_from_arrays
from synapseml_tpu_torch.onnx import import_model, zoo
from torch_onnx_parity import assert_parity, dtype_name, to_numpy, to_torch

FIXTURES = os.path.join(os.path.dirname(__file__), "fixtures")
sys.path.insert(0, FIXTURES)
import make_resnet50_fixture  # noqa: E402


def within_bf16_rule(got: np.ndarray, want: np.ndarray) -> bool:
    span = max(1e-6, float(np.abs(want.astype(np.float64)).max()))
    return float(np.abs(got.astype(np.float64) - want).max()) <= 0.05 * span


def _images(seed, n, size):
    return np.random.default_rng(seed).standard_normal(
        (n, 3, size, size)).astype(np.float32)


def test_resnet50_32px_float32_and_bf16_against_jax():
    blob = zoo.resnet50(num_classes=1000, image_size=32)
    g, jg = import_model(blob), jax_import_model(blob)
    x = _images(0, 2, 32)
    ref32 = jg.apply(jg.params, x)
    port32 = g.bind(device="cpu")(torch.from_numpy(x))
    assert_parity(port32, ref32, rtol=1e-4, atol=1e-4)
    xb = x.astype(jnp.bfloat16)
    ref16 = jg.bind(cast_dtype=jnp.bfloat16)(jnp.asarray(xb))
    port16 = g.bind(cast_dtype=torch.bfloat16, device="cpu")(to_torch(xb))
    assert dtype_name(port16[0]) == dtype_name(ref16[0]) == "bfloat16"
    want = to_numpy(ref32[0])
    assert within_bf16_rule(to_numpy(port16[0]), want)
    assert within_bf16_rule(to_numpy(ref16[0]), want)


@pytest.mark.parametrize("build", ["resnet18", "tiny_resnet"])
def test_resnet18_and_tiny_resnet_against_jax(build):
    blob = getattr(zoo, build)(num_classes=10, image_size=32, seed=2)
    g, jg = import_model(blob), jax_import_model(blob)
    x = _images(1, 3, 32)
    assert_parity(g.bind(device="cpu")(torch.from_numpy(x)),
                  jg.apply(jg.params, x), rtol=1e-4, atol=1e-4)


def test_resnet50_224_against_the_jax_fixture():
    """Row 0 of ``entry()``'s images, float32 and bf16 binds."""
    fx = np.load(os.path.join(FIXTURES, "resnet50_224_logits.npz"))
    g = import_model(zoo.resnet50(num_classes=1000))
    x = make_resnet50_fixture.images(1)
    got = g.bind(device="cpu")(torch.from_numpy(x))[0]
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), fx["logits_f32"][:1],
                               rtol=1e-3, atol=1e-3)
    got16 = g.bind(cast_dtype=torch.bfloat16, device="cpu")(
        torch.from_numpy(x).to(torch.bfloat16))[0]
    assert got16.dtype == torch.bfloat16
    assert within_bf16_rule(got16.float().numpy(), fx["logits_f32"][:1])


def test_graph_split_bytes_and_truncation_are_the_references():
    blob = zoo.resnet18(num_classes=10, image_size=32, seed=3)
    g, jg = import_model(blob), jax_import_model(blob)
    assert set(g.params) == set(jg.params)
    assert set(g.static_params) == set(jg.static_params)
    assert g.param_bytes() == jg.param_bytes()
    assert g.input_names == jg.input_names
    assert g.output_names == jg.output_names
    assert repr(g) == repr(jg)
    x = _images(4, 2, 32)
    for cut in (0, 1, 3):
        t, jt = g.truncated(cut), jg.truncated(cut)
        assert t.output_names == jt.output_names
        assert set(t.params) == set(jt.params)
        assert set(t.static_params) == set(jt.static_params)
        assert t.param_bytes() == jt.param_bytes()
        assert_parity(t.bind(device="cpu")(torch.from_numpy(x)),
                      jt.apply(jt.params, x), rtol=1e-4, atol=1e-4)
    with pytest.raises(ValueError, match="out of range"):
        g.truncated(len(g._nodes))


def test_graph_params_from_arrays_carries_the_jax_params():
    blob = zoo.tiny_resnet(seed=5)
    g, jg = import_model(blob), jax_import_model(blob)
    params = graph_params_from_arrays(g, jg.params, device="cpu")
    assert set(params) == set(g.params)
    assert all(isinstance(v, torch.Tensor) for v in params.values())
    x = _images(5, 2, 32)
    assert_parity(g.apply(params, torch.from_numpy(x)),
                  jg.apply(jg.params, x), rtol=1e-4, atol=1e-4)
    name = next(iter(jg.params))
    with pytest.raises(ValueError, match="missing"):
        graph_params_from_arrays(
            g, {k: v for k, v in jg.params.items() if k != name},
            device="cpu")
    bad = dict(jg.params)
    bad[name] = np.zeros((1,) + jg.params[name].shape, np.float32)
    with pytest.raises(ValueError, match=name):
        graph_params_from_arrays(g, bad, device="cpu")
    bad[name] = jg.params[name].astype(np.float64)
    with pytest.raises(ValueError, match="float64"):
        graph_params_from_arrays(g, bad, device="cpu")


def test_zoo_emits_the_references_bytes():
    assert zoo.resnet50() == jax_zoo.resnet50()
    for build, kw in (("resnet18", dict(num_classes=7, image_size=64,
                                        seed=1)),
                      ("tiny_resnet", dict(seed=3)),
                      ("mlp", dict(layer_sizes=[8, 16], num_classes=3)),
                      ("transformer_encoder", dict(
                          vocab=50, d_model=32, n_heads=4, ffn_dim=64,
                          n_layers=2, seq_len=8, causal=True)),
                      ("bilstm_tagger", dict(vocab=20, embed=8, hidden=6,
                                             n_tags=4)),
                      ("tiny_decoder", {})):
        assert getattr(zoo, build)(**kw) == getattr(jax_zoo, build)(**kw), \
            build

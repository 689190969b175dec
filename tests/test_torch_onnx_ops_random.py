"""The port's ONNX random ops against the JAX package's importer, on the
CPU: ``RandomNormal``, ``RandomNormalLike``, ``RandomUniform``,
``RandomUniformLike``, ``Bernoulli``, ``Multinomial`` and ``Dropout``.

The one-node cases are ``tests/fixtures/random_op_cases.py``'s (the card
runs the same ones in ``chip_smoke.py`` and ``test_torch_cuda.py``): the
same graph bytes and seeded inputs through both importers, the port bound
on the CPU, the reference through its eager bound forward. Gates: uniform,
Bernoulli and Dropout draws and the per-node keys bitwise; the normal
draws within 1e-6 (absolute and relative), their bitwise share reported
and bounded below; Multinomial ids equal but at counted near-ties. The
draws themselves (``synapseml_tpu_torch/onnx/random.py``) are held to
``jax.random`` directly, and the normal's ``erf_inv`` to XLA's.

Then the places where the port copies the reference and not the ONNX
spec (ROADMAP Queue 3), each held on its own; batch-prefix consistency in
both packages; and Stable Diffusion v1's VAE encoder
(``tests/fixtures/vae_encoder.py``), which samples its latent with
``RandomNormalLike``, at a small width end to end and at full width
against the JAX fixture.
"""
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from synapseml_tpu.onnx import GraphBuilder as JaxBuilder
from synapseml_tpu.onnx import import_model as jax_import
from synapseml_tpu.onnx import importer as jax_importer
from synapseml_tpu_torch.gbdt import prng
from synapseml_tpu_torch.onnx import GraphBuilder, import_model, importer
from synapseml_tpu_torch.onnx import random as draws

FIXTURES = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "fixtures")
sys.path.insert(0, FIXTURES)
import random_op_cases as cases  # noqa: E402
import vae_encoder  # noqa: E402

NAMES = ("RandomNormal", "RandomNormalLike", "RandomUniform",
         "RandomUniformLike", "Bernoulli", "Multinomial", "Dropout")
NORMAL_BITWISE_FLOOR = 0.97   # normal draws equal bit for bit to the reference
ENCODER_TOL = 1e-4            # the encoder against JAX, of each output's largest |value|
N_DRAWS = 1 << 16


def _key(seed):
    return prng.prng_key(seed, "cpu")


def _jax_gumbel(seed, shape, dtype):
    return np.asarray(jax.random.gumbel(jax.random.PRNGKey(seed), shape,
                                        dtype=getattr(jnp, dtype)))


def _port(case):
    return cases.run(case, import_model, GraphBuilder, "cpu")


def _reference(case):
    """The JAX importer's outputs of the case, as :func:`cases.run` gives
    the port's."""
    fn = jax_import(cases.graph(case, JaxBuilder)).bind()
    out = fn(*[jnp.asarray(a) for a in cases.feeds(case)])
    return [(cases.as_numpy(v), isinstance(v, (np.ndarray, np.generic)))
            for v in out]


def _bits(a):
    return a.view(f"u{a.itemsize}") if a.dtype.kind == "f" else a


def test_every_name_is_registered_and_covered():
    assert set(NAMES) <= set(importer._REGISTRY)
    assert {c["op"] for c in cases.CASES} == set(NAMES)
    names = [c["name"] for c in cases.CASES]
    assert len(names) == len(set(names)) and len(names) >= 45


def test_both_graph_builders_give_the_same_bytes():
    for case in cases.CASES:
        assert cases.graph(case, GraphBuilder) == \
            cases.graph(case, JaxBuilder), case["name"]


@pytest.mark.parametrize("case", cases.CASES, ids=lambda c: c["name"])
def test_op_matches_the_reference(case):
    got = cases.agree(case, _port(case), _reference(case),
                      cases.ties_for(case, _jax_gumbel))
    assert got["ok"], got
    if case["kind"] == "normal":
        assert got["bitwise_share"] >= NORMAL_BITWISE_FLOOR, got
    if case["kind"] == "ids":
        assert got["differing"] == 0, got


# -- the per-node key ------------------------------------------------------

@pytest.mark.parametrize("seed,name,want", [
    (3.0, "n", 3), (-7.0, "n", 2_147_483_641), (-1.5, "n", 3_217_031_168),
    (3.0e9, "n", 3_000_000_000 & 0x7FFFFFFF), (0.25, "n", 0x3E800000),
    (None, "vae.encoder.sample", None), (None, "y0", None)],
    ids=["integral", "negative", "non_integral", "large", "fraction",
         "unseeded_named", "unseeded_unnamed"])
def test_node_key_is_the_references(seed, name, want):
    attrs = {} if seed is None else {"seed": seed}
    ctx = importer.OpContext(dict(attrs), 17, name, "RandomNormal", 1)
    ref = np.asarray(jax.random.key_data(jax_importer._node_key(
        jax_importer.OpContext(dict(attrs), 17, name, "RandomNormal", 1))))
    got = importer._node_key(ctx, torch.device("cpu")).numpy()
    np.testing.assert_array_equal(got, ref.astype(np.int64))
    if want is not None:
        assert importer._node_seed(ctx) == want


def test_unnamed_nodes_draw_apart_and_repeat_across_calls():
    """Two unnamed RandomNormal nodes draw differently (their outputs'
    names key them), and a bound graph draws the same numbers at every
    call, in both packages."""
    def build(builder):
        g = builder(opset=17)
        for out in ("a", "b"):
            g.add_node("RandomNormal", [], outputs=[out], shape=[300])
            g._nodes[-1].name = ""
            g.add_output(out, np.float32, None)
        return g.to_bytes()

    blob = build(GraphBuilder)
    assert blob == build(JaxBuilder)
    fn = import_model(blob).bind(device="cpu")
    a, b = (t.numpy() for t in fn())
    assert not np.allclose(a, b)
    again = [t.numpy() for t in fn()]
    np.testing.assert_array_equal(_bits(again[0]), _bits(a))
    np.testing.assert_array_equal(_bits(again[1]), _bits(b))
    ref = [np.asarray(v) for v in jax_import(blob).bind()()]
    np.testing.assert_allclose(a, ref[0], rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(b, ref[1], rtol=1e-6, atol=1e-6)


def test_a_bound_forward_copies_no_key_after_its_first_run(monkeypatch):
    """The node's key is copied to the device once: a second run of a
    bound graph makes no tensor from a host array, so a capture copies
    nothing."""
    runs = []
    for name in ("normal_like_unseeded_latent", "uniform_like",
                 "bernoulli_f32", "multinomial_gpt2_head", "normal_seed_3"):
        case = cases.by_name(name)
        fn = import_model(cases.graph(case, GraphBuilder)).bind(device="cpu")
        args = [torch.from_numpy(a) for a in cases.feeds(case)]
        runs.append((fn, args, fn(*args)))
    made = []
    real = importer._tensor

    def counting(x, dev=None):
        if not isinstance(x, torch.Tensor) and np.ndim(x) > 0:
            made.append(np.shape(x))
        return real(x, dev)

    monkeypatch.setattr(importer, "_tensor", counting)
    for fn, args, first in runs:
        for a, b in zip(first, fn(*args)):
            assert torch.equal(a, b)
    assert made == []


# -- the draws against jax.random ------------------------------------------

@pytest.mark.parametrize("lo,hi", [
    (0.0, 1.0), (0.1, 0.7), (-3.0, 5.5), (1000.0, 1000.5), (1e-30, 1.0),
    (-0.25, 0.75), (-1.0, 1.0), (float(np.nextafter(np.float32(-1.0),
                                                    np.float32(0.0))), 1.0),
    (0.5, 0.5), (2.0, -1.0)])
def test_uniform_is_jax_random_uniform_bitwise(lo, hi):
    want = np.asarray(jax.random.uniform(
        jax.random.PRNGKey(5), (N_DRAWS,), minval=lo, maxval=hi))
    got = draws.uniform(_key(5), (N_DRAWS,), lo, hi)
    np.testing.assert_array_equal(got.numpy().view(np.uint32),
                                  want.view(np.uint32))


@pytest.mark.parametrize("dtype", ["float32", "float16", "bfloat16"])
def test_unit_floats_are_jax_random_uniform_bitwise(dtype):
    """``prng.unit``, the floats in [0, 1) under every draw, in each
    format the reference draws: float32 from 32-bit words, float16 from 16
    bits, bfloat16 from 8."""
    want = np.asarray(jax.random.uniform(
        jax.random.PRNGKey(5), (64, N_DRAWS // 64),
        dtype=getattr(jnp, dtype)))
    got = prng.unit(_key(5), (64, N_DRAWS // 64), getattr(torch, dtype))
    assert got.shape == want.shape
    np.testing.assert_array_equal(
        got.view(torch.int16 if got.itemsize == 2 else torch.int32).numpy(),
        want.view(np.int16 if want.itemsize == 2 else np.int32))


def test_uniform_scales_in_one_fused_multiply_add():
    """``floats * (hi - lo) + lo`` rounded twice misses the reference on
    0.1 / 0.7, which XLA contracts into one FMA; :func:`draws.fma` does
    not."""
    want = np.asarray(jax.random.uniform(jax.random.PRNGKey(1), (N_DRAWS,),
                                         minval=0.1, maxval=0.7))
    floats = draws.uniform(_key(1), (N_DRAWS,))
    span = np.float32(0.7) - np.float32(0.1)
    unfused = (floats * float(span) + float(np.float32(0.1))).numpy()
    assert (unfused.view(np.uint32) != want.view(np.uint32)).mean() > 0.05
    got = draws.uniform(_key(1), (N_DRAWS,), 0.1, 0.7)
    np.testing.assert_array_equal(got.numpy().view(np.uint32),
                                  want.view(np.uint32))


def test_fma_rounds_once():
    """Each result is the float32 nearest ``a * b + c`` computed exactly
    (ties to even), including where a float64 sum rounded first lands on
    a float32 halfway point and breaks the tie the wrong way."""
    from fractions import Fraction

    rng = np.random.default_rng(0)
    a, b = (rng.standard_normal(2000).astype(np.float32) for _ in range(2))
    c = (rng.standard_normal(2000) * 1e-9).astype(np.float32)
    got = draws.fma(*(torch.from_numpy(v) for v in (a, b, c))).numpy()
    for x, y, z, r in zip(a, b, c, got):
        exact = Fraction(float(x)) * Fraction(float(y)) + Fraction(float(z))
        err = abs(exact - Fraction(float(r)))
        for side in (np.inf, -np.inf):
            other = Fraction(float(np.nextafter(r, np.float32(side))))
            assert err < abs(exact - other) or (
                err == abs(exact - other)
                and int(r.view(np.uint32)) % 2 == 0)
    # 8 (1 + 2^-23) * 8 (1 - 2^-23) + (2^30 + 2^7) lies just under the
    # halfway point 2^30 + 2^7 + 2^6: rounded once it goes down; a float64
    # sum rounds onto the halfway point, and ties-to-even goes up
    x = torch.tensor([8 * (1 + 2.0 ** -23)])
    y = torch.tensor([8 * (1 - 2.0 ** -23)])
    z = torch.tensor([2.0 ** 30 + 2.0 ** 7])
    assert draws.fma(x, y, z).item() == 2.0 ** 30 + 2.0 ** 7
    assert (x.double() * y.double() + z.double()).float().item() == \
        2.0 ** 30 + 2.0 ** 8


@pytest.mark.parametrize("dtype", ["float16", "bfloat16"])
def test_gumbel_is_jax_random_gumbel_bitwise_in_16_bits(dtype):
    want = _jax_gumbel(9, (N_DRAWS,), dtype)
    got = draws.gumbel(_key(9), (N_DRAWS,), getattr(torch, dtype))
    np.testing.assert_array_equal(got.view(torch.int16).numpy(),
                                  want.view(np.int16))


def test_gumbel_float32_is_within_an_ulp_of_jax():
    """float32 logs differ between XLA:CPU and torch in the last bit, so
    the float32 noise is held within 1e-6 and Multinomial's ids are held
    equal in :func:`test_op_matches_the_reference`."""
    want = _jax_gumbel(9, (N_DRAWS,), "float32")
    got = draws.gumbel(_key(9), (N_DRAWS,)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


def test_normal_is_jax_random_normal_within_1e6():
    want = np.asarray(jax.random.normal(jax.random.PRNGKey(7), (N_DRAWS,)))
    got = draws.normal(_key(7), (N_DRAWS,)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    assert (got.view(np.uint32) == want.view(np.uint32)).mean() >= \
        NORMAL_BITWISE_FLOOR


def test_erf_inv_is_xlas_polynomial_not_torch_erfinv():
    """On the normal's own uniforms the port's ``erf_inv`` is within an
    ulp of XLA's and bitwise on almost every draw; ``torch.erfinv``
    misses it by orders of magnitude more."""
    lo = float(np.nextafter(np.float32(-1.0), np.float32(0.0)))
    u = draws.uniform(_key(3), (N_DRAWS,), lo, 1.0)
    want = np.asarray(jax.lax.erf_inv(jnp.asarray(u.numpy())))
    got = draws.erf_inv(u).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    assert (got.view(np.uint32) == want.view(np.uint32)).mean() >= 0.97
    theirs = torch.erfinv(u).numpy()
    assert np.abs(theirs - want).max() > 10 * np.abs(got - want).max()
    edges = torch.tensor([-1.0, 1.0, 0.0])
    assert draws.erf_inv(edges).tolist() == [-np.inf, np.inf, 0.0]


@pytest.mark.parametrize("op,attrs", [
    ("RandomNormalLike", {}), ("RandomUniformLike", {"low": 0.1,
                                                     "high": 0.7})])
def test_draws_are_a_prefix_along_the_batch_in_both_packages(op, attrs):
    """3 rows draw what the first 3 of 4 rows draw, in the port and in
    the reference (partitionable threefry): a padded bucket does not move
    the real rows' noise."""
    def run(n, package):
        builder, load = ((GraphBuilder, import_model) if package == "port"
                         else (JaxBuilder, jax_import))
        g = builder(opset=17)
        g.add_input("x", np.float32, [n, 4, 8, 8])
        g.add_node(op, ["x"], outputs=["y"], name="sample.eps", **attrs)
        g.add_output("y", np.float32, None)
        x = np.zeros((n, 4, 8, 8), np.float32)
        if package == "port":
            return load(g.to_bytes()).bind(device="cpu")(
                torch.from_numpy(x))[0].numpy()
        return np.asarray(load(g.to_bytes()).bind()(jnp.asarray(x))[0])

    for package in ("port", "reference"):
        three, four = run(3, package), run(4, package)
        np.testing.assert_array_equal(_bits(three), _bits(four[:3]))


# -- the reference's own behaviour where the spec says otherwise
# (ROADMAP Queue 3): each held here on its own ---------------------------

def test_dropout_ignores_training_mode():
    """``training_mode`` True with ratio 0.5: the spec drops and scales;
    the reference, and so the port, pass the input through with an
    all-true mask."""
    case = cases.by_name("dropout_training_mode_ignored")
    x = cases.feeds(case)[0]
    for out in (_port(case), _reference(case)):
        np.testing.assert_array_equal(out[0][0], x)
        assert out[1][0].dtype == np.bool_ and out[1][0].all()


@pytest.mark.parametrize("name,port_dtype,ref_dtype", [
    ("normal_double_is_float32_values", "float64", "float32"),
    ("uniform_double_is_float32_values", "float64", "float32"),
    ("multinomial_int64_is_int32_values", "int64", "int32")])
def test_64_bit_dtypes_keep_the_spec_type_with_the_references_values(
        name, port_dtype, ref_dtype):
    """With JAX's 64-bit mode off the reference gives float32 for
    ``dtype`` 11 and int32 for Multinomial's 7; the port keeps the spec's
    type and holds the reference's values (float32 draws widened)."""
    case = cases.by_name(name)
    (got, _), = _port(case)
    (want, _), = _reference(case)
    assert got.dtype.name == port_dtype and want.dtype.name == ref_dtype
    np.testing.assert_array_equal(got.astype(want.dtype).astype(got.dtype),
                                  got)
    tol = cases.NORMAL_TOL if case["kind"] == "normal" else 0.0
    np.testing.assert_allclose(got.astype(want.dtype), want, rtol=tol,
                               atol=tol)


def test_unseeded_draws_repeat_across_calls():
    """The spec generates a seed where none is given; the reference keys
    the node by its name instead, so every call of a bound graph draws the
    same numbers, and the port does the same."""
    case = cases.by_name("normal_like_unseeded_latent")
    fn = import_model(cases.graph(case, GraphBuilder)).bind(device="cpu")
    x = torch.from_numpy(cases.feeds(case)[0])
    first, second = fn(x)[0].numpy(), fn(x)[0].numpy()
    np.testing.assert_array_equal(_bits(first), _bits(second))
    ref = jax_import(cases.graph(case, JaxBuilder)).bind()
    a = np.asarray(ref(jnp.asarray(x.numpy()))[0])
    np.testing.assert_array_equal(_bits(a), _bits(np.asarray(
        ref(jnp.asarray(x.numpy()))[0])))


# -- Stable Diffusion v1's VAE encoder -----------------------------------

def test_vae_encoder_matches_the_reference_at_small_width():
    cfg = vae_encoder.SMALL
    blob = vae_encoder.encoder_graph(GraphBuilder, cfg)
    assert blob == vae_encoder.encoder_graph(JaxBuilder, cfg)
    graph = import_model(blob)
    assert sum(v.size for v in graph.params.values()) == \
        vae_encoder.parameters(cfg) + 5     # + the five scalars
    x = vae_encoder.images(2, 32)
    port = dict(zip(vae_encoder.OUTPUTS, (
        t.numpy() for t in graph.bind(device="cpu")(torch.from_numpy(x)))))
    ref = dict(zip(vae_encoder.OUTPUTS, (
        np.asarray(v) for v in jax_import(blob).bind()(jnp.asarray(x)))))
    for k in ("mean", "logvar", "latent"):
        span = float(np.abs(ref[k]).max())
        np.testing.assert_allclose(port[k], ref[k], rtol=0,
                                   atol=ENCODER_TOL * span, err_msg=k)
    np.testing.assert_allclose(port["eps"], ref["eps"], rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(
        port["latent"], (port["mean"] + np.exp(0.5 * port["logvar"])
                         * port["eps"]) * np.float32(0.18215),
        rtol=1e-5, atol=1e-6)


def test_full_width_vae_encoder_matches_the_jax_fixture():
    """The port at Stable Diffusion v1's width (34.2 M parameters, seed 0)
    on the fixture's two 256 x 256 images: ``mean``, ``logvar`` and the
    latent within 1e-4 of each one's largest |value|, the draw within
    1e-6."""
    fx = np.load(vae_encoder.OUT)
    n, size = vae_encoder.FIXTURE_IMAGES, vae_encoder.FIXTURE_SIZE
    assert int(fx["weight_seed"]) == vae_encoder.WEIGHT_SEED
    assert int(fx["image_seed"]) == vae_encoder.IMAGE_SEED
    assert vae_encoder.parameters() == 34_163_664     # the published 34.2 M
    work = vae_encoder.flops(vae_encoder.FULL, 1, vae_encoder.PUBLISHED_SIZE)
    assert abs(work["total"] - 1.117e12) < 1e9 and \
        work["conv"] / work["total"] > 0.96
    fn = import_model(vae_encoder.encoder_graph(GraphBuilder)).bind(
        device="cpu")
    got = dict(zip(vae_encoder.OUTPUTS, (
        t.numpy() for t in fn(torch.from_numpy(vae_encoder.images(n, size))))))
    for k in vae_encoder.OUTPUTS:
        assert got[k].shape == fx[k].shape == (n, 4, size // 8, size // 8)
    for k in ("mean", "logvar", "latent"):
        np.testing.assert_allclose(got[k], fx[k], rtol=0, atol=ENCODER_TOL
                                   * float(fx[f"span_{k}"]), err_msg=k)
    np.testing.assert_allclose(got["eps"], fx["eps"], rtol=1e-6, atol=1e-6)

"""One-node graphs of the ONNX random ops (``RandomNormal``,
``RandomNormalLike``, ``RandomUniform``, ``RandomUniformLike``,
``Bernoulli``, ``Multinomial``, ``Dropout``), with their seeded inputs.

``tests/test_torch_onnx_ops_random.py`` runs each case through the JAX
package's importer and the port's on the CPU; ``chip_smoke.py`` and
``tests/test_torch_cuda.py`` run the port on the card against the port on
the CPU (:func:`run`, :func:`agree`). The cases hold the reference's own
choices: the per-node key (integral, negative, non-integral and very
large ``seed`` attributes; no seed on a named and on an unnamed node),
``uniform``'s fused multiply-add (bounds where an unfused form differs,
such as 0.1 / 0.7), the normal's unfused ``* scale + mean``, the dtypes
(float16, bfloat16, the 64-bit types the reference narrows), Bernoulli's
edges (0, 1, NaN, outside [0, 1]), a GPT-2-vocabulary sampling head for
Multinomial in float32 and float16, and Dropout's pass-through whatever
``training_mode`` says.

A case is a dict: ``op``, ``inputs`` (``[(name, array, where)]``,
``where`` one of ``"feed"``, ``"init"``, ``"const"``), ``attrs``,
``n_out``, ``node_name`` (None: the GraphBuilder's; ``""``: none, so the
output's name keys an unseeded draw) and ``kind``: ``"exact"`` (bitwise),
``"normal"`` (within :data:`NORMAL_TOL`, absolute and relative) or
``"ids"`` (Multinomial: equal ids but at counted near-ties,
:func:`near_ties`); ``exact`` and ``raises`` (None: no case raises) as
the other case modules name them, for ``chip_smoke.py``'s
``cases_on_card``.

This module imports neither package at import time: :func:`graph` takes
either package's ``GraphBuilder``, :func:`run` the port's
``import_model``; :func:`agree` draws the port's Gumbel noise on the CPU
for Multinomial's near-ties when it is given none.
"""
import numpy as np

F32, F16, I32, I64 = np.float32, np.float16, np.int32, np.int64
NORMAL_TOL = 1e-6     # normal draws: atol = rtol, against the reference and card vs CPU
NEAR_TIE = 1e-6       # Multinomial: a top-2 gap of logits + noise under this share
                      # of the largest |value| (float16: its resolution, 2^-10)
GPT2_VOCAB = 50257
GPT2_BATCH = 8
OPSET = 17


def _case(name, op, inputs=(), kind="exact", node_name=None, n_out=1,
          **attrs):
    return dict(name=name, op=op, inputs=list(inputs), kind=kind,
                exact=kind == "exact", raises=None, node_name=node_name,
                n_out=n_out, attrs=attrs)


def _x(seed, *shape, dtype=F32, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape)
            * scale).astype(dtype)


def _p(seed, *shape, dtype=F32):
    return np.random.default_rng(seed).uniform(0, 1, shape).astype(dtype)


def gpt2_logits(seed: int, dtype=F32) -> np.ndarray:
    """``[8, 50257]`` logits shaped like a GPT-2 head's: a spread of about
    3 with a few tokens well ahead."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((GPT2_BATCH, GPT2_VOCAB)) * 3.0
    top = rng.integers(0, GPT2_VOCAB, (GPT2_BATCH, 4))
    np.put_along_axis(x, top, np.take_along_axis(x, top, 1) + 8.0, 1)
    return x.astype(dtype)


_EDGES = np.tile(np.array([0.0, 1.0, np.nan, -0.5, 1.5, 1e-8, 0.99999994,
                           0.5], F32), (8, 2))
_MASKED = _x(60, 3, 5)
_MASKED[0, [1, 3]] = -np.inf
_MASKED[2, :4] = -np.inf

NORMAL_CASES = [
    _case("normal_seed_3", "RandomNormal", kind="normal", shape=[4, 1000],
          seed=3.0),
    _case("normal_seed_negative", "RandomNormal", kind="normal",
          shape=[257], seed=-7.0),
    _case("normal_seed_fraction", "RandomNormal", kind="normal",
          shape=[3, 5, 7], seed=-1.5),
    _case("normal_seed_large", "RandomNormal", kind="normal", shape=[64],
          seed=3.0e9),
    _case("normal_mean_scale_unfused", "RandomNormal", kind="normal",
          shape=[8, 512], seed=11.0, mean=0.7, scale=2.3),
    _case("normal_float16", "RandomNormal", kind="normal", shape=[1024],
          seed=5.0, dtype=10),
    _case("normal_bfloat16", "RandomNormal", kind="normal", shape=[1024],
          seed=5.0, dtype=16),
    _case("normal_double_is_float32_values", "RandomNormal", kind="normal",
          shape=[100], seed=2.0, dtype=11),
    _case("normal_unseeded_named", "RandomNormal", kind="normal",
          node_name="vae.encoder.sample", shape=[2, 4, 8, 8]),
    _case("normal_unseeded_unnamed", "RandomNormal", kind="normal",
          node_name="", shape=[500]),
    _case("normal_empty", "RandomNormal", kind="normal", shape=[2, 0],
          seed=1.0),
    _case("normal_scalar", "RandomNormal", kind="normal", shape=[],
          seed=1.0),
    _case("normal_like_seeded", "RandomNormalLike",
          [("x", _x(1, 2, 4, 16, 16), "feed")], kind="normal", seed=9.0),
    _case("normal_like_float16_input", "RandomNormalLike",
          [("x", _x(2, 4, 300, dtype=F16), "feed")], kind="normal",
          seed=8.0),
    _case("normal_like_dtype_attr", "RandomNormalLike",
          [("x", _x(3, 3, 33), "feed")], kind="normal", seed=7.0, dtype=10),
    _case("normal_like_unseeded_latent", "RandomNormalLike",
          [("x", _x(4, 2, 4, 8, 8), "feed")], kind="normal",
          node_name="sample.eps"),
    _case("normal_like_host_input", "RandomNormalLike",
          [("x", _x(5, 5, 6), "const")], kind="normal", seed=6.0),
    _case("normal_like_int32_input", "RandomNormalLike",
          [("x", np.arange(63, dtype=I32).reshape(7, 9), "feed")],
          seed=4.0, mean=10.0, scale=20.0),
    _case("normal_like_mean_scale_unfused", "RandomNormalLike",
          [("x", _x(6, 4096), "feed")], kind="normal", seed=21.0,
          mean=-0.3, scale=1.7),
]

UNIFORM_CASES = [
    _case("uniform_default", "RandomUniform", shape=[1000], seed=0.0),
    _case("uniform_0.1_0.7_fused", "RandomUniform", shape=[64, 64],
          seed=1.0, low=0.1, high=0.7),
    _case("uniform_-3_5.5", "RandomUniform", shape=[4096], seed=2.0,
          low=-3.0, high=5.5),
    _case("uniform_1000_1000.5", "RandomUniform", shape=[2048], seed=3.0,
          low=1000.0, high=1000.5),
    _case("uniform_tiny_low", "RandomUniform", shape=[2048], seed=4.0,
          low=1e-30, high=1.0),
    _case("uniform_degenerate", "RandomUniform", shape=[16], seed=5.0,
          low=0.5, high=0.5),
    _case("uniform_low_above_high", "RandomUniform", shape=[16], seed=6.0,
          low=2.0, high=-1.0),
    _case("uniform_float16", "RandomUniform", shape=[1024], seed=7.0,
          low=-1.0, high=1.0, dtype=10),
    _case("uniform_double_is_float32_values", "RandomUniform", shape=[300],
          seed=8.0, low=0.1, high=0.7, dtype=11),
    _case("uniform_unseeded_unnamed", "RandomUniform", node_name="",
          shape=[3, 7]),
    _case("uniform_like", "RandomUniformLike",
          [("x", _x(10, 3, 50), "feed")], seed=7.0, low=-2.0, high=2.0),
    _case("uniform_like_float16_input", "RandomUniformLike",
          [("x", _x(11, 256, dtype=F16), "feed")], seed=12.0, low=0.1,
          high=0.7),
    _case("uniform_like_bfloat16_dtype", "RandomUniformLike",
          [("x", _x(12, 128), "feed")], seed=13.0, low=0.1, high=0.7,
          dtype=16),
    _case("uniform_like_unseeded_named", "RandomUniformLike",
          [("x", _x(13, 6, 9), "feed")], node_name="noise.uniform"),
]

BERNOULLI_CASES = [
    _case("bernoulli_f32", "Bernoulli", [("p", _p(20, 64, 128), "feed")],
          seed=1.0),
    _case("bernoulli_f16", "Bernoulli",
          [("p", _p(21, 32, 32, dtype=F16), "feed")], seed=2.0),
    _case("bernoulli_bool_out", "Bernoulli", [("p", _p(22, 100), "feed")],
          seed=3.0, dtype=9),
    _case("bernoulli_int32_out", "Bernoulli", [("p", _p(23, 100), "feed")],
          seed=4.0, dtype=6),
    _case("bernoulli_edges", "Bernoulli", [("p", _EDGES, "feed")],
          seed=5.0),
    _case("bernoulli_unseeded", "Bernoulli", [("p", _p(24, 40), "feed")]),
]

MULTINOMIAL_CASES = [
    _case("multinomial_gpt2_head", "Multinomial",
          [("logits", gpt2_logits(30), "feed")], kind="ids", seed=1.0,
          sample_size=1),
    _case("multinomial_gpt2_head_4", "Multinomial",
          [("logits", gpt2_logits(31), "feed")], kind="ids", seed=2.0,
          sample_size=4),
    _case("multinomial_gpt2_head_float16", "Multinomial",
          [("logits", gpt2_logits(32, F16), "feed")], kind="ids", seed=3.0,
          sample_size=1),
    _case("multinomial_gpt2_head_float16_4", "Multinomial",
          [("logits", gpt2_logits(33, F16), "feed")], kind="ids", seed=4.0,
          sample_size=4),
    _case("multinomial_masked", "Multinomial",
          [("logits", _MASKED, "feed")], kind="ids", seed=5.0,
          sample_size=100),
    _case("multinomial_int64_is_int32_values", "Multinomial",
          [("logits", _x(61, 2, 10), "feed")], kind="ids", seed=6.0,
          sample_size=16, dtype=7),
    _case("multinomial_host_logits", "Multinomial",
          [("logits", _x(62, 4, 20), "const")], kind="ids", seed=7.0,
          sample_size=8),
]

DROPOUT_CASES = [
    _case("dropout_passthrough", "Dropout", [("x", _x(40, 4, 16), "feed")]),
    _case("dropout_mask", "Dropout", [("x", _x(41, 4, 16), "feed")],
          n_out=2),
    _case("dropout_training_mode_ignored", "Dropout",
          [("x", _x(42, 4, 16), "feed"),
           ("ratio", np.array(0.5, F32), "const"),
           ("training_mode", np.array(True), "const")], n_out=2, seed=1),
    _case("dropout_ratio_init", "Dropout",
          [("x", _x(43, 3, 8), "feed"), ("ratio", np.array(0.3, F32),
                                         "init")]),
    _case("dropout_host", "Dropout", [("x", _x(44, 5), "const")], n_out=2),
]

CASES = (NORMAL_CASES + UNIFORM_CASES + BERNOULLI_CASES
         + MULTINOMIAL_CASES + DROPOUT_CASES)


def by_name(name: str) -> dict:
    return next(c for c in CASES if c["name"] == name)


def graph(case: dict, graph_cls) -> bytes:
    """The case's graph, built with ``graph_cls`` (either package's
    ``GraphBuilder``)."""
    g = graph_cls(opset=OPSET)
    names = []
    for name, a, where in case["inputs"]:
        names.append(name)
        if where == "feed":
            g.add_input(name, a.dtype, list(a.shape))
        elif where == "init":
            g.add_initializer(name, a)
        else:
            g.add_node("Constant", [], outputs=[name], value=np.asarray(a))
    outs = [f"y{i}" for i in range(case["n_out"])]
    g.add_node(case["op"], names, outputs=outs,
               name=case["node_name"] or None, **case["attrs"])
    if case["node_name"] == "":
        g._nodes[-1].name = ""          # the builder names every node
    for o in outs:
        g.add_output(o, np.float32, None)
    return g.to_bytes()


def feeds(case: dict) -> list:
    """The graph inputs' numpy values, in order."""
    return [a for _, a, where in case["inputs"] if where == "feed"]


def seed_of(case: dict) -> int:
    """The key's seed of a seeded case, as the reference's ``_node_key``
    reads an integral ``seed``."""
    return int(case["attrs"]["seed"]) & 0x7FFFFFFF


def as_numpy(v) -> np.ndarray:
    """An output as numpy: bfloat16 widened to float32, exactly."""
    if hasattr(v, "detach"):                        # a torch tensor
        import torch

        v = v.detach().cpu()
        return (v.float() if v.dtype == torch.bfloat16 else v).numpy()
    a = np.asarray(v)
    return a.astype(F32) if a.dtype.name == "bfloat16" else a


def run(case: dict, import_model, graph_cls, device: str) -> list:
    """The port's outputs of the case on ``device`` (``import_model`` and
    ``graph_cls`` the port's), each as numpy (:func:`as_numpy`) with
    whether it was a host value."""
    import torch

    fn = import_model(graph(case, graph_cls)).bind(device=device)
    args = [torch.from_numpy(np.ascontiguousarray(a)).to(device)
            for a in feeds(case)]
    return [(as_numpy(v), not isinstance(v, torch.Tensor))
            for v in fn(*args)]


def scores(case: dict, gumbel) -> np.ndarray:
    """A Multinomial case's ``logits + noise`` over ``[B, n, C]``, in the
    logits' dtype, with ``gumbel(seed, shape, dtype_name)`` giving the
    noise (either package's draw, as numpy)."""
    logits = case["inputs"][0][1]
    b, c = logits.shape
    shape = (b, case["attrs"].get("sample_size", 1), c)
    noise = gumbel(seed_of(case), shape, logits.dtype.name)
    return (noise.astype(logits.dtype) + logits[:, None, :])


def ties_for(case: dict, gumbel):
    """A Multinomial case's near-ties (:func:`near_ties` of
    :func:`scores`); None for any other case."""
    return near_ties(scores(case, gumbel)) if case["kind"] == "ids" else None


def port_gumbel(seed: int, shape, dtype: str) -> np.ndarray:
    """The port's Gumbel noise on the CPU, widened to float32, as
    :func:`scores` takes it."""
    import torch

    from synapseml_tpu_torch.gbdt import prng
    from synapseml_tpu_torch.onnx import random as draws

    return draws.gumbel(prng.prng_key(seed, "cpu"), shape,
                        getattr(torch, dtype)).float().numpy()


def near_ties(values: np.ndarray) -> np.ndarray:
    """``[B, n]``: the draws whose top-2 gap of ``values`` (``[B, n, C]``)
    is under :data:`NEAR_TIE` of the largest finite |value| (2^-10 of it
    in float16, whose resolution is coarser)."""
    v = values.astype(np.float64)
    finite = np.abs(v[np.isfinite(v)])
    tol = (2.0 ** -10 if values.dtype == F16 else NEAR_TIE) * (
        finite.max() if finite.size else 1.0)
    top2 = -np.sort(-np.where(np.isnan(v), np.inf, v), axis=-1)[..., :2]
    with np.errstate(invalid="ignore"):
        return (top2[..., 0] - top2[..., 1]) <= tol


def agree(case: dict, got: list, want: list, ties=None) -> dict:
    """``got`` against ``want`` (lists of :func:`run`'s ``(array,
    host)``; ``want``'s dtypes may be the reference's 32-bit ones where
    ``got``'s are 64-bit): bitwise where the case is ``"exact"``, within
    :data:`NORMAL_TOL` where ``"normal"``, and for ``"ids"`` equal but at
    the near-ties ``ties`` (a ``[B, n]`` mask; without it, those of the
    port's CPU noise, :func:`port_gumbel`). Returns
    ``{"ok", "max_abs_err", "bitwise_share", "differing", "near_ties"}``."""
    ok, err, same, total = len(got) == len(want), 0.0, 0, 0
    differing = ties_n = 0
    if ties is None:
        ties = ties_for(case, port_gumbel)
    for (g, g_host), (w, w_host) in zip(got, want):
        narrowed = {"float64": "float32", "int64": "int32"}
        ok &= g_host == w_host and g.shape == w.shape and (
            g.dtype == w.dtype or narrowed.get(g.dtype.name) == w.dtype.name)
        if not ok:
            break
        g = g.astype(w.dtype)
        bits = f"u{g.itemsize}" if g.dtype.kind == "f" else g.dtype
        eq = g.view(bits) == w.view(bits) if g.size else np.zeros(0, bool)
        same += int(eq.sum())
        total += g.size
        if case["kind"] == "ids":
            diff = g != w
            differing += int(diff.sum())
            ties_n += int(ties.sum())
            ok &= bool(np.all(ties[diff]))
        elif case["kind"] == "normal":
            ok &= bool(np.allclose(g, w, rtol=NORMAL_TOL, atol=NORMAL_TOL,
                                   equal_nan=True))
        else:
            ok &= bool(eq.all())
        if g.size and g.dtype.kind == "f":
            with np.errstate(invalid="ignore"):
                d = np.abs(g.astype(np.float64) - w.astype(np.float64))
            d = d[~np.isnan(d)]
            err = max(err, float(d.max()) if d.size else 0.0)
    return {"ok": bool(ok), "max_abs_err": err,
            "bitwise_share": same / total if total else 1.0,
            "differing": differing, "near_ties": ties_n}

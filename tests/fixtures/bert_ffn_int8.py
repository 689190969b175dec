"""BERT-base's feed-forward block, dynamically quantized, as an ONNX graph
for either package.

The block is BERT-base's (hidden 768, intermediate 3,072, erf GELU, bias,
residual add and LayerNormalization with epsilon 1e-12; Devlin et al.'s
published widths), its weights random from a seed (std 0.02, as BERT
initialises them; nothing is fetched), flattened to 2-D (one row a
token). Its contractions are what onnxruntime's ``quantize_dynamic``
emits for a MatMul with an initializer weight: per-tensor symmetric int8
weights (zero point 0) and, a matmul each,

    DynamicQuantizeLinear -> MatMulInteger -> Cast -> Mul(x_scale * w_scale)
    -> Add(bias)

with GELU as the exporters spell it (``Div`` by sqrt 2, ``Erf``, ``Add``
1, two ``Mul``). Two graph inputs, ``hidden`` and ``residual`` (both
``[N, 768]`` float32), so an executor over it stages two host columns.
``stages=True`` adds the block's intermediate values as outputs:
``hq``, ``hs``, ``hz`` (the first ``DynamicQuantizeLinear``), ``acc1``
(the first int32 accumulator), ``g`` (the GELU output), ``gq``, ``gs``,
``gz`` and ``acc2``.

:data:`FULL` is BERT-base at 1,024 tokens; :data:`SMALL` the tier-1
tests' width. This module imports neither package.
"""
import numpy as np

FULL = dict(hidden=768, ffn=3072, tokens=1024)
SMALL = dict(hidden=32, ffn=64, tokens=24)
SEED = 0
INPUT_SEED = 1
EPS = 1e-12
OPSET = 17
FLOAT = 1                     # TensorProto.FLOAT, Cast's "to"
STAGES = ("hq", "hs", "hz", "acc1", "g", "gq", "gs", "gz", "acc2")


def _quantize(w: np.ndarray):
    """quantize_dynamic's default weights: per-tensor symmetric int8."""
    scale = np.float32(np.abs(w).max() / 127.0)
    return (np.clip(np.rint(w / scale), -127, 127).astype(np.int8), scale)


def inputs(cfg: dict = FULL, seed: int = INPUT_SEED):
    """(hidden, residual), ``[tokens, hidden]`` float32 each."""
    rng = np.random.default_rng(seed)
    shape = (cfg["tokens"], cfg["hidden"])
    return (rng.standard_normal(shape).astype(np.float32),
            rng.standard_normal(shape).astype(np.float32))


def graph(graph_cls, cfg: dict = FULL, stages: bool = False,
          seed: int = SEED) -> bytes:
    """The block's bytes, built with ``graph_cls`` (either package's
    ``GraphBuilder``); output ``out`` ``[N, hidden]`` float32 (and
    :data:`STAGES` with ``stages``)."""
    rng = np.random.default_rng(seed)
    h, f = cfg["hidden"], cfg["ffn"]
    w1 = (rng.standard_normal((h, f)) * 0.02).astype(np.float32)
    b1 = (rng.standard_normal(f) * 0.02).astype(np.float32)
    w2 = (rng.standard_normal((f, h)) * 0.02).astype(np.float32)
    b2 = (rng.standard_normal(h) * 0.02).astype(np.float32)
    gamma = (1 + rng.standard_normal(h) * 0.02).astype(np.float32)
    beta = (rng.standard_normal(h) * 0.02).astype(np.float32)
    g = graph_cls(name="bert_ffn_int8", opset=OPSET)
    g.add_input("hidden", np.float32, ["N", h])
    g.add_input("residual", np.float32, ["N", h])

    def dense(x, w, b, i, names):
        wq, ws = _quantize(w)
        g.add_node("DynamicQuantizeLinear", [x], outputs=list(names))
        xq, xs, xz = names
        acc = g.add_node("MatMulInteger", [
            xq, g.add_initializer(f"w{i}_q", wq), xz,
            g.add_initializer(f"w{i}_zp", np.int8(0))],
            outputs=[f"acc{i}"])
        sc = g.add_node("Mul", [xs, g.add_initializer(f"w{i}_scale", ws)])
        y = g.add_node("Mul", [g.add_node("Cast", [acc], to=FLOAT), sc])
        return g.add_node("Add", [y, g.add_initializer(f"b{i}", b)])

    a1 = dense("hidden", w1, b1, 1, ("hq", "hs", "hz"))
    erf = g.add_node("Erf", [g.add_node("Div", [
        a1, g.add_initializer("sqrt2", np.float32(np.sqrt(2.0)))])])
    one = g.add_node("Add", [erf, g.add_initializer("one", np.float32(1))])
    gelu = g.add_node("Mul", [g.add_node("Mul", [a1, one]),
                              g.add_initializer("half", np.float32(0.5))],
                      outputs=["g"])
    a2 = dense(gelu, w2, b2, 2, ("gq", "gs", "gz"))
    r = g.add_node("Add", [a2, "residual"])
    g.add_node("LayerNormalization", [
        r, g.add_initializer("gamma", gamma),
        g.add_initializer("beta", beta)], outputs=["out"], axis=-1,
        epsilon=EPS)
    g.add_output("out", np.float32, ["N", h])
    if stages:
        for name in STAGES:
            g.add_output(name, np.float32, None)
    return g.to_bytes()

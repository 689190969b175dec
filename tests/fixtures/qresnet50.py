"""A statically quantized (QOperator) ResNet-50 as an ONNX graph, for
either package.

The layout is the ONNX Model Zoo's
``validated/vision/classification/resnet/model/resnet50-v1-12-int8.onnx``
(onnxruntime's ``quantize_static(quant_format=QOperator)``; named here,
not fetched), over the weights of ``onnx.zoo.resnet50`` at 224, seed 0
(:func:`float_layers` draws them in the zoo's order, from the zoo's
seed), with each BatchNormalization folded into its convolution:

- the float input -> ``QuantizeLinear`` (uint8);
- one ``QLinearConv`` a convolution, ReLU fused by its output range (a
  zero point of 0 saturates the negatives), per-output-channel symmetric
  int8 weights (zero point 0), uint8 activations, int32 biases at
  ``x_scale * w_scale``;
- ``QLinearAdd`` for the 16 residual adds, their ReLU fused the same way;
- ``QLinearGlobalAveragePool``, then ``Flatten``;
- ``QGemm`` for the head (per-output-channel weights, int32 bias, uint8
  logits ``logits_q``);
- ``DequantizeLinear`` on the output (``logits``, float32).

One departure from the zoo's graph: the stem's ``MaxPool`` sits between a
``DequantizeLinear`` and a ``QuantizeLinear`` with the stem's own scale
and zero point (an exact round trip of its values), because the JAX
importer refuses an integer ``MaxPool`` (``TypeError: reduce_window got
inconsistent dtypes``; ROADMAP Queue 3).

Calibration is MinMax over :data:`CALIB_IMAGES` seeded images
(onnxruntime's default ``CalibrationMethod.MinMax``): each quantized
tensor's float range, widened to hold 0, gives a uint8 scale over 255
steps and a zero point. ``accumulator=True`` adds the output ``stem_acc``:
a ``ConvInteger`` of the quantized input with the stem's int8 weights,
the first convolution's int32 accumulator (bias excluded).

:data:`FULL` is ResNet-50 224 (1,000 classes); :data:`TINY` is
``zoo.tiny_resnet`` (two bottleneck stages of width 8, 32 x 32, 10
classes), the tier-1 tests' width. ``tests/fixtures/make_qresnet50_fixture.py``
writes the JAX package's outputs of the full graph for two images to
``qresnet50_io.npz``. This module imports neither package and no JAX.
"""
import os

import numpy as np
from numpy.lib.stride_tricks import sliding_window_view

HERE = os.path.dirname(os.path.abspath(__file__))
OUT = os.path.join(HERE, "qresnet50_io.npz")
FULL = dict(depths=(3, 4, 6, 3), width=64, image=224, classes=1000)
TINY = dict(depths=(1, 1), width=8, image=32, classes=10)
SEED = 0                      # zoo.resnet50's weights
CALIB_SEED = 1
CALIB_IMAGES = 4
BN_EPS = 1e-5                 # GraphBuilder.batch_norm's epsilon
OPSET = 21
OUTPUTS = ("logits", "logits_q")


def float_layers(cfg: dict = FULL, seed: int = SEED) -> dict:
    """The zoo's float ResNet (``onnx/zoo.py`` ``build_resnet``), drawn in
    its order from its seed, each BatchNormalization folded into its
    convolution: ``{"stem": conv, "blocks": [(c1, c2, c3, shortcut or
    None)], "fc": (w [classes, C], b)}``, a conv being ``dict(w, b,
    stride, pad, relu)`` in float32."""
    rng = np.random.default_rng(seed)

    def conv_w(out_c, in_c, k):
        std = np.sqrt(2.0 / (in_c * k * k))
        return rng.normal(0, std, (out_c, in_c, k, k)).astype(np.float32)

    def bn(c):
        return (np.abs(rng.normal(1, 0.1, c)).astype(np.float32),
                rng.normal(0, 0.1, c).astype(np.float32),
                rng.normal(0, 0.5, c).astype(np.float32),
                np.abs(rng.normal(1, 0.2, c)).astype(np.float32) + 0.1)

    def conv(out_c, in_c, k, stride=1, pad=0, relu=True):
        w = conv_w(out_c, in_c, k)
        s, b, m, v = (a.astype(np.float64) for a in bn(out_c))
        f = s / np.sqrt(v + BN_EPS)
        return dict(w=(w * f[:, None, None, None]).astype(np.float32),
                    b=(b - m * f).astype(np.float32), stride=stride,
                    pad=pad, relu=relu)

    width = cfg["width"]
    stem = conv(width, 3, 7, 2, 3)
    blocks, in_c, chan = [], width, width
    for stage, n_blocks in enumerate(cfg["depths"]):
        for blk in range(n_blocks):
            stride = 2 if (stage > 0 and blk == 0) else 1
            out_c = chan * 4
            c1 = conv(chan, in_c, 1)
            c2 = conv(chan, chan, 3, stride, 1)
            c3 = conv(out_c, chan, 1, relu=False)
            sc = (conv(out_c, in_c, 1, stride, relu=False)
                  if stride != 1 or in_c != out_c else None)
            blocks.append((c1, c2, c3, sc))
            in_c = out_c
        chan *= 2
    std = np.sqrt(1.0 / in_c)
    w = rng.uniform(-std, std, (cfg["classes"], in_c)).astype(np.float32)
    b = rng.uniform(-std, std, (cfg["classes"],)).astype(np.float32)
    return dict(stem=stem, blocks=blocks, fc=(w, b))


def conv_classes(cfg: dict = FULL) -> list:
    """Each distinct convolution of the graph as ``(C_in, H, C_out, k,
    stride, pad)`` (square inputs and kernels), in graph order; the head
    is ``(C, classes)`` under ``"head"``."""
    layers = float_layers(cfg)
    out, seen = [], set()

    def add(c, h, conv):
        key = (c, h, len(conv["w"]), conv["w"].shape[2], conv["stride"],
               conv["pad"])
        if key not in seen:
            seen.add(key)
            out.append(key)
        return (h + 2 * conv["pad"] - conv["w"].shape[2]) \
            // conv["stride"] + 1

    h = add(3, cfg["image"], layers["stem"])
    h = (h + 2 - 3) // 2 + 1                            # the MaxPool
    for c1, c2, c3, sc in layers["blocks"]:
        c_in = c1["w"].shape[1]
        hm = add(c_in, h, c1)
        hm = add(len(c1["w"]), hm, c2)
        add(len(c2["w"]), hm, c3)
        if sc is not None:
            add(c_in, h, sc)
        h = hm
    w, _ = layers["fc"]
    return out + [("head", w.shape[1], w.shape[0])]


def images(n: int, cfg: dict = FULL, seed: int = CALIB_SEED) -> np.ndarray:
    return np.random.default_rng(seed).standard_normal(
        (n, 3, cfg["image"], cfg["image"])).astype(np.float32)


def _conv_np(x, c):
    k = c["w"].shape[2]
    p, s = c["pad"], c["stride"]
    xp = np.pad(x, ((0, 0), (0, 0), (p, p), (p, p)))
    win = sliding_window_view(xp, (k, k), axis=(2, 3))[:, :, ::s, ::s]
    n, _, ho, wo = win.shape[:4]
    cols = win.transpose(0, 2, 3, 1, 4, 5).reshape(n * ho * wo, -1)
    y = cols @ c["w"].reshape(len(c["w"]), -1).T + c["b"]
    y = y.reshape(n, ho, wo, -1).transpose(0, 3, 1, 2)
    return np.maximum(y, 0) if c["relu"] else y


def _max_pool_np(x):
    xp = np.pad(x, ((0, 0), (0, 0), (1, 1), (1, 1)),
                constant_values=-np.inf)
    return sliding_window_view(xp, (3, 3), axis=(2, 3))[
        :, :, ::2, ::2].max(axis=(4, 5))


def ranges(layers: dict, x: np.ndarray) -> dict:
    """MinMax calibration: the float forward on ``x``, the (min, max) of
    every quantized tensor: ``input``, ``stem``, ``b{i}c{j}`` (the j-th
    convolution of block i, 4 = the shortcut), ``b{i}add``, ``gap`` and
    ``logits``."""
    r = {"input": (x.min(), x.max())}
    y = _conv_np(x, layers["stem"])
    r["stem"] = (y.min(), y.max())
    y = _max_pool_np(y)
    for i, (c1, c2, c3, sc) in enumerate(layers["blocks"]):
        h = y
        for j, c in enumerate((c1, c2, c3), 1):
            h = _conv_np(h, c)
            r[f"b{i}c{j}"] = (h.min(), h.max())
        if sc is not None:
            y = _conv_np(y, sc)
            r[f"b{i}c4"] = (y.min(), y.max())
        y = np.maximum(h + y, 0)
        r[f"b{i}add"] = (y.min(), y.max())
    y = y.mean(axis=(2, 3))
    r["gap"] = (y.min(), y.max())
    w, b = layers["fc"]
    y = y @ w.T + b
    r["logits"] = (y.min(), y.max())
    return {k: (float(lo), float(hi)) for k, (lo, hi) in r.items()}


def qparams(lo: float, hi: float):
    """uint8 asymmetric scale and zero point of a calibrated range (the
    range widened to hold 0)."""
    lo, hi = min(lo, 0.0), max(hi, 0.0)
    scale = np.float32((hi - lo) / 255.0) if hi > lo else np.float32(1.0)
    zp = np.uint8(np.clip(np.rint(-lo / float(scale)), 0, 255))
    return scale, zp


def quantize_weights(w: np.ndarray):
    """Per-output-channel symmetric int8 weights: (int8 values, float32
    scales), zero point 0."""
    amax = np.abs(w.reshape(len(w), -1)).max(axis=1).astype(np.float64)
    scale = np.where(amax > 0, amax / 127.0, 1.0)
    q = np.clip(np.rint(w / scale.reshape((-1,) + (1,) * (w.ndim - 1))),
                -127, 127).astype(np.int8)
    return q, scale.astype(np.float32)


def stored_ranges() -> dict:
    """The calibrated ranges of the FULL graph that ``qresnet50_io.npz``
    was made with: the float forward's min and max depend on the BLAS
    that computed them, so a machine that rebuilds the graph reads them
    here instead of calibrating again."""
    with np.load(OUT) as z:
        return {str(k): (float(lo), float(hi)) for k, (lo, hi) in
                zip(z["range_keys"], z["ranges"])}


def graph(graph_cls, cfg: dict = FULL, accumulator: bool = False,
          seed: int = SEED, calib_images: int = CALIB_IMAGES,
          calibrated: dict = None) -> bytes:
    """The quantized graph's bytes, built with ``graph_cls`` (either
    package's ``GraphBuilder``); input ``data`` ``[N, 3, H, W]`` float32,
    outputs :data:`OUTPUTS` (and ``stem_acc`` with ``accumulator``).
    ``calibrated`` gives the ranges (:func:`ranges`' dict); by default
    they are calibrated here."""
    layers = float_layers(cfg, seed)
    if calibrated is None:
        calibrated = ranges(layers, images(calib_images, cfg))
    qp = {k: qparams(*v) for k, v in calibrated.items()}
    g = graph_cls(name="qresnet50", opset=OPSET)
    n_ = iter(range(10 ** 6))

    def init(prefix, a):
        return g.add_initializer(f"{prefix}_{next(n_)}", np.asarray(a))

    def scale_zp(key):
        s, z = qp[key]
        return init(f"{key}_scale", s), init(f"{key}_zp", z)

    x = g.add_input("data", np.float32, ["N", 3, cfg["image"], cfg["image"]])
    in_s, in_z = scale_zp("input")
    q = g.add_node("QuantizeLinear", [x, in_s, in_z])
    act = {q: ("input", in_s, in_z)}

    def qconv(x, key, c):
        xk, xs, xz = act[x]
        wq, ws = quantize_weights(c["w"])
        bq = np.rint(c["b"].astype(np.float64)
                     / (float(qp[xk][0]) * ws.astype(np.float64))
                     ).astype(np.int32)
        ys, yz = scale_zp(key)
        y = g.add_node("QLinearConv", [
            x, xs, xz, init("w", wq), init("w_scale", ws),
            init("w_zp", np.zeros(len(wq), np.int8)), ys, yz,
            init("b", bq)], strides=[c["stride"]] * 2,
            pads=[c["pad"]] * 4, kernel_shape=list(wq.shape[2:]))
        act[y] = (key, ys, yz)
        return y

    y = qconv(q, "stem", layers["stem"])
    _, ss, sz = act[y]
    f = g.add_node("DequantizeLinear", [y, ss, sz])
    f = g.add_node("MaxPool", [f], kernel_shape=[3, 3], strides=[2, 2],
                   pads=[1, 1, 1, 1])
    y = g.add_node("QuantizeLinear", [f, ss, sz])
    act[y] = ("stem", ss, sz)
    for i, (c1, c2, c3, sc) in enumerate(layers["blocks"]):
        h = qconv(y, f"b{i}c1", c1)
        h = qconv(h, f"b{i}c2", c2)
        h = qconv(h, f"b{i}c3", c3)
        if sc is not None:
            y = qconv(y, f"b{i}c4", sc)
        _, hs, hz = act[h]
        _, ys_, yz_ = act[y]
        os_, oz = scale_zp(f"b{i}add")
        y = g.add_node("QLinearAdd", [h, hs, hz, y, ys_, yz_, os_, oz])
        act[y] = (f"b{i}add", os_, oz)
    _, xs, xz = act[y]
    gs, gz = scale_zp("gap")
    y = g.add_node("QLinearGlobalAveragePool", [y, xs, xz, gs, gz])
    y = g.add_node("Flatten", [y], axis=1)
    w, b = layers["fc"]
    wq, ws = quantize_weights(w)
    bq = np.rint(b.astype(np.float64) / (float(qp["gap"][0])
                                         * ws.astype(np.float64))
                 ).astype(np.int32)
    ls, lz = scale_zp("logits")
    g.add_node("QGemm", [y, gs, gz, init("fc_w", wq), init("fc_scale", ws),
                         init("fc_zp", np.zeros(len(wq), np.int8)),
                         init("fc_b", bq), ls, lz], outputs=["logits_q"],
               transB=1)
    g.add_node("DequantizeLinear", ["logits_q", ls, lz], outputs=["logits"])
    g.add_output("logits", np.float32, ["N", cfg["classes"]])
    g.add_output("logits_q", np.uint8, ["N", cfg["classes"]])
    if accumulator:
        stem = layers["stem"]
        g.add_node("ConvInteger", [q, init("stem_wq",
                                           quantize_weights(stem["w"])[0]),
                                   in_z], outputs=["stem_acc"],
                   strides=[2, 2], pads=[3, 3, 3, 3])
        g.add_output("stem_acc", np.int32, None)
    return g.to_bytes()

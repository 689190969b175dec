"""Stable Diffusion v1's VAE decoder as an ONNX graph, for either package.

The decoder of diffusers' ``AutoencoderKL`` with the ``vae/config.json``
of ``runwayml/stable-diffusion-v1-5`` (:data:`FULL`):
``block_out_channels`` [128, 256, 512, 512], ``layers_per_block`` 2,
``latent_channels`` 4, ``norm_num_groups`` 32, SiLU; 49.5 M float32
parameters, random from a seed (no weights are fetched). The graph, opset
21, built by the caller's ``GraphBuilder`` (:func:`decoder_graph`):

- ``latent [N, 4, H, W]`` divided by the scaling factor 0.18215, then
  ``post_quant_conv`` (1x1, 4 -> 4) and ``conv_in`` (3x3, 4 -> 512);
- the mid block: a resnet, single-head attention over the ``H * W``
  positions (``GroupNormalization``, q/k/v projections, ``MatMul``, scale
  1/sqrt(512), ``Softmax``, ``MatMul``, the output projection, the
  residual), a resnet;
- four up blocks of ``layers_per_block + 1`` resnets each (512, 512, 256,
  128 channels); a resnet is ``GroupNormalization(32, eps=1e-6)``, SiLU as
  ``x * Sigmoid(x)``, conv 3x3, twice, plus the input (through a 1x1 conv
  where the width changes); after each of the first three, ``Resize``
  nearest x2 as ``torch.onnx`` exports ``F.interpolate``
  (``asymmetric``/``floor``) and a conv 3x3;
- ``conv_norm_out``, SiLU, ``conv_out`` (128 -> 3): ``image [N, 3, 8H,
  8W]``.

Node names start with the block they belong to (``mid.attn.`` for the
attention's), so a timing can group them. :data:`SMALL` is the tier-1
tests' width. ``tests/fixtures/make_vae_fixture.py`` runs the JAX
package's importer on the full-width graph over :func:`latents` at
32 x 32 into ``vae_decoder_io.npz``. This module imports neither package
and no JAX.
"""
import math
import os

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
OUT = os.path.join(HERE, "vae_decoder_io.npz")
FULL = dict(block_out_channels=(128, 256, 512, 512), layers_per_block=2,
            latent_channels=4, out_channels=3, norm_num_groups=32)
SMALL = dict(block_out_channels=(32, 64), layers_per_block=0,
             latent_channels=4, out_channels=3, norm_num_groups=8)
EPS = 1e-6
SCALING_FACTOR = 0.18215
WEIGHT_SEED = 0
LATENT_SEED = 1
FIXTURE_LATENTS = 2      # the fixture's latents...
FIXTURE_SIZE = 32        # ...at 32 x 32 (256 x 256 images)
PUBLISHED_SIZE = 64      # sample_size 512: 64 x 64 latents
OPSET = 21


class _Net:
    """The GraphBuilder, the weights' generator and a node-name prefix."""

    def __init__(self, g, seed: int):
        self.g = g
        self.rng = np.random.default_rng(seed)
        self.prefix = ""
        self._n = 0

    def name(self, what: str) -> str:
        self._n += 1
        return f"{self.prefix}{what}_{self._n}"

    def init(self, what: str, a: np.ndarray) -> str:
        return self.g.add_initializer(self.name(what), a.astype(np.float32))

    def normal(self, shape, std: float) -> np.ndarray:
        return self.rng.standard_normal(shape, dtype=np.float32) * np.float32(
            std)

    def node(self, op: str, inputs, **attrs) -> str:
        return self.g.add_node(op, inputs, name=self.name(op.lower()),
                               **attrs)

    def conv(self, x: str, cin: int, cout: int, k: int, stride: int = 1,
             pad: int = None) -> str:
        """A ``k`` x ``k`` convolution, padded ``k // 2`` a side unless
        ``pad`` says otherwise."""
        w = self.init("w", self.normal((cout, cin, k, k),
                                       1.0 / math.sqrt(cin * k * k)))
        b = self.init("b", self.normal((cout,), 0.02))
        p = k // 2 if pad is None else pad
        attrs = {"strides": [stride, stride]} if stride != 1 else {}
        return self.node("Conv", [x, w, b], kernel_shape=[k, k],
                         pads=[p, p, p, p], **attrs)

    def group_norm(self, x: str, c: int, groups: int) -> str:
        scale = self.init("gamma", 1.0 + self.normal((c,), 0.1))
        bias = self.init("beta", self.normal((c,), 0.1))
        return self.node("GroupNormalization", [x, scale, bias],
                         num_groups=groups, epsilon=EPS)

    def silu(self, x: str) -> str:
        return self.node("Mul", [x, self.node("Sigmoid", [x])])

    def linear(self, x: str, c: int) -> str:
        w = self.init("w", self.normal((c, c), 1.0 / math.sqrt(c)))
        b = self.init("b", self.normal((c,), 0.02))
        return self.node("Add", [self.node("MatMul", [x, w]), b])


def _resnet(net: _Net, x: str, cin: int, cout: int, groups: int) -> str:
    h = net.conv(net.silu(net.group_norm(x, cin, groups)), cin, cout, 3)
    h = net.conv(net.silu(net.group_norm(h, cout, groups)), cout, cout, 3)
    skip = net.conv(x, cin, cout, 1) if cin != cout else x
    return net.node("Add", [skip, h])


def _attention(net: _Net, x: str, c: int, groups: int) -> str:
    """Single-head self-attention over the H * W positions (diffusers'
    ``Attention`` with ``heads=1``, ``dim_head=c``, residual)."""
    h = net.group_norm(x, c, groups)
    flat = net.init("flat", np.array([0, c, -1], np.int64))
    seq = net.node("Transpose", [net.node("Reshape", [h, flat])],
                   perm=[0, 2, 1])                          # [N, HW, C]
    q, k, v = (net.linear(seq, c) for _ in range(3))
    scores = net.node("MatMul", [q, net.node("Transpose", [k],
                                            perm=[0, 2, 1])])
    scale = net.init("scale", np.array(1.0 / math.sqrt(c), np.float32))
    probs = net.node("Softmax", [net.node("Mul", [scores, scale])], axis=-1)
    out = net.linear(net.node("MatMul", [probs, v]), c)
    back = net.node("Reshape", [net.node("Transpose", [out], perm=[0, 2, 1]),
                                net.node("Shape", [x])])
    return net.node("Add", [back, x])


def decoder_graph(graph_cls, cfg: dict = FULL,
                  seed: int = WEIGHT_SEED) -> bytes:
    """The decoder's ONNX bytes (opset 21), built with ``graph_cls``
    (either package's ``GraphBuilder``); the weights drawn from ``seed``
    in node order."""
    g = graph_cls(name="vae_decoder", opset=OPSET)
    net = _Net(g, seed)
    chans = list(cfg["block_out_channels"])[::-1]
    groups, lat = cfg["norm_num_groups"], cfg["latent_channels"]
    x = g.add_input("latent", np.float32, ["N", lat, "H", "W"])
    net.prefix = "in."
    x = net.node("Div", [x, net.init("scaling_factor", np.array(
        SCALING_FACTOR, np.float32))])
    x = net.conv(x, lat, lat, 1)                        # post_quant_conv
    x = net.conv(x, lat, chans[0], 3)                   # conv_in
    net.prefix = "mid."
    x = _resnet(net, x, chans[0], chans[0], groups)
    net.prefix = "mid.attn."
    x = _attention(net, x, chans[0], groups)
    net.prefix = "mid."
    x = _resnet(net, x, chans[0], chans[0], groups)
    scales = g.add_initializer("up_scales",
                               np.array([1, 1, 2, 2], np.float32))
    prev = chans[0]
    for i, ch in enumerate(chans):
        net.prefix = f"up{i}."
        for j in range(cfg["layers_per_block"] + 1):
            x = _resnet(net, x, prev if j == 0 else ch, ch, groups)
        prev = ch
        if i < len(chans) - 1:
            x = net.node("Resize", [x, "", scales], mode="nearest",
                         coordinate_transformation_mode="asymmetric",
                         nearest_mode="floor", cubic_coeff_a=-0.75)
            x = net.conv(x, ch, ch, 3)
    net.prefix = "out."
    x = net.conv(net.silu(net.group_norm(x, prev, groups)), prev,
                 cfg["out_channels"], 3)
    g.add_node("Identity", [x], outputs=["image"], name="out.image")
    g.add_output("image", np.float32, ["N", cfg["out_channels"], None, None])
    return g.to_bytes()


def latents(n: int, size: int, seed: int = LATENT_SEED,
            channels: int = 4) -> np.ndarray:
    """``n`` seeded ``[channels, size, size]`` latents, unit normal (a
    diffusion sampler's output scaled by 0.18215)."""
    return np.random.default_rng(seed).standard_normal(
        (n, channels, size, size), dtype=np.float32)


def parameters(cfg: dict = FULL) -> int:
    """The decoder's parameter count: its convolutions, norms and
    projections (not the reshape target, the resize scales and the two
    scalars)."""
    chans = list(cfg["block_out_channels"])[::-1]
    lat, c0 = cfg["latent_channels"], chans[0]

    def conv(cin, cout, k):
        return cout * cin * k * k + cout

    def resnet(cin, cout):
        return (2 * cin + conv(cin, cout, 3) + 2 * cout + conv(cout, cout, 3)
                + (conv(cin, cout, 1) if cin != cout else 0))

    total = conv(lat, lat, 1) + conv(lat, c0, 3) + 2 * resnet(c0, c0)
    total += 2 * c0 + 4 * (c0 * c0 + c0)               # the attention
    prev = c0
    for i, ch in enumerate(chans):
        for j in range(cfg["layers_per_block"] + 1):
            total += resnet(prev if j == 0 else ch, ch)
        prev = ch
        if i < len(chans) - 1:
            total += conv(ch, ch, 3)
    return total + 2 * prev + conv(prev, cfg["out_channels"], 3)


def flops(cfg: dict, n: int, size: int) -> dict:
    """Operations of one forward over ``n`` latents of ``size`` x
    ``size`` (2 a multiply-add), by part: the convolutions, the
    attention's four projections and two products."""
    chans = list(cfg["block_out_channels"])[::-1]
    lat, out = cfg["latent_channels"], cfg["out_channels"]
    conv = 0.0
    side = size

    def c(cin, cout, k):
        return 2.0 * n * cin * cout * k * k * side * side

    conv += c(lat, lat, 1) + c(lat, chans[0], 3)

    def resnet(cin, cout):
        return c(cin, cout, 3) + c(cout, cout, 3) + (
            c(cin, cout, 1) if cin != cout else 0.0)

    conv += 2 * resnet(chans[0], chans[0])
    hw, ch0 = side * side, chans[0]
    attention = 2.0 * n * (4 * hw * ch0 * ch0 + 2 * hw * hw * ch0)
    prev = chans[0]
    for i, ch in enumerate(chans):
        for j in range(cfg["layers_per_block"] + 1):
            conv += resnet(prev if j == 0 else ch, ch)
        prev = ch
        if i < len(chans) - 1:
            side *= 2
            conv += c(ch, ch, 3)
    conv += c(prev, out, 3)
    return {"conv": conv, "attention": attention, "total": conv + attention}

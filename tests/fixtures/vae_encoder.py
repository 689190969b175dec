"""Stable Diffusion v1's VAE encoder, sampling its latent, as an ONNX graph
for either package.

The encoder of diffusers' ``AutoencoderKL`` with the ``vae/config.json``
of ``runwayml/stable-diffusion-v1-5`` (:data:`FULL`):
``block_out_channels`` [128, 256, 512, 512], ``layers_per_block`` 2,
``latent_channels`` 4 with ``double_z``, ``norm_num_groups`` 32, SiLU;
34.2 M float32 parameters, random from a seed (no weights are fetched).
The graph, opset 21, built by the caller's ``GraphBuilder``
(:func:`encoder_graph`) with the decoder's pieces
(``vae_decoder._Net``, ``_resnet``, ``_attention``):

- ``image [N, 3, H, W]`` (in [-1, 1]), ``conv_in`` (3x3, 3 -> 128);
- four ``DownEncoderBlock2D``s of ``layers_per_block`` resnets (128, 256,
  512, 512 channels); the first three end in diffusers' ``Downsample2D``
  as ``torch.onnx`` exports it: ``Pad`` [0, 0, 0, 0, 0, 0, 1, 1] (one row
  and one column of zeros at the end) and a 3x3 stride-2 conv with
  padding 0;
- the mid block: a resnet, single-head attention over the ``H/8 * W/8``
  positions, a resnet;
- ``conv_norm_out``, SiLU, ``conv_out`` (512 -> 8) and ``quant_conv``
  (1x1, 8 -> 8);
- ``DiagonalGaussianDistribution.sample()``: ``Split`` into ``mean`` and
  ``logvar``, ``Clip(logvar, -30, 20)``, ``std = Exp(0.5 * logvar)``,
  ``eps = RandomNormalLike(mean)`` with no ``seed`` attribute (so the
  importer keys it by the node's name), ``(mean + std * eps) * 0.18215``:
  ``latent [N, 4, H/8, W/8]``.

Outputs: ``latent``, ``mean``, ``logvar`` (clipped) and ``eps``. Node
names start with the block they belong to (``mid.attn.`` for the
attention's, ``sample.`` for the draw's). :data:`SMALL` is the tier-1
tests' width. ``tests/fixtures/make_vae_encoder_fixture.py`` runs the JAX
package's importer on the full-width graph over :func:`images` at
256 x 256 into ``vae_encoder_io.npz``. This module imports neither
package and no JAX.
"""
import os

import numpy as np

from vae_decoder import _Net, _attention, _resnet

HERE = os.path.dirname(os.path.abspath(__file__))
OUT = os.path.join(HERE, "vae_encoder_io.npz")
FULL = dict(block_out_channels=(128, 256, 512, 512), layers_per_block=2,
            latent_channels=4, in_channels=3, norm_num_groups=32)
SMALL = dict(block_out_channels=(32, 64), layers_per_block=1,
             latent_channels=4, in_channels=3, norm_num_groups=8)
SCALING_FACTOR = 0.18215
LOGVAR_RANGE = (-30.0, 20.0)
WEIGHT_SEED = 0
IMAGE_SEED = 1
FIXTURE_IMAGES = 2       # the fixture's images...
FIXTURE_SIZE = 256       # ...at 256 x 256
PUBLISHED_SIZE = 512     # sample_size 512
OPSET = 21
OUTPUTS = ("latent", "mean", "logvar", "eps")


def _downsample(net: _Net, x: str, c: int) -> str:
    """diffusers' ``Downsample2D(padding=0)``: pad one zero row and column
    at the end, then a 3x3 stride-2 conv without padding."""
    pads = net.init("pads", np.array([0, 0, 0, 0, 0, 0, 1, 1], np.int64))
    x = net.node("Pad", [x, pads], mode="constant")
    return net.conv(x, c, c, 3, stride=2, pad=0)


def encoder_graph(graph_cls, cfg: dict = FULL,
                  seed: int = WEIGHT_SEED) -> bytes:
    """The encoder's ONNX bytes (opset 21), built with ``graph_cls``
    (either package's ``GraphBuilder``); the weights drawn from ``seed``
    in node order."""
    g = graph_cls(name="vae_encoder", opset=OPSET)
    net = _Net(g, seed)
    chans = list(cfg["block_out_channels"])
    groups, lat = cfg["norm_num_groups"], cfg["latent_channels"]
    x = g.add_input("image", np.float32, ["N", cfg["in_channels"], "H", "W"])
    net.prefix = "in."
    x = net.conv(x, cfg["in_channels"], chans[0], 3)        # conv_in
    prev = chans[0]
    for i, ch in enumerate(chans):
        net.prefix = f"down{i}."
        for j in range(cfg["layers_per_block"]):
            x = _resnet(net, x, prev if j == 0 else ch, ch, groups)
        prev = ch
        if i < len(chans) - 1:
            x = _downsample(net, x, ch)
    net.prefix = "mid."
    x = _resnet(net, x, prev, prev, groups)
    net.prefix = "mid.attn."
    x = _attention(net, x, prev, groups)
    net.prefix = "mid."
    x = _resnet(net, x, prev, prev, groups)
    net.prefix = "out."
    x = net.conv(net.silu(net.group_norm(x, prev, groups)), prev, 2 * lat, 3)
    x = net.conv(x, 2 * lat, 2 * lat, 1)                    # quant_conv
    net.prefix = "sample."
    halves = net.init("split", np.array([lat, lat], np.int64))
    g.add_node("Split", [x, halves], outputs=["mean", "logvar_raw"],
               name=net.name("split"), axis=1)
    lo, hi = (net.init(k, np.array(v, np.float32))
              for k, v in zip(("lo", "hi"), LOGVAR_RANGE))
    g.add_node("Clip", ["logvar_raw", lo, hi], outputs=["logvar"],
               name=net.name("clip"))
    std = net.node("Exp", [net.node("Mul", [
        "logvar", net.init("half", np.array(0.5, np.float32))])])
    g.add_node("RandomNormalLike", ["mean"], outputs=["eps"],
               name=net.name("randomnormallike"))
    z = net.node("Add", ["mean", net.node("Mul", [std, "eps"])])
    g.add_node("Mul", [z, net.init("scaling_factor", np.array(
        SCALING_FACTOR, np.float32))], outputs=["latent"],
        name=net.name("mul"))
    for name, shape in (("latent", lat), ("mean", lat), ("logvar", lat),
                        ("eps", lat)):
        g.add_output(name, np.float32, ["N", shape, None, None])
    return g.to_bytes()


def images(n: int, size: int, seed: int = IMAGE_SEED) -> np.ndarray:
    """``n`` seeded ``[3, size, size]`` images in [-1, 1] (the encoder's
    input range): smooth colour fields plus pixel noise."""
    rng = np.random.default_rng(seed)
    yy, xx = np.meshgrid(np.linspace(0, 1, size), np.linspace(0, 1, size),
                         indexing="ij")
    freq = rng.uniform(1, 6, (n, 3, 2))
    phase = rng.uniform(0, 2 * np.pi, (n, 3))
    field = np.sin(2 * np.pi * (freq[..., 0, None, None] * yy
                                + freq[..., 1, None, None] * xx)
                   + phase[..., None, None])
    noise = rng.uniform(-0.3, 0.3, (n, 3, size, size))
    return np.clip(0.7 * field + noise, -1.0, 1.0).astype(np.float32)


def parameters(cfg: dict = FULL) -> int:
    """The encoder's parameter count: its convolutions, norms and
    projections (not the pads, the split sizes, the reshape target and
    the scalars)."""
    chans = list(cfg["block_out_channels"])
    lat = cfg["latent_channels"]

    def conv(cin, cout, k):
        return cout * cin * k * k + cout

    def resnet(cin, cout):
        return (2 * cin + conv(cin, cout, 3) + 2 * cout + conv(cout, cout, 3)
                + (conv(cin, cout, 1) if cin != cout else 0))

    total = conv(cfg["in_channels"], chans[0], 3)
    prev = chans[0]
    for i, ch in enumerate(chans):
        for j in range(cfg["layers_per_block"]):
            total += resnet(prev if j == 0 else ch, ch)
        prev = ch
        if i < len(chans) - 1:
            total += conv(ch, ch, 3)
    total += 2 * resnet(prev, prev) + 2 * prev + 4 * (prev * prev + prev)
    return (total + 2 * prev + conv(prev, 2 * lat, 3)
            + conv(2 * lat, 2 * lat, 1))


def flops(cfg: dict, n: int, size: int) -> dict:
    """Operations of one forward over ``n`` images of ``size`` x ``size``
    (2 a multiply-add), by part: the convolutions, the attention's four
    projections and two products."""
    chans = list(cfg["block_out_channels"])
    lat = cfg["latent_channels"]
    side = size

    def c(cin, cout, k, out_side=None):
        s = side if out_side is None else out_side
        return 2.0 * n * cin * cout * k * k * s * s

    def resnet(cin, cout):
        return c(cin, cout, 3) + c(cout, cout, 3) + (
            c(cin, cout, 1) if cin != cout else 0.0)

    conv = c(cfg["in_channels"], chans[0], 3)
    prev = chans[0]
    for i, ch in enumerate(chans):
        for j in range(cfg["layers_per_block"]):
            conv += resnet(prev if j == 0 else ch, ch)
        prev = ch
        if i < len(chans) - 1:
            side //= 2
            conv += c(ch, ch, 3)
    conv += 2 * resnet(prev, prev)
    hw = side * side
    attention = 2.0 * n * (4 * hw * prev * prev + 2 * hw * hw * prev)
    conv += c(prev, 2 * lat, 3) + c(2 * lat, 2 * lat, 1)
    return {"conv": conv, "attention": attention, "total": conv + attention}

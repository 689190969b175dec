"""SLIC-style superpixel clustering on the device.

The counterpart of the reference package's ``explainers/superpixel.py``
(itself the re-design of ref: core/.../lime/Superpixel.scala:42-267 —
grid-seeded iterative color-distance clustering, ``cellSize``/``modifier``
params): a k-means-style loop of a fixed 10 iterations in torch ops, all
pixel→center distances one ``[H·W, P]`` block an iteration, the centers
updated by ``index_add_`` where the reference sums with ``segment_sum``.
No per-pixel Python and no host sync inside the loop.

``index_add_`` on the card adds with atomics, in no fixed order, so a
center's float32 sum may differ from the reference's in the last bit; a
pixel whose two nearest centers are that close to a tie may take the
other one.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from synapseml_tpu_torch import device as device_policy


@dataclasses.dataclass
class SuperpixelData:
    """Cluster assignment for one image (ref: SuperpixelData.scala:25)."""
    assignment: np.ndarray  # [H, W] int32 cluster ids
    num_clusters: int

    def masked_image(self, image: np.ndarray, state: np.ndarray,
                     background: float = 0.0) -> np.ndarray:
        """Apply an on/off superpixel state vector to the image."""
        on = np.asarray(state)[self.assignment].astype(image.dtype)
        if image.ndim == 3:
            on = on[..., None]
        return image * on + background * (1 - on)


def _distances(flat: torch.Tensor, pos: torch.Tensor, centers: torch.Tensor,
               spatial_w: float) -> torch.Tensor:
    """``[H·W, P]`` SLIC distances: color plus weighted spatial, squared."""
    cd = ((flat[:, None, :] - centers[None, :, :-2]) ** 2).sum(-1)
    sd = ((pos[:, None, :] - centers[None, :, -2:]) ** 2).sum(-1)
    return cd + spatial_w * sd


def _slic(pix: torch.Tensor, yx: torch.Tensor, grid_h: int, grid_w: int,
          spatial_w: float, iters: int) -> torch.Tensor:
    """The reference's ``_slic`` (explainers/superpixel.py:37-63): grid
    seeds, ``iters`` assignment/update rounds, a final assignment."""
    h, w, _ = pix.shape
    p = grid_h * grid_w
    dev = pix.device
    flat = pix.reshape(-1, pix.shape[-1])
    pos = yx.reshape(-1, 2)
    cy = (torch.arange(grid_h, dtype=torch.float32, device=dev) + 0.5) \
        * (h / grid_h)
    cx = (torch.arange(grid_w, dtype=torch.float32, device=dev) + 0.5) \
        * (w / grid_w)
    cyx = torch.stack(torch.meshgrid(cy, cx, indexing="ij"), -1).reshape(-1, 2)
    c_idx = (torch.clamp(cyx[:, 0].to(torch.int64), 0, h - 1) * w
             + torch.clamp(cyx[:, 1].to(torch.int64), 0, w - 1))
    centers = torch.cat([flat[c_idx], cyx], dim=1)  # [P, C+2]
    feat = torch.cat([flat, pos], dim=1)
    ones = torch.ones(flat.shape[0], dtype=torch.float32, device=dev)
    for _ in range(iters):
        assign = torch.argmin(_distances(flat, pos, centers, spatial_w), dim=1)
        sums = torch.zeros_like(centers).index_add_(0, assign, feat)
        cnts = torch.zeros(p, dtype=torch.float32,
                           device=dev).index_add_(0, assign, ones)
        new = sums / torch.clamp(cnts, min=1.0)[:, None]
        centers = torch.where(cnts[:, None] > 0, new, centers)
    return torch.argmin(_distances(flat, pos, centers, spatial_w),
                        dim=1).to(torch.int32)


def superpixels(image: np.ndarray, cell_size: float = 16.0,
                modifier: float = 130.0, iters: int = 10,
                device=device_policy.DEFAULT_DEVICE) -> SuperpixelData:
    """Cluster an [H, W, C] (or [H, W]) image into ~(H/cell)*(W/cell)
    superpixels on ``device`` ("cuda" by default; raises without CUDA).
    ``modifier`` balances color vs spatial distance, matching the
    reference's parameter naming (ref: Superpixel.scala:148)."""
    dev = device_policy.resolve(device)
    img = np.asarray(image, np.float32)
    if img.ndim == 2:
        img = img[..., None]
    if img.max() <= 1.5:  # normalize to the 0..255 scale `modifier` assumes
        img = img * 255.0
    h, w = img.shape[:2]
    grid_h = max(1, round(h / cell_size))
    grid_w = max(1, round(w / cell_size))
    ys, xs = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
    yx = np.stack([ys, xs], -1).astype(np.float32)
    # standard SLIC distance: d_color^2 + (modifier/S)^2 * d_spatial^2,
    # colors on the 0..255 scale
    spatial_w = (modifier / cell_size) ** 2
    assign = _slic(torch.from_numpy(img).to(dev), torch.from_numpy(yx).to(dev),
                   grid_h, grid_w, spatial_w, iters).cpu().numpy()
    # compact ids: drop empty clusters so states have no dead slots
    uniq, compact = np.unique(assign, return_inverse=True)
    return SuperpixelData(compact.reshape(h, w).astype(np.int32), len(uniq))

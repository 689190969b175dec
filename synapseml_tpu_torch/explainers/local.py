"""Model-agnostic local explainers: LIME + KernelSHAP for
tabular / vector / image / text inputs.

The counterpart of the reference package's ``explainers/local.py`` (itself
the re-design of ref: core/.../explainers/LocalExplainer.scala:16-130,
LIMEBase.scala:49-145, KernelSHAPBase.scala:36-125, TabularLIME/
TabularSHAP/VectorLIME/VectorSHAP/ImageLIME.scala:38/ImageSHAP.scala:35/
TextLIME/TextSHAP):
- sampling draws the whole [rows, samples, features] block at once from
  ``np.random.default_rng(seed)``, bitwise the reference's draws
- the model scores ONE flattened batch (rows*samples) per explained table,
  through ``model.transform(table, device)``: over a LightGBM model that
  is one launch of the forest traversal (K2) on the card
- every row's surrogate fit runs at once, batched over rows on ``device``
  (:mod:`synapseml_tpu_torch.explainers.surrogate`)

``transform(table, device="cuda")`` runs the model, the superpixels and the
fits on the card and raises without CUDA; ``device="cpu"`` runs them on the
CPU. Outputs: ``output_col`` holds a [K, D] (LIME) or [K, D+1] (SHAP, phi0
first) array per row, K = number of target classes, D = interpretable
features.
"""
from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np
import torch

from synapseml_tpu_torch import device as device_policy
from synapseml_tpu_torch.core.param import (ComplexParam, HasInputCol,
                                            HasOutputCol, Param)
from synapseml_tpu_torch.core.pipeline import Transformer
from synapseml_tpu_torch.data.table import Table
from synapseml_tpu_torch.explainers import samplers
from synapseml_tpu_torch.explainers.superpixel import (SuperpixelData,
                                                       superpixels)
from synapseml_tpu_torch.explainers.surrogate import (
    shap_weighted_fit, weighted_lasso, weighted_least_squares)


def _on(a: np.ndarray, dev: torch.device) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(dev)


class LocalExplainer(Transformer, HasOutputCol):
    """Common scoring plumbing (ref: LocalExplainer.scala:16-130)."""

    model = ComplexParam("the Transformer being explained")
    target_col = Param("model output column to explain", default="probability")
    target_classes = Param("indices into the output vector", default=(0,))
    num_samples = Param("perturbations per row", default=None)
    seed = Param("rng seed", default=0)

    _DEFAULT_SAMPLES = 100

    def _n_samples(self) -> int:
        return int(self.num_samples or self._DEFAULT_SAMPLES)

    def _score(self, table: Table, dev: torch.device) -> np.ndarray:
        """Model outputs restricted to target classes, [N, K]."""
        out = self.model.transform(table, dev)
        col = out[self.target_col]
        arr = np.asarray(np.stack(list(col)) if col.dtype == object else col,
                         np.float32)
        if arr.ndim == 1:
            arr = arr[:, None]
        classes = [c if c < arr.shape[1] else arr.shape[1] - 1
                   for c in self.target_classes]
        return arr[:, classes]

    def _replicate_others(self, table: Table, skip: Sequence[str],
                          n_samples: int) -> dict:
        """Repeat non-perturbed columns row-wise for the flattened batch."""
        rep = {}
        for c in table.columns:
            if c not in skip:
                rep[c] = np.repeat(table[c], n_samples, axis=0)
        return rep


class _LIMEFit:
    """LIME surrogate: kernel-weighted lasso on interpretable states
    (ref: LIMEBase.transform:67-115)."""

    kernel_width = Param("LIME kernel width", default=0.75)
    regularization = Param("lasso alpha (0 -> least squares)", default=0.0)

    def _fit_surrogate(self, states: np.ndarray, weights: np.ndarray,
                       y: np.ndarray, dev: torch.device) -> np.ndarray:
        """states [N,S,D], weights [N,S], y [N,S,K] -> coefs [N,K,D]."""
        st = _on(states, dev)
        w = _on(weights, dev)
        outs = []
        alpha = float(self.regularization)
        for ki in range(y.shape[-1]):
            yk = _on(y[..., ki], dev)
            if alpha > 0:
                coefs, _ = weighted_lasso(st, yk, w, alpha)
            else:
                coefs, _ = weighted_least_squares(st, yk, w)
            outs.append(coefs.cpu().numpy())
        return np.stack(outs, axis=1)  # [N, K, D]


class _SHAPFit:
    """KernelSHAP surrogate (ref: KernelSHAPBase.transform:42-94)."""

    def _fit_surrogate_shap(self, states: np.ndarray, weights: np.ndarray,
                            y: np.ndarray, fnull: np.ndarray,
                            dev: torch.device,
                            d_per_row: Optional[Sequence[int]] = None
                            ) -> np.ndarray:
        """states [N,S,D], weights [N,S], y [N,S,K], fnull [K] or [N,K]
        -> phis [N,K,D+1] (phi0 first). Sample 0 of every row must be the
        all-on coalition (it supplies f(x) for the efficiency constraint).

        ``d_per_row`` handles ragged features (text tokens / superpixels):
        rows are grouped by their true feature count and each group is fit on
        the unpadded [.., :d] slice — zero-padded phantom columns must never
        enter the constraint elimination."""
        n, s, d = states.shape
        k = y.shape[-1]
        fnull = np.broadcast_to(np.asarray(fnull, np.float32), (n, k))
        ds = (np.full(n, d, int) if d_per_row is None
              else np.asarray(list(d_per_row), int))
        out = np.zeros((n, k, d + 1), np.float32)
        for dv in np.unique(ds):
            idx = np.flatnonzero(ds == dv)
            st = _on(states[idx][:, :, :dv], dev)
            w = _on(weights[idx], dev)
            for ki in range(k):
                phis = shap_weighted_fit(st, _on(y[idx, :, ki], dev), w,
                                         _on(fnull[idx, ki], dev),
                                         _on(y[idx, 0, ki], dev))
                out[idx, ki, :dv + 1] = phis.cpu().numpy()
        return out  # [N, K, D+1]


# ---------------------------------------------------------------------------
# Vector explainers: input_col is a 2-D numeric features column
# ---------------------------------------------------------------------------

class _VectorBase(LocalExplainer, HasInputCol):
    background = ComplexParam(
        "background row [D] (default: column mean of the explained batch)",
        default=None)

    def _background(self, x: np.ndarray) -> np.ndarray:
        bg = self.background
        return (np.asarray(bg, np.float32) if bg is not None
                else x.mean(axis=0))

    def _score_perturbed(self, table: Table, perturbed: np.ndarray,
                         dev: torch.device) -> np.ndarray:
        n, s, d = perturbed.shape
        cols = self._replicate_others(table, [self.input_col, self.output_col], s)
        cols[self.input_col] = perturbed.reshape(n * s, d)
        k = len(list(self.target_classes))
        return self._score(Table(cols), dev).reshape(n, s, k)


class VectorLIME(_VectorBase, _LIMEFit):
    """LIME over a dense feature vector (ref: VectorLIME.scala)."""

    kernel_width = Param("LIME kernel width", default=0.75)
    regularization = Param("lasso alpha (0 -> least squares)", default=0.0)

    def _transform(self, table: Table, device) -> Table:
        dev = device_policy.resolve(device)
        x = np.asarray(table[self.input_col], np.float32)
        n, d = x.shape
        s = self._n_samples()
        rng = np.random.default_rng(int(self.seed))
        states = samplers.lime_state_samples(rng, n, s, d)
        weights = samplers.lime_kernel_weights(states, float(self.kernel_width))
        perturbed = samplers.apply_mask_background(x, states, self._background(x))
        y = self._score_perturbed(table, perturbed, dev)
        coefs = self._fit_surrogate(states, weights, y, dev)
        return table.with_column(self.output_col, coefs)


class VectorSHAP(_VectorBase, _SHAPFit):
    """KernelSHAP over a dense feature vector (ref: VectorSHAP.scala)."""

    def _transform(self, table: Table, device) -> Table:
        dev = device_policy.resolve(device)
        x = np.asarray(table[self.input_col], np.float32)
        n, d = x.shape
        s = self._n_samples()
        rng = np.random.default_rng(int(self.seed))
        states, weights = samplers.kernel_shap_samples(rng, n, s, d)
        bg = self._background(x)
        perturbed = samplers.apply_mask_background(x, states, bg)
        y = self._score_perturbed(table, perturbed, dev)
        # fnull = model on the all-background row
        null_t = Table({**self._replicate_others(table.slice(0, 1),
                                                 [self.input_col, self.output_col], 1),
                        self.input_col: bg.reshape(1, d)})
        fnull = self._score(null_t, dev)[0]
        phis = self._fit_surrogate_shap(states, weights, y, fnull, dev)
        return table.with_column(self.output_col, phis)


# ---------------------------------------------------------------------------
# Tabular explainers: input_cols are scalar numeric columns
# ---------------------------------------------------------------------------

class _TabularBase(LocalExplainer):
    input_cols = Param("numeric columns to explain", default=None)
    background_data = ComplexParam(
        "background Table for feature stats (default: the explained table)",
        default=None)

    def _matrix(self, table: Table) -> np.ndarray:
        return np.column_stack([
            np.asarray(table[c], np.float32) for c in self.input_cols])

    def _stats(self, table: Table):
        bg = self.background_data if self.background_data is not None else table
        m = self._matrix(bg)
        return m.mean(axis=0), m.std(axis=0) + 1e-12

    def _score_perturbed(self, table: Table, perturbed: np.ndarray,
                         dev: torch.device) -> np.ndarray:
        n, s, d = perturbed.shape
        flat = perturbed.reshape(n * s, d)
        cols = self._replicate_others(
            table, list(self.input_cols) + [self.output_col], s)
        for j, c in enumerate(self.input_cols):
            cols[c] = flat[:, j].astype(np.float64)
        k = len(list(self.target_classes))
        return self._score(Table(cols), dev).reshape(n, s, k)


class TabularLIME(_TabularBase, _LIMEFit):
    """LIME over raw table columns: off-features resample from background
    stats (ref: TabularLIME.scala:160)."""

    kernel_width = Param("LIME kernel width", default=0.75)
    regularization = Param("lasso alpha (0 -> least squares)", default=0.0)

    def _transform(self, table: Table, device) -> Table:
        dev = device_policy.resolve(device)
        x = self._matrix(table)
        n, d = x.shape
        s = self._n_samples()
        rng = np.random.default_rng(int(self.seed))
        mean, std = self._stats(table)
        states = samplers.lime_state_samples(rng, n, s, d)
        weights = samplers.lime_kernel_weights(states, float(self.kernel_width))
        perturbed = samplers.tabular_value_samples(rng, states, x, mean, std)
        y = self._score_perturbed(table, perturbed, dev)
        coefs = self._fit_surrogate(states, weights, y, dev)
        return table.with_column(self.output_col, coefs)


class TabularSHAP(_TabularBase, _SHAPFit):
    """KernelSHAP over raw table columns (ref: TabularSHAP.scala)."""

    def _transform(self, table: Table, device) -> Table:
        dev = device_policy.resolve(device)
        x = self._matrix(table)
        n, d = x.shape
        s = self._n_samples()
        rng = np.random.default_rng(int(self.seed))
        mean, _ = self._stats(table)
        states, weights = samplers.kernel_shap_samples(rng, n, s, d)
        perturbed = samplers.apply_mask_background(x, states, mean)
        y = self._score_perturbed(table, perturbed, dev)
        null_cols = self._replicate_others(
            table.slice(0, 1), list(self.input_cols) + [self.output_col], 1)
        for j, c in enumerate(self.input_cols):
            null_cols[c] = np.asarray([mean[j]], np.float64)
        fnull = self._score(Table(null_cols), dev)[0]
        phis = self._fit_surrogate_shap(states, weights, y, fnull, dev)
        return table.with_column(self.output_col, phis)


# ---------------------------------------------------------------------------
# Text explainers: input_col is a string column; tokens are the features
# ---------------------------------------------------------------------------

def _obj_col(values):
    arr = np.empty(len(values), dtype=object)
    for i, v in enumerate(values):
        arr[i] = v
    return arr


class _TextBase(LocalExplainer, HasInputCol):
    tokens_col = Param("output column holding the token list", default="tokens")

    def _explain_text(self, table: Table, use_shap: bool, device) -> Table:
        dev = device_policy.resolve(device)
        texts = [str(v) for v in table[self.input_col]]
        token_lists = [t.split() for t in texts]
        n = len(texts)
        s = self._n_samples()
        max_d = max((len(t) for t in token_lists), default=1) or 1
        rng = np.random.default_rng(int(self.seed))
        k = len(list(self.target_classes))
        states = np.zeros((n, s, max_d), np.float32)
        weights = np.zeros((n, s), np.float32)
        flat_texts: List[str] = []
        for r, toks in enumerate(token_lists):
            d = max(len(toks), 1)
            if use_shap:
                st, w = samplers.kernel_shap_samples(rng, 1, s, d)
                st, w = st[0], w[0]
            else:
                st = samplers.lime_state_samples(rng, 1, s, d)[0]
                w = samplers.lime_kernel_weights(
                    st, float(self.get("kernel_width", 0.75) or 0.75))[0]
            states[r, :, :d] = st
            weights[r] = w
            for si in range(s):
                kept = [t for t, on in zip(toks, st[si]) if on > 0.5]
                flat_texts.append(" ".join(kept))
        cols = self._replicate_others(table, [self.input_col, self.output_col], s)
        cols[self.input_col] = np.array(flat_texts, dtype=object)
        y = self._score(Table(cols), dev).reshape(n, s, k)
        if use_shap:
            null_cols = self._replicate_others(
                table.slice(0, 1), [self.input_col, self.output_col], 1)
            null_cols[self.input_col] = np.array([""], dtype=object)
            fnull = self._score(Table(null_cols), dev)[0]
            out = self._fit_surrogate_shap(
                states, weights, y, fnull, dev,
                d_per_row=[max(len(t), 1) for t in token_lists])
        else:
            out = self._fit_surrogate(states, weights, y, dev)
        return (table
                .with_column(self.output_col, out)
                .with_column(self.tokens_col,
                             np.array(token_lists, dtype=object)
                             if len({len(t) for t in token_lists}) > 1
                             else _obj_col(token_lists)))


class TextLIME(_TextBase, _LIMEFit):
    """Token-masking LIME (ref: TextLIME.scala)."""

    kernel_width = Param("LIME kernel width", default=0.75)
    regularization = Param("lasso alpha", default=0.0)

    def _transform(self, table: Table, device) -> Table:
        return self._explain_text(table, False, device)


class TextSHAP(_TextBase, _SHAPFit):
    """Token-coalition KernelSHAP (ref: TextSHAP.scala)."""

    def _transform(self, table: Table, device) -> Table:
        return self._explain_text(table, True, device)


# ---------------------------------------------------------------------------
# Image explainers: input_col holds [H, W, C] arrays; superpixels are features
# ---------------------------------------------------------------------------

class _ImageBase(LocalExplainer, HasInputCol):
    cell_size = Param("superpixel cell size", default=16.0)
    modifier = Param("superpixel color/spatial balance", default=130.0)
    background_value = Param("fill for masked superpixels", default=0.0)
    superpixel_col = Param("output column with [H, W] assignments",
                           default="superpixels")

    def _explain_images(self, table: Table, use_shap: bool, device) -> Table:
        dev = device_policy.resolve(device)
        images = [np.asarray(v, np.float32) for v in table[self.input_col]]
        n = len(images)
        s = self._n_samples()
        k = len(list(self.target_classes))
        sps: List[SuperpixelData] = [
            superpixels(img, float(self.cell_size), float(self.modifier),
                        device=dev)
            for img in images]
        max_d = max(sp.num_clusters for sp in sps)
        rng = np.random.default_rng(int(self.seed))
        states = np.zeros((n, s, max_d), np.float32)
        weights = np.zeros((n, s), np.float32)
        flat_imgs: List[np.ndarray] = []
        bgv = float(self.background_value)
        for r, (img, sp) in enumerate(zip(images, sps)):
            d = sp.num_clusters
            if use_shap:
                st, w = samplers.kernel_shap_samples(rng, 1, s, d)
                st, w = st[0], w[0]
            else:
                st = samplers.lime_state_samples(rng, 1, s, d)[0]
                w = samplers.lime_kernel_weights(
                    st, float(self.get("kernel_width", 0.75) or 0.75))[0]
            states[r, :, :d] = st
            weights[r] = w
            for si in range(s):
                flat_imgs.append(sp.masked_image(img, st[si, :d], bgv))
        cols = self._replicate_others(table, [self.input_col, self.output_col], s)
        cols[self.input_col] = _obj_col(flat_imgs)
        y = self._score(Table(cols), dev).reshape(n, s, k)
        if use_shap:
            null_cols = self._replicate_others(
                table.slice(0, 1), [self.input_col, self.output_col], 1)
            null_cols[self.input_col] = _obj_col(
                [np.full_like(images[0], bgv)])
            fnull = self._score(Table(null_cols), dev)[0]
            out = self._fit_surrogate_shap(
                states, weights, y, fnull, dev,
                d_per_row=[sp.num_clusters for sp in sps])
        else:
            out = self._fit_surrogate(states, weights, y, dev)
        return (table
                .with_column(self.output_col, out)
                .with_column(self.superpixel_col,
                             _obj_col([sp.assignment for sp in sps])))


class ImageLIME(_ImageBase, _LIMEFit):
    """Superpixel-masking LIME (ref: ImageLIME.scala:38)."""

    kernel_width = Param("LIME kernel width", default=0.75)
    regularization = Param("lasso alpha", default=0.0)
    _DEFAULT_SAMPLES = 50

    def _transform(self, table: Table, device) -> Table:
        return self._explain_images(table, False, device)


class ImageSHAP(_ImageBase, _SHAPFit):
    """Superpixel-coalition KernelSHAP (ref: ImageSHAP.scala:35)."""

    _DEFAULT_SAMPLES = 50

    def _transform(self, table: Table, device) -> Table:
        return self._explain_images(table, True, device)

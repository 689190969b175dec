"""Feature binning for the histogram GBDT engine (numpy, host side).

The port's own copy of ``synapseml_tpu/gbdt/binning.py``. The reference gets
binning free from lib_lightgbm's C++ BinMapper (the JNI jar behind
lightgbm/.../dataset/DatasetAggregator.scala). Here rows are binned on the
host once into a uint8 matrix (max 255 bins + missing bin; uint16 above 256
total bins), the only representation shipped to the device, so every
downstream op (histogram build, split application) reads integer bins.

Bin semantics follow LightGBM: quantile (equal-count) boundaries over distinct
values, a dedicated missing bin, categorical features binned by category id.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence

import numpy as np


@dataclasses.dataclass
class BinInfo:
    """Per-feature binning metadata."""
    upper_bounds: np.ndarray          # [n_bins-?] float64 boundaries for numeric
    is_categorical: bool = False
    categories: Optional[np.ndarray] = None   # category value per bin
    n_bins: int = 0                   # data bins (excluding the missing bin)


class BinMapper:
    """Fit quantile bins on host data; transform to uint8 bin indices.

    Missing values map to bin ``n_bins`` (the last, dedicated missing bin).
    """

    def __init__(self, max_bin: int = 255, categorical_features: Sequence[int] = (),
                 max_cat: int = 255, subsample: int = 200_000, seed: int = 0):
        self.max_bin = int(max_bin)
        self.categorical_features = set(int(c) for c in categorical_features)
        self.max_cat = int(max_cat)
        self.subsample = subsample
        self.seed = seed
        self.bins_: List[BinInfo] = []
        self.n_features_: int = 0

    # -- fitting -------------------------------------------------------
    def fit(self, x: np.ndarray) -> "BinMapper":
        x = np.asarray(x, dtype=np.float64)
        n, f = x.shape
        self.n_features_ = f
        if n > self.subsample:
            rng = np.random.default_rng(self.seed)
            x = x[rng.choice(n, self.subsample, replace=False)]
        self.bins_ = []
        for j in range(f):
            col = x[:, j]
            if j in self.categorical_features:
                self.bins_.append(self._fit_categorical(col))
            else:
                self.bins_.append(self._fit_numeric(col))
        return self

    def _fit_numeric(self, col: np.ndarray) -> BinInfo:
        finite = col[np.isfinite(col)]
        if finite.size == 0:
            return BinInfo(upper_bounds=np.asarray([np.inf]), n_bins=1)
        distinct = np.unique(finite)
        if distinct.size <= self.max_bin:
            # boundary = midpoint between consecutive distinct values
            uppers = np.concatenate(
                [(distinct[:-1] + distinct[1:]) / 2.0, [np.inf]])
        else:
            qs = np.linspace(0, 1, self.max_bin + 1)[1:-1]
            cuts = np.unique(np.quantile(finite, qs))
            uppers = np.concatenate([cuts, [np.inf]])
        return BinInfo(upper_bounds=uppers, n_bins=len(uppers))

    def _fit_categorical(self, col: np.ndarray) -> BinInfo:
        finite = col[np.isfinite(col)]
        cats, counts = np.unique(finite.astype(np.int64), return_counts=True)
        if cats.size > self.max_cat:
            cats = cats[np.argsort(-counts)][: self.max_cat]
            cats = np.sort(cats)
        return BinInfo(upper_bounds=np.asarray([]), is_categorical=True,
                       categories=cats, n_bins=max(len(cats), 1))

    # -- transform -----------------------------------------------------
    @property
    def total_bins(self) -> int:
        """Max bins over features incl. the missing bin (device array width)."""
        return max(b.n_bins for b in self.bins_) + 1

    def missing_bin(self, j: int) -> int:
        return self.bins_[j].n_bins

    def transform(self, x: np.ndarray) -> np.ndarray:
        x = np.asarray(x, dtype=np.float64)
        n, f = x.shape
        assert f == self.n_features_, (f, self.n_features_)
        out = np.empty((n, f), dtype=np.uint8 if self.total_bins <= 256 else np.uint16)
        for j in range(f):
            info = self.bins_[j]
            col = x[:, j]
            miss = ~np.isfinite(col)
            if info.is_categorical:
                idx = np.searchsorted(info.categories, col.astype(np.int64,
                                                                  casting="unsafe"))
                idx = np.clip(idx, 0, len(info.categories) - 1)
                known = np.zeros(n, dtype=bool)
                ok = ~miss
                known[ok] = info.categories[idx[ok]] == col[ok].astype(np.int64)
                b = np.where(known, idx, info.n_bins)
            else:
                b = np.searchsorted(info.upper_bounds, col, side="left")
                b = np.where(miss, info.n_bins, np.minimum(b, info.n_bins - 1))
            out[:, j] = b
        return out

    def bin_upper_value(self, j: int, b: int) -> float:
        """Numeric threshold for 'goes left if value <= threshold' at bin b."""
        info = self.bins_[j]
        if info.is_categorical:
            return float(info.categories[min(b, len(info.categories) - 1)])
        return float(info.upper_bounds[min(b, info.n_bins - 1)])

    def threshold_values(self) -> np.ndarray:
        """[F, B] array: split value for (feature, bin) pairs (device-side)."""
        bmax = self.total_bins
        out = np.full((self.n_features_, bmax), np.inf, dtype=np.float64)
        for j, info in enumerate(self.bins_):
            if info.is_categorical:
                vals = info.categories.astype(np.float64)
                out[j, :len(vals)] = vals
            else:
                out[j, :info.n_bins] = info.upper_bounds
        return out

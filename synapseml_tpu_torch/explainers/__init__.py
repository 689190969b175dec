"""Local explainers of the port: LIME and KernelSHAP over vectors, table
columns, text and images, the superpixels and the surrogate solvers.

The counterpart of the reference package's ``explainers/``.
"""
from synapseml_tpu_torch.explainers.local import (
    ImageLIME,
    ImageSHAP,
    LocalExplainer,
    TabularLIME,
    TabularSHAP,
    TextLIME,
    TextSHAP,
    VectorLIME,
    VectorSHAP,
)
from synapseml_tpu_torch.explainers.superpixel import SuperpixelData, superpixels
from synapseml_tpu_torch.explainers.surrogate import (
    weighted_lasso,
    weighted_least_squares,
)

__all__ = [
    "ImageLIME", "ImageSHAP", "LocalExplainer", "TabularLIME", "TabularSHAP",
    "TextLIME", "TextSHAP", "VectorLIME", "VectorSHAP", "SuperpixelData",
    "superpixels", "weighted_lasso", "weighted_least_squares",
]

"""IO layer of the port: the binary file reader.

The counterpart of the reference package's ``io/``; only ``io.binary``
(directory and zip traversal with seeded subsampling, which the image
reader stands on) is ported. HTTP, serving and PowerBI are not ported yet
(ROADMAP Queue 1 items 3 and 6).
"""
from synapseml_tpu_torch.io.binary import read_binary_files  # noqa: F401

__all__ = ["read_binary_files"]

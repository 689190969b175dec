"""IO layer of the port: the binary file reader and serving.

The counterpart of the reference package's ``io/``: ``io.binary``
(directory and zip traversal with seeded subsampling, which the image
reader stands on), ``io.http``'s request/response data classes and
``io.serving`` (the single serving front end and its container entry,
``python -m synapseml_tpu_torch.io.serving``, with ``POST /generate``
and ``--decode`` over ``runtime/decode.py``). ``DistributedServer``, the
HTTP client transformers and PowerBI are not ported yet (ROADMAP Queue 1
items 3b and 6).
"""
from synapseml_tpu_torch.io.binary import read_binary_files  # noqa: F401

__all__ = ["read_binary_files"]

"""IO layer of the port: the binary file reader and serving.

The counterpart of the reference package's ``io/``: ``io.binary``
(directory and zip traversal with seeded subsampling, which the image
reader stands on), ``io.http``'s request/response data classes and
``io.serving`` (the serving front end and its container entry,
``python -m synapseml_tpu_torch.io.serving``, with ``POST /generate``
and ``--decode`` over ``runtime/decode.py``; ``DistributedServer``, its
``MultiChannelMap`` and the channel circuit breakers). The HTTP client
transformers and PowerBI are not ported yet (ROADMAP Queue 1 item 6).
"""
from synapseml_tpu_torch.io.binary import read_binary_files  # noqa: F401
from synapseml_tpu_torch.io.serving import (  # noqa: F401
    BREAKER_CLOSED, BREAKER_HALF_OPEN, BREAKER_OPEN, DistributedServer,
    MultiChannelMap, device_for_channel)

__all__ = ["read_binary_files", "DistributedServer", "MultiChannelMap",
           "device_for_channel", "BREAKER_CLOSED", "BREAKER_OPEN",
           "BREAKER_HALF_OPEN"]

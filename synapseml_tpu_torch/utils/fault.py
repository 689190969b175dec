"""Fault-tolerance utilities: the exponential-backoff retry used around
network init.

Copy of ``retry_with_backoff`` from ``synapseml_tpu/utils/fault.py:44-58``
(ref: lightgbm/.../TrainUtils.scala:279-295 networkInit backoff retries);
nothing else of that module is needed by the port.
"""
from __future__ import annotations

import logging
import time
from typing import Callable, Optional, Tuple, Type, TypeVar

T = TypeVar("T")
logger = logging.getLogger("synapseml_tpu_torch")


def retry_with_backoff(fn: Callable[[], T],
                       backoffs_ms: Tuple[int, ...] = (100, 500, 1000, 5000),
                       retryable: Tuple[Type[BaseException], ...] = (Exception,)
                       ) -> T:
    """Exponential-backoff retry (ref: TrainUtils.networkInit:279-295)."""
    last: Optional[BaseException] = None
    for i in range(len(backoffs_ms) + 1):
        try:
            return fn()
        except retryable as e:
            last = e
            if i < len(backoffs_ms):
                logger.warning("retrying after %dms: %s", backoffs_ms[i], e)
                time.sleep(backoffs_ms[i] / 1000.0)
    raise last  # type: ignore[misc]

"""Bounded retry of checkpoint IO: the port of modalities_tpu/resilience/retry.py.

Transient storage errors (a flaky network mount) cost a retry, not the run:
`retry_io` runs a function again after an `OSError`, with exponential backoff
and jitter, a bounded number of times, and then re-raises the last error
unchanged. Each retry is logged at warning level (the JAX package also records
a telemetry span and event: the trainer's telemetry, ROADMAP.md Queue 1 item 6).

The defaults are read from the environment, as in the JAX package:
- ``MODALITIES_TPU_IO_RETRY_ATTEMPTS`` (default 4 attempts in all)
- ``MODALITIES_TPU_IO_RETRY_BASE_S``   (default 0.5 s; doubled a retry, plus jitter)
"""

from __future__ import annotations

import logging
import os
import random
import time
from typing import Callable, Optional, TypeVar

logger = logging.getLogger(__name__)

T = TypeVar("T")

MAX_DELAY_S = 30.0


def retry_io(fn: Callable[[], T], what: str, attempts: Optional[int] = None,
             base_delay_s: Optional[float] = None) -> T:
    """Run `fn`, retrying an OSError with exponential backoff and jitter; the
    last failure re-raises the last exception."""
    attempts = attempts if attempts is not None else int(os.environ.get("MODALITIES_TPU_IO_RETRY_ATTEMPTS", "4"))
    if base_delay_s is None:
        base_delay_s = float(os.environ.get("MODALITIES_TPU_IO_RETRY_BASE_S", "0.5"))
    attempts = max(attempts, 1)
    for attempt in range(attempts):
        try:
            return fn()
        except OSError as e:
            if attempt + 1 >= attempts:
                raise
            delay = min(base_delay_s * (2**attempt), MAX_DELAY_S) * (1.0 + random.uniform(0.0, 0.25))
            logger.warning("%s failed (attempt %d/%d): %r; retrying in %.2f s", what, attempt + 1, attempts, e, delay)
            time.sleep(delay)
    raise AssertionError("unreachable")

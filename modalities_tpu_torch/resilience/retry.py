"""Bounded retry of checkpoint IO: the port of modalities_tpu/resilience/retry.py.

Transient storage errors (a flaky network mount) cost a retry, not the run:
`retry_io` runs a function again after an `OSError`, with exponential backoff
and jitter, a bounded number of times, and then re-raises the last error
unchanged. Each retry is logged at warning level and recorded as a
``ckpt_retry/attempt`` event, and every attempt after the first runs under a
``ckpt_retry/<what>`` telemetry span (goodput bucket: recovery). The
``checkpoint_io_error`` fault point (faults.py) fires inside each attempt.

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
    from modalities_tpu_torch.resilience.events import record_event
    from modalities_tpu_torch.resilience.faults import fire_io_error_if_armed
    from modalities_tpu_torch.telemetry import span
    from modalities_tpu_torch.telemetry.spans import NULL_CONTEXT

    attempts = max(attempts, 1)
    for attempt in range(attempts):
        try:
            with span(f"ckpt_retry/{what}") if attempt else NULL_CONTEXT:
                fire_io_error_if_armed()
                return fn()
        except OSError as e:
            if attempt + 1 >= attempts:
                raise
            delay = min(base_delay_s * (2**attempt), MAX_DELAY_S) * (1.0 + random.uniform(0.0, 0.25))
            record_event("ckpt_retry/attempt", what=what, attempt=attempt + 1, error=repr(e),
                         next_delay_s=round(delay, 3))
            logger.warning("%s failed (attempt %d/%d): %r; retrying in %.2f s", what, attempt + 1, attempts, e, delay)
            time.sleep(delay)
    raise AssertionError("unreachable")

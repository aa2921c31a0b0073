"""The `performance.xla_flags` component, accepted so the JAX training configs
load unchanged. Its knobs set TPU runtime flags (LIBTPU_INIT_ARGS); on the
card they mean nothing, and building the component logs that once."""

from __future__ import annotations

import dataclasses
import logging
from typing import Optional

logger = logging.getLogger(__name__)


@dataclasses.dataclass
class XlaPerformanceFlags:
    latency_hiding_scheduler: bool = True
    async_collectives: bool = True
    dcn_collective_overlap: bool = False
    all_gather_combine_threshold_bytes: Optional[int] = None
    reduce_scatter_combine_threshold_bytes: Optional[int] = None
    all_reduce_combine_threshold_bytes: Optional[int] = None
    extra_libtpu_args: list = dataclasses.field(default_factory=list)
    extra_xla_flags: list = dataclasses.field(default_factory=list)

    def __post_init__(self):
        logger.info("performance.xla_flags: TPU runtime flags, not applied on the CUDA port (%s)",
                    dataclasses.asdict(self))

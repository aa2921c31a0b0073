"""Performance-attribution scope, runtime part: the port of
modalities_tpu/telemetry/perfscope.py's profiler capture windows and
step-time anomaly detection.

1. **Profiler capture windows.** `ProfileWindow.from_env()` parses
   `MODALITIES_TPU_PROFILE_AT_STEP=N[:K]` and records steps [N, N+K) with
   `torch.profiler.profile` (CPU activity, plus CUDA on a card), then writes
   a Chrome trace (`profile_rank_<r>_steps_<N>-<N+K-1>.json`) into
   `MODALITIES_TPU_PROFILE_DIR`, or else the folder the trainer passes (its
   telemetry folder). The trainer calls `maybe_start`/`maybe_stop`
   unconditionally; both are no-ops outside the window. Capture never
   changes a step's result: only host-side trace collection toggles. A
   profiler failure is logged, never raised, as in the JAX package.
2. **Anomaly detection.** `AnomalyDetector` keeps a rolling window and scores
   each observation with a robust z (median/MAD, 0.6745 normalization) plus an
   EWMA; the `Telemetry` facade feeds per-step wall time and per-goodput-bucket
   deltas through detectors into the metrics registry
   (`training_step_time_anomaly_total`, `training_goodput_bucket_zscore`).

The JAX module's static HLO cost walk (`analyze_hlo_text`,
`perfscope_for_config`) is ROADMAP.md Queue 1 item 6's next part.
"""

from __future__ import annotations

import json
import logging
import math
import os
import statistics
from collections import deque
from dataclasses import dataclass
from pathlib import Path
from typing import Optional, Union

logger = logging.getLogger(__name__)

PROFILE_ENV = "MODALITIES_TPU_PROFILE_AT_STEP"
PROFILE_DIR_ENV = "MODALITIES_TPU_PROFILE_DIR"


def write_report(report: dict, path: Union[str, Path]) -> Path:
    """Atomic JSON write (a temp file, then a rename)."""
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    tmp = path.with_suffix(path.suffix + ".tmp")
    with open(tmp, "w") as f:
        json.dump(report, f, indent=1)
    tmp.rename(path)
    return path


def parse_window(raw: str, env_name: str, what: str) -> tuple[int, int]:
    """`N` -> (N, 1), `N:K` -> (N, K); anything else raises JAX's ValueError."""
    try:
        if ":" in raw:
            start_s, num_s = raw.split(":", 1)
            return int(start_s), int(num_s)
        return int(raw), 1
    except ValueError as e:
        raise ValueError(f"{env_name}={raw!r}: expected N or N:K ({what} K steps starting at step N)") from e


# ------------------------------------------------------------- profiler windows


class ProfileWindow:
    """A `torch.profiler` capture armed by env var: started right before step
    N, stopped after step N+K-1 (`MODALITIES_TPU_PROFILE_AT_STEP=N` or `N:K`),
    its Chrome trace written to `out_dir` (`MODALITIES_TPU_PROFILE_DIR`, or
    the `fallback_dir` the trainer passes)."""

    def __init__(self, start_step: int, num_steps: int = 1, out_dir: Optional[Path] = None, global_rank: int = 0):
        if num_steps < 1:
            raise ValueError(f"profile window needs num_steps >= 1, got {num_steps}")
        self.start_step = int(start_step)
        self.num_steps = int(num_steps)
        self.out_dir = Path(out_dir) if out_dir is not None else None
        self.global_rank = int(global_rank)
        self.active = False
        self.completed = False
        self.trace_path: Optional[Path] = None
        self._profiler = None

    @classmethod
    def from_env(cls, fallback_dir: Optional[Path] = None, global_rank: int = 0) -> Optional["ProfileWindow"]:
        raw = os.environ.get(PROFILE_ENV, "").strip()
        if not raw:
            return None
        start, num = parse_window(raw, PROFILE_ENV, "capture")
        out = os.environ.get(PROFILE_DIR_ENV)
        return cls(start, num, Path(out) if out else fallback_dir, global_rank=global_rank)

    def maybe_start(self, step_id: int) -> bool:
        """Call before dispatching `step_id`; starts the capture on the
        window's first step. Returns True while capture runs."""
        if self.active:
            return True
        if self.completed or step_id != self.start_step:
            return False
        try:
            import torch
            from torch.profiler import ProfilerActivity, profile

            activities = [ProfilerActivity.CPU]
            if torch.cuda.is_available():
                activities.append(ProfilerActivity.CUDA)
                torch.cuda.synchronize()  # earlier steps' device work stays out of the window
            self._profiler = profile(activities=activities)
            self._profiler.start()
            self.active = True
            logger.info("perfscope: profiler capture started at step %d for %d step(s) -> %s", step_id,
                        self.num_steps, self._out_dir())
        except Exception:
            logger.exception("perfscope: profiler start failed; window disabled")
            self._profiler = None
            self.completed = True
        return self.active

    def _out_dir(self) -> Path:
        return self.out_dir or Path(os.getcwd()) / "profile"

    def maybe_stop(self, step_id: int, block_on=None) -> bool:
        """Call after `step_id` completed; stops the capture once the window's
        last step is done and writes the trace. Returns True if capture
        stopped on this call. The card is synchronized first (JAX blocks on
        `block_on`), so the captured steps' device work is in the trace."""
        if not self.active or step_id < self.start_step + self.num_steps - 1:
            return False
        try:
            import torch

            if torch.cuda.is_available():
                torch.cuda.synchronize()
            self._profiler.stop()
            end = self.start_step + self.num_steps - 1
            out_dir = self._out_dir()
            out_dir.mkdir(parents=True, exist_ok=True)
            path = out_dir / f"profile_rank_{self.global_rank}_steps_{self.start_step}-{end}.json"
            self._profiler.export_chrome_trace(str(path))
            self.trace_path = path
            logger.info("perfscope: profiler capture stopped after step %d -> %s", step_id, path)
        except Exception:
            logger.exception("perfscope: profiler stop failed")
        self._profiler = None
        self.active = False
        self.completed = True
        return True


# ----------------------------------------------------------- anomaly detection


@dataclass
class Anomaly:
    value: float
    zscore: float
    ewma: float
    is_anomaly: bool


class AnomalyDetector:
    """Rolling robust z-score + EWMA over a univariate stream (per-step wall
    time, per-bucket goodput seconds). Robust z = 0.6745 * (v - median) / MAD —
    outliers in the window don't inflate their own yardstick the way a plain
    stdev z does. No verdicts until `min_history` observations; a zero MAD
    (constant window) scores any deviation as `inf`."""

    def __init__(
        self,
        window: int = 64,
        zscore_threshold: float = 6.0,
        min_history: int = 8,
        ewma_alpha: float = 0.2,
    ):
        if window < 2:
            raise ValueError(f"anomaly window must be >= 2, got {window}")
        self.window: deque[float] = deque(maxlen=int(window))
        self.zscore_threshold = float(zscore_threshold)
        self.min_history = max(2, int(min_history))
        self.ewma_alpha = float(ewma_alpha)
        self.ewma: Optional[float] = None
        self.anomalies = 0

    def observe(self, value: float) -> Anomaly:
        value = float(value)
        self.ewma = (
            value if self.ewma is None
            else self.ewma_alpha * value + (1.0 - self.ewma_alpha) * self.ewma
        )
        z = 0.0
        if len(self.window) >= self.min_history:
            med = statistics.median(self.window)
            mad = statistics.median(abs(v - med) for v in self.window)
            dev = value - med
            if mad > 0.0:
                z = 0.6745 * dev / mad
            elif dev != 0.0:
                z = math.copysign(math.inf, dev)
        is_anomaly = z > self.zscore_threshold  # one-sided: slow is the anomaly
        if is_anomaly:
            self.anomalies += 1
        self.window.append(value)
        return Anomaly(value=value, zscore=z, ewma=self.ewma, is_anomaly=is_anomaly)

"""Hang watchdog: the port of modalities_tpu/telemetry/watchdog.py. It
detects a wedged step (a train step, or a serving dispatch) and dumps a
crash artifact before the job is killed.

Protocol: the loop `arm()`s the watchdog before its first dispatch and
`beat()`s after every completed one; each beat re-arms the deadline. A
background thread checks the deadline; when it expires it writes ONE
artifact per armed period: every thread's Python stack, the device memory
stats (telemetry/device_memory.py, the JAX key names), what the registered
state providers report (the serving engine's published stats snapshot),
the metrics registry's snapshot and the weights generation, then keeps
waiting so a later beat can re-arm it. `disarm()` suspends checking (idle
is not a hang); `stop()` joins the thread and is safe in `finally`.
"""

from __future__ import annotations

import json
import logging
import sys
import threading
import time
import traceback
from pathlib import Path
from typing import Callable, Optional

logger = logging.getLogger(__name__)


def collect_thread_stacks() -> dict[str, list[str]]:
    """Formatted Python stacks for every live thread, keyed "name (ident)"."""
    names = {thread.ident: thread.name for thread in threading.enumerate()}
    stacks = {}
    for ident, frame in sys._current_frames().items():
        key = f"{names.get(ident, '?')} ({ident})"
        stacks[key] = traceback.format_stack(frame)
    return stacks


def _collect_device_memory() -> dict:
    try:
        from modalities_tpu_torch.telemetry.device_memory import device_memory_stats

        return device_memory_stats()
    except Exception as e:
        return {"error": repr(e)}


class Watchdog:
    """Background heartbeat monitor. All public methods are thread-safe; start()
    is lazy-idempotent and the thread is a daemon so a hard crash elsewhere never
    hangs interpreter shutdown on it."""

    def __init__(
        self,
        deadline_s: float,
        artifact_dir: Path,
        global_rank: int = 0,
        poll_interval_s: float = 0.05,
        metrics_provider: Optional[Callable[[], dict]] = None,
    ):
        if deadline_s <= 0:
            raise ValueError(f"watchdog deadline_s must be > 0, got {deadline_s}")
        self.deadline_s = float(deadline_s)
        self.artifact_dir = Path(artifact_dir)
        self.global_rank = global_rank
        self._poll_interval_s = poll_interval_s
        # the process's metrics snapshot rides the artifact: a hang dump
        # without counters cannot be lined up against the scrape history
        self._metrics_provider = metrics_provider
        self._lock = threading.Lock()
        self._stop_event = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._deadline_at: Optional[float] = None  # monotonic; None = disarmed
        self._armed_step: Optional[int] = None
        self._fired_for_armed_period = False
        self._state_providers: list[Callable[[], dict]] = []
        self.fired_artifacts: list[Path] = []

    # ------------------------------------------------------------- lifecycle

    def start(self) -> None:
        with self._lock:
            if self._thread is not None:
                return
            self._stop_event.clear()
            self._thread = threading.Thread(target=self._run, name="telemetry-watchdog", daemon=True)
            self._thread.start()

    def stop(self) -> None:
        with self._lock:
            thread = self._thread
            self._thread = None
        self._stop_event.set()
        if thread is not None:
            thread.join(timeout=10.0)

    @property
    def is_alive(self) -> bool:
        thread = self._thread
        return thread is not None and thread.is_alive()

    # ------------------------------------------------------------- heartbeat

    def arm(self, step_id: int, deadline_s: Optional[float] = None) -> None:
        """Arm (or re-arm) the deadline for the step about to run. Pass a custom
        deadline_s for steps with a known longer budget (first step = compile)."""
        with self._lock:
            self._deadline_at = time.monotonic() + (deadline_s or self.deadline_s)
            self._armed_step = step_id
            self._fired_for_armed_period = False

    def beat(self, step_id: int) -> None:
        """A step completed: re-arm the deadline for the next one."""
        self.arm(step_id + 1)

    def disarm(self) -> None:
        with self._lock:
            self._deadline_at = None
            self._armed_step = None

    def register_state_provider(self, provider: Callable[[], dict]) -> None:
        """Provider returns a JSON-safe dict merged into the artifact's `state`
        section (e.g. the device feeder's queue snapshot)."""
        with self._lock:
            self._state_providers.append(provider)

    # ------------------------------------------------------------- internals

    def _run(self) -> None:
        while not self._stop_event.wait(self._poll_interval_s):
            with self._lock:
                deadline_at = self._deadline_at
                fired = self._fired_for_armed_period
                armed_step = self._armed_step
            if deadline_at is None or fired:
                continue
            overdue_s = time.monotonic() - deadline_at
            if overdue_s < 0:
                continue
            with self._lock:
                # re-check under the lock: a beat may have raced the dump decision
                if self._deadline_at != deadline_at or self._fired_for_armed_period:
                    continue
                self._fired_for_armed_period = True
            try:
                self._dump(armed_step, overdue_s)
            except Exception:
                logger.exception("watchdog artifact dump failed")

    def _dump(self, armed_step: Optional[int], overdue_s: float) -> Path:
        with self._lock:
            providers = list(self._state_providers)
        state = {}
        for provider in providers:
            try:
                state.update(provider())
            except Exception as e:
                state[f"provider_error_{len(state)}"] = repr(e)
        metrics_snapshot = None
        if self._metrics_provider is not None:
            try:
                metrics_snapshot = self._metrics_provider()
            except Exception as e:
                metrics_snapshot = {"error": repr(e)}
        artifact = {
            "event": "watchdog_fired",
            "rank": self.global_rank,
            "armed_step": armed_step,
            "deadline_s": self.deadline_s,
            "overdue_s": round(overdue_s, 3),
            "wall_time": time.time(),
            "thread_stacks": collect_thread_stacks(),
            "device_memory": _collect_device_memory(),
            "state": state,
            "metrics": metrics_snapshot,
            # serving hangs: which weights generation was live when the step
            # wedged — lifted from the engine's state provider for triage
            "weights_generation": (
                state.get("serving_engine", {}).get("weights_generation")
                if isinstance(state.get("serving_engine"), dict) else None
            ),
        }
        self.artifact_dir.mkdir(parents=True, exist_ok=True)
        path = self.artifact_dir / f"watchdog_dump_rank_{self.global_rank}_step_{armed_step}.json"
        tmp = path.with_suffix(".json.tmp")
        with open(tmp, "w") as f:
            json.dump(artifact, f, indent=1)
            f.flush()
        tmp.rename(path)  # killers mid-write leave .tmp, never a torn artifact
        self.fired_artifacts.append(path)
        logger.error(
            "WATCHDOG: no step completed within %.1fs (armed for step %s) — dumped %s",
            self.deadline_s, armed_step, path,
        )
        return path

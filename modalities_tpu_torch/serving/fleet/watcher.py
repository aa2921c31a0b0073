"""Checkpoint watcher: the train -> serve seam of the fleet, the port of
modalities_tpu/serving/fleet/watcher.py.

A poll loop over a training checkpoint ring (folders named
``eid_*-seen_steps_*``) that finds newly *sealed* checkpoints and hands
verified, loaded parameters to a deploy callback (the rollout controller's
`deploy`). Sealing is STRICTER than warmstart's `verify_manifest`: a folder
without a ``manifest.json`` is a save still in flight, or one that died, so
the watcher wants the manifest present AND clean. A torn or corrupt seal
emits ``fleet/seal_rejected`` and the scan walks back to the newest folder
that verifies.

A checkpoint that seals cleanly but fails to LOAD emits ``fleet/rollback``
and burns the step: the watcher never retries it and keeps serving the
incumbent generation until a newer step appears. The deploy callback burns
a step the same way by returning False (the canary was rolled back).

Sleeps are injectable (the default waits on the stop event, so `stop()`
ends a poll interval at once); ``MODALITIES_TPU_FLEET_POLL_S`` sets the
interval (default 5 s).
"""

from __future__ import annotations

import functools
import logging
import os
import threading
from pathlib import Path
from typing import Callable, Optional

from modalities_tpu_torch.resilience.events import record_event
from modalities_tpu_torch.resilience.manifest import MANIFEST_FILE_NAME, _seen_steps_of, verify_manifest

logger = logging.getLogger(__name__)


def _default_poll_s() -> float:
    return float(os.environ.get("MODALITIES_TPU_FLEET_POLL_S", "5.0"))


class CheckpointWatcher:
    """Poll a checkpoint ring and deploy the newest sealed, verified folder.

    `on_params(params, step, folder)` is the deploy seam: False burns the
    step, anything else marks it deployed. `load_fn(folder)` defaults to
    the shared `load_serving_params` onto `device`, so startup and the
    watcher load the same way."""

    def __init__(self, ring_path, on_params: Callable, *, device=None, load_fn: Optional[Callable] = None,
                 poll_interval_s: Optional[float] = None, sleep_fn: Optional[Callable[[float], None]] = None):
        self.ring_path = Path(ring_path)
        self.on_params = on_params
        if load_fn is None:
            from modalities_tpu_torch.serving.serve import load_serving_params

            load_fn = functools.partial(load_serving_params, device=device)
        self._load_fn = load_fn
        self.poll_interval_s = poll_interval_s if poll_interval_s is not None else _default_poll_s()
        self._stop = threading.Event()
        self._sleep_fn = sleep_fn if sleep_fn is not None else self._stop.wait
        self._thread: Optional[threading.Thread] = None
        self.deployed_step = -1  # the newest step handed off
        self._rejected_steps: set[int] = set()  # load or deploy failures: burned
        self._rejected_seen: set[str] = set()  # seal rejections, one event a folder
        self.polls = 0
        self.deploys = 0

    def scan_once(self) -> Optional[Path]:
        """The newest sealed AND verified ring folder newer than the deployed
        step (burned steps skipped), or None when nothing new serves."""
        candidates = sorted((p for p in self.ring_path.glob("eid_*-seen_steps_*") if p.is_dir()),
                            key=_seen_steps_of, reverse=True)
        for folder in candidates:
            step = _seen_steps_of(folder)
            if step <= self.deployed_step:
                return None  # newest first: everything below is served already
            if step in self._rejected_steps:
                continue
            if not (folder / MANIFEST_FILE_NAME).is_file():
                # a torn seal: the manifest may still land, so the folder is
                # checked again next poll rather than burned
                self._reject_seal(folder, "unsealed (no manifest)")
                continue
            verification = verify_manifest(folder)
            if not verification.ok:
                self._reject_seal(folder, verification.reason)
                continue
            return folder
        return None

    def _reject_seal(self, folder: Path, reason: str) -> None:
        if folder.name in self._rejected_seen:
            return
        self._rejected_seen.add(folder.name)
        logger.warning("fleet watcher: rejecting seal of %s: %s", folder, reason)
        record_event("fleet/seal_rejected", folder=str(folder), reason=reason)

    def poll_once(self) -> bool:
        """One scan -> load -> deploy attempt; True when new parameters were deployed."""
        self.polls += 1
        folder = self.scan_once()
        if folder is None:
            return False
        step = _seen_steps_of(folder)
        try:
            params = self._load_fn(folder)
        except Exception as exc:
            # sealed but unloadable: burn the step, keep the incumbent generation
            logger.error("fleet watcher: loading %s failed (%r); burning step %d", folder, exc, step)
            record_event("fleet/rollback", stage="load", folder=str(folder), step=step, error=repr(exc))
            self._rejected_steps.add(step)
            return False
        if self.on_params(params, step, folder) is False:
            self._rejected_steps.add(step)  # rolled back: never retried
            return False
        self.deployed_step = step
        self.deploys += 1
        return True

    def run(self, stop_fn: Optional[Callable[[], bool]] = None) -> None:
        while not self._stop.is_set() and not (stop_fn is not None and stop_fn()):
            self.poll_once()
            self._sleep_fn(self.poll_interval_s)

    def start(self) -> "CheckpointWatcher":
        self._thread = threading.Thread(target=self.run, name="fleet-watcher", daemon=True)
        self._thread.start()
        return self

    def stop(self, timeout_s: float = 10.0) -> None:
        self._stop.set()
        if self._thread is not None and self._thread.is_alive():
            self._thread.join(timeout_s)

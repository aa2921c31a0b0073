"""Supervisor: the restart-on-resumable-exit loop with crash-loop detection,
single host; the port of modalities_tpu/resilience/supervisor.py
(`build_child_command`, `run_resilient`).

`python -m modalities_tpu_torch run --resilient` runs the training as a child
process. A child exiting with `RESUMABLE_EXIT_CODE` (preemption, anomaly
rollback) is restarted as a warmstart from the resume pointer, with
`resolve_resume_folder` picking the newest verified checkpoint. Restarts are
bounded (`max_restarts`) and exponentially backed off. The budget measures
crash-looping, not lifetime restarts: whenever the resume target advanced
since the previous restart, the counter and the backoff reset. Until the
pointer appears, every start is cold.

Degradation ladder: a child that keeps dying right after resuming from the
same checkpoint (`ladder_after` consecutive failures at one step) has that
step burned: it is excluded from resolution and the ring walks back one
slot. The last usable slot is never burned.

A child never recurses: its command is `run` or `warmstart`, never
`--resilient`. `runner` is injectable for unit tests (exit-code scripts, no
processes). The multi-host resume vote and elastic repair (`host_count`,
`resume_quorum`, `min_hosts`, ...) wait for ROADMAP.md Queue 1 item 7,
cluster resilience.
"""

from __future__ import annotations

import logging
import subprocess
import sys
import time
from pathlib import Path
from typing import Callable, Optional

from modalities_tpu_torch.resilience.coordination import collect_verified_steps
from modalities_tpu_torch.resilience.errors import RESUMABLE_EXIT_CODE
from modalities_tpu_torch.resilience.events import record_event
from modalities_tpu_torch.resilience.manifest import _seen_steps_of, atomic_write_json, resolve_resume_folder

logger = logging.getLogger(__name__)


def _default_runner(cmd: list[str]) -> int:
    return subprocess.call(cmd)


def build_child_command(config_file_path: Path, last_checkpoint_info_file_path: Path,
                        experiments_root_path: Optional[Path] = None, resume: bool = False,
                        warmstart_config_file_path: Optional[Path] = None,
                        extra_args: tuple[str, ...] = ()) -> list[str]:
    """The `run` (cold) or `warmstart` (resume) child invocation, never
    `--resilient`. Resumes use `warmstart_config_file_path` when given: a
    cold-start config pins the training progress at zero, a warmstart config
    derives it from the checkpoint folder's name. `extra_args` (the port's
    `--device`) go to every child."""
    cmd = [sys.executable, "-m", "modalities_tpu_torch"]
    if resume:
        cmd += ["warmstart", "--config_file_path", str(warmstart_config_file_path or config_file_path),
                "--last_checkpoint_info_file_path", str(last_checkpoint_info_file_path)]
    else:
        cmd += ["run", "--config_file_path", str(config_file_path)]
    if experiments_root_path is not None:
        cmd += ["--experiments_root_path", str(experiments_root_path)]
    return cmd + list(extra_args)


def run_resilient(config_file_path: Path, last_checkpoint_info_file_path: Path,
                  experiments_root_path: Optional[Path] = None, warmstart_config_file_path: Optional[Path] = None,
                  max_restarts: int = 3, backoff_base_s: float = 1.0, restart_on_crash: bool = False,
                  runner: Callable[[list[str]], int] = _default_runner,
                  sleep_fn: Callable[[float], None] = time.sleep, ladder_after: int = 2,
                  extra_args: tuple[str, ...] = ()) -> int:
    """Supervise the run; returns the final exit code (0 on success).

    `last_checkpoint_info_file_path` is where the resume pointer will appear
    (it need not exist yet). `restart_on_crash=True` also restarts
    non-resumable failures, still bounded by `max_restarts`."""
    config_file_path = Path(config_file_path)
    info_path = Path(last_checkpoint_info_file_path)
    coordination_dir = info_path.parent / "supervisor_votes"
    restarts = 0
    last_resume_step: Optional[int] = None
    burned_steps: set[int] = set()
    ladder_step: Optional[int] = None  # the step of the last failed resume
    ladder_failures = 0
    while True:
        resume = info_path.is_file()
        child_info_path = info_path
        step: Optional[int] = None
        if resume:
            # fail fast (and loudly) when every checkpoint is unverifiable, rather
            # than letting the child crash-loop through the budget
            try:
                folder = resolve_resume_folder(info_path, exclude_steps=frozenset(burned_steps))
                logger.info("supervisor: resuming from verified checkpoint %s", folder)
            except (FileNotFoundError, ValueError) as e:
                logger.error("supervisor: no verifiable checkpoint to resume from: %s", e)
                return 1
            # crash-LOOP detection, not a lifetime cap: a resume target that advanced
            # since the previous restart resets the budget and the backoff
            step = _seen_steps_of(folder)
            if last_resume_step is not None and step > last_resume_step and restarts > 0:
                logger.info("supervisor: checkpoint progressed (step %d -> %d) since the last restart — "
                            "resetting the restart budget", last_resume_step, step)
                restarts = 0
            last_resume_step = step
            if burned_steps:
                # hand the child the resolved folder: the pointer may name a burned slot
                child_info_path = coordination_dir / "agreed_checkpoint_info_h0.json"
                coordination_dir.mkdir(parents=True, exist_ok=True)
                atomic_write_json(child_info_path, {"checkpoint_folder_path": str(Path(folder).absolute())})
        cmd = build_child_command(config_file_path, child_info_path, experiments_root_path, resume=resume,
                                  warmstart_config_file_path=warmstart_config_file_path, extra_args=extra_args)
        logger.info("supervisor: starting %s attempt (restart %d/%d)", "warmstart" if resume else "cold",
                    restarts, max_restarts)
        code = runner(cmd)
        if code == 0:
            logger.info("supervisor: run completed successfully")
            return 0
        # the degradation ladder: repeated deaths right after resuming from one step
        # burn it, so the next resolution walks the ring back a slot
        if step is not None:
            if step == ladder_step:
                ladder_failures += 1
            else:
                ladder_step, ladder_failures = step, 1
            fallback_exists = bool(collect_verified_steps(info_path, exclude_steps=frozenset(burned_steps | {step})))
            if ladder_failures >= ladder_after and fallback_exists:
                burned_steps.add(step)
                ladder_step, ladder_failures = None, 0
                record_event("elastic/degradation_ladder", host_id=0, burned_step=step,
                             burned_steps=sorted(burned_steps), after_failures=ladder_after)
                logger.warning("supervisor: degradation ladder burned checkpoint step %d after %d consecutive "
                               "failed resumes — walking the ring back", step, ladder_after)
        resumable = code == RESUMABLE_EXIT_CODE
        if not (resumable or restart_on_crash):
            logger.error("supervisor: child failed non-resumably (exit %d) — giving up", code)
            return code
        restarts += 1
        if restarts > max_restarts:
            logger.error("supervisor: crash loop — %d restarts exhausted (last exit %d)", max_restarts, code)
            return code
        delay = backoff_base_s * (2 ** (restarts - 1))
        logger.warning("supervisor: child exited %s (code %d) — restart %d/%d in %.1fs",
                       "resumable" if resumable else "crashed", code, restarts, max_restarts, delay)
        sleep_fn(delay)

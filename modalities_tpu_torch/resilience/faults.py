"""Fault injection: named fault points armed from the environment or the API,
the port of modalities_tpu/resilience/faults.py. Spec grammar (env
``MODALITIES_TPU_FAULTS`` or `arm_faults`), the JAX package's:

    name[@step][:arg][,name[@step][:arg]...]

Every one of the JAX package's 16 names parses; unknown names and malformed
specs raise the JAX errors. The points wired in the port:

- ``checkpoint_io_error[:count]``: the next `count` (default 1) checkpoint IO
  attempts raise OSError inside `retry.retry_io`.
- ``nan_grads@step``: the train step multiplies the gradients by NaN at
  optimizer step `step` (0-based: the step count before the update), baked
  in when the step is built.
- ``loss_spike@step[:magnitude]``: the reported loss jumps by `magnitude`
  (default 1e3) at `step`; the gradients are untouched.
- ``sigterm_at_step@step``: the trainer sends SIGTERM to its own process after
  completing `step`.
- ``sigterm_one_rank@step[:rank]``: SIGTERM only on rank `rank` (default 0)
  after `step`; the other ranks keep the fault armed.
- ``peer_hang@step[:seconds]``: the step loop sleeps `seconds` (default 30)
  after completing `step`.
- ``peer_death@step``: `os._exit(1)` after completing `step`.
- ``oom@step``: the trainer's dispatch of `step` (1-based, as the JAX
  trainer counts it) raises an allocation failure, so memscope's OOM
  forensics write their dump and the run exits resumable.

Arming one of the others raises NotImplementedError naming where it waits
(`UNPORTED`).
"""

from __future__ import annotations

import logging
import os
import signal
import time
from dataclasses import dataclass
from typing import Optional

from modalities_tpu_torch.resilience.events import record_event

logger = logging.getLogger(__name__)

ENV_VAR = "MODALITIES_TPU_FAULTS"

FAULT_POINTS = (
    "checkpoint_io_error",
    "nan_grads",
    "loss_spike",
    "feeder_wedge",
    "sigterm_at_step",
    "sigterm_one_rank",
    "peer_hang",
    "peer_death",
    "host_loss",
    "oom",
    "serve_worker_hang",
    "serve_slow_decode",
    "handoff_corrupt",
    "sse_torn",
    "queue_storm",
    "tenant_flood",
)

_SERVING = "the serving fault points (ROADMAP.md, Queue 1 item 7)"
# the points whose fire sites the port does not have yet: name -> where they wait
UNPORTED = {
    "feeder_wedge": "the device feeder (ROADMAP.md, Queue 1 item 7)",
    "host_loss": "elastic repair (ROADMAP.md, Queue 1 item 7)",
    **{name: _SERVING for name in ("serve_worker_hang", "serve_slow_decode", "handoff_corrupt", "sse_torn",
                                   "queue_storm", "tenant_flood")},
}


@dataclass
class FaultSpec:
    name: str
    step: Optional[int] = None  # the step or index the fault targets (None: untargeted)
    arg: Optional[float] = None  # count / magnitude / seconds, per fault point
    remaining: int = 1  # shots left (one-shot by default)


_armed: dict[str, FaultSpec] = {}
_env_loaded = False


def parse_faults(spec: str) -> dict[str, FaultSpec]:
    """Parse the comma-separated spec grammar; unknown names fail loudly."""
    parsed: dict[str, FaultSpec] = {}
    for entry in spec.split(","):
        entry = entry.strip()
        if not entry:
            continue
        name, _, arg_part = entry.partition(":")
        name, _, step_part = name.partition("@")
        if name not in FAULT_POINTS:
            raise ValueError(f"unknown fault point {name!r}; registered fault points: {FAULT_POINTS}")
        step = int(step_part) if step_part else None
        arg = float(arg_part) if arg_part else None
        remaining = 1
        if name == "checkpoint_io_error":
            remaining = int(arg) if arg is not None else 1
        parsed[name] = FaultSpec(name=name, step=step, arg=arg, remaining=remaining)
    return parsed


def arm_faults(spec: str) -> None:
    """Arm from a spec string (additive over already-armed points). A point
    the port has no fire site for raises before anything is armed."""
    parsed = parse_faults(spec)
    refused = [name for name in parsed if name in UNPORTED]
    if refused:
        raise NotImplementedError("; ".join(f"fault point {name!r}: its fire site is {UNPORTED[name]}"
                                            for name in refused))
    for name, fault in parsed.items():
        logger.warning("FAULT ARMED: %s (step=%s arg=%s)", name, fault.step, fault.arg)
        _armed[name] = fault


def load_faults_from_env() -> None:
    """Arm from $MODALITIES_TPU_FAULTS once per process (Main.run calls this)."""
    global _env_loaded
    if _env_loaded:
        return
    _env_loaded = True
    spec = os.environ.get(ENV_VAR)
    if spec:
        arm_faults(spec)


def clear_faults() -> None:
    """Disarm everything (test isolation; does not block later env re-loads)."""
    global _env_loaded
    _armed.clear()
    _env_loaded = False


def get_fault(name: str) -> Optional[FaultSpec]:
    """Build-time query (the train step bakes nan_grads / loss_spike in). Does
    not consume a shot."""
    if name not in FAULT_POINTS:
        raise ValueError(f"unknown fault point {name!r}")
    return _armed.get(name)


def _consume(name: str, step: Optional[int] = None) -> Optional[FaultSpec]:
    fault = _armed.get(name)
    if fault is None or fault.remaining <= 0:
        return None
    if fault.step is not None and step != fault.step:
        return None
    fault.remaining -= 1
    return fault


def fire_io_error_if_armed(name: str = "checkpoint_io_error") -> None:
    """Raise an injected OSError when armed: placed inside retried IO, so the
    retry sees the failure and eventually succeeds."""
    fault = _consume(name)
    if fault is not None:
        record_event(f"fault/{name}", remaining=fault.remaining)
        raise OSError(f"injected fault: {name} ({fault.remaining} shots left)")


def fire_sigterm_if_armed(step: int) -> bool:
    """SIGTERM this process when `sigterm_at_step` is armed for `step`."""
    fault = _consume("sigterm_at_step", step=step)
    if fault is None:
        return False
    record_event("fault/sigterm_at_step", step=step)
    logger.warning("FAULT FIRING: sigterm_at_step at step %d", step)
    os.kill(os.getpid(), signal.SIGTERM)
    return True


def fire_oom_if_armed(step: int) -> bool:
    """Raise an injected allocation failure when `oom` is armed for `step`:
    placed at the trainer's dispatch, so memscope's OOM forensics (the dump,
    the resumable exit) run on the CPU as on the card. It is a
    `torch.OutOfMemoryError` carrying the JAX fault's message."""
    fault = _consume("oom", step=step)
    if fault is None:
        return False
    import torch

    record_event("fault/oom", step=step)
    logger.warning("FAULT FIRING: oom at step %d", step)
    raise torch.OutOfMemoryError(f"RESOURCE_EXHAUSTED: injected fault: oom at step {step} "
                                 "(fault-injection stand-in for a device allocation failure)")


def fire_sigterm_one_rank_if_armed(step: int) -> bool:
    """SIGTERM this process at `step` only when its rank is the fault's target
    (arg, default 0); the other ranks do not consume a shot."""
    fault = _armed.get("sigterm_one_rank")
    if fault is None or fault.remaining <= 0:
        return False
    if fault.step is not None and step != fault.step:
        return False
    if _process_index() != (int(fault.arg) if fault.arg is not None else 0):
        return False
    _consume("sigterm_one_rank", step=step)
    record_event("fault/sigterm_one_rank", step=step, rank=_process_index())
    logger.warning("FAULT FIRING: sigterm_one_rank at step %d (rank %d)", step, _process_index())
    os.kill(os.getpid(), signal.SIGTERM)
    return True


def peer_hang_if_armed(step: int) -> bool:
    """Wedge this process's step loop for `arg` seconds (default 30) at `step`;
    its heartbeat thread keeps beating, so the other ranks' rendezvous
    deadline catches it."""
    fault = _consume("peer_hang", step=step)
    if fault is None:
        return False
    seconds = fault.arg if fault.arg is not None else 30.0
    record_event("fault/peer_hang", step=step, seconds=seconds)
    logger.warning("FAULT FIRING: peer_hang for %.1fs at step %d", seconds, step)
    time.sleep(seconds)
    return True


def peer_death_if_armed(step: int) -> bool:
    """Abrupt process death (`os._exit(1)`: no signal, no cleanup) at `step`."""
    fault = _consume("peer_death", step=step)
    if fault is None:
        return False
    record_event("fault/peer_death", step=step)
    logger.error("FAULT FIRING: peer_death at step %d — exiting abruptly", step)
    os._exit(1)
    return True  # unreachable outside tests that stub os._exit


def _process_index() -> int:
    from modalities_tpu_torch.running_env import env

    return env.rank()

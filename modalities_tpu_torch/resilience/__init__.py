"""Training resilience: the port of modalities_tpu/resilience/.

- **Preemption** (`preemption.py`): SIGTERM/SIGINT set a flag; the trainer
  lets the in-flight step finish, forces an out-of-schedule checkpoint, drains
  it (Gym) and raises `PreemptionShutdown`, which the CLI maps to
  `RESUMABLE_EXIT_CODE`.
- **Anomaly policy** (`anomaly.py`): `raise` (the default, bitwise a run
  without this component), `skip_step` (the train step leaves parameters,
  moments and AdamW's step count untouched on a non-finite step, within a
  skip budget a window), `rollback` (a spent budget exits resumable).
- **Checkpoint integrity** (`manifest.py`, `retry.py`), and **fault
  injection** (`faults.py`).
- **Stop consensus** (`coordination.py`): each step carries this rank's vote,
  MAX-reduced over the world, so every rank leaves at the same boundary.
- **Peer health** (`heartbeat.py`): a dead or wedged peer becomes a
  diagnosed resumable exit instead of a hung collective.
- **Supervisor** (`supervisor.py`): `run --resilient`, single host.

`Resilience` is the registry component ("resilience", "default"), wired by
Main into the trainer and the train step. The JAX knobs of cluster
resilience (the multi-host resume vote: `resume_quorum`,
`resume_vote_deadline_s`; elastic repair: `min_hosts`) raise
NotImplementedError naming ROADMAP.md Queue 1 item 7 when set.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

from modalities_tpu_torch.config.config import check_bool, check_float, check_int
from modalities_tpu_torch.resilience.anomaly import POLICIES, AnomalyTracker
from modalities_tpu_torch.resilience.errors import (
    RESUMABLE_EXIT_CODE,
    AnomalyRollback,
    PeerFailure,
    PreemptionShutdown,
    ResumableError,
)
from modalities_tpu_torch.resilience.preemption import PreemptionHandler

_CLUSTER = "cluster resilience (ROADMAP.md, Queue 1 item 7)"


def _choice(name: str, value, allowed: tuple) -> str:
    if value not in allowed:
        raise ValueError(f"{name}: expected one of {list(allowed)}, got {value!r}")
    return value


@dataclasses.dataclass
class ResilienceConfig:
    """The JAX `ResilienceConfig` (modalities_tpu/config/config.py), field for
    field, with its bounds."""

    anomaly_policy: str = "raise"
    skip_budget: int = 2
    anomaly_window_steps: int = 100
    loss_spike_zscore: Optional[float] = None
    loss_spike_min_history: int = 8
    install_signal_handlers: bool = True
    max_restarts: int = 3
    backoff_base_s: float = 1.0
    stop_consensus: str = "auto"
    heartbeat: str = "auto"
    heartbeat_interval_s: float = 5.0
    peer_deadline_s: float = 30.0
    rendezvous_deadline_s: float = 300.0
    resume_quorum: Optional[int] = None
    resume_vote_deadline_s: float = 120.0
    min_hosts: Optional[int] = None

    def __post_init__(self):
        self.anomaly_policy = _choice("anomaly_policy", self.anomaly_policy, POLICIES)
        check_int("skip_budget", self.skip_budget, ge=0)
        check_int("anomaly_window_steps", self.anomaly_window_steps, ge=1)
        self.loss_spike_zscore = check_float("loss_spike_zscore", self.loss_spike_zscore, gt=0.0, optional=True)
        check_int("loss_spike_min_history", self.loss_spike_min_history, ge=1)
        check_bool("install_signal_handlers", self.install_signal_handlers)
        check_int("max_restarts", self.max_restarts, ge=0)
        self.backoff_base_s = check_float("backoff_base_s", self.backoff_base_s, ge=0.0)
        self.stop_consensus = _choice("stop_consensus", self.stop_consensus, ("auto", "on", "off"))
        self.heartbeat = _choice("heartbeat", self.heartbeat, ("auto", "kv", "udp", "off"))
        self.heartbeat_interval_s = check_float("heartbeat_interval_s", self.heartbeat_interval_s, gt=0.0)
        self.peer_deadline_s = check_float("peer_deadline_s", self.peer_deadline_s, gt=0.0)
        self.rendezvous_deadline_s = check_float("rendezvous_deadline_s", self.rendezvous_deadline_s, ge=0.0)
        check_int("resume_quorum", self.resume_quorum, ge=1, optional=True)
        self.resume_vote_deadline_s = check_float("resume_vote_deadline_s", self.resume_vote_deadline_s, gt=0.0)
        check_int("min_hosts", self.min_hosts, ge=1, optional=True)


class Resilience:
    """Registry component ("resilience", "default"): the anomaly tracker, the
    preemption handler and the supervisor knobs. `anomaly_policy="raise"` with
    spike detection off is bitwise a run without the component."""

    def __init__(self, anomaly_policy: str = "raise", skip_budget: int = 2, anomaly_window_steps: int = 100,
                 loss_spike_zscore: Optional[float] = None, loss_spike_min_history: int = 8,
                 install_signal_handlers: bool = True, max_restarts: int = 3, backoff_base_s: float = 1.0,
                 stop_consensus: str = "auto", heartbeat: str = "auto", heartbeat_interval_s: float = 5.0,
                 peer_deadline_s: float = 30.0, rendezvous_deadline_s: float = 300.0,
                 resume_quorum: Optional[int] = None, resume_vote_deadline_s: float = 120.0,
                 min_hosts: Optional[int] = None):
        if resume_quorum is not None or resume_vote_deadline_s != 120.0:
            raise NotImplementedError("resilience.resume_quorum / resume_vote_deadline_s: the multi-host resume "
                                      f"vote is {_CLUSTER}")
        if min_hosts is not None:
            raise NotImplementedError(f"resilience.min_hosts: elastic repair is {_CLUSTER}")
        self.anomaly_policy = anomaly_policy
        self.install_signal_handlers = install_signal_handlers
        self.max_restarts = max_restarts
        self.backoff_base_s = backoff_base_s
        self.stop_consensus = stop_consensus
        self.heartbeat = heartbeat
        self.heartbeat_interval_s = heartbeat_interval_s
        self.peer_deadline_s = peer_deadline_s
        self.rendezvous_deadline_s = rendezvous_deadline_s
        self.anomaly = AnomalyTracker(policy=anomaly_policy, skip_budget=skip_budget,
                                      window_steps=anomaly_window_steps, loss_spike_zscore=loss_spike_zscore,
                                      loss_spike_min_history=loss_spike_min_history)
        self.preemption = PreemptionHandler() if install_signal_handlers else None

    def consensus_enabled(self) -> bool:
        """The stop_consensus mode against the live world."""
        from modalities_tpu_torch.resilience.coordination import resolve_consensus

        return resolve_consensus(self.stop_consensus)

    def build_heartbeat(self, artifact_dir=None):
        """A HeartbeatMonitor to start, or None when the transport resolves
        off (a single process, heartbeat=off)."""
        from modalities_tpu_torch.resilience.heartbeat import HeartbeatMonitor, resolve_transport
        from modalities_tpu_torch.running_env import env

        rank, world = env.rank(), env.world_size()
        transport = resolve_transport(self.heartbeat, rank=rank, world=world)
        if transport is None:
            return None
        return HeartbeatMonitor(rank=rank, world=world, transport=transport, interval_s=self.heartbeat_interval_s,
                                peer_deadline_s=self.peer_deadline_s,
                                rendezvous_deadline_s=self.rendezvous_deadline_s, artifact_dir=artifact_dir)


__all__ = [
    "RESUMABLE_EXIT_CODE",
    "AnomalyRollback",
    "AnomalyTracker",
    "PeerFailure",
    "PreemptionHandler",
    "PreemptionShutdown",
    "Resilience",
    "ResilienceConfig",
    "ResumableError",
]

"""Anomaly policy: the configurable response to non-finite gradients and loss
spikes, the port of modalities_tpu/resilience/anomaly.py (`AnomalyTracker`).

- ``raise`` (default): the first non-finite interval kills the run with the
  trainer's own message.
- ``skip_step``: the train step already leaves the parameters, both moments
  and AdamW's step count untouched on a non-finite step
  (training/train_step.py), with no host sync; this tracker reads the
  interval's ``skipped_step`` flags at the interval boundary, enforces a
  bounded skip budget per trailing window and escalates when it is spent.
- ``rollback``: like ``skip_step``, but budget exhaustion raises
  `AnomalyRollback`, a resumable exit: the supervisor warmstarts from the
  newest verified checkpoint.

Loss-spike detection (a z-score of the loss over recent finite losses) feeds
the same policy; it is off unless `loss_spike_zscore` is set. `observe_slo`
counts an interval in breach of a training SLO (the telemetry component's
`slo` block) against the same budget.
"""

from __future__ import annotations

import logging
from collections import deque
from typing import Optional

import numpy as np

from modalities_tpu_torch.resilience.errors import AnomalyRollback
from modalities_tpu_torch.resilience.events import record_event

logger = logging.getLogger(__name__)

POLICIES = ("raise", "skip_step", "rollback")


class AnomalyTracker:
    def __init__(self, policy: str = "raise", skip_budget: int = 2, window_steps: int = 100,
                 loss_spike_zscore: Optional[float] = None, loss_spike_min_history: int = 8,
                 loss_history_size: int = 64):
        if policy not in POLICIES:
            raise ValueError(f"anomaly policy must be one of {POLICIES}, got {policy!r}")
        self.policy = policy
        self.skip_budget = skip_budget
        self.window_steps = window_steps
        self.loss_spike_zscore = loss_spike_zscore
        self.loss_spike_min_history = loss_spike_min_history
        self._anomalous_steps: deque[int] = deque()
        self._loss_history: deque[float] = deque(maxlen=loss_history_size)

    @property
    def watches_loss(self) -> bool:
        return self.loss_spike_zscore is not None

    def should_observe(self, metric_keys) -> bool:
        """Whether `observe_interval` has anything to do for these metrics:
        an unarmed tracker costs no host sync."""
        return self.watches_loss or "nonfinite_grads" in metric_keys or "skipped_step" in metric_keys

    def anomalies_in_window(self, step_id: int) -> int:
        while self._anomalous_steps and self._anomalous_steps[0] <= step_id - self.window_steps:
            self._anomalous_steps.popleft()
        return len(self._anomalous_steps)

    def observe_interval(self, pending_metrics: list[dict], step_id: int) -> None:
        """Read the interval's anomaly flags and apply the policy. Called at the
        interval boundary before the checkpoint callback, so an anomalous
        interval is never committed as the latest resume target under the
        raise policy. Raises per policy; returns normally otherwise.
        `pending_metrics` hold numbers or 0-d tensors."""
        first_step = step_id - len(pending_metrics) + 1
        anomalous_steps: list[tuple[int, str]] = []

        flag_key = "skipped_step" if "skipped_step" in pending_metrics[0] else (
            "nonfinite_grads" if "nonfinite_grads" in pending_metrics[0] else None)
        if flag_key is not None:
            flags = np.asarray([int(m[flag_key]) for m in pending_metrics])
            for offset in np.flatnonzero(flags):
                anomalous_steps.append((first_step + int(offset), "nonfinite"))

        if self.watches_loss:
            losses = np.asarray([float(m["loss"]) for m in pending_metrics], dtype=np.float64)
            for offset, loss in enumerate(losses):
                step = first_step + offset
                if not np.isfinite(loss):
                    # a non-finite loss on a step not already flagged (no grad guard armed) is itself an anomaly
                    if not any(s == step for s, _ in anomalous_steps):
                        anomalous_steps.append((step, "nonfinite"))
                    continue
                history = np.asarray(self._loss_history)
                if history.size >= self.loss_spike_min_history:
                    zscore = abs(loss - history.mean()) / max(history.std(), 1e-12)
                    if zscore > self.loss_spike_zscore:
                        anomalous_steps.append((step, f"loss_spike(z={zscore:.1f})"))
                        # a spike stays out of the history, so a genuine level shift still needs
                        # `min_history` steps to be accepted as the new normal
                        continue
                self._loss_history.append(loss)

        if not anomalous_steps:
            return
        anomalous_steps.sort()
        first_bad_step, first_kind = anomalous_steps[0]
        if self.policy == "raise":
            if first_kind == "nonfinite":
                raise RuntimeError(f"non-finite gradient norm at train step {first_bad_step} "
                                   "(gradient_clipper.error_if_nonfinite=True)")
            raise RuntimeError(f"loss anomaly at train step {first_bad_step}: {first_kind} "
                               "(resilience.anomaly_policy=raise)")
        for step, kind in anomalous_steps:
            self._anomalous_steps.append(step)
            record_event("anomaly/skipped" if kind == "nonfinite" else "anomaly/loss_spike", step=step, kind=kind,
                         policy=self.policy, in_window=self.anomalies_in_window(step_id), budget=self.skip_budget)
            logger.warning("anomaly at step %d (%s): optimizer update skipped [%d/%d budget used in trailing %d "
                           "steps]", step, kind, self.anomalies_in_window(step_id), self.skip_budget,
                           self.window_steps)
        self._escalate_if_exhausted(step_id, f"first at step {first_bad_step}")

    def observe_slo(self, breaching: list, step_id: int) -> None:
        """An interval spent in breach of a training SLO (a goodput or
        MFU-floor objective, telemetry/slo.py) counts one anomalous step
        against the same skip budget, so sustained infra degradation
        escalates through the policy path bad math takes."""
        if not breaching:
            return
        self._anomalous_steps.append(step_id)
        used = self.anomalies_in_window(step_id)
        record_event("anomaly/slo_breach", step=step_id, objectives=list(breaching), policy=self.policy,
                     in_window=used, budget=self.skip_budget)
        logger.warning("SLO breach at step %d (%s) counted against anomaly budget [%d/%d used in trailing %d steps]",
                       step_id, ", ".join(breaching), used, self.skip_budget, self.window_steps)
        self._escalate_if_exhausted(step_id, f"last breaching {', '.join(breaching)}")

    def _escalate_if_exhausted(self, step_id: int, cause: str) -> None:
        used = self.anomalies_in_window(step_id)
        if used > self.skip_budget:
            record_event("anomaly/budget_exhausted", step=step_id, used=used, budget=self.skip_budget,
                         policy=self.policy)
            detail = (f"anomaly skip budget exhausted: {used} anomalous steps in the trailing "
                      f"{self.window_steps} steps (budget {self.skip_budget}), {cause}")
            if self.policy == "rollback":
                raise AnomalyRollback(detail + " — exiting resumable for a rollback warmstart from the newest "
                                      "verified checkpoint")
            raise RuntimeError(detail + " (resilience.anomaly_policy=skip_step)")

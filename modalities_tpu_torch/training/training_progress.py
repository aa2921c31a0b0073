"""Training progress bookkeeping: the port's copy of
modalities_tpu/training/training_progress.py."""

from __future__ import annotations

from dataclasses import dataclass


@dataclass
class TrainingProgress:
    num_seen_steps_current_run: int
    num_seen_tokens_current_run: int
    num_target_steps: int
    num_target_tokens: int
    num_seen_steps_previous_run: int = 0
    num_seen_tokens_previous_run: int = 0

    @property
    def num_seen_steps_total(self) -> int:
        return self.num_seen_steps_current_run + self.num_seen_steps_previous_run

    @property
    def num_seen_tokens_total(self) -> int:
        return self.num_seen_tokens_current_run + self.num_seen_tokens_previous_run

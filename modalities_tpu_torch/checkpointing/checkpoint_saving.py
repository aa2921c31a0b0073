"""Checkpoint saving: the port of modalities_tpu/checkpointing/checkpoint_saving.py.
The strategy decides whether a save is due and which old folders go; the
execution (checkpointing/dcp/dcp_checkpoint_saving.py) writes and seals them,
under a `checkpoint_save` telemetry span (goodput bucket: checkpoint)."""

from __future__ import annotations

import dataclasses

from modalities_tpu_torch.checkpointing.checkpoint_saving_execution import CheckpointSavingExecutionABC
from modalities_tpu_torch.checkpointing.checkpoint_saving_strategies import CheckpointSavingStrategyIF
from modalities_tpu_torch.telemetry import span
from modalities_tpu_torch.training.training_progress import TrainingProgress


@dataclasses.dataclass
class CheckpointSaving:
    checkpoint_saving_strategy: CheckpointSavingStrategyIF
    checkpoint_saving_execution: CheckpointSavingExecutionABC

    def __post_init__(self):
        if not isinstance(self.checkpoint_saving_strategy, CheckpointSavingStrategyIF):
            raise ValueError(f"checkpoint_saving_strategy: expected a strategy, got {self.checkpoint_saving_strategy!r}")
        if not isinstance(self.checkpoint_saving_execution, CheckpointSavingExecutionABC):
            raise ValueError(
                f"checkpoint_saving_execution: expected an execution, got {self.checkpoint_saving_execution!r}"
            )

    def save_checkpoint(self, training_progress: TrainingProgress, app_state, force: bool = False) -> None:
        """`force=True` saves whatever the strategy's schedule says (a
        preemption's last save); the strategy's ring deletions still apply."""
        with span("checkpoint_save"):
            instruction = self.checkpoint_saving_strategy.get_checkpoint_instruction(
                training_progress=training_progress)
            if force:
                instruction.savable = True
            self.checkpoint_saving_execution.run_checkpoint_instruction(
                checkpointing_instruction=instruction, training_progress=training_progress, app_state=app_state,
            )

    def wait_until_finished(self) -> None:
        """Drain pending (async) saves; flushes the deferred resume pointer."""
        self.checkpoint_saving_execution.wait_until_finished()

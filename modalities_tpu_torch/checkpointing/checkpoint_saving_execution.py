"""Checkpoint execution ABC: the port's copy of
modalities_tpu/checkpointing/checkpoint_saving_execution.py."""

from __future__ import annotations

from abc import ABC, abstractmethod

from modalities_tpu_torch.checkpointing.checkpoint_saving_instruction import CheckpointingInstruction
from modalities_tpu_torch.training.training_progress import TrainingProgress


class CheckpointSavingExecutionABC(ABC):
    @abstractmethod
    def _save_checkpoint(self, app_state, training_progress: TrainingProgress) -> None: ...

    @abstractmethod
    def _delete_checkpoint(self, training_progress: TrainingProgress) -> None: ...

    def wait_until_finished(self) -> None:
        """Drain a pending background save (none here: a synchronous execution
        has committed when its save returns)."""

    def run_checkpoint_instruction(self, checkpointing_instruction: CheckpointingInstruction,
                                   training_progress: TrainingProgress, app_state) -> None:
        if checkpointing_instruction.savable:
            self._save_checkpoint(app_state=app_state, training_progress=training_progress)
        for progress_to_delete in checkpointing_instruction.checkpoints_to_delete:
            self._delete_checkpoint(training_progress=progress_to_delete)

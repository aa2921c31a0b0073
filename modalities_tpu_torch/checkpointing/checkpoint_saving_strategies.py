"""Checkpoint retention strategies: the port's copy of
modalities_tpu/checkpointing/checkpoint_saving_strategies.py. Each is its own
config dataclass (the JAX config's field and bound)."""

from __future__ import annotations

import copy
import dataclasses
from abc import ABC, abstractmethod

from modalities_tpu_torch.checkpointing.checkpoint_saving_instruction import CheckpointingInstruction
from modalities_tpu_torch.config.config import check_int
from modalities_tpu_torch.training.training_progress import TrainingProgress


class CheckpointSavingStrategyIF(ABC):
    @abstractmethod
    def get_checkpoint_instruction(self, training_progress: TrainingProgress) -> CheckpointingInstruction: ...


@dataclasses.dataclass
class SaveKMostRecentCheckpointsStrategy(CheckpointSavingStrategyIF):
    """A ring of the k most recent checkpoints: k = -1 keeps all, k = 0 none,
    k > 0 the newest k."""

    k: int = -1
    saved_step_checkpoints: list = dataclasses.field(default_factory=list, init=False)

    def __post_init__(self):
        check_int("k", self.k, ge=-1)

    def get_checkpoint_instruction(self, training_progress: TrainingProgress) -> CheckpointingInstruction:
        checkpoints_to_delete: list[TrainingProgress] = []
        savable = self.k != 0
        if savable:
            self.saved_step_checkpoints = [copy.deepcopy(training_progress)] + self.saved_step_checkpoints
            if self.k > 0 and len(self.saved_step_checkpoints) > self.k:
                checkpoints_to_delete = [self.saved_step_checkpoints[-1]]
                self.saved_step_checkpoints = self.saved_step_checkpoints[: self.k]
        return CheckpointingInstruction(savable=savable, checkpoints_to_delete=checkpoints_to_delete)


@dataclasses.dataclass
class SaveEveryKStepsCheckpointingStrategy(CheckpointSavingStrategyIF):
    """Save whenever the total of seen steps is a multiple of k."""

    k: int

    def __post_init__(self):
        check_int("k", self.k, ge=1)

    def get_checkpoint_instruction(self, training_progress: TrainingProgress) -> CheckpointingInstruction:
        savable = self.k > 0 and training_progress.num_seen_steps_total % self.k == 0
        return CheckpointingInstruction(savable=savable, checkpoints_to_delete=[])

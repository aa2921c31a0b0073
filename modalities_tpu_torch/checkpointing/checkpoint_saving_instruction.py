"""Checkpointing instruction: the port's copy of
modalities_tpu/checkpointing/checkpoint_saving_instruction.py."""

from __future__ import annotations

from dataclasses import dataclass, field

from modalities_tpu_torch.training.training_progress import TrainingProgress


@dataclass
class CheckpointingInstruction:
    """Whether to save, and which older checkpoints to delete."""

    savable: bool = False
    checkpoints_to_delete: list[TrainingProgress] = field(default_factory=list)

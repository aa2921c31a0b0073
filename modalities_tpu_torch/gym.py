"""Gym: the trainer plus the evaluation and checkpoint callbacks, the port of
modalities_tpu/gym.py. Evaluation runs only with an empty `eval_dataloaders`
(eval loops are not ported yet); a checkpoint that falls due raises from the
checkpoint-saving component."""

from __future__ import annotations

from typing import Optional

from modalities_tpu_torch.trainer import Trainer
from modalities_tpu_torch.training.training_progress import TrainingProgress


class Gym:
    def __init__(self, trainer: Trainer):
        self.trainer = trainer

    def run(self, train_step, train_data_loader, evaluation_data_loaders: list, checkpoint_saving=None,
            training_progress: Optional[TrainingProgress] = None, evaluation_interval_in_steps: int = 0,
            checkpointing_interval_in_steps: int = 0) -> list[dict]:
        if evaluation_data_loaders:
            raise NotImplementedError(
                "eval loops are not ported yet (ROADMAP.md, Queue 1 item 7); set eval_dataloaders: []"
            )
        if training_progress is None:
            training_progress = TrainingProgress(0, 0, len(train_data_loader), 0)

        def checkpointing_callback(progress: TrainingProgress) -> None:
            if (checkpoint_saving is not None and checkpointing_interval_in_steps > 0
                    and progress.num_seen_steps_total % checkpointing_interval_in_steps == 0):
                checkpoint_saving.save_checkpoint(progress, train_step)

        return self.trainer.train(train_step, train_data_loader, training_progress,
                                  evaluation_callback=lambda step: None,
                                  checkpointing_callback=checkpointing_callback)

"""Gym: the trainer plus the evaluation and checkpoint callbacks, the port of
modalities_tpu/gym.py. The evaluator runs over every eval dataloader every
`evaluation_interval_in_steps` seen steps, step 0 of the run included (JAX
gym.py:36-46). A checkpoint falls due every
`checkpointing_interval_in_steps` seen steps; after a run that ends well the
pending (async) save is drained, which seals its folder and moves the resume
pointer to it. A run that raises leaves a pending folder unsealed, with the
pointer on the last sealed one."""

from __future__ import annotations

from typing import Optional

from modalities_tpu_torch.checkpointing.stateful.app_state import AppState
from modalities_tpu_torch.evaluator import Evaluator
from modalities_tpu_torch.trainer import Trainer
from modalities_tpu_torch.training.training_progress import TrainingProgress


class Gym:
    def __init__(self, trainer: Trainer, evaluator: Evaluator):
        self.trainer = trainer
        self.evaluator = evaluator

    def run(self, app_state: AppState, train_data_loader, evaluation_data_loaders: list, checkpoint_saving=None,
            training_progress: Optional[TrainingProgress] = None, evaluation_interval_in_steps: int = 0,
            checkpointing_interval_in_steps: int = 0) -> list[dict]:
        """Trains `app_state.train_step`; a checkpoint saves `app_state`."""
        train_step = app_state.train_step
        if training_progress is None:
            training_progress = TrainingProgress(0, 0, len(train_data_loader), 0)

        def checkpointing_callback(progress: TrainingProgress) -> None:
            if (checkpoint_saving is not None and checkpointing_interval_in_steps > 0
                    and progress.num_seen_steps_total % checkpointing_interval_in_steps == 0):
                checkpoint_saving.save_checkpoint(progress, app_state)

        def evaluation_callback(num_train_steps_done: int) -> None:
            if (evaluation_interval_in_steps > 0 and num_train_steps_done % evaluation_interval_in_steps == 0
                    and evaluation_data_loaders):
                self.evaluator.evaluate(train_step, evaluation_data_loaders, num_train_steps_done)

        results = self.trainer.train(train_step, train_data_loader, training_progress,
                                     evaluation_callback=evaluation_callback,
                                     checkpointing_callback=checkpointing_callback)
        if checkpoint_saving is not None:
            checkpoint_saving.wait_until_finished()
        return results

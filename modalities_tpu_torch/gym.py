"""Gym: the trainer plus the evaluation and checkpoint callbacks, the port of
modalities_tpu/gym.py. The evaluator runs over every eval dataloader every
`evaluation_interval_in_steps` seen steps, step 0 of the run included (JAX
gym.py:36-46). A checkpoint falls due every
`checkpointing_interval_in_steps` seen steps. The trainer's preemption stop
calls the checkpoint callback with `force=True`: a save at that step whatever
the interval, unless the step was just saved on schedule (JAX gym.py:48-72).
However the run ends, the pending (async) save is drained on the way out
(under a `checkpoint_drain` telemetry span), which seals its folder and moves
the resume pointer to it; a drain that fails after a run that ended well
raises, one that fails while an error propagates is logged."""

from __future__ import annotations

import logging
from typing import Optional

from modalities_tpu_torch.checkpointing.stateful.app_state import AppState
from modalities_tpu_torch.evaluator import Evaluator
from modalities_tpu_torch.telemetry import span
from modalities_tpu_torch.trainer import Trainer
from modalities_tpu_torch.training.training_progress import TrainingProgress

logger = logging.getLogger(__name__)


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

        last_saved_step = -1

        def checkpointing_callback(progress: TrainingProgress, force: bool = False) -> None:
            nonlocal last_saved_step
            if checkpoint_saving is None:
                return
            scheduled = (checkpointing_interval_in_steps > 0
                         and progress.num_seen_steps_total % checkpointing_interval_in_steps == 0)
            # a preemption on an interval boundary would otherwise save the same step twice
            if not (scheduled or force) or progress.num_seen_steps_total == last_saved_step:
                return
            last_saved_step = progress.num_seen_steps_total
            checkpoint_saving.save_checkpoint(progress, app_state, force=force)

        def evaluation_callback(num_train_steps_done: int) -> None:
            if (evaluation_interval_in_steps > 0 and num_train_steps_done % evaluation_interval_in_steps == 0
                    and evaluation_data_loaders):
                self.evaluator.evaluate(train_step, evaluation_data_loaders, num_train_steps_done)

        succeeded = False
        try:
            results = self.trainer.train(train_step, train_data_loader, training_progress,
                                         evaluation_callback=evaluation_callback,
                                         checkpointing_callback=checkpointing_callback)
            succeeded = True
        finally:
            if checkpoint_saving is not None:
                try:
                    with span("checkpoint_drain"):
                        checkpoint_saving.wait_until_finished()
                except Exception:
                    logger.exception("draining the pending checkpoint save failed during shutdown")
                    if succeeded:
                        raise
        return results

"""Checkpoint saving, as far as the port has it: the `checkpoint_saving`
component and its strategy / execution nodes build from the JAX configs
(`save_k_most_recent_checkpoints_strategy`, `orbax`), and a save that falls
due raises, because writing checkpoints is not ported yet (ROADMAP.md,
Queue 1 item 2). Runs whose intervals put no save in reach train.
"""

from __future__ import annotations

import dataclasses
from pathlib import Path
from typing import Any

from modalities_tpu_torch.config.config import check_bool, check_int, check_str


@dataclasses.dataclass
class SaveKMostRecentCheckpointsStrategy:
    k: int

    def __post_init__(self):
        check_int("k", self.k, ge=-1)


@dataclasses.dataclass
class CheckpointSavingExecution:
    checkpoint_path: Path
    experiment_id: str
    global_rank: int = 0
    use_async: bool = False

    def __post_init__(self):
        self.checkpoint_path = Path(self.checkpoint_path)
        check_str("experiment_id", self.experiment_id)
        check_int("global_rank", self.global_rank, ge=0)
        check_bool("use_async", self.use_async)


@dataclasses.dataclass
class CheckpointSaving:
    checkpoint_saving_strategy: Any
    checkpoint_saving_execution: Any

    def save_checkpoint(self, training_progress, train_step) -> None:
        raise NotImplementedError(
            f"a checkpoint is due at step {training_progress.num_seen_steps_total}, but checkpoint saving is not "
            "ported yet (ROADMAP.md, Queue 1 item 2); raise checkpointing_interval_in_steps beyond the run"
        )

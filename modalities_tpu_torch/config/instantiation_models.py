"""Top-level config schemas (the port's counterpart of
modalities_tpu/config/instantiation_models.py)."""

from __future__ import annotations

import dataclasses
import logging
from pathlib import Path
from typing import Any, Optional

from modalities_tpu_torch.config.config import check_bool, check_dict, check_int, check_str, validate_config

logger = logging.getLogger(__name__)


@dataclasses.dataclass
class ServeSettings:
    """`settings` of the serve entry: `checkpoint_folder_path` null serves
    fresh-init parameters (smoke tests and demos)."""

    checkpoint_folder_path: Optional[str] = None

    def __post_init__(self):
        if self.checkpoint_folder_path is not None:
            self.checkpoint_folder_path = check_str("checkpoint_folder_path", str(self.checkpoint_folder_path))


@dataclasses.dataclass
class ServeInstantiationModel:
    serving_component: Any
    settings: Any = dataclasses.field(default_factory=ServeSettings)

    def __post_init__(self):
        if isinstance(self.settings, dict):
            self.settings = validate_config(ServeSettings, self.settings)


# ------------------------------------------------------------------ training
# The settings tree and cross-field checks of the JAX
# TrainingSettings / TrainingComponentsInstantiationModel
# (config/instantiation_models.py:59-221).


def _section(cls, data, name):
    return data if isinstance(data, cls) else validate_config(cls, check_dict(name, data))


@dataclasses.dataclass
class DistEnvSettings:
    local_rank: int = 0
    world_size: int = 1
    global_rank: int = 0

    def __post_init__(self):
        check_int("local_rank", self.local_rank, ge=0)
        check_int("world_size", self.world_size, ge=1)
        check_int("global_rank", self.global_rank, ge=0)


@dataclasses.dataclass
class StepProfile:
    gradient_accumulation_steps: int
    local_train_micro_batch_size: int
    sequence_length: int
    dp_degree: int

    def __post_init__(self):
        for f in dataclasses.fields(self):
            check_int(f.name, getattr(self, f.name), ge=1)


@dataclasses.dataclass
class ConsistencyEnforcement:
    enforce_tokens_per_step_consistency: bool = True
    enforce_last_step_logged: bool = True
    enforce_last_step_evaluated: bool = True
    enforce_last_step_checkpointed: bool = True
    enforce_enough_tokens_in_dataset: bool = True

    def __post_init__(self):
        for f in dataclasses.fields(self):
            check_bool(f.name, getattr(self, f.name))


@dataclasses.dataclass
class Intervals:
    training_log_interval_in_steps: int
    checkpointing_interval_in_steps: int
    evaluation_interval_in_steps: int

    def __post_init__(self):
        for f in dataclasses.fields(self):
            check_int(f.name, getattr(self, f.name), ge=1)


@dataclasses.dataclass
class TrainingTarget:
    num_target_tokens: int
    num_target_steps: int

    def __post_init__(self):
        check_int("num_target_tokens", self.num_target_tokens, ge=1)
        check_int("num_target_steps", self.num_target_steps, ge=1)


@dataclasses.dataclass
class TrainingProgressSettings:
    global_num_seen_tokens: int
    num_seen_steps: int
    num_seen_samples: int
    last_step: int

    def __post_init__(self):
        check_int("global_num_seen_tokens", self.global_num_seen_tokens, ge=0)
        check_int("num_seen_steps", self.num_seen_steps, ge=0)
        check_int("num_seen_samples", self.num_seen_samples, ge=0)
        check_int("last_step", self.last_step, ge=-1)


@dataclasses.dataclass
class WarmstartCheckpointPaths:
    checkpoint_folder_path: Path

    def __post_init__(self):
        self.checkpoint_folder_path = Path(check_str("checkpoint_folder_path", str(self.checkpoint_folder_path)))


@dataclasses.dataclass
class TrainingSettings:
    experiment_id: str
    config_file_path: Any
    referencing_keys: dict
    paths: dict
    intervals: Any
    consistency_enforcement: Any
    step_profile: Any
    training_target: Any
    training_progress: Any
    cuda_env: Any = None  # the JAX settings' alias of dist_env
    dist_env: Any = None
    warmstart_checkpoint_paths: Any = None
    debugging: Any = None

    def __post_init__(self):
        check_str("experiment_id", self.experiment_id)
        check_dict("referencing_keys", self.referencing_keys)
        self.paths = {k: Path(v) for k, v in check_dict("paths", self.paths).items()}
        self.intervals = _section(Intervals, self.intervals, "intervals")
        self.consistency_enforcement = _section(ConsistencyEnforcement, self.consistency_enforcement,
                                                "consistency_enforcement")
        self.step_profile = _section(StepProfile, self.step_profile, "step_profile")
        self.training_target = _section(TrainingTarget, self.training_target, "training_target")
        self.training_progress = _section(TrainingProgressSettings, self.training_progress, "training_progress")
        if self.cuda_env is not None and self.dist_env is not None:
            raise ValueError("settings: give cuda_env or dist_env, not both")
        self.dist_env = _section(DistEnvSettings, self.dist_env or self.cuda_env or {}, "dist_env")
        self.cuda_env = self.dist_env
        if self.warmstart_checkpoint_paths is not None:
            self.warmstart_checkpoint_paths = _section(WarmstartCheckpointPaths, self.warmstart_checkpoint_paths,
                                                       "warmstart_checkpoint_paths")
        self._check_tokens_per_step()
        c = self.consistency_enforcement
        self._check_interval(self.intervals.training_log_interval_in_steps, "logged", c.enforce_last_step_logged)
        self._check_interval(self.intervals.evaluation_interval_in_steps, "evaluated", c.enforce_last_step_evaluated)
        self._check_interval(self.intervals.checkpointing_interval_in_steps, "checkpointed",
                             c.enforce_last_step_checkpointed)

    @property
    def tokens_per_step(self) -> int:
        p = self.step_profile
        return p.local_train_micro_batch_size * p.sequence_length * p.gradient_accumulation_steps * p.dp_degree

    def _remaining_steps(self) -> int:
        remaining = self.training_target.num_target_steps - self.training_progress.num_seen_steps
        if remaining <= 0:
            raise ValueError("num_target_steps must exceed num_seen_steps")
        return remaining

    def _check_tokens_per_step(self) -> None:
        remaining = self._remaining_steps()
        required = (self.training_target.num_target_tokens - self.training_progress.global_num_seen_tokens) / remaining
        if required != self.tokens_per_step:
            msg = (f"Required number of tokens per step is ({required}) which does not match the number of "
                   f"tokens per step ({self.tokens_per_step}) from the step profile.")
            if self.consistency_enforcement.enforce_tokens_per_step_consistency:
                raise ValueError(msg)
            logger.warning(msg)

    def _check_interval(self, interval: int, what: str, enforce: bool) -> None:
        remaining = self._remaining_steps()
        if remaining % interval != 0:
            msg = (f"Last step will not be {what}. Since remaining_steps ({remaining}) is not a multiple of the "
                   f"{what} interval ({interval})")
            if enforce:
                raise ValueError(msg)
            logger.warning(msg)


@dataclasses.dataclass
class TrainingComponentsInstantiationModel:
    settings: Any
    app_state: Any
    loss_fn: Any
    train_dataset: Any
    train_dataloader: Any
    eval_dataloaders: list
    progress_subscriber: Any
    evaluation_subscriber: Any
    checkpoint_saving: Any
    gradient_clipper: Any
    mfu_calculator: Any = None
    device_mesh: Any = None
    performance: Any = None
    model_raw: Any = None
    scheduled_pipeline: Any = None  # built for its effect on the model spec (pipeline.scheduled), as in JAX
    resilience: Any = None
    telemetry: Any = None

    def __post_init__(self):
        if isinstance(self.settings, dict):
            self.settings = validate_config(TrainingSettings, self.settings)
        dataset_tokens = len(self.train_dataset) * self.settings.step_profile.sequence_length
        expected = self.settings.training_target.num_target_tokens
        if dataset_tokens < expected:
            msg = f"Not enough tokens in dataset. Actual: {dataset_tokens}, Expected: >={expected}"
            if self.settings.consistency_enforcement.enforce_enough_tokens_in_dataset:
                raise ValueError(msg)
            logger.warning(msg)


# top-level components of the JAX training configs the port does not have
# yet: a config that sets one is refused, naming where it waits
UNPORTED_TRAINING_COMPONENTS = {
    "profiler": "the profiler component (ROADMAP.md, Queue 1 item 7)",
    "device_feeder": "the device feeder (ROADMAP.md, Queue 1 item 7)",
}

"""Config-time arithmetic between steps, tokens, samples and batches: the
port's copy of modalities_tpu/utils/number_conversion.py, with the configs
of the JAX registry's `number_conversion` variants (13 conversions and
`parallel_degree`) as dataclasses.

Warmstart configs build `settings.training_progress` through these: a
checkpoint folder's name is the metadata store, and seen/target steps and
tokens are parsed back out of it.
"""

from __future__ import annotations

import dataclasses
import math
import re
from pathlib import Path
from typing import Any, Optional

from modalities_tpu_torch.config.config import check_bool, check_int, check_str


def _extract_single_int(pattern: str, string: str) -> int:
    matches = re.findall(pattern, string)
    if len(matches) == 1:
        return int(matches[0])
    if len(matches) > 1:
        raise ValueError(
            f"Expected a single group in the match. Got {len(matches)} matches: {matches}. "
            f"Pattern: {pattern}, String: {string}"
        )
    raise ValueError(f"No match found for pattern {pattern} in {string}")


class NumberConversion:
    @staticmethod
    def get_local_num_batches_from_num_samples(num_ranks: int, global_num_samples: int,
                                               local_micro_batch_size: int) -> int:
        return global_num_samples // num_ranks // local_micro_batch_size

    @staticmethod
    def get_num_samples_from_num_tokens(num_tokens: int, sequence_length: int) -> int:
        return num_tokens // sequence_length

    @staticmethod
    def get_local_num_batches_from_num_tokens(num_ranks: int, global_num_tokens: int, sequence_length: int,
                                              local_micro_batch_size: int) -> int:
        return NumberConversion.get_local_num_batches_from_num_samples(
            num_ranks=num_ranks, global_num_samples=global_num_tokens // sequence_length,
            local_micro_batch_size=local_micro_batch_size,
        )

    @staticmethod
    def get_num_steps_from_num_samples(dp_degree: int, local_micro_batch_size: int, global_num_samples: int,
                                       gradient_accumulation_steps: int) -> int:
        return global_num_samples // dp_degree // local_micro_batch_size // gradient_accumulation_steps

    @staticmethod
    def get_num_steps_from_num_tokens(dp_degree: int, local_micro_batch_size: int, global_num_tokens: int,
                                      sequence_length: int, gradient_accumulation_steps: int) -> int:
        return NumberConversion.get_num_steps_from_num_samples(
            dp_degree=dp_degree, local_micro_batch_size=local_micro_batch_size,
            global_num_samples=global_num_tokens // sequence_length,
            gradient_accumulation_steps=gradient_accumulation_steps,
        )

    @staticmethod
    def get_num_tokens_from_num_steps(num_steps: int, dp_degree: int, local_micro_batch_size: int,
                                      sequence_length: int, gradient_accumulation_steps: int) -> int:
        return num_steps * dp_degree * local_micro_batch_size * sequence_length * gradient_accumulation_steps

    @staticmethod
    def get_last_step_from_checkpoint_path(checkpoint_path: Path) -> int:
        return _extract_single_int(r"seen_steps_(\d+)", str(checkpoint_path)) - 1

    @staticmethod
    def get_num_seen_steps_from_checkpoint_path(checkpoint_path: Path) -> int:
        return _extract_single_int(r"seen_steps_(\d+)", str(checkpoint_path))

    @staticmethod
    def get_global_num_seen_tokens_from_checkpoint_path(checkpoint_path: Path) -> int:
        return _extract_single_int(r"seen_tokens_(\d+)", str(checkpoint_path))

    @staticmethod
    def get_global_num_target_tokens_from_checkpoint_path(checkpoint_path: Path) -> int:
        return _extract_single_int(r"target_tokens_(\d+)", str(checkpoint_path))

    @staticmethod
    def get_num_target_steps_from_checkpoint_path(checkpoint_path: Path) -> int:
        tokens_per_step = NumberConversion.get_global_num_seen_tokens_from_checkpoint_path(checkpoint_path) / (
            NumberConversion.get_last_step_from_checkpoint_path(checkpoint_path) + 1
        )
        global_num_target_tokens = NumberConversion.get_global_num_target_tokens_from_checkpoint_path(checkpoint_path)
        num_target_steps = global_num_target_tokens // tokens_per_step
        if isinstance(num_target_steps, float) and not num_target_steps.is_integer():
            raise ValueError(f"Number of steps calculated is not an integer. {num_target_steps}")
        return int(num_target_steps)

    @staticmethod
    def get_num_tokens_from_packed_mem_map_dataset_continuous(
        dataset_path: Path, sequence_length: int, dp_degree: int, local_micro_batch_size: int,
        gradient_accumulation_steps: int, sample_key: str, reuse_last_target: bool = True,
    ) -> int:
        """Trainable tokens of a .pbin dataset: its token count rounded down to
        a whole number of optimizer steps."""
        from modalities_tpu_torch.dataloader.dataset import get_packed_mem_map_dataset_continuous

        dataset = get_packed_mem_map_dataset_continuous(Path(dataset_path), sequence_length, sample_key,
                                                        reuse_last_target=reuse_last_target)
        num_steps = NumberConversion.get_num_steps_from_num_tokens(
            dp_degree=dp_degree, local_micro_batch_size=local_micro_batch_size,
            global_num_tokens=len(dataset) * sequence_length, sequence_length=sequence_length,
            gradient_accumulation_steps=gradient_accumulation_steps,
        )
        return NumberConversion.get_num_tokens_from_num_steps(
            num_steps=num_steps, dp_degree=dp_degree, local_micro_batch_size=local_micro_batch_size,
            sequence_length=sequence_length, gradient_accumulation_steps=gradient_accumulation_steps,
        )

    @staticmethod
    def get_parallel_degree(device_mesh, parallelism_methods: list[str]) -> int:
        """The product of the mesh degrees of the given methods (e.g.
        ["dp_replicate", "dp_shard"]: the data-parallel world)."""
        return math.prod(device_mesh.get_parallel_degree(m) for m in parallelism_methods)

    @staticmethod
    def get_num_steps_from_raw_dataset_index(raw_index_path: Path, num_ranks: int, local_micro_batch_size: int,
                                             gradient_accumulation_steps: int) -> int:
        import pickle

        with Path(raw_index_path).open("rb") as f:
            index = pickle.load(f)
        return NumberConversion.get_num_steps_from_num_samples(
            dp_degree=num_ranks, local_micro_batch_size=local_micro_batch_size, global_num_samples=len(index),
            gradient_accumulation_steps=gradient_accumulation_steps,
        )


# --------------------------------------------------------------------------
# The configs of the `number_conversion` variants (the JAX pydantic models'
# fields and bounds)


def _check_fields(obj, positive=(), non_negative=()) -> None:
    for name in positive:
        check_int(name, getattr(obj, name), ge=1)
    for name in non_negative:
        check_int(name, getattr(obj, name), ge=0)


@dataclasses.dataclass
class LocalNumBatchesFromNumSamplesConfig:
    num_ranks: int
    global_num_samples: int
    local_micro_batch_size: int

    def __post_init__(self):
        _check_fields(self, ("num_ranks", "local_micro_batch_size"), ("global_num_samples",))


@dataclasses.dataclass
class LocalNumBatchesFromNumTokensConfig:
    num_ranks: int
    global_num_tokens: int
    sequence_length: int
    local_micro_batch_size: int

    def __post_init__(self):
        _check_fields(self, ("num_ranks", "sequence_length", "local_micro_batch_size"), ("global_num_tokens",))


@dataclasses.dataclass
class NumSamplesFromNumTokensConfig:
    num_tokens: int
    sequence_length: int

    def __post_init__(self):
        _check_fields(self, ("sequence_length",), ("num_tokens",))


@dataclasses.dataclass
class NumStepsFromNumSamplesConfig:
    dp_degree: int
    local_micro_batch_size: int
    global_num_samples: int
    gradient_accumulation_steps: int

    def __post_init__(self):
        _check_fields(self, ("dp_degree", "local_micro_batch_size", "gradient_accumulation_steps"),
                      ("global_num_samples",))


@dataclasses.dataclass
class NumStepsFromNumTokensConfig:
    dp_degree: int
    local_micro_batch_size: int
    global_num_tokens: int
    sequence_length: int
    gradient_accumulation_steps: int

    def __post_init__(self):
        _check_fields(self, ("dp_degree", "local_micro_batch_size", "sequence_length", "gradient_accumulation_steps"),
                      ("global_num_tokens",))


@dataclasses.dataclass
class NumTokensFromNumStepsConfig:
    num_steps: int
    dp_degree: int
    local_micro_batch_size: int
    sequence_length: int
    gradient_accumulation_steps: int

    def __post_init__(self):
        _check_fields(self, ("dp_degree", "local_micro_batch_size", "sequence_length", "gradient_accumulation_steps"),
                      ("num_steps",))


@dataclasses.dataclass
class NumberConversionFromCheckpointPathConfig:
    checkpoint_path: Path

    def __post_init__(self):
        self.checkpoint_path = Path(check_str("checkpoint_path", str(self.checkpoint_path)))


@dataclasses.dataclass
class NumTokensFromPackedMemMapDatasetContinuousConfig:
    dataset_path: Path
    sequence_length: int
    dp_degree: int
    local_micro_batch_size: int
    gradient_accumulation_steps: int
    sample_key: str = "text"
    reuse_last_target: bool = True

    def __post_init__(self):
        self.dataset_path = Path(self.dataset_path)
        _check_fields(self, ("sequence_length", "dp_degree", "local_micro_batch_size", "gradient_accumulation_steps"))
        check_str("sample_key", self.sample_key)
        check_bool("reuse_last_target", self.reuse_last_target)


@dataclasses.dataclass
class NumStepsFromRawDatasetIndexConfig:
    """`dp_degree` is accepted in place of `num_ranks`, as the JAX config's
    alias accepts it."""

    raw_index_path: Path
    local_micro_batch_size: int
    gradient_accumulation_steps: int
    num_ranks: Optional[int] = None
    dp_degree: Optional[int] = None

    def __post_init__(self):
        self.raw_index_path = Path(self.raw_index_path)
        if (self.num_ranks is None) == (self.dp_degree is None):
            raise ValueError("give one of num_ranks and its alias dp_degree")
        self.num_ranks = self.num_ranks if self.num_ranks is not None else self.dp_degree
        _check_fields(self, ("num_ranks", "local_micro_batch_size", "gradient_accumulation_steps"))


@dataclasses.dataclass
class ParallelDegreeConfig:
    device_mesh: Any
    parallelism_methods: list

    def __post_init__(self):
        if not isinstance(self.parallelism_methods, list):
            raise ValueError(f"parallelism_methods: expected a list, got {self.parallelism_methods!r}")


def _num_steps_from_raw_dataset_index(raw_index_path, local_micro_batch_size, gradient_accumulation_steps,
                                      num_ranks, dp_degree=None) -> int:
    """The registry entry over NumStepsFromRawDatasetIndexConfig's fields (its
    check has set num_ranks from either spelling)."""
    return NumberConversion.get_num_steps_from_raw_dataset_index(raw_index_path, num_ranks, local_micro_batch_size,
                                                                 gradient_accumulation_steps)


# (variant key, function, config): the JAX registry's `number_conversion` entries
NUMBER_CONVERSIONS = [
    ("local_num_batches_from_num_samples", NumberConversion.get_local_num_batches_from_num_samples,
     LocalNumBatchesFromNumSamplesConfig),
    ("local_num_batches_from_num_tokens", NumberConversion.get_local_num_batches_from_num_tokens,
     LocalNumBatchesFromNumTokensConfig),
    ("num_samples_from_num_tokens", NumberConversion.get_num_samples_from_num_tokens, NumSamplesFromNumTokensConfig),
    ("num_steps_from_num_samples", NumberConversion.get_num_steps_from_num_samples, NumStepsFromNumSamplesConfig),
    ("num_steps_from_num_tokens", NumberConversion.get_num_steps_from_num_tokens, NumStepsFromNumTokensConfig),
    ("num_tokens_from_num_steps", NumberConversion.get_num_tokens_from_num_steps, NumTokensFromNumStepsConfig),
    ("last_step_from_checkpoint_path", NumberConversion.get_last_step_from_checkpoint_path,
     NumberConversionFromCheckpointPathConfig),
    ("num_seen_steps_from_checkpoint_path", NumberConversion.get_num_seen_steps_from_checkpoint_path,
     NumberConversionFromCheckpointPathConfig),
    ("global_num_seen_tokens_from_checkpoint_path", NumberConversion.get_global_num_seen_tokens_from_checkpoint_path,
     NumberConversionFromCheckpointPathConfig),
    ("global_num_target_tokens_from_checkpoint_path",
     NumberConversion.get_global_num_target_tokens_from_checkpoint_path, NumberConversionFromCheckpointPathConfig),
    ("num_target_steps_from_checkpoint_path", NumberConversion.get_num_target_steps_from_checkpoint_path,
     NumberConversionFromCheckpointPathConfig),
    ("num_tokens_from_packed_mem_map_dataset_continuous",
     NumberConversion.get_num_tokens_from_packed_mem_map_dataset_continuous,
     NumTokensFromPackedMemMapDatasetContinuousConfig),
    ("num_steps_from_raw_dataset_index", _num_steps_from_raw_dataset_index, NumStepsFromRawDatasetIndexConfig),
    ("parallel_degree", NumberConversion.get_parallel_degree, ParallelDegreeConfig),
]

"""Samplers and the batch sampler: the port's copy of
modalities_tpu/dataloader/samplers.py and sampler_factory.py.

`ResumableDistributedSampler` shuffles with numpy PCG64(seed + epoch), as the
JAX sampler does, so the port reads the JAX package's sample order; the
`resumable_distributed_multi_dim_sampler` variant takes its replica count
(dcn * dp_replicate * dp_shard) and rank (this rank's flat dp coordinate,
dcn outermost) from the device mesh, so the cp ranks of one dp coordinate
read the same samples and each takes its chunk of their sequence in the
train step. The ranks of a slice read a contiguous block of coordinates, as
the processes of a JAX slice do (the JAX loader deals samples to processes
the same way and a slice owns its processes' block of the global batch).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Iterator, Optional

import numpy as np

from modalities_tpu_torch.config.config import check_bool, check_int, check_str
from modalities_tpu_torch.running_env.device_mesh import get_data_loading_info


class ResumableDistributedSampler:
    def __init__(self, dataset, rank: int, num_replicas: Optional[int] = None, epoch: int = 0,
                 shuffle: bool = False, seed: int = 0, drop_last: bool = False, skip_num_global_samples: int = 0):
        num_replicas = 1 if num_replicas is None else num_replicas
        if rank >= num_replicas or rank < 0:
            raise ValueError(f"Invalid rank {rank}, rank should be in the interval [0, {num_replicas - 1}]")
        self.dataset = dataset
        self.rank = rank
        self.num_replicas = num_replicas
        self.epoch = epoch
        self.drop_last = drop_last
        self.skip_num_global_samples = skip_num_global_samples
        self.global_num_samples = len(self.dataset) - self.skip_num_global_samples
        if self.drop_last and self.global_num_samples % self.num_replicas != 0:
            self.local_num_samples = math.ceil((self.global_num_samples - self.num_replicas) / self.num_replicas)
        else:
            self.local_num_samples = math.ceil(self.global_num_samples / self.num_replicas)
        self.global_num_samples_effective = self.local_num_samples * self.num_replicas
        self.shuffle = shuffle
        self.seed = seed

    def __iter__(self) -> Iterator[int]:
        if self.shuffle:
            rng = np.random.Generator(np.random.PCG64(self.seed + self.epoch))
            indices_full = rng.permutation(len(self.dataset)).tolist()
        else:
            indices_full = list(range(len(self.dataset)))
        indices = indices_full[self.skip_num_global_samples :]
        if not self.drop_last:
            padding_size = self.global_num_samples_effective - len(indices)
            if padding_size <= len(indices_full):
                indices += indices_full[:padding_size]
            else:
                indices += (indices_full * math.ceil(padding_size / len(indices_full)))[:padding_size]
        else:
            indices = indices[: self.global_num_samples_effective]
        if len(indices) != self.global_num_samples_effective:
            raise ValueError(
                f"global_num_samples_effective ({self.global_num_samples_effective}) does not match the "
                f"actual number of samples ({len(indices)})"
            )
        indices = indices[self.rank : self.global_num_samples_effective : self.num_replicas]
        return iter(indices)

    def __len__(self) -> int:
        return self.local_num_samples


class BatchSampler:
    """Groups sampler indices into micro-batches."""

    def __init__(self, sampler, batch_size: int, drop_last: bool = False):
        self.sampler = sampler
        self.batch_size = batch_size
        self.drop_last = drop_last

    def __iter__(self) -> Iterator[list[int]]:
        batch: list[int] = []
        for idx in self.sampler:
            batch.append(idx)
            if len(batch) == self.batch_size:
                yield batch
                batch = []
        if batch and not self.drop_last:
            yield batch

    def __len__(self) -> int:
        if self.drop_last:
            return len(self.sampler) // self.batch_size
        return math.ceil(len(self.sampler) / self.batch_size)


@dataclasses.dataclass
class ResumableDistributedMultiDimSamplerConfig:
    dataset: Any
    device_mesh: Any
    data_parallel_key: str = "dp_shard"
    epoch: int = 0
    shuffle: Optional[bool] = False
    seed: Optional[int] = 0
    drop_last: bool = True
    skip_num_global_samples: int = 0

    def __post_init__(self):
        check_str("data_parallel_key", self.data_parallel_key)
        check_int("epoch", self.epoch, ge=0)
        check_bool("shuffle", self.shuffle, optional=True)
        check_int("seed", self.seed, optional=True)
        if self.drop_last is not True:
            raise ValueError("drop_last: the multi-dim sampler requires true")
        check_int("skip_num_global_samples", self.skip_num_global_samples, ge=0)


@dataclasses.dataclass
class BatchSamplerConfig:
    sampler: Any
    batch_size: int
    drop_last: bool = True
    device_mesh: Any = None

    def __post_init__(self):
        check_int("batch_size", self.batch_size, ge=1)
        if self.drop_last is not True:
            raise ValueError("drop_last: the batch sampler requires true")


def create_resumable_distributed_multi_dim_sampler(dataset, device_mesh, data_parallel_key: str = "dp_shard",
                                                   epoch: int = 0, shuffle: bool = False, seed: int = 0,
                                                   drop_last: bool = True, skip_num_global_samples: int = 0):
    num_replicas, rank = get_data_loading_info(device_mesh)
    return ResumableDistributedSampler(dataset, rank, num_replicas, epoch, bool(shuffle), seed or 0, drop_last,
                                       skip_num_global_samples)


def create_batch_sampler(sampler, batch_size: int, drop_last: bool = True, device_mesh=None) -> BatchSampler:
    """`batch_size` is the per-rank micro batch (the dp ranks' together make the global one)."""
    return BatchSampler(sampler, batch_size, drop_last)

"""The batch container, the GPT2 collator and the data loader: the port's copy
of modalities_tpu/batch.py:DatasetBatch, models/gpt2/collator.py and
dataloader/dataloader.py. Batches stay host-side numpy until the trainer
moves a step's microbatches to the device (`device_tensor`).
"""

from __future__ import annotations

import dataclasses
import queue
import threading
from typing import Any, Iterator, Optional

import numpy as np
import torch

from modalities_tpu_torch.config.config import check_int, check_str


def device_tensor(array, device) -> torch.Tensor:
    """A host batch array on `device`: integers (token ids) as int64, floats
    (a dict-in model's images) as float32, the dtype the JAX package's device
    put gives a float64 array."""
    array = np.asarray(array)
    dtype = np.float32 if np.issubdtype(array.dtype, np.floating) else np.int64
    return torch.from_numpy(array.astype(dtype)).to(device, non_blocking=True)


@dataclasses.dataclass
class DatasetBatch:
    samples: dict
    targets: dict

    def __len__(self) -> int:
        return next(iter(self.samples.values())).shape[0]


@dataclasses.dataclass
class GPT2LLMCollateFn:
    """CLM collator: inputs = tokens[:-1], targets = tokens[1:]."""

    sample_key: str
    target_key: str

    def __post_init__(self):
        check_str("sample_key", self.sample_key)
        check_str("target_key", self.target_key)

    def __call__(self, batch: list[dict]) -> DatasetBatch:
        tokens = np.stack([np.asarray(d[self.sample_key]) for d in batch])
        return DatasetBatch(samples={self.sample_key: tokens[:, :-1]}, targets={self.target_key: tokens[:, 1:]})


@dataclasses.dataclass
class LLMDataLoader:
    """Batch-sampler-driven loader; one background thread keeps
    `num_prefetch_batches` collated batches ready."""

    dataloader_tag: str
    dataset: Any
    batch_sampler: Any
    collate_fn: Any = None
    num_prefetch_batches: int = 2
    num_workers: Optional[int] = None  # torch DataLoader knobs, accepted for config parity
    pin_memory: Optional[bool] = None

    def __post_init__(self):
        check_str("dataloader_tag", self.dataloader_tag)
        check_int("num_prefetch_batches", self.num_prefetch_batches, ge=0)

    def __len__(self) -> int:
        return len(self.batch_sampler)

    def _load_batch(self, indices: list[int]):
        items = [self.dataset[i] for i in indices]
        return self.collate_fn(items) if self.collate_fn is not None else items

    def __iter__(self) -> Iterator:
        if self.num_prefetch_batches <= 0:
            for indices in self.batch_sampler:
                yield self._load_batch(indices)
            return
        q: queue.Queue = queue.Queue(maxsize=self.num_prefetch_batches)
        done = object()
        error: list[BaseException] = []
        stop = threading.Event()

        def producer() -> None:
            try:
                for indices in self.batch_sampler:
                    if stop.is_set():
                        return
                    q.put(self._load_batch(indices))
            except BaseException as e:  # handed to the consumer
                error.append(e)
            finally:
                q.put(done)

        thread = threading.Thread(target=producer, daemon=True)
        thread.start()
        try:
            while True:
                item = q.get()
                if item is done:
                    if error:
                        raise error[0]
                    return
                yield item
        finally:
            stop.set()
            while thread.is_alive():  # unblock a producer waiting on a full queue
                try:
                    q.get(timeout=0.1)
                except queue.Empty:
                    pass

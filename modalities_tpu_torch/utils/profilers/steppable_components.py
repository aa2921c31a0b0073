"""Steppable components driven by the profiler harness: the port of
modalities_tpu/utils/profilers/steppable_components.py.

`RandomDatasetBatchGenerator` draws with `numpy.random.default_rng(seed)` as
the JAX generator does, so one seed gives the JAX package's tokens bit for
bit. `SteppableForwardPass` steps the port's `TrainStep` (its `eval_step`
without the backward) on those batches: the step is built at the first
step, and each step ends in a host read of the loss, which waits for the
step's device work (JAX's `hard_sync`).
"""

from __future__ import annotations

import dataclasses
import logging
from abc import ABC, abstractmethod
from typing import Any, Optional

import numpy as np

from modalities_tpu_torch.config.config import check_bool, check_dict, check_int, check_str

logger = logging.getLogger(__name__)


class SteppableComponentIF(ABC):
    @abstractmethod
    def step(self) -> None: ...


class RandomDatasetBatchGenerator:
    """Random batches with fixed shapes. Two config shapes, both supported:

    - named-field: sample_key/target_key/micro_batch_size/sequence_length/
      vocab_size — token batches for the train and eval steps.
    - dims-style: dims (ordered name->size), data_type (int64 | float32 |
      bfloat16 | float16), min_val, max_val — arbitrary-shape arrays under
      the fixed keys input_ids/target_ids, used by the profiling tutorials
      (e.g. a [batch, seq, hidden] float batch for norms).
    """

    def __init__(self, sample_key: str = "input_ids", target_key: str = "target_ids",
                 micro_batch_size: int = 1, sequence_length: int = 128,
                 vocab_size: int = 256, seed: int = 0, dims=None, data_type=None,
                 min_val: int = 0, max_val: int = 256):
        self.sample_key = sample_key
        self.target_key = target_key
        self.micro_batch_size = micro_batch_size
        self.sequence_length = sequence_length
        self.vocab_size = vocab_size
        self.dims = dict(dims) if dims else None
        self.data_type = str(data_type) if data_type is not None else None
        self.min_val = min_val
        self.max_val = max_val
        self._rng = np.random.default_rng(seed)
        self._warned_caps: set = set()

    def _capped(self, configured: int, vocab_cap: int | None, field: str) -> int:
        """Clamp the token draw ceiling to the profiled model's vocab, warning once
        per distinct clamp (not per profiled step — get_batch runs in the hot loop)."""
        if vocab_cap is None or configured <= vocab_cap:
            return configured
        key = (field, configured, vocab_cap)
        if key not in self._warned_caps:
            self._warned_caps.add(key)
            logger.warning(
                "batch generator %s=%d exceeds the profiled model's vocab_size=%d; "
                "clamping token draws to the model vocab",
                field, configured, vocab_cap,
            )
        return vocab_cap

    def get_batch(self, num_microbatches: int = 1, vocab_cap: int | None = None) -> dict:
        """Token batches [num_microbatches, batch, seq] (numpy int32) for the
        train and eval steps. `vocab_cap` (the profiled model's vocab_size) clamps the
        draw range: out-of-range ids would profile a distorted embedding
        access instead of failing or correcting."""
        if self.dims is not None:
            # dims-style: derive token batches from the declared batch/seq sizes
            size = tuple(self.dims.values())
            batch, seq = size[0], size[1] if len(size) > 1 else self.sequence_length
            hi = self._capped(self.max_val, vocab_cap, "max_val")
            lo = min(self.min_val, hi - 1)
            tokens = self._rng.integers(lo, hi, size=(num_microbatches, batch, seq + 1))
        else:
            hi = self._capped(self.vocab_size, vocab_cap, "vocab_size")
            tokens = self._rng.integers(
                0, hi,
                size=(num_microbatches, self.micro_batch_size, self.sequence_length + 1),
            )
        return {
            "samples": {self.sample_key: tokens[:, :, :-1].astype(np.int32)},
            "targets": {self.target_key: tokens[:, :, 1:].astype(np.int32)},
        }

    def get_dataset_batch(self):
        """One DatasetBatch of shape tuple(dims.values()) under the fixed
        input_ids/target_ids keys: numpy arrays, or CPU torch tensors for the
        16-bit float types (numpy has no bfloat16)."""
        from modalities_tpu_torch.dataloader.dataloader import DatasetBatch

        if self.dims is not None:
            size = tuple(self.dims.values())
        else:
            size = (self.micro_batch_size, self.sequence_length)
        dtype = self.data_type or "int64"
        if "int" in dtype:
            inputs = self._rng.integers(self.min_val, self.max_val, size=size)
            targets = self._rng.integers(self.min_val, self.max_val, size=size)
        elif dtype in ("float32", "bfloat16", "float16"):
            span = self.max_val - self.min_val
            inputs = (self._rng.random(size=size) * span + self.min_val).astype(np.float32)
            targets = (self._rng.random(size=size) * span + self.min_val).astype(np.float32)
            if dtype != "float32":
                import torch

                inputs = torch.from_numpy(inputs).to(getattr(torch, dtype))
                targets = torch.from_numpy(targets).to(getattr(torch, dtype))
        else:
            raise ValueError(f"Unsupported data type: {self.data_type}")
        return DatasetBatch(samples={"input_ids": inputs}, targets={"target_ids": targets})


def _to_device(batch: dict, device) -> dict:
    import torch

    return {part: {k: torch.from_numpy(np.ascontiguousarray(v)).to(device=device, dtype=torch.int64)
                   for k, v in tensors.items()} for part, tensors in batch.items()}


class SteppableForwardPass(SteppableComponentIF):
    """Forward (and with `include_backward` the backward and the update) over
    random batches. `train_step` is the port's `TrainStep`, or a zero-argument
    callable that builds one: then the build (the parameters' allocation and
    initialization) waits for the first step, as JAX's thunk does."""

    def __init__(self, train_step, batch_generator: RandomDatasetBatchGenerator,
                 include_backward: bool = True, gradient_accumulation_steps: int = 1, device_mesh=None):
        self._train_step = train_step if not callable(train_step) or hasattr(train_step, "eval_step") else None
        self._build = None if self._train_step is not None else train_step
        self.batch_generator = batch_generator
        self.include_backward = include_backward
        self.gradient_accumulation_steps = gradient_accumulation_steps
        self.device_mesh = device_mesh  # the mesh the step is built on (None: one device)
        self.losses: list[float] = []

    @property
    def train_step(self):
        if self._train_step is None:
            self._train_step = self._build()
        return self._train_step

    def _model_vocab(self) -> int | None:
        spec = getattr(self.train_step.model, "config_spec", None)
        return getattr(spec, "vocab_size", None)

    def step(self) -> None:
        step = self.train_step
        if self.include_backward:  # the train step takes [acc, mb, S]
            raw = self.batch_generator.get_batch(self.gradient_accumulation_steps, vocab_cap=self._model_vocab())
            metrics = step(_to_device(raw, step.device))
        else:  # eval_step takes a flat [mb, S] micro-batch
            raw = self.batch_generator.get_batch(1, vocab_cap=self._model_vocab())
            flat = {part: {k: v[0] for k, v in tensors.items()} for part, tensors in raw.items()}
            metrics = step.eval_step(_to_device(flat, step.device))
        self.losses.append(float(metrics["loss"]))  # the host read waits for the step's device work


# ------------------------------------------------------------------- configs

_NAMED = ("micro_batch_size", "sequence_length", "vocab_size")


@dataclasses.dataclass
class RandomDatasetBatchGeneratorConfig:
    """The named-field schema, or the dims-style one (dims/data_type/
    min_val/max_val): without `dims` all three named sizes must be given, so
    a misspelt field cannot profile a default-shaped batch."""

    sample_key: str = "input_ids"
    target_key: str = "target_ids"
    micro_batch_size: Optional[int] = None
    sequence_length: Optional[int] = None
    vocab_size: Optional[int] = None
    seed: int = 0
    dims: Optional[dict] = None
    data_type: Optional[str] = None
    min_val: int = 0
    max_val: int = 256

    def __post_init__(self):
        check_str("sample_key", self.sample_key)
        check_str("target_key", self.target_key)
        check_int("seed", self.seed)
        check_int("min_val", self.min_val)
        check_int("max_val", self.max_val)
        check_str("data_type", self.data_type, optional=True)
        if check_dict("dims", self.dims, optional=True) is not None:
            for name, size in self.dims.items():
                check_int(f"dims.{name}", size, ge=1)
        given = [name for name in _NAMED if getattr(self, name) is not None]
        if self.dims is None and len(given) < len(_NAMED):
            raise ValueError(
                "dataset_batch_generator.random needs either the reference dims-style "
                "schema (dims/data_type/min_val/max_val) or ALL of the named fields "
                f"{sorted(_NAMED)} — got only {sorted(given)}; "
                "a typo'd field name would otherwise silently profile a default-shaped batch")
        for name, default in zip(_NAMED, (1, 128, 256)):
            setattr(self, name, check_int(name, default if getattr(self, name) is None else getattr(self, name), ge=1))


@dataclasses.dataclass
class SteppableForwardPassConfig:
    """`dataset_batch_generator` is accepted for `batch_generator` (the
    reference name); without an optimizer only the forward is stepped."""

    model: Any
    batch_generator: Any = None
    dataset_batch_generator: Any = None
    loss_fn: Any = None
    optimizer: Any = None
    device_mesh: Any = None
    include_backward: Optional[bool] = None
    gradient_accumulation_steps: int = 1

    def __post_init__(self):
        if (self.batch_generator is None) == (self.dataset_batch_generator is None):
            raise ValueError("give batch_generator or its alias dataset_batch_generator")
        self.batch_generator = self.batch_generator or self.dataset_batch_generator
        self.dataset_batch_generator = None
        check_bool("include_backward", self.include_backward, optional=True)
        check_int("gradient_accumulation_steps", self.gradient_accumulation_steps, ge=1)


def steppable_forward_pass(model, batch_generator, dataset_batch_generator=None, loss_fn=None, optimizer=None,
                           device_mesh=None, include_backward=None, gradient_accumulation_steps=1,
                           device=None) -> SteppableForwardPass:
    """The registry's component (JAX registry/components.py:139-175): no
    optimizer means forward only (an AdamW spec is still made, as JAX's state
    needs one), no loss the CLM cross entropy on the generator's target key.
    The `TrainStep` is built at the first step on `device` (default: the
    card): with no `device_mesh` the module stays whole on one device, with
    one it takes the mesh's path (its process group must exist)."""
    from modalities_tpu_torch.device import resolve_device
    from modalities_tpu_torch.loss_functions import CLMCrossEntropyLoss
    from modalities_tpu_torch.optimizers.optimizer_factory import OptimizerFactory

    device = resolve_device(device)
    if include_backward is None:
        include_backward = optimizer is not None
    if loss_fn is None:
        loss_fn = CLMCrossEntropyLoss(target_key=getattr(batch_generator, "target_key", "target_ids"),
                                      prediction_key=model.prediction_key)
    if optimizer is None:
        optimizer = OptimizerFactory.get_adam_w(lr=1e-4, betas=(0.9, 0.95), eps=1e-8, weight_decay=0.0,
                                                weight_decay_groups_excluded=[], wrapped_model=model)

    def build():
        from modalities_tpu_torch.training.train_step import TrainStep

        return TrainStep(model, loss_fn, optimizer, device=device, gradient_acc_steps=gradient_accumulation_steps,
                         device_mesh=device_mesh)

    return SteppableForwardPass(build, batch_generator, include_backward=include_backward,
                                gradient_accumulation_steps=gradient_accumulation_steps, device_mesh=device_mesh)

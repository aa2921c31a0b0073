"""Model transform variants: the port of modalities_tpu/models/model_factory.py
for the variants the training path uses. Each records a descriptor on the
model's `TrainSpec`, applied when the train step is built (the train step
applies the tensor-parallel plan of parallel/tensor_parallel.py over the
mesh's tp axis, then shards the model over its dp dims with
parallel/fsdp.py; under a pp axis it does so to this rank's pipeline stage,
parallel/pipeline.py).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional

from modalities_tpu_torch.config.config import check_bool, check_dict, check_int
from modalities_tpu_torch.models.gpt2.gpt2_model import FSDPSpec, MixedPrecisionSpec
from modalities_tpu_torch.parallel.pipeline_schedules import SUPPORTED_SCHEDULES, canonical_schedule_name
from modalities_tpu_torch.training.activation_checkpointing import apply_activation_checkpointing

# the GPT2 blocks: unset, the upstream torch module's path, or the port's own attribute
_BLOCKS_FQNS = (None, "transformer.h", "blocks")


def _parse_dtype_name(name) -> str:
    """jax / torch dtype names ("bfloat16", "torch.bfloat16") and the reference's
    enum spellings ("BF_16"); FP_16 maps to bfloat16 as in the JAX package."""
    text = str(name).split(".")[-1]
    return {"BF_16": "bfloat16", "FP_16": "bfloat16", "FP_32": "float32"}.get(text.upper(), text.lower())


@dataclasses.dataclass
class FSDP2WrappedModelConfig:
    model: Any
    device_mesh: Any = None
    mixed_precision_settings: Optional[dict] = None
    block_names: Optional[list] = None  # accepted for config parity: the units are the GPT2 blocks
    layers_per_fsdp_unit: Optional[int] = None
    reshard_after_forward: bool = True

    def __post_init__(self):
        check_dict("mixed_precision_settings", self.mixed_precision_settings, optional=True)
        check_int("layers_per_fsdp_unit", self.layers_per_fsdp_unit, ge=1, optional=True)
        check_bool("reshard_after_forward", self.reshard_after_forward)


@dataclasses.dataclass
class GPT2TPModelConfig:
    model: Any
    device_mesh: Any


def virtual_stages(pp_schedule_name: str, num_virtual_stages: Optional[int]) -> Optional[int]:
    """The chunks a device of the schedule runs (JAX config.py:164-210's
    checks and messages): the V schedules take exactly 2 (unset or 1 read
    as 2), interleaved_1f1b 2 or more (unset: 2), gpipe and 1f1b 1. None for
    a name that is no schedule (the model factory refuses it)."""
    name = canonical_schedule_name(pp_schedule_name)
    if name in ("zbv", "dualpipev"):
        if num_virtual_stages not in (None, 1, 2):
            raise ValueError(
                f"pp_schedule_name: {pp_schedule_name!r} uses exactly 2 virtual chunks (the V shape); set "
                f"num_virtual_stages to 2 or leave it unset (got num_virtual_stages: {num_virtual_stages})")
        return 2
    if name == "interleaved_1f1b":
        if num_virtual_stages is not None and num_virtual_stages < 2:
            raise ValueError("pp_schedule_name: 'interleaved_1f1b' requires num_virtual_stages >= 2 "
                             f"(got num_virtual_stages: {num_virtual_stages})")
        return 2 if num_virtual_stages is None else num_virtual_stages
    if name in ("gpipe", "1f1b"):
        if num_virtual_stages is not None and num_virtual_stages != 1:
            raise ValueError(f"num_virtual_stages: {num_virtual_stages} requires pp_schedule_name: "
                             f"'interleaved_1f1b' (got pp_schedule_name: {pp_schedule_name!r})")
        return 1
    return None


@dataclasses.dataclass
class PipelinedModelConfig:
    """The `pipelined` variant's schema and its schedule / num_virtual_stages
    checks at config time (`virtual_stages`); an unknown schedule name
    passes through to the model factory, which refuses it."""

    model: Any
    pp_schedule_name: str = "1f1b"
    num_microbatches: Optional[int] = None
    batch_size: Optional[int] = None
    microbatch_size: Optional[int] = None
    num_virtual_stages: Optional[int] = None

    def __post_init__(self):
        for name in ("num_microbatches", "batch_size", "microbatch_size", "num_virtual_stages"):
            check_int(name, getattr(self, name), ge=1, optional=True)
        virtual_stages(self.pp_schedule_name, self.num_virtual_stages)


@dataclasses.dataclass
class WeightInitializedModelConfig:
    model: Any
    model_initializer: Any


@dataclasses.dataclass
class ActivationCheckpointedModelConfig:
    model: Any
    activation_checkpointing_variant: str = "full_activation_checkpointing"
    layers_fqn: Optional[str] = None
    ac_freq: int = 1
    save_list: Optional[list] = None
    device_mesh: Any = None


class ModelFactory:
    @staticmethod
    def get_gpt2_tp_model(model, device_mesh):
        """The `gpt2_tp` variant (JAX config.py:149-154). In the JAX package
        it is the identity: the mesh's tp axis shards the model by rule. Here
        too the mesh decides: the train step applies the plan
        (parallel/tensor_parallel.py) whenever its mesh has tp > 1, and at
        tp 1 the variant changes nothing. It requires the mesh component."""
        if not hasattr(device_mesh, "tensor_parallel_degree"):
            raise ValueError(f"gpt2_tp: device_mesh must be the device_mesh component, got {device_mesh!r}")
        return model

    @staticmethod
    def get_fsdp2_wrapped_model(model, device_mesh=None, mixed_precision_settings=None, block_names=None,
                                layers_per_fsdp_unit=None, reshard_after_forward=True):
        """Records the mixed-precision policy (param and reduce dtypes; JAX
        model_factory.py:34-52, models/model.py:35-38) and the FSDP2 units
        (`layers_per_fsdp_unit` blocks a unit, `reshard_after_forward`); the
        train step shards over its device mesh when it is built."""
        model.update_train_spec(fsdp=FSDPSpec(layers_per_fsdp_unit, reshard_after_forward))
        if mixed_precision_settings:
            model.update_train_spec(mixed_precision=MixedPrecisionSpec(
                param_dtype=_parse_dtype_name(mixed_precision_settings.get("param_dtype", "float32")),
                reduce_dtype=_parse_dtype_name(mixed_precision_settings.get("reduce_dtype", "float32")),
            ))
        return model

    @staticmethod
    def get_pipelined_model(model, pp_schedule_name: str = "1f1b", num_microbatches: Optional[int] = None,
                            batch_size: Optional[int] = None, microbatch_size: Optional[int] = None,
                            num_virtual_stages: Optional[int] = None):
        """The pipeline schedule on the model's spec (JAX
        model_factory.py:114-181): `pp_schedule`, `pp_num_microbatches`
        (given, or batch_size // microbatch_size) and `pp_num_virtual`
        (`virtual_stages`: the schema's checks and messages, where the JAX
        factory words the same refusals its own way). The mesh's pp axis
        decides whether it runs (training/train_step.py)."""
        name = canonical_schedule_name(pp_schedule_name)
        if name not in SUPPORTED_SCHEDULES:
            raise NotImplementedError(
                f"pipeline schedule {pp_schedule_name!r} not supported (have: gpipe, 1f1b, interleaved_1f1b, zbv, "
                "dualpipev — all five reference schedules, pipeline_parallelism.py:13-20)")
        num_virtual_stages = virtual_stages(pp_schedule_name, num_virtual_stages)
        if num_microbatches is None and (batch_size is not None) != (microbatch_size is not None):
            raise ValueError("pipelined model: batch_size and microbatch_size must be given together")
        if num_microbatches is None and batch_size is not None:
            if batch_size % microbatch_size != 0:
                raise ValueError(f"batch_size ({batch_size}) must be divisible by microbatch_size ({microbatch_size})")
            num_microbatches = batch_size // microbatch_size
        if not hasattr(model, "with_spec_updates"):
            raise NotImplementedError("pipelined model variant requires a staged model (gpt2)")
        return model.with_spec_updates(pp_schedule=name, pp_num_microbatches=num_microbatches,
                                       pp_num_virtual=num_virtual_stages)

    @staticmethod
    def get_weight_initialized_model(model, model_initializer):
        model.update_train_spec(init_routines=model.train_spec.init_routines + (model_initializer,))
        return model

    @staticmethod
    def get_activation_checkpointed_model(model, activation_checkpointing_variant="full_activation_checkpointing",
                                          layers_fqn=None, ac_freq=1, save_list=None, device_mesh=None):
        """Records the remat variant on the model's spec (JAX
        model_factory.py:101-111). The port remats whole transformer blocks:
        `layers_fqn` may only name them, and a `save_list` (selective_op's
        policies) is refused. `device_mesh` is accepted for config parity (the
        remat does not depend on the mesh)."""
        if layers_fqn not in _BLOCKS_FQNS:
            raise ValueError(f"layers_fqn {layers_fqn!r}: the port checkpoints the transformer blocks only "
                             f"({', '.join(repr(n) for n in _BLOCKS_FQNS)})")
        if save_list:
            raise NotImplementedError(f"save_list {save_list!r}: save-list policies are not ported yet "
                                      "(ROADMAP.md, Queue 1 item 7)")
        return apply_activation_checkpointing(model, activation_checkpointing_variant, ac_freq=ac_freq)

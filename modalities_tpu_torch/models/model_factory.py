"""Model transform variants: the port of modalities_tpu/models/model_factory.py
for the variants the training path uses. Each records a descriptor on the
model's `TrainSpec`, applied when the train step is built (the train step
applies the tensor-parallel plan of parallel/tensor_parallel.py over the
mesh's tp axis, then shards the model over its dp dims with
parallel/fsdp.py).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional

from modalities_tpu_torch.config.config import check_bool, check_dict, check_int
from modalities_tpu_torch.models.gpt2.gpt2_model import FSDPSpec, MixedPrecisionSpec
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

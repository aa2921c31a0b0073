"""The reference's pipeline config graph: the port of
modalities_tpu/parallel/pipeline_components.py (the `pipeline.{staged,
scheduled, selector, builder}` and `stages_generator.gpt2_stages_generator`
registry nodes).

As in the JAX package, these nodes work on the model DESCRIPTOR (a `GPT2LLM`,
which holds no tensors): `pipeline.staged` validates the stage geometry and
records stage descriptors; `pipeline.scheduled` applies the schedule to the
model's spec (`ModelFactory.get_pipelined_model`: schedule, microbatches,
virtual stages); `pipeline.selector` hands out the descriptor's facets. The
split itself happens when the train step is built: each pp rank builds the
module of its own stage (parallel/pipeline.py), so the whole model is the
one "model part" a config node sees.
"""

from __future__ import annotations

import dataclasses
from enum import Enum
from typing import Any, Optional

from modalities_tpu_torch.config.config import check_int, check_str
from modalities_tpu_torch.config.yaml_interp import ConfigError
from modalities_tpu_torch.parallel.pipeline import stage_layers


class PipelineSelectionTypes(Enum):
    PP_STAGE = "PP_STAGE"
    MODEL_PART = "MODEL_PART"
    PP_SCHEDULE = "PP_SCHEDULE"


@dataclasses.dataclass(frozen=True)
class StageDescriptor:
    """One global pipeline stage: the contiguous layer block it owns (the
    layers parallel/pipeline.py gives that stage, `stage_layers`)."""

    stage_index: int
    num_stages: int
    first_layer: int
    num_layers: int

    @property
    def is_first(self) -> bool:
        return self.stage_index == 0

    @property
    def is_last(self) -> bool:
        return self.stage_index == self.num_stages - 1


class StagesGenerator:
    """Equal-depth stages: every global stage holds as many layers (the
    schedules' layout, parallel/pipeline.py)."""

    def get_num_global_stages(self, total_layers: int, num_layers_per_stage: int) -> int:
        return -(-total_layers // num_layers_per_stage)  # ceil

    def get_stage_layer_counts(self, total_layers: int, num_global_stages: int) -> list[int]:
        if num_global_stages <= 0:
            raise ConfigError(f"num_global_stages must be positive (got {num_global_stages})")
        if total_layers % num_global_stages != 0:
            raise ConfigError(
                f"n_layer ({total_layers}) must divide evenly into {num_global_stages} global stages "
                "(pp_degree x virtual stages): every stage holds as many layers. Adapt n_layer, pp degree, or "
                "num_layers_per_stage so the division is even (e.g. the reference's 6-layer pp config runs at "
                "pp=2 with num_layers_per_stage=4)."
            )
        return [total_layers // num_global_stages] * num_global_stages


class GPT2LLMStagesGenerator(StagesGenerator):
    """The reference's GPT2 stages generator: the embedding and the head
    weigh in as `input_layer_equivalence` / `output_layer_equivalence` layers
    in the stage count; `num_model_layers` is cross-checked against the
    staged model."""

    def __init__(self, num_model_layers: Optional[int] = None, input_layer_equivalence: int = 0,
                 output_layer_equivalence: int = 0):
        self.num_model_layers = num_model_layers
        self.input_layer_equivalence = input_layer_equivalence
        self.output_layer_equivalence = output_layer_equivalence

    def get_num_global_stages(self, total_layers: int, num_layers_per_stage: int) -> int:
        weighted = total_layers + self.input_layer_equivalence + self.output_layer_equivalence
        return -(-weighted // num_layers_per_stage)  # ceil

    def get_stage_layer_counts(self, total_layers: int, num_global_stages: int) -> list[int]:
        if self.num_model_layers is not None and self.num_model_layers != total_layers:
            raise ConfigError(f"stages_generator num_model_layers ({self.num_model_layers}) does not match the "
                              f"staged model's n_layer ({total_layers})")
        return super().get_stage_layer_counts(total_layers, num_global_stages)


@dataclasses.dataclass
class GPT2LLMStagesGeneratorConfig:
    """The JAX schema defaults the equivalences to 1, as the reference does."""

    num_model_layers: Optional[int] = None
    input_layer_equivalence: int = 1
    output_layer_equivalence: int = 1

    def __post_init__(self):
        check_int("num_model_layers", self.num_model_layers, ge=1, optional=True)
        check_int("input_layer_equivalence", self.input_layer_equivalence, ge=1)
        check_int("output_layer_equivalence", self.output_layer_equivalence, ge=1)


@dataclasses.dataclass
class Pipeline:
    """The reference's `Pipeline` holder over the model descriptor: one model
    part (the stage split happens when the train step is built), stage
    descriptors, and the schedule-applied model."""

    model: Any
    pp_stages: list = dataclasses.field(default_factory=list)
    pp_schedule_name: Optional[str] = None
    num_virtual: int = 1
    scheduled_model: Any = None
    schedule_applied: Optional[str] = None  # guards against two schedules through one staged descriptor

    @property
    def model_parts(self) -> list:
        return [self.model]

    @property
    def pp_schedule(self):
        return self.scheduled_model


class PipelineFactory:
    @staticmethod
    def get_staged_pipeline(whole_model, stages_generator: StagesGenerator, device_mesh, pp_schedule_name: str,
                            num_layers_per_stage: int, local_rank: int = 0) -> Pipeline:
        """Validate the stage geometry; num_virtual = global stages / pp degree.
        `local_rank` is accepted for config parity (each rank builds its own
        stage from the mesh)."""
        del local_rank
        pp_degree = device_mesh.degrees.get("pp", 1)
        total_layers = getattr(getattr(whole_model, "config_spec", None), "n_layer", None)
        if total_layers is None:
            raise ConfigError("staged pipeline requires a model exposing config_spec.n_layer")
        if num_layers_per_stage <= 0:
            raise ConfigError(f"num_layers_per_stage must be positive (got {num_layers_per_stage})")
        num_global_stages = stages_generator.get_num_global_stages(total_layers, num_layers_per_stage)
        if num_global_stages % max(pp_degree, 1) != 0:
            raise ConfigError(f"global stage count ({num_global_stages}) must be a multiple of the pp degree "
                              f"({pp_degree})")
        stages_generator.get_stage_layer_counts(total_layers, num_global_stages)  # the reference's checks
        stages = [StageDescriptor(i, num_global_stages, *stage_layers(total_layers, num_global_stages, i))
                  for i in range(num_global_stages)]
        return Pipeline(model=whole_model, pp_stages=stages, pp_schedule_name=pp_schedule_name,
                        num_virtual=num_global_stages // max(pp_degree, 1))

    @staticmethod
    def get_scheduled_pipeline(loss_fn, pp_schedule_name: str, batch_size: int, microbatch_size: int,
                               pp_degree: int, pipeline: Pipeline) -> Pipeline:
        """Apply the schedule to the descriptor's model spec. `loss_fn` is
        accepted for config parity (the train step computes the loss with
        the training components' loss)."""
        del loss_fn
        if pipeline.schedule_applied is not None:
            raise ConfigError(f"this staged pipeline already had schedule {pipeline.schedule_applied!r} applied; "
                              "build one scheduled pipeline per staged descriptor (the schedule is applied to the "
                              "shared model spec in place)")
        if pipeline.pp_stages and len(pipeline.pp_stages) % max(pp_degree, 1) != 0:
            raise ConfigError(f"pp_degree ({pp_degree}) does not divide the staged pipeline's global stage count "
                              f"({len(pipeline.pp_stages)})")
        from modalities_tpu_torch.models.model_factory import ModelFactory

        scheduled = ModelFactory.get_pipelined_model(pipeline.model, pp_schedule_name=pp_schedule_name,
                                                     batch_size=batch_size, microbatch_size=microbatch_size,
                                                     num_virtual_stages=pipeline.num_virtual)
        pipeline.schedule_applied = pp_schedule_name
        return Pipeline(model=pipeline.model, pp_stages=pipeline.pp_stages, pp_schedule_name=pp_schedule_name,
                        num_virtual=pipeline.num_virtual, scheduled_model=scheduled,
                        schedule_applied=pp_schedule_name)

    @staticmethod
    def get_pipeline(pp_stages: list, model_parts: list, pp_schedule=None) -> Pipeline:
        """The builder form: a descriptor from its parts (one model part)."""
        if len(model_parts) != 1:
            raise ConfigError(f"a pipeline config node has exactly ONE model part (got {len(model_parts)}): each "
                              "rank builds its stage from the whole model")
        return Pipeline(model=model_parts[0], pp_stages=list(pp_stages), scheduled_model=pp_schedule)


class ComponentSelectorFromPipeline:
    @staticmethod
    def select(pipeline: Pipeline, selection_type):
        if isinstance(selection_type, str):
            try:
                selection_type = PipelineSelectionTypes(selection_type)
            except ValueError:
                raise ConfigError(f"unknown selection_type {selection_type!r} (valid: "
                                  f"{[t.value for t in PipelineSelectionTypes]})") from None
        if selection_type == PipelineSelectionTypes.PP_STAGE:
            return pipeline.pp_stages
        if selection_type == PipelineSelectionTypes.MODEL_PART:
            return pipeline.model
        if pipeline.scheduled_model is None:
            raise ConfigError("PP_SCHEDULE selected from a pipeline without a schedule: wire pipeline.scheduled "
                              "(get_scheduled_pipeline) first")
        return pipeline.scheduled_model


@dataclasses.dataclass
class StagedPipelineConfig:
    whole_model: Any
    stages_generator: Any
    device_mesh: Any
    pp_schedule_name: str
    num_layers_per_stage: int
    local_rank: int = 0

    def __post_init__(self):
        check_str("pp_schedule_name", self.pp_schedule_name)
        check_int("num_layers_per_stage", self.num_layers_per_stage, ge=1)
        check_int("local_rank", self.local_rank, ge=0)


@dataclasses.dataclass
class ScheduledPipelineConfig:
    loss_fn: Any
    pp_schedule_name: str
    batch_size: int
    microbatch_size: int
    pp_degree: int
    pipeline: Any

    def __post_init__(self):
        check_str("pp_schedule_name", self.pp_schedule_name)
        for name in ("batch_size", "microbatch_size", "pp_degree"):
            check_int(name, getattr(self, name), ge=1)


@dataclasses.dataclass
class ComponentSelectorFromPipelineConfig:
    pipeline: Any
    selection_type: str

    def __post_init__(self):
        check_str("selection_type", self.selection_type)


@dataclasses.dataclass
class PipelineBuilderConfig:
    """The reference's PipelineConfig: `pp_stage` / `model_part`, the
    singular aliases, take one item and lift it to a list."""

    pp_stages: Optional[list] = None
    model_parts: Optional[list] = None
    pp_schedule: Any = None
    pp_stage: Any = None
    model_part: Any = None

    def __post_init__(self):
        for plural, singular in (("pp_stages", "pp_stage"), ("model_parts", "model_part")):
            value = getattr(self, plural) if getattr(self, plural) is not None else getattr(self, singular)
            if value is None:
                raise ValueError(f"PipelineBuilderConfig: {plural} (or {singular}) is required")
            setattr(self, plural, value if isinstance(value, list) else [value])
            setattr(self, singular, None)


def build_pipeline(pp_stages, model_parts, pp_schedule=None, pp_stage=None, model_part=None) -> Pipeline:
    """`pipeline.builder` over a validated PipelineBuilderConfig (its aliases
    already folded in)."""
    return PipelineFactory.get_pipeline(pp_stages, model_parts, pp_schedule)

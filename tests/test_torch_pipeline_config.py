"""The pipeline's config surface in the port against the JAX package's:
the `model.pipelined` variant (`ModelFactory.get_pipelined_model`: schedule
names and aliases, virtual stages, batch_size // microbatch_size; it refuses
where the JAX factory does, a virtual-stages case in the words of the JAX
schema, whose check it shares) and its schema's checks (`PipelinedModelConfig`, the messages of JAX config.py and
the cases of tests/config/test_pipelined_config_validation.py); the
reference's graph `pipeline.staged` -> `pipeline.scheduled` ->
`pipeline.selector` (and `pipeline.builder`, `stages_generator.
gpt2_stages_generator`), directly and through the port's ComponentFactory,
as tests/config/test_reference_component_surface.py drives the JAX one; and
the `scheduled_pipeline` node, which Main no longer refuses. No component
trains here."""

import pytest
from pydantic import ValidationError

from modalities_tpu.config.config import PipelinedModelConfig as JaxPipelinedModelConfig
from modalities_tpu.exceptions import ConfigError as JaxConfigError
from modalities_tpu.models.model_factory import ModelFactory as JaxModelFactory
from modalities_tpu.parallel.pipeline_components import GPT2LLMStagesGenerator as JaxStagesGenerator
from modalities_tpu_torch.config.component_factory import ComponentFactory
from modalities_tpu_torch.config.instantiation_models import UNPORTED_TRAINING_COMPONENTS
from modalities_tpu_torch.config.yaml_interp import ConfigError
from modalities_tpu_torch.models.gpt2.gpt2_model import GPT2LLM
from modalities_tpu_torch.models.model_factory import ModelFactory, PipelinedModelConfig
from modalities_tpu_torch.parallel.pipeline_components import (
    ComponentSelectorFromPipeline,
    GPT2LLMStagesGenerator,
    PipelineFactory,
)
from modalities_tpu_torch.registry.components import TRAINING_COMPONENTS
from modalities_tpu_torch.registry.registry import Registry
from modalities_tpu_torch.running_env.device_mesh import DeviceMesh
from tests.models.test_gpt2_model import tiny_gpt2
from tests.test_torch_gpt2 import port_config


def _model(n_layer=4):
    return GPT2LLM(**port_config(n_layer=n_layer))


def _jax_error(fn):
    try:
        fn()
    except (ValidationError, ValueError, NotImplementedError, JaxConfigError) as e:
        return str(e)
    return None


SCHEMA_CASES = [(name, nv) for name in ("zbv", "dualpipev", "ZBVZeroBubble", "dual_pipe_v", "interleaved_1f1b",
                                         "gpipe", "1f1b", "some_future_schedule") for nv in (None, 1, 2, 4)]


@pytest.mark.parametrize("name,virtual", SCHEMA_CASES, ids=lambda v: str(v))
def test_the_schema_accepts_and_refuses_as_the_jax_one(name, virtual):
    want = _jax_error(lambda: JaxPipelinedModelConfig(model=tiny_gpt2("manual"), pp_schedule_name=name,
                                                      num_virtual_stages=virtual))
    try:
        PipelinedModelConfig(model=_model(), pp_schedule_name=name, num_virtual_stages=virtual)
    except ValueError as e:
        assert want is not None and str(e) in want, (str(e), want)
    else:
        assert want is None, want


FACTORY_CASES = [
    dict(pp_schedule_name="1f1b", batch_size=16, microbatch_size=4),
    dict(pp_schedule_name="ZBVZeroBubble"), dict(pp_schedule_name="dual_pipe_v", num_virtual_stages=1),
    dict(pp_schedule_name="interleaved_1f1b"), dict(pp_schedule_name="interleaved_1f1b", num_virtual_stages=4),
    dict(pp_schedule_name="gpipe", num_microbatches=8), dict(pp_schedule_name="looped_bfs"),
    dict(pp_schedule_name="1f1b", num_virtual_stages=2), dict(pp_schedule_name="interleaved_1f1b",
                                                              num_virtual_stages=1),
    dict(pp_schedule_name="zbv", num_virtual_stages=3), dict(pp_schedule_name="1f1b", batch_size=16),
    dict(pp_schedule_name="1f1b", batch_size=10, microbatch_size=4),
]


@pytest.mark.parametrize("kwargs", FACTORY_CASES, ids=lambda k: "-".join(f"{a}{b}" for a, b in k.items()))
def test_the_pipelined_variant_sets_the_jax_spec_fields(kwargs):
    jax_model = tiny_gpt2("manual")
    want = _jax_error(lambda: JaxModelFactory.get_pipelined_model(jax_model, **kwargs))
    model = _model()
    try:
        out = ModelFactory.get_pipelined_model(model, **kwargs)
    except (ValueError, NotImplementedError) as e:
        # the port checks virtual stages with one validator for the schema and the factory: the JAX schema's words
        schema = _jax_error(lambda: JaxPipelinedModelConfig(model=tiny_gpt2("manual"),
                                                            pp_schedule_name=kwargs["pp_schedule_name"],
                                                            num_virtual_stages=kwargs.get("num_virtual_stages")))
        assert want is not None and (str(e) == want or (schema is not None and str(e) in schema)), (str(e), want)
        return
    assert want is None and out is model
    for field in ("pp_schedule", "pp_num_microbatches", "pp_num_virtual"):
        assert getattr(model.config_spec, field) == getattr(jax_model.config_spec, field), field


def test_the_reference_graph_applies_the_schedule():
    mesh = DeviceMesh(world_size=8, data_parallel_shard_degree=4, pipeline_parallel_degree=2)
    model = _model()
    staged = PipelineFactory.get_staged_pipeline(whole_model=model, stages_generator=GPT2LLMStagesGenerator(),
                                                 device_mesh=mesh, pp_schedule_name="1f1b", num_layers_per_stage=2)
    assert [s.num_layers for s in staged.pp_stages] == [2, 2] and staged.num_virtual == 1
    assert staged.pp_stages[0].is_first and staged.pp_stages[-1].is_last and staged.model_parts == [model]
    scheduled = PipelineFactory.get_scheduled_pipeline(loss_fn=None, pp_schedule_name="1f1b", batch_size=8,
                                                       microbatch_size=2, pp_degree=2, pipeline=staged)
    assert ComponentSelectorFromPipeline.select(scheduled, "PP_SCHEDULE") is model
    assert ComponentSelectorFromPipeline.select(scheduled, "MODEL_PART") is model
    assert ComponentSelectorFromPipeline.select(scheduled, "PP_STAGE") == staged.pp_stages
    assert (model.config_spec.pp_schedule, model.config_spec.pp_num_microbatches) == ("1f1b", 4)
    with pytest.raises(ConfigError, match="already had schedule"):
        PipelineFactory.get_scheduled_pipeline(None, "1f1b", 8, 2, 2, staged)
    with pytest.raises(ConfigError, match="unknown selection_type"):
        ComponentSelectorFromPipeline.select(scheduled, "STAGE")
    # 1 layer a stage over pp 2: 4 global stages, 2 virtual chunks a device
    staged = PipelineFactory.get_staged_pipeline(_model(), GPT2LLMStagesGenerator(), mesh, "interleaved_1f1b", 1)
    assert staged.num_virtual == 2
    PipelineFactory.get_scheduled_pipeline(None, "interleaved_1f1b", 8, 2, 2, staged)
    assert staged.model.config_spec.pp_num_virtual == 2


def test_the_stages_generators_errors_are_the_jax_ones():
    for port, jax in ((GPT2LLMStagesGenerator(), JaxStagesGenerator()),
                      (GPT2LLMStagesGenerator(num_model_layers=6), JaxStagesGenerator(num_model_layers=6))):
        with pytest.raises(JaxConfigError) as want:
            jax.get_stage_layer_counts(10, 4)
        with pytest.raises(ConfigError) as got:
            port.get_stage_layer_counts(10, 4)
        assert ("num_model_layers" in str(got.value)) == ("num_model_layers" in str(want.value))
        assert str(got.value).split(" virtual stages)")[0] == str(want.value).split(" virtual stages)")[0]
    assert GPT2LLMStagesGenerator(input_layer_equivalence=1, output_layer_equivalence=1).get_num_global_stages(4, 3) \
        == JaxStagesGenerator(input_layer_equivalence=1, output_layer_equivalence=1).get_num_global_stages(4, 3) == 2


def test_the_graph_builds_through_the_component_factory():
    import dataclasses

    @dataclasses.dataclass
    class Holder:
        scheduled_pipeline: object
        selected_model: object
        built_pipeline: object

    model = _model()
    config = {
        "device_mesh": {"component_key": "device_mesh", "variant_key": "default",
                        "config": {"data_parallel_shard_degree": 4, "pipeline_parallel_degree": 2, "world_size": 8}},
        "staged_pipeline": {"component_key": "pipeline", "variant_key": "staged", "config": {
            "whole_model": model,
            "stages_generator": {"component_key": "stages_generator", "variant_key": "gpt2_stages_generator",
                                 "config": {}},
            "device_mesh": {"instance_key": "device_mesh", "pass_type": "BY_REFERENCE"},
            "pp_schedule_name": "1f1b", "num_layers_per_stage": 3}},  # (4 + 1 + 1) / 3 = 2 stages
        "scheduled_pipeline": {"component_key": "pipeline", "variant_key": "scheduled", "config": {
            "loss_fn": {"component_key": "loss", "variant_key": "clm_cross_entropy_loss",
                        "config": {"target_key": "target_ids", "prediction_key": "logits"}},
            "pp_schedule_name": "1f1b", "batch_size": 8, "microbatch_size": 2, "pp_degree": 2,
            "pipeline": {"instance_key": "staged_pipeline", "pass_type": "BY_REFERENCE"}}},
        "selected_model": {"component_key": "pipeline", "variant_key": "selector", "config": {
            "pipeline": {"instance_key": "scheduled_pipeline", "pass_type": "BY_REFERENCE"},
            "selection_type": "PP_SCHEDULE"}},
        "built_pipeline": {"component_key": "pipeline", "variant_key": "builder", "config": {
            "pp_stage": {"instance_key": "staged_pipeline", "pass_type": "BY_REFERENCE"},
            "model_part": model}},
    }
    built = ComponentFactory(Registry(TRAINING_COMPONENTS)).build_components(config, Holder)
    assert built.selected_model is model and model.config_spec.pp_schedule == "1f1b"
    assert built.built_pipeline.model_parts == [model]
    assert "scheduled_pipeline" not in UNPORTED_TRAINING_COMPONENTS

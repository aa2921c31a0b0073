"""The port's component catalog (the JAX catalog is
modalities_tpu/registry/components.py): `COMPONENTS` for serving
(`inference_component.serve` is added by serving/serve.py, as the JAX package
does) and `TRAINING_COMPONENTS` for `run`, the component and variant keys of
the JAX training configs. Together they hold every (component_key,
variant_key) pair of the JAX catalog: the ones the port lacks are `Unported`
entities (`UNPORTED`), whose lookup raises NotImplementedError naming their
ROADMAP.md Queue 1 item."""

from modalities_tpu_torch.config.config import PreTrainedHFTokenizerConfig
from modalities_tpu_torch.models.coca.coca_model import CoCa, CoCaConfig
from modalities_tpu_torch.models.gpt2.gpt2_model import GPT2LLM, GPT2LLMConfig
from modalities_tpu_torch.models.vision_transformer.vision_transformer_model import (
    VisionTransformer,
    VisionTransformerConfig,
)
from modalities_tpu_torch.registry.registry import ComponentEntity, Unported
from modalities_tpu_torch.tokenization.tokenizer_wrapper import PreTrainedHFTokenizer

_MODELS = "the other models and their data"
_FSDP1 = "the FSDP1 names, to be mapped onto FSDP2"
_DATA = "the other data variants"
_DEBUGGING = "the debugging transforms"
# the JAX catalog's pairs the port does not have yet: (component_key, variant_key) -> (Queue 1 item, what)
UNPORTED = {
    **{pair: (6, _MODELS) for pair in (("model", "huggingface_pretrained_model"),
                                       ("tokenizer", "pretrained_sp_tokenizer"))},
    **{pair: (7, _FSDP1) for pair in (
        ("model", "fsdp1_wrapped"), ("model", "fsdp1_checkpointed"), ("model", "activation_checkpointed_fsdp1"),
        ("optimizer", "fsdp1_checkpointed"), ("gradient_clipper", "fsdp1"),
        ("gradient_clipper", "fsdp1_logging_only"))},
    **{pair: (7, _DATA) for pair in (
        ("collate_fn", "mask_loss_collator_wrapper"), ("data_loader", "repeating_data_loader"), ("dataset", "combined"),
        ("dataset", "mem_map_dataset"), ("dataset", "packed_mem_map_dataset_megatron"),
        ("sampler", "distributed_sampler"), ("sampler", "random_sampler"), ("sampler", "resumable_distributed_sampler"),
        ("sampler", "sequential_sampler"))},
    **{pair: (7, _DEBUGGING) for pair in (
        ("model", "compiled"), ("model", "debugging_enriched"), ("model_debugging_hook", "nan_hook"),
        ("model_debugging_hook", "print_forward_hook"), ("debugging", "settings"))},
    **{("layer_norm", v): (7, "the layer_norm components") for v in ("layer_norm", "pytorch_rms_norm", "rms_norm")},
    ("device_feeder", "default"): (7, "the device feeder"),
}

COMPONENTS = [
    ComponentEntity("model", "gpt2", GPT2LLM, GPT2LLMConfig),
    ComponentEntity("model", "coca", CoCa, CoCaConfig),
    ComponentEntity("model", "vision_transformer", VisionTransformer, VisionTransformerConfig),
    ComponentEntity("tokenizer", "pretrained_hf_tokenizer", PreTrainedHFTokenizer, PreTrainedHFTokenizerConfig),
    *[ComponentEntity(key, variant, Unported(item, what)) for (key, variant), (item, what) in UNPORTED.items()],
]


def _training_components() -> list[ComponentEntity]:
    from modalities_tpu_torch.checkpointing.checkpoint_saving import CheckpointSaving
    from modalities_tpu_torch.checkpointing.checkpoint_saving_strategies import (
        SaveEveryKStepsCheckpointingStrategy,
        SaveKMostRecentCheckpointsStrategy,
    )
    from modalities_tpu_torch.checkpointing.dcp.dcp_checkpoint_loading import (
        DCPCheckpointLoading,
        FSDP1AliasCheckpointLoadingConfig,
        TorchAliasCheckpointLoadingConfig,
        alias_checkpoint_loading,
    )
    from modalities_tpu_torch.checkpointing.dcp.dcp_checkpoint_saving import (
        DCPCheckpointSaving,
        DCPCheckpointSavingConfig,
    )
    from modalities_tpu_torch.checkpointing.stateful.app_state_factory import (
        AppStateFactory,
        DCPAppStateConfig,
        RawAppStateConfig,
    )
    from modalities_tpu_torch.dataloader import samplers
    from modalities_tpu_torch.dataloader.dataloader import GPT2LLMCollateFn, LLMDataLoader
    from modalities_tpu_torch.dataloader.dataset import (
        DummyDatasetConfig,
        PackedMemMapDatasetContinuousConfig,
        get_dummy_dataset,
        get_packed_mem_map_dataset_continuous,
    )
    from modalities_tpu_torch.logging_broker.subscribers import (
        DummySubscriber,
        EvaluationResultToDiscSubscriber,
        PrintProgressSubscriber,
        RichResultSubscriber,
        WandBEvaluationResultSubscriberConfig,
        get_wandb_result_subscriber,
    )
    from modalities_tpu_torch.loss_functions import CLMCrossEntropyLoss, NCELoss
    from modalities_tpu_torch.models.coca.coca_model import CoCaCollateFn, CoCaCollatorConfig
    from modalities_tpu_torch.models.model_factory import (
        ActivationCheckpointedModelConfig,
        FSDP2WrappedModelConfig,
        GPT2TPModelConfig,
        ModelFactory,
        PipelinedModelConfig,
        WeightInitializedModelConfig,
    )
    from modalities_tpu_torch.parallel import pipeline_components as pl
    from modalities_tpu_torch.resilience import Resilience, ResilienceConfig
    from modalities_tpu_torch.nn.llama3_initialization import Llama3Initializer
    from modalities_tpu_torch.nn.model_initialization import ComposedModelInitialization
    from modalities_tpu_torch.optimizers.optimizer_factory import AdamOptimizerConfig, OptimizerFactory
    from modalities_tpu_torch.optimizers.scheduler_factory import SCHEDULERS
    from modalities_tpu_torch.running_env.device_mesh import DeviceMesh
    from modalities_tpu_torch.running_env.xla_flags import XlaPerformanceFlags
    from modalities_tpu_torch.telemetry import TelemetryConfig, build_telemetry
    from modalities_tpu_torch.training.gradient_clipping import (
        DummyGradientClipper,
        GradientClipper,
        LoggingOnlyGradientClipper,
    )
    from modalities_tpu_torch.utils.mfu import GPT2MFUCalculator, GPT2MFUCalculatorConfig
    from modalities_tpu_torch.utils.number_conversion import NUMBER_CONVERSIONS
    from modalities_tpu_torch.utils.profilers import profilers as prof
    from modalities_tpu_torch.utils.profilers import steppable_components as steppable

    def E(key, variant, component, config=None, own_config=True):  # noqa: N802
        """A dataclass component is its own config unless another is given."""
        return ComponentEntity(key, variant, component, config or (component if own_config else None))

    return [
        E("performance", "xla_flags", XlaPerformanceFlags),
        E("device_mesh", "default", DeviceMesh),
        E("model", "gpt2_tp", ModelFactory.get_gpt2_tp_model, GPT2TPModelConfig),
        E("model", "fsdp2_wrapped", ModelFactory.get_fsdp2_wrapped_model, FSDP2WrappedModelConfig),
        E("model", "model_initialized", ModelFactory.get_weight_initialized_model, WeightInitializedModelConfig),
        E("model", "activation_checkpointed", ModelFactory.get_activation_checkpointed_model,
          ActivationCheckpointedModelConfig),
        E("model", "pipelined", ModelFactory.get_pipelined_model, PipelinedModelConfig),
        E("pipeline", "staged", pl.PipelineFactory.get_staged_pipeline, pl.StagedPipelineConfig),
        E("pipeline", "scheduled", pl.PipelineFactory.get_scheduled_pipeline, pl.ScheduledPipelineConfig),
        E("pipeline", "selector", pl.ComponentSelectorFromPipeline.select, pl.ComponentSelectorFromPipelineConfig),
        E("pipeline", "builder", pl.build_pipeline, pl.PipelineBuilderConfig),
        E("stages_generator", "gpt2_stages_generator", pl.GPT2LLMStagesGenerator, pl.GPT2LLMStagesGeneratorConfig),
        E("model_initialization", "composed", ComposedModelInitialization),
        E("model_initialization", "gpt2_llama3_like", Llama3Initializer),
        E("loss", "clm_cross_entropy_loss", CLMCrossEntropyLoss),
        E("loss", "nce_loss", NCELoss),
        E("optimizer", "adam", OptimizerFactory.get_adam, AdamOptimizerConfig),
        E("optimizer", "adam_w", OptimizerFactory.get_adam_w, AdamOptimizerConfig),
        *[E("scheduler", name, cls) for name, cls in SCHEDULERS.items()],
        E("app_state", "raw", AppStateFactory.get_raw_app_state, RawAppStateConfig),
        E("app_state", "dcp", AppStateFactory.get_dcp_checkpointed_app_state_, DCPAppStateConfig),
        E("dataset", "packed_mem_map_dataset_continuous", get_packed_mem_map_dataset_continuous,
          PackedMemMapDatasetContinuousConfig),
        E("dataset", "dummy_dataset", get_dummy_dataset, DummyDatasetConfig),
        E("sampler", "resumable_distributed_multi_dim_sampler",
          samplers.create_resumable_distributed_multi_dim_sampler, samplers.ResumableDistributedMultiDimSamplerConfig),
        E("batch_sampler", "default", samplers.create_batch_sampler, samplers.BatchSamplerConfig),
        E("collate_fn", "gpt_2_llm_collator", GPT2LLMCollateFn),
        E("collate_fn", "coca_collator", CoCaCollateFn, CoCaCollatorConfig),
        E("data_loader", "default", LLMDataLoader),
        E("checkpoint_saving", "default", CheckpointSaving),
        E("checkpoint_saving_strategy", "save_k_most_recent_checkpoints_strategy", SaveKMostRecentCheckpointsStrategy),
        E("checkpoint_saving_strategy", "save_every_k_steps_checkpointing_strategy",
          SaveEveryKStepsCheckpointingStrategy),
        # the JAX variant keys of the one checkpoint format here, DCP (the JAX package's is Orbax whatever the name)
        *[E("checkpoint_saving_execution", name, DCPCheckpointSaving, DCPCheckpointSavingConfig)
          for name in ("orbax", "dcp", "fsdp1")],
        *[E("checkpoint_loading", name, DCPCheckpointLoading) for name in ("orbax", "dcp")],
        E("checkpoint_loading", "fsdp1", alias_checkpoint_loading, FSDP1AliasCheckpointLoadingConfig),
        E("checkpoint_loading", "torch", alias_checkpoint_loading, TorchAliasCheckpointLoadingConfig),
        E("gradient_clipper", "fsdp2", GradientClipper),
        E("gradient_clipper", "fsdp2_logging_only", LoggingOnlyGradientClipper),
        E("gradient_clipper", "dummy", DummyGradientClipper, own_config=False),
        E("progress_subscriber", "rich", PrintProgressSubscriber),
        E("progress_subscriber", "dummy", DummySubscriber, own_config=False),
        # the JAX package registers one class under both names
        *[E("results_subscriber", name, EvaluationResultToDiscSubscriber) for name in ("save_to_disc", "to_disc")],
        E("results_subscriber", "rich", RichResultSubscriber),
        E("results_subscriber", "wandb", get_wandb_result_subscriber, WandBEvaluationResultSubscriberConfig),
        E("results_subscriber", "dummy", DummySubscriber, own_config=False),
        E("mfu_calculator", "gpt2", GPT2MFUCalculator, GPT2MFUCalculatorConfig),
        E("resilience", "default", Resilience, ResilienceConfig),
        E("telemetry", "default", build_telemetry, TelemetryConfig),
        *[E("number_conversion", name, fn, config) for name, fn, config in NUMBER_CONVERSIONS],
        # the profiler harness (`profile distributed`) and the trainer's `profiler` node, under JAX's names
        # and the reference's
        *[E(key, "random_dataset_batch_generator" if key == "batch_generator" else "random",
            steppable.RandomDatasetBatchGenerator, steppable.RandomDatasetBatchGeneratorConfig)
          for key in ("batch_generator", "dataset_batch_generator")],
        E("steppable_component", "forward_pass", steppable.steppable_forward_pass,
          steppable.SteppableForwardPassConfig),
        *[E(key, variant, component, config, own_config=False) for key, names in (
            ("profiler", ("no_profiler", "kernel_profiler", "memory_profiler", "combined_profiler")),
            ("steppable_profiler", ("no_profiler", "kernel_tracing", "memory_tracing", "combined")))
          for variant, (component, config) in zip(names, (
              (prof.SteppableNoProfiler, None),
              (prof.steppable_kernel_profiler, prof.SteppableKernelProfilerConfig),
              (prof.SteppableMemoryProfiler, prof.SteppableMemoryProfilerConfig),
              (prof.SteppableCombinedProfiler, prof.SteppableCombinedProfilerConfig)))],
    ]


TRAINING_COMPONENTS = COMPONENTS + _training_components()

"""The port's component catalog against the JAX package's: every
(component_key, variant_key) pair the JAX catalog registers
(modalities_tpu/registry/components.py, and the `inference_component`
variants its serve() adds) is registered in the port, and every pair a
shipped configs/*.yaml names is either built by the port or refused with
NotImplementedError naming its ROADMAP.md Queue 1 item, never "Unknown
variant_key". The serving variants are all ported: configs/config_serve.yaml,
config_fleet.yaml and config_disagg.yaml build with their `slo` blocks as
shipped (their tokenizer stubbed). No data file is needed."""

import json
import re
from pathlib import Path

import pytest
import yaml

from modalities_tpu.registry.components import COMPONENTS as JAX_COMPONENTS
from modalities_tpu_torch.registry.components import TRAINING_COMPONENTS, UNPORTED
from modalities_tpu_torch.registry.registry import Registry, Unported
from modalities_tpu_torch.serving.serve import serving_entities

ROOT = Path(__file__).resolve().parents[1]
PORT = Registry(TRAINING_COMPONENTS + serving_entities())


def _pairs(node, out: set) -> set:
    if isinstance(node, dict):
        if "component_key" in node and "variant_key" in node:
            out.add((node["component_key"], node["variant_key"]))
        for value in node.values():
            _pairs(value, out)
    elif isinstance(node, list):
        for value in node:
            _pairs(value, out)
    return out


def test_the_port_registers_exactly_the_jax_catalogs_pairs():
    jax_keys = {(e.component_key, e.variant_key) for e in JAX_COMPONENTS}
    serve_source = (ROOT / "modalities_tpu" / "serving" / "serve.py").read_text()
    jax_keys |= {("inference_component", v) for v in re.findall(r'ComponentEntity\(\s*"inference_component", "(\w+)"',
                                                                serve_source)}
    assert {("inference_component", v) for v in ("serve", "fleet", "disagg")} <= jax_keys
    assert PORT.keys() == jax_keys


def test_each_unported_pair_names_a_queue_1_item():
    assert len(UNPORTED) == 26
    assert sorted(item for item, _ in UNPORTED.values()) == [6] * 2 + [7] * 24
    for (key, variant), (item, _) in UNPORTED.items():
        assert item in (5, 6, 7)
        with pytest.raises(NotImplementedError, match=rf"{key}\.{variant} .* Queue 1 item {item}\)"):
            PORT.get_component(key, variant)


@pytest.mark.parametrize("config", sorted((ROOT / "configs").glob("*.yaml")), ids=lambda p: p.name)
def test_each_pair_a_shipped_config_names_is_built_or_names_its_item(config):
    pairs = _pairs(yaml.safe_load(config.read_text()), set())
    assert pairs
    for key, variant in sorted(pairs):
        try:
            component = PORT.get_component(key, variant)
        except NotImplementedError as e:
            assert re.search(r"ROADMAP\.md, Queue 1 item \d+", str(e)), (key, variant, str(e))
        else:
            assert not isinstance(component, Unported) and callable(component), (key, variant)


MULTIMODAL_PAIRS = {("model", "coca"), ("model", "vision_transformer"), ("loss", "nce_loss"),
                    ("dataset", "dummy_dataset"), ("collate_fn", "coca_collator")}


def _resolved(node, root: dict):
    """`node` with its `${settings...}` references (no resolver) read from `root`."""
    if isinstance(node, dict):
        return {k: _resolved(v, root) for k, v in node.items()}
    if isinstance(node, list):
        return [_resolved(v, root) for v in node]
    if isinstance(node, str) and node.startswith("${") and ":" not in node:
        value = root
        for key in node[2:-1].split("."):
            value = value[key]
        return _resolved(value, root)
    return node


def test_the_multimodal_pairs_are_built_from_the_coca_configs_nodes():
    """config_example_coca_tpu.yaml names no refused pair; its model, dataset
    and collator nodes build the port's components, and the ViT and NCE loss
    build from nodes of the same shape; the HF model and the sp tokenizer
    still name item 6."""
    from modalities_tpu_torch.config.component_factory import ComponentFactory
    from modalities_tpu_torch.dataloader.dataset import DummyDataset
    from modalities_tpu_torch.loss_functions import NCELoss
    from modalities_tpu_torch.models.coca.coca_model import CoCa, CoCaCollateFn
    from modalities_tpu_torch.models.vision_transformer.vision_transformer_model import VisionTransformer

    assert not MULTIMODAL_PAIRS & set(UNPORTED)
    assert set(UNPORTED) & {("model", "huggingface_pretrained_model"), ("tokenizer", "pretrained_sp_tokenizer")}
    cfg = yaml.safe_load((ROOT / "configs" / "config_example_coca_tpu.yaml").read_text())
    pairs = _pairs(cfg, set())
    assert MULTIMODAL_PAIRS - {("model", "vision_transformer"), ("loss", "nce_loss")} <= pairs
    assert not pairs & set(UNPORTED)
    factory = ComponentFactory(PORT)
    nodes = {key: _resolved(cfg[key]["config"], cfg) for key in ("model_raw", "train_dataset", "collate_fn")}
    coca = factory._instantiate("model", "coca", nodes["model_raw"])
    assert isinstance(coca, CoCa) and coca.vision_spec["block_size"] == 16 and coca.num_parameters() > 0
    dataset = factory._instantiate("dataset", "dummy_dataset", nodes["train_dataset"])
    assert isinstance(dataset, DummyDataset) and len(dataset) == 384
    assert dataset[0]["images"].shape == (32, 32, 3) and dataset[0]["input_ids"].shape == (17,)
    collator = factory._instantiate("collate_fn", "coca_collator", nodes["collate_fn"])
    assert isinstance(collator, CoCaCollateFn) and collator.text_target_key == "target_ids"
    vit = factory._instantiate("model", "vision_transformer",
                               dict(nodes["model_raw"]["vision_encoder_config"], n_classes=10))
    assert isinstance(vit, VisionTransformer) and vit.spec["n_classes"] == 10
    loss = factory._instantiate("loss", "nce_loss", {"prediction_key1": "vision_cls", "prediction_key2": "text_cls"})
    assert isinstance(loss, NCELoss) and loss.is_asymmetric and loss.temperature == 1.0


def test_the_7b_tp_configs_variants_are_ported():
    pairs = _pairs(yaml.safe_load((ROOT / "configs" / "config_7b_tp_fsdp.yaml").read_text()), set())
    for key, variant in pairs:
        PORT.get_component(key, variant)
    assert {("model", "gpt2_tp"), ("model_initialization", "gpt2_llama3_like")} <= pairs


PIPELINE_PAIRS = {("model", "pipelined"), ("pipeline", "staged"), ("pipeline", "scheduled"), ("pipeline", "selector"),
                  ("pipeline", "builder"), ("stages_generator", "gpt2_stages_generator")}


def test_the_pipeline_pairs_are_built():
    """The six pipeline pairs of the pp config graph are ported, and the two
    shipped configs that name them build them (pp_tp: `model.pipelined`)."""
    assert not PIPELINE_PAIRS & set(UNPORTED)
    for key, variant in PIPELINE_PAIRS:
        component = PORT.get_component(key, variant)
        assert not isinstance(component, Unported) and callable(component), (key, variant)
    pairs = _pairs(yaml.safe_load((ROOT / "configs" / "config_lorem_ipsum_tpu_pp_tp.yaml").read_text()), set())
    assert ("model", "pipelined") in pairs


def test_no_serving_variant_is_unported():
    assert all(not isinstance(e.component_type, Unported) for e in serving_entities())


@pytest.mark.parametrize("name,variant", [("config_serve", "serve"), ("config_fleet", "fleet"),
                                          ("config_disagg", "disagg")])
def test_the_serving_configs_build_with_their_slo_blocks(name, variant):
    """Each shipped serving config builds as it stands, its `slo` block kept
    for serve() (or the fleet) to arm."""
    from modalities_tpu_torch.config.component_factory import ComponentFactory
    from modalities_tpu_torch.config.instantiation_models import ServeInstantiationModel
    from modalities_tpu_torch.config.yaml_interp import load_app_config_dict
    from modalities_tpu_torch.registry.components import COMPONENTS
    from modalities_tpu_torch.registry.registry import ComponentEntity

    class _Tokenizer:  # the file's tokenizer folder is not shipped
        def get_token_id(self, token):
            return 0

    factory = ComponentFactory(Registry(COMPONENTS + serving_entities()
                                        + [ComponentEntity("tokenizer", "stub", _Tokenizer, None)]))
    config = load_app_config_dict(ROOT / "configs" / f"{name}.yaml")
    node = config["serving_component"]["config"]
    node["tokenizer"] = {"component_key": "tokenizer", "variant_key": "stub", "config": {}}
    shipped = yaml.safe_load((ROOT / "configs" / f"{name}.yaml").read_text())["serving_component"]["config"]["slo"]
    component = factory.build_components(config, ServeInstantiationModel).serving_component
    assert type(component).__name__ == {"serve": "ServingComponent", "fleet": "FleetServingComponent",
                                        "disagg": "DisaggServingComponent"}[variant]
    assert component.slo == shipped and {"ttft_p99", "error_rate"} <= {o["name"] for o in shipped["objectives"]}
    assert component.slo_engine is None  # armed by serve() (or per worker by the fleet), not at the build
    if variant == "fleet":
        assert (component.num_workers, component.probation_s, component.health_interval_s) == (2, None, 0.5)
    elif variant == "disagg":
        assert (component.prefill_workers, component.decode_workers) == (1, 1)


def test_the_resilience_component_is_built_with_the_jax_schema():
    """("resilience", "default") builds the port's `Resilience` from the
    JAX `ResilienceConfig`'s fields and defaults; the getting-started
    config's block (configs/config_lorem_ipsum_tpu.yaml) builds as shipped;
    the cluster knobs raise naming ROADMAP.md Queue 1 item 7."""
    import dataclasses

    from modalities_tpu.config.config import ResilienceConfig as JaxResilienceConfig
    from modalities_tpu_torch.config.component_factory import ComponentFactory
    from modalities_tpu_torch.resilience import Resilience, ResilienceConfig

    assert ("resilience", "default") not in UNPORTED
    ours = {f.name: f.default for f in dataclasses.fields(ResilienceConfig)}
    assert ours == {name: field.default for name, field in JaxResilienceConfig.model_fields.items()}
    factory = ComponentFactory(PORT)
    shipped = yaml.safe_load((ROOT / "configs" / "config_lorem_ipsum_tpu.yaml").read_text())["resilience"]
    built = factory._instantiate("resilience", "default", shipped["config"])
    assert isinstance(built, Resilience) and built.anomaly_policy == "raise" and built.preemption is not None
    assert not built.consensus_enabled() and built.build_heartbeat() is None  # one process: both off
    for knob, value in (("min_hosts", 2), ("resume_quorum", 2), ("resume_vote_deadline_s", 5.0)):
        with pytest.raises(NotImplementedError, match=r"cluster resilience \(ROADMAP\.md, Queue 1 item 7\)"):
            factory._instantiate("resilience", "default", {knob: value})
    with pytest.raises(ValueError, match="anomaly_policy"):
        factory._instantiate("resilience", "default", {"anomaly_policy": "ignore"})


def test_the_telemetry_component_and_the_results_subscribers_are_built_with_the_jax_schemas(tmp_path):
    """("telemetry", "default") builds the port's `Telemetry` from the JAX
    `TelemetryConfig`'s fields and defaults (`use_jax_annotations` sets the
    port's `profiler_annotations`); the results subscribers `to_disc`,
    `rich` and `wandb` are registered; `to_disc` writes JAX's JSONL keys,
    `wandb` raises naming its package where it is missing, and DISABLED gives
    the no-op subscriber, as in JAX."""
    import dataclasses
    import importlib.util
    import json

    from modalities_tpu.config.config import TelemetryConfig as JaxTelemetryConfig
    from modalities_tpu.config.config import WandBEvaluationResultSubscriberConfig as JaxWandBConfig
    from modalities_tpu_torch.config.component_factory import ComponentFactory
    from modalities_tpu_torch.logging_broker.subscribers import (
        DummySubscriber,
        EvaluationResultToDiscSubscriber,
        RichResultSubscriber,
        WandBEvaluationResultSubscriberConfig,
    )
    from modalities_tpu_torch.telemetry import Telemetry, TelemetryConfig

    pairs = {("telemetry", "default"), ("results_subscriber", "rich"), ("results_subscriber", "to_disc"),
             ("results_subscriber", "wandb")}
    assert not pairs & set(UNPORTED)
    ours = {f.name: f.default for f in dataclasses.fields(TelemetryConfig)}
    assert ours == {name: field.default for name, field in JaxTelemetryConfig.model_fields.items()}
    assert {f.name for f in dataclasses.fields(WandBEvaluationResultSubscriberConfig)} == set(JaxWandBConfig.model_fields)
    factory = ComponentFactory(PORT)
    node = {"component_key": "telemetry", "variant_key": "default",
            "config": {"use_jax_annotations": False, "watchdog_deadline_s": 0, "anomaly_window": 8,
                       "slo": {"objectives": [{"name": "g", "expr": "training_goodput_ratio > 0.5"}]}}}
    telemetry = factory._instantiate("telemetry", "default", node["config"])
    assert isinstance(telemetry, Telemetry) and telemetry.enabled and telemetry.anomaly_window == 8
    assert telemetry._recorder._profiler_annotations is False and telemetry.slo_engine is not None
    for bad in ({"anomaly_window": 1}, {"watchdog_first_step_factor": 0.5}, {"anomaly_zscore": 0}):
        with pytest.raises(ValueError):
            factory._instantiate("telemetry", "default", bad)
    assert factory._instantiate("results_subscriber", "rich", {}).__class__ is RichResultSubscriber
    disc = factory._instantiate("results_subscriber", "to_disc", {"output_folder_path": str(tmp_path)})
    assert isinstance(disc, EvaluationResultToDiscSubscriber)
    disc.consume({"dataloader_tag": "train", "num_train_steps_done": 1, "losses": {"train loss avg": 1.0},
                  "metrics": {}, "throughput_metrics": {"tokens/s (device)": 2.0}})
    row = json.loads((tmp_path / "evaluation_results.jsonl").read_text())
    assert {"dataloader_tag", "num_train_steps_done", "losses", "metrics", "throughput_metrics"} <= set(row)
    wandb = {"project": "p", "experiment_id": "e"}
    assert isinstance(factory._instantiate("results_subscriber", "wandb", {**wandb, "mode": "DISABLED"}),
                      DummySubscriber)
    assert isinstance(factory._instantiate("results_subscriber", "wandb", {**wandb, "global_rank": 1}),
                      DummySubscriber)
    with pytest.raises(ValueError, match="unknown wandb mode"):
        factory._instantiate("results_subscriber", "wandb", {**wandb, "mode": "sometimes"})
    if importlib.util.find_spec("wandb") is None:
        with pytest.raises(ImportError, match="results_subscriber.wandb needs the `wandb` package"):
            factory._instantiate("results_subscriber", "wandb", wandb)


PROFILING_PAIRS = {
    *[("profiler", v) for v in ("no_profiler", "kernel_profiler", "memory_profiler", "combined_profiler")],
    *[("steppable_profiler", v) for v in ("no_profiler", "kernel_tracing", "memory_tracing", "combined")],
    ("steppable_component", "forward_pass"), ("batch_generator", "random_dataset_batch_generator"),
    ("dataset_batch_generator", "random")}


def test_the_profiling_pairs_are_built_under_jaxs_names_and_the_references(tmp_path):
    """The 11 pairs of the profiler harness (utils/profilers/), JAX's field
    names and the reference names they accept (num_*_steps, with_stack,
    dataset_batch_generator, the dims-style generator); the torch.profiler
    knobs are applied, not dropped."""
    from modalities_tpu_torch.config.component_factory import ComponentFactory
    from modalities_tpu_torch.utils.profilers.modalities_profiler import ProfilerInstantiationModel, _registry_with
    from modalities_tpu_torch.utils.profilers.profilers import SteppableCombinedProfiler, SteppableNoProfiler

    assert len(PROFILING_PAIRS) == 11 and not PROFILING_PAIRS & set(UNPORTED)
    model = {"component_key": "model", "variant_key": "gpt2", "config": yaml.safe_load(
        (ROOT / "configs" / "config_profile_gpt2.yaml").read_text())["model"]["config"]}
    built = []
    for kind, (generator, forward, profilers) in {
        "jax": (("batch_generator", "random_dataset_batch_generator",
                 {"micro_batch_size": 2, "sequence_length": 32, "vocab_size": 64}), "batch_generator",
                ("profiler", ("kernel_profiler", "memory_profiler", "combined_profiler", "no_profiler"),
                 {"wait_steps": 2, "warmup_steps": 1, "active_steps": 2, "profile_memory": True,
                  "tracked_ranks": [0]})),
        "reference": (("dataset_batch_generator", "random", {"dims": {"batch": 2, "seq": 32}, "max_val": 64}),
                      "dataset_batch_generator",
                      ("steppable_profiler", ("kernel_tracing", "memory_tracing", "combined", "no_profiler"),
                       {"num_wait_steps": 2, "num_warmup_steps": 1, "num_active_steps": 2, "with_stack": True,
                        "profile_memory": True, "tracked_ranks": [0]})),
    }.items():
        key, (kernel, memory, combined, none), knobs = profilers
        out = str(tmp_path / kind)
        config = {
            "model": model,
            "steppable_component": {"component_key": "steppable_component", "variant_key": "forward_pass", "config": {
                "model": {"instance_key": "model", "pass_type": "BY_REFERENCE"},
                forward: {"component_key": generator[0], "variant_key": generator[1], "config": generator[2]}}},
            "profiler": {"component_key": key, "variant_key": combined, "config": {"profilers": [
                {"component_key": key, "variant_key": kernel, "config": {"output_folder_path": out, **knobs}},
                {"component_key": key, "variant_key": memory, "config": {"output_folder_path": out, "max_steps": 9}},
                {"component_key": key, "variant_key": none}]}},
        }
        # the harness's catalog: the training catalog, its forward pass bound to a device (here the CPU)
        built.append(ComponentFactory(_registry_with(None, "cpu")).build_components(config, ProfilerInstantiationModel))
    for components in built:
        component, profiler = components.steppable_component, components.profiler
        assert isinstance(profiler, SteppableCombinedProfiler) and len(profiler) == 9
        kernel, memory, none = profiler.profilers
        assert (kernel.wait_steps, kernel.warmup_steps, kernel.active_steps, len(kernel)) == (2, 1, 2, 5)
        assert kernel.knobs["profile_memory"] and kernel.tracked_ranks == [0] and isinstance(none, SteppableNoProfiler)
        assert component.include_backward is False  # no optimizer: forward only, as in JAX
        assert component.batch_generator.get_batch(1)["samples"]["input_ids"].shape == (1, 2, 32)
    assert built[1].profiler.profilers[0].with_python_stack
    with pytest.raises(ValueError, match="needs either the reference dims-style schema"):
        ComponentFactory(PORT)._instantiate("batch_generator", "random_dataset_batch_generator",
                                            {"micro_batch_size": 2, "sequence_length": 32})


def _jax_tree(group) -> set:
    import click

    out = set()
    for name, command in group.commands.items():
        out.add(name)
        if isinstance(command, click.Group):
            out |= {f"{name} {sub}" for sub in _jax_tree(command)}
    return out


def _port_tree(parser) -> set:
    import argparse

    out = set()
    for action in parser._actions:
        if isinstance(action, argparse._SubParsersAction):
            for name, sub in action.choices.items():
                out.add(name)
                out |= {f"{name} {deeper}" for deeper in _port_tree(sub)}
    return out


def test_the_cli_has_the_jax_command_tree_and_each_command_runs_or_names_its_item(tmp_path, monkeypatch):
    """Every command and group of the JAX CLI is the port's (ROADMAP.md
    Queue 3 item 23); the ones the port lacks raise NotImplementedError
    naming their Queue 1 item, with the error record written."""
    from modalities_tpu.__main__ import main as jax_cli
    from modalities_tpu_torch.__main__ import _UNPORTED_DATA, build_parser, main

    assert _port_tree(build_parser()) == _jax_tree(jax_cli)
    monkeypatch.setenv("MODALITIES_TPU_ERROR_LOG_DIR", str(tmp_path))
    config = str(ROOT / "configs" / "config_2p7b_dp.yaml")
    for argv in (["convert_checkpoint_to_hf", "--config_file_path", config, "--output_hf_checkpoint_dir", "out"],
                 *[["data", name] for name in _UNPORTED_DATA]):
        with pytest.raises(NotImplementedError, match=r"ROADMAP\.md, Queue 1 item 6"):
            main(argv)
        assert json.loads((tmp_path / "error_rank_0.json").read_text())["error"].startswith("NotImplementedError")
    with pytest.raises(SystemExit) as usage:  # a path that does not exist: a usage error, as click's exists=True
        main(["profile", "distributed", "--config_file_path", str(tmp_path / "missing.yaml")])
    assert usage.value.code == 2
    sweep = tmp_path / "sweep"
    for argv in (["benchmark", "list_remaining_runs", "--sweep_dir", str(tmp_path)],
                 ["benchmark", "summarize_results", "--sweep_dir", str(tmp_path)]):
        assert main(argv) == 0
    spec = tmp_path / "sweep.yaml"
    spec.write_text(yaml.safe_dump({"sweep": {"world_size": [1, 2], "lr": [0.1]},
                                    "settings": {"lr": "${sweep.lr}"}}))
    assert main(["benchmark", "prepare_sweep_configs", "--sweep_config_path", str(spec), "--output_dir",
                 str(sweep)]) == 0
    written = sorted(p.relative_to(sweep).as_posix() for p in sweep.rglob("config.yaml"))
    assert written == ["world_size_1/lr_0.1__world_size_1/config.yaml", "world_size_2/lr_0.1__world_size_2/config.yaml"]
    assert yaml.safe_load((sweep / written[0]).read_text())["settings"]["lr"] == 0.1

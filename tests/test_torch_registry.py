"""The port's component catalog against the JAX package's: every
(component_key, variant_key) pair the JAX catalog registers
(modalities_tpu/registry/components.py, and the `inference_component`
variants its serve() adds) is registered in the port, and every pair a
shipped configs/*.yaml names is either built by the port or refused with
NotImplementedError naming its ROADMAP.md Queue 1 item, never "Unknown
variant_key". The serving variants are all ported: configs/config_serve.yaml,
config_fleet.yaml and config_disagg.yaml build with their `slo` blocks as
shipped (their tokenizer stubbed). No data file is needed."""

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
    assert len(UNPORTED) == 42
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

"""The port's component catalog against the JAX package's: every
(component_key, variant_key) pair the JAX catalog registers
(modalities_tpu/registry/components.py, and the `inference_component`
variants its serve() adds) is registered in the port, and every pair a
shipped configs/*.yaml names is either built by the port or refused with
NotImplementedError naming its ROADMAP.md Queue 1 item, never "Unknown
variant_key". The serving variants are all ported: configs/config_fleet.yaml
and configs/config_disagg.yaml build with `slo: null` (their tokenizer
stubbed), and a non-null `slo` is refused naming item 6. No data file is
needed."""

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
    assert len(UNPORTED) == 47
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


@pytest.mark.parametrize("name,variant", [("config_fleet", "fleet"), ("config_disagg", "disagg")])
def test_the_fleet_configs_build_with_slo_null_and_refuse_an_slo(name, variant):
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
    with pytest.raises(NotImplementedError, match=r"\['slo'\].*Queue 1 item 6"):
        factory.build_components(config, ServeInstantiationModel)
    node["slo"] = None
    component = factory.build_components(config, ServeInstantiationModel).serving_component
    assert type(component).__name__ == {"fleet": "FleetServingComponent", "disagg": "DisaggServingComponent"}[variant]
    assert hasattr(component, "run_fleet") and component.kv_cache == "paged"
    if variant == "fleet":
        assert (component.num_workers, component.probation_s, component.health_interval_s) == (2, None, 0.5)
    else:
        assert (component.prefill_workers, component.decode_workers) == (1, 1)

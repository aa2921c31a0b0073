"""Recursive component factory: the port's copy of
modalities_tpu/config/component_factory.py, validating with the config
dataclasses (config/config.py) instead of pydantic.

* a dict node containing ``component_key`` + ``variant_key`` is a component
  config: its ``config`` sub-node is built first (recursively), validated
  against the variant's config dataclass (unknown keys refused), then the
  component type is instantiated with the validated fields.
* a dict node with exactly ``{instance_key, pass_type}`` is a reference: the
  referenced top-level component is built on demand (once) and shared.
* top-level components are memoized, so every reference sees one instance.
"""

from __future__ import annotations

import dataclasses
from typing import Any

from modalities_tpu_torch.config.config import validate_config
from modalities_tpu_torch.registry.registry import Registry


class ComponentFactory:
    def __init__(self, registry: Registry) -> None:
        self.registry = registry

    def build_components(self, config_dict: dict, components_model_type: type):
        """Build every component the instantiation dataclass names (optional
        fields only if present in the config) and validate the result."""
        fields = dataclasses.fields(components_model_type)
        required = [
            f.name
            for f in fields
            if f.default is dataclasses.MISSING and f.default_factory is dataclasses.MISSING
        ]
        optional = [f.name for f in fields if f.name not in required]
        missing = [name for name in required if name not in config_dict]
        if missing:
            raise ValueError(
                f"Config is missing required top-level components {missing}. "
                f"Present keys: {sorted(config_dict)}; also optional: {optional}"
            )
        filtered = {name: config_dict[name] for name in required + optional if name in config_dict}
        components, _ = self._build_component(filtered, config_dict, {}, [])
        return components_model_type(**components)

    def _build_component(
        self, current: Any, full_config: dict, top_level: dict[str, Any], path: list[str]
    ) -> tuple[Any, dict[str, Any]]:
        if len(path) == 1 and path[0] in top_level:
            return top_level[path[0]], top_level
        if isinstance(current, dict):
            materialized: dict[str, Any] = {}
            for key, sub in current.items():
                materialized[key], top_level = self._build_component(sub, full_config, top_level, path + [key])
            if "component_key" in current:
                component = self._instantiate(
                    current["component_key"], current["variant_key"], materialized.get("config", {})
                )
                if len(path) == 1:
                    top_level[path[-1]] = component
                return component, top_level
            if {"instance_key", "pass_type"} == current.keys():
                referenced = current["instance_key"]
                if referenced not in top_level:
                    if referenced not in full_config:
                        raise ValueError(
                            f"Reference to unknown top-level component {referenced!r} (at {' -> '.join(path)})"
                        )
                    built, top_level = self._build_component(
                        full_config[referenced], full_config, top_level, [referenced]
                    )
                    top_level[referenced] = built
                return top_level[referenced], top_level
            return materialized, top_level
        if isinstance(current, list):
            out = []
            for i, sub in enumerate(current):
                built, top_level = self._build_component(sub, full_config, top_level, path + [str(i)])
                out.append(built)
            return out, top_level
        return current, top_level

    def _instantiate(self, component_key: str, variant_key: str, config: dict) -> Any:
        config_type = self.registry.get_config(component_key, variant_key)
        component_type = self.registry.get_component(component_key, variant_key)
        if config_type is None:
            if config:
                raise ValueError(f"Component `{component_key}.{variant_key}` takes no config, got: {config}")
            return component_type()
        validated = validate_config(config_type, config)
        if config_type is component_type:  # a dataclass component is its own config
            return validated
        return component_type(**{f.name: getattr(validated, f.name) for f in dataclasses.fields(config_type)})

"""Two-level component registry: the port's copy of
modalities_tpu/registry/registry.py.

Maps ``component_key -> variant_key -> (component type, config dataclass)``.
A variant of the JAX catalog that the port does not have yet is registered as
an `Unported` entity: looking it up raises NotImplementedError naming its
ROADMAP.md item, never "Unknown variant_key".
"""

from dataclasses import dataclass
from typing import Optional


@dataclass(frozen=True)
class ComponentEntity:
    component_key: str
    variant_key: str
    component_type: type
    component_config_type: Optional[type] = None


@dataclass(frozen=True)
class Unported:
    """The component type of a JAX variant the port lacks: `item` is its
    ROADMAP.md Queue 1 item."""

    item: int
    what: str

    def refuse(self, component_key: str, variant_key: str):
        raise NotImplementedError(f"{component_key}.{variant_key} ({self.what}) is not ported yet "
                                  f"(ROADMAP.md, Queue 1 item {self.item})")


class Registry:
    def __init__(self, components: Optional[list[ComponentEntity]] = None) -> None:
        self._registry_dict: dict[str, dict[str, tuple[type, Optional[type]]]] = {}
        for entity in components or []:
            self.add_entity(entity)

    def add_entity(self, entity: ComponentEntity) -> None:
        self._registry_dict.setdefault(entity.component_key, {})[entity.variant_key] = (
            entity.component_type,
            entity.component_config_type,
        )

    def get_component(self, component_key: str, variant_key: str):
        return self._get(component_key, variant_key)[0]

    def get_config(self, component_key: str, variant_key: str) -> Optional[type]:
        return self._get(component_key, variant_key)[1]

    def _get(self, component_key: str, variant_key: str):
        try:
            variants = self._registry_dict[component_key]
        except KeyError:
            raise ValueError(
                f"Unknown component_key {component_key!r}. Known keys: {sorted(self._registry_dict)}"
            ) from None
        try:
            entry = variants[variant_key]
        except KeyError:
            raise ValueError(
                f"Unknown variant_key {variant_key!r} for component {component_key!r}. "
                f"Known variants: {sorted(variants)}"
            ) from None
        if isinstance(entry[0], Unported):
            entry[0].refuse(component_key, variant_key)
        return entry

    def keys(self) -> set[tuple[str, str]]:
        """Every registered (component_key, variant_key), unported ones included."""
        return {(c, v) for c, variants in self._registry_dict.items() for v in variants}

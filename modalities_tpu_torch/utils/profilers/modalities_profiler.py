"""The standalone profiling harness (`profile distributed`): the port of
modalities_tpu/utils/profilers/modalities_profiler.py.

Builds {steppable_component, profiler} from a config with the port's
training catalog and steps the component max(len(profiler), 1) times inside
the profiler. `run_distributed` joins the port's process group first (the
launcher's world under `torch.distributed.run`, else a world of 1).
"""

from __future__ import annotations

import dataclasses
import functools
from pathlib import Path
from typing import Any, Optional

from modalities_tpu_torch.config.component_factory import ComponentFactory
from modalities_tpu_torch.config.yaml_interp import load_app_config_dict
from modalities_tpu_torch.registry.components import TRAINING_COMPONENTS
from modalities_tpu_torch.registry.registry import ComponentEntity, Registry


@dataclasses.dataclass
class ProfilerInstantiationModel:
    steppable_component: Any
    profiler: Any


@dataclasses.dataclass
class CustomComponentRegisterable:
    """A user-supplied component to register before building the profiling
    graph (how the rms-norm tutorial injects its SteppableNorm)."""

    component_key: str
    variant_key: str
    custom_component: type
    custom_config: type


def _registry_with(custom_component_registerables, device) -> Registry:
    from modalities_tpu_torch.utils.profilers.steppable_components import (
        SteppableForwardPassConfig,
        steppable_forward_pass,
    )

    registry = Registry(TRAINING_COMPONENTS)
    # the forward pass builds its step on the harness's device
    registry.add_entity(ComponentEntity("steppable_component", "forward_pass",
                                        functools.partial(steppable_forward_pass, device=device),
                                        SteppableForwardPassConfig))
    for reg in custom_component_registerables or ():
        registry.add_entity(ComponentEntity(reg.component_key, reg.variant_key, reg.custom_component,
                                            reg.custom_config))
    return registry


@dataclasses.dataclass
class _SteppableOnly:
    steppable_component: Any


def build_steppable_component(config_file_path: Path, device: Optional[str] = None):
    """The config's steppable component alone (the static walk of a harness
    config reads its step; utils/recipe_validation.py)."""
    config_dict = load_app_config_dict(Path(config_file_path))
    return ComponentFactory(_registry_with(None, device)).build_components(config_dict,
                                                                           _SteppableOnly).steppable_component


class ModalitiesProfilerStarter:
    @staticmethod
    def run_distributed(config_file_path: Path, experiment_root_path: Optional[Path] = None,
                        experiment_id: Optional[str] = None,
                        custom_component_registerables: Optional[list[CustomComponentRegisterable]] = None,
                        device: Optional[str] = None):
        """`run_single_process` inside the port's process group for `device`
        (default: the card). Returns the built components."""
        from modalities_tpu_torch.device import resolve_device
        from modalities_tpu_torch.running_env import env

        device = resolve_device(device)
        with env.process_group(device):
            return ModalitiesProfilerStarter.run_single_process(
                config_file_path, experiment_root_path=experiment_root_path, experiment_id=experiment_id,
                custom_component_registerables=custom_component_registerables, device=device)

    @staticmethod
    def run_single_process(config_file_path: Path, experiment_root_path: Optional[Path] = None,
                           experiment_id: Optional[str] = None,
                           custom_component_registerables: Optional[list[CustomComponentRegisterable]] = None,
                           device: Optional[str] = None) -> ProfilerInstantiationModel:
        """Build the config's component and profiler and step them; returns
        the built components (the component holds its step and losses, the
        profiler its traces)."""
        config_dict = load_app_config_dict(Path(config_file_path), experiments_root_path=experiment_root_path,
                                           experiment_id=experiment_id)
        components = ComponentFactory(_registry_with(custom_component_registerables, device)).build_components(
            config_dict, ProfilerInstantiationModel)
        component, profiler = components.steppable_component, components.profiler
        with profiler:
            for _ in range(max(len(profiler), 1)):
                component.step()
                profiler.step()
        return components

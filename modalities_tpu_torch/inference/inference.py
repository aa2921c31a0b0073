"""Config-driven text generation, the port of
modalities_tpu/inference/inference.py (`generate_text`,
`_resolve_component_params`, `build_text_inference_components`): the entry
behind `python -m modalities_tpu_torch generate_text`.

Two config shapes, as in the JAX package:
- `settings` / `model` / `tokenizer` (configs/config_generate_text.yaml): the
  component is built from `settings` (prompt_template, sequence_length,
  temperature, seed, eod_token);
- the reference's `text_inference_component` node (`inference_component.text`)
  with `settings.model_path`.

The parameters come from a sealed checkpoint folder of the port
(`settings.checkpoint_folder_path`, else `settings.model_path`): the folder
must pass its manifest, then the model's parameters alone are read from the
full app state. With no folder named, the model's own initialization
(a generator seeded with 0). Prompts are read from stdin, one a line, until
EOF; each completion prints. On the card the run ends with the process's
kernel launches (ops.launch_counts), as `run`'s does.
"""

from __future__ import annotations

import dataclasses
import json
import logging
from pathlib import Path
from typing import Any, Optional

import torch

from modalities_tpu_torch.config.yaml_interp import load_app_config_dict
from modalities_tpu_torch.device import resolve_device

logger = logging.getLogger(__name__)


@dataclasses.dataclass
class _TextGenModel:
    model: Any
    tokenizer: Any
    settings: dict


@dataclasses.dataclass
class TextGenerationInstantiationModel:
    """The reference shape (JAX TextGenerationInstantiationModel): the
    component, and settings with `model_path` and `sequence_length`."""

    text_inference_component: Any
    settings: dict

    def __post_init__(self):
        missing = [k for k in ("model_path", "sequence_length") if k not in (self.settings or {})]
        if missing:
            raise ValueError(f"settings: missing {missing}")


def _load_params(checkpoint_folder_path, device) -> dict:
    """The model's parameters of a sealed app-state folder, on `device`."""
    from modalities_tpu_torch.checkpointing.dcp.dcp_checkpoint_loading import restore_tree_single_device
    from modalities_tpu_torch.resilience.manifest import verify_manifest

    folder = Path(checkpoint_folder_path)
    verification = verify_manifest(folder)
    if not verification.ok:
        raise ValueError(f"refusing to generate from {folder}: checkpoint failed manifest verification "
                         f"({verification.reason})")
    return restore_tree_single_device(folder, device=device)


def _init_params(model, device) -> dict:
    logger.warning("generate_text: no checkpoint folder — generating from the model's own initialization")
    return model.init_params(torch.Generator(device=device).manual_seed(0))


def generate_text(config_file_path: Path, device: Optional[str] = None) -> None:
    """Build the component the config describes and run its prompt loop."""
    from modalities_tpu_torch.config.component_factory import ComponentFactory
    from modalities_tpu_torch.inference.text.inference_component import TextInferenceComponent
    from modalities_tpu_torch.registry.components import COMPONENTS
    from modalities_tpu_torch.registry.registry import Registry

    config_dict = load_app_config_dict(config_file_path)
    if "text_inference_component" in config_dict:
        components = build_text_inference_components(config_dict)
        component = components.text_inference_component
        component.device = resolve_device(device)
        _resolve_component_params(component, components.settings.get("model_path"))
        _run(component)
        return

    components = ComponentFactory(Registry(COMPONENTS)).build_components(config_dict, _TextGenModel)
    settings, model = components.settings, components.model
    device = resolve_device(device)
    folder = settings.get("checkpoint_folder_path") or settings.get("model_path")
    params = _load_params(folder, device) if folder else _init_params(model, device)
    temperature = settings.get("temperature", 1.0)
    component = TextInferenceComponent(
        model=model, params=params, tokenizer=components.tokenizer,
        prompt_template=settings.get("prompt_template", "{prompt}"),
        sequence_length=int(settings.get("sequence_length", model.config_spec.sequence_length)),
        temperature=None if temperature is None else float(temperature),
        seed=int(settings.get("seed", 0)), eod_token=settings.get("eod_token", "<eod>"),
    )
    component.device = device
    _run(component)


def _run(component) -> None:
    component.run()
    if component.device.type == "cuda":
        from modalities_tpu_torch.ops import launch_counts

        print(f"[generate_text] kernel launches in this process: {json.dumps(launch_counts())}", flush=True)


def _resolve_component_params(component, model_path) -> None:
    """Give a built component its parameters: the checkpoint at `model_path`
    when it exists on disk, else the model's own initialization."""
    if component.params is not None:
        return
    device = resolve_device(component.device)
    if model_path is not None and Path(model_path).exists():
        component.params = _load_params(model_path, device)
    else:
        component.params = _init_params(component.model, device)


def build_text_inference_components(config_dict: dict):
    """Build the reference-shaped graph: `inference_component.text` is
    registered as the reference's generate_text registers it."""
    from modalities_tpu_torch.config.component_factory import ComponentFactory
    from modalities_tpu_torch.inference.text.inference_component import (
        TextInferenceComponent,
        TextInferenceComponentConfig,
    )
    from modalities_tpu_torch.registry.components import COMPONENTS
    from modalities_tpu_torch.registry.registry import ComponentEntity, Registry

    registry = Registry(COMPONENTS + [ComponentEntity("inference_component", "text", TextInferenceComponent,
                                                      TextInferenceComponentConfig)])
    return ComponentFactory(registry).build_components(config_dict, TextGenerationInstantiationModel)

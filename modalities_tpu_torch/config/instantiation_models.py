"""Top-level config schemas (the port's counterpart of
modalities_tpu/config/instantiation_models.py)."""

from __future__ import annotations

import dataclasses
from typing import Any, Optional

from modalities_tpu_torch.config.config import check_str, validate_config


@dataclasses.dataclass
class ServeSettings:
    """`settings` of the serve entry: `checkpoint_folder_path` null serves
    fresh-init parameters (smoke tests and demos)."""

    checkpoint_folder_path: Optional[str] = None

    def __post_init__(self):
        if self.checkpoint_folder_path is not None:
            self.checkpoint_folder_path = check_str("checkpoint_folder_path", str(self.checkpoint_folder_path))


@dataclasses.dataclass
class ServeInstantiationModel:
    serving_component: Any
    settings: Any = dataclasses.field(default_factory=ServeSettings)

    def __post_init__(self):
        if isinstance(self.settings, dict):
            self.settings = validate_config(ServeSettings, self.settings)

"""App-state specs, fresh or to be loaded from a checkpoint: the port of
modalities_tpu/checkpointing/stateful/app_state_factory.py.

A spec bundles the model, optimizer and scheduler specs the train step is
built from; the `dcp` variant adds the checkpoint folder and loader, and
`Main` loads it into the built step (the `raw` and `dcp` variants of the JAX
registry).
"""

from __future__ import annotations

import dataclasses
from pathlib import Path
from typing import Any, Optional


@dataclasses.dataclass
class AppStateSpec:
    model: Any
    optimizer: Any
    lr_scheduler: Any = None
    checkpoint_dir_path: Optional[Path] = None  # set: load into the built train step
    checkpoint_loading: Any = None


@dataclasses.dataclass
class RawAppStateConfig:
    model: Any
    optimizer: Any
    lr_scheduler: Any = None


@dataclasses.dataclass
class DCPAppStateConfig:
    raw_app_state: Any
    checkpoint_dir_path: Path
    checkpoint_loading: Any = None

    def __post_init__(self):
        if not isinstance(self.raw_app_state, AppStateSpec):
            raise ValueError(f"raw_app_state: expected an app_state.raw component, got {self.raw_app_state!r}")
        self.checkpoint_dir_path = Path(self.checkpoint_dir_path)


class AppStateFactory:
    @staticmethod
    def get_raw_app_state(model, optimizer, lr_scheduler=None) -> AppStateSpec:
        return AppStateSpec(model=model, optimizer=optimizer, lr_scheduler=lr_scheduler)

    @staticmethod
    def get_dcp_checkpointed_app_state_(raw_app_state: AppStateSpec, checkpoint_dir_path: Path,
                                        checkpoint_loading=None) -> AppStateSpec:
        raw_app_state.checkpoint_dir_path = Path(checkpoint_dir_path)
        raw_app_state.checkpoint_loading = checkpoint_loading
        return raw_app_state

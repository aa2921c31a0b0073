"""The `app_state.raw` component: the model, optimizer and scheduler specs
the train step is built from (the JAX AppStateFactory.get_raw_app_state's
inputs; the state itself lives in the train step)."""

from __future__ import annotations

import dataclasses
from typing import Any


@dataclasses.dataclass
class AppStateSpec:
    model: Any
    optimizer: Any
    lr_scheduler: Any = None

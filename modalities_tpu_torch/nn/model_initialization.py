"""Weight init routines: the port of
modalities_tpu/nn/model_initialization/composed_initialization.py (`plain`,
`scaled`, `scaled_embed`).

Each routine is a regex-targeted N(mean, std) over parameter names. The JAX
package applies them in order as redraws of the whole tree; here a parameter
is drawn once, by the last routine that targets it (`targets`, `draw`; the
interface nn/llama3_initialization.py shares), from the `torch.Generator` of
the train step (`GPT2LLM.init_train_params`).
The two frameworks draw different numbers from one seed; the distributions
are the same.
"""

from __future__ import annotations

import dataclasses
import math
import re
from typing import Optional

import torch

from modalities_tpu_torch.config.config import check_float, check_int, check_str

# regex groups per model type over the port's state-dict names (the JAX
# groups with `.` for flax's `/`)
NAMED_PARAMETER_INIT_GROUPS = {
    "gpt2": {
        "weighted_layers": [r".*(q_attn|k_attn|v_attn|c_proj|c_fc|W|V|W_2)\.kernel.*", r".*wte.*", r".*wpe.*"],
        "embedding_layers": [r".*(wte|wpe).*"],
        "projection_layers": [r".*(c_proj|W_2)\.kernel.*"],
    },
}


@dataclasses.dataclass(frozen=True)
class InitializationRoutine:
    """One regex-targeted N(mean, std)."""

    patterns: tuple[str, ...]
    std: float
    mean: float = 0.0

    def matches(self, name: str) -> bool:
        return any(re.search(p, name) for p in self.patterns)


@dataclasses.dataclass
class ComposedModelInitialization:
    """plain + optional scaled + optional scaled_embed (the JAX class's
    routines, in its order)."""

    model_type: str
    weight_init_type: str
    mean: float = 0.0
    std: float | str = 0.02
    num_layers: Optional[int] = None
    hidden_dim: Optional[int] = None

    def __post_init__(self):
        check_str("model_type", self.model_type)
        self.mean = check_float("mean", self.mean)
        check_int("num_layers", self.num_layers, optional=True)
        check_int("hidden_dim", self.hidden_dim, optional=True)
        if self.model_type not in NAMED_PARAMETER_INIT_GROUPS:
            raise ValueError(f"Unknown model_type {self.model_type!r}; known: {sorted(NAMED_PARAMETER_INIT_GROUPS)}")
        if self.weight_init_type not in ("plain", "scaled", "scaled_embed"):
            raise ValueError(f"weight_init_type {self.weight_init_type!r}: expected plain, scaled or scaled_embed")
        groups = NAMED_PARAMETER_INIT_GROUPS[self.model_type]
        if self.std == "auto":
            if self.hidden_dim is None:
                raise ValueError('std="auto" requires hidden_dim')
            std = math.sqrt(2 / (5 * self.hidden_dim))
        else:
            std = check_float("std", self.std)
        self.routines = [InitializationRoutine(tuple(groups["weighted_layers"]), std, self.mean)]
        if self.weight_init_type in ("scaled", "scaled_embed"):
            if self.num_layers is None:
                raise ValueError("scaled init requires num_layers")
            self.routines.append(
                InitializationRoutine(tuple(groups["projection_layers"]), std / math.sqrt(2 * self.num_layers), self.mean)
            )
        if self.weight_init_type == "scaled_embed":
            self.routines.append(InitializationRoutine(tuple(groups["embedding_layers"]), math.sqrt(0.4), self.mean))

    def validate(self, names: list[str]) -> None:
        """Nothing to check: a routine may target no parameter."""

    def targets(self, name: str) -> bool:
        return self.normal_for(name) is not None

    def draw(self, name: str, shape, generator: torch.Generator) -> torch.Tensor:
        """The fp32 tensor of parameter `name`, drawn on the generator's device."""
        mean, std = self.normal_for(name)
        return torch.empty(shape, device=generator.device).normal_(mean, std, generator=generator)

    def normal_for(self, name: str) -> Optional[tuple[float, float]]:
        """(mean, std) of the last routine targeting `name`, or None."""
        hit = None
        for routine in self.routines:
            if routine.matches(name):
                hit = (routine.mean, routine.std)
        return hit

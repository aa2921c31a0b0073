"""Llama3-like weight initialization (the `gpt2_llama3_like` variant): the
port of modalities_tpu/nn/model_initialization/llama3_initialization.py.

Groups, by the port's parameter names:
- wte: N(0, 1);
- lm_head: truncN(0, 1/sqrt(E)) truncated at +-3/sqrt(E);
- q/k/v and W: truncN(0, 0.02) truncated at +-2 (absolute);
- c_proj, V and W_2: truncN(0, std_l) truncated at +-2, with std_l =
  0.02 / sqrt(2 (l + 1)) for layer l under `depth_init`, else the constant
  0.02 / sqrt(2 L).

Truncation bounds are capped at 10 standard deviations, as the JAX sampler
caps them. Its structural errors stay: a bias parameter, a group that
matches no parameter (a GELU MLP, a tied head) and a parameter in two groups
raise ValueError. Every other parameter keeps the model's default init.

Each tensor is drawn whole, in fp32, from the train step's `torch.Generator`
(`GPT2LLM.init_train_params`), before any sharding: the values do not depend
on the tp or dp degree. The two frameworks draw different numbers from one
seed; the distributions are the same.
"""

from __future__ import annotations

import dataclasses
import math
import re
from typing import Optional

import torch

from modalities_tpu_torch.config.config import check_bool, check_int

TRUNC_SIGMA_CAP = 10.0
GROUPS = {
    "embedding": r"^wte$",
    "lm_head": r"^lm_head\.kernel$",
    "qkv": r"\.attn\.(q_attn|k_attn|v_attn)\.kernel$",
    "attn_out": r"\.attn\.c_proj\.kernel$",
    "mlp_in": r"\.mlp\.W\.kernel$",
    "mlp_scaled": r"\.mlp\.(V|W_2)\.kernel$",
}
_LAYER = re.compile(r"^blocks\.(\d+)\.")


@dataclasses.dataclass
class Llama3Initializer:
    num_layers: int
    n_embd: int
    depth_init: bool = True

    def __post_init__(self):
        check_int("num_layers", self.num_layers, ge=1)
        check_int("n_embd", self.n_embd, ge=1)
        check_bool("depth_init", self.depth_init)

    def group_of(self, name: str) -> Optional[str]:
        matches = [g for g, pattern in GROUPS.items() if re.search(pattern, name)]
        if len(matches) > 1:
            raise ValueError(f"Parameter {name} matched multiple init groups ({matches}), which is not allowed")
        return matches[0] if matches else None

    def validate(self, names: list[str]) -> None:
        """The JAX initializer's structural checks over the model's parameter names."""
        hits = dict.fromkeys(GROUPS, 0)
        for name in names:
            if re.search(r"(^|\.)bias$", name):
                raise ValueError(f"Bias initialization is not allowed for Llama3Initializer. Found bias parameter: "
                                 f"{name}")
            group = self.group_of(name)
            if group is not None:
                hits[group] += 1
        for group, count in hits.items():
            if count == 0:
                raise ValueError(f"Init group {group!r} ({GROUPS[group]}) did not match any parameter. The model "
                                 "specification probably does not match Llama3 (requires SwiGLU MLP, separate q/k/v "
                                 "projections, and untied lm_head).")

    def targets(self, name: str) -> bool:
        return self.group_of(name) is not None

    def std_and_bounds(self, name: str) -> tuple[float, float, float]:
        """(std, lower, upper) of a truncated group's normal (absolute bounds)."""
        group = self.group_of(name)
        if group == "lm_head":
            s = 1.0 / math.sqrt(self.n_embd)
            return s, -3.0 * s, 3.0 * s
        if group in ("qkv", "mlp_in"):
            return 0.02, -2.0, 2.0
        if group not in ("attn_out", "mlp_scaled"):
            raise ValueError(f"{name}: no truncated normal in the Llama3 init")
        layer = int(_LAYER.match(name).group(1))
        if layer >= self.num_layers:
            raise ValueError(f"{name}: layer {layer} is past num_layers ({self.num_layers})")
        depth = layer + 1 if self.depth_init else self.num_layers
        return 0.02 / math.sqrt(2.0 * depth), -2.0, 2.0

    def draw(self, name: str, shape, generator: torch.Generator) -> torch.Tensor:
        """The fp32 tensor of parameter `name`, drawn whole on the generator's device."""
        t = torch.empty(shape, device=generator.device)
        if self.group_of(name) == "embedding":
            return t.normal_(0.0, 1.0, generator=generator)
        std, a, b = self.std_and_bounds(name)
        lower, upper = max(a / std, -TRUNC_SIGMA_CAP), min(b / std, TRUNC_SIGMA_CAP)
        torch.nn.init.trunc_normal_(t, 0.0, 1.0, lower, upper, generator=generator)
        return t.mul_(std)

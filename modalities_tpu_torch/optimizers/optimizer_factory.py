"""Optimizers: the port of modalities_tpu/optimizers/optimizer_factory.py.

`OptimizerSpec` is what the `optimizer` component builds from the config; the
train step turns it into a torch optimizer over the module's parameters with
`build`. The weight-decay mask comes from the model's regex
`weight_decay_groups` exactly as `build_weight_decay_mask` resolves it (the
`norm`/`layernorm` alias included), matched against the parameters' names
(GPT2's regexes match the port's state-dict names as they match the flax
paths) or, for a model that gives `jax_param_path` (the ViT, CoCa), against
the flax paths of the names, so the JAX regexes pick the same parameters;
the mask becomes two parameter groups:

- `adam_w`: `torch.optim.AdamW`, which matches `optax.adamw`: bias-corrected
  moments, eps outside the square root, decoupled decay lr * wd * p;
- `adam`: `torch.optim.Adam` with L2 decay into the gradient, which matches
  the JAX chain `add_decayed_weights` -> `adam`.

The moments take each parameter's dtype, as optax's do. Every optimizer is
torch's fused implementation: one kernel a step over all the parameters, its
step count a tensor on the parameters' device, a rate that may be a device
tensor, and a device-side `found_inf` that leaves the parameters, both
moments and the step count untouched without a host sync (the train step's
anomaly skip and its rate, training/train_step.py). Every run takes the same
implementation, so a step with the skip armed and nothing anomalous is
bitwise a step without it; a config asking for another one (`foreach: true`,
`fused: false`) is refused.
"""

from __future__ import annotations

import dataclasses
import re
from typing import Any, Optional

import torch

from modalities_tpu_torch.config.config import check_bool, check_float


@dataclasses.dataclass
class AdamOptimizerConfig:
    lr: float
    wrapped_model: Any
    betas: list
    eps: float
    weight_decay: float
    weight_decay_groups_excluded: list
    foreach: Optional[bool] = None  # accepted for config parity: None or false
    fused: Optional[bool] = None  # accepted for config parity: None or true

    def __post_init__(self):
        self.lr = check_float("lr", self.lr, ge=0.0)
        if len(self.betas) != 2:
            raise ValueError(f"betas: expected two numbers, got {self.betas!r}")
        self.betas = [check_float("betas", b, ge=0.0) for b in self.betas]
        self.eps = check_float("eps", self.eps, ge=0.0)
        self.weight_decay = check_float("weight_decay", self.weight_decay, ge=0.0)
        if not isinstance(self.weight_decay_groups_excluded, list):
            raise ValueError("weight_decay_groups_excluded: expected a list")
        check_bool("foreach", self.foreach, optional=True)
        check_bool("fused", self.fused, optional=True)
        if self.foreach or self.fused is False:
            # every update is torch's fused one: the anomaly skip's device flag and the device rate ride it
            raise NotImplementedError(
                f"foreach: {self.foreach}, fused: {self.fused}: the port always runs torch's fused optimizer "
                "(the anomaly skip's mechanism, ROADMAP Queue 3 item 21); leave both unset, or set fused: true")


def weight_decay_mask(names: list[str], groups: dict[str, list[str]], excluded: list[str]) -> dict[str, bool]:
    """True = apply weight decay (JAX optimizer_factory.py:33-60)."""
    if not excluded:
        return {n: True for n in names}
    aliases = {"norm": "layernorm", "layernorm": "norm"}
    resolved = [g if g in groups else aliases.get(g, g) if aliases.get(g, g) in groups else g for g in excluded]
    for g in resolved:
        if g not in groups:
            raise ValueError(f"weight decay group {g!r} not in model's weight_decay_groups {sorted(groups)}")
    patterns = [re.compile(p) for g in resolved for p in groups[g]]
    return {n: not any(p.search(n) for p in patterns) for n in names}


@dataclasses.dataclass
class OptimizerSpec:
    kind: str  # "adam_w" | "adam"
    lr: float
    betas: tuple[float, float] = (0.9, 0.95)
    eps: float = 1e-8
    weight_decay: float = 0.0
    weight_decay_groups_excluded: list = dataclasses.field(default_factory=list)
    model: Any = None

    def build(self, named_parameters) -> torch.optim.Optimizer:
        """The torch optimizer over (name, parameter) pairs, in two groups:
        decayed and not decayed."""
        named = list(named_parameters)
        groups = self.model.weight_decay_groups if self.model is not None else {}
        path = getattr(self.model, "jax_param_path", lambda name: name)
        mask = weight_decay_mask([path(n) for n, _ in named], groups, self.weight_decay_groups_excluded)
        decay = [p for n, p in named if mask[path(n)]]
        no_decay = [p for n, p in named if not mask[path(n)]]
        param_groups = [g for g in ({"params": decay, "weight_decay": self.weight_decay},
                                    {"params": no_decay, "weight_decay": 0.0}) if g["params"]]
        cls = {"adam_w": torch.optim.AdamW, "adam": torch.optim.Adam}[self.kind]
        return cls(param_groups, lr=self.lr, betas=tuple(self.betas), eps=self.eps, fused=True)


class OptimizerFactory:
    @staticmethod
    def get_adam(lr, betas, eps, weight_decay, weight_decay_groups_excluded, wrapped_model,
                 foreach=None, fused=None) -> OptimizerSpec:
        return OptimizerSpec("adam", lr, tuple(betas), eps, weight_decay, list(weight_decay_groups_excluded),
                             wrapped_model)

    @staticmethod
    def get_adam_w(lr, betas, eps, weight_decay, weight_decay_groups_excluded, wrapped_model,
                   foreach=None, fused=None) -> OptimizerSpec:
        return OptimizerSpec("adam_w", lr, tuple(betas), eps, weight_decay, list(weight_decay_groups_excluded),
                             wrapped_model)

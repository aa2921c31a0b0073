"""Gradient clipping: the port of modalities_tpu/training/gradient_clipping.py.

A clipper is a descriptor the train step reads. The global p2 / p1 / max norm
of all gradients is computed in fp32 and reported as `grad_norm` before
clipping. Clipping follows the JAX package, not `torch.nn.utils.clip_grad_norm_`
(whose `+ 1e-6` gives other numbers):

- p2: optax's `clip_by_global_norm`: g * max_norm / norm where norm >= max_norm;
- p1 / max: the JAX `clip_by_norm_mode`: g * min(1, max_norm / max(norm, 1e-16)).
"""

from __future__ import annotations

import dataclasses
from enum import Enum
from typing import Any, Optional

import torch

from modalities_tpu_torch.config.config import check_bool, check_float


class GradientClippingMode(str, Enum):
    P2_NORM = "p2_norm"
    P1_NORM = "p1_norm"
    MAX_NORM = "max_norm"  # infinity norm

    @classmethod
    def parse(cls, value) -> "GradientClippingMode":
        """The enum, its lowercase value, or the enum NAME (the reference YAMLs' spelling)."""
        if isinstance(value, cls):
            return value
        try:
            return cls(value)
        except ValueError:
            try:
                return cls[str(value).upper()]
            except KeyError:
                raise ValueError(
                    f"{value!r} is not a valid GradientClippingMode (values: {[m.value for m in cls]})"
                ) from None


def global_norm(grads: list[torch.Tensor], mode: GradientClippingMode) -> torch.Tensor:
    """The global norm over all gradients, in fp32, as a 0-d tensor."""
    if mode == GradientClippingMode.P2_NORM:
        return torch.stack([torch.linalg.vector_norm(g, dtype=torch.float32) ** 2 for g in grads]).sum().sqrt()
    if mode == GradientClippingMode.P1_NORM:
        return torch.stack([torch.linalg.vector_norm(g, 1, dtype=torch.float32) for g in grads]).sum()
    return torch.stack([torch.linalg.vector_norm(g, float("inf"), dtype=torch.float32) for g in grads]).max()


def clip_(grads: list[torch.Tensor], norm: torch.Tensor, max_norm: float, mode: GradientClippingMode) -> None:
    """Clip in place, without a host sync (the decision stays on the device)."""
    if mode == GradientClippingMode.P2_NORM:
        clip = norm >= max_norm
        div = torch.where(clip, norm, torch.ones_like(norm))
        mul = torch.where(clip, torch.full_like(norm, max_norm), torch.ones_like(norm))
        for g in grads:  # (g / norm) * max_norm, as optax writes it; dividing by 1 is exact
            g.div_(div.to(g.dtype)).mul_(mul.to(g.dtype))
    else:
        scale = torch.clamp(max_norm / torch.clamp(norm, min=1e-16), max=1.0)
        for g in grads:
            g.mul_(scale.to(g.dtype))


@dataclasses.dataclass
class GradientClipper:
    """Clip to max_norm (the `fsdp2` / `fsdp1` variants)."""

    max_norm: float = 1.0
    norm_type: Any = GradientClippingMode.P2_NORM
    error_if_nonfinite: bool = False
    wrapped_model: Optional[Any] = None  # accepted for config parity; the norm needs no model
    device_mesh: Optional[Any] = None

    def __post_init__(self):
        self.max_norm = check_float("max_norm", self.max_norm, gt=0.0)
        self.norm_type = GradientClippingMode.parse(self.norm_type)
        check_bool("error_if_nonfinite", self.error_if_nonfinite)


@dataclasses.dataclass
class LoggingOnlyGradientClipper:
    """Report the norm without clipping (`fsdp2_logging_only`)."""

    wrapped_model: Optional[Any] = None
    norm_type: Any = GradientClippingMode.P2_NORM
    max_norm = None
    error_if_nonfinite = False

    def __post_init__(self):
        self.norm_type = GradientClippingMode.parse(self.norm_type)


class DummyGradientClipper:
    max_norm = None
    norm_type = GradientClippingMode.P2_NORM
    error_if_nonfinite = False

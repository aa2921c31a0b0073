"""Gradient clipping: the port of modalities_tpu/training/gradient_clipping.py.

A clipper is a descriptor the train step reads. The global p2 / p1 / max norm
of all gradients is computed in fp32 and reported as `grad_norm` before
clipping. Gradients sharded over the device mesh (DTensors) give the whole
model's norm: each rank reduces its shards, then the squares (p2), the sums
(p1) or the maxima are reduced over the mesh dims each gradient is sharded on
(not over a dim that holds copies: dp_replicate, and tp for the gradients
the tensor-parallel plan replicates), so every rank gets the world-1 norm.
Under ZeRO-1 a gradient is a DTensor over this rank's chunk, sharded over
dp_replicate as well (parallel/zero.py), so each element counts once; no
gradient is placed over dcn (its slices hold copies), so nothing is summed
over it;
under pipeline parallelism the stages' totals are reduced over pp too, and
the train step leaves the tied weight's last-stage copy out, so it counts
once.
Clipping follows the JAX package, not `torch.nn.utils.clip_grad_norm_`
(whose `+ 1e-6` gives other numbers):

- p2: optax's `clip_by_global_norm`: g * max_norm / norm where norm >= max_norm;
- p1 / max: the JAX `clip_by_norm_mode`: g * min(1, max_norm / max(norm, 1e-16)).
"""

from __future__ import annotations

import dataclasses
from enum import Enum
from typing import Any, Optional

import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor

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


def _local(g: torch.Tensor) -> torch.Tensor:
    return g.to_local() if isinstance(g, DTensor) else g


def _buckets(grads: list[torch.Tensor]) -> list[tuple[list, list[torch.Tensor]]]:
    """The gradients grouped by the mesh dims they are sharded on, in order of
    first appearance: (the process groups of those dims, the local tensors).
    A gradient replicated over a dim (dp_replicate; tp for the norms) is
    reduced over the others only, so it counts once."""
    buckets: dict = {}
    for g in grads:
        key, groups = (), []
        if isinstance(g, DTensor):
            dims = tuple(i for i, p in enumerate(g.placements) if not (p.is_replicate() or p.is_partial()))
            key = (g.device_mesh.mesh_dim_names, dims)
            groups = [g.device_mesh.get_group(i) for i in dims]
        buckets.setdefault(key, (groups, []))[1].append(_local(g))
    return list(buckets.values())


def global_norm(grads: list[torch.Tensor], mode: GradientClippingMode, across=None) -> torch.Tensor:
    """The global norm over all gradients (plain tensors or DTensors), in
    fp32, as a 0-d tensor. `across`: a process group whose ranks hold other
    parameters (pp: each rank its stage's), over which the squares (sums,
    maxima) are reduced too."""
    op = dist.ReduceOp.MAX if mode == GradientClippingMode.MAX_NORM else dist.ReduceOp.SUM
    totals = []
    for groups, local in _buckets(grads):
        if mode == GradientClippingMode.P2_NORM:
            total = torch.stack([torch.linalg.vector_norm(g, dtype=torch.float32) ** 2 for g in local]).sum()
        elif mode == GradientClippingMode.P1_NORM:
            total = torch.stack([torch.linalg.vector_norm(g, 1, dtype=torch.float32) for g in local]).sum()
        else:  # an empty shard has no inf norm: it adds nothing to the maximum of |g| >= 0
            norms = [torch.linalg.vector_norm(g, float("inf"), dtype=torch.float32) for g in local if g.numel()]
            total = torch.stack(norms).max() if norms else torch.zeros((), device=local[0].device)
        for group in groups:
            dist.all_reduce(total, op=op, group=group)
        totals.append(total)
    total = torch.stack(totals).max() if mode == GradientClippingMode.MAX_NORM else torch.stack(totals).sum()
    if across is not None:
        dist.all_reduce(total, op=op, group=across)
    return total.sqrt() if mode == GradientClippingMode.P2_NORM else total


def clip_(grads: list[torch.Tensor], norm: torch.Tensor, max_norm: float, mode: GradientClippingMode) -> None:
    """Clip in place (a DTensor's local shard), without a host sync (the
    decision stays on the device)."""
    grads = [_local(g) for g in grads]
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

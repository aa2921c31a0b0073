"""Norm layers and their configs: the port of
modalities_tpu/models/components/layer_norms.py.

`NormSpec` resolves a `{norm_type, config}` wrapper node exactly as the JAX
package does. `RMSNorm` runs through ops/rmsnorm.py:fused_rms_norm, the fused
forward and backward kernels on the card (`FusedRMSNormFn`) and autograd
through the plain version on the CPU. `LayerNorm` follows flax's
`nn.LayerNorm` (fp32 statistics, fast variance E[x^2] - E[x]^2).

Output dtype: the JAX package's two RMSNorm tiers disagree when bf16 x meets
fp32 params with no `dtype` given (the lm_head norm). Its reference tier,
`nn.RMSNorm(dtype=None)`, promotes to fp32; its kernel tier returns x's dtype.
The port follows the kernel tier: `RMSNorm` returns x's dtype, cast to `dtype`
when one is given. f32 parity tests cannot see the difference; the head then
casts to fp32 either way.
"""

from __future__ import annotations

import dataclasses
from enum import Enum
from typing import Optional

import torch
from torch import nn

from modalities_tpu_torch.config.config import (
    check_bool,
    check_choice,
    check_dict,
    check_float,
    check_int,
    validate_config,
)
from modalities_tpu_torch.ops.rmsnorm import fused_rms_norm
from modalities_tpu_torch.parallel.tensor_parallel import local


class LayerNorms(Enum):
    rms_norm = "rms_norm"
    layer_norm = "layer_norm"
    pytorch_rms_norm = "pytorch_rms_norm"  # config-compat alias of rms_norm


@dataclasses.dataclass
class LayerNormConfig:
    normalized_shape: int
    eps: float = 1e-5
    elementwise_affine: bool = True
    bias: bool = True

    def __post_init__(self):
        check_int("normalized_shape", self.normalized_shape, ge=1)
        self.eps = check_float("eps", self.eps, gt=0)
        check_bool("elementwise_affine", self.elementwise_affine)
        check_bool("bias", self.bias)


@dataclasses.dataclass
class RMSLayerNormConfig:
    ndim: int
    epsilon: float = 1e-6
    bias: bool = True

    def __post_init__(self):
        check_int("ndim", self.ndim, ge=1)
        self.epsilon = check_float("epsilon", self.epsilon, gt=0)
        check_bool("bias", self.bias)


@dataclasses.dataclass
class PytorchRMSLayerNormConfig:
    normalized_shape: int
    eps: float = 1e-6

    def __post_init__(self):
        check_int("normalized_shape", self.normalized_shape, ge=1)
        self.eps = check_float("eps", self.eps, gt=0)


@dataclasses.dataclass
class LayerNormWrapperConfig:
    norm_type: str
    config: dict

    def __post_init__(self):
        self.norm_type = check_choice("norm_type", self.norm_type, LayerNorms)
        check_dict("config", self.config)


@dataclasses.dataclass(frozen=True)
class NormSpec:
    """Resolved norm description (frozen, so it can live in the model spec)."""

    kind: str  # a LayerNorms value
    dim: int
    eps: float
    use_bias: bool
    use_scale: bool = True

    @staticmethod
    def from_wrapper_config(wrapper, default_dim: int) -> "NormSpec":
        if wrapper is None:
            return NormSpec(kind=LayerNorms.rms_norm.value, dim=default_dim, eps=1e-6, use_bias=False)
        if isinstance(wrapper, dict):
            wrapper = validate_config(LayerNormWrapperConfig, wrapper)
        cfg = wrapper.config
        if wrapper.norm_type == LayerNorms.layer_norm.value:
            parsed = validate_config(LayerNormConfig, cfg)
            return NormSpec(
                kind=wrapper.norm_type,
                dim=parsed.normalized_shape,
                eps=parsed.eps,
                use_bias=parsed.bias and parsed.elementwise_affine,
                use_scale=parsed.elementwise_affine,
            )
        if wrapper.norm_type == LayerNorms.rms_norm.value:
            parsed = validate_config(RMSLayerNormConfig, cfg)
            return NormSpec(kind=wrapper.norm_type, dim=parsed.ndim, eps=parsed.epsilon, use_bias=parsed.bias)
        parsed = validate_config(PytorchRMSLayerNormConfig, cfg)
        return NormSpec(kind=wrapper.norm_type, dim=parsed.normalized_shape, eps=parsed.eps, use_bias=False)


class _Norm(nn.Module):
    """Shared parameter layout: fp32 `scale` (ones) and `bias` (zeros) over the
    last axis, the JAX modules' parameter names. Under tensor parallelism they
    are replicated DTensors, read as their local tensors."""

    def __init__(self, dim: int, eps: float, use_scale: bool, use_bias: bool, dtype=None, device=None):
        super().__init__()
        self.eps = float(eps)
        self.dtype = dtype
        self.scale = nn.Parameter(torch.ones(dim, device=device)) if use_scale else None
        self.bias = nn.Parameter(torch.zeros(dim, device=device)) if use_bias else None


class RMSNorm(_Norm):
    def forward(self, x):
        y = fused_rms_norm(x, local(self.scale), local(self.bias), eps=self.eps)
        return y.to(self.dtype) if self.dtype is not None else y


class LayerNorm(_Norm):
    """flax `nn.LayerNorm` semantics: statistics in fp32 with the fast variance
    mean(x^2) - mean(x)^2 (clipped at 0); output in `dtype`, else fp32 (flax
    promotes x with the fp32 params)."""

    def forward(self, x):
        x32 = x.float()
        mean = x32.mean(dim=-1, keepdim=True)
        var = torch.clamp((x32 * x32).mean(dim=-1, keepdim=True) - mean * mean, min=0.0)
        y = (x32 - mean) * torch.rsqrt(var + self.eps)
        if self.scale is not None:
            y = y * local(self.scale)
        if self.bias is not None:
            y = y + local(self.bias)
        return y.to(self.dtype if self.dtype is not None else torch.float32)


class InputDtypeLayerNorm(LayerNorm):
    """flax `nn.LayerNorm(dtype=x.dtype)` (the ViT's and CoCa's norms): the
    same fp32 statistics, the output in x's dtype."""

    def forward(self, x):
        return super().forward(x).to(x.dtype)


def build_norm(spec: NormSpec, dtype: Optional[torch.dtype] = None, device=None) -> nn.Module:
    """The norm module for a NormSpec; `dtype` is the output dtype (None: see
    the module docstring)."""
    if spec.kind == LayerNorms.layer_norm.value:
        return LayerNorm(spec.dim, spec.eps, spec.use_scale, spec.use_bias, dtype=dtype, device=device)
    return RMSNorm(spec.dim, spec.eps, spec.use_scale, spec.use_bias, dtype=dtype, device=device)

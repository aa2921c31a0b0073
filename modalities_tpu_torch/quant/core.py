"""Core quantization primitives: the port of modalities_tpu/quant/core.py.

Conventions (shared with the JAX package, so the two quantize to the same
codes):

- int8 is symmetric absmax: `scale = absmax / 127`, `q = round(x / scale)`
  clipped to [-127, 127]. `torch.round`, like `jnp.round`, rounds half to
  even; the round-trip error is at most scale / 2 per element.
- scales are float32 and keep the reduced axis as size 1 (`keepdim=True`), so
  dequantizing is a plain broadcast multiply, `q.float() * scale`.
- fp8 is `torch.float8_e4m3fn` with an absmax prescale (`scale = absmax /
  448`): the largest value lands on the largest finite e4m3 value. The cast
  rounds to nearest even, as ml_dtypes' does on the JAX side.
"""

from __future__ import annotations

import torch

INT8_QMAX = 127.0
FP8_E4M3_MAX = 448.0  # largest finite e4m3fn value


def safe_scale(absmax, qmax: float):
    """absmax / qmax, clamped to the smallest positive normal float32 so a
    zero row divides by something (q rounds to 0 there anyway)."""
    return torch.clamp(absmax / qmax, min=torch.finfo(torch.float32).tiny).float()


def quantize_per_channel(x, dim: int = -1):
    """Symmetric int8 quantization with one scale per slice along `dim`.
    Returns (q int8, scale float32 keeping `dim` as size 1)."""
    x32 = x.float()
    absmax = x32.abs().amax(dim=dim, keepdim=True)
    scale = safe_scale(absmax, INT8_QMAX)
    q = torch.clamp(torch.round(x32 / scale), -INT8_QMAX, INT8_QMAX).to(torch.int8)
    return q, scale


def quantize_fp8(x):
    """Absmax-prescaled fp8 e4m3 quantization over the last dim. Returns
    (q float8_e4m3fn, scale float32 [..., 1])."""
    x32 = x.float()
    absmax = x32.abs().amax(dim=-1, keepdim=True)
    scale = safe_scale(absmax, FP8_E4M3_MAX)
    q = torch.clamp(x32 / scale, -FP8_E4M3_MAX, FP8_E4M3_MAX).to(torch.float8_e4m3fn)
    return q, scale


def tree_bytes(tensors) -> int:
    """Total bytes of a mapping or sequence of tensors."""
    values = tensors.values() if isinstance(tensors, dict) else tensors
    return int(sum(t.numel() * t.element_size() for t in values))

"""Fused RMSNorm forward: the port of `modalities_tpu/ops/rmsnorm.py` and of
the Pallas kernel `ops/pallas/fused_rmsnorm.py:_fwd_kernel`.

`rms_norm` dispatches on the tensor's device and nothing else: a CPU tensor
takes `reference_rms_norm` (the plain PyTorch version, same math), a CUDA
tensor launches the hand-written kernel in `csrc/fused_rmsnorm.cu` or raises.
There is no fallback from the kernel to the plain version on the card, and no
switch that selects one.
"""

from __future__ import annotations

import torch

from modalities_tpu_torch.ops import _build

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def reference_rms_norm(x, scale=None, bias=None, *, eps: float = 1e-6):
    """`y = x * rsqrt(mean(x^2) + eps) * scale + bias` in fp32, returned in x's
    dtype — the same expression as the JAX package's reference_rms_norm."""
    x32 = x.float()
    y = x32 * torch.rsqrt((x32 * x32).mean(dim=-1, keepdim=True) + eps)
    if scale is not None:
        y = y * scale
    if bias is not None:
        y = y + bias
    return y.to(x.dtype)


def rms_norm(x, scale=None, bias=None, *, eps: float = 1e-6, residual: bool = False):
    """RMSNorm over the last axis of `x` [..., E]; scale/bias are optional fp32
    [E] (None = identity). Returns y with x's shape and dtype, and with
    `residual=True` also the fp32 row statistic r = rsqrt(mean(x^2) + eps)
    shaped [..., 1] (what the backward reads)."""
    if x.device.type == "cpu":
        if residual:
            x32 = x.float()
            r = torch.rsqrt((x32 * x32).mean(dim=-1, keepdim=True) + eps)
            return reference_rms_norm(x, scale, bias, eps=eps), r
        return reference_rms_norm(x, scale, bias, eps=eps)
    if x.device.type != "cuda":
        raise RuntimeError(f"rms_norm: no kernel for device {x.device}")
    y, r = _launch(x, scale, bias, float(eps))
    return (y, r) if residual else y


def _launch(x, scale, bias, eps):
    _build.require_hopper(x)
    if x.dtype not in _DTYPE_CODES:
        raise TypeError(f"rms_norm kernel: x must be float32 or bfloat16, got {x.dtype}")
    e = x.shape[-1]
    for name, p in (("scale", scale), ("bias", bias)):
        if p is not None and (p.dtype != torch.float32 or p.shape != (e,) or p.device != x.device):
            raise TypeError(f"rms_norm kernel: {name} must be float32 [{e}] on {x.device}")
    x2 = x.reshape(-1, e)
    if not x2.is_contiguous():
        raise ValueError("rms_norm kernel: x must be contiguous")
    if (e * x.element_size()) % 16 or x2.data_ptr() % 16:
        raise ValueError(f"rms_norm kernel: needs rows of a multiple of 16 bytes and a 16-byte aligned x, "
                         f"got E={e} of {x.dtype}")
    scale = scale.contiguous() if scale is not None else None
    bias = bias.contiguous() if bias is not None else None
    n = x2.shape[0]
    y = torch.empty_like(x2)
    r = torch.empty((n, 1), dtype=torch.float32, device=x.device)
    lib = _build.library()
    with torch.cuda.device(x.device):
        status = lib.mt_rms_norm_fwd(
            x2.data_ptr(),
            scale.data_ptr() if scale is not None else None,
            bias.data_ptr() if bias is not None else None,
            y.data_ptr(),
            r.data_ptr(),
            n,
            e,
            eps,
            _DTYPE_CODES[x.dtype],
            _build.stream_of(x),
        )
    _build.check(status, "rms_norm kernel")
    rms_norm.launches += 1
    return y.reshape(x.shape), r.reshape(*x.shape[:-1], 1)


rms_norm.launches = 0  # kernel launches since the last reset (the CPU path never counts)

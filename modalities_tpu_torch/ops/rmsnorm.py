"""Fused RMSNorm, forward and backward: the port of
`modalities_tpu/ops/rmsnorm.py` and of the Pallas kernels
`ops/pallas/fused_rmsnorm.py:_fwd_kernel` and `_bwd_kernel`.

`rms_norm` (forward) and `rms_norm_backward` dispatch on the tensor's device
and nothing else: a CPU tensor takes the plain PyTorch version (same math), a
CUDA tensor launches the hand-written kernels in `csrc/fused_rmsnorm.cu` or
raises. There is no fallback from a kernel to the plain version on the card,
and no switch that selects one. `fused_rms_norm` is the differentiable entry:
`FusedRMSNormFn` (both kernels) on the card, autograd through
`reference_rms_norm` on the CPU.
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


def _aligned(t):
    """`t` contiguous and 16-byte aligned (a copy if it is not)."""
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


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
    scale, bias = (_aligned(t) if t is not None else None for t in (scale, bias))  # read as 16-byte vectors
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


# CTAs of the backward kernel: four a SM of an H100 (132 SMs). CTA b takes
# rows b, b + G, b + 2G, ... of the grid's G CTAs and writes its fp32 column
# partials, [G, E], which a second kernel sums over the CTAs in a fixed
# order. G, and with it the bits of dscale and dbias, depends on N alone.
BWD_CTAS = 528


def backward_grid(n: int) -> tuple[int, int]:
    """(rows a CTA, CTAs) of the backward kernel for N rows: at most BWD_CTAS
    CTAs, each taking ceil(N / CTAs) rows or one fewer. A function of N only,
    never of the device."""
    rows = max(1, -(-n // BWD_CTAS))
    return rows, -(-n // rows)


def backward_workspace_floats(n: int, e: int, want_dscale: bool, want_dbias: bool) -> int:
    """Floats of the fp32 scratch the backward kernel takes: the dscale and
    dbias column partials, [CTAs, E] each, when either is wanted."""
    return 2 * backward_grid(n)[1] * e if want_dscale or want_dbias else 0


def reference_rms_norm_backward(dy, x, scale, r):
    """The plain version of the backward kernel: (dx in x's dtype, dscale and
    dbias as fp32 [E] column sums), the JAX `_bwd_kernel`'s math."""
    e = x.shape[-1]
    x32, dy32 = x.float().reshape(-1, e), dy.float().reshape(-1, e)
    r = r.reshape(-1, 1)
    x_hat = x32 * r
    g = dy32 * scale.float() if scale is not None else dy32
    dx = r * (g - x_hat * (g * x_hat).mean(dim=-1, keepdim=True))
    return dx.to(x.dtype).reshape(x.shape), (dy32 * x_hat).sum(dim=0), dy32.sum(dim=0)


def rms_norm_backward(dy, x, scale, r, *, want_dscale: bool = True, want_dbias: bool = True):
    """Gradients of `rms_norm` from the forward's fp32 statistic `r` [..., 1]:
    (dx in x's dtype, dscale fp32 [E] or None, dbias fp32 [E] or None).
    `scale` is the fp32 [E] scale the forward used, or None."""
    if x.device.type == "cpu":
        dx, dscale, dbias = reference_rms_norm_backward(dy, x, scale, r)
        return dx, dscale if want_dscale else None, dbias if want_dbias else None
    if x.device.type != "cuda":
        raise RuntimeError(f"rms_norm_backward: no kernel for device {x.device}")
    return _launch_backward(dy, x, scale, r, want_dscale, want_dbias)


def _launch_backward(dy, x, scale, r, want_dscale, want_dbias):
    _build.require_hopper(x)
    if x.dtype not in _DTYPE_CODES or dy.dtype != x.dtype:
        raise TypeError(f"rms_norm backward kernel: x and dy must share float32 or bfloat16, got {x.dtype}/{dy.dtype}")
    e = x.shape[-1]
    vec = 16 // x.element_size()
    if (e * x.element_size()) % 16 or e > 4 * 256 * vec:
        raise ValueError(f"rms_norm backward kernel: needs E a multiple of {vec} and at most {4 * 256 * vec}, got {e}")
    if scale is not None and (scale.dtype != torch.float32 or scale.shape != (e,) or scale.device != x.device):
        raise TypeError(f"rms_norm backward kernel: scale must be float32 [{e}] on {x.device}")
    x2, dy2 = x.reshape(-1, e), dy.reshape(-1, e)
    for name, t in (("x", x2), ("dy", dy2)):
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"rms_norm backward kernel: {name} must be contiguous and 16-byte aligned")
    n = x2.shape[0]
    r1 = r.reshape(-1).float().contiguous()
    if r1.numel() != n:
        raise ValueError(f"rms_norm backward kernel: r has {r1.numel()} rows, x has {n}")
    dx = torch.empty_like(x2)
    dscale = torch.empty(e, dtype=torch.float32, device=x.device) if want_dscale else None
    dbias = torch.empty(e, dtype=torch.float32, device=x.device) if want_dbias else None
    ws_floats = backward_workspace_floats(n, e, want_dscale, want_dbias)
    ws = torch.empty(ws_floats, dtype=torch.float32, device=x.device) if ws_floats else None
    scale = scale.contiguous() if scale is not None else None
    lib = _build.library()
    with torch.cuda.device(x.device):
        status = lib.mt_rms_norm_bwd(
            x2.data_ptr(),
            scale.data_ptr() if scale is not None else None,
            r1.data_ptr(),
            dy2.data_ptr(),
            dx.data_ptr(),
            dscale.data_ptr() if dscale is not None else None,
            dbias.data_ptr() if dbias is not None else None,
            ws.data_ptr() if ws is not None else None,
            n,
            e,
            backward_grid(n)[0],
            _DTYPE_CODES[x.dtype],
            _build.stream_of(x),
        )
    _build.check(status, "rms_norm backward kernel")
    rms_norm_backward.launches += 1
    return dx.reshape(x.shape), dscale, dbias


rms_norm_backward.launches = 0  # kernel launches since the last reset (the CPU path never counts)


class FusedRMSNormFn(torch.autograd.Function):
    """RMSNorm with both kernels: the forward saves x, the fp32 scale and the
    row statistic r; the backward reads them. A bf16 scale (a bf16 parameter)
    is widened to fp32 outside the kernels, and its gradient is returned in
    the parameter's dtype, as the JAX custom_vjp returns it."""

    @staticmethod
    def forward(ctx, x, scale, bias, eps):
        scale32 = scale.float() if scale is not None else None
        bias32 = bias.float() if bias is not None else None
        y, r = rms_norm(x, scale32, bias32, eps=eps, residual=True)
        ctx.save_for_backward(x, scale32, r)
        ctx.param_dtypes = (scale.dtype if scale is not None else None, bias.dtype if bias is not None else None)
        return y

    @staticmethod
    def backward(ctx, dy):
        x, scale32, r = ctx.saved_tensors
        scale_dtype, bias_dtype = ctx.param_dtypes
        dx, dscale, dbias = rms_norm_backward(
            dy.contiguous(), x, scale32, r,
            want_dscale=scale_dtype is not None and ctx.needs_input_grad[1],
            want_dbias=bias_dtype is not None and ctx.needs_input_grad[2],
        )
        return (
            dx,
            dscale.to(scale_dtype) if dscale is not None else None,
            dbias.to(bias_dtype) if dbias is not None else None,
            None,
        )


def fused_rms_norm(x, scale=None, bias=None, *, eps: float = 1e-6):
    """Differentiable RMSNorm over the last axis: `FusedRMSNormFn` on a CUDA
    tensor, autograd through `reference_rms_norm` on a CPU tensor. With no
    graph to record (serving, inference mode) a CUDA tensor takes the forward
    kernel alone, without the Function's bookkeeping."""
    if x.device.type == "cpu":
        return reference_rms_norm(x, scale, bias, eps=eps)
    params = (scale, bias)
    if torch.is_grad_enabled() and any(t is not None and t.requires_grad for t in (x, *params)):
        return FusedRMSNormFn.apply(x, scale, bias, float(eps))
    return rms_norm(x, *(t.float() if t is not None else None for t in params), eps=eps)

"""Flash attention, forward and backward: the port of the `dao_flash` tier
(`modalities_tpu/ops/attention.py`) and of the Pallas kernels in
`modalities_tpu/ops/pallas/flash_attention.py` (`_fwd_kernel`,
`_bwd_dq_kernel`, `_bwd_dkv_kernel`).

The kernel-level functions keep the JAX contract, in the kernels' [B, H, S, D]
layout, so a ring-attention port can reuse them:

- `flash_fwd_out_lse(q, k, v, *, causal, sm_scale) -> (out, lse)`, lse fp32
  [B, Hq, Sq, 1];
- `flash_bwd_dq(q, k, v, do, lse, delta, *, causal, sm_scale) -> dq`;
- `flash_bwd_dkv(q, k, v, do, lse, delta, *, causal, sm_scale) -> (dk, dv)`,
  already summed over each kv head's group of q heads.

lse and delta are the GLOBAL softmax statistics ([B, Hq, Sq, 1] or
[B, Hq, Sq], fp32); delta = sum_D dO * out stays a plain torch reduction, as
it is outside the kernels in JAX. `flash_attention(q, k, v)` is the model's
entry in the [B, S, H, D] layout, differentiable through `FlashAttentionFn`.

Each function dispatches on the tensors' device and nothing else: CPU tensors
take the plain PyTorch version (the same math in fp32), CUDA tensors launch
the hand-written kernels in `csrc/flash_attention.cu` or raise. On the CPU,
`flash_attention` is `reference_attention`, the port of the JAX
`manual_attention` oracle, differentiated by autograd.
"""

from __future__ import annotations

import ctypes
import math

import torch

from modalities_tpu_torch.ops import _build, static_walk

NEG_INF = -1e30
HEAD_DIMS = (16, 32, 64, 80, 96, 128)
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_LL3 = ctypes.c_longlong * 3


class _FlashParams(ctypes.Structure):
    """Mirror of `struct FlashParams` in csrc/flash_attention.cu."""

    _fields_ = [
        ("q", ctypes.c_void_p),
        ("k", ctypes.c_void_p),
        ("v", ctypes.c_void_p),
        ("dout", ctypes.c_void_p),
        ("lse_in", ctypes.c_void_p),
        ("delta", ctypes.c_void_p),
        ("out", ctypes.c_void_p),
        ("lse_out", ctypes.c_void_p),
        ("dq", ctypes.c_void_p),
        ("dk", ctypes.c_void_p),
        ("dv", ctypes.c_void_p),
        ("q_s", _LL3),
        ("k_s", _LL3),
        ("v_s", _LL3),
        ("o_s", _LL3),
        ("dq_s", _LL3),
        ("dk_s", _LL3),
        ("dv_s", _LL3),
        ("b", ctypes.c_int),
        ("hq", ctypes.c_int),
        ("hkv", ctypes.c_int),
        ("sq", ctypes.c_int),
        ("sk", ctypes.c_int),
        ("sm_scale", ctypes.c_float),
        ("causal", ctypes.c_int),
    ]


def _scale(q, sm_scale):
    return 1.0 / math.sqrt(q.shape[-1]) if sm_scale is None else float(sm_scale)


# ------------------------------------------------------------ plain versions


def reference_attention(q, k, v, causal: bool = True, sm_scale=None):
    """The JAX `manual_attention` oracle (gpt2_model.py:344-380) in the model
    layout: q [B, Sq, Hq, D], k/v [B, Sk, Hkv, D] -> [B, Sq, Hq, D]. q.k in the
    inputs' dtype, then fp32 scaled, masked with the fp32 minimum (queries and
    keys aligned at position 0), fp32 softmax, probabilities cast to v's dtype
    before P.V. q head h reads kv head h // (Hq // Hkv)."""
    b, sq, hq, d = q.shape
    sk, hkv = k.shape[1], k.shape[2]
    qg = q.reshape(b, sq, hkv, hq // hkv, d)
    logits = torch.einsum("bshgd,bthd->bhgst", qg, k).float()
    logits = logits / math.sqrt(d) if sm_scale is None else logits * float(sm_scale)
    if causal:
        mask = torch.arange(sk, device=q.device)[None, :] <= torch.arange(sq, device=q.device)[:, None]
        logits = logits.masked_fill(~mask, torch.finfo(torch.float32).min)
    probs = torch.softmax(logits, dim=-1).to(v.dtype)
    return torch.einsum("bhgst,bthd->bshgd", probs, v).reshape(b, sq, hq, d)


def _plain_scores(q, k, causal, sm_scale):
    """fp32 scores [B, Hq, Sq, Sk] of the kernels: (q * sm_scale) . k, -1e30
    where the key lies after the query (causal)."""
    group = q.shape[1] // k.shape[1]
    kx = k.float().repeat_interleave(group, dim=1)
    s = torch.matmul(q.float() * sm_scale, kx.transpose(-1, -2))
    if causal:
        sq, sk = q.shape[2], k.shape[2]
        keep = torch.arange(sk, device=q.device)[None, :] <= torch.arange(sq, device=q.device)[:, None]
        s = s.masked_fill(~keep, NEG_INF)
    return s


def reference_flash_fwd_out_lse(q, k, v, *, causal: bool = True, sm_scale=None):
    """The plain version of the forward kernel, [B, H, S, D] layout."""
    sm_scale = _scale(q, sm_scale)
    s = _plain_scores(q, k, causal, sm_scale)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    l_safe = p.sum(dim=-1, keepdim=True).clamp_min(1e-30)
    vx = v.float().repeat_interleave(q.shape[1] // k.shape[1], dim=1)
    out = torch.matmul(p, vx) / l_safe
    return out.to(q.dtype), m + torch.log(l_safe)


def _plain_grads(q, k, v, do, lse, delta, causal, sm_scale):
    s = _plain_scores(q, k, causal, sm_scale)
    p = torch.exp(s - lse.reshape(*q.shape[:3], 1).float())
    vx = v.float().repeat_interleave(q.shape[1] // k.shape[1], dim=1)
    dp = torch.matmul(do.float(), vx.transpose(-1, -2))
    ds = p * (dp - delta.reshape(*q.shape[:3], 1).float()) * sm_scale
    return p, ds


def reference_flash_bwd_dq(q, k, v, do, lse, delta, *, causal: bool = True, sm_scale=None):
    """The plain version of the dq kernel."""
    sm_scale = _scale(q, sm_scale)
    _, ds = _plain_grads(q, k, v, do, lse, delta, causal, sm_scale)
    kx = k.float().repeat_interleave(q.shape[1] // k.shape[1], dim=1)
    return torch.matmul(ds, kx).to(q.dtype)


def reference_flash_bwd_dkv(q, k, v, do, lse, delta, *, causal: bool = True, sm_scale=None):
    """The plain version of the dk/dv kernel: per q head, then summed over
    each kv head's group in fp32."""
    sm_scale = _scale(q, sm_scale)
    p, ds = _plain_grads(q, k, v, do, lse, delta, causal, sm_scale)
    b, hkv, sk, d = k.shape
    group = q.shape[1] // hkv
    dv = torch.matmul(p.transpose(-1, -2), do.float()).reshape(b, hkv, group, sk, d).sum(dim=2)
    dk = torch.matmul(ds.transpose(-1, -2), q.float()).reshape(b, hkv, group, sk, d).sum(dim=2)
    return dk.to(k.dtype), dv.to(v.dtype)


# ------------------------------------------------------------------- kernels


def _check_shapes(q, k, v):
    if q.dim() != 4 or k.shape != v.shape or k.dim() != 4:
        raise ValueError(f"flash attention: q [B, Hq, Sq, D] and k/v [B, Hkv, Sk, D], got {q.shape}, {k.shape}")
    b, hq, sq, d = q.shape
    if k.shape[0] != b or k.shape[3] != d or hq % k.shape[1]:
        raise ValueError(f"flash attention: shapes do not pair: q {tuple(q.shape)}, k {tuple(k.shape)}")
    if d not in HEAD_DIMS:
        raise ValueError(f"flash attention kernels: head dim {d} not in {HEAD_DIMS}")
    if q.dtype not in _DTYPE_CODES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"flash attention kernels: q/k/v must share float32 or bfloat16, got {q.dtype}/{k.dtype}/{v.dtype}")
    for t in (k, v):
        if t.device != q.device:
            raise ValueError("flash attention kernels: q, k and v must lie on one device")


def _check(q, k, v):
    _check_shapes(q, k, v)
    _build.require_hopper(q)


def _rows(t):
    """`t` [B, H, S, D] itself when every row is a 16-byte aligned run of D
    elements (unit stride along D), else a contiguous copy."""
    per = 16 // t.element_size()
    aligned = t.stride(3) == 1 and all(st % per == 0 for st in t.stride()[:3]) and t.data_ptr() % 16 == 0
    return t if aligned else t.contiguous()


def _strides(t):
    return _LL3(t.stride(0), t.stride(1), t.stride(2))


def _params(q, k, v, causal, sm_scale) -> _FlashParams:
    p = _FlashParams()
    p.q, p.k, p.v = q.data_ptr(), k.data_ptr(), v.data_ptr()
    p.q_s, p.k_s, p.v_s = _strides(q), _strides(k), _strides(v)
    p.b, p.hq, p.sq, _ = q.shape
    p.hkv, p.sk = k.shape[1], k.shape[2]
    p.sm_scale = sm_scale
    p.causal = int(bool(causal))
    return p


def _run(fn_name: str, p: _FlashParams, q) -> None:
    lib = _build.library()
    with torch.cuda.device(q.device):
        status = getattr(lib, fn_name)(ctypes.addressof(p), q.shape[3], _DTYPE_CODES[q.dtype], _build.stream_of(q))
    _build.check(status, fn_name)


def _stats(t, q):
    """lse/delta as contiguous fp32 [B, H, Sq]."""
    return t.reshape(q.shape[:3]).float().contiguous()


def _fwd_kernel(q, k, v, out, causal, sm_scale):
    """Launches the forward into `out` (any [B, Hq, Sq, D] view with aligned
    rows); returns lse fp32 [B, Hq, Sq]."""
    lse = torch.empty(q.shape[:3], dtype=torch.float32, device=q.device)
    p = _params(q, k, v, causal, sm_scale)
    p.out, p.o_s, p.lse_out = out.data_ptr(), _strides(out), lse.data_ptr()
    _run("mt_flash_fwd", p, q)
    flash_fwd_out_lse.launches += 1
    return lse


def _dq_kernel(q, k, v, do, lse, delta, dq, causal, sm_scale):
    p = _params(q, k, v, causal, sm_scale)
    p.dout, p.o_s = do.data_ptr(), _strides(do)
    p.lse_in, p.delta = lse.data_ptr(), delta.data_ptr()
    p.dq, p.dq_s = dq.data_ptr(), _strides(dq)
    _run("mt_flash_bwd_dq", p, q)
    flash_bwd_dq.launches += 1


def _dkv_kernel(q, k, v, do, lse, delta, dk, dv, causal, sm_scale):
    p = _params(q, k, v, causal, sm_scale)
    p.dout, p.o_s = do.data_ptr(), _strides(do)
    p.lse_in, p.delta = lse.data_ptr(), delta.data_ptr()
    p.dk, p.dk_s, p.dv, p.dv_s = dk.data_ptr(), _strides(dk), dv.data_ptr(), _strides(dv)
    _run("mt_flash_bwd_dkv", p, q)
    flash_bwd_dkv.launches += 1


def _on_card(fn_name, *tensors) -> bool:
    dev = tensors[0].device.type
    if dev == "cpu":
        return False
    if dev != "cuda":
        raise RuntimeError(f"{fn_name}: no kernel for device {tensors[0].device}")
    return True


def _walked(q, k, v) -> bool:
    """Whether a CPU call belongs to the static walk (ops/static_walk.py),
    which takes the kernels' stand-ins after the kernels' shape checks."""
    if static_walk.recorder() is None:
        return False
    _check_shapes(q, k, v)
    return True


# ------------------------------------------------------------ public entries


def flash_fwd_out_lse(q, k, v, *, causal: bool = True, sm_scale=None):
    """q [B, Hq, Sq, D], k/v [B, Hkv, Sk, D] -> (out [B, Hq, Sq, D] in q's
    dtype, lse [B, Hq, Sq, 1] fp32). No autograd: the caller owns
    differentiation (ring attention merges per-hop (out, lse) pairs)."""
    if not _on_card("flash_fwd_out_lse", q):
        if _walked(q, k, v):
            static_walk.flash("flash_fwd", q, k, causal)
            return torch.empty_like(q, memory_format=torch.contiguous_format), torch.empty(*q.shape[:3], 1)
        return reference_flash_fwd_out_lse(q, k, v, causal=causal, sm_scale=sm_scale)
    _check(q, k, v)
    q, k, v = _rows(q), _rows(k), _rows(v)
    out = torch.empty_like(q, memory_format=torch.contiguous_format)
    lse = _fwd_kernel(q, k, v, out, causal, _scale(q, sm_scale))
    return out, lse[..., None]


def flash_bwd_dq(q, k, v, do, lse, delta, *, causal: bool = True, sm_scale=None):
    """dq [B, Hq, Sq, D] for one (q, k, v) pairing given the GLOBAL lse and
    delta ([B, Hq, Sq, 1] or [B, Hq, Sq], fp32)."""
    if not _on_card("flash_bwd_dq", q):
        if _walked(q, k, v):
            static_walk.flash("flash_dq", q, k, causal)
            return torch.empty_like(q, memory_format=torch.contiguous_format)
        return reference_flash_bwd_dq(q, k, v, do, lse, delta, causal=causal, sm_scale=sm_scale)
    _check(q, k, v)
    q, k, v, do = _rows(q), _rows(k), _rows(v), _rows(do.to(q.dtype))
    dq = torch.empty_like(q, memory_format=torch.contiguous_format)
    _dq_kernel(q, k, v, do, _stats(lse, q), _stats(delta, q), dq, causal, _scale(q, sm_scale))
    return dq


def flash_bwd_dkv(q, k, v, do, lse, delta, *, causal: bool = True, sm_scale=None):
    """(dk, dv) [B, Hkv, Sk, D] for one (q, k, v) pairing given the GLOBAL lse
    and delta, summed over each kv head's group of q heads (inside the kernel,
    in fp32) and returned in k's dtype."""
    if not _on_card("flash_bwd_dkv", q):
        if _walked(q, k, v):
            static_walk.flash("flash_dkv", q, k, causal)
            return (torch.empty_like(k, memory_format=torch.contiguous_format),
                    torch.empty_like(v, memory_format=torch.contiguous_format))
        return reference_flash_bwd_dkv(q, k, v, do, lse, delta, causal=causal, sm_scale=sm_scale)
    _check(q, k, v)
    q, k, v, do = _rows(q), _rows(k), _rows(v), _rows(do.to(q.dtype))
    dk = torch.empty_like(k, memory_format=torch.contiguous_format)
    dv = torch.empty_like(v, memory_format=torch.contiguous_format)
    _dkv_kernel(q, k, v, do, _stats(lse, q), _stats(delta, q), dk, dv, causal, _scale(q, sm_scale))
    return dk, dv


flash_fwd_out_lse.launches = 0  # kernel launches since the last reset (the CPU path never counts)
flash_bwd_dq.launches = 0
flash_bwd_dkv.launches = 0


def backward_operands(dout, out):
    """What the backward kernels read besides the forward's tensors, made by
    torch: dO in out's dtype, contiguous, and delta = rowsum(dO * out), fp32
    [B, Hq, Sq] (both [B, S, H, D] in)."""
    dout = dout.to(out.dtype).contiguous()
    return dout, (dout.float() * out.float()).sum(dim=-1).transpose(1, 2).contiguous()


class FlashAttentionFn(torch.autograd.Function):
    """Attention in the model layout [B, S, H, D] through the three kernels.
    The kernels read and write that layout through strides (no transposes);
    the forward saves q, k, v, out and lse, the backward computes delta with
    one torch reduction and launches dq and dk/dv."""

    @staticmethod
    def forward(ctx, q, k, v, causal, sm_scale):
        qt, kt, vt = (_rows(t.transpose(1, 2)) for t in (q, k, v))
        out = torch.empty(q.shape, dtype=q.dtype, device=q.device)
        lse = _fwd_kernel(qt, kt, vt, out.transpose(1, 2), causal, sm_scale)
        ctx.save_for_backward(qt, kt, vt, out, lse)
        ctx.causal, ctx.sm_scale = causal, sm_scale
        return out

    @staticmethod
    def backward(ctx, dout):
        qt, kt, vt, out, lse = ctx.saved_tensors
        dout, delta = backward_operands(dout, out)
        dq = torch.empty(out.shape, dtype=out.dtype, device=out.device)
        dk = torch.empty(kt.shape[0], kt.shape[2], kt.shape[1], kt.shape[3], dtype=kt.dtype, device=kt.device)
        dv = torch.empty_like(dk)
        do_t = dout.transpose(1, 2)
        _dq_kernel(qt, kt, vt, do_t, lse, delta, dq.transpose(1, 2), ctx.causal, ctx.sm_scale)
        _dkv_kernel(qt, kt, vt, do_t, lse, delta, dk.transpose(1, 2), dv.transpose(1, 2), ctx.causal, ctx.sm_scale)
        return dq, dk, dv, None, None


def flash_attention(q, k, v, causal: bool = True, sm_scale=None):
    """The `dao_flash` attention: q [B, Sq, Hq, D], k/v [B, Sk, Hkv, D] ->
    [B, Sq, Hq, D]. CUDA tensors go through `FlashAttentionFn` (the kernels);
    CPU tensors through `reference_attention`."""
    if not _on_card("flash_attention", q):
        if _walked(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)):
            return static_walk.FlashAttention.apply(q, k, v, bool(causal))
        return reference_attention(q, k, v, causal=causal, sm_scale=sm_scale)
    _check(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2))
    return FlashAttentionFn.apply(q, k, v, bool(causal), _scale(q, sm_scale))

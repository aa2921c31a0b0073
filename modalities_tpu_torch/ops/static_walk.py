"""The kernels as the static walk sees them (telemetry/perfscope.py).

The walk runs a config's card path on fake tensors (no storage, no device)
and must record each hand-written kernel as one op with its work, where a
card would launch it. A CPU-only torch build cannot run fake CUDA tensors
through every op (an in-place copy onto one asks for the CUDA runtime), so
the walk fakes CPU tensors inside `walking(recorder)`. There is one
mechanism: each wrapper's CPU branch asks `recorder()` whether a walk is in
progress on this thread, and if one is, calls the stand-in here for its
kernel instead of the plain version. A stand-in records the kernel and
returns empty outputs of the kernel's shapes and dtypes. Nothing is built or
launched, and no launch is counted. Other threads' CPU calls during a walk
take the plain version as always.

On the card nothing of this runs: each wrapper tests `device.type ==
"cpu"` first, so a CUDA tensor never reaches `recorder()`.

`kernel_work` gives each kernel's (operations, bytes) from its inputs'
shapes, the formulas of the kernel table's bounds in PERF.md (chip_smoke.py
phase 1): each input read once and each output written once; flash counts 2
operations a multiply-add over the causal (or all) query-key pairs.
"""

from __future__ import annotations

import contextlib
import threading
from typing import Iterator

import torch

KERNELS = ("flash_fwd", "flash_dq", "flash_dkv", "rms_fwd", "rms_bwd", "ce_fwd", "ce_dh", "ce_dw", "quant_matmul")

_walk = threading.local()


def recorder():
    """The walk in progress on this thread (telemetry/perfscope.py:StaticWalk), or None."""
    return getattr(_walk, "recorder", None)


@contextlib.contextmanager
def walking(walk) -> Iterator[None]:
    """Route this thread's wrappers to the stand-ins, which record into
    `walk` (its `custom_call(name, flops, bytes, what, tensor_cores)`),
    for the block."""
    if recorder() is not None:
        raise RuntimeError("a static walk is already in progress")
    _walk.recorder = walk
    try:
        yield
    finally:
        _walk.recorder = None


def _pairs(sq: int, sk: int, causal: bool) -> int:
    """Query-key pairs a flash call computes: all, or under the kernels'
    causal mask, queries and keys aligned at position 0 (query i sees keys
    0..i, at most sk of them)."""
    if not causal:
        return sq * sk
    diagonal = min(sq, sk)  # queries 0..diagonal-1 see i + 1 keys; the rest see all sk
    return diagonal * (diagonal + 1) // 2 + (sq - diagonal) * sk


def kernel_work(name: str, **s) -> tuple[int, int]:
    """(operations, bytes) of one call of kernel `name`; `s` holds the call's
    sizes and element sizes (see the stand-ins below)."""
    if name in ("flash_fwd", "flash_dq", "flash_dkv"):
        b, hq, hkv, sq, sk, d, el = s["b"], s["hq"], s["hkv"], s["sq"], s["sk"], s["d"], s["el"]
        mm = 2 * b * hq * _pairs(sq, sk, s["causal"]) * d  # one of the kernel's matmuls
        q, kv, st = b * hq * sq * d * el, b * hkv * sk * d * el, b * hq * sq * 4
        return {"flash_fwd": (2 * mm, 2 * q + 2 * kv + st), "flash_dq": (3 * mm, 3 * q + 2 * kv + 2 * st),
                "flash_dkv": (4 * mm, 2 * q + 4 * kv + 2 * st)}[name]
    if name in ("rms_fwd", "rms_bwd"):
        n, e, el, params = s["n"], s["e"], s["el"], s["params"]  # params: fp32 [E] vectors read or written
        if name == "rms_fwd":  # x in, y out, r out
            return 4 * n * e, 2 * n * e * el + 4 * n + 4 * e * params
        return 8 * n * e, 3 * n * e * el + 4 * n + 4 * e * params  # x, dy in, dx out, r in
    if name in ("ce_fwd", "ce_dh", "ce_dw"):
        n, v, e, hel, wel = s["n"], s["v"], s["e"], s["hel"], s["wel"]
        ops, read = 2 * n * v * e, n * e * hel + v * e * wel + 4 * n  # one h . W^T; h, W, the labels
        if name == "ce_fwd":
            return ops, read + 2 * 4 * n  # lse, corr out
        return 2 * ops, read + 2 * 4 * n + (n * e * hel if name == "ce_dh" else v * e * wel)  # lse, gm in
    if name == "quant_matmul":
        m, k, n, xel = s["m"], s["k"], s["n"], s["xel"]
        return 2 * m * k * n * (3 if xel == 4 else 1), m * k * xel + k * n + 4 * n + m * n * xel
    raise ValueError(f"unknown kernel {name!r}; the kernels are {KERNELS}")


def _record(name: str, what: str, **sizes) -> None:
    flops, nbytes = kernel_work(name, **sizes)
    # the RMSNorm kernels and the fp32 flash / CE kernels compute on the CUDA cores; the rest on the tensor cores
    cuda_cores = name.startswith("rms") or 4 in (sizes.get("el"), sizes.get("hel"), sizes.get("wel"))
    recorder().custom_call(name, flops, nbytes, what, tensor_cores=not cuda_cores)


# ---------------------------------------------------------------- stand-ins


def rms_norm(x, scale, bias):
    """ops/rmsnorm.py's forward kernel: (y, r)."""
    e = x.shape[-1]
    _record("rms_fwd", f"x{list(x.shape)}", n=x.numel() // e, e=e, el=x.element_size(),
            params=(scale is not None) + (bias is not None))
    return torch.empty_like(x), torch.empty(*x.shape[:-1], 1, dtype=torch.float32)


def rms_norm_backward(x, scale, want_dscale: bool, want_dbias: bool):
    """ops/rmsnorm.py's backward kernels: (dx, dscale or None, dbias or None)."""
    e = x.shape[-1]
    _record("rms_bwd", f"x{list(x.shape)}", n=x.numel() // e, e=e, el=x.element_size(),
            params=(scale is not None) + bool(want_dscale) + bool(want_dbias))
    column = (lambda: torch.empty(e, dtype=torch.float32))
    return torch.empty_like(x), column() if want_dscale else None, column() if want_dbias else None


def flash(name: str, q, k, causal: bool) -> None:
    """Records one call of the flash kernel `name` on q [B, Hq, Sq, D] and
    k [B, Hkv, Sk, D] (ops/flash_attention.py's layout)."""
    _record(name, f"q{list(q.shape)} k{list(k.shape)}", b=q.shape[0], hq=q.shape[1], hkv=k.shape[1], sq=q.shape[2],
            sk=k.shape[2], d=q.shape[3], el=q.element_size(), causal=bool(causal))


class FlashAttention(torch.autograd.Function):
    """ops/flash_attention.py's FlashAttentionFn (q [B, S, H, D]): the
    forward kernel; in the backward the torch ops the card runs before the
    kernels (`backward_operands`), then the dq and dk/dv kernels."""

    @staticmethod
    def forward(ctx, q, k, v, causal):
        qt, kt = q.transpose(1, 2), k.transpose(1, 2)
        flash("flash_fwd", qt, kt, causal)
        out = torch.empty_like(q)
        ctx.save_for_backward(qt, kt, out)
        ctx.causal = causal
        return out

    @staticmethod
    def backward(ctx, dout):
        from modalities_tpu_torch.ops.flash_attention import backward_operands

        qt, kt, out = ctx.saved_tensors
        backward_operands(dout, out)
        flash("flash_dq", qt, kt, ctx.causal)
        flash("flash_dkv", qt, kt, ctx.causal)
        dq, dk = torch.empty_like(qt).transpose(1, 2), torch.empty_like(kt).transpose(1, 2)
        return dq, dk, torch.empty_like(dk), None


def fused_ce(name: str, h, w):
    """ops/fused_ce.py's kernel `name` ("ce_fwd": (lse, corr), "ce_dh": dh,
    "ce_dw": dw) on h [N, E] and w [V, E]."""
    _record(name, f"h{list(h.shape)} w{list(w.shape)}", n=h.shape[0], v=w.shape[0], e=h.shape[1],
            hel=h.element_size(), wel=w.element_size())
    if name == "ce_fwd":
        return torch.empty(h.shape[0], dtype=torch.float32), torch.empty(h.shape[0], dtype=torch.float32)
    return torch.empty_like(h if name == "ce_dh" else w)


def quant_matmul(x, wq):
    """ops/quant_matmul.py's kernel: y [M, N] in x's dtype."""
    (m, k), n = x.shape, wq.shape[1]
    _record("quant_matmul", f"x{list(x.shape)} w{list(wq.shape)}", m=m, k=k, n=n, xel=x.element_size())
    return torch.empty((m, n), dtype=x.dtype)

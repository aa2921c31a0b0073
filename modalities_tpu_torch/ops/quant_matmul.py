"""Fused dequant-matmul for weight-only quantized serving: the port of
`modalities_tpu/ops/quant_matmul.py` and of the Pallas kernel
`ops/pallas/quant_matmul.py:_kernel`.

`y = (x [M, K] @ widen(wq [K, N])) * scale [N]` with fp32 accumulation, cast
to x's dtype. x is float32 or bfloat16; wq is int8 or float8_e4m3fn; scale is
float32. `quant_matmul` dispatches on the tensor's device only: a CPU tensor
takes `reference_quant_matmul`, a CUDA tensor launches `csrc/quant_matmul.cu`
or raises.
"""

from __future__ import annotations

import torch

from modalities_tpu_torch.ops import _build

_X_CODES = {torch.float32: 0, torch.bfloat16: 1}
_W_FP8 = {torch.int8: 0, torch.float8_e4m3fn: 1}
BLOCK_N = 64  # output columns per CTA (csrc/quant_matmul.cu kBN)
BLOCK_K = 64  # K depth per stage (kBK)
# Split-K aims at this many CTAs per call: eight per SM of an H100's 132, enough
# loads in flight at M <= 64 without letting the split reduction dominate.
TARGET_CTAS = 1056


def reference_quant_matmul(x, wq, scale):
    """The plain version: widen, matmul with fp32 accumulation, scale, cast —
    the JAX package's reference_quant_matmul expression. Both widenings are
    exact, so fp32 products of the widened operands are the exact products."""
    acc = torch.matmul(x.float(), wq.float())
    return (acc * scale.float()).to(x.dtype)


def split_k(k: int, n: int) -> int:
    """How many CTAs share one output tile's K loop. A function of the weight
    shape only, never of M: every row is then summed in the same order whatever
    the batch holds."""
    ktiles = k // BLOCK_K
    tiles_n = -(-n // BLOCK_N)
    want = max(1, min(ktiles, -(-TARGET_CTAS // tiles_n)))
    per_split = -(-ktiles // want)
    return -(-ktiles // per_split)


def quant_matmul(x, wq, scale):
    """Fused dequant-matmul over 2-D operands (see module docstring)."""
    if x.ndim != 2 or wq.ndim != 2 or x.shape[1] != wq.shape[0]:
        raise ValueError(f"quant_matmul: x {tuple(x.shape)} vs wq {tuple(wq.shape)} contraction mismatch")
    if scale.shape != (wq.shape[1],):
        raise ValueError(f"quant_matmul: scale shape {tuple(scale.shape)} != ({wq.shape[1]},)")
    if x.device.type == "cpu":
        return reference_quant_matmul(x, wq, scale)
    if x.device.type != "cuda":
        raise RuntimeError(f"quant_matmul: no kernel for device {x.device}")
    return _launch(x, wq, scale)


def _launch(x, wq, scale):
    _build.require_hopper(x)
    m, k = x.shape
    n = wq.shape[1]
    if x.dtype not in _X_CODES:
        raise TypeError(f"quant_matmul kernel: x must be float32 or bfloat16, got {x.dtype}")
    if wq.dtype not in _W_FP8:
        raise TypeError(f"quant_matmul kernel: wq must be int8 or float8_e4m3fn, got {wq.dtype}")
    if scale.dtype != torch.float32:
        raise TypeError(f"quant_matmul kernel: scale must be float32, got {scale.dtype}")
    if wq.device != x.device or scale.device != x.device:
        raise ValueError("quant_matmul kernel: x, wq and scale must lie on one device")
    if k % BLOCK_K or n % 16:
        raise ValueError(f"quant_matmul kernel: needs K % {BLOCK_K} == 0 and N % 16 == 0, got K={k} N={n}")
    if not (x.is_contiguous() and wq.is_contiguous() and scale.is_contiguous()):
        raise ValueError("quant_matmul kernel: x, wq and scale must be contiguous")
    if x.data_ptr() % 16 or wq.data_ptr() % 16:
        raise ValueError("quant_matmul kernel: x and wq must be 16-byte aligned")
    splits = split_k(k, n)
    y = torch.empty((m, n), dtype=x.dtype, device=x.device)
    ws = torch.empty((splits, m, n), dtype=torch.float32, device=x.device) if splits > 1 else None
    lib = _build.library()
    with torch.cuda.device(x.device):
        status = lib.mt_quant_matmul(
            x.data_ptr(),
            wq.data_ptr(),
            scale.data_ptr(),
            y.data_ptr(),
            ws.data_ptr() if ws is not None else None,
            m,
            k,
            n,
            _X_CODES[x.dtype],
            _W_FP8[wq.dtype],
            splits,
            _build.stream_of(x),
        )
    _build.check(status, "quant_matmul kernel")
    quant_matmul.launches += 1
    return y


quant_matmul.launches = 0  # kernel launches since the last reset (the CPU path never counts)


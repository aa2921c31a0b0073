"""Fused dequant-matmul for weight-only quantized serving: the port of
`modalities_tpu/ops/quant_matmul.py` and of the Pallas kernel
`ops/pallas/quant_matmul.py:_kernel`.

`y = (x [M, K] @ widen(wq [K, N])) * scale [N]` with fp32 accumulation, cast
to x's dtype. x is float32 or bfloat16; wq is int8 or float8_e4m3fn; scale is
float32. `quant_matmul` dispatches on the tensor's device only: a CPU tensor
takes `reference_quant_matmul`, a CUDA tensor launches `csrc/quant_matmul.cu`
(one launch a call) or raises.

The weight is checked once, when it is prepared (`PreparedWeight`: dtype,
device, contiguity, 16-byte alignment, K % 64, N % 16, and its TMA
descriptor); a call then checks x only. `QuantLinear` keeps its weight's
`PreparedWeight`; a call without one prepares the weight anew.
"""

from __future__ import annotations

import ctypes

import torch

from modalities_tpu_torch.ops import _build, static_walk

_X_F32 = {torch.float32: 1, torch.bfloat16: 0}
_W_FP8 = {torch.int8: 0, torch.float8_e4m3fn: 1}
BLOCK_N = 128  # output columns of a cluster's tile (csrc/quant_matmul.cu kBN)
BLOCK_K = 64  # K depth of a ring stage (kBK)
MAX_CLUSTER = 8  # CTAs of a cluster sharing one tile's K loop (the portable cluster size)
# The split model: two CTAs resident on each of an H100's 132 SMs, and a CTA's
# set-up and cluster reduction costing about as much as streaming 3 k tiles.
CTA_SLOTS = 2 * 132
CTA_OVERHEAD_TILES = 3


class _QmmArgs(ctypes.Structure):
    """Mirror of `struct QmmArgs` in csrc/quant_matmul.cu."""

    _fields_ = [
        ("wmap", ctypes.c_ubyte * 128),
        ("x", ctypes.c_void_p),
        ("scale", ctypes.c_void_p),
        ("y", ctypes.c_void_p),
        ("m", ctypes.c_int),
        ("k", ctypes.c_int),
        ("n", ctypes.c_int),
        ("splits", ctypes.c_int),
        ("x_f32", ctypes.c_int),
        ("w_fp8", ctypes.c_int),
        ("device", ctypes.c_int),
    ]


def reference_quant_matmul(x, wq, scale):
    """The plain version: widen, matmul with fp32 accumulation, scale, cast —
    the JAX package's reference_quant_matmul expression. Both widenings are
    exact, so fp32 products of the widened operands are the exact products."""
    acc = torch.matmul(x.float(), wq.float())
    return (acc * scale.float()).to(x.dtype)


def split_bf16x3(x):
    """fp32 x -> bf16 (hi, mid, lo) with hi + mid + lo = x to 2^-24 relative:
    each piece is the residual of the ones before, rounded to bf16 (the
    residuals are exact in fp32). The kernel splits fp32 x so, on the card,
    before its three tensor-core products."""
    x = x.float()
    hi = x.to(torch.bfloat16)
    r1 = x - hi.float()
    mid = r1.to(torch.bfloat16)
    lo = (r1 - mid.float()).to(torch.bfloat16)
    return hi, mid, lo


def split_k(k: int, n: int) -> int:
    """How many CTAs of a cluster share one output tile's K loop: a function of
    the weight's shape only, never of M, so that every row is summed in the same
    order whatever the batch holds. The split, at most MAX_CLUSTER and at most
    the number of k tiles, that minimises waves x (k tiles a CTA + overhead)
    with CTA_SLOTS CTAs a wave; ties go to the smaller split."""
    ktiles = k // BLOCK_K
    tiles = -(-n // BLOCK_N)
    best, best_cost = 1, None
    s = 1
    while s <= min(MAX_CLUSTER, ktiles):
        cost = -(-tiles * s // CTA_SLOTS) * (-(-ktiles // s) + CTA_OVERHEAD_TILES)
        if best_cost is None or cost < best_cost:
            best, best_cost = s, cost
        s *= 2
    return best


def rank_k_tiles(k: int, n: int) -> list[tuple[int, int]]:
    """The k tiles [start, stop) each rank of a cluster takes, in rank order
    (csrc/quant_matmul.cu: rank r of s takes [r T / s, (r + 1) T / s))."""
    ktiles, s = k // BLOCK_K, split_k(k, n)
    return [(r * ktiles // s, (r + 1) * ktiles // s) for r in range(s)]


class PreparedWeight:
    """A quantized weight checked once for the kernel, with its TMA tensor
    map and the launch arguments that do not change between calls. Holds
    `wq` and `scale`, so the memory the map points at stays alive."""

    def __init__(self, wq, scale):
        if wq.ndim != 2 or scale.shape != (wq.shape[1],):
            raise ValueError(f"quant_matmul: scale shape {tuple(scale.shape)} != ({wq.shape[1]},) of wq")
        if wq.device.type != "cuda":
            raise RuntimeError(f"quant_matmul kernel: wq must lie on a CUDA device, got {wq.device}")
        _build.require_hopper(wq)
        if wq.dtype not in _W_FP8:
            raise TypeError(f"quant_matmul kernel: wq must be int8 or float8_e4m3fn, got {wq.dtype}")
        if scale.dtype != torch.float32:
            raise TypeError(f"quant_matmul kernel: scale must be float32, got {scale.dtype}")
        if scale.device != wq.device:
            raise ValueError("quant_matmul kernel: wq and scale must lie on one device")
        k, n = wq.shape
        if k % BLOCK_K or n % 16 or k == 0 or n == 0:
            raise ValueError(f"quant_matmul kernel: needs K % {BLOCK_K} == 0 and N % 16 == 0, got K={k} N={n}")
        if not (wq.is_contiguous() and scale.is_contiguous()):
            raise ValueError("quant_matmul kernel: wq and scale must be contiguous")
        if wq.data_ptr() % 16:
            raise ValueError("quant_matmul kernel: wq must be 16-byte aligned")
        self.wq, self.scale = wq, scale
        self.wq_ptr, self.scale_ptr, self.shape = wq.data_ptr(), scale.data_ptr(), wq.shape
        self.device, self.index = wq.device, wq.get_device()
        self.splits = split_k(k, n)
        lib = _build.library()
        args = _QmmArgs()
        _build.check(lib.mt_quant_matmul_prepare(self.wq_ptr, k, n, ctypes.addressof(args.wmap)),
                     "quant_matmul kernel: tensor map")
        args.scale, args.k, args.n, args.splits = self.scale_ptr, k, n, self.splits
        args.w_fp8, args.device = _W_FP8[wq.dtype], wq.device.index
        self._args, self._args_ref, self._launch = args, ctypes.byref(args), lib.mt_quant_matmul

    def holds(self, wq, scale) -> bool:
        """Whether this was prepared for these very tensors, as they still are."""
        return (wq is self.wq and scale is self.scale and wq.data_ptr() == self.wq_ptr
                and scale.data_ptr() == self.scale_ptr and wq.shape == self.shape)

    def __call__(self, x):
        """The kernel on x [M, K] (checked here), one launch; y [M, N]."""
        if x.ndim != 2 or x.shape[1] != self.shape[0]:
            raise ValueError(f"quant_matmul: x {tuple(x.shape)} vs wq {tuple(self.shape)} contraction mismatch")
        if x.dtype not in _X_F32:
            raise TypeError(f"quant_matmul kernel: x must be float32 or bfloat16, got {x.dtype}")
        if x.get_device() != self.index:
            raise ValueError(f"quant_matmul kernel: x on {x.device}, the weight on {self.device}")
        if not x.is_contiguous():
            raise ValueError("quant_matmul kernel: x must be contiguous")
        x_ptr = x.data_ptr()
        if x_ptr % 16:
            raise ValueError("quant_matmul kernel: x must be 16-byte aligned")
        m = x.shape[0]
        y = torch.empty((m, self.shape[1]), dtype=x.dtype, device=x.device)
        if m == 0:
            return y
        args = self._args
        args.x, args.y, args.m, args.x_f32 = x_ptr, y.data_ptr(), m, _X_F32[x.dtype]
        _build.check(self._launch(self._args_ref, _build.stream_of(x)), "quant_matmul kernel")
        quant_matmul.launches += 1
        return y


def quant_matmul(x, wq, scale, prepared: PreparedWeight | None = None):
    """Fused dequant-matmul over 2-D operands (see module docstring). On the
    card, `prepared` (from `PreparedWeight(wq, scale)`) skips the weight's
    checks; without it the weight is prepared for this call."""
    if prepared is not None and x.is_cuda:  # the weight was checked when it was prepared; x is checked there
        if not prepared.holds(wq, scale):
            raise ValueError("quant_matmul: `prepared` was made for another weight")
        return prepared(x)
    if x.ndim != 2 or wq.ndim != 2 or x.shape[1] != wq.shape[0]:
        raise ValueError(f"quant_matmul: x {tuple(x.shape)} vs wq {tuple(wq.shape)} contraction mismatch")
    if scale.shape != (wq.shape[1],):
        raise ValueError(f"quant_matmul: scale shape {tuple(scale.shape)} != ({wq.shape[1]},)")
    if x.device.type == "cpu":
        if static_walk.recorder() is not None:
            return static_walk.quant_matmul(x, wq)
        return reference_quant_matmul(x, wq, scale)
    if x.device.type != "cuda":
        raise RuntimeError(f"quant_matmul: no kernel for device {x.device}")
    return PreparedWeight(wq, scale)(x)


quant_matmul.launches = 0  # kernel launches since the last reset (the CPU path never counts)

#!/usr/bin/env python3
"""Probe: what makes the fused-CE backward kernels' bf16 gradients differ,
element by element, from the fp32 plain gradient rounded to bf16.

At the 32k training shape (h [32768, 1536], W [50304, 1536] bf16, one row in
16 ignored; the inputs of `chip_smoke.py` phase 1), the reference is what
`chip_smoke._ce_check` holds the kernels to: autograd of
`plain_sum_and_count` in fp32 (dh and dW of the sum, TF32 off), rounded to
bf16. Against it this probe counts the share of elements whose bf16 value
differs, for dh = ds W and for dW = ds^T h, computed from the same fp32
ds = gm (softmax(h W^T) - onehot(label)) in five ways:

  (a) fp32 ds times fp32 W in one cuBLAS product (no TF32): the share any
      second fp32 computation of the same gradient shows;
  (b) ds split as the kernels split it (hi = bf16(ds), lo = bf16(ds - hi))
      and (hi + lo) times W in fp32: the share of the 16-bit ds alone;
  (c) fp32 ds times W summed in 64-column vocab tiles for dh (64-token tiles
      for dW), one fp32 sum carried across the tiles in order: the kernels'
      order of accumulation alone;
  (d) (b) and (c) together: what the kernels compute, in another order within
      a tile;
  (e) hi and lo times W on the tensor cores, as the kernels multiply them: one
      cuBLAS bf16 product over the vocab twice ([hi | lo] [W; W], fp32
      accumulation on the tensor cores, rounded to bf16 at the end);

and, in the same run, the kernels' own share (`fused_ce_backward_dh`,
`fused_ce_backward_dw`). Run on the card from the repository root:

    python3 scripts/probe_ce_rounding.py
"""

from __future__ import annotations

import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

TILE = 64  # vocab columns (dh) and tokens (dW) a tile of the kernels


def main() -> int:
    import torch

    import chip_smoke as cs
    from modalities_tpu_torch.ops import fused_ce as fce

    if not torch.cuda.is_available():
        print("probe_ce_rounding: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    n, v, e = cs.CE_SHAPE
    g = torch.Generator(device="cuda").manual_seed(5)
    h, w, labels = cs._ce_inputs(torch, g, n, v, e, "bfloat16", "bfloat16", n // 16)

    # the reference: autograd of the fp32 plain version, as _ce_check takes it
    hp, wp = h.float().requires_grad_(True), w.float().requires_grad_(True)
    fce.plain_sum_and_count(hp, wp, labels)[0].backward()
    ref = {"dh": hp.grad.to(torch.bfloat16), "dW": wp.grad.to(torch.bfloat16)}
    h32, w32 = hp.detach(), wp.detach()
    del hp, wp

    # the kernels' own gradients of the sum (gm = the mask)
    lse, _ = fce.fused_ce_forward(h, w, labels)
    gm = (labels != -100).float()
    kernel = {"dh": fce.fused_ce_backward_dh(h, w, labels, lse, gm),
              "dW": fce.fused_ce_backward_dw(h, w, labels, lse, gm)}

    # ds in fp32 from fp32 logits, the plain backward's formula
    ds = h32 @ w32.t()
    ds -= torch.logsumexp(ds, dim=-1, keepdim=True)
    ds.exp_()
    hit = labels >= 0
    ds[torch.arange(n, device="cuda")[hit], labels[hit]] -= 1.0
    ds *= gm[:, None]
    hi = ds.to(torch.bfloat16)
    lo = (ds - hi.float()).to(torch.bfloat16)
    split = hi.float() + lo.float()  # hi + lo, exact in fp32

    def tiled(a, b, transpose: bool):
        """sum over tiles t of a[:, t] @ b[t] (or a[t]^T @ b[t]), in tile order, one fp32 sum."""
        out = None
        for t0 in range(0, a.shape[0] if transpose else a.shape[1], TILE):
            part = a[t0:t0 + TILE].t() @ b[t0:t0 + TILE] if transpose else a[:, t0:t0 + TILE] @ b[t0:t0 + TILE]
            out = part if out is None else out.add_(part)
        return out

    ways = {
        "(a) fp32 ds, one product": (lambda: ds @ w32, lambda: ds.t() @ h32),
        "(b) ds as bf16 hi + lo, one fp32 product": (lambda: split @ w32, lambda: split.t() @ h32),
        "(c) fp32 ds, 64-wide tiles summed in order": (lambda: tiled(ds, w32, False), lambda: tiled(ds, h32, True)),
        "(d) hi + lo and 64-wide tiles": (lambda: tiled(split, w32, False), lambda: tiled(split, h32, True)),
        "(e) hi and lo on the tensor cores, one bf16 product": (
            lambda: torch.cat([hi, lo], 1) @ torch.cat([w, w]), lambda: torch.cat([hi, lo]).t() @ torch.cat([h, h])),
    }
    shares = {}
    for name, fns in ways.items():
        for grad, fn in zip(("dh", "dW"), fns):
            got = fn().to(torch.bfloat16)
            shares[(name, grad)] = float((got != ref[grad]).float().mean())
            del got
            torch.cuda.empty_cache()
    for grad in ("dh", "dW"):
        shares[("kernel", grad)] = float((kernel[grad] != ref[grad]).float().mean())
    for name in [*ways, "kernel"]:
        print(f"{name}: elements unequal to the fp32 plain gradient rounded to bf16: "
              f"dh {shares[(name, 'dh')]:.3%}, dW {shares[(name, 'dW')]:.3%} "
              f"(h[{n},{e}] w[{v},{e}] bf16, {n // 16} rows ignored; {smi})", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

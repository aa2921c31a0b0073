#!/usr/bin/env python3
"""Probe: the dequant-matmul kernel alone on the card. Builds the port's
library, prints ptxas's registers and spills of `quant_mm_tc`, then runs
chip_smoke.py's dequant-matmul checks and times (`phase_quant_matmul`: every
serving shape, int8 and fp8, bf16 and fp32 x, M 1..100 against the plain
version; bitwise batch invariance and repeatability; the check's sensitivity;
kernel, plain and library times at M 8 and 64).

With `--stamps`, a copy of csrc/quant_matmul.cu with timeline stamps
inserted (thread 0 of every CTA: clock64 at entry, at the first and the last
k tile's arrival, after the main loop, after each cluster barrier; the
global timer at entry and exit; the SM) is built alone under build/ and run
at the serving shapes, once after an L2 flush and once warm: per CTA the
cycles from entry to the first tile, streaming the rest, the tail, the
partials' exchange, the reduction, and the kernel's span and CTAs a SM.

With `--sweep`, the kernel is timed at every cluster split of 1..8 at the
serving shapes (M 8 and 64), the split set by hand on a prepared weight.

With `--sass`, quant_matmul.cu is compiled alone to a cubin and the SASS of
the decode instance (NB 8, bf16 x, int8) is written under build/, its
barrier, fence and shared-memory instructions printed.

With `--parent DIR` (a csrc/ directory of the kernel before the redesign, for
example the parent commit's unpacked under build/:
`git archive HEAD~1 modalities_tpu_torch/csrc | tar -x -C build/parent`), that
copy's quant_matmul.cu is built alone and its entry point (the split-K kernel
and its reduction, with a workspace) is timed beside the current kernel at
the same shapes, in turns (parent, current, current, parent), and the two
outputs are compared. Run on the card from the repository root:

    python3 scripts/probe_quant_matmul.py [--stamps] [--sweep] [--sass] [--skip-checks] [--parent DIR]
"""

from __future__ import annotations

import argparse
import ctypes
import subprocess
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

# The parent's launch plan (its ops/quant_matmul.py): 64-column tiles, K split towards 1056 CTAs.
PARENT_BLOCK_N, PARENT_TARGET_CTAS = 64, 1056


def parent_splits(k: int, n: int) -> int:
    ktiles = k // 64
    tiles_n = -(-n // PARENT_BLOCK_N)
    want = max(1, min(ktiles, -(-PARENT_TARGET_CTAS // tiles_n)))
    per_split = -(-ktiles // want)
    return -(-ktiles // per_split)


def build_parent(csrc: Path):
    from modalities_tpu_torch.ops import _build

    out = REPO / "build" / "probe_quant_matmul" / "libparent_qmm.so"
    out.parent.mkdir(parents=True, exist_ok=True)
    subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-shared", "-o", str(out), str(csrc / "quant_matmul.cu")],
                   check=True, capture_output=True, text=True)
    lib = ctypes.CDLL(str(out))
    vp, i = ctypes.c_void_p, ctypes.c_int
    lib.mt_quant_matmul.argtypes = [vp, vp, vp, vp, vp, i, i, i, i, i, i, vp]
    lib.mt_quant_matmul.restype = ctypes.c_int
    return lib


STAMP_PRELUDE = """
__device__ unsigned long long qmm_stamps[16384 * 16];
__device__ __forceinline__ unsigned long long* qmm_slot() { return qmm_stamps + (blockIdx.y * gridDim.x + blockIdx.x) * 16; }
__device__ __forceinline__ void qmm_stamp(int i) { qmm_slot()[i] = clock64(); }
__device__ __forceinline__ void qmm_stamp_gt(int i) {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  qmm_slot()[i] = t;
}
__device__ __forceinline__ void qmm_smid(int i) {
  unsigned s;
  asm volatile("mov.u32 %0, %%smid;" : "=r"(s));
  qmm_slot()[i] = s;
}
extern "C" int probe_stamps(void* out, unsigned long long bytes) {
  return static_cast<int>(cudaMemcpyFromSymbol(out, qmm_stamps, bytes));
}
"""
# (anchor, what goes after it; "before:" puts it in front of the anchor), each anchor's first occurrence
STAMP_PATCHES = [
    ('#include "hopper.cuh"\n', STAMP_PRELUDE),
    ("  const int tid = threadIdx.x;\n",
     "  if (tid == 0) { qmm_stamp(0); qmm_stamp_gt(8); }\n  long long qs[5] = {0, 0, 0, 0, 0};\n"),
    ("before:      hopper::mbar_wait(&full[t % C::STAGES], (t / C::STAGES) & 1);\n", "      long long q0 = clock64();\n"),
    ("      hopper::mbar_wait(&full[t % C::STAGES], (t / C::STAGES) & 1);\n",
     "      if (tid == 0 && t == 0) qmm_stamp(1);\n      if (tid == 0 && t == n_t - 1) qmm_stamp(2);\n"
     "      long long q1 = clock64();\n      qs[0] += q1 - q0;\n"),
    ("      widen_tile<FP8>(st, a_of(t), wg, tid & 127);\n", "      long long q2 = clock64();\n      qs[1] += q2 - q1;\n"),
    ("      hopper::fence_async_smem();  // the widened tile (and the pieces), for wgmma\n",
     "      qs[2] += clock64() - q2;\n"),
    ("before:        hopper::named_bar_sync(1 + wg, 128);", "        long long q3 = clock64();\n"),
    ("        hopper::named_bar_sync(1 + wg, 128);  // this warpgroup's four warps have widened tile t\n",
     "        long long q4 = clock64();\n        qs[3] += q4 - q3;\n"),
    ("        if (t > 0) release(t - 1);\n", "        qs[4] += clock64() - q4;\n"),
    ("before:  // Every column's partial goes to the rank", "  if (tid == 0) qmm_stamp(3);\n"),
    ("  hopper::mbar_wait(recv_bar, 0);  // every rank's partials of this rank's columns have landed\n",
     "  if (tid == 0) qmm_stamp(4);\n"),
    ("before:\n}\n\ntemplate <int NB, bool XF32, bool FP8>\nint launch(",
     "\n  if (tid == 0) {\n    qmm_stamp(5); qmm_stamp_gt(9); qmm_smid(10);\n"
     "    for (int i = 0; i < 5; ++i) qmm_slot()[11 + i] = qs[i];\n  }"),
]


def build_stamped():
    """The current quant_matmul.cu with the stamps, built alone; returns the library."""
    from modalities_tpu_torch.ops import _build

    dst = REPO / "build" / "probe_quant_matmul" / "stamped"
    dst.mkdir(parents=True, exist_ok=True)
    (dst / "hopper.cuh").write_text((_build.CSRC / "hopper.cuh").read_text())
    src = (_build.CSRC / "quant_matmul.cu").read_text()
    for anchor, text in STAMP_PATCHES:
        before = anchor.startswith("before:")
        anchor = anchor.removeprefix("before:")
        at = src.index(anchor)
        at = at if before else at + len(anchor)
        src = src[:at] + text + src[at:]
    (dst / "quant_matmul.cu").write_text(src)
    out = dst / "libstamped_qmm.so"
    r = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-shared", "-o", str(out), str(dst / "quant_matmul.cu")],
                       capture_output=True, text=True)
    for line in (r.stdout + r.stderr).splitlines():
        if "warning" in line or "C75" in line or "error" in line:
            print(line, flush=True)
    r.check_returncode()
    lib = ctypes.CDLL(str(out))
    vp, i = ctypes.c_void_p, ctypes.c_int
    lib.mt_quant_matmul_prepare.argtypes = [vp, i, i, vp]
    lib.mt_quant_matmul.argtypes = [vp, vp]
    lib.probe_stamps.argtypes = [vp, ctypes.c_ulonglong]
    for fn in (lib.mt_quant_matmul_prepare, lib.mt_quant_matmul, lib.probe_stamps):
        fn.restype = ctypes.c_int
    return lib


def stamps_run(torch, lib) -> None:
    import numpy as np

    import chip_smoke
    from modalities_tpu_torch.ops import quant_matmul as qm
    from modalities_tpu_torch.quant.core import quantize_per_channel

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(9)
    flush = torch.empty(chip_smoke.L2_FLUSH_BYTES, dtype=torch.uint8, device=dev)
    for k, n in chip_smoke.QMM_SHAPES:
        w = torch.randn(n, k, generator=g, device=dev) * 0.02
        q, s = quantize_per_channel(w)
        wq, scale = q.t().contiguous(), s[:, 0].contiguous()
        args = qm._QmmArgs()
        if lib.mt_quant_matmul_prepare(wq.data_ptr(), k, n, ctypes.addressof(args.wmap)):
            raise RuntimeError("prepare failed")
        args.scale, args.k, args.n, args.splits = scale.data_ptr(), k, n, qm.split_k(k, n)
        args.w_fp8, args.device = 0, 0
        for m in (8, 64):
            x_dtype = torch.float32 if n == 50304 else torch.bfloat16
            x = torch.randn(m, k, generator=g, device=dev).to(x_dtype)
            y = torch.empty(m, n, dtype=x_dtype, device=dev)
            args.x, args.y, args.m, args.x_f32 = x.data_ptr(), y.data_ptr(), m, int(x_dtype == torch.float32)
            ctas = args.splits * -(-n // qm.BLOCK_N) * -(-m // 64)
            for how in ("after an L2 flush", "warm"):
                if how == "warm":
                    for _ in range(3):
                        lib.mt_quant_matmul(ctypes.byref(args), torch.cuda.current_stream().cuda_stream)
                else:
                    flush.zero_()
                    torch.cuda._sleep(chip_smoke.SPIN_CYCLES)
                if lib.mt_quant_matmul(ctypes.byref(args), torch.cuda.current_stream().cuda_stream):
                    raise RuntimeError("launch failed")
                torch.cuda.synchronize()
                buf = np.zeros(ctas * 16, dtype=np.uint64)
                if lib.probe_stamps(buf.ctypes.data, buf.nbytes):
                    raise RuntimeError("stamps copy failed")
                st = buf.reshape(ctas, 16).astype(np.int64)
                d = {"to first tile": st[:, 1] - st[:, 0], "rest of the tiles": st[:, 2] - st[:, 1],
                     "last tile to loop end": st[:, 3] - st[:, 2], "partials out and in": st[:, 4] - st[:, 3],
                     "reduction": st[:, 5] - st[:, 4], "CTA": st[:, 5] - st[:, 0]}
                span_us = (st[:, 9].max() - st[:, 8].min()) / 1e3
                start_spread_us = (st[:, 8].max() - st[:, 8].min()) / 1e3
                per_sm = np.bincount(st[:, 10], minlength=132)
                print(f"x[{m},{k}] {str(x_dtype)[6:]} @ int8[{k},{n}] split {args.splits}, {ctas} CTAs, {how}: "
                      f"span {span_us:.2f} us (global timer), CTA starts spread over {start_spread_us:.2f} us, "
                      f"CTAs a SM {per_sm.min()}..{per_sm.max()}; cycles median / max: "
                      + ", ".join(f"{key} {int(np.median(v))} / {int(v.max())}" for key, v in d.items()), flush=True)
                if x_dtype == torch.bfloat16:  # the consumer loop's phases (thread 0), cycles a k tile, median
                    tiles = np.array([b - a for a, b in qm.rank_k_tiles(k, n)] * (ctas // args.splits))
                    names = ("waiting for the stage", "widening", "fence", "warpgroup barrier",
                             "issue and waiting for the tile before")
                    print("    per k tile: " + ", ".join(
                        f"{name} {np.median(st[:, 11 + i] / tiles):.0f}" for i, name in enumerate(names)), flush=True)


def sweep_splits(torch) -> None:
    """Every split of 1..8 (at most the k tiles) at the serving shapes, M 8 and 64: the kernel's time
    (`chip_smoke.time_ms`) with the split set by hand, beside split_k's choice."""
    import chip_smoke
    from modalities_tpu_torch.ops.quant_matmul import BLOCK_K, PreparedWeight, quant_matmul, split_k
    from modalities_tpu_torch.quant.core import quantize_per_channel

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(13)
    for k, n in chip_smoke.QMM_SHAPES:
        w = torch.randn(n, k, generator=g, device=dev) * 0.02
        q, s = quantize_per_channel(w)
        wq, scale = q.t().contiguous(), s[:, 0].contiguous()
        pw = PreparedWeight(wq, scale)
        for m in (8, 64):
            x_dtype = torch.float32 if n == 50304 else torch.bfloat16
            x = torch.randn(m, k, generator=g, device=dev).to(x_dtype)
            times = []
            for splits in range(1, min(8, k // BLOCK_K) + 1):
                pw.splits = pw._args.splits = splits
                times.append(f"{splits}: {chip_smoke.time_ms(torch, lambda: quant_matmul(x, wq, scale, pw)):.4f}")
            print(f"splits at x[{m},{k}] {str(x_dtype)[6:]} @ int8[{k},{n}] (split_k: {split_k(k, n)}), ms: "
                  + ", ".join(times), flush=True)


def dump_sass() -> None:
    """quant_matmul.cu compiled alone to a cubin; the SASS of the decode instance (NB 8, bf16 x, int8) into
    build/probe_quant_matmul/quant_mm_tc.sass, and its barrier, fence and shared-memory lines printed."""
    from modalities_tpu_torch.ops import _build

    out = REPO / "build" / "probe_quant_matmul"
    out.mkdir(parents=True, exist_ok=True)
    subprocess.run([_build._nvcc(), "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3", "-cubin", "-o",
                    str(out / "qmm.cubin"), str(_build.CSRC / "quant_matmul.cu")], check=True)
    cuobjdump = Path(_build._nvcc()).parent / "cuobjdump"
    sass = subprocess.run([str(cuobjdump), "-sass", str(out / "qmm.cubin")], check=True, capture_output=True,
                          text=True).stdout
    body = next(f for f in sass.split("Function : ") if "quant_mm_tcILi8ELb0ELb0E" in f.split("\n")[0])
    (out / "quant_mm_tc.sass").write_text(body)
    keys = ("BAR", "MEMBAR", "CCTL", "SYNCS", "ST.E", "STAS", "LDS", "EXIT")
    for line in body.splitlines():
        if any(k in line for k in keys):
            print(" ".join(line.split()[:4]), flush=True)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--parent", type=Path, default=None, help="a csrc/ directory holding the earlier kernel")
    ap.add_argument("--stamps", action="store_true", help="a timeline of the kernel's CTAs at the serving shapes")
    ap.add_argument("--skip-checks", action="store_true", help="leave out chip_smoke's checks and times")
    ap.add_argument("--sweep", action="store_true", help="time every cluster split at the serving shapes")
    ap.add_argument("--sass", action="store_true", help="the decode instance's SASS: barriers, fences, stores")
    args = ap.parse_args()
    import torch

    import chip_smoke
    from modalities_tpu_torch.ops import _build
    from modalities_tpu_torch.ops.quant_matmul import PreparedWeight, quant_matmul
    from modalities_tpu_torch.quant.core import quantize_fp8, quantize_per_channel

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    t = time.perf_counter()
    _build.library()
    print(f"built in {time.perf_counter() - t:.1f} s", flush=True)
    for line in _build.ptxas_usage("quant_mm_tc"):
        print(line, flush=True)
    for line in _build.build_log.splitlines():
        if "quant_matmul" in line and ("warning" in line or "C75" in line):
            print(line, flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    chip_smoke.warm_up(torch)
    if args.sass:
        dump_sass()
    if args.stamps:
        stamps_run(torch, build_stamped())
    if args.sweep:
        sweep_splits(torch)
    if not args.skip_checks:
        chip_smoke.phase_quant_matmul(torch)
    if args.parent is None:
        return 0

    lib = build_parent(args.parent)
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(5)
    for k, n in chip_smoke.QMM_SHAPES:
        w = torch.randn(n, k, generator=g, device=dev) * 0.02
        for mode, quantize in (("int8", quantize_per_channel), ("fp8", quantize_fp8)):
            q, s = quantize(w)
            wq, scale = q.t().contiguous(), s[:, 0].contiguous()
            pw = PreparedWeight(wq, scale)
            for m in (8, 64):
                x_dtype = torch.float32 if n == 50304 else torch.bfloat16
                x = torch.randn(m, k, generator=g, device=dev).to(x_dtype)
                splits = parent_splits(k, n)
                y = torch.empty(m, n, dtype=x_dtype, device=dev)
                ws = torch.empty(splits, m, n, device=dev)

                def parent():
                    st = lib.mt_quant_matmul(x.data_ptr(), wq.data_ptr(), scale.data_ptr(), y.data_ptr(),
                                             ws.data_ptr(), m, k, n, 0 if x_dtype == torch.float32 else 1,
                                             1 if mode == "fp8" else 0, splits,
                                             torch.cuda.current_stream().cuda_stream)
                    if st:
                        raise RuntimeError(f"parent kernel: CUDA error {st}")

                parent()
                torch.cuda.synchronize()
                diff = float((y.float() - quant_matmul(x, wq, scale, pw).float()).abs().max())
                times = [chip_smoke.time_ms(torch, fn) for fn in (parent, lambda: quant_matmul(x, wq, scale, pw),
                                                                  lambda: quant_matmul(x, wq, scale, pw), parent)]
                print(f"x[{m},{k}] {str(x_dtype)[6:]} @ {mode}[{k},{n}]: parent (split {splits}) "
                      f"{times[0]:.4f} / {times[3]:.4f} ms, current (split {pw.splits}) {times[1]:.4f} / "
                      f"{times[2]:.4f} ms; max |parent - current| {diff:.3g}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

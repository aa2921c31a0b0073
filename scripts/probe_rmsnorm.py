#!/usr/bin/env python3
"""Probe: the RMSNorm backward's two launches timed apart, at both training
shapes (x [8192, 2560] and [32768, 1536] bf16, scale fp32, dscale wanted and
dbias not, as the training paths call it); and the forward (`mt_rms_norm_fwd`,
bf16, scale fp32, r written) at those shapes and the serving path's decode and
largest prefill chunk (x [8, 2560], [64, 2560]), its outputs compared bitwise
across the versions.

The backward (`mt_rms_norm_bwd` in csrc/fused_rmsnorm.cu) is one C call that
launches a row kernel (dx, and fp32 column partials a CTA) and then a column
sum (the partials summed over the row kernel's CTAs). This probe copies a
csrc/ directory, appends to the copy of fused_rmsnorm.cu an entry point for each
launch alone (the SHIMS below, chosen by the design the source holds), builds
that copy alone and times with CUDA events (`chip_smoke.time_ms`: each call
after an L2 flush) the rows alone, the column sum alone on the partials the
rows left, and both in one call. With several `--csrc` directories (for
example the parent commit's, unpacked under build/), each is built and the
versions are timed in turns, A, B, A, B, in one process. Run on the card from
the repository root:

    python3 scripts/probe_rmsnorm.py [--csrc DIR ...]

The copies are built under build/probe_rmsnorm/ (gitignored); the sources
are read, never changed.
"""

from __future__ import annotations

import argparse
import ctypes
import shutil
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

SHAPES = [(8192, 2560), (32768, 1536)]  # (rows, width): the 2.7B and the 32k training paths' norms
FWD_SHAPES = [(8, 2560), (64, 2560), *SHAPES]  # and the serving path's decode and largest prefill chunk
_ARGS = "const void* x, const void* scale, const void* r, const void* dy, void* dx, void* ws, int n, int e"
# marker in fused_rmsnorm.cu -> (entry points launching each part alone for bf16, rows a CTA for N)
SHIMS = {
    # the first design: a CTA of 256 threads a block of 32 rows; the column sum a thread a column
    "column_sum_kernel<<<grid, 256, 0, stream>>>": (f"""
extern "C" int probe_rows({_ARGS}, int rows, void* stream) {{
  rms_norm_bwd_kernel<__nv_bfloat16><<<(n + rows - 1) / rows, kBwdThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const float*>(scale), static_cast<const float*>(r),
      static_cast<const __nv_bfloat16*>(dy), static_cast<__nv_bfloat16*>(dx), static_cast<float*>(ws), nullptr, n, e,
      rows);
  return static_cast<int>(cudaGetLastError());
}}
extern "C" int probe_columns(const void* ws, void* out, int n, int e, int rows, void* stream) {{
  column_sum_kernel<<<(e + 255) / 256, 256, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(ws), static_cast<float*>(out), (n + rows - 1) / rows, e);
  return static_cast<int>(cudaGetLastError());
}}
""", lambda n: 32),
    # CTAs walking rows b, b + G, ... through a ring of bulk copies; a wide column sum
    "launch_bwd_rows<T>(": (f"""
extern "C" int probe_rows({_ARGS}, int rows, void* stream) {{
  launch_bwd_rows<__nv_bfloat16>(x, static_cast<const float*>(scale), static_cast<const float*>(r), dy, dx,
                                 static_cast<float*>(ws), nullptr, n, e, rows, static_cast<cudaStream_t>(stream));
  return static_cast<int>(cudaGetLastError());
}}
extern "C" int probe_columns(const void* ws, void* out, int n, int e, int rows, void* stream) {{
  launch_column_sums(static_cast<const float*>(ws), nullptr, static_cast<float*>(out), nullptr,
                     (n + rows - 1) / rows, e, static_cast<cudaStream_t>(stream));
  return static_cast<int>(cudaGetLastError());
}}
""", None),
}


def build(csrc: Path, label: str):
    """The copy of `csrc` with the shim appended, built alone; (library, rows a CTA for N)."""
    from modalities_tpu_torch.ops import _build

    dst = REPO / "build" / "probe_rmsnorm" / label
    shutil.rmtree(dst, ignore_errors=True)
    shutil.copytree(csrc, dst / "csrc")
    src = (dst / "csrc" / "fused_rmsnorm.cu").read_text()
    found = [k for k in SHIMS if k in src]
    if len(found) != 1:
        raise RuntimeError(f"{csrc}/fused_rmsnorm.cu: no single known design (markers found: {found})")
    shim, rows = SHIMS[found[0]]
    (dst / "csrc" / "fused_rmsnorm.cu").write_text(src + shim)
    lib_path = dst / "libprobe.so"
    subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-shared", "-o", str(lib_path),
                    str(dst / "csrc" / "fused_rmsnorm.cu")], check=True, capture_output=True, text=True)
    lib = ctypes.CDLL(str(lib_path))
    vp, i32 = ctypes.c_void_p, ctypes.c_int
    lib.probe_rows.argtypes = [vp] * 6 + [i32] * 3 + [vp]
    lib.probe_columns.argtypes = [vp, vp] + [i32] * 3 + [vp]
    lib.mt_rms_norm_fwd.argtypes = list(_build._SIGNATURES["mt_rms_norm_fwd"])
    if rows is None:  # the wrapper's own grid sizing
        from modalities_tpu_torch.ops.rmsnorm import backward_grid

        rows = lambda n: backward_grid(n)[0]  # noqa: E731
    return lib, rows


def main() -> int:
    import torch

    import chip_smoke as cs

    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--csrc", nargs="+", type=Path, default=[REPO / "modalities_tpu_torch" / "csrc"],
                        help="csrc/ directories to build and time in turns (default: the repository's)")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("probe_rmsnorm: no CUDA device", file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    libs = {f"{i}:{c}": build(c.resolve(), f"v{i}") for i, c in enumerate(args.csrc)}
    stream = torch.cuda.current_stream().cuda_stream
    g = torch.Generator(device="cuda").manual_seed(3)
    cs.warm_up(torch)
    for n, e in FWD_SHAPES:
        x = torch.randn(n, e, generator=g, device="cuda").to(torch.bfloat16)
        s32 = torch.randn(e, generator=g, device="cuda")
        outs = {label: (torch.empty_like(x), torch.empty(n, device="cuda")) for label in libs}
        times = {label: [] for label in libs}
        for _ in range(2):  # A, B, A, B
            for label, (lib, _) in libs.items():
                y, r = outs[label]

                def run_fwd(lib=lib, y=y, r=r):
                    if lib.mt_rms_norm_fwd(x.data_ptr(), s32.data_ptr(), None, y.data_ptr(), r.data_ptr(), n, e,
                                           1e-5, 1, stream):
                        raise RuntimeError("mt_rms_norm_fwd: launch failed")

                times[label].append(cs.time_ms(torch, run_fwd, reps=20))
        first = next(iter(outs.values()))
        bound = 1e3 * (2 * n * e * 2 + 4 * e + 4 * n) / cs.PEAK_BYTES_S  # x in, y out, scale, r
        for label in libs:
            same = all(torch.equal(a, b) for a, b in zip(outs[label], first))
            print(f"forward x[{n},{e}] bf16 {label}: {times[label]} ms; bound {bound:.5f} ms (bytes); y and r bitwise "
                  f"equal to the first version's: {same} ({smi})", flush=True)
    for n, e in SHAPES:
        x = torch.randn(n, e, generator=g, device="cuda").to(torch.bfloat16)
        dy = torch.randn(n, e, generator=g, device="cuda").to(torch.bfloat16)
        s32 = torch.randn(e, generator=g, device="cuda")
        r = torch.rsqrt((x.float() ** 2).mean(-1) + 1e-5)
        dx = torch.empty_like(x)
        out = torch.empty(e, device="cuda")
        bound = 1e3 * (3 * n * e * 2 + 4 * n + 2 * 4 * e) / cs.PEAK_BYTES_S  # x, dy in; dx out; r, scale; dscale
        times: dict[tuple[str, str], list[float]] = {}
        for _ in range(2):  # A, B, A, B
            for label, (lib, rows_of) in libs.items():
                rows = rows_of(n)
                ws = torch.empty(-(-n // rows) * e, device="cuda")
                ptrs = (x.data_ptr(), s32.data_ptr(), r.data_ptr(), dy.data_ptr(), dx.data_ptr(), ws.data_ptr())

                def run_rows(lib=lib, ptrs=ptrs, rows=rows):
                    if lib.probe_rows(*ptrs, n, e, rows, stream):
                        raise RuntimeError("probe_rows: launch failed")

                def run_columns(lib=lib, ws=ws, rows=rows):
                    if lib.probe_columns(ws.data_ptr(), out.data_ptr(), n, e, rows, stream):
                        raise RuntimeError("probe_columns: launch failed")

                run_rows()
                for part, fn in (("rows", run_rows), ("columns", run_columns),
                                 ("both", lambda: (run_rows(), run_columns()))):
                    times.setdefault((label, part), []).append(cs.time_ms(torch, fn, reps=10))
                want = (dy.float() * x.float() * r[:, None]).sum(0)
                err = float((out - want).abs().max() / want.abs().max())
                if err > 1e-5:
                    raise AssertionError(f"{label} x[{n},{e}]: dscale off by {err:g} (relative to its largest)")
        for label, (_, rows_of) in libs.items():
            rows = rows_of(n)
            parts = {part: times[(label, part)] for part in ("rows", "columns", "both")}
            print(f"x[{n},{e}] bf16 {label} ({-(-n // rows)} CTAs of up to {rows} rows): "
                  + ", ".join(f"{part} {v} ms" for part, v in parts.items())
                  + f"; bound {bound:.5f} ms (bytes) ({smi})", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

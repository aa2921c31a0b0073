"""Build and load the port's CUDA kernels (route b of a hand-written kernel:
`nvcc` into a shared library with a plain C interface, bound with `ctypes`).

Every `.cu` source under `modalities_tpu_torch/csrc/` is compiled for `sm_90a`
by its own nvcc process, all started together, and the objects are linked into
one shared library under `build/modalities_tpu_torch/` at the repository root.
A source named in `PARTS` is compiled once a part, each with its own macro
(flash_attention.cu in five: head dim 128's three kernels one a part, head dim
80, the smaller head dims), so no one process holds the
build up; `unit_seconds` keeps each process's wall time.
The sources share `csrc/hopper.cuh` (wgmma, mbarrier, cp.async and cluster
helpers in raw PTX). The library's file name carries a hash of the sources,
headers and flags, so an edited source builds anew and an unchanged one loads
the existing library. nvcc runs with `-Xptxas -v`: `build_log` keeps what it
printed (registers, shared memory and spills of every kernel). The build
happens on first use, inside the call that launches a kernel, never at import:
a process without CUDA can import every module.

Each C entry point returns `cudaGetLastError()` right after its launch;
`check(status, what)` turns a non-zero status into an exception. A failed
build raises with nvcc's output: there is no fallback.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build" / "modalities_tpu_torch"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

# sources compiled in parts, one nvcc process a part: the flags that pick each part's share of the source
PARTS = {"flash_attention.cu": tuple(f"-DMT_FLASH_PART={i}" for i in range(1, 6))}

_VP = ctypes.c_void_p
_INT = ctypes.c_int
# C signatures of the entry points (see the .cu sources)
_SIGNATURES = {
    "mt_rms_norm_fwd": (_VP, _VP, _VP, _VP, _VP, _INT, _INT, ctypes.c_float, _INT, _VP),
    "mt_rms_norm_bwd": (_VP, _VP, _VP, _VP, _VP, _VP, _VP, _VP, _INT, _INT, _INT, _INT, _VP),
    "mt_flash_fwd": (_VP, _INT, _INT, _VP),  # (const FlashParams*, head dim, dtype, stream)
    "mt_flash_bwd_dq": (_VP, _INT, _INT, _VP),
    "mt_flash_bwd_dkv": (_VP, _INT, _INT, _VP),
    "mt_quant_matmul_prepare": (_VP, _INT, _INT, _VP),  # (wq, K, N, tensor map out)
    "mt_quant_matmul": (_VP, _VP),  # (const QmmArgs*, stream)
    "mt_fused_ce_fwd": (_VP, _INT, _VP),  # (const CEParams*, dtype, stream)
    "mt_fused_ce_bwd_dh": (_VP, _INT, _VP),
    "mt_fused_ce_bwd_dw": (_VP, _INT, _VP),
    "mt_fused_ce_clusters": (_INT, _INT, _VP, _VP),  # (dh 1 / dW 2, E, int* ctas, int* resident)
}

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None
build_seconds: float | None = None  # wall time of the nvcc calls in this process (None: loaded)
build_log = ""  # nvcc's output of that build (ptxas -v)
unit_seconds: dict[str, float] = {}  # wall time of each nvcc process of that build, by object (the link: "link")


def sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu"))


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    candidate = Path(cuda_home) / "bin" / "nvcc"
    if candidate.exists():
        return str(candidate)
    raise RuntimeError("nvcc not found (PATH, CUDA_HOME, /usr/local/cuda): cannot build the port's kernels")


def library_path() -> Path:
    digest = hashlib.sha256()
    for src in sorted(CSRC.glob("*.cu*")):
        digest.update(src.name.encode())
        digest.update(src.read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    digest.update(repr(sorted(PARTS.items())).encode())
    return BUILD_DIR / f"libmt_kernels_{digest.hexdigest()[:16]}.so"


def _run_all(cmds: list[list[str]]) -> tuple[str, list[float]]:
    """Run the commands as concurrent processes; raise with the output of the
    first that fails, after every one has ended. Returns their outputs and
    each one's wall time."""
    start = time.perf_counter()
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True) for c in cmds]
    outputs, seconds = [""] * len(procs), [0.0] * len(procs)

    def wait(i: int) -> None:
        outputs[i] = procs[i].communicate()[0]
        seconds[i] = time.perf_counter() - start

    waiters = [threading.Thread(target=wait, args=(i,)) for i in range(len(procs))]
    for w in waiters:
        w.start()
    for w in waiters:
        w.join()
    for cmd, proc, output in zip(cmds, procs, outputs):
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed (exit {proc.returncode}): {' '.join(cmd)}\n{output}")
    return "".join(outputs), seconds


def _build(out: Path) -> None:
    global build_seconds, build_log, unit_seconds
    out.parent.mkdir(parents=True, exist_ok=True)
    stem = out.with_suffix(f".{os.getpid()}")
    units = [(src, flag, f"{src.stem}{i + 1 if flag else ''}")
             for src in sources() for i, flag in enumerate(PARTS.get(src.name, (None,)))]
    objs = [Path(f"{stem}.{name}.o") for _, _, name in units]
    tmp = Path(f"{stem}.tmp.so")
    start = time.perf_counter()
    try:
        log, seconds = _run_all([[_nvcc(), *NVCC_FLAGS, *([flag] if flag else []), "-c", "-o", str(o), str(src)]
                                 for (src, flag, _), o in zip(units, objs)])
        _, link = _run_all([[_nvcc(), *NVCC_FLAGS, "-shared", "-o", str(tmp), *map(str, objs)]])
        os.replace(tmp, out)  # atomic: a concurrent loader sees all or nothing
    finally:
        for path in (*objs, tmp):
            path.unlink(missing_ok=True)
    build_seconds = time.perf_counter() - start
    build_log = log
    unit_seconds = {**{name: t for (_, _, name), t in zip(units, seconds)}, "link": link[0]}


def ptxas_usage(kernel: str) -> list[str]:
    """ptxas's lines (registers, shared memory, spills) for every compiled
    kernel whose mangled name contains `kernel`, from this process's build."""
    lines, keep = [], False
    for line in build_log.splitlines():
        if "Compiling entry function" in line:
            keep = kernel in line
        if keep and ("entry function" in line or "registers" in line or "spill" in line):
            lines.append(line.strip())
    return lines


def library() -> ctypes.CDLL:
    """The kernels' shared library, built on first use."""
    global _lib
    with _lock:
        if _lib is None:
            path = library_path()
            if not path.exists():
                _build(path)
            lib = ctypes.CDLL(str(path))
            for name, argtypes in _SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = list(argtypes)
                fn.restype = ctypes.c_int
            _lib = lib
        return _lib


def check(status: int, what: str) -> None:
    if status != 0:
        raise RuntimeError(f"{what}: CUDA error {status} at launch")


def require_hopper(t) -> None:
    """Raise unless `t` lies on an sm_90 card: the library holds sm_90a code only."""
    import torch

    cap = torch.cuda.get_device_capability(t.device)
    if cap != (9, 0):
        raise RuntimeError(
            f"the port's kernels are built for sm_90a (Hopper); {t.device} has capability {cap}"
        )


def stream_of(t) -> int:
    """The raw handle of the current CUDA stream of `t`'s device (what
    `torch.cuda.current_stream(t.device).cuda_stream` gives, without building
    a Stream object: a few microseconds of host time a launch)."""
    import torch

    return torch._C._cuda_getCurrentRawStream(t.get_device())

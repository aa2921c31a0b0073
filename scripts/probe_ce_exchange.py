#!/usr/bin/env python3
"""Probe: the share of the cluster fused-CE backward kernels' time (ce_dh_bf16
and ce_dw_bf16 in modalities_tpu_torch/csrc/fused_ce.cu) that goes to their
per-tile exchange across the cluster of 8 CTAs.

It builds a second copy of the kernels with the exchange cut out: no bulk
copies of partial s or of ds rows, no waits for them, no per-tile cluster
barrier. Each CTA then reduces its own partial and multiplies its own ds rows,
so that copy's results are wrong; it only times the rest of the kernel (the
wgmma products, TMA loads, the reduction's shared-memory reads and the ds
arithmetic). Both versions are timed at the 32k training shape (h [32768,
1536], W [50304, 1536] bf16, `chip_smoke.time_ms`), alternating A, B, A, B in
one process. Run on the card from the repository root:

    python3 scripts/probe_ce_exchange.py

The copy is built under build/ (gitignored); the sources the port runs are
read, never changed.
"""

from __future__ import annotations

import shutil
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

# (text of csrc/fused_ce.cu, its replacement, occurrences: the same line in dh and in dW, or one of each)
CUTS = [
    ("    if (t > 0) hopper::cluster_wait();\n", "", 2),
    ("        hopper::mbar_expect(recv_bar, C::P_BYTES);\n", "", 2),
    ("        hopper::mbar_expect(&ds_bar[t & 1], (C::CL - 1) * 2 * C::DS_ROWS);\n", "", 2),
    ("      hopper::bulk_to_peer(hopper::mapa(recv + rank * C::SLOT / 4, tid), part + tid * C::SLOT / 4, C::SLOT,\n"
     "                           hopper::mapa(recv_bar, tid));\n", "", 2),
    ("    hopper::mbar_wait(recv_bar, t & 1);\n", "", 2),
    ("recv + (c * C::RM + rr) * C::BV", "part + (c * C::RM + rr) * C::BV", 1),
    ("recv + (c * C::RV + rr) * C::RP", "part + (c * C::RV + rr) * C::RP", 1),
    ("    hopper::cluster_arrive();  // this CTA has read its slots of tile t\n", "", 2),
    ("        hopper::bulk_to_peer(hopper::mapa(rows, peer), rows, C::DS_ROWS, hopper::mapa(&ds_bar[t & 1], peer));\n",
     "", 2),
    ("    hopper::mbar_wait(&ds_bar[t & 1], (t >> 1) & 1);\n", "", 2),
    ("  hopper::cluster_wait();    // the last tile's arrival\n", "", 2),
]


def cut_copy(dst: Path) -> Path:
    """A copy of csrc/ under `dst` with the exchange cut out of fused_ce.cu."""
    from modalities_tpu_torch.ops import _build

    shutil.rmtree(dst, ignore_errors=True)
    shutil.copytree(_build.CSRC, dst)
    src = (dst / "fused_ce.cu").read_text()
    for old, new, count in CUTS:
        if src.count(old) != count:
            raise RuntimeError(f"fused_ce.cu changed: {old!r} occurs {src.count(old)} times, expected {count}")
        src = src.replace(old, new)
    (dst / "fused_ce.cu").write_text(src)
    return dst


def main() -> int:
    import torch

    import chip_smoke as cs
    from modalities_tpu_torch.ops import _build
    from modalities_tpu_torch.ops import fused_ce as fce

    if not torch.cuda.is_available():
        print("probe_ce_exchange: no CUDA device", file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    libs = {"kernel": _build.library()}
    _build.CSRC = cut_copy(REPO / "build" / "probe_ce_exchange" / "csrc")
    _build.BUILD_DIR = REPO / "build" / "probe_ce_exchange" / "lib"
    _build._lib = None
    libs["no exchange"] = _build.library()

    n, v, e = cs.CE_SHAPE
    g = torch.Generator(device="cuda").manual_seed(5)
    h, w, labels = cs._ce_inputs(torch, g, n, v, e, "bfloat16", "bfloat16", n // 16)
    _build._lib = libs["kernel"]
    lse, _ = fce.fused_ce_forward(h, w, labels)
    gm = (labels != -100).float()
    calls = {"dh": lambda: fce.fused_ce_backward_dh(h, w, labels, lse, gm),
             "dW": lambda: fce.fused_ce_backward_dw(h, w, labels, lse, gm)}
    cs.warm_up(torch)
    times = {(name, lib): [] for name in calls for lib in libs}
    for _ in range(2):  # A, B, A, B
        for lib in libs:
            _build._lib = libs[lib]
            for name, fn in calls.items():
                times[(name, lib)].append(cs.time_ms(torch, fn, reps=3))
    for name, fn in calls.items():
        _build._lib = libs["kernel"]
        want = fn()
        _build._lib = libs["no exchange"]
        differs = not torch.equal(fn(), want)
        a, b = (sum(times[(name, lib)]) / 2 for lib in libs)
        print(f"{name}: kernel {times[(name, 'kernel')]} ms, without the exchange {times[(name, 'no exchange')]} ms "
              f"(wrong results: {differs}); exchange share {(a - b) / a:.3f} of {a:.3f} ms ({smi})", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

#!/usr/bin/env python3
"""Step times of the 2.7B and 32k training configs on one card for two
source trees taken in turns (A, B, B, A), each run in a process of its own
through `python -m modalities_tpu_torch run`: what a change to the
training path costs, measured within one call.

    python3 scripts/probe_train_ab.py --a build/parent --b . [--steps 5]

Both trees must hold the same `modalities_tpu_torch/csrc` (the kernels are
built once, in --b, and the library is copied into --a's build folder).
Each run trains a copy of `configs/config_2p7b_dp.yaml` (2 x 2 sequences of
4096 a step) or `configs/config_long_context_32k.yaml` (one sequence of
32768) cut to one card, on a seeded synthetic corpus (chip_smoke.py's
`_train_config`). A step's time is the tokens of a step over the tokens/s
of its `[train] step` line; step 1 (the warm-up) is left out. The two trees'
losses are printed beside each other: a change that leaves the tp-1 path as
it was gives them bitwise.
"""

from __future__ import annotations

import argparse
import os
import re
import shutil
import statistics
import subprocess
import sys
import tempfile
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
STEP_LINE = re.compile(r"^\[train\] step (\d+): loss (\S+) grad_norm (\S+) lr \S+ tokens/s (\S+)")
CONFIGS = {  # name: (base file, sequence length, micro batch, accumulation steps)
    "2p7b": ("config_2p7b_dp.yaml", 4096, 2, 2),
    "32k": ("config_long_context_32k.yaml", 32768, 1, 1),
}


def run(tree: Path, cfg: Path, tokens_per_step: int) -> tuple[list[float], list[str]]:
    env = dict(os.environ, PYTHONPATH=str(tree))
    proc = subprocess.run([sys.executable, "-m", "modalities_tpu_torch", "run", "--config_file_path", str(cfg),
                           "--device", "cuda"], cwd=tree, env=env, capture_output=True, text=True, timeout=900)
    if proc.returncode != 0:
        raise RuntimeError(f"{tree}: run exited {proc.returncode}: {proc.stderr[-3000:]}")
    steps = [STEP_LINE.match(line) for line in proc.stdout.splitlines()]
    steps = [m for m in steps if m]
    ms = [1e3 * tokens_per_step / float(m.group(4)) for m in steps if int(m.group(1)) > 1]
    return ms, [m.group(2) for m in steps]


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--a", type=Path, required=True, help="the first tree (e.g. the parent commit unpacked)")
    parser.add_argument("--b", type=Path, default=ROOT, help="the second tree (default: this one)")
    parser.add_argument("--steps", type=int, default=5)
    args = parser.parse_args()
    trees = {"A": args.a.resolve(), "B": args.b.resolve()}

    sys.path.insert(0, str(trees["B"]))
    import chip_smoke
    from modalities_tpu_torch.ops import _build

    built = _build.library_path()
    _build.library()
    target = trees["A"] / "build" / "modalities_tpu_torch" / built.name
    target.parent.mkdir(parents=True, exist_ok=True)
    shutil.copy(built, target)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(f"{smi}; kernels {built.name} in both trees", flush=True)

    rng = np.random.default_rng(2032)
    scratch = ROOT / "build"
    scratch.mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=scratch) as tmp:
        tmp = Path(tmp)
        for name, (base, seq, micro, acc) in CONFIGS.items():
            vocab = 50304
            corpus = rng.integers(0, vocab, size=seq + 1 + micro * acc * (args.steps + 2) * seq)
            cfg = chip_smoke._train_config(tmp, f"ab_{name}", corpus, args.steps, {}, seq=seq, base=base, micro=micro,
                                           acc=acc, phase="probe")
            times: dict[str, list[float]] = {"A": [], "B": []}
            losses: dict[str, list[str]] = {}
            for side in "ABBA":
                ms, seen = run(trees[side], cfg, seq * micro * acc)
                times[side] += ms
                losses.setdefault(side, seen)
                print(f"[{name}] {side} ({trees[side]}): step ms {[round(t, 1) for t in ms]}", flush=True)
            med = {side: statistics.median(t) for side, t in times.items()}
            print(f"[{name}] median step ms A {med['A']:.1f}, B {med['B']:.1f} (B / A {med['B'] / med['A']:.4f}); "
                  f"losses A {losses['A']}, B {losses['B']}, equal: {losses['A'] == losses['B']} ({smi})",
                  flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

#!/usr/bin/env python3
"""Host time of the 2.7B serving engine's decode steps on one card for two
source trees taken in turns (A, B, B, A), each run in a process of its own:
what a change to the serving scheduler costs with its new knobs at their
defaults, measured within one call.

    python3 scripts/probe_serve_ab.py --a build/parent --b . [--rounds 2] [--reps 3]

Both trees must hold the same `modalities_tpu_torch/csrc` (the kernels are
built once, in --b, and the library is copied into --a's build folder). Each
process imports its own tree's `chip_smoke.py` and serves its phase 2
requests (9 prompts of 33-451 tokens, 64 new tokens each, 8 slots) with
bf16 weights, first on the ring cache (`serve_phase`, phase 2) and then on
the paged cache (`paged_run`, phase 3b(a)), `--reps` times each on fresh
engines. The order A, B, B, A is taken `--rounds` times. It prints the host
ms a decode step (the engine's `decode_seconds` over `decode_steps`: each
dispatch ends in its device fetch) and the run's wall seconds, and the
median of every run of a tree; the tokens of the two trees are compared (a
change that leaves the default path as it was gives them bitwise).
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import statistics
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]

# one tree's run: its own chip_smoke's phase 2 (ring) and 3b(a) (paged) on bf16 weights
RUN = """
import json, sys, torch
import chip_smoke as cs
cs.PER_FORWARD = cs.per_forward(32)  # the launches a forward at the 2.7B's full depth, not the phases' cut
model = cs.build_model()
params = model.init_params(torch.Generator(device="cuda").manual_seed(0))
reqs = cs.make_requests()
for _ in range(int(sys.argv[1])):
    ring = cs.serve_phase(torch, model, params, "none", reqs)
    paged = cs.paged_run(torch, cs.paged_engine(torch, model, params, "none"), "none", reqs, cs.NEW_TOKENS)
    out = {}
    for name, r in (("ring", ring), ("paged", paged)):
        s = r["stats"]
        out[name] = {"step_ms": 1e3 * s["decode_seconds"] / s["decode_steps"], "decode_steps": s["decode_steps"],
                     "forwards": s["forward_calls"], "wall_s": r["wall_s"], "tokens": r["tokens"]}
    print("RESULT " + json.dumps(out))
"""


def run(tree: Path, reps: int) -> list[dict]:
    env = dict(os.environ, PYTHONPATH=str(tree))
    proc = subprocess.run([sys.executable, "-c", RUN, str(reps)], cwd=tree, env=env, capture_output=True,
                          text=True, timeout=900)
    if proc.returncode != 0:
        raise RuntimeError(f"{tree}: exited {proc.returncode}: {proc.stderr[-3000:]}")
    return [json.loads(x[len("RESULT "):]) for x in proc.stdout.splitlines() if x.startswith("RESULT ")]


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--a", type=Path, required=True, help="the first tree (e.g. the parent commit unpacked)")
    parser.add_argument("--b", type=Path, default=ROOT, help="the second tree (default: this one)")
    parser.add_argument("--rounds", type=int, default=1, help="times the order A, B, B, A is taken")
    parser.add_argument("--reps", type=int, default=1, help="runs of each cache in one process")
    args = parser.parse_args()
    trees = {"A": args.a.resolve(), "B": args.b.resolve()}

    sys.path.insert(0, str(trees["B"]))
    from modalities_tpu_torch.ops import _build

    built = _build.library_path()
    _build.library()
    target = trees["A"] / "build" / "modalities_tpu_torch" / built.name
    target.parent.mkdir(parents=True, exist_ok=True)
    shutil.copy(built, target)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(f"{smi}; kernels {built.name} in both trees", flush=True)

    seen: dict[str, list[dict]] = {"A": [], "B": []}
    for side in "ABBA" * args.rounds:
        for r in run(trees[side], args.reps):
            seen[side].append(r)
            print(f"{side} ({trees[side]}): " + "; ".join(
                f"{name} {v['step_ms']:.2f} ms a decode step over {v['decode_steps']} steps, {v['forwards']} "
                f"forwards, run {v['wall_s']:.2f} s" for name, v in r.items()), flush=True)
    for name in ("ring", "paged"):
        med = {side: statistics.median(r[name]["step_ms"] for r in runs) for side, runs in seen.items()}
        wall = {side: statistics.median(r[name]["wall_s"] for r in runs) for side, runs in seen.items()}
        same = all(r[name]["tokens"] == seen["A"][0][name]["tokens"] for runs in seen.values() for r in runs)
        spread = {side: (min(r[name]["step_ms"] for r in runs), max(r[name]["step_ms"] for r in runs))
                  for side, runs in seen.items()}
        print(f"[{name}] median host ms a decode step A {med['A']:.2f} ({spread['A'][0]:.2f}-{spread['A'][1]:.2f} "
              f"over {len(seen['A'])} runs), B {med['B']:.2f} ({spread['B'][0]:.2f}-{spread['B'][1]:.2f}) "
              f"(B / A {med['B'] / med['A']:.4f}); median run s A {wall['A']:.2f}, B {wall['B']:.2f}; "
              f"tokens equal across all runs: {same} ({smi})", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

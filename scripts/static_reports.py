"""The static reports PERF.md quotes, on a CPU host (no card is touched):

1. perfscope's estimate of configs/config_2p7b_dp.yaml cut to one card at
   chip_smoke.py phase 4's shape (world 1, 2 microbatches of 2 x 4096), one
   train step walked on fake tensors, bucket by bucket, with its kernels;
2. `validate_recipe` of the three shipped recipes at world 64: this rank's
   bytes by kind against the budget (79.18 GiB, the memory of an NVIDIA H100
   80GB HBM3, 700.00 W).

    python scripts/static_reports.py [--out report.json]

Each report runs in a child process (the CLI's engines). The roofline times
are estimates from datasheet figures (telemetry/perfscope.py:HwSpec), not
measurements.
"""

from __future__ import annotations

import argparse
import json
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

RECIPES = ("config_2p7b_dp.yaml", "config_7b_tp_fsdp.yaml", "config_7b_warmstart_32k.yaml")
PHASE4 = {"device_mesh.config.data_parallel_shard_degree": 1, "device_mesh.config.world_size": 1,
          "settings.step_profile.local_train_micro_batch_size": 2,
          "settings.step_profile.gradient_accumulation_steps": 2,
          "settings.training_target.num_target_steps": 3, "settings.training_target.num_target_tokens": 3 * 4 * 4096,
          "settings.intervals.training_log_interval_in_steps": 1, "settings.intervals.evaluation_interval_in_steps": 3,
          "settings.intervals.checkpointing_interval_in_steps": 3}


def _one_card_2p7b(folder: Path) -> Path:
    import yaml

    cfg = yaml.safe_load((ROOT / "configs" / "config_2p7b_dp.yaml").read_text())
    for dotted, value in PHASE4.items():
        node = cfg
        *parents, leaf = dotted.split(".")
        for key in parents:
            node = node[key]
        node[leaf] = value
    path = folder / "config_2p7b_one_card.yaml"
    path.write_text(yaml.safe_dump(cfg, sort_keys=False))
    return path


def main() -> int:
    from modalities_tpu_torch.telemetry.perfscope import format_perfscope_table, run_perfscope_subprocess
    from modalities_tpu_torch.utils.recipe_validation import H100_HBM_BUDGET_BYTES, run_validation_subprocess

    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--out", type=Path, default=None, help="also write both reports as JSON here")
    args = parser.parse_args()
    with tempfile.TemporaryDirectory() as tmp:
        perf = run_perfscope_subprocess(_one_card_2p7b(Path(tmp)))
    print(format_perfscope_table(perf))
    step = perf["executables"]["train_step"]
    for o in step["buckets"]["custom_call"]["top_ops"]:
        print(f"  kernel {o['op']:<10} {o['calls']:>4} calls {o['flops'] / 1e9:>12.3f} GFLOP "
              f"{o['bytes'] / 1e6:>10.3f} MB est {o['est_time_s'] * 1e3:.4f} ms")
    recipes = {}
    for name in RECIPES:
        report = run_validation_subprocess(ROOT / "configs" / name, hbm_budget_bytes=H100_HBM_BUDGET_BYTES)
        recipes[name] = report
        d = report["per_device"]
        mesh = ", ".join(f"{k} {v}" for k, v in report["mesh"].items() if v > 1)
        print(f"{name}: world {report['world_size']} mesh {{{mesh}}}, "
              f"{report['num_params']:,} params, walk {report['lowering']}; per device GiB: params "
              f"{d['params_bytes'] / 1024**3:.3f}, optimizer {d['optimizer_bytes'] / 1024**3:.3f}, gradients "
              f"{d['gradient_bytes'] / 1024**3:.3f}, activations {d['activation_estimate']['total'] / 1024**3:.3f} "
              f"({d['activation_estimate']['remat_mode']}), total {d['total_gib']:.3f} of "
              f"{report['hbm_budget_bytes'] / 1024**3:.2f}: fits {report['fits_budget']}")
    if args.out is not None:
        args.out.write_text(json.dumps({"perfscope_2p7b_one_card": perf, "validate_recipe": recipes}, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())

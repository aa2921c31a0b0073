"""Sweep status tracking: the port's copy of
modalities_tpu/utils/benchmarking/benchmarking_utils.py. It reads the
`evaluation_results.jsonl` the port's `to_disc` subscriber writes under the
JAX keys, and the CLI's error records.

Scans experiment folders for ``evaluation_results.jsonl``, counts logged steps vs the
config's target, and classifies runs done / failed / remaining; optionally skips
configs that previously died with an out-of-memory error.
"""

from __future__ import annotations

import json
from pathlib import Path

OOM_MARKERS = ("RESOURCE_EXHAUSTED", "Out of memory", "out of memory")  # telemetry/memscope.py's


def _expected_log_lines(config: dict) -> int:
    try:
        settings = config["settings"]
        target = settings["training_target"]["num_target_steps"]
        seen = settings["training_progress"]["num_seen_steps"]
        interval = settings["intervals"]["training_log_interval_in_steps"]
        return (target - seen) // interval
    except KeyError:
        return -1


def _died_with_oom(run_dir: Path) -> bool:
    for error_file in run_dir.glob("error_rank_*.json"):
        try:
            record = json.loads(error_file.read_text())
            text = record.get("stacktrace", "") + record.get("error", "")
            if any(marker in text for marker in OOM_MARKERS):  # JAX's markers and torch's "CUDA out of memory"
                return True
        except (json.JSONDecodeError, OSError):
            continue
    return False


def _iter_train_records(run_dir: Path) -> list[dict]:
    """All train-tagged result records under a run dir. Malformed lines (a run
    killed mid-write leaves a truncated tail) are skipped, not fatal."""
    records: list[dict] = []
    for rf in run_dir.rglob("evaluation_results.jsonl"):
        for line in rf.read_text().splitlines():
            if not line.strip():
                continue
            try:
                rec = json.loads(line)
            except json.JSONDecodeError:
                continue
            if rec.get("dataloader_tag") == "train":
                records.append(rec)
    return records


def summarize_sweep_results(sweep_dir: Path) -> list[dict]:
    """Perf summary across a sweep (the scaling-experiments grid workflow,
    reference docs/scaling_experiments): for every run with results, report the
    peak and last tokens/s and MFU plus the final train loss, sorted by tokens/s."""
    rows: list[dict] = []
    for config_path in sorted(Path(sweep_dir).rglob("config.yaml")):
        run_dir = config_path.parent
        records = _iter_train_records(run_dir)
        if not records:
            continue
        tps = [r["throughput_metrics"].get("tokens/s") for r in records]
        tps = [t for t in tps if t is not None]
        mfu = [r["throughput_metrics"].get("MFU") for r in records]
        mfu = [m for m in mfu if m is not None]
        rows.append(
            {
                "run": str(run_dir),
                "steps_logged": len(records),
                "peak_tokens_per_s": max(tps) if tps else None,
                "last_tokens_per_s": tps[-1] if tps else None,
                "peak_mfu": max(mfu) if mfu else None,
                "final_train_loss": records[-1]["losses"].get("train loss avg"),
            }
        )
    rows.sort(key=lambda r: -(r["peak_tokens_per_s"] or 0.0))
    return rows


def get_updated_sweep_status(sweep_dir: Path, skip_oom_configs: bool = False) -> dict:
    sweep_dir = Path(sweep_dir)
    status: dict[str, list[str]] = {"done": [], "failed": [], "remaining": [], "skipped_oom": []}
    import yaml

    for config_path in sorted(sweep_dir.rglob("config.yaml")):
        run_dir = config_path.parent
        with open(config_path) as f:
            config = yaml.safe_load(f)
        expected = _expected_log_lines(config)
        logged = len(_iter_train_records(run_dir))
        if expected > 0 and logged >= expected:
            status["done"].append(str(run_dir))
        elif skip_oom_configs and _died_with_oom(run_dir):
            status["skipped_oom"].append(str(run_dir))
        elif logged > 0:
            status["failed"].append(str(run_dir))
        else:
            status["remaining"].append(str(run_dir))
    return status

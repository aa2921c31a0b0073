"""Benchmark-trajectory analysis: the port of
modalities_tpu/utils/benchmarking/trajectory.py (pure Python, copied so the
port imports nothing of the JAX package). `data check_slo
--trajectory_path` reads a folder of per-round artifacts through it.

A round's artifact is ``BENCH_r*.json`` ({"n", "cmd", "rc", "tail",
"parsed"}) or ``MULTICHIP_r*.json`` ({"n_devices", "rc", "ok", "skipped",
"tail"}). Each round is classified:

- ``ok``        the round produced a metric (BENCH) / passed (MULTICHIP)
- ``wedged``    rc=124 (the timeout killed it) or ``parsed: null`` with a
                tail that names a wedge
- ``oom``       the tail carries RESOURCE_EXHAUSTED
- ``no_metric`` rc=0 but nothing parsed and no wedge in the tail
- ``failed``    a nonzero rc other than the timeout's
- ``skipped``   the round declared itself not applicable
"""

from __future__ import annotations

import json
import re
from pathlib import Path
from typing import Optional

_ROUND_RE = re.compile(r"_r(\d+)\.json$")

_TIMEOUT_RC = 124  # a round run under `timeout` that ran out

# the probe's own wedge report in the artifact tail ("TPU probe attempt N
# wedged; retrying ...") — the rc depends on which layer gave up first, the
# tail marker does not
_WEDGE_TAIL_RE = re.compile(r"\bwedged\b", re.IGNORECASE)


def _round_of(path: Path) -> int:
    m = _ROUND_RE.search(path.name)
    return int(m.group(1)) if m else -1


def load_round_artifacts(folder: Path, prefix: str) -> list[dict]:
    """All `{prefix}_r*.json` artifacts under `folder`, sorted by round number,
    each as {"round", "path", "data"}. A torn/unreadable artifact still appears
    (data=None) — a round that crashed mid-write is itself a signal."""
    rounds = []
    for path in sorted(Path(folder).glob(f"{prefix}_r*.json"), key=_round_of):
        try:
            data = json.loads(path.read_text())
        except (OSError, json.JSONDecodeError):
            data = None
        rounds.append({"round": _round_of(path), "path": str(path), "data": data})
    return rounds


def _classify(data: Optional[dict], kind: str) -> str:
    if not isinstance(data, dict):
        return "failed"
    rc = data.get("rc")
    wedge_tail = bool(_WEDGE_TAIL_RE.search(data.get("tail") or ""))
    oom_tail = "RESOURCE_EXHAUSTED" in (data.get("tail") or "")
    if kind == "bench":
        if data.get("parsed") is not None:
            return "ok"
        if oom_tail:
            return "oom"
        if rc == _TIMEOUT_RC or wedge_tail:
            return "wedged"
        return "no_metric" if rc == 0 else "failed"
    # multichip
    if data.get("skipped"):
        return "skipped"
    if data.get("ok"):
        return "ok"
    if oom_tail:
        return "oom"
    return "wedged" if rc == _TIMEOUT_RC or wedge_tail else "failed"


def summarize_trajectory(folder) -> dict:
    """Fold the folder's BENCH/MULTICHIP round artifacts into trend rows plus a
    flags list naming every round that needs a human look."""
    folder = Path(folder)
    bench_rows = []
    for artifact in load_round_artifacts(folder, "BENCH"):
        data = artifact["data"] or {}
        parsed = data.get("parsed") if isinstance(data.get("parsed"), dict) else None
        detail = (parsed or {}).get("detail") or {}
        bench_rows.append(
            {
                "round": artifact["round"],
                "status": _classify(artifact["data"], "bench"),
                "rc": data.get("rc"),
                "metric": (parsed or {}).get("metric"),
                "value": (parsed or {}).get("value"),
                "unit": (parsed or {}).get("unit"),
                "vs_baseline": (parsed or {}).get("vs_baseline"),
                "config": detail.get("config"),
                "tokens_per_sec": detail.get("tokens_per_sec"),
                "device": detail.get("device"),
            }
        )
    multichip_rows = []
    for artifact in load_round_artifacts(folder, "MULTICHIP"):
        data = artifact["data"] or {}
        multichip_rows.append(
            {
                "round": artifact["round"],
                "status": _classify(artifact["data"], "multichip"),
                "rc": data.get("rc"),
                "n_devices": data.get("n_devices"),
            }
        )
    flags = []
    for row in bench_rows:
        if row["status"] != "ok":
            flags.append(
                f"BENCH r{row['round']}: {row['status']} (rc={row['rc']})"
            )
    for row in multichip_rows:
        if row["status"] not in ("ok", "skipped"):
            flags.append(
                f"MULTICHIP r{row['round']}: {row['status']} (rc={row['rc']})"
            )
    ok_values = [r["value"] for r in bench_rows if r["status"] == "ok" and r["value"] is not None]
    return {
        "bench": bench_rows,
        "multichip": multichip_rows,
        "flags": flags,
        "best_bench_value": max(ok_values) if ok_values else None,
    }


def format_trajectory_table(summary: dict) -> str:
    lines = []
    bench = summary.get("bench") or []
    if bench:
        lines.append(
            f"{'round':<6} {'status':<10} {'rc':>4} {'value':>9} {'vs_base':>8} "
            f"{'tokens/s':>9}  config"
        )
        for row in bench:
            value = f"{row['value']:.4g}" if row.get("value") is not None else "-"
            vsb = f"{row['vs_baseline']:.3f}" if row.get("vs_baseline") is not None else "-"
            tps = f"{row['tokens_per_sec']:.1f}" if row.get("tokens_per_sec") is not None else "-"
            lines.append(
                f"r{row['round']:<5} {row['status']:<10} {str(row['rc']):>4} "
                f"{value:>9} {vsb:>8} {tps:>9}  {row.get('config') or '-'}"
            )
    multichip = summary.get("multichip") or []
    if multichip:
        lines.append("")
        lines.append(f"{'round':<6} {'status':<10} {'rc':>4} {'devices':>8}")
        for row in multichip:
            lines.append(
                f"r{row['round']:<5} {row['status']:<10} {str(row['rc']):>4} "
                f"{str(row.get('n_devices') or '-'):>8}"
            )
    if not lines:
        return "no BENCH_r*/MULTICHIP_r* artifacts found"
    best = summary.get("best_bench_value")
    if best is not None:
        lines.append("")
        lines.append(f"best bench value: {best:.4g}")
    flags = summary.get("flags") or []
    if flags:
        lines.append("")
        lines.append("flagged rounds:")
        lines.extend(f"  {flag}" for flag in flags)
    return "\n".join(lines)

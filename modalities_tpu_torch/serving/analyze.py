"""Offline analysis of per-request serving trace records (`data
analyze_serve` and `data analyze_fleet`): the port of
modalities_tpu/serving/analyze.py.

Input: the per-rank telemetry JSONL sink(s) a serve run writes when
`MODALITIES_TPU_SERVE_TELEMETRY_DIR` is set (or any folder or file holding
`serve_request` records). Each record is one request's folded lifecycle:
latency summary fields plus the raw event stream on the engine's clock
(enqueue / admit / prefill_chunk / first_token / preempt / requeue /
finish, ...).

Output: p50/p95/p99 tables (TTFT, end-to-end, queue wait, mean TPOT), the
finish reasons, token / preemption / truncation totals, prefix-hit tokens
and the speculation acceptance, per weights generation and per tenant, and a
slot-occupancy timeline rebuilt from the admit -> (preempt | finish)
intervals: the offline counterpart of the live `/metrics` histograms, but
exact (per-request samples, not bucket interpolation). The fleet half joins
the routers' `fleet/request` records and the workers' `serve_request`
records on their trace id into one span tree per request.
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Iterable, Optional

QUANTILES = (0.50, 0.95, 0.99)

LATENCY_FIELDS = (
    ("ttft_s", "time to first token"),
    ("e2e_s", "end-to-end latency"),
    ("queue_wait_s", "queue wait"),
    ("tpot_mean_s", "mean time per output token"),
)


def load_serve_records(sink_path: Path) -> list[dict]:
    """Read `serve_request` records from one `telemetry_rank_N.jsonl` file or
    every such file in a folder. Non-serve events (spans, resilience, ...) are
    skipped, and so is a torn tail line — a sink from a killed run may end
    mid-write (same tolerance as `analyze_telemetry`)."""
    sink_path = Path(sink_path)
    if sink_path.is_dir():
        files = sorted(sink_path.glob("telemetry_rank_*.jsonl"))
        if not files:
            raise FileNotFoundError(f"no telemetry_rank_*.jsonl under {sink_path}")
    else:
        files = [sink_path]
    records: list[dict] = []
    for path in files:
        with open(path) as f:
            for line in f:
                line = line.strip()
                if not line:
                    continue
                try:
                    event = json.loads(line)
                except json.JSONDecodeError:
                    continue  # torn tail line from a killed run
                if event.get("event") == "serve_request":
                    records.append(event)
    return records


def _quantile(sorted_values: list[float], q: float) -> float:
    """Linear-interpolation quantile over EXACT per-request samples (matches
    numpy's default method; avoids importing numpy for a CLI table)."""
    n = len(sorted_values)
    if n == 1:
        return sorted_values[0]
    pos = q * (n - 1)
    lo = int(pos)
    hi = min(lo + 1, n - 1)
    frac = pos - lo
    return sorted_values[lo] * (1.0 - frac) + sorted_values[hi] * frac


def _occupancy_timeline(records: Iterable[dict], max_points: int = 40) -> list[dict]:
    """Concurrent-requests-over-time rebuilt from each record's admit→exit
    intervals (exit = the matching preempt or the finish). Returned as step
    points (t, active), downsampled to at most `max_points` rows."""
    deltas: list[tuple[float, int]] = []
    for rec in records:
        open_t: Optional[float] = None
        for ev in rec.get("events", ()):
            name, t = ev.get("name"), float(ev.get("t", 0.0))
            if name == "admit":
                open_t = t
            elif name in ("preempt", "finish") and open_t is not None:
                deltas.append((open_t, +1))
                deltas.append((t, -1))
                open_t = None
    if not deltas:
        return []
    deltas.sort()
    points: list[dict] = []
    active = 0
    for t, d in deltas:
        active += d
        if points and points[-1]["t"] == t:
            points[-1]["active"] = active
        else:
            points.append({"t": round(t, 6), "active": active})
    if len(points) > max_points:
        stride = (len(points) + max_points - 1) // max_points
        sampled = points[::stride]
        if sampled[-1] is not points[-1]:
            sampled.append(points[-1])
        points = sampled
    return points


def summarize_serve(records: list[dict]) -> dict:
    """Fold records into the summary dict `format_serve_table` renders (and
    `--as_json` emits verbatim)."""
    if not records:
        return {"requests": 0}
    reasons: dict[str, int] = {}
    for rec in records:
        reason = rec.get("finish_reason") or "?"
        reasons[reason] = reasons.get(reason, 0) + 1
    latency: dict[str, dict] = {}
    for field, _ in LATENCY_FIELDS:
        values = sorted(
            float(rec[field]) for rec in records if rec.get(field) is not None
        )
        if not values:
            continue
        latency[field] = {
            "n": len(values),
            "mean": sum(values) / len(values),
            **{f"p{int(q * 100)}": _quantile(values, q) for q in QUANTILES},
        }
    spec_proposed = sum(int(rec.get("spec_proposed") or 0) for rec in records)
    spec_accepted = sum(int(rec.get("spec_accepted") or 0) for rec in records)
    # fleet hot swaps: per-weights-generation breakdown (requests, errors,
    # TTFT p50) — the offline view of a canary's probation window
    generations: dict[int, dict] = {}
    for rec in records:
        gen = int(rec.get("weights_generation") or 0)
        bucket = generations.setdefault(
            gen, {"requests": 0, "errors": 0, "_ttfts": []}
        )
        bucket["requests"] += 1
        if rec.get("finish_reason") == "error":
            bucket["errors"] += 1
        if rec.get("ttft_s") is not None:
            bucket["_ttfts"].append(float(rec["ttft_s"]))
    for bucket in generations.values():
        ttfts = sorted(bucket.pop("_ttfts"))
        bucket["ttft_p50_s"] = _quantile(ttfts, 0.5) if ttfts else None
    # multi-tenant serving: per-tenant breakdown from the tenant tag
    # each record carries; records from a tenant-off run (no tag) fold into
    # the implicit "-" row so mixed sinks still sum to the totals
    tenants: dict[str, dict] = {}
    for rec in records:
        name = str(rec.get("tenant") or "-")
        bucket = tenants.setdefault(
            name,
            {"requests": 0, "errors": 0, "sheds": 0, "preemptions": 0, "_ttfts": []},
        )
        bucket["requests"] += 1
        reason = rec.get("finish_reason")
        if reason == "error":
            bucket["errors"] += 1
        if reason == "shed":
            bucket["sheds"] += 1
        bucket["preemptions"] += int(rec.get("preemptions") or 0)
        if rec.get("ttft_s") is not None:
            bucket["_ttfts"].append(float(rec["ttft_s"]))
    for bucket in tenants.values():
        ttfts = sorted(bucket.pop("_ttfts"))
        bucket["ttft_p50_s"] = _quantile(ttfts, 0.5) if ttfts else None
        bucket["ttft_p99_s"] = _quantile(ttfts, 0.99) if ttfts else None
    return {
        "requests": len(records),
        "finish_reasons": dict(sorted(reasons.items())),
        "prompt_tokens": sum(int(rec.get("prompt_len") or 0) for rec in records),
        "generated_tokens": sum(int(rec.get("tokens") or 0) for rec in records),
        "preemptions": sum(int(rec.get("preemptions") or 0) for rec in records),
        "truncated_requests": sum(1 for rec in records if rec.get("truncated")),
        # prompt tokens served from shared prefix blocks, and the
        # spec-decode acceptance ratio (accepted drafts / proposed drafts)
        "prefix_hit_tokens": sum(
            int(rec.get("prefix_hit_tokens") or 0) for rec in records
        ),
        "spec_proposed": spec_proposed,
        "spec_accepted": spec_accepted,
        "spec_acceptance": (spec_accepted / spec_proposed) if spec_proposed else None,
        # fleet hot swaps: which weights generation served each request
        "generations": {gen: generations[gen] for gen in sorted(generations)},
        # multi-tenant serving: per-tenant requests/errors/sheds/preemptions
        "tenants": {name: tenants[name] for name in sorted(tenants)},
        "latency": latency,
        "occupancy_timeline": _occupancy_timeline(records),
    }


def format_serve_table(summary: dict) -> str:
    if not summary.get("requests"):
        return "no serve_request records found"
    lines = [
        f"requests: {summary['requests']}  "
        f"prompt_tokens: {summary['prompt_tokens']}  "
        f"generated_tokens: {summary['generated_tokens']}",
        f"preemptions: {summary['preemptions']}  "
        f"truncated: {summary['truncated_requests']}  "
        f"prefix_hit_tokens: {summary.get('prefix_hit_tokens', 0)}",
    ]
    acceptance = summary.get("spec_acceptance")
    if acceptance is not None:
        lines.append(
            f"spec_decode: accepted {summary['spec_accepted']} / "
            f"proposed {summary['spec_proposed']} "
            f"(acceptance {acceptance:.3f})"
        )
    lines += ["", "finish reasons:"]
    for reason, count in summary["finish_reasons"].items():
        lines.append(f"  {reason:<10} {count}")
    generations = summary.get("generations") or {}
    if len(generations) > 1 or any(int(g) != 0 for g in generations):
        lines += ["", f"{'weights gen':<12} {'requests':>9} {'errors':>7} {'ttft_p50':>9}"]
        for gen, row in generations.items():
            ttft = f"{row['ttft_p50_s']:.4f}" if row.get("ttft_p50_s") is not None else "-"
            lines.append(
                f"{gen:<12} {row['requests']:>9} {row['errors']:>7} {ttft:>9}"
            )
    tenants = summary.get("tenants") or {}
    if len(tenants) > 1 or any(name != "-" for name in tenants):
        lines += [
            "",
            f"{'tenant':<14} {'requests':>9} {'errors':>7} {'sheds':>6} "
            f"{'preempts':>9} {'ttft_p50':>9} {'ttft_p99':>9}",
        ]
        for name, row in tenants.items():
            p50 = f"{row['ttft_p50_s']:.4f}" if row.get("ttft_p50_s") is not None else "-"
            p99 = f"{row['ttft_p99_s']:.4f}" if row.get("ttft_p99_s") is not None else "-"
            lines.append(
                f"{name:<14} {row['requests']:>9} {row['errors']:>7} "
                f"{row['sheds']:>6} {row['preemptions']:>9} {p50:>9} {p99:>9}"
            )
    lines += ["", f"{'latency':<14} {'n':>5} {'mean':>9} {'p50':>9} {'p95':>9} {'p99':>9}"]
    for field, label in LATENCY_FIELDS:
        row = summary["latency"].get(field)
        if row is None:
            continue
        lines.append(
            f"{field:<14} {row['n']:>5} "
            f"{row['mean']:>9.4f} {row['p50']:>9.4f} {row['p95']:>9.4f} {row['p99']:>9.4f}"
        )
    timeline = summary.get("occupancy_timeline") or []
    if timeline:
        peak = max(p["active"] for p in timeline)
        lines += ["", f"occupancy timeline (active requests over engine time, peak {peak}):"]
        width = 40
        for p in timeline:
            bar = "#" * (p["active"] * width // max(peak, 1))
            lines.append(f"  {p['t']:>9.3f}s {p['active']:>3} {bar}")
    return "\n".join(lines)


# ------------------------------------------------------------- fleet tracing
# Cross-tier stitching: the router's `fleet/request` record and every
# worker's `serve_request` records share one trace_id — joining on it turns
# "request latency spike" from a per-tier grep into ONE span tree per request.


def _iter_jsonl(path: Path) -> Iterable[dict]:
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            try:
                yield json.loads(line)
            except json.JSONDecodeError:
                continue  # torn tail line from a killed run


def load_fleet_records(sink_paths: Iterable[Path]) -> dict:
    """Read router + worker sinks (files or folders of `telemetry_rank_*.jsonl`
    / `*.jsonl`) into the three record streams the stitcher joins:
    {"fleet_requests", "failovers", "serve_requests"}."""
    files: list[Path] = []
    for sink_path in sink_paths:
        sink_path = Path(sink_path)
        if sink_path.is_dir():
            # a sinkless folder (run died pre-flush, or the wrong --sink_path
            # of several) contributes nothing — the stitcher renders a clean
            # "no records" tree instead of crashing the whole analysis
            files.extend(sorted(sink_path.glob("*.jsonl")))
        elif sink_path.exists():
            files.append(sink_path)
    out = {"fleet_requests": [], "failovers": [], "serve_requests": []}
    for path in files:
        for event in _iter_jsonl(path):
            kind = event.get("event")
            if kind == "serve_request":
                out["serve_requests"].append(event)
            elif kind == "resilience" and event.get("name") == "fleet/request":
                out["fleet_requests"].append(event)
            elif kind == "resilience" and event.get("name") == "fleet/failover":
                out["failovers"].append(event)
    return out


def stitch_fleet_traces(records: dict) -> list[dict]:
    """Join the three streams on trace_id into one span tree per request:
    {"trace_id", "router": fleet/request record or None, "failovers": [...],
    "worker_legs": serve_request records sorted by hop}. Traces seen by only
    one tier still appear (router-only: the worker sink wasn't collected;
    worker-only: a direct client bypassed the router)."""
    traces: dict[str, dict] = {}

    def entry(trace_id: str) -> dict:
        return traces.setdefault(
            trace_id,
            {"trace_id": trace_id, "router": None, "failovers": [], "worker_legs": []},
        )

    for rec in records.get("fleet_requests", ()):
        tid = rec.get("trace_id")
        if tid:
            entry(tid)["router"] = rec
    for rec in records.get("failovers", ()):
        tid = rec.get("trace_id")
        if tid:
            entry(tid)["failovers"].append(rec)
    for rec in records.get("serve_requests", ()):
        tid = rec.get("trace_id")
        if tid:
            entry(tid)["worker_legs"].append(rec)
    for trace in traces.values():
        trace["worker_legs"].sort(key=lambda r: (int(r.get("hop") or 0), r.get("rid", 0)))
    # stable order: router traces first, slowest e2e leading (the latency-spike
    # triage order), then router-less traces by first worker arrival
    def sort_key(trace: dict):
        router = trace["router"]
        if router is not None:
            return (0, -float(router.get("e2e_s") or 0.0))
        legs = trace["worker_legs"]
        return (1, float(legs[0].get("arrival_s") or 0.0) if legs else 0.0)

    return sorted(traces.values(), key=sort_key)


def format_fleet_trace_tree(traces: list[dict]) -> str:
    """Render stitched traces as one indented span tree per request."""
    if not traces:
        return "no fleet/request or serve_request records found"
    lines: list[str] = []
    for trace in traces:
        router = trace["router"]
        if router is not None:
            lines.append(
                f"trace {trace['trace_id']}  outcome={router.get('outcome')}  "
                f"e2e={float(router.get('e2e_s') or 0.0):.4f}s  "
                f"forwarded_tokens={router.get('forwarded_tokens')}"
            )
            for leg in router.get("legs") or ():
                # disagg routers tag each leg with its tier: the prefill and
                # decode halves of one answer render as separate spans
                tier = f"  tier={leg['tier']}" if leg.get("tier") else ""
                lines.append(
                    f"  router leg hop={leg.get('hop')}  worker={leg.get('worker')}"
                    f"{tier}  outcome={leg.get('outcome')}  "
                    f"forwarded_tokens={leg.get('forwarded_tokens')}"
                )
        else:
            lines.append(f"trace {trace['trace_id']}  (no router record)")
        for rec in trace["worker_legs"]:
            # tiered engines stamp their role into the request record; a
            # combined engine's record stays the bare "worker leg"
            kind = f"{rec['role']} leg" if rec.get("role") else "worker leg"
            row = (
                f"  {kind} hop={rec.get('hop')}  rid={rec.get('rid')}  "
                f"finish={rec.get('finish_reason')}  tokens={rec.get('tokens')}"
            )
            if rec.get("ttft_s") is not None:
                row += f"  ttft={float(rec['ttft_s']):.4f}s"
            lines.append(row)
        for rec in trace["failovers"]:
            lines.append(
                f"  failover off {rec.get('worker')} after "
                f"{rec.get('forwarded_tokens')} forwarded tokens"
            )
        lines.append("")
    return "\n".join(lines).rstrip()

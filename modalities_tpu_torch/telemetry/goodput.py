"""Goodput ledger: attribute every wall-clock second of a run to one bucket.
The port of modalities_tpu/telemetry/goodput.py (the ledger and the sink
replay; the `analyze_telemetry` tables wait for ROADMAP.md Queue 1 item 6).

Buckets: ``init``, ``compile_first_step``, ``train_step`` (the goodput
numerator), ``data_stall``, ``eval``, ``checkpoint``, ``publish``,
``recovery``, ``serve`` and ``other``. A span's first path segment picks its
bucket (``serve/decode`` -> ``serve``).

The ledger consumes the exclusive time (``self_s``) of *timeline-thread*
spans only, so every second of the step loop's wall time lands in at most one
bucket; ``summary()`` folds the untracked remainder into ``other``, so the
buckets sum to the wall time by construction. ``goodput_pct`` = 100 *
train_step / wall.
"""

from __future__ import annotations

import json
import threading
import time
from pathlib import Path
from typing import Iterable, Optional, Union

from modalities_tpu_torch.telemetry.spans import SpanRecord

BUCKETS = (
    "init",
    "compile_first_step",
    "train_step",
    "data_stall",
    "eval",
    "checkpoint",
    "publish",
    "recovery",
    "serve",
    "other",
)

# span name (first path segment) -> bucket
_NAME_TO_BUCKET = {
    "init": "init",
    "build_components": "init",
    "state_init": "init",
    "checkpoint_restore": "init",
    "first_step": "compile_first_step",
    "train_step": "train_step",
    "metrics_fetch": "train_step",
    "data_wait": "data_stall",
    "eval": "eval",
    "checkpoint": "checkpoint",
    "checkpoint_save": "checkpoint",
    "checkpoint_drain": "checkpoint",
    "publish": "publish",
    "preempt": "recovery",
    "ckpt_retry": "recovery",
    "anomaly": "recovery",
    "rollback": "recovery",
    "recovery": "recovery",
    "heartbeat": "recovery",
    "consensus": "recovery",
    # serving engine (serving/engine.py): "serve/prefill", "serve/decode",
    # "serve/admission" all land in one bucket — decode-step seconds over total
    # serve seconds is the engine's goodput
    "serve": "serve",
}


def bucket_of(span_name: str) -> str:
    """Spans may namespace with '/' (e.g. "eval/val_loader"); the first segment
    decides the bucket."""
    return _NAME_TO_BUCKET.get(span_name.split("/", 1)[0], "other")


class GoodputLedger:
    """Thread-safe accumulator from the span stream (or direct `add_seconds`,
    for callers that time segments without span machinery)."""

    def __init__(self):
        self._lock = threading.Lock()
        self._seconds = {bucket: 0.0 for bucket in BUCKETS}
        self._t0 = time.perf_counter()

    def start(self) -> None:
        """(Re)set the wall-clock origin used by `wall_s()`."""
        self._t0 = time.perf_counter()

    def wall_s(self) -> float:
        return time.perf_counter() - self._t0

    def add_record(self, record: SpanRecord) -> None:
        if not record.timeline:
            return  # background threads overlap the main timeline
        self.add_seconds(bucket_of(record.name), record.self_s)

    def add_seconds(self, bucket: str, seconds: float) -> None:
        if bucket not in self._seconds:
            bucket = "other"
        with self._lock:
            self._seconds[bucket] += seconds

    def bucket_seconds(self) -> dict[str, float]:
        with self._lock:
            return dict(self._seconds)

    def summary(self, wall_s: Optional[float] = None) -> dict:
        """{"wall_s", "goodput_pct", "buckets": {bucket: seconds}} with the
        untracked remainder folded into "other" so the buckets sum to wall_s."""
        if wall_s is None:
            wall_s = self.wall_s()
        buckets = self.bucket_seconds()
        tracked = sum(buckets.values())
        buckets["other"] += max(0.0, wall_s - tracked)
        goodput_pct = 100.0 * buckets["train_step"] / wall_s if wall_s > 0 else 0.0
        return {
            "wall_s": round(wall_s, 6),
            "goodput_pct": round(goodput_pct, 3),
            "buckets": {bucket: round(seconds, 6) for bucket, seconds in buckets.items()},
        }


# ------------------------------------------------------------------ sink analysis
# Offline replay of one or more JSONL sink files into per-rank goodput summaries
# (the `analyze_telemetry` CLI and cross-rank aggregation path).


def _iter_sink_events(path: Path) -> Iterable[dict]:
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            try:
                yield json.loads(line)
            except json.JSONDecodeError:
                continue  # a torn tail line from a killed run must not sink the analysis


def summarize_sink(path: Union[str, Path]) -> dict:
    """Summarize a telemetry sink — a single `telemetry_rank_N.jsonl` file or the
    folder holding them — into per-rank goodput summaries.

    Returns {"ranks": {rank: summary}, "combined": summary-averaged-over-ranks}.
    """
    path = Path(path)
    files = sorted(path.glob("telemetry_rank_*.jsonl")) if path.is_dir() else [path]
    files = [file for file in files if file.exists()]

    ranks: dict[int, dict] = {}
    for file in files:
        ledger = GoodputLedger()
        rank = 0
        t_min = t_max = None
        for event in _iter_sink_events(file):
            rank = int(event.get("rank", rank))
            if event.get("event") == "span":
                ledger.add_record(
                    SpanRecord(
                        name=event.get("name", "other"),
                        ts=float(event.get("ts", 0.0)),
                        dur_s=float(event.get("dur_s", 0.0)),
                        self_s=float(event.get("self_s", 0.0)),
                        thread=event.get("thread", "?"),
                        timeline=bool(event.get("timeline", False)),
                    )
                )
                t0 = float(event.get("ts", 0.0))
                t1 = t0 + float(event.get("dur_s", 0.0))
                t_min = t0 if t_min is None else min(t_min, t0)
                t_max = t1 if t_max is None else max(t_max, t1)
            elif event.get("event") == "run_summary" and "wall_s" in event:
                # prefer the run's own wall clock when the sink recorded one
                t_min, t_max = 0.0, float(event["wall_s"])
        wall_s = (t_max - t_min) if (t_min is not None and t_max is not None) else 0.0
        ranks[rank] = ledger.summary(wall_s=wall_s)

    if not ranks:
        # an empty/missing sink (run died before the first flush) analyzes to a
        # clean zero summary, not a crash — the CLIs print "no records" tables
        empty = GoodputLedger().summary(wall_s=0.0)
        return {"ranks": {}, "combined": empty}

    n = len(ranks)
    combined = {
        "wall_s": round(sum(s["wall_s"] for s in ranks.values()) / n, 6),
        "goodput_pct": round(sum(s["goodput_pct"] for s in ranks.values()) / n, 3),
        "buckets": {
            bucket: round(sum(s["buckets"][bucket] for s in ranks.values()) / n, 6)
            for bucket in BUCKETS
        },
    }
    return {"ranks": ranks, "combined": combined}

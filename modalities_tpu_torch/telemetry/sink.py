"""Per-rank JSONL telemetry sink: the port of modalities_tpu/telemetry/sink.py.

Every event is written AND flushed at once, so a run killed mid-way still
leaves its record up to the kill. The record layout and the file names are
the JAX package's (`telemetry_rank_<rank>.jsonl`; rank 0 also writes
`goodput_summary.json` at close), so its readers read the port's sinks.
"""

from __future__ import annotations

import json
import threading
import time
from pathlib import Path
from typing import Optional

from modalities_tpu_torch.telemetry.spans import SpanRecord


class TelemetrySink:
    def __init__(self, output_folder_path: Path, global_rank: int = 0):
        self.global_rank = global_rank
        self.folder = Path(output_folder_path)
        self.folder.mkdir(parents=True, exist_ok=True)
        self.path = self.folder / f"telemetry_rank_{global_rank}.jsonl"
        self._lock = threading.Lock()
        self._file = open(self.path, "w")

    def emit(self, event: dict) -> None:
        line = json.dumps({"rank": self.global_rank, **event})
        with self._lock:
            if self._file.closed:
                return  # a straggler background span after close is not an error
            self._file.write(line + "\n")
            self._file.flush()

    def emit_span(self, record: SpanRecord) -> None:
        self.emit(
            {
                "event": "span",
                "name": record.name,
                "ts": round(record.ts, 6),
                "dur_s": round(record.dur_s, 6),
                "self_s": round(record.self_s, 6),
                "thread": record.thread,
                "timeline": record.timeline,
            }
        )

    def close(self, run_summary: Optional[dict] = None) -> None:
        if run_summary is not None:
            self.emit({"event": "run_summary", "wall_time": time.time(), **run_summary})
            if self.global_rank == 0:
                with open(self.folder / "goodput_summary.json", "w") as f:
                    json.dump(run_summary, f, indent=1)
        with self._lock:
            if not self._file.closed:
                self._file.close()

"""Telemetry: spans, the goodput ledger, the hang watchdog and the JSONL
sink behind one object. The port of modalities_tpu/telemetry/__init__.py.

One `Telemetry` object per process composes the four parts:

- `spans.SpanRecorder`: host phases as spans (torch profiler ranges while a
  profile records)
- `goodput.GoodputLedger`: every wall second classified into a bucket
- `watchdog.Watchdog`: a heartbeat per step or dispatch; a wedged one dumps
  a crash artifact
- `sink.TelemetrySink`: the per-rank, always-flushed JSONL event stream

plus `metrics`, the process's one scrape surface (telemetry/metrics.py):
the serving engine and its HTTP front end register into it unless given a
registry of their own. Deep call sites use the module-level `span("name")`,
which routes to the process-global active telemetry (`set_active_telemetry`);
with none active every call is an allocation-free no-op, so library code
never guards its telemetry calls.

The training publish paths (`publish_mfu_waterfall`,
`publish_memory_timeline`, `publish_memscope_report`,
`publish_resource_gauges`, `throughput_metrics`, `observe_step_time`) raise
NotImplementedError naming ROADMAP.md Queue 1 item 6: the trainer's
telemetry is that item's part 2 (with it the JAX constructor's `slo`, the
trainer's SLO engine, which this one does not take).
"""

from __future__ import annotations

import os
import tempfile
from pathlib import Path
from typing import Callable, Optional, Union

from modalities_tpu_torch.telemetry.goodput import GoodputLedger
from modalities_tpu_torch.telemetry.metrics import MetricsRegistry
from modalities_tpu_torch.telemetry.sink import TelemetrySink
from modalities_tpu_torch.telemetry.spans import NULL_CONTEXT, SpanRecorder, step_trace_annotation
from modalities_tpu_torch.telemetry.watchdog import Watchdog


def _default_rank() -> int:
    try:
        return int(os.environ["RANK"])
    except (KeyError, ValueError):
        pass
    import torch.distributed as dist

    return dist.get_rank() if dist.is_available() and dist.is_initialized() else 0


def _training_only(what: str):
    raise NotImplementedError(f"Telemetry.{what}: the trainer's telemetry is not in the port yet "
                              "(ROADMAP.md, Queue 1 item 6)")


class Telemetry:
    """Facade over recorder + ledger + watchdog + sink.

    `enabled=False` is the fast path: `span()`/`step_annotation()` return a
    shared no-op context manager and every other method returns at once,
    safe to call unconditionally from hot loops. Spans are torch profiler
    ranges while a profile records."""

    def __init__(
        self,
        enabled: bool = True,
        output_folder_path: Optional[Union[str, Path]] = None,
        watchdog_deadline_s: float = 1800.0,
        watchdog_first_step_factor: float = 4.0,
        global_rank: Optional[int] = None,
    ):
        self.enabled = enabled
        self.watchdog_deadline_s = float(watchdog_deadline_s)
        self.watchdog_first_step_factor = float(watchdog_first_step_factor)
        self._sink: Optional[TelemetrySink] = None
        self._watchdog: Optional[Watchdog] = None
        self._pending_state_providers: list[Callable[[], dict]] = []
        self._folder: Optional[Path] = None
        # one scrape surface a process, present even when disabled so
        # instrumented code never guards its metric calls
        self.metrics = MetricsRegistry()
        self.ledger = GoodputLedger()  # inert when disabled, but summary() stays callable
        if not enabled:
            self.global_rank = 0
            self._recorder = None
            return
        self.global_rank = _default_rank() if global_rank is None else global_rank
        self._recorder = SpanRecorder(on_record=self._on_record)
        if output_folder_path is not None:
            self.set_output_folder(output_folder_path)

    # ------------------------------------------------------------------ spans

    def span(self, name: str):
        if not self.enabled:
            return NULL_CONTEXT
        return self._recorder.span(name)

    def step_annotation(self, step_id: int):
        if not self.enabled:
            return NULL_CONTEXT
        return step_trace_annotation(step_id)

    def set_timeline_thread(self) -> None:
        """Mark the CALLING thread as the step-loop timeline (the ledger's source)."""
        if self.enabled:
            self._recorder.set_timeline_thread()

    def _on_record(self, record) -> None:
        self.ledger.add_record(record)
        if self._sink is not None:
            self._sink.emit_span(record)

    # ------------------------------------------------------------------- sink

    def set_output_folder(self, output_folder_path: Union[str, Path]) -> None:
        """Open the JSONL sink (idempotent). Watchdog artifacts land in the
        same folder."""
        if not self.enabled or self._sink is not None:
            return
        self._folder = Path(output_folder_path)
        self._sink = TelemetrySink(self._folder, global_rank=self.global_rank)
        if self._watchdog is not None:
            self._watchdog.artifact_dir = self._folder

    @property
    def sink_path(self) -> Optional[Path]:
        return self._sink.path if self._sink is not None else None

    def emit_event(self, name: str, payload: Optional[dict] = None) -> None:
        """A named point event (slo/*, fleet/*, serve/*, ...) to the JSONL
        sink. No-op when disabled or before the sink is open."""
        if not self.enabled or self._sink is None:
            return
        self._sink.emit({"event": "resilience", "name": name, **(payload or {})})

    def emit_serve_trace(self, record: dict) -> None:
        """One request's serving lifecycle record (`event: "serve_request"`),
        the `data analyze_serve` input. No-op when disabled or before the sink
        is open."""
        if not self.enabled or self._sink is None:
            return
        self._sink.emit({"event": "serve_request", **record})

    # --------------------------------------------------------------- watchdog

    def _ensure_watchdog(self) -> Optional[Watchdog]:
        if not self.enabled or self.watchdog_deadline_s <= 0:
            return None
        if self._watchdog is None:
            artifact_dir = self._folder or Path(tempfile.gettempdir()) / "modalities_tpu_telemetry"
            self._watchdog = Watchdog(
                deadline_s=self.watchdog_deadline_s,
                artifact_dir=artifact_dir,
                global_rank=self.global_rank,
                # a hang artifact carries the live scrape surface too
                metrics_provider=self.metrics.snapshot,
            )
            for provider in self._pending_state_providers:
                self._watchdog.register_state_provider(provider)
            self._pending_state_providers.clear()
            self._watchdog.start()
        return self._watchdog

    def arm_watchdog(self, step_id: int, first_step: bool = False) -> None:
        watchdog = self._ensure_watchdog()
        if watchdog is None:
            return
        deadline_s = self.watchdog_deadline_s * (self.watchdog_first_step_factor if first_step else 1.0)
        watchdog.arm(step_id, deadline_s=deadline_s)

    def beat_watchdog(self, step_id: int) -> None:
        if self._watchdog is not None:
            self._watchdog.beat(step_id)

    def disarm_watchdog(self) -> None:
        if self._watchdog is not None:
            self._watchdog.disarm()

    def register_watchdog_state_provider(self, provider: Callable[[], dict]) -> None:
        if not self.enabled:
            return
        if self._watchdog is not None:
            self._watchdog.register_state_provider(provider)
        else:
            self._pending_state_providers.append(provider)

    @property
    def watchdog_artifacts(self) -> list[Path]:
        return list(self._watchdog.fired_artifacts) if self._watchdog is not None else []

    # ---------------------------------------------------------------- goodput

    def goodput_summary(self) -> dict:
        return self.ledger.summary()

    def publish_resource_gauges(self, hbm_headroom_mb: Optional[float] = None,
                                peak_memory_mb: Optional[float] = None) -> None:
        _training_only("publish_resource_gauges")

    def throughput_metrics(self) -> dict[str, float]:
        _training_only("throughput_metrics")

    def publish_mfu_waterfall(self, mfu_achieved: float, collective_frac: Optional[float] = None,
                              dcn_collective_frac: Optional[float] = None) -> Optional[dict]:
        _training_only("publish_mfu_waterfall")

    def observe_step_time(self, seconds: float, step_id: Optional[int] = None) -> None:
        _training_only("observe_step_time")

    def publish_memory_timeline(self, sample: dict) -> None:
        _training_only("publish_memory_timeline")

    def publish_memscope_report(self, report: dict, executable: str = "train_step") -> None:
        _training_only("publish_memscope_report")

    # -------------------------------------------------------------- lifecycle

    def close(self) -> None:
        """Stop the watchdog and seal the sink with a run summary.
        Idempotent; safe on the exception path."""
        if self._watchdog is not None:
            self._watchdog.stop()
        if self._sink is not None:
            self._sink.close(run_summary=self.goodput_summary())


# -------------------------------------------------------- process-global routing

NOOP_TELEMETRY = Telemetry(enabled=False)
_active: Telemetry = NOOP_TELEMETRY


def get_active_telemetry() -> Telemetry:
    return _active


def set_active_telemetry(telemetry: Optional[Telemetry]) -> Telemetry:
    """Install the process-global telemetry (None -> the no-op). Returns the
    previous one, so callers restore it in a finally block."""
    global _active
    previous = _active
    _active = telemetry if telemetry is not None else NOOP_TELEMETRY
    return previous


def span(name: str):
    """`with span("checkpoint_save"): ...` against the active telemetry."""
    return _active.span(name)

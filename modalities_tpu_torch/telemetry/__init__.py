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

The training publish paths feed the same registry and sink: the goodput
gauges and bucket detectors (`throughput_metrics`), the MFU waterfall
(`publish_mfu_waterfall`, telemetry/waterfall.py), the step-time detector
(`observe_step_time`, telemetry/perfscope.py), the device-memory gauges and
memscope's timeline and static buckets. `slo=` builds the trainer's SLO
engine (telemetry/slo.py), sampled at each interval publish. The registry
component ("telemetry", "default") takes JAX's `TelemetryConfig`
(`build_telemetry`); `Main` builds a default one when the config has none.
"""

from __future__ import annotations

import dataclasses
import os
import tempfile
from pathlib import Path
from typing import Callable, Optional, Union

from modalities_tpu_torch.config.config import check_bool, check_dict, check_float, check_int
from modalities_tpu_torch.telemetry.goodput import BUCKETS, GoodputLedger
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


class Telemetry:
    """Facade over recorder + ledger + watchdog + sink.

    `enabled=False` is the fast path: `span()`/`step_annotation()` return a
    shared no-op context manager and every other method returns at once,
    safe to call unconditionally from hot loops. Spans are torch profiler
    ranges while a profile records, unless `profiler_annotations` is off
    (JAX: `use_jax_annotations`)."""

    def __init__(
        self,
        enabled: bool = True,
        output_folder_path: Optional[Union[str, Path]] = None,
        watchdog_deadline_s: float = 1800.0,
        watchdog_first_step_factor: float = 4.0,
        profiler_annotations: bool = True,
        global_rank: Optional[int] = None,
        anomaly_zscore: float = 6.0,
        anomaly_window: int = 64,
        slo: Optional[dict] = None,
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
        # step-time / goodput-bucket anomaly detection: robust-z detectors, built lazily
        self.anomaly_zscore = float(anomaly_zscore)
        self.anomaly_window = int(anomaly_window)
        self._step_time_detector = None
        self._bucket_detectors: dict[str, object] = {}
        self._last_bucket_seconds: dict[str, float] = {}
        # the trainer's SLO engine: None keeps every publish path free of SLO work
        self.slo_engine = None
        if not enabled:
            self.global_rank = 0
            self._recorder = None
            return
        self.global_rank = _default_rank() if global_rank is None else global_rank
        self._recorder = SpanRecorder(on_record=self._on_record, profiler_annotations=profiler_annotations)
        if output_folder_path is not None:
            self.set_output_folder(output_folder_path)
        if slo:
            # built but NOT started: the trainer samples it at each interval publish, so training verdicts
            # are deterministic per interval (serving paths start their own sampler threads instead)
            from modalities_tpu_torch.telemetry.slo import SLOEngine, load_slo_spec

            objectives, options = load_slo_spec(slo)
            self.slo_engine = SLOEngine(objectives, self.metrics, **options)

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

    def throughput_metrics(self) -> dict[str, float]:
        """Cumulative goodput metrics for the interval publish: goodput % plus
        per-bucket seconds. Empty when disabled (publishers skip cleanly)."""
        if not self.enabled:
            return {}
        summary = self.ledger.summary()
        metrics = {"goodput [%]": summary["goodput_pct"]}
        for bucket in BUCKETS:
            metrics[f"goodput/{bucket} [s]"] = summary["buckets"][bucket]
        # same numbers onto the Prometheus scrape surface: one job covers both
        # training and serving workloads
        self.metrics.gauge(
            "training_goodput_ratio", "Fraction of wall time spent in train_step"
        ).set(summary["goodput_pct"] / 100.0)
        bucket_gauge = self.metrics.gauge(
            "training_goodput_bucket_seconds",
            "Cumulative wall seconds attributed to each goodput bucket",
        )
        for bucket in BUCKETS:
            bucket_gauge.set(summary["buckets"][bucket], bucket=bucket)
        self._observe_bucket_deltas(summary["buckets"])
        return metrics

    def publish_mfu_waterfall(
        self,
        mfu_achieved: float,
        collective_frac: Optional[float] = None,
        dcn_collective_frac: Optional[float] = None,
    ) -> Optional[dict]:
        """Decompose the cumulative wall-clock MFU against the goodput ledger
        (telemetry/waterfall.py) and publish: `training_mfu_achieved` plus one
        `training_mfu_waterfall_deduction{cause}` gauge per named cause on the
        scrape surface, and an `mfu_waterfall` record on the sink for
        `data analyze_telemetry`. Returns the waterfall (None when disabled)."""
        if not self.enabled:
            return None
        from modalities_tpu_torch.telemetry.waterfall import DEDUCTIONS, mfu_waterfall

        summary = self.ledger.summary()
        waterfall = mfu_waterfall(
            mfu_achieved,
            wall_s=summary["wall_s"],
            buckets=summary["buckets"],
            collective_frac=collective_frac,
            dcn_collective_frac=dcn_collective_frac,
        )
        self.metrics.gauge(
            "training_mfu_achieved", "Cumulative wall-clock MFU of the run"
        ).set(waterfall["achieved"])
        deduction_gauge = self.metrics.gauge(
            "training_mfu_waterfall_deduction",
            "MFU lost to each named cause; causes sum exactly to peak - achieved",
        )
        for cause in DEDUCTIONS:
            deduction_gauge.set(waterfall["deductions"][cause], cause=cause)
        if self._sink is not None:
            # full precision on purpose: the deductions sum to gap EXACTLY, and
            # rounding here would break that identity for sink replays
            self._sink.emit({
                "event": "mfu_waterfall",
                "peak": waterfall["peak"],
                "achieved": waterfall["achieved"],
                "gap": waterfall["gap"],
                "deductions": dict(waterfall["deductions"]),
            })
        return waterfall

    # ------------------------------------------------------- anomaly detection

    def _detector(self):
        from modalities_tpu_torch.telemetry.perfscope import AnomalyDetector

        return AnomalyDetector(
            window=self.anomaly_window, zscore_threshold=self.anomaly_zscore
        )

    def observe_step_time(self, seconds: float, step_id: Optional[int] = None) -> None:
        """Feed one step's wall time through the rolling robust-z detector. An anomalous step bumps `training_step_time_anomaly_total`,
        the live z/EWMA land on gauges, and the sink gets an `anomaly/step_time`
        event the analyze CLI can line up against the goodput buckets."""
        if not self.enabled:
            return
        if self._step_time_detector is None:
            self._step_time_detector = self._detector()
        verdict = self._step_time_detector.observe(seconds)
        z = verdict.zscore if verdict.zscore not in (float("inf"), float("-inf")) else 1e9
        self.metrics.gauge(
            "training_step_time_zscore", "Robust z-score of the latest step's wall time"
        ).set(z)
        self.metrics.gauge(
            "training_step_time_ewma_seconds", "EWMA of per-step wall time"
        ).set(verdict.ewma)
        if verdict.is_anomaly:
            self.metrics.counter(
                "training_step_time_anomaly_total",
                "Steps whose wall time scored over the anomaly z-score threshold",
            ).inc()
            self.emit_event(
                "anomaly/step_time",
                {"step_id": step_id, "seconds": round(seconds, 6),
                 "zscore": round(z, 3), "ewma_s": round(verdict.ewma, 6)},
            )

    def _observe_bucket_deltas(self, bucket_seconds: dict) -> None:
        """Per-publish goodput-bucket deltas through per-bucket detectors: a
        publish interval that suddenly spends 10x its usual data_stall seconds
        scores high on `training_goodput_bucket_zscore{bucket="data_stall"}`."""
        zscore_gauge = self.metrics.gauge(
            "training_goodput_bucket_zscore",
            "Robust z-score of each goodput bucket's seconds over the last publish interval",
        )
        for bucket in BUCKETS:
            total = float(bucket_seconds.get(bucket, 0.0))
            delta = total - self._last_bucket_seconds.get(bucket, 0.0)
            self._last_bucket_seconds[bucket] = total
            detector = self._bucket_detectors.get(bucket)
            if detector is None:
                detector = self._bucket_detectors[bucket] = self._detector()
            verdict = detector.observe(delta)
            z = verdict.zscore if abs(verdict.zscore) != float("inf") else 1e9
            zscore_gauge.set(z, bucket=bucket)
            if verdict.is_anomaly:
                self.emit_event(
                    "anomaly/goodput_bucket",
                    {"bucket": bucket, "delta_s": round(delta, 6), "zscore": round(z, 3)},
                )

    def publish_resource_gauges(
        self,
        hbm_headroom_mb: Optional[float] = None,
        peak_memory_mb: Optional[float] = None,
    ) -> None:
        """Device-memory gauges for the shared scrape surface; the trainer calls
        this from its interval publish with the numbers it already computes."""
        if hbm_headroom_mb is not None:
            self.metrics.gauge(
                "training_hbm_headroom_mbytes", "Min over devices of free HBM (MB)"
            ).set(hbm_headroom_mb)
        if peak_memory_mb is not None:
            self.metrics.gauge(
                "training_peak_memory_mbytes", "Max over devices of peak HBM in use (MB)"
            ).set(peak_memory_mb)

    def publish_memory_timeline(self, sample: dict) -> None:
        """One memscope timeline sample (telemetry/memscope.py) onto the scrape
        surface and the sink: worst-device bytes in use, per-device headroom
        (the SLO floor objective's source), and a `memscope_timeline` sink event
        so headroom objectives replay offline via `data check_slo`."""
        if not self.enabled:
            return
        self.metrics.gauge(
            "training_hbm_bytes_in_use", "Max over devices of HBM bytes in use"
        ).set(sample["bytes_in_use"])
        headroom_gauge = self.metrics.gauge(
            "memscope_device_headroom_bytes",
            "Per-device bytes_limit - bytes_in_use (absent on backends with no limit)",
        )
        for device, headroom in (sample.get("headroom_bytes") or {}).items():
            headroom_gauge.set(headroom, device=device)
        if self._sink is not None:
            self._sink.emit({
                "event": "memscope_timeline",
                "step": sample.get("step"),
                "executable": sample.get("executable"),
                "bytes_in_use": sample["bytes_in_use"],
                "headroom_bytes": dict(sample.get("headroom_bytes") or {}),
            })

    def publish_memscope_report(self, report: dict, executable: str = "train_step") -> None:
        """Static memscope buckets onto the scrape surface:
        `memscope_bucket_bytes{executable,bucket}` — the memory sibling of the
        goodput bucket gauges; the buckets sum to the report's predicted peak."""
        if not self.enabled:
            return
        bucket_gauge = self.metrics.gauge(
            "memscope_bucket_bytes",
            "Static per-device bytes attributed to each memscope bucket; buckets "
            "sum exactly to the step's predicted peak",
        )
        for bucket, nbytes in (report.get("buckets") or {}).items():
            bucket_gauge.set(nbytes, executable=executable, bucket=bucket)

    # -------------------------------------------------------------- lifecycle

    def close(self) -> None:
        """Stop the watchdog and seal the sink with a run summary.
        Idempotent; safe on the exception path."""
        if self.slo_engine is not None:
            self.slo_engine.stop()
        if self._watchdog is not None:
            self._watchdog.stop()
        if self._sink is not None:
            self._sink.close(run_summary=self.goodput_summary())


@dataclasses.dataclass
class TelemetryConfig:
    """The JAX `TelemetryConfig` (modalities_tpu/config/config.py:468-491),
    field for field, with its bounds. `output_folder_path` defaults to
    <experiment folder>/telemetry (set by Main); `watchdog_deadline_s` 0
    disables the watchdog; `slo` is an SLO spec ({"objectives": [...]})
    judged at each interval publish."""

    enabled: bool = True
    output_folder_path: Optional[Path] = None
    watchdog_deadline_s: float = 1800.0
    watchdog_first_step_factor: float = 4.0
    use_jax_annotations: bool = True
    anomaly_zscore: float = 6.0
    anomaly_window: int = 64
    slo: Optional[dict] = None

    def __post_init__(self):
        check_bool("enabled", self.enabled)
        if self.output_folder_path is not None:
            self.output_folder_path = Path(self.output_folder_path)
        self.watchdog_deadline_s = check_float("watchdog_deadline_s", self.watchdog_deadline_s, ge=0.0)
        self.watchdog_first_step_factor = check_float("watchdog_first_step_factor", self.watchdog_first_step_factor,
                                                      ge=1.0)
        check_bool("use_jax_annotations", self.use_jax_annotations)
        self.anomaly_zscore = check_float("anomaly_zscore", self.anomaly_zscore, gt=0.0)
        check_int("anomaly_window", self.anomaly_window, ge=2)
        check_dict("slo", self.slo, optional=True)


def build_telemetry(enabled: bool = True, output_folder_path: Optional[Path] = None,
                    watchdog_deadline_s: float = 1800.0, watchdog_first_step_factor: float = 4.0,
                    use_jax_annotations: bool = True, anomaly_zscore: float = 6.0, anomaly_window: int = 64,
                    slo: Optional[dict] = None) -> Telemetry:
    """("telemetry", "default"): a `Telemetry` from JAX's config fields;
    `use_jax_annotations` sets the port's `profiler_annotations`."""
    return Telemetry(enabled=enabled, output_folder_path=output_folder_path, watchdog_deadline_s=watchdog_deadline_s,
                     watchdog_first_step_factor=watchdog_first_step_factor, profiler_annotations=use_jax_annotations,
                     anomaly_zscore=anomaly_zscore, anomaly_window=anomaly_window, slo=slo)


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

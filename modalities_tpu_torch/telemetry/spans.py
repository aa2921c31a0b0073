"""Host-side span recording: the event source of the goodput ledger and the
sink. The port of modalities_tpu/telemetry/spans.py.

A span is `with recorder.span("checkpoint_save"): ...` around a host phase.
Each span records wall timestamps plus its EXCLUSIVE time (duration minus
the enclosed child spans, tracked per thread), so a span stream buckets into
wall-time accounting without interval arithmetic: every second of a
thread's timeline lands in exactly one span's exclusive time.

While a torch profiler is recording, a span is also a
`torch.profiler.record_function` range, so host phases appear by name on the
host rows of the trace next to the device streams (the JAX spans double as
`jax.profiler.TraceAnnotation`s always). Outside a profile a span costs host
time only: two clock reads and a list push, never a device sync.
`step_trace_annotation(step_id)` names a train-step range the same way.

Threading: spans may be opened from any thread. Only spans from the
designated *timeline thread* (the step loop) carry `timeline=True`; the
goodput ledger ignores the rest, since background work overlaps the main
timeline and would count wall seconds twice.
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass
from typing import Callable, Optional

import torch


@dataclass
class SpanRecord:
    name: str
    ts: float  # epoch seconds at span start
    dur_s: float  # wall duration of the span
    self_s: float  # duration minus enclosed child spans (exclusive time)
    thread: str
    timeline: bool  # True when recorded on the designated step-loop thread


class _NullContext:
    """Shared allocation-free no-op context manager (the disabled fast path)."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, exc_type, exc_val, exc_tb):
        return False


NULL_CONTEXT = _NullContext()


def _profiler_range(name: str):
    """A `record_function` range while a torch profiler records, else None."""
    if torch.autograd._profiler_enabled():
        return torch.profiler.record_function(name)
    return None


class _Span:
    __slots__ = ("_recorder", "name", "_ts", "_t0", "_children_s", "_annotation")

    def __init__(self, recorder: "SpanRecorder", name: str):
        self._recorder = recorder
        self.name = name
        self._annotation = None

    def __enter__(self) -> "_Span":
        recorder = self._recorder
        stack = getattr(recorder._tls, "stack", None)
        if stack is None:
            stack = recorder._tls.stack = []
        stack.append(self)
        self._children_s = 0.0
        self._annotation = _profiler_range(self.name) if recorder._profiler_annotations else None
        if self._annotation is not None:
            self._annotation.__enter__()
        self._ts = time.time()
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, exc_type, exc_val, exc_tb) -> bool:
        dur_s = time.perf_counter() - self._t0
        if self._annotation is not None:
            self._annotation.__exit__(exc_type, exc_val, exc_tb)
            self._annotation = None
        recorder = self._recorder
        stack = recorder._tls.stack
        stack.pop()
        if stack:
            stack[-1]._children_s += dur_s
        if recorder._on_record is not None:
            recorder._on_record(
                SpanRecord(
                    name=self.name,
                    ts=self._ts,
                    dur_s=dur_s,
                    self_s=max(0.0, dur_s - self._children_s),
                    thread=threading.current_thread().name,
                    timeline=threading.get_ident() == recorder._timeline_ident,
                )
            )
        return False


class SpanRecorder:
    """Thread-safe span source. `on_record(SpanRecord)` fires at every span
    exit, on the exiting span's own thread (consumers must be thread-safe).
    `profiler_annotations=False` keeps spans out of torch profiles."""

    def __init__(self, on_record: Optional[Callable[[SpanRecord], None]] = None, profiler_annotations: bool = True):
        self._on_record = on_record
        self._profiler_annotations = profiler_annotations
        self._tls = threading.local()
        self._timeline_ident = threading.get_ident()

    def set_timeline_thread(self, ident: Optional[int] = None) -> None:
        """Designate the thread whose spans carry `timeline=True` (default: the
        thread that constructed the recorder)."""
        self._timeline_ident = threading.get_ident() if ident is None else ident

    def span(self, name: str) -> _Span:
        return _Span(self, name)


def step_trace_annotation(step_id: int, name: str = "train_step"):
    """A `record_function` range "<name>#<step_id>" while a torch profiler
    records (profiles group device work by step), else a no-op."""
    return _profiler_range(f"{name}#{step_id}") or NULL_CONTEXT

"""Resilience event stream: every recovery-path action (failover, rollback,
seal rejection, SLO breach, ...) is counted in-process AND emitted to the
active telemetry sink. The port of modalities_tpu/resilience/events.py.

The counters let a caller that needs a synchronous answer to "did anything
degrade in this window?" read it without tailing the JSONL sink. They are
keyed by the event's first path segment (``fleet/rollback`` counts under
``fleet``). With no telemetry active the sink is the no-op: the counter
still advances, the payload goes nowhere.
"""

from __future__ import annotations

import threading

from modalities_tpu_torch.telemetry import get_active_telemetry

_lock = threading.Lock()
_counts: dict[str, int] = {}


def record_event(name: str, **payload) -> None:
    """Count the event under its first path segment and emit it to the active
    telemetry sink."""
    group = name.split("/", 1)[0]
    with _lock:
        _counts[group] = _counts.get(group, 0) + 1
    get_active_telemetry().emit_event(name, payload)


def snapshot_counts() -> dict[str, int]:
    with _lock:
        return dict(_counts)


def counts_since(snapshot: dict[str, int]) -> dict[str, int]:
    """Per-group event counts accumulated since `snapshot` (zero entries dropped)."""
    with _lock:
        current = dict(_counts)
    delta = {k: v - snapshot.get(k, 0) for k, v in current.items()}
    return {k: v for k, v in delta.items() if v > 0}


def reset_counts() -> None:
    """Test isolation hook."""
    with _lock:
        _counts.clear()

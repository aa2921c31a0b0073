"""Resilience event counters: every recovery-path action of the fleet
(failover, rollback, seal rejection, ...) is counted in-process. The port of
modalities_tpu/resilience/events.py.

The counters let a caller that needs a synchronous answer to "did anything
degrade in this window?" read it without a telemetry sink. They are keyed
by the event's first path segment (``fleet/rollback`` counts under
``fleet``). The JAX module also emits each event to the active telemetry
sink; the port has no sink yet (ROADMAP.md Queue 1 item 6), which is what the
JAX package does with telemetry off: the counter still advances, the
payload goes nowhere.
"""

from __future__ import annotations

import threading

_lock = threading.Lock()
_counts: dict[str, int] = {}


def record_event(name: str, **payload) -> None:
    """Count the event under its first path segment (the payload has no sink yet)."""
    group = name.split("/", 1)[0]
    with _lock:
        _counts[group] = _counts.get(group, 0) + 1


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

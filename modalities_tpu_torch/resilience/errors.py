"""The resumable-failure contract shared by the trainer, the anomaly policy,
the CLI and the supervisor: the port of modalities_tpu/resilience/errors.py."""

from __future__ import annotations

# Exit code signalling "this run died in a resumable way" (preemption, rollback):
# a supervisor seeing it warmstarts from the newest verified checkpoint.
# 75 is EX_TEMPFAIL in sysexits.h: "temporary failure, retry later".
RESUMABLE_EXIT_CODE = 75


class ResumableError(Exception):
    """Base for failures that a supervisor should treat as resume-and-retry."""


class PreemptionShutdown(ResumableError):
    """Raised after the forced preemption checkpoint committed; exit resumable."""


class AnomalyRollback(ResumableError):
    """Anomaly skip budget exhausted under the rollback policy; exit resumable so
    the supervisor warmstarts from the newest verified checkpoint."""


class PeerFailure(ResumableError):
    """A peer process died or wedged past its heartbeat/rendezvous deadline; this
    process exits resumable instead of hanging in a collective forever."""


class OutOfMemory(ResumableError):
    """Device allocation failed. Exit resumable so the supervisor can warmstart
    (raised by memscope's OOM forensics, telemetry/memscope.py)."""

"""Preemption-aware shutdown: SIGTERM/SIGINT -> flag -> graceful stop. The
port of modalities_tpu/resilience/preemption.py.

The signal handler does the minimum legal work (set a flag, remember the
signal); a loop polls `should_stop()` at its own boundaries. The serving
engine takes it as its `stop_fn`: admission stops, in-flight requests finish
and stream out, and the serve process exits 0 with its final stats. The
trainer (the `resilience` component's handler, installed by Main for the
training window) lets the in-flight step finish, saves out of schedule at
that step and raises `PreemptionShutdown`; with the stop consensus on, the
flag is this rank's vote in the stop ballot (resilience/coordination.py), so
every rank stops at the same step.
"""

from __future__ import annotations

import logging
import signal
import threading
from typing import Optional

logger = logging.getLogger(__name__)

_HANDLED_SIGNALS = (signal.SIGTERM, signal.SIGINT)


class PreemptionHandler:
    """Install/uninstall SIGTERM+SIGINT handlers that flip a stop flag.

    Installation is main-thread-only by Python's signal semantics; off the main
    thread installation degrades to a warning and the handler stays inert:
    `should_stop()` then only reports `request_stop()` calls.
    """

    def __init__(self):
        self._stop_event = threading.Event()
        self._received_signum: Optional[int] = None
        self._previous_handlers: dict[int, object] = {}
        self._installed = False

    def install(self) -> "PreemptionHandler":
        if self._installed:
            return self
        try:
            for signum in _HANDLED_SIGNALS:
                self._previous_handlers[signum] = signal.signal(signum, self._on_signal)
            self._installed = True
        except ValueError:  # not the main thread
            self._previous_handlers.clear()
            logger.warning(
                "cannot install signal handlers outside the main thread — "
                "preemption-aware shutdown responds only to request_stop()"
            )
        return self

    def uninstall(self) -> None:
        for signum, previous in self._previous_handlers.items():
            try:
                signal.signal(signum, previous)
            except (ValueError, TypeError):
                pass
        self._previous_handlers.clear()
        self._installed = False

    def __enter__(self) -> "PreemptionHandler":
        return self.install()

    def __exit__(self, *exc_info) -> None:
        self.uninstall()

    def _on_signal(self, signum, frame) -> None:
        # handler body: flag + bookkeeping only (no IO, no locks, no logging:
        # the logging module takes locks and is not async-signal-safe)
        self._received_signum = signum
        self._stop_event.set()

    def request_stop(self) -> None:
        """Programmatic stop request (tests, external orchestration hooks)."""
        self._stop_event.set()

    def should_stop(self) -> bool:
        return self._stop_event.is_set()

    @property
    def received_signal(self) -> Optional[str]:
        if self._received_signum is None:
            return None
        try:
            return signal.Signals(self._received_signum).name
        except ValueError:
            return str(self._received_signum)

    def reset(self) -> None:
        """Re-arm for a fresh run in the same process (tests)."""
        self._stop_event.clear()
        self._received_signum = None

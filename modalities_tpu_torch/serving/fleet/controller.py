"""Rollout controller: canary deployments with metric-gated promotion or
rollback, the port of modalities_tpu/serving/fleet/controller.py.

`deploy(params, step)` never swaps the whole fleet at once. One worker, the
least-loaded healthy one, becomes the canary for generation g + 1. For a
probation window its `serve_request_errors_total` delta and TTFT
histogram are compared against the rest of the fleet: a regression rolls
the canary back to the donor generation, a clean window promotes g + 1 to
every worker. The verdict is an event (``fleet/rollout`` /
``fleet/rollback``) and a counter (`fleet_rollouts_total` /
`fleet_rollbacks_total`) on the fleet registry.

The error delta is checked every tick (a NaN-weights canary whose requests
finish "error" rolls back mid-window); the TTFT comparison runs once at
the window's end, when both sides have observations. The window is
``MODALITIES_TPU_FLEET_PROBATION_S`` (default 30 s); clock and sleep are
injectable, so tests step probation. The JAX controller also asks an SLO
engine for the canary's breaching objectives each tick; the port has none
yet (ROADMAP.md Queue 1 item 6), so `slo_verdict_fn` stays None.

The port's engine installs a generation by copying it into its tensors
(serving/engine.py, hot swap), so the donor is not a reference the engine
leaves behind as in JAX: the controller takes a copy of the canary's
installed weights before it swaps (`EngineWorker.snapshot_params`), and
rolls back from that copy.
"""

from __future__ import annotations

import logging
import os
import time
from typing import Callable, Optional

from modalities_tpu_torch.resilience.events import record_event
from modalities_tpu_torch.telemetry.metrics import MetricsRegistry

logger = logging.getLogger(__name__)


def _default_probation_s() -> float:
    return float(os.environ.get("MODALITIES_TPU_FLEET_PROBATION_S", "30.0"))


class EngineWorker:
    """One in-process serving worker: a ServingEngine and, optionally, its
    HTTP front end. Each worker owns its own MetricsRegistry, so its error
    counts and latency histograms are its own: what makes the canary
    comparison meaningful."""

    def __init__(self, name: str, engine, server=None):
        self.name = name
        self.engine = engine
        self.server = server  # ServingHTTPServer when fronted, None in units

    @property
    def url(self) -> Optional[str]:
        if self.server is None or self.server.port is None:
            return None
        return f"http://127.0.0.1:{self.server.port}"

    def healthy(self) -> bool:
        return not self.engine._stopping()

    def load(self) -> int:
        """Live slots + queue depth (the engine's published snapshot)."""
        stats = self.engine.stats()
        return int(stats["active_slots"]) + int(stats["queue_depth"])

    def snapshot(self) -> dict:
        """The metrics the probation compares: a baseline, then deltas."""
        stats = self.engine.stats()
        ttft = self.engine.metrics.get("serve_ttft_seconds")
        return {"request_errors": stats["request_errors"], "weights_generation": stats["weights_generation"],
                "ttft_sum": ttft.sum() if ttft is not None else 0.0,
                "ttft_count": ttft.count() if ttft is not None else 0.0}

    def snapshot_params(self) -> dict:
        """A copy of the installed weights (the donor a rollback restores)."""
        return {name: t.detach().clone() for name, t in self.engine._installed.items()}

    def swap(self, params, generation: int, timeout_s: float = 60.0) -> bool:
        """Install new weights on this worker. With a live engine thread (the
        HTTP front end running) the swap is queued onto it and lands at the
        next token boundary; a worker without one swaps here."""
        engine_thread = getattr(self.server, "_engine_thread", None)
        if engine_thread is not None and engine_thread.is_alive():
            return self.engine.request_swap(params, generation).wait(timeout_s)
        self.engine.swap_weights(params, generation)
        return True


class RolloutController:
    """Canary rollout over a fixed worker set. `metrics` is the FLEET
    registry (the router's /metrics renders it); each worker's serve_*
    series live on its own registry."""

    def __init__(
        self,
        workers: list[EngineWorker],
        *,
        metrics: Optional[MetricsRegistry] = None,
        probation_s: Optional[float] = None,
        probation_tick_s: float = 0.25,
        max_error_delta: int = 0,
        ttft_regression_factor: float = 2.0,
        slo_verdict_fn: Optional[Callable[[EngineWorker], list]] = None,
        time_fn: Callable[[], float] = time.monotonic,
        sleep_fn: Callable[[float], None] = time.sleep,
    ):
        if not workers:
            raise ValueError("RolloutController needs at least one worker")
        if slo_verdict_fn is not None:
            raise NotImplementedError("slo_verdict_fn: the SLO engine's verdicts wait for ROADMAP.md Queue 1 item 6")
        self.workers = list(workers)
        self.metrics = metrics if metrics is not None else MetricsRegistry()
        self.probation_s = probation_s if probation_s is not None else _default_probation_s()
        self.probation_tick_s = probation_tick_s
        self.max_error_delta = int(max_error_delta)
        self.ttft_regression_factor = float(ttft_regression_factor)
        self._now = time_fn
        self._sleep = sleep_fn
        self.generation = max(w.engine.weights_generation for w in self.workers)
        self._m_rollouts = self.metrics.counter("fleet_rollouts_total", "Canary rollouts promoted to the full fleet")
        self._m_rollbacks = self.metrics.counter("fleet_rollbacks_total",
                                                 "Canary rollouts rolled back during probation")

    def deploy(self, params, step: Optional[int] = None, folder=None) -> bool:
        """Canary-roll `params` out as generation g + 1. True on promotion,
        False on a rollback (the watcher burns the step)."""
        gen = self.generation + 1
        canary = self._pick_canary()
        if canary is None:
            record_event("fleet/rollback", stage="no_healthy_worker", generation=gen, step=step)
            self._m_rollbacks.inc()
            return False
        donor_params = canary.snapshot_params()
        donor_gen = canary.engine.weights_generation
        baselines = {w.name: w.snapshot() for w in self.workers}
        logger.info("fleet rollout: canary %s -> generation %d (step %s)", canary.name, gen, step)
        record_event("fleet/canary", worker=canary.name, generation=gen, step=step)
        if not canary.swap(params, gen):
            record_event("fleet/rollback", stage="canary_swap", worker=canary.name, generation=gen, step=step)
            self._m_rollbacks.inc()
            return False
        verdict = self._probation(canary, baselines)
        if verdict is not None:
            stage, reason = verdict
            canary.swap(donor_params, donor_gen)
            logger.warning("fleet rollback: generation %d off %s (%s); donor generation %d keeps serving", gen,
                           canary.name, reason, donor_gen)
            record_event("fleet/rollback", stage=stage, worker=canary.name, generation=gen, step=step, reason=reason)
            self._m_rollbacks.inc()
            return False
        del donor_params
        for worker in self.workers:
            if worker is not canary:
                worker.swap(params, gen)
        self.generation = gen
        self._m_rollouts.inc()
        logger.info("fleet rollout: generation %d promoted to %d workers", gen, len(self.workers))
        record_event("fleet/rollout", generation=gen, step=step, workers=len(self.workers), canary=canary.name)
        return True

    def _pick_canary(self) -> Optional[EngineWorker]:
        healthy = [w for w in self.workers if w.healthy()]
        if not healthy:
            return None
        return min(healthy, key=lambda w: w.load())

    def _probation(self, canary: EngineWorker, baselines: dict) -> Optional[tuple[str, str]]:
        """Watch the canary for the probation window: None promotes, a
        (stage, reason) pair rolls back."""
        deadline = self._now() + self.probation_s
        base = baselines[canary.name]
        while True:
            error_delta = canary.snapshot()["request_errors"] - base["request_errors"]
            if error_delta > self.max_error_delta:
                return ("probation", f"request_errors regressed by {error_delta} during probation "
                                     f"(allowed {self.max_error_delta})")
            if self._now() >= deadline:
                break
            self._sleep(self.probation_tick_s)
        # the window's end: the canary's mean TTFT against the PEERS' mean over
        # the same window (from the histograms' sum and count deltas; both
        # sides need observations for the comparison to mean anything)
        snap = canary.snapshot()
        canary_count = snap["ttft_count"] - base["ttft_count"]
        peer_sum = peer_count = 0.0
        for worker in self.workers:
            if worker is canary:
                continue
            peer_snap, peer_base = worker.snapshot(), baselines[worker.name]
            peer_sum += peer_snap["ttft_sum"] - peer_base["ttft_sum"]
            peer_count += peer_snap["ttft_count"] - peer_base["ttft_count"]
        if canary_count > 0 and peer_count > 0:
            canary_mean = (snap["ttft_sum"] - base["ttft_sum"]) / canary_count
            peer_mean = peer_sum / peer_count
            if peer_mean > 0 and canary_mean > self.ttft_regression_factor * peer_mean:
                return ("probation", f"ttft regressed: canary mean {canary_mean:.4f}s vs fleet mean {peer_mean:.4f}s "
                                     f"(factor {self.ttft_regression_factor:g})")
        return None

"""`serve --fleet` for the flat fleet: the DI component that boots N
in-process engine workers (each with its own MetricsRegistry and a loopback
HTTP front end), the load-balancing router, the canary rollout controller
and, when a ring path is set, the checkpoint watcher that closes the train ->
serve loop. The port of modalities_tpu/serving/fleet/component.py.

Its config is configs/config_fleet.yaml: the `inference_component.fleet`
variant is the `serve` variant's schema plus the knobs below; the time
windows left null take ``MODALITIES_TPU_FLEET_POLL_S`` /
``MODALITIES_TPU_FLEET_PROBATION_S`` / ``MODALITIES_TPU_FLEET_HEALTH_DEADLINE_S``
(watcher, controller and router modules). The file's `slo` block stays
refused, as `serve` refuses it (ROADMAP.md Queue 1 item 6): set `slo: null`.
Every worker gets the component's admission knobs; a `tenants` block gives
each worker a registry of its own (the JAX fleet builds its workers without
one).
"""

from __future__ import annotations

import dataclasses
import functools
import logging
import time
from pathlib import Path
from typing import Optional

from modalities_tpu_torch.config.config import check_float, check_int, check_str
from modalities_tpu_torch.serving.serve import ServingComponent, ServingComponentConfig

logger = logging.getLogger(__name__)

_SERVE_FIELDS = {f.name for f in dataclasses.fields(ServingComponentConfig)}


@dataclasses.dataclass
class FleetComponentConfig(ServingComponentConfig):
    """Schema of the `serving_component` node in configs/config_fleet.yaml."""

    num_workers: int = 2
    watch_ring_path: Optional[str] = None  # the training checkpoint ring to watch
    watch_poll_s: Optional[float] = None  # None: MODALITIES_TPU_FLEET_POLL_S / 5 s
    probation_s: Optional[float] = None  # None: MODALITIES_TPU_FLEET_PROBATION_S / 30 s
    probation_tick_s: float = 0.25
    max_error_delta: int = 0  # canary request_errors allowed during probation
    ttft_regression_factor: float = 2.0  # canary mean TTFT ceiling against the fleet's
    health_interval_s: float = 0.5
    heartbeat_deadline_s: Optional[float] = None  # None: MODALITIES_TPU_FLEET_HEALTH_DEADLINE_S / 5 s

    def __post_init__(self):
        super().__post_init__()
        check_int("num_workers", self.num_workers, ge=1)
        check_str("watch_ring_path", self.watch_ring_path, optional=True)
        self.watch_poll_s = check_float("watch_poll_s", self.watch_poll_s, optional=True)
        self.probation_s = check_float("probation_s", self.probation_s, optional=True)
        self.probation_tick_s = check_float("probation_tick_s", self.probation_tick_s)
        check_int("max_error_delta", self.max_error_delta, ge=0)
        self.ttft_regression_factor = check_float("ttft_regression_factor", self.ttft_regression_factor)
        self.health_interval_s = check_float("health_interval_s", self.health_interval_s)
        self.heartbeat_deadline_s = check_float("heartbeat_deadline_s", self.heartbeat_deadline_s, optional=True)


def split_knobs(config_type, knobs: dict) -> tuple[dict, dict]:
    """(the `serve` knobs, the variant's own) of a fleet variant's knobs."""
    own = {f.name for f in dataclasses.fields(config_type)} - _SERVE_FIELDS
    return {k: v for k, v in knobs.items() if k not in own}, {k: v for k, v in knobs.items() if k in own}


class WorkerBoot:
    """What the fleet and the disaggregated fleet share: one worker (engine,
    HTTP front end on a loopback port, /admin/swap handler) booted from the
    component's knobs, and the one load seam every generation goes through."""

    def _load_fn(self):
        """Boot, the watcher's rollouts and /admin/swap all quantize through
        this partial, so swap_weights' quantization gate fires on config skew only."""
        from modalities_tpu_torch.serving.serve import load_serving_params

        return functools.partial(load_serving_params, device=self.device, quant_weights=self.quant_weights_setting)

    def _boot_worker(self, name: str, role: str = "combined", spec_decode=None, load_fn=None):
        from modalities_tpu_torch.serving.engine import ServingEngine
        from modalities_tpu_torch.serving.fleet.controller import EngineWorker
        from modalities_tpu_torch.serving.resilience import BrownoutController, TenantRegistry
        from modalities_tpu_torch.serving.server import ServingHTTPServer
        from modalities_tpu_torch.telemetry.metrics import MetricsRegistry

        engine = ServingEngine(
            self.model,
            self.params,
            device=self.device,
            max_batch_slots=self.max_batch_slots,
            cache_capacity=self.cache_capacity,
            eod_token_id=self._eod_id(),
            default_temperature=self.temperature,
            kv_cache=self.kv_cache,
            paged_block_size=self.paged_block_size,
            paged_num_blocks=self.paged_num_blocks,
            paged_max_len=self.paged_max_len,
            prefix_sharing=self.prefix_sharing,
            spec_decode=spec_decode,
            quant_weights=self.quant_weights_setting,
            quant_kv=self.quant_kv_setting,
            max_queue_depth=self.max_queue_depth,
            brownout=(BrownoutController(queue_high=self.brownout_queue_high)
                      if self.brownout_queue_high is not None else None),
            tenants=TenantRegistry.from_config(self.tenants_config) if self.tenants_config else None,
            stop_fn=self.stop_fn,
            metrics=MetricsRegistry(),  # a worker's own: the canary's metrics stay apart
            role=role,
        )
        server = ServingHTTPServer(engine, encode=self._encode, decode=self.tokenizer.decode, host=self.http_host,
                                   port=0, default_max_new_tokens=self.max_new_tokens)
        worker = EngineWorker(name, engine, server)
        # POST /admin/swap on a worker: load the named sealed folder and swap THAT worker
        server.swap_handler = swap_handler(worker, load_fn or self._load_fn())
        server.start()
        return worker

    def _serve_until_stopped(self, router, workers: list, watcher=None) -> dict:
        """Block until the stop flag (SIGTERM/SIGINT) trips, then drain: the
        router first, every worker at once, then each reaped."""
        try:
            while not (self.stop_fn is not None and self.stop_fn()):
                time.sleep(0.2)
        finally:
            if watcher is not None:
                watcher.stop()
            router.stop()
            for worker in workers:
                worker.server.stop()
            worker_stats = {worker.name: worker.server.serve_forever() for worker in workers}
            router.close()
        return {"fleet": router.fleet_table(), "workers": worker_stats}


def swap_handler(worker, load_fn):
    """POST /admin/swap's handler for `worker`: load the body's
    `checkpoint_folder` and swap it in at the next token boundary."""

    def handler(body: dict) -> dict:
        folder = body.get("checkpoint_folder")
        if not folder:
            raise ValueError("body needs a 'checkpoint_folder'")
        params = load_fn(folder)
        generation = body.get("generation")
        done = worker.engine.request_swap(params, int(generation) if generation is not None else None)
        if not done.wait(60.0):
            raise TimeoutError("swap did not install within 60s")
        return {"worker": worker.name, "weights_generation": worker.engine.weights_generation}

    return handler


class FleetServingComponent(WorkerBoot, ServingComponent):
    """ServingComponent whose run mode is a worker fleet behind a router."""

    def __init__(self, model, tokenizer, **knobs):
        serve_knobs, own = split_knobs(FleetComponentConfig, knobs)
        cfg = FleetComponentConfig(model=model, tokenizer=tokenizer, **knobs)  # names and types checked
        super().__init__(model, tokenizer, **serve_knobs)
        self.num_workers = cfg.num_workers
        self.watch_ring_path = Path(cfg.watch_ring_path) if cfg.watch_ring_path else None
        self.watch_poll_s = cfg.watch_poll_s
        self.probation_s = cfg.probation_s
        self.probation_tick_s = cfg.probation_tick_s
        self.max_error_delta = cfg.max_error_delta
        self.ttft_regression_factor = cfg.ttft_regression_factor
        self.health_interval_s = cfg.health_interval_s
        self.heartbeat_deadline_s = cfg.heartbeat_deadline_s
        self._boot_step = -1  # the ring step the initial params came from

    def resolve_params(self, checkpoint_folder_path) -> None:
        """The initial generation: an explicit checkpoint, else the newest
        sealed ring folder, else fresh init. The ring boot records its step,
        so the watcher does not deploy the weights it booted from again."""
        from modalities_tpu_torch.resilience.manifest import _seen_steps_of
        from modalities_tpu_torch.serving.fleet.watcher import CheckpointWatcher
        from modalities_tpu_torch.serving.serve import resolve_params

        if self.params is None and not checkpoint_folder_path and self.watch_ring_path:
            folder = CheckpointWatcher(self.watch_ring_path, on_params=lambda *a: None).scan_once()
            if folder is not None:
                logger.info("fleet: booting from ring checkpoint %s", folder)
                self.params = self._load_fn()(folder)
                self._boot_step = _seen_steps_of(folder)
                return
        resolve_params(self, checkpoint_folder_path)

    def run_fleet(self) -> dict:
        """Boot workers -> router -> controller -> watcher; block until the
        stop flag drains everything. Returns the workers' final stats, the
        router's fleet table and the generation serving."""
        from modalities_tpu_torch.serving.fleet.controller import RolloutController
        from modalities_tpu_torch.serving.fleet.router import FleetRouter, WorkerHandle
        from modalities_tpu_torch.serving.fleet.watcher import CheckpointWatcher
        from modalities_tpu_torch.telemetry.metrics import MetricsRegistry

        if self.params is None:
            raise ValueError("params not resolved — serve() loads them first")
        load_fn = self._load_fn()
        self._seed_deadline_env()  # deadline_default_ms applies fleet-wide
        workers = [self._boot_worker(f"worker{i}", spec_decode=self.spec_decode, load_fn=load_fn)
                   for i in range(self.num_workers)]
        fleet_registry = MetricsRegistry()
        controller = RolloutController(workers, metrics=fleet_registry, probation_s=self.probation_s,
                                       probation_tick_s=self.probation_tick_s, max_error_delta=self.max_error_delta,
                                       ttft_regression_factor=self.ttft_regression_factor)
        router = FleetRouter([WorkerHandle(w.name, self.http_host, w.server.port) for w in workers],
                             host=self.http_host, port=self.http_port or 0, metrics=fleet_registry,
                             health_interval_s=self.health_interval_s,
                             heartbeat_deadline_s=self.heartbeat_deadline_s).start()
        self.router, self.controller, self.workers = router, controller, workers
        watcher = None
        if self.watch_ring_path is not None:
            watcher = CheckpointWatcher(
                self.watch_ring_path,
                on_params=lambda params, step, folder: controller.deploy(params, step=step, folder=folder),
                load_fn=load_fn, poll_interval_s=self.watch_poll_s)
            watcher.deployed_step = self._boot_step
            watcher.start()
        logger.info("fleet serving: %d workers behind router on %s:%d%s", len(workers), self.http_host, router.port,
                    f", watching {self.watch_ring_path}" if watcher else "")
        out = self._serve_until_stopped(router, workers, watcher)
        out["generation"] = controller.generation
        return out

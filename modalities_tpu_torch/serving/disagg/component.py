"""`serve --fleet` for the DISAGGREGATED fleet: a prefill tier and a decode
tier behind a DisaggRouter, the port of
modalities_tpu/serving/disagg/component.py.

The `inference_component.disagg` variant (configs/config_disagg.yaml) boots
`prefill_workers` engines with ``role="prefill"`` and `decode_workers`
engines with ``role="decode"``, each with its own MetricsRegistry and
loopback HTTP front end, behind a DisaggRouter as the public face. `POST
/generate` on the router runs the prefill leg, ships the KV handoff record
to a decode worker and streams ONE SSE answer. The tiers need the paged
cache; `spec_decode` arms the decode tier only (the prefill tier is built
with speculation off, whatever MODALITIES_TPU_SERVE_SPEC_K says, since it
never decodes).

Workers keep the per-worker /admin/swap of the flat fleet, so a hot swap
moves a worker's weights generation, and the decode tier's generation check
at import turns a half-swapped fleet into `generation_mismatch` rejections
and a replay, not silently wrong KV. The `slo` block is armed per tier: a
worker judges only the objectives its tier owns (`_TIER_METRICS`: TTFT on
the prefill tier, TPOT on the decode tier, the rest on both), each over the
worker's own registry, feeding its /healthz and its brownout.
"""

from __future__ import annotations

import dataclasses
import logging
from typing import Optional

from modalities_tpu_torch.config.config import check_float, check_int
from modalities_tpu_torch.serving.fleet.component import WorkerBoot, split_knobs
from modalities_tpu_torch.serving.serve import ServingComponent, ServingComponentConfig

logger = logging.getLogger(__name__)

# the tier that owns an objective's metric; any other metric is judged on both
_TIER_METRICS = {
    "serve_ttft_seconds": "prefill",
    "serve_tpot_seconds": "decode",
}


@dataclasses.dataclass
class DisaggComponentConfig(ServingComponentConfig):
    """Schema of the `serving_component` node in configs/config_disagg.yaml."""

    prefill_workers: int = 1
    decode_workers: int = 1
    health_interval_s: float = 0.5
    heartbeat_deadline_s: Optional[float] = None  # None: the env / 5 s

    def __post_init__(self):
        super().__post_init__()
        check_int("prefill_workers", self.prefill_workers)
        check_int("decode_workers", self.decode_workers)
        self.health_interval_s = check_float("health_interval_s", self.health_interval_s)
        self.heartbeat_deadline_s = check_float("heartbeat_deadline_s", self.heartbeat_deadline_s, optional=True)


class DisaggServingComponent(WorkerBoot, ServingComponent):
    """ServingComponent whose run mode is a two-tier disaggregated fleet."""

    def __init__(self, model, tokenizer, **knobs):
        serve_knobs, _ = split_knobs(DisaggComponentConfig, knobs)
        cfg = DisaggComponentConfig(model=model, tokenizer=tokenizer, **knobs)  # names and types checked
        super().__init__(model, tokenizer, **serve_knobs)
        if cfg.prefill_workers < 1 or cfg.decode_workers < 1:
            raise ValueError("disagg needs >= 1 worker in EACH tier")
        if self.kv_cache not in (None, "paged"):
            raise ValueError(f"kv_cache={self.kv_cache!r}: disagg tiers require the paged KV cache "
                             "(block-granular handoff)")
        self.kv_cache = "paged"
        self.prefill_workers = cfg.prefill_workers
        self.decode_workers = cfg.decode_workers
        self.health_interval_s = cfg.health_interval_s
        self.heartbeat_deadline_s = cfg.heartbeat_deadline_s
        self._slo_hooks: dict = {}  # worker name -> its brownout's late-bound SLO hook

    def run_fleet(self) -> dict:
        """Boot both tiers -> the per-tier SLOs -> DisaggRouter; block until
        the stop flag drains everything (the flat fleet's contract)."""
        from modalities_tpu_torch.serving.disagg.router import DisaggRouter
        from modalities_tpu_torch.serving.fleet.router import WorkerHandle
        from modalities_tpu_torch.telemetry.metrics import MetricsRegistry

        if self.params is None:
            raise ValueError("params not resolved — serve() loads them first")
        load_fn = self._load_fn()
        self._seed_deadline_env()  # deadline_default_ms applies to both tiers
        prefill = [self._boot_worker(f"prefill{i}", "prefill", {"k": 0}, load_fn) for i in range(self.prefill_workers)]
        decode = [self._boot_worker(f"decode{i}", "decode", self.spec_decode, load_fn)
                  for i in range(self.decode_workers)]
        slo_engines = self._arm_slos(
            prefill + decode, lambda w, objectives: [o for o in objectives if _TIER_METRICS.get(
                o.metric, w.engine.role) == w.engine.role])
        router = DisaggRouter([WorkerHandle(w.name, self.http_host, w.server.port) for w in prefill],
                              [WorkerHandle(w.name, self.http_host, w.server.port) for w in decode],
                              host=self.http_host, port=self.http_port or 0, metrics=MetricsRegistry(),
                              health_interval_s=self.health_interval_s,
                              heartbeat_deadline_s=self.heartbeat_deadline_s).start()
        self.router, self.workers, self.slo_engines = router, prefill + decode, slo_engines
        logger.info("disagg serving: %d prefill + %d decode workers behind router on %s:%d", len(prefill),
                    len(decode), self.http_host, router.port)
        return self._serve_until_stopped(router, prefill + decode, slo_engines=slo_engines)

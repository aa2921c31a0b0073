"""`serve` entry: the DI component and config surface of the serving engine,
the port of modalities_tpu/serving/serve.py.

The engine's knobs pass through: the ring or the paged KV cache
(`kv_cache`, the `paged_*` sizes), prefix sharing, speculative decoding
(`spec_decode`) and `quant` {weights, kv}; a knob left null takes its JAX
environment switch inside the engine (MODALITIES_TPU_SERVE_KV_CACHE,
_PREFILL_CHUNKS, _SPEC_K, _PREFIX_SHARING, MODALITIES_TPU_QUANT_WEIGHTS,
MODALITIES_TPU_QUANT_KV). `prefix_sharing` and the `paged_*` sizes are ignored
on the ring cache, as the JAX engine ignores them there.

Admission control: `tenants` (weighted DRR, quotas, token-rate limits),
`deadline_default_ms` (env MODALITIES_TPU_SERVE_DEADLINE_DEFAULT_MS before
it), `brownout_queue_high` (the queue-pressure brownout), `max_queue_depth`
(MODALITIES_TPU_SERVE_QUEUE_LIMIT) and MODALITIES_TPU_SERVE_TENANT_DEFAULT.
`http_port` (or `serve --http_port`) starts the streaming HTTP front end
(serving/server.py) on `http_host`. The `fleet` and `disagg` variants
(serving/fleet/component.py, serving/disagg/component.py) run N workers, or
a prefill and a decode tier, behind a router (`serve --fleet`; `http_port`
is then the router's).

Refused, naming their ROADMAP.md item: `slo` (the SLO engine and its burn
signal, Queue 1 item 6), `device_mesh` (the engine's mesh shardings, item 3)
and the JAX serving switches MODALITIES_TPU_SERVE_TELEMETRY_DIR and _WATCHDOG_S
(item 6) at a value the port would not apply (`_refuse_unported_env`). So
`configs/config_serve.yaml` does not load unchanged: its `slo` block arms the
JAX engine's SLO judge, and the port refuses it (set `slo: null`).
"""

from __future__ import annotations

import dataclasses
import json
import logging
import os
from pathlib import Path
from typing import Any, Optional

import torch

from modalities_tpu_torch.config.config import (
    check_bool,
    check_dict,
    check_float,
    check_int,
    check_str,
)
from modalities_tpu_torch.config.yaml_interp import load_app_config_dict
from modalities_tpu_torch.device import resolve_device
from modalities_tpu_torch.serving.resilience import BrownoutController, TenantRegistry, resolve_deadline_ms
from modalities_tpu_torch.telemetry.metrics import MetricsRegistry

logger = logging.getLogger(__name__)


@dataclasses.dataclass
class ServingComponentConfig:
    """Schema of the `serving_component` node (the JAX ServingComponentConfig's
    keys, so the same YAML loads)."""

    model: Any
    tokenizer: Any
    device_mesh: Any = None
    max_batch_slots: int = 8
    cache_capacity: Optional[int] = None
    max_new_tokens: int = 64
    temperature: Optional[float] = None  # None = greedy
    seed: int = 0
    prompt_template: str = "{prompt}"
    eod_token: Optional[str] = "<eod>"
    kv_cache: Optional[str] = None  # "ring" | "paged"; None = env / ring
    paged_block_size: int = 16
    paged_num_blocks: Optional[int] = None
    paged_max_len: Optional[int] = None
    prefix_sharing: Optional[bool] = None
    spec_decode: Optional[dict] = None
    quant: Optional[dict] = None  # {"weights": none|int8|fp8, "kv": none|int8}; None = env / off
    http_host: str = "127.0.0.1"
    http_port: Optional[int] = None
    slo: Optional[dict] = None
    max_queue_depth: Optional[int] = None
    deadline_default_ms: Optional[float] = None
    brownout_queue_high: Optional[int] = None
    tenants: Optional[dict] = None

    def __post_init__(self):
        check_int("max_batch_slots", self.max_batch_slots, ge=1)
        check_int("cache_capacity", self.cache_capacity, optional=True)
        check_int("max_new_tokens", self.max_new_tokens)
        self.temperature = check_float("temperature", self.temperature, optional=True)
        check_int("seed", self.seed)
        check_str("prompt_template", self.prompt_template)
        check_str("eod_token", self.eod_token, optional=True)
        check_str("kv_cache", self.kv_cache, optional=True)
        check_int("paged_block_size", self.paged_block_size)
        check_int("paged_num_blocks", self.paged_num_blocks, optional=True)
        check_int("paged_max_len", self.paged_max_len, optional=True)
        check_bool("prefix_sharing", self.prefix_sharing, optional=True)
        check_dict("spec_decode", self.spec_decode, optional=True)
        check_dict("quant", self.quant, optional=True)
        check_str("http_host", self.http_host)
        check_int("http_port", self.http_port, optional=True)
        check_dict("slo", self.slo, optional=True)
        check_int("max_queue_depth", self.max_queue_depth, optional=True)
        self.deadline_default_ms = check_float("deadline_default_ms", self.deadline_default_ms, optional=True)
        check_int("brownout_queue_high", self.brownout_queue_high, optional=True)
        check_dict("tenants", self.tenants, optional=True)


# The JAX serving environment switches the port does not apply yet, each with
# the values that leave the port's result unchanged (the JAX defaults) and
# the ROADMAP.md Queue 1 item that ports its feature. The engine applies
# MODALITIES_TPU_SERVE_KV_CACHE, _PREFILL_CHUNKS, _SPEC_K, _PREFIX_SHARING and
# _QUEUE_LIMIT itself, and serving/resilience.py _DEADLINE_DEFAULT_MS and
# _TENANT_DEFAULT, as the JAX package does.
_ENV_DEFAULTS = {
    "MODALITIES_TPU_SERVE_TELEMETRY_DIR": (lambda v: False, 6),
    "MODALITIES_TPU_SERVE_WATCHDOG_S": (lambda v: float(v) == 300, 6),
}


def _refuse_unported_env() -> None:
    """Raise on a JAX serving switch set to a value the port would not apply
    (unset or empty is the default): the port refuses, never ignores."""
    for name, (is_default, item) in _ENV_DEFAULTS.items():
        raw = os.environ.get(name, "").strip()
        if not raw:
            continue
        try:
            default = is_default(raw)
        except ValueError:
            default = False
        if not default:
            raise NotImplementedError(
                f"{name}={raw!r}: the port does not have this serving feature yet "
                f"(ROADMAP.md, Queue 1 item {item}); unset it"
            )


class ServingComponent:
    """Serving as a DI component: holds the engine knobs and builds the
    `ServingEngine` once parameters and the device are resolved."""

    def __init__(self, model, tokenizer, **knobs):
        cfg = ServingComponentConfig(model=model, tokenizer=tokenizer, **knobs)  # names and types checked
        unported = {  # knob -> (set to a non-default value, the ROADMAP.md Queue 1 item that ports it)
            "device_mesh": (cfg.device_mesh is not None, 3),
            "slo": (cfg.slo is not None, 6),  # the JAX serve() arms the SLO judge and its brownout signal from it
        }
        refused = {k: item for k, (is_set, item) in unported.items() if is_set}
        if refused:
            raise NotImplementedError(
                f"serving_component knobs {sorted(refused)} need engine features the port does not have yet "
                f"(ROADMAP.md, Queue 1 item{'s' if len(set(refused.values())) > 1 else ''} "
                f"{' and '.join(str(i) for i in sorted(set(refused.values())))})"
            )
        _refuse_unported_env()
        self.model = model
        self.tokenizer = tokenizer
        self.max_batch_slots = cfg.max_batch_slots
        self.cache_capacity = cfg.cache_capacity
        self.max_new_tokens = cfg.max_new_tokens
        self.temperature = cfg.temperature
        self.seed = cfg.seed
        self.prompt_template = cfg.prompt_template
        self.eod_token = cfg.eod_token
        self.kv_cache = cfg.kv_cache
        self.paged_block_size = cfg.paged_block_size
        self.paged_num_blocks = cfg.paged_num_blocks
        self.paged_max_len = cfg.paged_max_len
        self.prefix_sharing = cfg.prefix_sharing
        self.spec_decode = cfg.spec_decode
        self.quant_weights_setting = (cfg.quant or {}).get("weights")
        self.quant_kv_setting = (cfg.quant or {}).get("kv")
        self.http_host = cfg.http_host
        self.http_port = cfg.http_port
        self.max_queue_depth = cfg.max_queue_depth
        self.deadline_default_ms = cfg.deadline_default_ms
        self.brownout_queue_high = cfg.brownout_queue_high
        # None keeps the engine on its single implicit tenant (plain FIFO); a malformed block fails here
        self.tenants = TenantRegistry.from_config(cfg.tenants) if cfg.tenants else None
        self.tenants_config = cfg.tenants  # a fleet builds each worker's registry (its buckets) from it
        self.metrics = MetricsRegistry()  # the engine's series; serve() adds the process gauges
        self.stop_fn = None  # graceful drain: serve() wires the SIGTERM flag here
        self.params: Optional[dict] = None
        self.device: Optional[torch.device] = None
        self._engine = None

    def _eod_id(self) -> int:
        if self.eod_token is None:
            return -1
        try:
            return self.tokenizer.get_token_id(self.eod_token)
        except (ValueError, KeyError):
            return -1

    def _seed_deadline_env(self) -> None:
        """env > config, as for every other serving knob: the config default
        lands only when no env value is present."""
        if self.deadline_default_ms is not None and not os.environ.get("MODALITIES_TPU_SERVE_DEADLINE_DEFAULT_MS"):
            os.environ["MODALITIES_TPU_SERVE_DEADLINE_DEFAULT_MS"] = str(self.deadline_default_ms)

    def build_engine(self):
        from modalities_tpu_torch.serving.engine import ServingEngine

        if self._engine is None:
            if self.params is None:
                raise ValueError("params not resolved — serve() initializes or loads them first")
            self._seed_deadline_env()
            self._engine = ServingEngine(
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
                spec_decode=self.spec_decode,
                quant_weights=self.quant_weights_setting,
                quant_kv=self.quant_kv_setting,
                max_queue_depth=self.max_queue_depth,
                # the queue-pressure brownout only: the JAX component also trips it on the SLO burn
                # signal, and `slo` is refused until ROADMAP.md Queue 1 item 6
                brownout=(BrownoutController(queue_high=self.brownout_queue_high)
                          if self.brownout_queue_high is not None else None),
                tenants=self.tenants,
                stop_fn=self.stop_fn,
                metrics=self.metrics,
            )
        return self._engine

    def _encode(self, prompt: str) -> list[int]:
        text = self.prompt_template.format(prompt=prompt) if self.prompt_template else prompt
        return list(self.tokenizer.tokenize(text))

    def run_requests(self, requests: list[dict]) -> list[dict]:
        """Replay parsed requests ({"prompt", "max_new_tokens"?, "temperature"?,
        "seed"?, "arrival_offset_s"?, "deadline_ms"?, "tenant"?}); returns the
        JSONL rows of the JAX serve path. A row's deadline and tenant resolve
        as the HTTP server resolves them (the row's value, else the env or
        config default); a request a drain left unserved gets no row."""
        engine = self.build_engine()
        rid_to_req = {}
        for req in requests:
            rid = engine.submit(
                list(self.tokenizer.tokenize(self.prompt_template.format(prompt=req["prompt"]))),
                int(req.get("max_new_tokens", self.max_new_tokens)),
                temperature=req.get("temperature", self.temperature),
                seed=int(req.get("seed", self.seed)),
                arrival_offset_s=float(req.get("arrival_offset_s", 0.0)),
                deadline_ms=resolve_deadline_ms(req.get("deadline_ms")),
                tenant=engine.resolve_submit_tenant(req.get("tenant")),
            )
            rid_to_req[rid] = req
        results = engine.run()
        rows = []
        for rid, req in rid_to_req.items():
            res = results.get(rid)
            if res is None:  # a drain stopped admission before this request
                logger.warning("serve: request %d left unserved by drain", rid)
                continue
            rows.append(
                {
                    "rid": rid,
                    "prompt": req["prompt"],
                    "completion": self.tokenizer.decode(res.tokens),
                    "tokens": res.tokens,
                    "finish_reason": res.finish_reason,
                    "truncated": res.truncated,
                    "ttft_s": res.ttft_s,
                    "latency_s": res.finish_s - res.arrival_s,
                }
            )
        return rows

    def run_http(self) -> dict:
        """Serve HTTP (serving/server.py) until drained (SIGTERM/SIGINT through
        `stop_fn`, or the server's stop()). Returns the final stats."""
        from modalities_tpu_torch.serving.server import ServingHTTPServer

        server = ServingHTTPServer(self.build_engine(), encode=self._encode, decode=self.tokenizer.decode,
                                   host=self.http_host, port=self.http_port or 0,
                                   default_max_new_tokens=self.max_new_tokens)
        server.start()
        logger.info("serving HTTP on %s:%d (POST /generate, GET /healthz, GET /stats, GET /metrics)",
                    self.http_host, server.port)
        return server.serve_forever()

    def run(self) -> None:
        """Interactive loop: one prompt a line from stdin, its completion
        printed (the JAX component's `run`). Ctrl-C or EOF ends it."""
        engine = self.build_engine()
        while True:
            try:
                prompt = input("serve> ").strip()
            except (EOFError, KeyboardInterrupt):
                print()
                break
            if not prompt:
                continue
            rid = engine.submit(self._encode(prompt), self.max_new_tokens, temperature=self.temperature,
                                seed=self.seed)
            print(self.tokenizer.decode(engine.run().pop(rid).tokens))


def build_serving_components(config_dict: dict):
    from modalities_tpu_torch.config.component_factory import ComponentFactory
    from modalities_tpu_torch.config.instantiation_models import ServeInstantiationModel
    from modalities_tpu_torch.registry.components import COMPONENTS
    from modalities_tpu_torch.registry.registry import Registry

    return ComponentFactory(Registry(COMPONENTS + serving_entities())).build_components(config_dict,
                                                                                       ServeInstantiationModel)


def serving_entities() -> list:
    """The `inference_component` variants of the JAX serve(): `serve`, the
    flat fleet and the disaggregated fleet."""
    from modalities_tpu_torch.registry.registry import ComponentEntity
    from modalities_tpu_torch.serving.disagg.component import DisaggComponentConfig, DisaggServingComponent
    from modalities_tpu_torch.serving.fleet.component import FleetComponentConfig, FleetServingComponent

    return [ComponentEntity("inference_component", "serve", ServingComponent, ServingComponentConfig),
            ComponentEntity("inference_component", "fleet", FleetServingComponent, FleetComponentConfig),
            ComponentEntity("inference_component", "disagg", DisaggServingComponent, DisaggComponentConfig)]


def load_serving_params(checkpoint_folder_path, device=None, quant_weights=None) -> dict:
    """A sealed training checkpoint -> serving parameters (the JAX
    `load_serving_params`): the folder must pass its manifest, then the
    model's parameters alone are read onto `device` (default: the CUDA card;
    raises without one) in the dtypes they were trained in, then quantized as
    `resolve_quant_weights_mode(quant_weights)` says (the environment before
    the config; unset: none)."""
    from modalities_tpu_torch.checkpointing.dcp.dcp_checkpoint_loading import restore_tree_single_device
    from modalities_tpu_torch.quant.weights import quantize_params, resolve_quant_weights_mode
    from modalities_tpu_torch.resilience.manifest import verify_manifest

    folder = Path(checkpoint_folder_path)
    device = resolve_device(device)
    verification = verify_manifest(folder)
    if not verification.ok:
        raise ValueError(f"refusing to serve from {folder}: checkpoint failed manifest verification "
                         f"({verification.reason})")
    params = restore_tree_single_device(folder, device=device)
    return quantize_params(params, resolve_quant_weights_mode(quant_weights))


def resolve_params(component: ServingComponent, checkpoint_folder_path, seed: int = 0) -> None:
    """Startup parameter resolution: explicit params win, then a sealed
    checkpoint (`load_serving_params`); with neither, fresh-init parameters
    drawn from a generator seeded with `seed`."""
    if component.params is not None:
        return
    if checkpoint_folder_path:
        component.params = load_serving_params(checkpoint_folder_path, device=component.device,
                                               quant_weights=component.quant_weights_setting)
        return
    logger.warning("serve: no checkpoint_folder_path — serving fresh-init params")
    generator = torch.Generator(device=component.device).manual_seed(seed)
    component.params = component.model.init_params(generator)


def serve(
    config_file_path: Path,
    requests_file_path: Optional[Path] = None,
    output_file_path: Optional[Path] = None,
    device: Optional[str] = None,
    http_port: Optional[int] = None,
    fleet: bool = False,
) -> dict:
    """Entry point behind `python -m modalities_tpu_torch serve`. A `fleet`
    or `disagg` config (`fleet` says the caller expects one, and a config
    of another variant is refused): its workers behind the router, on
    `http_port` (0 or unset = an ephemeral port), until SIGTERM/SIGINT drains
    them. Else with `http_port` (the flag or the config knob; 0 = an
    ephemeral port): the streaming HTTP front end until SIGTERM/SIGINT drains it. With a JSONL
    requests file: replay it and write the result rows (to
    `output_file_path`, or stdout). With neither: the interactive loop. Runs
    on the CUDA card unless `device="cpu"`. While HTTP or a replay serves,
    SIGTERM/SIGINT drain gracefully (admission stops, in-flight requests
    finish); the interactive loop keeps Ctrl-C, which ends it. Returns the
    engine's final stats."""
    from modalities_tpu_torch import __version__
    from modalities_tpu_torch.resilience.preemption import PreemptionHandler
    from modalities_tpu_torch.telemetry.metrics import config_hash_of, register_process_metrics

    config_dict = load_app_config_dict(config_file_path)
    components = build_serving_components(config_dict)
    component = components.serving_component
    if fleet and not hasattr(component, "run_fleet"):
        raise ValueError("--fleet needs the fleet serving component: set the config's "
                         "serving_component.variant_key to 'fleet' or 'disagg' (configs/config_fleet.yaml, "
                         "configs/config_disagg.yaml)")
    component.device = resolve_device(device)
    register_process_metrics(component.metrics, version=__version__, config_hash=config_hash_of(config_file_path))
    if hasattr(component, "resolve_params"):  # the fleet may boot from its ring
        component.resolve_params(components.settings.checkpoint_folder_path)
    else:
        resolve_params(component, components.settings.checkpoint_folder_path)
    if http_port is not None:
        component.http_port = int(http_port)
    if hasattr(component, "run_fleet"):
        handler = PreemptionHandler().install()
        component.stop_fn = handler.should_stop
        try:
            stats = component.run_fleet()
        finally:
            handler.uninstall()
        logger.info("fleet stats: %s", json.dumps(stats))
        return stats
    if component.http_port is None and requests_file_path is None:
        component.run()
        return component.build_engine().stats()
    handler = PreemptionHandler().install()
    component.stop_fn = handler.should_stop
    try:
        if component.http_port is not None:
            stats = component.run_http()
            logger.info("serve stats: %s", json.dumps(stats))
            return stats
        with open(requests_file_path) as f:
            requests = [json.loads(line) for line in f if line.strip()]
        rows = component.run_requests(requests)
        out_lines = [json.dumps(row) for row in rows]
        if output_file_path is not None:
            Path(output_file_path).write_text("\n".join(out_lines) + "\n")
        else:
            for line in out_lines:
                print(line)
        stats = component.build_engine().stats()
        logger.info("serve stats: %s", json.dumps(stats))
        return stats
    finally:
        handler.uninstall()

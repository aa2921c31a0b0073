"""`serve` entry: the DI component and config surface of the serving engine,
the port of modalities_tpu/serving/serve.py.

The engine's knobs pass through: the ring or the paged KV cache
(`kv_cache`, the `paged_*` sizes), prefix sharing, speculative decoding
(`spec_decode`) and `quant` {weights, kv}; a knob left null takes its JAX
environment switch inside the engine (MODALITIES_TPU_SERVE_KV_CACHE,
_PREFILL_CHUNKS, _SPEC_K, _PREFIX_SHARING, MODALITIES_TPU_QUANT_WEIGHTS,
MODALITIES_TPU_QUANT_KV). `prefix_sharing` and the `paged_*` sizes are ignored
on the ring cache, as the JAX engine ignores them there.

Knobs of engine features that this package does not have yet are refused when
set to anything but their default (deadlines, brownout, tenants, a bounded
queue, a device mesh and the HTTP front end: ROADMAP.md Queue 1 item 3; the
SLO block and telemetry: item 6), and so are the JAX serving environment
switches that would change what is served or what is written beside it
(`_refuse_unported_env`). So `configs/config_serve.yaml` does not load
unchanged: its `slo` block arms the JAX engine's brownout shedder, and the
port refuses it (set `slo: null`).
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
# MODALITIES_TPU_SERVE_KV_CACHE, _PREFILL_CHUNKS, _SPEC_K and _PREFIX_SHARING
# itself, as the JAX engine does.
_ENV_DEFAULTS = {
    "MODALITIES_TPU_SERVE_QUEUE_LIMIT": (lambda v: float(v) <= 0, 3),
    "MODALITIES_TPU_SERVE_DEADLINE_DEFAULT_MS": (lambda v: float(v) <= 0, 3),
    "MODALITIES_TPU_SERVE_TENANT_DEFAULT": (lambda v: v.strip() == "default", 3),
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
            "http_port": (cfg.http_port is not None, 3),
            "deadline_default_ms": (cfg.deadline_default_ms is not None, 3),
            "brownout_queue_high": (cfg.brownout_queue_high is not None, 3),
            "tenants": (bool(cfg.tenants), 3),
            "max_queue_depth": (cfg.max_queue_depth is not None, 3),
            "slo": (cfg.slo is not None, 6),  # the JAX serve() arms brownout shedding and SLO telemetry from it
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

    def build_engine(self):
        from modalities_tpu_torch.serving.engine import ServingEngine

        if self._engine is None:
            if self.params is None:
                raise ValueError("params not resolved — serve() initializes or loads them first")
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
            )
        return self._engine

    def run_requests(self, requests: list[dict]) -> list[dict]:
        """Replay parsed requests ({"prompt", "max_new_tokens"?, "temperature"?,
        "seed"?, "arrival_offset_s"?}); returns the JSONL rows of the JAX serve
        path."""
        engine = self.build_engine()
        rid_to_req = {}
        for req in requests:
            text = self.prompt_template.format(prompt=req["prompt"])
            rid = engine.submit(
                list(self.tokenizer.tokenize(text)),
                int(req.get("max_new_tokens", self.max_new_tokens)),
                temperature=req.get("temperature", self.temperature),
                seed=int(req.get("seed", self.seed)),
                arrival_offset_s=float(req.get("arrival_offset_s", 0.0)),
            )
            rid_to_req[rid] = req
        results = engine.run()
        rows = []
        for rid, req in rid_to_req.items():
            res = results[rid]
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


def build_serving_components(config_dict: dict):
    from modalities_tpu_torch.config.component_factory import ComponentFactory
    from modalities_tpu_torch.config.instantiation_models import ServeInstantiationModel
    from modalities_tpu_torch.registry.components import COMPONENTS
    from modalities_tpu_torch.registry.registry import Registry

    return ComponentFactory(Registry(COMPONENTS + serving_entities())).build_components(config_dict,
                                                                                       ServeInstantiationModel)


def serving_entities() -> list:
    """The `inference_component` variants of the JAX serve(): `serve`, and the
    fleet and disaggregated tiers, which wait on ROADMAP.md Queue 1 item 3
    (its last part)."""
    from modalities_tpu_torch.registry.registry import ComponentEntity, Unported

    return [ComponentEntity("inference_component", "serve", ServingComponent, ServingComponentConfig),
            ComponentEntity("inference_component", "fleet", Unported(3, "the serving fleet")),
            ComponentEntity("inference_component", "disagg", Unported(3, "disaggregated prefill/decode"))]


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
    requests_file_path: Path,
    output_file_path: Optional[Path] = None,
    device: Optional[str] = None,
) -> dict:
    """Entry point behind `python -m modalities_tpu_torch serve`: replay a
    JSONL requests file and write result rows (to `output_file_path`, or
    stdout). Runs on the CUDA card unless `device="cpu"`. Returns the engine's
    stats. (The JAX CLI's interactive loop is not ported.)"""
    config_dict = load_app_config_dict(config_file_path)
    components = build_serving_components(config_dict)
    component = components.serving_component
    component.device = resolve_device(device)
    resolve_params(component, components.settings.checkpoint_folder_path)
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

"""Continuous-batching decode engine over the GPT2 KV cache: the port of
modalities_tpu/serving/engine.py, with its two cache layouts, selected by
`kv_cache` (or MODALITIES_TPU_SERVE_KV_CACHE):

- `ring`: two preallocated tensors [layers, slots, capacity, kv_heads,
  head_dim] (GPT2Module.init_slot_cache). A prompt is prefilled in chunks of
  the (64, 16, 4, 1) ladder (MODALITIES_TPU_SERVE_PREFILL_CHUNKS) right at
  admission, its last chunk yielding the first token; a request whose prompt
  and generation reach the ring's end finishes "capacity".
- `paged`: ONE block pool per layer [layers, num_blocks + 1, block_size,
  kv_heads, head_dim] (GPT2Module.init_paged_cache; the extra block takes the
  writes of cells that write nowhere) plus host block tables
  (serving/paged_cache.py). Blocks are allocated on demand and the budget is
  clamped at admission to the table ceiling, so a request finishes "budget"
  or "eod", never "capacity". Admission gates on free blocks; a dry pool
  preempts the YOUNGEST slot back to the front of the queue (its blocks
  released; it restarts from its prompt with its sampler freshly seeded).
  Prefill is packed across requests: one fixed [slots, block_size] dispatch
  takes block-aligned prompt chunks FIFO over the prefilling requests.
  On top of the block tables:
  - prefix sharing (`prefix_sharing`, MODALITIES_TPU_SERVE_PREFIX_SHARING,
    default on): a prompt's leading full blocks found in the prefix index are
    forked into its table (refcount bump, no re-prefill); a full-window match
    copies its last shared block (copy-on-write) and re-forwards only the last
    prompt token;
  - speculative decoding (`spec_decode` {"k": k}, MODALITIES_TPU_SERVE_SPEC_K):
    the n-gram drafter proposes up to k tokens for each greedy slot, and ONE
    [slots, k+1] verify forward scores them; the accept length is the cumprod
    of draft matches, and the host replays the stopping rule over the
    accepted run;
  - int8 KV (`quant_kv`, MODALITIES_TPU_QUANT_KV): int8 pools with float32
    scales per (block, row, kv head), quantized on write, dequantized at the
    gather.

Decode: ONE batched forward advances every decoding slot by one token. Slots
that are idle or still prefilling compute garbage harmlessly (the ring
overwrites their rows at the next admission; the paged step writes their K/V
into the scratch block). Per-slot stopping is folded into the step on the
device, and the host makes one small fetch of (tokens, finished, ok) per
step. The paged decode step's inputs (tokens, positions, eod ids, budgets,
tables, write coordinates) live in one preallocated device tensor of fixed
shape, filled by one host-to-device copy per step, with no host sync between
its launches.

Sampling: greedy is `argmax` of the fp32 logits row. A sampled slot draws
Gumbel noise from its own `torch.Generator`, seeded with the request's seed at
admission and advanced only when that slot samples (its first token, each
decode step, column 0 of a verify forward), so a request's tokens depend on
its seed alone, never on what else is in the batch, on preemption or on
speculation. (JAX's Threefry draws cannot be reproduced in torch; greedy
tokens are what matches the JAX engine exactly.)

Batch invariance: every shape a request meets (the decode batch of `slots`
rows, the ring's prefill chunks, the packed [slots, block_size] prefill, the
[slots, k+1] verify) is the same whether it runs alone or beside others, and
no op mixes rows, so a request's tokens are bitwise the same either way.

Admission control (serving/resilience.py), each off by default, where the
engine's tokens, finish reasons and counters are those of the plain FIFO
scheduler:
- deadlines (`ServeRequest.deadline_ms`, from the request's arrival): a
  lapsed request is cancelled at the next seam, finish reason "deadline":
  seam 1 in the queue sweep before every admission round, seam 2 at every
  prefill chunk boundary (the ring's ladder, the packed prefill), seam 3 at
  every decode or verify step boundary. A cancelled slot frees its blocks.
- a bounded queue (`max_queue_depth`, MODALITIES_TPU_SERVE_QUEUE_LIMIT) and a
  brownout controller: `overload_reason` tells the HTTP layer to answer 429,
  with `retry_after_s` derived from the queue; a browned-out engine sheds
  queued work (finish reason "shed") down to the controller's low mark.
- tenants (`TenantRegistry`): weighted deficit-round-robin admission across
  tenants within a priority class, per-tenant slot quotas, token-rate limits
  at the HTTP ingress, and burn-aware victims for shedding and preemption.
- drain (`stop_fn`): admission stops, in-flight requests finish.

`on_token(rid, tok)` fires once per final token position (a preempted
request's regenerated tokens are not streamed twice), `on_finish(rid,
result)` once per request, and then the engine keeps no result of its
own (a long-running server's memory stays bounded). Every counter the JAX
engine exports is in `metrics` (telemetry/metrics.py) under the JAX names.

Hot swap: `request_swap(params)` from any thread, installed by the engine
thread at the next step boundary (`swap_weights`): the new weights are
copied into the installed tensors, so every shape and address stays fixed,
and the prefix index is flushed. The engine owns its tensors: a parameter it
would share with the caller's dict is copied at construction.

Disaggregated roles (`role`, serving/disagg/): a "prefill" engine prefills
a request to its first token, then exports the request's pool blocks and
sampler state as a sealed `HandoffRecord` (serving/disagg/handoff.py) and
finishes it "handoff"; a "decode" engine takes work only through
`import_handoff`, which validates a record (version, pool configuration,
window, digest, weights generation, sampler), queues it, and at admission
scatters its blocks into local pool blocks and arms the slot straight into
the decode step. Both roles need the paged cache; the prefill tier takes no
speculation. The export's gather and the import's scatter are plain
PyTorch, as they are plain jnp in the JAX engine.

Request tracing: every request keeps an event stream on the engine's
clock (enqueue / import_enqueue, admit, prefix_hit, prefill_chunk,
first_token, preempt, requeue, import_* and handoff_export, deadline or
shed, finish), folded at its finish into ONE `serve_request` record on the
active telemetry's sink (telemetry/__init__.py; `data analyze_serve` reads
it) with the JAX record's fields. A request's trace id is the one the fleet
propagated, or one minted at submit; it rides the result, the handoff record
and the TTFT / end-to-end histogram exemplars. The engine's phases are spans
(serve/admission, serve/prefill, serve/decode, serve/import, serve/cow,
serve/handoff_export), and each round with pending work arms the active
telemetry's hang watchdog (beat on a dispatched round, disarm on an idle
one), whose artifact carries `stats()` (the published snapshot). Tracing
reads no device value and syncs nothing: the events ride the host
bookkeeping each dispatch already does.
"""

from __future__ import annotations

import math
import os
import threading
import time
import uuid
from collections import deque
from dataclasses import dataclass, field
from pathlib import Path
from typing import Callable, Optional

import numpy as np
import torch

from modalities_tpu_torch.device import resolve_device
from modalities_tpu_torch.models.gpt2.gpt2_model import PositionTypes
from modalities_tpu_torch.quant.core import tree_bytes
from modalities_tpu_torch.quant.kv import resolve_quant_kv_mode
from modalities_tpu_torch.quant.weights import (
    infer_quant_mode,
    quantize_params,
    quantized_model,
    resolve_quant_weights_mode,
    weights_bytes_saved,
)
from modalities_tpu_torch.serving.paged_cache import BlockTableState, blocks_for_tokens
from modalities_tpu_torch.serving.resilience import TenantRegistry, deadline_expired, resolve_tenant
from modalities_tpu_torch.serving.spec_decode import propose_ngram, resolve_spec_config
from modalities_tpu_torch.resilience.faults import fire_oom_if_armed
from modalities_tpu_torch.telemetry import get_active_telemetry, span
from modalities_tpu_torch.telemetry.memscope import is_oom_error, oom_forensics
from modalities_tpu_torch.telemetry.metrics import MetricsRegistry

_DEFAULT_PREFILL_CHUNKS = (64, 16, 4, 1)  # descending, ending in 1: every prompt length fits

_IDLE_REMAINING = 2**30  # idle slots never trip the budget stop


def _prefill_chunks_from_env() -> tuple[int, ...]:
    raw = os.environ.get("MODALITIES_TPU_SERVE_PREFILL_CHUNKS")
    if not raw:
        return _DEFAULT_PREFILL_CHUNKS
    chunks = tuple(int(c) for c in raw.split(",") if c.strip())
    if not chunks or chunks[-1] != 1 or list(chunks) != sorted(chunks, reverse=True):
        raise ValueError(
            f"MODALITIES_TPU_SERVE_PREFILL_CHUNKS={raw!r}: need a descending comma "
            "list ending in 1 (e.g. '64,16,4,1')"
        )
    return chunks


def _prefix_sharing_from_env() -> bool:
    raw = os.environ.get("MODALITIES_TPU_SERVE_PREFIX_SHARING", "1").strip().lower()
    if raw in ("1", "true", "on", "yes"):
        return True
    if raw in ("0", "false", "off", "no"):
        return False
    raise ValueError(
        f"MODALITIES_TPU_SERVE_PREFIX_SHARING={raw!r}: must be a boolean "
        "(1/0/true/false/on/off)"
    )


def _kv_cache_from_env() -> str:
    raw = os.environ.get("MODALITIES_TPU_SERVE_KV_CACHE", "ring")
    if raw not in ("ring", "paged"):
        raise ValueError(f"MODALITIES_TPU_SERVE_KV_CACHE={raw!r}: must be 'ring' or 'paged'")
    return raw


@dataclass
class ServeRequest:
    """One generation request. `temperature=None` inherits the engine default
    (greedy unless set); `arrival_offset_s` is seconds after `run()` starts."""

    rid: int
    prompt_tokens: list[int]
    max_new_tokens: int
    temperature: Optional[float] = None
    seed: int = 0
    arrival_offset_s: float = 0.0
    # admission control: `deadline_ms` is the budget from arrival (None: no
    # deadline); `priority` orders brownout shedding (higher number = shed
    # first, FIFO within a class); `tenant` is the tenant charged ("" = the
    # engine runs without tenants: one implicit tenant, plain FIFO)
    deadline_ms: Optional[float] = None
    priority: int = 0
    tenant: str = ""
    # the fleet's trace id (propagated, or minted at submit) and hop: they
    # ride the request's records, its result and its handoff record
    trace_id: str = ""
    trace_hop: int = 0


@dataclass
class ServeResult:
    rid: int
    tokens: list[int] = field(default_factory=list)
    finish_reason: str = ""  # "eod" | "budget" | "capacity" | "error" | "handoff" | "deadline" | "shed"
    prompt_len: int = 0
    weights_generation: int = 0  # the generation serving when the request finished
    truncated: bool = False  # prompt window-clipped at admission
    prefix_hit_tokens: int = 0  # prompt tokens served from shared blocks (paged)
    arrival_s: float = 0.0  # engine-clock arrival
    first_token_s: float = 0.0  # engine-clock time the first token was available
    finish_s: float = 0.0
    first_emit_s: Optional[float] = None  # engine-clock time of the first emitted token (mean TPOT)
    last_token_s: Optional[float] = None  # engine-clock time of the latest token (TPOT)
    trace_id: str = ""
    trace_hop: int = 0
    # a prefill-tier engine finishes "handoff" and parks the sealed record
    # here for its caller (HTTP /disagg/prefill, the in-process pair)
    handoff: Optional[object] = None

    @property
    def ttft_s(self) -> float:
        return self.first_token_s - self.arrival_s


@dataclass
class _ImportRequest(ServeRequest):
    """A queued KV import on a decode-tier engine. It rides the queue and the
    preemption path of a plain request: a preempted import is requeued at
    the front and re-imported from its retained record."""

    record: object = None  # HandoffRecord
    pool_full_seen: bool = False  # the pool_full failure is counted once an import


@dataclass
class _SlotState:
    request: ServeRequest
    result: ServeResult
    remaining: int  # tokens still allowed, counting the one in flight
    phase: str = "decode"  # "prefill" (paged, prompt in flight) | "decode"
    window: Optional[list[int]] = None  # paged: the admitted prompt window
    prefill_pos: int = 0  # paged: prompt tokens already forwarded
    temp: float = 0.0
    seq: int = 0  # admission order: preemption picks the max (youngest)
    imported: bool = False  # seeded from a handoff: its TTFT is its first local token


class _Staging:
    """The int64 inputs of one fixed-shape dispatch: named fields over ONE
    host buffer (pinned for the card) and ONE device buffer of the same
    layout. The host fills the fields' numpy views, then `upload` moves them
    all in one copy and returns the device views."""

    def __init__(self, device: torch.device, **shapes):
        sizes = {name: math.prod(shape) for name, shape in shapes.items()}
        total = sum(sizes.values())
        self.host = torch.zeros(total, dtype=torch.long, pin_memory=device.type == "cuda")
        self.dev = torch.zeros(total, dtype=torch.long, device=device)
        host_np = self.host.numpy()
        self.np, self.views, off = {}, {}, 0
        for name, shape in shapes.items():
            self.np[name] = host_np[off : off + sizes[name]].reshape(shape)
            self.views[name] = self.dev[off : off + sizes[name]].view(shape)
            off += sizes[name]

    def upload(self) -> dict:
        self.dev.copy_(self.host, non_blocking=True)
        return self.views


class ServingEngine:
    """See module docstring. `model` is a GPT2LLM, `params` its state dict
    (fp32 from `init_params` or `params_from_jax`, or already quantized).
    Everything runs on `device` (default: the CUDA card; raises without one).
    A knob left None takes its environment switch, as in the JAX engine.
    `time_fn` replaces the engine clock (`time.monotonic`), as the JAX
    engine's does: a fake clock makes arrival-gated runs deterministic.
    `metrics` is the registry the engine's series go into (default: the
    active telemetry's, one scrape surface a process)."""

    def __init__(
        self,
        model,
        params: dict,
        *,
        device=None,
        max_batch_slots: int = 8,
        cache_capacity: Optional[int] = None,
        eod_token_id: int = -1,
        default_temperature: Optional[float] = None,
        prefill_chunks: Optional[tuple[int, ...]] = None,
        kv_cache: Optional[str] = None,
        paged_block_size: int = 16,
        paged_num_blocks: Optional[int] = None,
        paged_max_len: Optional[int] = None,
        prefix_sharing: Optional[bool] = None,
        spec_decode=None,
        quant_weights: Optional[str] = None,
        quant_kv: Optional[str] = None,
        max_queue_depth: Optional[int] = None,
        brownout=None,
        tenants: Optional[TenantRegistry] = None,
        tenant_budget_fn: Optional[Callable[[str], float]] = None,
        stop_fn: Optional[Callable[[], bool]] = None,
        on_token: Optional[Callable[[int, int], None]] = None,
        on_finish: Optional[Callable[[int, ServeResult], None]] = None,
        time_fn=None,
        metrics: Optional[MetricsRegistry] = None,
        role: str = "combined",
    ):
        if role not in ("combined", "prefill", "decode"):
            raise ValueError(f"role={role!r}: must be 'combined', 'prefill' or 'decode'")
        self.role = role
        self.device = resolve_device(device)
        self._now = time_fn if time_fn is not None else time.monotonic
        self._stop_fn = stop_fn
        self._on_token = on_token
        self._on_finish = on_finish
        self.kv_cache = kv_cache if kv_cache is not None else _kv_cache_from_env()
        if self.kv_cache not in ("ring", "paged"):
            raise ValueError(f"kv_cache={self.kv_cache!r}: must be 'ring' or 'paged'")
        self.quant_weights = resolve_quant_weights_mode(quant_weights)
        self.quant_kv = resolve_quant_kv_mode(quant_kv)
        if self.quant_kv != "none" and self.kv_cache != "paged":
            raise ValueError(
                f"quant_kv={self.quant_kv!r} requires kv_cache='paged': only the "
                "block pool stores per-block scales alongside the K/V data"
            )
        pre_mode = infer_quant_mode(params)
        if pre_mode not in ("none", self.quant_weights):
            raise ValueError(
                f"params arrive quantized as {pre_mode!r} but the engine is configured for "
                f"quant_weights={self.quant_weights!r}"
            )
        callers = {t.untyped_storage().data_ptr() for t in params.values()}
        params = {k: v.to(self.device) for k, v in params.items()}
        self.quant_bytes_saved = 0
        if self.quant_weights != "none":
            model = quantized_model(model, self.quant_weights)
            params = quantize_params(params, self.quant_weights)
            self.quant_bytes_saved = weights_bytes_saved(params)
        self.model = model
        self.module = model.build_module(params)
        # the engine owns what it serves: a hot swap copies into these tensors,
        # so none may be the caller's
        for t in [*self.module.parameters(), *self.module.buffers()]:
            if t.untyped_storage().data_ptr() in callers:
                t.data = t.data.clone()
        # what swap_weights holds a new generation to: the installed tensors
        # and the names, shapes and dtypes of the parameters as given
        self._installed = dict(self.module.state_dict())
        self._param_avals = {k: (tuple(v.shape), v.dtype) for k, v in params.items()}
        del params

        spec = model.config_spec
        spec_len = int(spec.sequence_length)
        self.slots = int(max_batch_slots)
        self.capacity = min(int(cache_capacity), spec_len) if cache_capacity else spec_len
        self.eod_token_id = int(eod_token_id)
        self.default_temperature = default_temperature
        self.prefill_chunks = tuple(prefill_chunks) if prefill_chunks else _prefill_chunks_from_env()
        self.prefix_sharing = bool(prefix_sharing) if prefix_sharing is not None else _prefix_sharing_from_env()
        self.spec = resolve_spec_config(spec_decode)
        if self.kv_cache != "paged":
            # both ride the paged block tables: on the ring sharing quietly
            # degrades to the plain path, speculation is refused
            self.prefix_sharing = False
            if self.spec.enabled:
                raise ValueError(
                    "spec_decode.k > 0 requires kv_cache='paged': the verify "
                    "forward runs through the paged block tables"
                )
        # the handoff ships pool blocks, so both tiers need the paged cache; the
        # prefill tier never decodes, so speculation there is a config error
        if self.role != "combined" and self.kv_cache != "paged":
            raise ValueError(f"role={self.role!r} requires kv_cache='paged': the KV handoff ships pool blocks")
        if self.role == "prefill" and self.spec.enabled:
            raise ValueError("role='prefill' excludes spec_decode: the prefill tier stops at the first token and "
                             "never runs a decode (or verify) forward")
        if self.slots < 1:
            raise ValueError("max_batch_slots must be >= 1")
        if self.capacity < 2:
            raise ValueError("cache_capacity must be >= 2 (1 prompt token + 1 generated)")

        if self.kv_cache == "paged":
            bs = int(paged_block_size)
            if bs < 1:
                raise ValueError(f"paged_block_size must be >= 1, got {bs}")
            # the per-request ceiling is the table width times the block size;
            # it may pass sequence_length for relative-position models
            max_len = int(paged_max_len) if paged_max_len else self.capacity
            if max_len < 2:
                raise ValueError("paged_max_len must be >= 2")
            if max_len > spec_len and spec.poe_type == PositionTypes.ABSOLUTE.value:
                raise ValueError(
                    f"paged_max_len {max_len} exceeds sequence_length {spec_len}: "
                    "ABSOLUTE position embeddings have no rows past the trained "
                    "sequence length"
                )
            self.block_size = bs
            self.table_width = blocks_for_tokens(max_len, bs)
            self.max_len = self.table_width * bs  # the ceiling rounded up to whole blocks
            self.num_blocks = int(paged_num_blocks) if paged_num_blocks else self.slots * self.table_width
            if self.num_blocks < self.table_width:
                raise ValueError(
                    f"paged_num_blocks {self.num_blocks} < table width "
                    f"{self.table_width}: one max-length request must fit the pool "
                    "(otherwise preemption livelocks)"
                )
            self.cache = self.module.init_paged_cache(self.num_blocks, bs, kv_quant=self.quant_kv)
            self._table_state = BlockTableState(self.num_blocks, bs, self.table_width)
            s, w, k1 = self.slots, self.table_width, self.spec.k + 1
            self._decode_in = _Staging(self.device, tokens=(s,), positions=(s,), eods=(s,), remaining=(s,),
                                       wblk=(s,), woff=(s,), tables=(s, w))
            self._prefill_in = _Staging(self.device, tokens=(s, bs), positions=(s, bs), wblk=(s, bs),
                                        woff=(s, bs), tables=(s, w), last_idx=(s,))
            if self.spec.enabled:
                self._verify_in = _Staging(self.device, tokens=(s, k1), positions=(s, k1), wblk=(s, k1),
                                           woff=(s, k1), tables=(s, w), prop_len=(s,))
        else:
            self.block_size = self.table_width = self.num_blocks = 0
            self.max_len = self.capacity
            self.cache = self.module.init_slot_cache(self.slots, self.capacity)
            self._table_state = None
        self.kv_pool_bytes = self.cache.nbytes
        self.kv_scale_bytes = self.cache.scale_bytes if self.kv_cache == "paged" else 0
        self.weights_bytes = tree_bytes(dict(self.module.state_dict()))

        # host-side mirrors of the per-slot state
        b = self.slots
        self._tokens = np.zeros((b,), np.int64)
        self._positions = np.zeros((b,), np.int64)
        self._temps = np.zeros((b,), np.float32)
        self._eods = np.full((b,), -1, np.int64)
        self._remaining = np.full((b,), _IDLE_REMAINING, np.int64)
        self._gens: list[Optional[torch.Generator]] = [None] * b
        self._slot_states: list[Optional[_SlotState]] = [None] * b
        if self.kv_cache == "paged":
            self._tables = np.zeros((b, self.table_width), np.int64)
            self._wblk = np.full((b,), self.num_blocks, np.int64)  # idle: the scratch block
            self._woff = np.zeros((b,), np.int64)

        self._queue: deque[ServeRequest] = deque()
        self._results: dict[int, ServeResult] = {}
        self._next_rid = 0
        self._admit_seq = 0
        # overload protection: a bounded queue (the HTTP layer's 429) and the
        # brownout controller the scheduler consults once a round; both off
        # by default
        if max_queue_depth is None:
            env_depth = int(os.environ.get("MODALITIES_TPU_SERVE_QUEUE_LIMIT", "0"))
            max_queue_depth = env_depth if env_depth > 0 else None
        self.max_queue_depth = max_queue_depth
        self.brownout = brownout
        # tenants: weighted deficit-round-robin admission (within each priority
        # class, FIFO within a tenant) and burn-aware shedding and preemption;
        # None keeps the plain FIFO scheduler
        self._tenants = tenants
        self._tenant_budget_fn = tenant_budget_fn
        self._drr_deficit: dict[str, float] = {}
        self._drr_cursor = ""
        self._tenant_stats: dict[str, dict] = {}
        self._streamed: dict[int, int] = {}  # rid -> tokens already passed to on_token
        # request tracing: rid -> its event stream and folded fields, kept
        # across preemption and flushed as one serve_request record at finish
        self._traces: dict[int, dict] = {}
        self._dispatch_seq = 0  # the watchdog's heartbeat id for dispatch rounds
        self._truncated_rids: set[int] = set()  # counted once, even across preemption
        # the distinct fixed shapes each forward ran at: the JAX engine's
        # executables (one per compiled shape), what a graph capture would hold
        self._decode_shapes: set = set()
        self._prefill_shapes: set = set()
        self._verify_shapes: set = set()
        self.decode_steps = 0  # every decode-side forward: plain and verify
        self.decode_token_count = 0
        self.prefill_chunk_count = 0  # ring: chunk dispatches; paged: packed rows
        self.prefill_dispatches = 0
        self._occupancy_sum = 0
        self.max_concurrent = 0
        self.truncated_requests = 0
        self.request_errors = 0
        self.preemptions = 0
        self.prefix_hit_requests = 0
        self.prefix_hit_blocks = 0
        self.prefix_hit_tokens = 0
        self.cow_copies = 0
        self.verify_steps = 0
        self.spec_proposed = 0
        self.spec_accepted = 0
        self.spec_emitted = 0  # tokens emitted by verify forwards
        # host wall time of the dispatches, each ending in its device fetch
        self.prefill_seconds = 0.0
        self.decode_seconds = 0.0
        self.deadline_expired_requests = 0  # finishes with reason "deadline"
        self.shed_requests = 0  # finishes with reason "shed" and refused arrivals
        # disaggregated roles: the export and import accounting
        self.handoffs_exported = 0
        self.handoffs_imported = 0
        self.import_requeues = 0
        self.imported_blocks = 0
        self.handoff_bytes_shipped = 0
        # counters above change at dispatch ends under this lock, and stats()
        # reads under it: /stats sees one snapshot, never half a dispatch
        self._stats_lock = threading.Lock()
        # the scheduler state other threads read (/stats, the scrape-time
        # gauges): published under the lock by the engine thread once submit,
        # step or swap_weights has changed it, never walked live
        self._live: dict = {}
        # hot swap: request_swap() queues weights from any thread; step()
        # installs them at the next boundary
        self.weights_generation = 0
        self.weight_swaps = 0
        self.swap_history: list[dict] = []
        self._swap_lock = threading.Lock()
        self._pending_swap: Optional[tuple] = None
        self._register_metrics(metrics if metrics is not None else get_active_telemetry().metrics)
        self._publish_live()
        # a wedged dispatch dumps the watchdog artifact with the engine's
        # published stats in its `state` section (never the live queue)
        get_active_telemetry().register_watchdog_state_provider(lambda: {"serving_engine": self.stats()})

    def _register_metrics(self, reg: MetricsRegistry) -> None:
        """The JAX engine's metric families, names, help and labels. Both
        tiers register the disaggregation families, so a scrape of either
        names every series: the prefill tier moves the handoffs and bytes,
        the decode tier the failures and the handoff latency."""
        self.metrics = reg
        self._m_ttft = reg.histogram("serve_ttft_seconds", "Time from request arrival to its first token")
        self._m_tpot = reg.histogram("serve_tpot_seconds", "Latency between consecutive generated tokens")
        self._m_queue_wait = reg.histogram("serve_queue_wait_seconds", "Time from enqueue/requeue to slot admission")
        self._m_e2e = reg.histogram("serve_e2e_latency_seconds", "Time from request arrival to finish")
        self._m_submitted = reg.counter("serve_requests_submitted_total", "Requests accepted by submit()")
        self._m_finished = reg.counter("serve_requests_finished_total", "Finished requests by finish reason")
        self._m_tokens = reg.counter("serve_tokens_generated_total", "Generated tokens emitted to clients")
        self._m_prompt_tokens = reg.counter("serve_prompt_tokens_total", "Prompt tokens accepted at submit()")
        self._m_prefill_chunks = reg.counter("serve_prefill_chunks_total",
                                             "Prefill chunk dispatches (ring) / packed rows (paged)")
        self._m_decode_steps = reg.counter("serve_decode_steps_total", "Batched decode dispatches")
        self._m_preempt = reg.counter("serve_preemptions_total", "Slots preempted on paged pool exhaustion")
        self._m_trunc = reg.counter("serve_truncated_requests_total", "Requests whose prompt was window-clipped")
        # scheduler gauges read, at scrape time, the engine thread's latest snapshot
        reg.gauge("serve_active_slots", "Slots holding a live request").set_fn(lambda: self._live_value("active_slots"))
        reg.gauge("serve_queue_depth", "Requests waiting in the FIFO queue").set_fn(
            lambda: self._live_value("queue_depth"))
        reg.gauge("serve_slot_occupancy_ratio",
                  "Decoding slots over total slots, cumulative mean").set_fn(self._occupancy_ratio)
        reg.gauge("serve_slots_total", "Configured max_batch_slots").set(self.slots)
        self._m_prefix_hit_blocks = reg.counter("serve_prefix_hit_blocks_total",
                                                "Prompt blocks served from the prefix index")
        self._m_prefix_hit_requests = reg.counter("serve_prefix_hit_requests_total",
                                                  "Admissions that forked shared prefix blocks")
        self._m_cow = reg.counter("serve_cow_copies_total", "Copy-on-write block copies (shared block first write)")
        self._m_spec_proposed = reg.counter("serve_spec_proposed_total",
                                            "Draft tokens proposed to the spec-decode verifier")
        self._m_spec_accepted = reg.counter("serve_spec_accepted_total",
                                            "Draft tokens accepted by the spec-decode verifier")
        self._m_swaps = reg.counter("serve_weight_swaps_total", "Hot weight swaps installed by the engine")
        self._m_req_errors = reg.counter("serve_request_errors_total",
                                         "Requests finished with reason=error (non-finite logits)")
        self._m_deadline_expired = reg.counter(
            "serve_deadline_expired_total", "Requests cancelled at a scheduler seam after their deadline expired")
        self._m_shed = reg.counter(
            "serve_shed_total",
            "Requests shed under overload, by reason (brownout = queued work "
            "dropped by the SLO shedder, queue_full/brownout_reject = new "
            "arrivals refused with 429 at the HTTP layer)",
        )
        # every tenant series carries a tenant label; the families exist on a
        # tenant-off engine, their series once tenants move traffic
        self._m_tenant_requests = reg.counter("serve_tenant_requests_total", "Requests accepted by submit(), by tenant")
        self._m_tenant_tokens = reg.counter("serve_tenant_tokens_total", "Generated tokens delivered, by tenant")
        self._m_tenant_shed = reg.counter(
            "serve_tenant_shed_total",
            "Requests shed under overload, by tenant (brownout sheds + HTTP-layer 429 rejections)",
        )
        self._m_tenant_preempt = reg.counter("serve_tenant_preemptions_total",
                                             "Slots preempted on pool exhaustion, by tenant")
        self._m_tenant_rate_limited = reg.counter("serve_tenant_rate_limited_total",
                                                  "Requests refused 429 by the per-tenant token-rate bucket")
        self._m_tenant_active = reg.gauge("serve_tenant_active_slots", "Slots holding a live request, by tenant")
        if self._tenants is not None:
            for name in self._tenants.names():
                self._m_tenant_active.set_fn(
                    lambda n=name: self._live_value("tenant_slots").get(n, 0), tenant=name)
        self._m_generation = reg.gauge("serve_weights_generation", "Weights generation currently installed")
        self._m_generation.set(0)
        reg.gauge("serve_kv_pool_bytes",
                  "Device bytes held by the serving KV cache (pools + quant scales)").set(self.kv_pool_bytes)
        reg.gauge("serve_quant_weights_bytes_saved",
                  "Param bytes saved by weight-only quantization (net of scale arrays)").set(self.quant_bytes_saved)
        reg.gauge("serve_quant_mode_info",
                  "Active quantization modes as labels (weights=, kv=); value is always 1").set(
            1.0, weights=self.quant_weights, kv=self.quant_kv)
        if self.kv_cache == "paged":
            reg.gauge("serve_paged_free_blocks", "Free blocks in the paged KV pool").set_fn(
                lambda: self._live_value("free_blocks"))
            reg.gauge("serve_paged_total_blocks", "Configured paged KV pool size").set(self.num_blocks)
            reg.gauge("serve_shared_blocks", "Pool blocks referenced by more than one table").set_fn(
                lambda: self._live_value("shared_blocks"))
        self._m_handoffs = reg.counter("disagg_handoffs_total", "KV handoff records exported by the prefill tier")
        self._m_handoff_failures = reg.counter(
            "disagg_handoff_failures_total",
            "Handoff imports rejected or requeued, by reason "
            "(pool_full, digest_mismatch, generation_mismatch, peer_down, ...)")
        self._m_kv_shipped = reg.counter("disagg_kv_bytes_shipped_total",
                                         "KV payload bytes shipped across the prefill->decode tier boundary")
        self._m_handoff_seconds = reg.histogram(
            "disagg_handoff_seconds",
            "Handoff latency: prefill-side export (or import arrival) to the "
            "decode-tier slot being seeded")

    # ---------------------------------------------------------------- hot swap
    def request_swap(self, params: dict, generation: Optional[int] = None) -> threading.Event:
        """Queue a weight swap from any thread; the engine thread installs it
        at the next step() boundary (between dispatches, never mid-token).
        Returns an event set once the swap is installed. Only the latest
        pending swap survives: a superseded one has its event set unapplied."""
        done = threading.Event()
        with self._swap_lock:
            if self._pending_swap is not None:
                self._pending_swap[2].set()
            self._pending_swap = (params, generation, done)
        return done

    def _maybe_apply_swap(self) -> None:
        with self._swap_lock:
            pending, self._pending_swap = self._pending_swap, None
        if pending is None:
            return
        params, generation, done = pending
        try:
            self.swap_weights(params, generation)
        finally:
            done.set()

    def swap_weights(self, params: dict, generation: Optional[int] = None) -> dict:
        """Install new weights between steps. Slots, cache and queue are
        untouched: in-flight requests continue under the new weights. `params`
        must be what the engine was built from (the same names, shapes and
        dtypes, quantized the same way, as `load_serving_params` gives); each
        is copied into the installed tensor, cast to its dtype as the
        constructor casts, so no shape, dtype or address changes. The prefix
        index is flushed: resident KV was computed under the old weights.
        `generation` may move backward (a rollback re-installs the donor).
        Call from the engine thread; other threads go through request_swap()."""
        start = self._now()
        gen = int(generation) if generation is not None else self.weights_generation + 1
        # quantization drift first: a generation quantized otherwise than the
        # installed one would change serving numerics mid-flight
        offered = infer_quant_mode(params)
        if offered != self.quant_weights:
            from modalities_tpu_torch.resilience.events import record_event

            record_event("fleet/rollback", stage="quant", installed=self.quant_weights, offered=offered,
                         generation=gen)
            raise ValueError(
                f"swap_weights: quantization mode drift (installed {self.quant_weights!r}, offered {offered!r}) "
                "— every generation must be quantized through the same load_serving_params seam"
            )
        if set(params) != set(self._param_avals):
            raise ValueError(
                f"swap_weights: param tree changed ({sorted(set(params) ^ set(self._param_avals))} differ) — "
                "a hot swap must keep the architecture identical"
            )
        for name, (shape, dtype) in self._param_avals.items():
            new = params[name]
            if (tuple(new.shape), new.dtype) != (shape, dtype):
                raise ValueError(
                    f"swap_weights: {name} {tuple(new.shape)}/{new.dtype} does not match the installed "
                    f"{shape}/{dtype} — the installed tensors keep their shapes and addresses"
                )
        with torch.no_grad():
            for name, dst in self._installed.items():
                dst.copy_(params[name])
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        in_flight = self._active_count()
        flushed = 0
        if self._table_state is not None and self.prefix_sharing:
            flushed = self._table_state.flush_prefix_index()
        self.weights_generation = gen
        latency = self._now() - start
        with self._stats_lock:
            self.weight_swaps += 1
        self._m_swaps.inc()
        self._m_generation.set(gen)
        record = {"generation": gen, "latency_s": latency, "in_flight": in_flight, "prefix_entries_flushed": flushed}
        self.swap_history.append(record)
        get_active_telemetry().emit_event("serve/weight_swap", dict(record))
        self._publish_live()
        return record

    # ---------------------------------------------------------------- sampling
    def _sample(self, rows, slots: list):
        """Tokens for logits `rows` [R, V] (fp32): argmax, except where the slot
        listed for that row samples: then argmax(row / temp + Gumbel noise)
        with noise from the slot's own generator. A row listed as None (or
        beyond the list) takes argmax and draws nothing."""
        toks = rows.argmax(dim=-1)
        for i, slot in enumerate(slots):
            temp = float(self._temps[slot]) if slot is not None else 0.0
            if temp > 0.0:
                u = torch.rand(rows.shape[-1], generator=self._gens[slot], device=rows.device)
                gumbel = -torch.log(-torch.log(u.clamp_min(torch.finfo(torch.float32).tiny)))
                toks[i] = (rows[i] / max(temp, 1e-6) + gumbel).argmax()
        return toks

    def _decoding_slots(self) -> list:
        return [i if s is not None and s.phase == "decode" else None for i, s in enumerate(self._slot_states)]

    # -------------------------------------------------------------- submission
    def submit(
        self,
        prompt_tokens: list[int],
        max_new_tokens: int,
        temperature: Optional[float] = ...,
        seed: int = 0,
        arrival_offset_s: float = 0.0,
        deadline_ms: Optional[float] = None,
        priority: int = 0,
        tenant: str = "",
        trace_id: Optional[str] = None,
        trace_hop: int = 0,
    ) -> int:
        if self.role == "decode":
            raise ValueError("role='decode' engines take work via import_handoff(), not submit(): the decode tier "
                             "never prefills a raw prompt")
        if not prompt_tokens:
            raise ValueError("empty prompt: the engine needs at least one prompt token")
        rid = self._next_rid
        self._next_rid += 1
        temp = self.default_temperature if temperature is ... else temperature
        # honour a propagated trace id (the router's X-Trace-Id), else mint
        # one: every record this request produces carries the same id
        req = ServeRequest(
            rid=rid,
            prompt_tokens=[int(t) for t in prompt_tokens],
            max_new_tokens=int(max_new_tokens),
            temperature=temp,
            seed=int(seed),
            arrival_offset_s=float(arrival_offset_s),
            deadline_ms=float(deadline_ms) if deadline_ms else None,
            priority=int(priority),
            tenant=str(tenant or ""),
            trace_id=str(trace_id or uuid.uuid4().hex[:16]),
            trace_hop=int(trace_hop or 0),
        )
        self._queue.append(req)
        self._open_trace(req)
        self._trace_event(rid, "enqueue", max(float(arrival_offset_s), 0.0))
        self._m_submitted.inc()
        self._m_prompt_tokens.inc(len(prompt_tokens))
        if tenant:
            self._m_tenant_requests.inc(tenant=tenant)
            self._tenant_stat(tenant, "submitted")
        self._publish_live()
        return rid

    # ------------------------------------------------------------ disagg imports
    def _check_import_generation(self, record, trace_id: str = "") -> None:
        """KV computed under other weights must never splice in: the decode
        would be silently wrong in a way no digest catches. Recorded as a
        `fleet/rollback stage=generation` event, as in the JAX engine."""
        from modalities_tpu_torch.resilience.events import record_event
        from modalities_tpu_torch.serving.disagg.handoff import HandoffRejected

        if int(record.generation) != int(self.weights_generation):
            record_event("fleet/rollback", stage="generation", offered=int(record.generation),
                         installed=int(self.weights_generation), trace_id=trace_id or record.trace_id)
            raise HandoffRejected(
                "generation_mismatch",
                f"handoff KV computed under weights generation {record.generation} cannot splice under generation "
                f"{self.weights_generation}: re-prefill on the current generation instead")

    def _sampler_words(self) -> int:
        """uint32 words of this engine's generator state (4 on the card, 1264 on the CPU)."""
        return torch.Generator(device=self.device).get_state().numel() // 4

    def import_handoff(self, record, *, arrival_offset_s: float = 0.0, trace_id: Optional[str] = None,
                       trace_hop: int = 0) -> int:
        """Decode tier: validate a sealed HandoffRecord and queue it for slot
        seeding. The checks (version, pool configuration, window, digest,
        weights generation, and for a sampled record the sampler state) run
        here, so a bad record fails the caller at once: raises
        HandoffRejected and counts `disagg_handoff_failures_total{reason}`.
        Admission (local blocks, the payload's scatter, the slot armed) runs
        in step() under the invariants of a plain request: a full pool
        leaves the import queued."""
        from modalities_tpu_torch.serving.disagg.handoff import HANDOFF_VERSION, HandoffRejected

        if self.role != "decode":
            raise ValueError(f"import_handoff() needs role='decode' (engine is {self.role!r})")
        try:
            if int(record.version) != HANDOFF_VERSION:
                raise HandoffRejected("version_mismatch", f"handoff version {record.version} != engine {HANDOFF_VERSION}")
            if int(record.block_size) != self.block_size:
                raise HandoffRejected("config_mismatch",
                                      f"handoff block_size {record.block_size} != pool {self.block_size}")
            if str(record.quant_kv) != self.quant_kv:
                raise HandoffRejected("config_mismatch", f"handoff quant_kv {record.quant_kv!r} != pool {self.quant_kv!r}")
            if len(record.window) < 1 or len(record.window) > self.max_len - 1:
                raise HandoffRejected("config_mismatch",
                                      f"handoff window {len(record.window)} tokens does not fit max_len {self.max_len}")
            record.verify_digest()
            self._check_import_generation(record, trace_id or "")
            if float(record.temperature) > 0.0 and len(record.key) != self._sampler_words():
                # a Threefry key (JAX) or another device's generator: the
                # continuation would sample from the wrong stream
                raise HandoffRejected(
                    "sampler_mismatch",
                    f"a sampled record carries a {len(record.key)}-word sampler key; this engine's "
                    f"{self.device.type} generator state has {self._sampler_words()} words")
        except HandoffRejected as exc:
            self._m_handoff_failures.inc(reason=exc.reason)
            raise
        rid = self._next_rid
        self._next_rid += 1
        req = _ImportRequest(
            rid=rid,
            prompt_tokens=[int(t) for t in record.window],
            max_new_tokens=int(record.remaining),
            temperature=float(record.temperature),
            seed=int(record.seed),
            arrival_offset_s=float(arrival_offset_s),
            # the deadline rides the record (outside the digest) and restarts
            # from this tier's arrival; the tenant rides it the same way
            deadline_ms=float(record.deadline_ms) if record.deadline_ms else None,
            tenant=str(record.tenant or ""),
            trace_id=str(trace_id or record.trace_id or uuid.uuid4().hex[:16]),
            trace_hop=int(trace_hop or record.trace_hop),
            record=record,
        )
        self._queue.append(req)
        self._open_trace(req)
        self._trace_event(rid, "import_enqueue", max(float(arrival_offset_s), 0.0), blocks=record.num_blocks,
                          kv_bytes=record.kv_bytes, source_rid=int(record.rid))
        self._m_submitted.inc()
        self._publish_live()
        return rid

    def _admit_imports(self, t0: float) -> None:
        """Decode tier: seed idle slots from queued imports (FIFO,
        arrival-gated, the pool gate BEFORE the head leaves the queue).
        Seeding allocates local blocks, scatters the payload in (int8 data
        and float32 scales verbatim), registers the prompt in the prefix
        index and arms the slot where the combined engine stands after its
        prefill: the last token pending at position len(window), the sampler
        past the first draw. A full pool leaves the head queued and counts
        ONE `disagg_handoff_failures_total{reason=pool_full}` an import."""
        for slot in range(self.slots):
            if not self._queue:
                break
            if self._slot_states[slot] is not None:
                continue
            now = self._now() - t0
            req = self._queue[0]
            if req.arrival_offset_s > now:
                break  # FIFO: later imports can't jump an unarrived head
            with span("serve/import"):
                if not self._admit_import(slot, req, now, t0):
                    break

    def _admit_import(self, slot: int, req: "_ImportRequest", now: float, t0: float) -> bool:
        """Seed `slot` from the head import `req`; False when the pool cannot
        take it (the head stays queued)."""
        from modalities_tpu_torch.serving.disagg.handoff import HandoffRejected, restore_generator

        ts = self._table_state
        record = req.record
        window = [int(t) for t in record.window]
        wl = len(window)
        matched = ts.match_prefix(window) if self.prefix_sharing else []
        nblk = blocks_for_tokens(wl, self.block_size)
        need = nblk - len(matched)  # the first decode write past wl is _ensure_decode_blocks' job
        if ts.pool.free_count < need:
            if not req.pool_full_seen:  # once an import, not once a round
                req.pool_full_seen = True
                with self._stats_lock:
                    self.import_requeues += 1
                self._m_handoff_failures.inc(reason="pool_full")
                self._trace_event(req.rid, "import_requeue", now, free=ts.pool.free_count, need=need)
            return False
        result = ServeResult(rid=req.rid, prompt_len=int(record.prompt_len) or wl,
                             arrival_s=max(req.arrival_offset_s, 0.0), truncated=bool(record.truncated),
                             trace_id=req.trace_id, trace_hop=req.trace_hop)
        # a hot swap may have landed since import_handoff(): stale KV
        # finishes "error" here instead of decoding garbage
        try:
            self._check_import_generation(record)
        except HandoffRejected as exc:
            self._queue.popleft()
            self._m_handoff_failures.inc(reason=exc.reason)
            self._trace_event(req.rid, "import_rejected", now, reason=exc.reason)
            result.first_token_s = self._now() - t0
            self._record_result(result, "error", result.first_token_s, req.tenant)
            return True
        self._queue.popleft()
        self._trace_admit(req.rid, now)
        if matched:
            ts.fork_prefix(req.rid, matched)
        if not ts.ensure(req.rid, wl):
            raise AssertionError("import admission gate let a dry pool through")
        # scatter the unmatched tail only: matched blocks hold the same
        # KV already (same tokens, same weights generation)
        scattered = self._scatter_import(record, ts.blocks(req.rid), len(matched), nblk)
        if self.prefix_sharing:
            ts.register_prefix(req.rid, window, upto=wl)
        if matched:
            hit_tokens = min(len(matched) * self.block_size, wl)
            result.prefix_hit_tokens = hit_tokens
            with self._stats_lock:
                self.prefix_hit_requests += 1
                self.prefix_hit_blocks += len(matched)
                self.prefix_hit_tokens += hit_tokens
            self._m_prefix_hit_requests.inc()
            self._m_prefix_hit_blocks.inc(len(matched))
            self._trace_event(req.rid, "prefix_hit", now, blocks=len(matched), tokens=hit_tokens)
        # the window grows by the shipped token, so the n-gram drafter sees
        # the combined path's context
        temp = float(record.temperature)
        self._slot_states[slot] = _SlotState(request=req, result=result, remaining=int(record.remaining),
                                             phase="decode", window=window + [int(record.last_token)],
                                             temp=temp, seq=self._admit_seq, imported=True)
        self._admit_seq += 1
        self._tokens[slot] = int(record.last_token)
        self._positions[slot] = wl
        self._temps[slot] = temp
        self._eods[slot] = self.eod_token_id
        self._remaining[slot] = int(record.remaining)
        self._gens[slot] = torch.Generator(device=self.device).manual_seed(int(record.seed))
        if temp > 0.0:
            restore_generator(self._gens[slot], record.key)
        with self._stats_lock:
            self.handoffs_imported += 1
            self.imported_blocks += scattered
        self._m_handoff_seconds.observe(max(0.0, now - max(req.arrival_offset_s, 0.0)), exemplar=req.trace_id)
        self._trace_event(req.rid, "import_seeded", now, blocks=nblk, scattered=scattered, kv_bytes=record.kv_bytes)
        return True

    def _pool_leaves(self) -> list:
        """The pool tensors in the JAX cache tree's flatten order (cached_key,
        cached_key_scale, cached_value, cached_value_scale)."""
        c = self.cache
        return [t for t in (c.k, c.k_scale, c.v, c.v_scale) if t is not None]

    def _scatter_import(self, record, table: list, first: int, nblk: int) -> int:
        """Write the record's blocks first..nblk-1 into this pool at the
        table's block ids (every leaf, from the JAX payload layout [n,
        layers, ...] to the pool's [layers, blocks, ...]). Returns the blocks
        written."""
        if first >= nblk:
            return 0
        with torch.inference_mode():
            idx = torch.tensor(table[first:nblk], dtype=torch.long, device=self.device)
            for pool, leaf in zip(self._pool_leaves(), record.payload):
                rows = leaf[first:nblk].to(self.device, non_blocking=True)
                pool.index_copy_(1, idx, rows.transpose(0, 1))
        return nblk - first

    def _export_handoff(self, state: _SlotState, slot: int, first_tok: int, remaining: int, now: float):
        """Prefill tier: gather the request's blocks (position order, the
        scratch block never) to host memory in the JAX payload layout and
        seal them with the sampler state into a HandoffRecord. An int8 pool
        ships its int8 data and float32 scales verbatim."""
        from modalities_tpu_torch.serving.disagg.handoff import (
            HANDOFF_VERSION,
            HandoffRecord,
            generator_key,
            greedy_key,
        )

        req, result = state.request, state.result
        wl = len(state.window)
        blocks = self._table_state.blocks(req.rid)[: blocks_for_tokens(wl, self.block_size)]
        # not inference mode: the record's tensors are its owner's, writable anywhere
        with span("serve/handoff_export"), torch.no_grad():
            idx = torch.tensor(blocks, dtype=torch.long, device=self.device)
            payload = [pool.index_select(1, idx).transpose(0, 1).contiguous().cpu() for pool in self._pool_leaves()]
        key = generator_key(self._gens[slot]) if state.temp > 0.0 else greedy_key(req.seed)
        record = HandoffRecord(
            version=HANDOFF_VERSION, generation=int(self.weights_generation), quant_kv=self.quant_kv,
            block_size=self.block_size, window=list(state.window), last_token=int(first_tok), key=key,
            temperature=float(state.temp), remaining=int(remaining), seed=int(req.seed), payload=payload,
            trace_id=req.trace_id, trace_hop=req.trace_hop, rid=req.rid, prompt_len=len(req.prompt_tokens),
            truncated=bool(result.truncated), deadline_ms=req.deadline_ms, tenant=req.tenant,
        ).seal()
        with self._stats_lock:
            self.handoffs_exported += 1
            self.handoff_bytes_shipped += record.kv_bytes
        self._m_handoffs.inc()
        self._m_kv_shipped.inc(record.kv_bytes)
        self._trace_event(req.rid, "handoff_export", now, blocks=record.num_blocks, kv_bytes=record.kv_bytes)
        return record

    def _first_local_token(self, state: _SlotState, now: float) -> None:
        """An imported slot's TTFT is its first LOCAL token (the request's
        second overall: the first rode in the handoff record)."""
        if state.imported and state.result.last_token_s is None:
            state.result.first_token_s = now
            self._record_first_token(state.result, now)

    # -------------------------------------------------------------- scheduling
    def _stopping(self) -> bool:
        return self._stop_fn is not None and bool(self._stop_fn())

    # ---------------------------------------------------------------- tracing
    def _open_trace(self, req: ServeRequest) -> None:
        self._traces[req.rid] = {"events": [], "preemptions": 0, "wait_from": max(req.arrival_offset_s, 0.0),
                                 "queue_wait_s": 0.0, "trace_id": req.trace_id, "trace_hop": req.trace_hop,
                                 "tenant": req.tenant}

    def _trace_event(self, rid: int, name: str, t: float, **fields) -> None:
        trace = self._traces.get(rid)
        if trace is not None:
            trace["events"].append({"name": name, "t": round(float(t), 6), **fields})

    def _trace_admit(self, rid: int, now: float) -> None:
        """Admission closes the request's current queue wait (opened at its
        arrival or its last requeue) and observes it."""
        self._trace_event(rid, "admit", now)
        trace = self._traces.get(rid)
        if trace is not None:
            wait = max(0.0, now - trace["wait_from"])
            trace["queue_wait_s"] += wait
            self._m_queue_wait.observe(wait)

    def _record_first_token(self, result: ServeResult, now: float) -> None:
        """The first token of an admission. TTFT is observed once a request: a
        preempted request's replay fires the trace event again (the timeline
        shows both) but not the histogram sample (the client saw the first)."""
        self._trace_event(result.rid, "first_token", now)
        trace = self._traces.get(result.rid)
        if trace is None or not trace.get("ttft_observed"):
            if trace is not None:
                trace["ttft_observed"] = True
            self._m_ttft.observe(max(0.0, now - result.arrival_s), exemplar=result.trace_id or None)

    def _flush_trace(self, result: ServeResult) -> None:
        """At the finish: fold the request's stream into ONE serve_request
        record on the active telemetry's sink (the JAX record's fields; mean
        TPOT from the first and the last emitted token of the final run)."""
        trace = self._traces.pop(result.rid, None)
        if trace is None:
            return
        n = len(result.tokens)
        tpot_mean = (result.last_token_s - result.first_emit_s) / (n - 1) if n >= 2 else None
        get_active_telemetry().emit_serve_trace({
            "rid": result.rid,
            "trace_id": result.trace_id,
            "hop": result.trace_hop,
            # a tier's records are tagged with its role, a combined engine's are not
            **({"role": self.role} if self.role != "combined" else {}),
            **({"tenant": trace["tenant"]} if trace.get("tenant") else {}),
            "prompt_len": result.prompt_len,
            "tokens": n,
            "finish_reason": result.finish_reason,
            "truncated": result.truncated,
            "weights_generation": result.weights_generation,
            "prefix_hit_tokens": result.prefix_hit_tokens,
            "spec_proposed": trace.get("spec_proposed", 0),
            "spec_accepted": trace.get("spec_accepted", 0),
            "preemptions": trace["preemptions"],
            "arrival_s": round(result.arrival_s, 6),
            "queue_wait_s": round(trace["queue_wait_s"], 6),
            "ttft_s": round(result.ttft_s, 6),
            "e2e_s": round(result.finish_s - result.arrival_s, 6),
            "tpot_mean_s": round(tpot_mean, 6) if tpot_mean is not None else None,
            "events": trace["events"],
        })

    def _emit_token(self, result: ServeResult, tok: int, now: float) -> None:
        """Append and stream a token. `_streamed` survives preemption (the
        replay regenerates the same tokens), so `on_token` fires exactly once
        per final token position."""
        if result.last_token_s is not None:
            self._m_tpot.observe(max(0.0, now - result.last_token_s))
        else:
            result.first_emit_s = now
        result.tokens.append(tok)
        result.last_token_s = now
        n = len(result.tokens)
        if n > self._streamed.get(result.rid, 0):
            self._streamed[result.rid] = n
            self._m_tokens.inc()
            if self._on_token is not None:
                self._on_token(result.rid, tok)

    def _record_result(self, result: ServeResult, reason: str, now: float, tenant: str = "") -> None:
        result.finish_reason = reason
        result.finish_s = now
        result.weights_generation = self.weights_generation
        if reason == "error":
            with self._stats_lock:
                self.request_errors += 1
            self._m_req_errors.inc()
        if tenant:
            self._tenant_stat(tenant, "finished")
            if result.tokens:
                self._m_tenant_tokens.inc(len(result.tokens), tenant=tenant)
                self._tenant_stat(tenant, "tokens", len(result.tokens))
        if self._on_finish is None:  # else the callback takes it: a server keeps no result
            self._results[result.rid] = result
        self._streamed.pop(result.rid, None)
        self._trace_event(result.rid, "finish", now, reason=reason, tokens=len(result.tokens),
                          truncated=result.truncated)
        self._m_finished.inc(reason=reason)
        self._m_e2e.observe(max(0.0, now - result.arrival_s), exemplar=result.trace_id or None)
        self._flush_trace(result)
        if self._on_finish is not None:
            self._on_finish(result.rid, result)

    def _clear_slot(self, slot: int) -> None:
        self._slot_states[slot] = None
        self._remaining[slot] = _IDLE_REMAINING
        self._eods[slot] = -1
        self._temps[slot] = 0.0
        self._positions[slot] = 0  # idle rows decode at position 0
        self._gens[slot] = None
        if self.kv_cache == "paged":
            self._tables[slot] = 0
            self._wblk[slot] = self.num_blocks

    def _finish(self, slot: int, reason: str, now: float) -> None:
        state = self._slot_states[slot]
        if self._table_state is not None:
            self._table_state.release(state.request.rid)
        self._record_result(state.result, reason, now, state.request.tenant)
        self._clear_slot(slot)

    # ---------------------------------------------------- admission control
    def _deadline_expired(self, req: ServeRequest, now: float) -> bool:
        return deadline_expired(req.arrival_offset_s, req.deadline_ms, now)

    def overload_reason(self) -> Optional[str]:
        """Why new work should be refused right now (None = admit): the HTTP
        layer turns it into a 429 with Retry-After."""
        if self.max_queue_depth is not None and len(self._queue) >= self.max_queue_depth:
            return "queue_full"
        if self.brownout is not None and self.brownout.active:
            return "brownout_reject"
        return None

    def note_rejected(self, reason: str, tenant: str = "") -> None:
        """Count one refused arrival (the HTTP layer's 429) on the shed
        counter, so shedding has one metric family whatever the seam."""
        with self._stats_lock:
            self.shed_requests += 1
        self._m_shed.inc(reason=reason)
        if tenant:
            self._m_tenant_shed.inc(tenant=tenant)
            self._tenant_stat(tenant, "shed")
            if reason == "rate_limited":
                self._m_tenant_rate_limited.inc(tenant=tenant)
                self._tenant_stat(tenant, "rate_limited")

    def _tenant_stat(self, tenant: str, key: str, amount: int = 1) -> None:
        with self._stats_lock:
            bucket = self._tenant_stats.setdefault(
                tenant, {"submitted": 0, "finished": 0, "tokens": 0, "shed": 0, "preemptions": 0, "rate_limited": 0})
            bucket[key] += amount

    def _tenant_slot_counts(self) -> dict[str, int]:
        counts: dict[str, int] = {}
        for s in self._slot_states:
            if s is not None:
                counts[s.request.tenant] = counts.get(s.request.tenant, 0) + 1
        return counts

    def _tenant_budget_remaining(self, tenant: str) -> float:
        """This tenant's error budget still unburned (1 = untouched): the
        tenant with more left is the preferred victim."""
        if self._tenant_budget_fn is None:
            return 1.0
        try:
            return float(self._tenant_budget_fn(tenant))
        except Exception:
            return 1.0

    def _demand_weight(self, slot_counts: dict[str, int]) -> float:
        names = set(slot_counts) | {r.tenant for r in self._queue}
        return sum(self._tenants.spec(n).weight for n in names if n)

    def _victim_key(self, tenant: str, slot_counts: dict[str, int], total_weight: float) -> tuple:
        """Burn-aware victim order (max = preferred victim): over-quota or
        over-fair-share tenants first, then bulk before interactive, then the
        least-burned error budget."""
        spec = self._tenants.spec(tenant)
        count = slot_counts.get(tenant, 0)
        fair = self.slots * spec.weight / total_weight if total_weight > 0 else self.slots
        over_quota = spec.max_slots is not None and count > spec.max_slots
        over = over_quota or count > fair
        return (1 if over else 0, 1 if spec.is_bulk else 0, self._tenant_budget_remaining(tenant))

    def resolve_submit_tenant(self, value) -> str:
        """Ingress tenant resolution, shared by both front ends: with tenants
        a missing or blank id maps to the default tenant; without, every id
        collapses to the implicit "" tenant."""
        if self._tenants is None:
            return ""
        return resolve_tenant(value)

    def tenant_reject_reason(self, tenant: str, max_new_tokens: int):
        """Per-tenant admission gate for the HTTP layer, before submit():
        None to admit (the token bucket was charged `max_new_tokens`), else
        ("rate_limited", retry_after_s) with the refill-derived wait."""
        if self._tenants is None or not tenant:
            return None
        retry_after = self._tenants.rate_limit_retry_after_s(tenant, float(max_new_tokens), self._now())
        if retry_after is None:
            return None
        return ("rate_limited", retry_after)

    def retry_after_s(self, reason: str) -> float:
        """Derived Retry-After for an overload rejection: the requests in
        excess of where the reason clears, over the parallel drain width (one
        slot retires about one request a recovery interval). At least 1 s."""
        depth = len(self._queue)
        if reason == "queue_full" and self.max_queue_depth is not None:
            excess = depth - self.max_queue_depth + 1
        elif reason == "brownout_reject" and self.brownout is not None:
            excess = depth - int(self.brownout.queue_low)  # recovery needs the queue at queue_low
        else:
            return 1.0
        return float(max(1, -(-max(excess, 0) // max(self.slots, 1))))

    def _next_admittable(self, now: float) -> Optional[ServeRequest]:
        """Pop the next request to admit (None = nothing admissible). Without
        tenants: the FIFO head, arrival-gated (later requests never jump an
        unarrived head). With tenants: weighted deficit-round-robin."""
        if self._tenants is None:
            if not self._queue:
                return None
            req = self._queue[0]
            if req.arrival_offset_s > now:
                return None
            self._queue.popleft()
            return req
        req = self._drr_pick(self._drr_candidates(now, set()))
        if req is not None:
            self._queue.remove(req)
        return req

    def _drr_candidates(self, now: float, blocked: set) -> dict[str, ServeRequest]:
        """Per-tenant admission heads: for each tenant (not `blocked`, not at
        its slot quota) the first queued arrived request of the best (lowest
        number) priority class present: DRR works within one class at a
        time, FIFO within (tenant, class)."""
        counts = self._tenant_slot_counts()
        eligible = []
        for r in self._queue:
            if r.arrival_offset_s > now or r.tenant in blocked:
                continue
            spec = self._tenants.spec(r.tenant)
            if spec.max_slots is not None and counts.get(r.tenant, 0) >= spec.max_slots:
                continue
            eligible.append(r)
        if not eligible:
            return {}
        best = min(r.priority for r in eligible)
        heads: dict[str, ServeRequest] = {}
        for r in eligible:
            if r.priority == best and r.tenant not in heads:
                heads[r.tenant] = r
        return heads

    def _drr_pick(self, heads: dict[str, ServeRequest]) -> Optional[ServeRequest]:
        """One weighted deficit-round-robin choice over the per-tenant heads:
        unit cost a request, quantum = weight, so under saturation admissions
        converge to the weight ratio. A tenant with no eligible work loses its
        deficit; the cursor keeps the rotation's place across rounds."""
        if not heads:
            return None
        for name in list(self._drr_deficit):
            if name not in heads:
                del self._drr_deficit[name]
        names = sorted(heads)
        idx = 0
        for i, n in enumerate(names):
            if n >= self._drr_cursor:
                idx = i
                break
        name = names[idx]
        deficit = self._drr_deficit.get(name, 0.0)
        if deficit < 1.0:
            deficit += self._tenants.spec(name).weight
        deficit -= 1.0
        self._drr_deficit[name] = deficit
        # stay on this tenant while it has credit, else advance the rotation
        self._drr_cursor = name if deficit >= 1.0 else names[(idx + 1) % len(names)]
        return heads[name]

    def _finish_queued(self, req: ServeRequest, reason: str, now: float) -> None:
        """Drop one queued request (deadline or shed): it holds no slot and no
        blocks, so this is a dequeue and a result."""
        result = self._new_result(req)
        result.first_token_s = now
        if reason == "deadline":
            with self._stats_lock:
                self.deadline_expired_requests += 1
            self._m_deadline_expired.inc()
        else:
            with self._stats_lock:
                self.shed_requests += 1
            self._m_shed.inc(reason="brownout")
            if req.tenant:
                self._m_tenant_shed.inc(tenant=req.tenant)
                self._tenant_stat(req.tenant, "shed")
        self._trace_event(req.rid, reason, now, queued=True)
        self._record_result(result, reason, now, req.tenant)

    def _sweep_queue(self, t0: float) -> None:
        """Seam 1 (queue admission): expire lapsed queued work, then let the
        brownout controller shed queued requests. Runs before every
        admission round; a queue with no deadlines and no controller passes
        through untouched."""
        now = self._now() - t0
        if any(req.deadline_ms is not None for req in self._queue):
            kept: deque[ServeRequest] = deque()
            for req in self._queue:
                if self._deadline_expired(req, now):
                    self._finish_queued(req, "deadline", now)
                else:
                    kept.append(req)
            self._queue = kept
        if self.brownout is None:
            return
        self.brownout.update(len(self._queue))
        for _ in range(self.brownout.shed_target(len(self._queue))):
            victim = None
            if self._tenants is None:
                # the youngest request of the lowest-priority class: older
                # work and higher classes keep their FIFO places
                for req in self._queue:
                    if victim is None or req.priority >= victim.priority:
                        victim = req
            else:
                # burn-aware: over-quota tenants first, bulk before
                # interactive, least-burned budget next; priority and the
                # youngest within a class break ties (`>=`)
                slot_counts = self._tenant_slot_counts()
                total_w = self._demand_weight(slot_counts)
                victim_key = None
                for req in self._queue:
                    key = self._victim_key(req.tenant, slot_counts, total_w) + (req.priority,)
                    if victim is None or key >= victim_key:
                        victim, victim_key = req, key
            if victim is None:
                break
            self._queue.remove(victim)
            self._finish_queued(victim, "shed", now)

    def _expire_active(self, t0: float) -> None:
        """Seams 2 and 3 (chunk and step boundaries): cancel lapsed slots
        between dispatches. `_finish` releases the block table, so the pool
        audit (free + unique owned == num_blocks) stays exact, and the
        cancelled request takes no further device step."""
        now = self._now() - t0
        for slot in range(self.slots):
            state = self._slot_states[slot]
            if state is None or state.request.deadline_ms is None:
                continue
            if self._deadline_expired(state.request, now):
                with self._stats_lock:
                    self.deadline_expired_requests += 1
                self._m_deadline_expired.inc()
                self._trace_event(state.request.rid, "deadline", now, phase=state.phase)
                if not state.result.tokens:
                    state.result.first_token_s = now  # never streamed: TTFT reads as time to cancellation
                self._finish(slot, "deadline", now)

    def _truncate_window(self, req: ServeRequest, result: ServeResult) -> list[int]:
        """Clip the prompt to max_len-1 tokens (the ring's capacity-1) so at
        least one can be generated; the clipping is recorded on the result and
        counted once per request."""
        window = req.prompt_tokens[-(self.max_len - 1) :]
        if len(window) < len(req.prompt_tokens):
            result.truncated = True
            if req.rid not in self._truncated_rids:  # once, even across preemption
                self._truncated_rids.add(req.rid)
                with self._stats_lock:
                    self.truncated_requests += 1
                self._m_trunc.inc()
                get_active_telemetry().emit_event(
                    "serve/prompt_truncated", {"rid": req.rid, "prompt_len": len(req.prompt_tokens),
                                               "window": len(window)})
        return window

    def _new_result(self, req: ServeRequest) -> ServeResult:
        return ServeResult(rid=req.rid, prompt_len=len(req.prompt_tokens), arrival_s=max(req.arrival_offset_s, 0.0),
                           trace_id=req.trace_id, trace_hop=req.trace_hop)

    def _admit(self, t0: float) -> None:
        """Fill idle slots from the queue (FIFO, arrival-gated; DRR with
        tenants) after the queue sweep (seam 1). Ring: chunked prefill into
        the freed slot right here, the first token taken from the last
        chunk's logits, the deadline checked between chunks (seam 2). Paged:
        `_admit_paged`. A draining engine (`stop_fn`) admits nothing."""
        if self._stopping():
            return
        self._sweep_queue(t0)
        if self.role == "decode":
            self._admit_imports(t0)
            return
        if self.kv_cache == "paged":
            self._admit_paged(t0)
            return
        for slot in range(self.slots):
            if not self._queue:
                break
            if self._slot_states[slot] is not None:
                continue
            now = self._now() - t0
            req = self._next_admittable(now)
            if req is None:
                break  # FIFO: later requests can't jump an unarrived head
            with span("serve/admission"):
                self._admit_ring(slot, req, now, t0)

    def _admit_ring(self, slot: int, req: ServeRequest, now: float, t0: float) -> None:
        """Ring admission of `req` into `slot`: its chunked prefill, the
        deadline checked between chunks (seam 2), the first token taken from
        the last chunk's logits."""
        temp = req.temperature if req.temperature is not None else 0.0
        result = self._new_result(req)
        self._trace_admit(req.rid, now)
        window = self._truncate_window(req, result)
        if req.max_new_tokens <= 0:
            result.first_token_s = self._now() - t0
            self._record_result(result, "budget", result.first_token_s, req.tenant)
            return
        self._temps[slot] = temp
        self._gens[slot] = torch.Generator(device=self.device).manual_seed(req.seed)
        pos = 0
        expired = False
        start = time.perf_counter()
        with span("serve/prefill"), torch.inference_mode():
            while pos < len(window):
                chunk = next(c for c in self.prefill_chunks if c <= len(window) - pos)
                toks = torch.tensor([window[pos : pos + chunk]], dtype=torch.long).to(self.device)
                logits = self.module.prefill_slot(self.cache, toks, slot, pos)
                self._prefill_shapes.add((1, chunk))
                with self._stats_lock:
                    self.prefill_chunk_count += 1
                    self.prefill_dispatches += 1
                self._m_prefill_chunks.inc()
                last_chunk = (pos, chunk)
                pos += chunk
                if pos < len(window):
                    # seam 2 (chunk boundary): a lapsed request stops taking
                    # prefill chunks; the ring slot holds nothing pooled. One
                    # clock read serves the chunk's trace event and the check
                    t_chunk = self._now() - t0
                    self._trace_event(req.rid, "prefill_chunk", t_chunk, start=last_chunk[0], ntok=chunk)
                    if self._deadline_expired(req, t_chunk):
                        expired = True
                        break
            if not expired:
                last = logits[:, -1, :]  # [1, V]
                first = self._sample(last, [slot])
                fetched = torch.stack([first[0], torch.isfinite(last).all().long()]).cpu()
        self.prefill_seconds += time.perf_counter() - start
        if expired:
            self._temps[slot] = 0.0
            self._gens[slot] = None
            now2 = self._now() - t0
            result.first_token_s = now2
            with self._stats_lock:
                self.deadline_expired_requests += 1
            self._m_deadline_expired.inc()
            self._trace_event(req.rid, "deadline", now2, phase="prefill")
            self._record_result(result, "deadline", now2, req.tenant)
            return
        first_tok, ok = int(fetched[0]), bool(fetched[1])  # device sync: the TTFT point
        now2 = self._now() - t0
        # the last chunk's event takes the TTFT clock read
        self._trace_event(req.rid, "prefill_chunk", now2, start=last_chunk[0], ntok=last_chunk[1])
        result.first_token_s = now2
        if not ok:  # non-finite logits: no token to trust
            self._temps[slot] = 0.0
            self._gens[slot] = None
            self._record_result(result, "error", now2, req.tenant)
            return
        self._record_first_token(result, now2)
        if first_tok == self.eod_token_id or req.max_new_tokens == 1:
            if first_tok != self.eod_token_id:
                self._emit_token(result, first_tok, now2)
            self._temps[slot] = 0.0
            self._gens[slot] = None
            self._record_result(result, "eod" if first_tok == self.eod_token_id else "budget", now2, req.tenant)
            return
        self._emit_token(result, first_tok, now2)
        # arm the slot: the admitted request joins the next decode step
        self._slot_states[slot] = _SlotState(request=req, result=result, remaining=req.max_new_tokens - 1,
                                             temp=temp, seq=self._admit_seq)
        self._admit_seq += 1
        self._tokens[slot] = first_tok
        self._positions[slot] = len(window)
        self._eods[slot] = self.eod_token_id
        self._remaining[slot] = req.max_new_tokens - 1

    def _paged_admission_need(self, req: ServeRequest) -> tuple:
        """(window, matched, full_match, need) for one admission candidate.
        A full-window match still re-forwards the LAST prompt token for the
        first-token logits; its K/V write lands in the final shared block, so
        admission copies that block first. `need` is the free-block demand:
        the unmatched tail's blocks plus that copy."""
        window = req.prompt_tokens[-(self.max_len - 1) :]
        ts = self._table_state
        matched = ts.match_prefix(window) if self.prefix_sharing else []
        full_match = bool(matched) and len(matched) * self.block_size >= len(window)
        need = blocks_for_tokens(len(window), self.block_size) - len(matched) + (1 if full_match else 0)
        return window, matched, full_match, need

    def _admit_paged(self, t0: float) -> None:
        """Admission onto the block pool: the head's free-block demand must fit
        BEFORE it leaves the queue (with tenants, a tenant whose head does not
        fit is passed over for this round only); matched prefix blocks are
        forked into its table, and the slot joins the packed prefill from the
        first unmatched position."""
        ts = self._table_state
        for slot in range(self.slots):
            if not self._queue:
                break
            if self._slot_states[slot] is not None:
                continue
            now = self._now() - t0
            if self._tenants is None:
                req = self._queue[0]
                if req.arrival_offset_s > now:
                    break  # FIFO: later requests can't jump an unarrived head
                window, matched, full_match, need = self._paged_admission_need(req)
                if ts.pool.free_count < need:
                    break  # the head stays queued; decoders will free blocks
                self._queue.popleft()
            else:
                # a tenant whose head does not fit the pool is blocked for
                # this round only: its big prompt never stalls the others
                blocked: set = set()
                while True:
                    heads = self._drr_candidates(now, blocked)
                    unfit = {name for name, cand in heads.items()
                             if ts.pool.free_count < self._paged_admission_need(cand)[3]}
                    if not unfit:
                        break
                    blocked |= unfit
                req = self._drr_pick(heads)
                if req is None:
                    break  # nothing arrived, under quota and admissible
                window, matched, full_match, need = self._paged_admission_need(req)
                self._queue.remove(req)
            with span("serve/admission"):
                self._admit_paged_one(slot, req, matched, full_match, now, t0)

    def _admit_paged_one(self, slot: int, req: ServeRequest, matched: list, full_match: bool, now: float,
                         t0: float) -> None:
        """Admit `req` into `slot` on the block pool: fork its matched prefix
        blocks, copy the last one on a full-window match, and hand the slot to
        the packed prefill from the first unmatched position."""
        ts = self._table_state
        temp = req.temperature if req.temperature is not None else 0.0
        result = self._new_result(req)
        self._trace_admit(req.rid, now)
        window = self._truncate_window(req, result)
        if req.max_new_tokens <= 0:
            result.first_token_s = self._now() - t0
            self._record_result(result, "budget", result.first_token_s, req.tenant)
            return
        if matched:
            ts.fork_prefix(req.rid, matched)
        if not ts.ensure(req.rid, len(window)):
            raise AssertionError("paged admission gate let a dry pool through")
        tail_start = len(matched) * self.block_size
        if full_match:
            tail_start = len(window) - 1
            cow = ts.ensure_writable(req.rid, tail_start)
            # the matched blocks were just forked, so the write target is
            # shared by construction and the copy always happens
            assert isinstance(cow, tuple), "full-match block unexpectedly private"
            self._cow_copy(*cow)
        if matched:
            result.prefix_hit_tokens = tail_start
            with self._stats_lock:
                self.prefix_hit_requests += 1
                self.prefix_hit_blocks += len(matched)
                self.prefix_hit_tokens += tail_start
            self._m_prefix_hit_requests.inc()
            self._m_prefix_hit_blocks.inc(len(matched))
            self._trace_event(req.rid, "prefix_hit", now, blocks=len(matched), tokens=tail_start)
        self._slot_states[slot] = _SlotState(request=req, result=result, remaining=0, phase="prefill",
                                             window=window, prefill_pos=tail_start, temp=temp,
                                             seq=self._admit_seq)
        self._admit_seq += 1
        self._temps[slot] = temp
        self._gens[slot] = torch.Generator(device=self.device).manual_seed(req.seed)

    def _cow_copy(self, src: int, dst: int) -> None:
        """Device row copy backing a copy-on-write: pool block `src` -> `dst`."""
        with span("serve/cow"), torch.inference_mode():
            self.cache.copy_block(src, dst)
        with self._stats_lock:
            self.cow_copies += 1
        self._m_cow.inc()

    def _active_count(self) -> int:
        return sum(s is not None for s in self._slot_states)

    def _decoding_count(self) -> int:
        return sum(s is not None and s.phase == "decode" for s in self._slot_states)

    def _prefilling_slots(self) -> list[int]:
        order = [(s.seq, i) for i, s in enumerate(self._slot_states) if s is not None and s.phase == "prefill"]
        return [i for _, i in sorted(order)]

    def _preempt(self, slot: int, t0: float) -> None:
        """Pool exhausted: push this slot's request back to the FRONT of the
        queue (it is older than everything queued) and release its blocks. It
        restarts from its prompt on re-admission, its sampler seeded anew;
        `_streamed` keeps `on_token` exactly once a token position."""
        state = self._slot_states[slot]
        req = state.request
        freed = self._table_state.release(req.rid)
        with self._stats_lock:
            self.preemptions += 1
        self._m_preempt.inc()
        if req.tenant:
            self._m_tenant_preempt.inc(tenant=req.tenant)
            self._tenant_stat(req.tenant, "preemptions")
        now = self._now() - t0
        discarded = len(state.result.tokens)
        self._trace_event(req.rid, "preempt", now, blocks_freed=freed, tokens_discarded=discarded)
        self._trace_event(req.rid, "requeue", now)
        trace = self._traces.get(req.rid)
        if trace is not None:
            trace["preemptions"] += 1
            trace["wait_from"] = now  # re-admission closes a NEW queue-wait interval
        get_active_telemetry().emit_event("serve/preempt", {"rid": req.rid, "blocks_freed": freed,
                                                            "tokens_discarded": discarded})
        self._queue.appendleft(req)
        self._clear_slot(slot)

    def _ensure_decode_blocks(self, t0: float, widths: Optional[dict] = None) -> None:
        """Before a paged decode or verify forward: every decoding slot needs
        the blocks covering its write range [p, p + w - 1] (`widths` maps slot
        -> w, default 1), each exclusively owned (a shared block is copied
        first). A dry pool preempts the YOUNGEST active slot, never an older
        one: the pool admits at least one max-length request by construction,
        so this cannot livelock. With tenants the burn-aware `_victim_key`
        orders the victims first, the youngest within a key."""
        ts = self._table_state
        for slot in range(self.slots):
            state = self._slot_states[slot]
            if state is None or state.phase != "decode":
                continue
            rid = state.request.rid
            p = int(self._positions[slot])
            w = int(widths.get(slot, 1)) if widths else 1
            while True:
                if ts.ensure(rid, p + w):
                    # the generated region's blocks stay private (prompt
                    # sharing copies at admission), but a shared write
                    # target here must still copy, never corrupt
                    dry = False
                    for bi in range(p // self.block_size, (p + w - 1) // self.block_size + 1):
                        res = ts.ensure_writable(rid, bi * self.block_size)
                        if res is False:
                            dry = True  # the pool ran dry mid-copy: preempt and retry
                            break
                        if isinstance(res, tuple):
                            self._cow_copy(*res)
                    if not dry:
                        break
                if self._tenants is None:
                    victims = [(s.seq, i) for i, s in enumerate(self._slot_states) if s is not None]
                else:
                    slot_counts = self._tenant_slot_counts()
                    total_w = self._demand_weight(slot_counts)
                    victims = [(self._victim_key(s.request.tenant, slot_counts, total_w) + (s.seq,), i)
                               for i, s in enumerate(self._slot_states) if s is not None]
                _, victim = max(victims)
                self._preempt(victim, t0)
                if victim == slot:
                    break
            if self._slot_states[slot] is None:
                continue  # preempted itself
            self._wblk[slot], self._woff[slot] = ts.write_coords(rid, p)
            self._tables[slot] = ts.table(rid)

    def _prefill_dispatch(self, t0: float) -> None:
        """Paged cross-request prefill: ONE [slots, block_size] forward packs
        up to `slots` block-aligned prompt chunks, taken FIFO across the
        prefilling slots (a long prompt takes several consecutive rows; every
        row's K/V is written before any row gathers, so this is exact). Rows
        whose chunk ends its prompt sample the request's first token."""
        self._expire_active(t0)  # seam 2: no chunk for a lapsed request
        R, C = self.slots, self.block_size
        rows: list[tuple[int, int, int, bool]] = []  # (slot, start, ntok, is_last)
        for slot in self._prefilling_slots():
            state = self._slot_states[slot]
            wl = len(state.window)
            pos = state.prefill_pos
            while pos < wl and len(rows) < R:
                ntok = min(C, wl - pos)
                rows.append((slot, pos, ntok, pos + ntok >= wl))
                pos += ntok
            if len(rows) >= R:
                break
        if not rows:
            return
        staged = self._prefill_in.np
        staged["tokens"][:] = 0
        staged["positions"][:] = 0
        staged["tables"][:] = 0
        staged["wblk"][:] = self.num_blocks  # default: the scratch block (write nowhere)
        staged["woff"][:] = 0
        staged["last_idx"][:] = 0
        for r, (slot, start, ntok, _) in enumerate(rows):
            state = self._slot_states[slot]
            table = self._table_state.table(state.request.rid)
            staged["tables"][r] = table
            staged["tokens"][r, :ntok] = state.window[start : start + ntok]
            cells = np.arange(start, start + ntok)
            staged["positions"][r, :ntok] = cells
            staged["wblk"][r, :ntok] = np.asarray(table)[cells // C]
            staged["woff"][r, :ntok] = cells % C
            staged["last_idx"][r] = ntok - 1
        samplers = [slot if is_last else None for slot, _, _, is_last in rows]
        start_t = time.perf_counter()
        with span("serve/prefill"), torch.inference_mode():
            dev = self._prefill_in.upload()
            logits = self.module.prefill_paged(self.cache, dev["tokens"], dev["positions"], dev["tables"],
                                               dev["wblk"], dev["woff"])
            last = logits[torch.arange(R, device=logits.device), dev["last_idx"]]  # [R, V]
            toks = self._sample(last, samplers)
            fetched = torch.stack([toks, torch.isfinite(last).all(dim=-1).long()]).cpu()
        out_toks, out_ok = fetched.numpy()
        self._prefill_shapes.add((R, C))
        with self._stats_lock:
            self.prefill_seconds += time.perf_counter() - start_t
            self.prefill_dispatches += 1
            self.prefill_chunk_count += len(rows)
        self._m_prefill_chunks.inc(len(rows))
        now = self._now() - t0
        for r, (slot, start, ntok, is_last) in enumerate(rows):
            state = self._slot_states[slot]
            state.prefill_pos = start + ntok
            self._trace_event(state.request.rid, "prefill_chunk", now, start=start, ntok=ntok)
            if not is_last:
                continue
            req, result = state.request, state.result
            wl = len(state.window)
            result.first_token_s = now
            if not out_ok[r]:
                # non-finite first-token row: finish "error" and NEVER publish
                # this request's blocks into the prefix index
                self._finish(slot, "error", now)
                continue
            if self.prefix_sharing:
                # the prompt is resident: publish its full PROMPT blocks (first
                # writer wins). Generated positions lie past `wl` and are
                # never registered, so indexed blocks are immutable for their
                # owner and copy-guarded for everyone else
                self._table_state.register_prefix(req.rid, state.window, upto=wl)
            first_tok = int(out_toks[r])
            self._record_first_token(result, now)
            if first_tok == self.eod_token_id:
                self._finish(slot, "eod", now)
                continue
            self._emit_token(result, first_tok, now)
            # budget clamped to the table ceiling: the last emitted token needs
            # no cache write, so max_len - wl + 1 tokens fit, and the stop is
            # always "budget" or "eod", never "capacity"
            allowed = min(req.max_new_tokens, self.max_len - wl + 1)
            if allowed <= 1:
                self._finish(slot, "budget", now)
                continue
            if self.role == "prefill":
                # the prefill tier stops at the first token: export the live
                # blocks and the sampler state (before _finish releases the
                # table) and finish "handoff"
                result.handoff = self._export_handoff(state, slot, first_tok, allowed - 1, now)
                self._finish(slot, "handoff", now)
                continue
            state.phase = "decode"
            state.remaining = allowed - 1
            self._tokens[slot] = first_tok
            self._positions[slot] = wl
            self._eods[slot] = self.eod_token_id
            self._remaining[slot] = allowed - 1

    def _decode_dispatch(self, t0: float) -> None:
        """ONE batched forward for every slot, then host bookkeeping on the
        single (tokens, finished, ok) fetch. Paged: blocks for the writes
        first (preempting on a dry pool), and a verify forward instead when
        any slot has drafts. Lapsed requests are cancelled first (seam 3)."""
        self._expire_active(t0)
        if self._decoding_count() == 0:
            return  # every decoder just expired
        if self.kv_cache == "paged":
            props = self._collect_proposals() if self.spec.enabled else {}
            widths = {slot: min(len(d) + 1, self._slot_states[slot].remaining) for slot, d in props.items()}
            self._ensure_decode_blocks(t0, widths or None)
            if self._decoding_count() == 0:
                return  # every decoder was preempted into the queue
            props = {slot: d for slot, d in props.items()
                     if self._slot_states[slot] is not None and self._slot_states[slot].phase == "decode"}
            if props:
                # drafts to score: the round goes through the verify forward
                # (slots without proposals ride along as 1-token columns)
                self._spec_verify_dispatch(t0, props)
                return
        start = time.perf_counter()
        with span("serve/decode"), torch.inference_mode():
            if self.kv_cache == "paged":
                staged = self._decode_in.np
                for name, value in (("tokens", self._tokens), ("positions", self._positions), ("eods", self._eods),
                                    ("remaining", self._remaining), ("wblk", self._wblk), ("woff", self._woff),
                                    ("tables", self._tables)):
                    staged[name][:] = value
                dev = self._decode_in.upload()
                tokens, positions, eods, remaining = dev["tokens"], dev["positions"], dev["eods"], dev["remaining"]
                logits = self.module.decode_paged(self.cache, tokens[:, None], positions, dev["tables"], dev["wblk"],
                                                  dev["woff"])
            else:
                host = torch.from_numpy(np.stack([self._tokens, self._positions, self._eods, self._remaining]))
                dev = host.to(self.device, non_blocking=True)
                tokens, positions, eods, remaining = dev[0], dev[1], dev[2], dev[3]
                logits = self.module.decode_slots(self.cache, tokens[:, None], positions)
            rows = logits[:, 0, :]  # [slots, V]
            toks = self._sample(rows, self._decoding_slots())
            # per-slot stopping folded into the step: eod never emits, budget
            # emits its last token then stops; the host only reads flags
            finished = (toks == eods) | (remaining <= 1)
            ok = torch.isfinite(rows).all(dim=-1)
            fetched = torch.stack([toks, finished.long(), ok.long()]).cpu()
        toks_h, finished_h, ok_h = fetched.numpy()
        seconds = time.perf_counter() - start
        self._decode_shapes.add((self.slots, 1))
        now = self._now() - t0
        active = self._decoding_count()
        emitted = 0
        for slot in range(self.slots):
            state = self._slot_states[slot]
            if state is None or state.phase != "decode":
                continue
            self._positions[slot] += 1  # the fed token landed in the cache
            tok = int(toks_h[slot])
            self._first_local_token(state, now)
            if not ok_h[slot]:  # non-finite logits: the token is garbage
                self._finish(slot, "error", now)
                continue
            if tok == self.eod_token_id:
                self._finish(slot, "eod", now)
                continue
            self._emit_token(state.result, tok, now)
            emitted += 1
            if finished_h[slot]:  # budget exhausted (eod handled above)
                self._finish(slot, "budget", now)
                continue
            state.remaining -= 1
            self._remaining[slot] = state.remaining
            self._tokens[slot] = tok
            if self.kv_cache == "ring" and self._positions[slot] >= self.capacity:
                # ring full: the request finishes (the paged cache never takes
                # this exit: the admission clamp keeps positions below max_len)
                self._finish(slot, "capacity", now)
        with self._stats_lock:
            self.decode_seconds += seconds
            self.decode_steps += 1
            self._occupancy_sum += active
            self.max_concurrent = max(self.max_concurrent, active)
            self.decode_token_count += emitted
        self._m_decode_steps.inc()

    def _collect_proposals(self) -> dict:
        """Prompt-lookup drafts per decoding slot: greedy slots only (a sampled
        token is a draw, with no argmax to verify against), and only while
        more than one token of budget remains. A pure function of the
        request's own context, so a preempted request re-proposes the same."""
        props: dict[int, list[int]] = {}
        for slot in range(self.slots):
            state = self._slot_states[slot]
            if state is None or state.phase != "decode":
                continue
            if state.temp > 0.0 or state.remaining <= 1:
                continue
            drafts = propose_ngram(state.window + state.result.tokens, self.spec.k, self.spec.ngram_max,
                                   self.spec.ngram_min)
            if drafts:
                props[slot] = drafts
        return props

    def _spec_verify_dispatch(self, t0: float, props: dict) -> None:
        """ONE [slots, k+1] verify forward: column 0 feeds each slot's pending
        token (a slot without drafts is a plain decode column, and a sampled
        slot draws its token from column 0 as a decode step would), columns
        1..n the drafts. The device returns each column's greedy continuation
        and the accept length (the cumprod of draft matches); the host replays
        the sequential stopping rule over the accepted run. Writes past the
        slot's budget go to the scratch block."""
        S, K1 = self.slots, self.spec.k + 1
        ts = self._table_state
        staged = self._verify_in.np
        staged["tokens"][:] = 0
        staged["positions"][:] = 0
        staged["wblk"][:] = self.num_blocks
        staged["woff"][:] = 0
        staged["prop_len"][:] = 0
        staged["tables"][:] = self._tables
        for slot in range(S):
            state = self._slot_states[slot]
            if state is None or state.phase != "decode":
                continue
            p = int(self._positions[slot])
            drafts = props.get(slot, [])
            n = len(drafts)
            staged["tokens"][slot, 0] = self._tokens[slot]
            staged["tokens"][slot, 1 : 1 + n] = drafts
            staged["positions"][slot] = p + np.arange(K1)
            staged["prop_len"][slot] = n
            # rejected drafts leave garbage K/V behind, which the next
            # dispatch's contiguous writes overwrite before any query can
            # attend it (key_pos <= pos masks the rest)
            for j in range(min(n + 1, state.remaining)):
                staged["wblk"][slot, j], staged["woff"][slot, j] = ts.write_coords(state.request.rid, p + j)
        start = time.perf_counter()
        with span("serve/decode"), torch.inference_mode():
            dev = self._verify_in.upload()
            tokens = dev["tokens"]
            logits = self.module.verify_paged(self.cache, tokens, dev["positions"], dev["tables"], dev["wblk"],
                                              dev["woff"])
            g = logits.argmax(dim=-1)  # [S, k+1] greedy continuation of each column
            toks0 = self._sample(logits[:, 0, :], self._decoding_slots())
            # draft j (fed at column j) is accepted iff it equals column j-1's
            # greedy continuation and every earlier draft was accepted
            match = (tokens[:, 1:] == g[:, :-1]) & (
                torch.arange(K1 - 1, device=tokens.device)[None, :] < dev["prop_len"][:, None])
            acc = torch.cumprod(match.long(), dim=1).sum(dim=1)
            # column 0 only: columns past a slot's window are fully masked
            # and may legitimately be non-finite
            ok = torch.isfinite(logits[:, 0, :]).all(dim=-1)
            fetched = torch.cat([g, toks0[:, None], acc[:, None], ok[:, None].long()], dim=1).cpu().numpy()
        seconds = time.perf_counter() - start
        self._verify_shapes.add((S, K1))
        g, toks0, acc, ok = fetched[:, :K1], fetched[:, K1], fetched[:, K1 + 1], fetched[:, K1 + 2]
        now = self._now() - t0
        active = self._decoding_count()
        emitted_total = proposed_total = accepted_total = 0
        for slot in range(S):
            state = self._slot_states[slot]
            if state is None or state.phase != "decode":
                continue
            self._first_local_token(state, now)
            if not ok[slot]:  # non-finite logits: nothing here is a token
                self._finish(slot, "error", now)
                continue
            p = int(self._positions[slot])
            drafts = props.get(slot, [])
            if drafts:
                e = min(int(acc[slot]) + 1, state.remaining)  # the emitted run, all valid columns
                emitted_seq = [int(g[slot, j]) for j in range(e)]
                used = min(int(acc[slot]), e - 1)  # drafts that advanced the slot
                proposed_total += len(drafts)
                accepted_total += used
                trace = self._traces.get(state.request.rid)
                if trace is not None:
                    trace["spec_proposed"] = trace.get("spec_proposed", 0) + len(drafts)
                    trace["spec_accepted"] = trace.get("spec_accepted", 0) + used
            else:
                emitted_seq = [int(toks0[slot])]
            # replay the sequential stopping rule over the accepted run
            n_emit, fin, rem = 0, None, state.remaining
            for tok in emitted_seq:
                if tok == self.eod_token_id:
                    fin = "eod"
                    break
                self._emit_token(state.result, tok, now)
                n_emit += 1
                if rem <= 1:
                    fin = "budget"
                    break
                rem -= 1
            emitted_total += n_emit
            if fin is not None:
                self._finish(slot, fin, now)
                continue
            state.remaining = rem
            self._remaining[slot] = rem
            self._positions[slot] = p + n_emit
            self._tokens[slot] = emitted_seq[-1]
        with self._stats_lock:
            self.decode_seconds += seconds
            self.decode_steps += 1
            self.verify_steps += 1
            self._occupancy_sum += active
            self.max_concurrent = max(self.max_concurrent, active)
            self.decode_token_count += emitted_total
            self.spec_proposed += proposed_total
            self.spec_accepted += accepted_total
            self.spec_emitted += emitted_total
        self._m_decode_steps.inc()
        if proposed_total:
            self._m_spec_proposed.inc(proposed_total)
        if accepted_total:
            self._m_spec_accepted.inc(accepted_total)

    def step(self, t0: float) -> bool:
        """One scheduler round: admit, (paged) one packed prefill, then one
        decode-side forward. A weight swap queued by request_swap() is
        installed first. Returns True if any device work was dispatched.

        Watchdog: a round with pending work arms the active telemetry's hang
        watchdog, beats it when the round dispatched and disarms it when idle
        (waiting is not a hang); a wedged dispatch dumps an artifact.

        OOM forensics (JAX engine.py:2553-2566): an allocation failure in the
        (paged) prefill or the decode dispatch (or the `oom@N` fault point,
        N the dispatch round) writes `oom_dump_rank_<r>_step_<N>.json` under
        the telemetry sink's folder (else the working directory) with the
        engine's metrics and the levers, and raises the resumable
        `OutOfMemory` in its place."""
        telemetry = get_active_telemetry()
        self._maybe_apply_swap()
        armed = bool(self._queue) or self._active_count() > 0
        if armed:
            self._dispatch_seq += 1
            telemetry.arm_watchdog(self._dispatch_seq, first_step=self._dispatch_seq == 1)
        dispatches_before = self.prefill_dispatches
        self._admit(t0)
        did = self.prefill_dispatches != dispatches_before
        try:
            fire_oom_if_armed(self._dispatch_seq)
            if self.kv_cache == "paged" and self._prefilling_slots():
                self._prefill_dispatch(t0)
                did = True
            if self._decoding_count():
                self._decode_dispatch(t0)
                did = True
        except Exception as e:
            if is_oom_error(e):  # the dump (the stats, the levers) first, then the resumable OutOfMemory
                raise oom_forensics(
                    telemetry.sink_path.parent if telemetry.sink_path is not None else Path("."),
                    rank=telemetry.global_rank, step=self._dispatch_seq, exc=e, static_report=None,
                    metrics_snapshot=self.metrics.snapshot()) from e
            raise
        self._publish_live()
        if armed:
            if did:
                telemetry.beat_watchdog(self._dispatch_seq)
            else:
                telemetry.disarm_watchdog()
        return did

    def run(self) -> dict[int, ServeResult]:
        """Serve until queue and slots drain, or, once `stop_fn` trips, until
        the in-flight slots finish (a drain: no new admissions, queued
        requests are left unserved). Returns rid -> ServeResult, every result
        since the engine was built (none where `on_finish` takes them)."""
        t0 = self._now()
        try:
            while True:
                stopping = self._stopping()
                if stopping:
                    if self._active_count() == 0:
                        break
                elif not self._queue and self._active_count() == 0:
                    break
                if not self.step(t0):
                    if stopping or not self._queue:
                        break
                    # nothing running and the head hasn't arrived: wait for it
                    wait = self._queue[0].arrival_offset_s - (self._now() - t0)
                    if wait > 0:
                        time.sleep(min(wait, 0.05))
        finally:
            get_active_telemetry().disarm_watchdog()
        return self._results

    # ------------------------------------------------------------------- stats
    def _publish_live(self) -> None:
        """Snapshot the scheduler state that /stats and the gauges read from
        other threads. Engine thread only: it walks the queue, the slots and
        the pool's refcounts, which only this thread changes."""
        slot_counts = self._tenant_slot_counts()
        live = {"queue_depth": len(self._queue), "active_slots": sum(slot_counts.values()),
                "tenant_slots": slot_counts, "tenant_queued": {}}
        if self._tenants is not None:
            for r in self._queue:
                live["tenant_queued"][r.tenant] = live["tenant_queued"].get(r.tenant, 0) + 1
        if self._table_state is not None:
            live.update(free_blocks=self._table_state.pool.free_count,
                        shared_blocks=self._table_state.pool.shared_count,
                        prefix_index_size=self._table_state.prefix_index_size)
        with self._stats_lock:
            self._live = live

    def _live_value(self, key: str):
        with self._stats_lock:
            return self._live[key]

    def _occupancy_ratio(self) -> float:
        with self._stats_lock:
            if not self.decode_steps:
                return 0.0
            return self._occupancy_sum / (self.decode_steps * self.slots)

    def stats(self) -> dict:
        """One consistent snapshot: the counters are read under the lock their
        dispatch-end updates hold, so a concurrent /stats never sees half a
        dispatch (decode_tokens without its decode_steps), and the queue,
        slot and pool figures are the engine thread's latest published ones,
        so no other thread walks state the engine thread is changing."""
        with self._stats_lock:
            occupancy = self._occupancy_sum / (self.decode_steps * self.slots) if self.decode_steps else 0.0
            out = {
                "role": self.role,
                "kv_cache": self.kv_cache,
                "device": str(self.device),
                "decode_steps": self.decode_steps,
                "decode_tokens": self.decode_token_count,
                "prefill_chunks": self.prefill_chunk_count,
                "forward_calls": self.decode_steps + self.prefill_dispatches,
                "decode_executables": len(self._decode_shapes),
                "prefill_executables": len(self._prefill_shapes),
                "slot_occupancy": occupancy,
                "max_concurrent": self.max_concurrent,
                "slots": self.slots,
                "capacity": self.capacity,
                "preemptions": self.preemptions,
                "truncated_requests": self.truncated_requests,
                "queue_depth": self._live["queue_depth"],
                "active_slots": self._live["active_slots"],
                "weights_generation": self.weights_generation,
                "weight_swaps": self.weight_swaps,
                "request_errors": self.request_errors,
                "deadline_expired_requests": self.deadline_expired_requests,
                "shed_requests": self.shed_requests,
                "prefill_seconds": self.prefill_seconds,
                "decode_seconds": self.decode_seconds,
                "quant_weights": self.quant_weights,
                "quant_kv": self.quant_kv,
                "kv_pool_bytes": self.kv_pool_bytes,
                "weights_bytes": self.weights_bytes,
                "quant_bytes_saved": self.quant_bytes_saved,
            }
            if self.kv_cache == "paged":
                out.update(
                    max_len=self.max_len,
                    block_size=self.block_size,
                    num_blocks=self.num_blocks,
                    free_blocks=self._live["free_blocks"],
                    kv_scale_bytes=self.kv_scale_bytes,
                    prefix_sharing=self.prefix_sharing,
                    prefix_hit_requests=self.prefix_hit_requests,
                    prefix_hit_blocks=self.prefix_hit_blocks,
                    prefix_hit_tokens=self.prefix_hit_tokens,
                    cow_copies=self.cow_copies,
                    cow_executables=int(self.cow_copies > 0),
                    shared_blocks=self._live["shared_blocks"],
                    prefix_index_size=self._live["prefix_index_size"],
                    spec_k=self.spec.k,
                    verify_steps=self.verify_steps,
                    verify_executables=len(self._verify_shapes),
                    spec_proposed=self.spec_proposed,
                    spec_accepted=self.spec_accepted,
                    spec_emitted=self.spec_emitted,
                    prefill_chunk_count=self.prefill_chunk_count,
                )
            if self.role != "combined":
                out.update(
                    handoffs_exported=self.handoffs_exported,
                    handoffs_imported=self.handoffs_imported,
                    import_requeues=self.import_requeues,
                    imported_blocks=self.imported_blocks,
                    handoff_bytes_shipped=self.handoff_bytes_shipped,
                    handoff_executables=int(self.handoffs_exported > 0),
                    import_executables=int(self.imported_blocks > 0),
                )
            tenant_stats = {t: dict(b) for t, b in self._tenant_stats.items()}
            slot_counts, queued = self._live["tenant_slots"], self._live["tenant_queued"]
        if self._tenants is not None:
            tenants_out = {}
            for name in sorted(set(self._tenants.names()) | set(tenant_stats) | set(queued)):
                spec = self._tenants.spec(name)
                row = dict(tenant_stats.get(name, {"submitted": 0, "finished": 0, "tokens": 0, "shed": 0,
                                                   "preemptions": 0, "rate_limited": 0}))
                row.update(tenant_class=spec.tenant_class, weight=spec.weight, max_slots=spec.max_slots,
                           active_slots=slot_counts.get(name, 0), queued=queued.get(name, 0))
                tenants_out[name] = row
            out["tenants"] = tenants_out
        return out

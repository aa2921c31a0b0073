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

Not here (ROADMAP.md Queue 1 item 3, later parts): tenants, deadlines,
brownout, the HTTP front end, telemetry, hot swap, fleet and disaggregation.
"""

from __future__ import annotations

import math
import os
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Optional

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
from modalities_tpu_torch.serving.spec_decode import propose_ngram, resolve_spec_config

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


@dataclass
class ServeResult:
    rid: int
    tokens: list[int] = field(default_factory=list)
    finish_reason: str = ""  # "eod" | "budget" | "capacity" | "error"
    prompt_len: int = 0
    truncated: bool = False  # prompt window-clipped at admission
    prefix_hit_tokens: int = 0  # prompt tokens served from shared blocks (paged)
    arrival_s: float = 0.0  # engine-clock arrival
    first_token_s: float = 0.0  # engine-clock time the first token was available
    finish_s: float = 0.0

    @property
    def ttft_s(self) -> float:
        return self.first_token_s - self.arrival_s


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
    engine's does: a fake clock makes arrival-gated runs deterministic."""

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
        time_fn=None,
    ):
        self.device = resolve_device(device)
        self._now = time_fn if time_fn is not None else time.monotonic
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
        params = {k: v.to(self.device) for k, v in params.items()}
        self.quant_bytes_saved = 0
        if self.quant_weights != "none":
            model = quantized_model(model, self.quant_weights)
            params = quantize_params(params, self.quant_weights)
            self.quant_bytes_saved = weights_bytes_saved(params)
        self.model = model
        self.module = model.build_module(params)

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
    ) -> int:
        if not prompt_tokens:
            raise ValueError("empty prompt: the engine needs at least one prompt token")
        rid = self._next_rid
        self._next_rid += 1
        temp = self.default_temperature if temperature is ... else temperature
        self._queue.append(
            ServeRequest(
                rid=rid,
                prompt_tokens=[int(t) for t in prompt_tokens],
                max_new_tokens=int(max_new_tokens),
                temperature=temp,
                seed=int(seed),
                arrival_offset_s=float(arrival_offset_s),
            )
        )
        return rid

    # -------------------------------------------------------------- scheduling
    def _record_result(self, result: ServeResult, reason: str, now: float) -> None:
        result.finish_reason = reason
        result.finish_s = now
        if reason == "error":
            self.request_errors += 1
        self._results[result.rid] = result

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
        self._record_result(state.result, reason, now)
        self._clear_slot(slot)

    def _truncate_window(self, req: ServeRequest, result: ServeResult) -> list[int]:
        """Clip the prompt to max_len-1 tokens (the ring's capacity-1) so at
        least one can be generated; the clipping is recorded on the result and
        counted once per request."""
        window = req.prompt_tokens[-(self.max_len - 1) :]
        if len(window) < len(req.prompt_tokens):
            result.truncated = True
            if req.rid not in self._truncated_rids:
                self._truncated_rids.add(req.rid)
                self.truncated_requests += 1
        return window

    def _new_result(self, req: ServeRequest) -> ServeResult:
        return ServeResult(rid=req.rid, prompt_len=len(req.prompt_tokens), arrival_s=max(req.arrival_offset_s, 0.0))

    def _admit(self, t0: float) -> None:
        """Fill idle slots from the queue (FIFO, arrival-gated). Ring: chunked
        prefill into the freed slot right here, the first token taken from the
        last chunk's logits. Paged: `_admit_paged`."""
        if self.kv_cache == "paged":
            self._admit_paged(t0)
            return
        for slot in range(self.slots):
            if not self._queue:
                break
            if self._slot_states[slot] is not None:
                continue
            now = self._now() - t0
            req = self._queue[0]
            if req.arrival_offset_s > now:
                break  # FIFO: later requests can't jump an unarrived head
            self._queue.popleft()
            temp = req.temperature if req.temperature is not None else 0.0
            result = self._new_result(req)
            window = self._truncate_window(req, result)
            if req.max_new_tokens <= 0:
                result.first_token_s = self._now() - t0
                self._record_result(result, "budget", result.first_token_s)
                continue
            self._temps[slot] = temp
            self._gens[slot] = torch.Generator(device=self.device).manual_seed(req.seed)
            pos = 0
            start = time.perf_counter()
            with torch.inference_mode():
                while pos < len(window):
                    chunk = next(c for c in self.prefill_chunks if c <= len(window) - pos)
                    toks = torch.tensor([window[pos : pos + chunk]], dtype=torch.long).to(self.device)
                    logits = self.module.prefill_slot(self.cache, toks, slot, pos)
                    self._prefill_shapes.add((1, chunk))
                    self.prefill_chunk_count += 1
                    self.prefill_dispatches += 1
                    pos += chunk
                last = logits[:, -1, :]  # [1, V]
                first = self._sample(last, [slot])
                fetched = torch.stack([first[0], torch.isfinite(last).all().long()]).cpu()
            first_tok, ok = int(fetched[0]), bool(fetched[1])  # device sync: the TTFT point
            self.prefill_seconds += time.perf_counter() - start
            now2 = self._now() - t0
            result.first_token_s = now2
            if not ok:  # non-finite logits: no token to trust
                self._temps[slot] = 0.0
                self._gens[slot] = None
                self._record_result(result, "error", now2)
                continue
            if first_tok == self.eod_token_id or req.max_new_tokens == 1:
                if first_tok != self.eod_token_id:
                    result.tokens.append(first_tok)
                self._temps[slot] = 0.0
                self._gens[slot] = None
                self._record_result(result, "eod" if first_tok == self.eod_token_id else "budget", now2)
                continue
            result.tokens.append(first_tok)
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
        BEFORE it leaves the queue; matched prefix blocks are forked into its
        table, and the slot joins the packed prefill from the first unmatched
        position."""
        ts = self._table_state
        for slot in range(self.slots):
            if not self._queue:
                break
            if self._slot_states[slot] is not None:
                continue
            now = self._now() - t0
            req = self._queue[0]
            if req.arrival_offset_s > now:
                break  # FIFO: later requests can't jump an unarrived head
            window, matched, full_match, need = self._paged_admission_need(req)
            if ts.pool.free_count < need:
                break  # the head stays queued; decoders will free blocks
            self._queue.popleft()
            temp = req.temperature if req.temperature is not None else 0.0
            result = self._new_result(req)
            window = self._truncate_window(req, result)
            if req.max_new_tokens <= 0:
                result.first_token_s = self._now() - t0
                self._record_result(result, "budget", result.first_token_s)
                continue
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
                self.prefix_hit_requests += 1
                self.prefix_hit_blocks += len(matched)
                self.prefix_hit_tokens += tail_start
            self._slot_states[slot] = _SlotState(request=req, result=result, remaining=0, phase="prefill",
                                                 window=window, prefill_pos=tail_start, temp=temp,
                                                 seq=self._admit_seq)
            self._admit_seq += 1
            self._temps[slot] = temp
            self._gens[slot] = torch.Generator(device=self.device).manual_seed(req.seed)

    def _cow_copy(self, src: int, dst: int) -> None:
        """Device row copy backing a copy-on-write: pool block `src` -> `dst`."""
        with torch.inference_mode():
            self.cache.copy_block(src, dst)
        self.cow_copies += 1

    def _active_count(self) -> int:
        return sum(s is not None for s in self._slot_states)

    def _decoding_count(self) -> int:
        return sum(s is not None and s.phase == "decode" for s in self._slot_states)

    def _prefilling_slots(self) -> list[int]:
        order = [(s.seq, i) for i, s in enumerate(self._slot_states) if s is not None and s.phase == "prefill"]
        return [i for _, i in sorted(order)]

    def _preempt(self, slot: int) -> None:
        """Pool exhausted: push this slot's request back to the FRONT of the
        queue (it is older than everything queued) and release its blocks. It
        restarts from its prompt on re-admission, its sampler seeded anew."""
        state = self._slot_states[slot]
        self._table_state.release(state.request.rid)
        self.preemptions += 1
        self._queue.appendleft(state.request)
        self._clear_slot(slot)

    def _ensure_decode_blocks(self, widths: Optional[dict] = None) -> None:
        """Before a paged decode or verify forward: every decoding slot needs
        the blocks covering its write range [p, p + w - 1] (`widths` maps slot
        -> w, default 1), each exclusively owned (a shared block is copied
        first). A dry pool preempts the YOUNGEST active slot, never an older
        one: the pool admits at least one max-length request by construction,
        so this cannot livelock."""
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
                _, victim = max((s.seq, i) for i, s in enumerate(self._slot_states) if s is not None)
                self._preempt(victim)
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
        with torch.inference_mode():
            dev = self._prefill_in.upload()
            logits = self.module.prefill_paged(self.cache, dev["tokens"], dev["positions"], dev["tables"],
                                               dev["wblk"], dev["woff"])
            last = logits[torch.arange(R, device=logits.device), dev["last_idx"]]  # [R, V]
            toks = self._sample(last, samplers)
            fetched = torch.stack([toks, torch.isfinite(last).all(dim=-1).long()]).cpu()
        out_toks, out_ok = fetched.numpy()
        self.prefill_seconds += time.perf_counter() - start_t
        self._prefill_shapes.add((R, C))
        self.prefill_dispatches += 1
        self.prefill_chunk_count += len(rows)
        now = self._now() - t0
        for r, (slot, start, ntok, is_last) in enumerate(rows):
            state = self._slot_states[slot]
            state.prefill_pos = start + ntok
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
            if first_tok == self.eod_token_id:
                self._finish(slot, "eod", now)
                continue
            result.tokens.append(first_tok)
            # budget clamped to the table ceiling: the last emitted token needs
            # no cache write, so max_len - wl + 1 tokens fit, and the stop is
            # always "budget" or "eod", never "capacity"
            allowed = min(req.max_new_tokens, self.max_len - wl + 1)
            if allowed <= 1:
                self._finish(slot, "budget", now)
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
        any slot has drafts."""
        if self.kv_cache == "paged":
            props = self._collect_proposals() if self.spec.enabled else {}
            widths = {slot: min(len(d) + 1, self._slot_states[slot].remaining) for slot, d in props.items()}
            self._ensure_decode_blocks(widths or None)
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
        with torch.inference_mode():
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
        self.decode_seconds += time.perf_counter() - start
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
            if not ok_h[slot]:  # non-finite logits: the token is garbage
                self._finish(slot, "error", now)
                continue
            if tok == self.eod_token_id:
                self._finish(slot, "eod", now)
                continue
            state.result.tokens.append(tok)
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
        self.decode_steps += 1
        self._occupancy_sum += active
        self.max_concurrent = max(self.max_concurrent, active)
        self.decode_token_count += emitted

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
        with torch.inference_mode():
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
        self.decode_seconds += time.perf_counter() - start
        self._verify_shapes.add((S, K1))
        g, toks0, acc, ok = fetched[:, :K1], fetched[:, K1], fetched[:, K1 + 1], fetched[:, K1 + 2]
        now = self._now() - t0
        active = self._decoding_count()
        emitted_total = proposed_total = accepted_total = 0
        for slot in range(S):
            state = self._slot_states[slot]
            if state is None or state.phase != "decode":
                continue
            if not ok[slot]:  # non-finite logits: nothing here is a token
                self._finish(slot, "error", now)
                continue
            p = int(self._positions[slot])
            drafts = props.get(slot, [])
            if drafts:
                e = min(int(acc[slot]) + 1, state.remaining)  # the emitted run, all valid columns
                emitted_seq = [int(g[slot, j]) for j in range(e)]
                proposed_total += len(drafts)
                accepted_total += min(int(acc[slot]), e - 1)  # drafts that advanced the slot
            else:
                emitted_seq = [int(toks0[slot])]
            # replay the sequential stopping rule over the accepted run
            n_emit, fin, rem = 0, None, state.remaining
            for tok in emitted_seq:
                if tok == self.eod_token_id:
                    fin = "eod"
                    break
                state.result.tokens.append(tok)
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
        self.decode_steps += 1
        self.verify_steps += 1
        self._occupancy_sum += active
        self.max_concurrent = max(self.max_concurrent, active)
        self.decode_token_count += emitted_total
        self.spec_proposed += proposed_total
        self.spec_accepted += accepted_total
        self.spec_emitted += emitted_total

    def step(self, t0: float) -> bool:
        """One scheduler round: admit, (paged) one packed prefill, then one
        decode-side forward. Returns True if any device work was dispatched."""
        dispatches_before = self.prefill_dispatches
        self._admit(t0)
        did = self.prefill_dispatches != dispatches_before
        if self.kv_cache == "paged" and self._prefilling_slots():
            self._prefill_dispatch(t0)
            did = True
        if self._decoding_count():
            self._decode_dispatch(t0)
            did = True
        return did

    def run(self) -> dict[int, ServeResult]:
        """Serve until queue and slots drain. Returns rid -> ServeResult."""
        t0 = self._now()
        while self._queue or self._active_count():
            if not self.step(t0) and self._queue:
                # nothing running and the head hasn't arrived: wait for it
                wait = self._queue[0].arrival_offset_s - (self._now() - t0)
                if wait > 0:
                    time.sleep(min(wait, 0.05))
        return self._results

    # ------------------------------------------------------------------- stats
    def stats(self) -> dict:
        occupancy = self._occupancy_sum / (self.decode_steps * self.slots) if self.decode_steps else 0.0
        out = {
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
            "queue_depth": len(self._queue),
            "active_slots": self._active_count(),
            "request_errors": self.request_errors,
            "prefill_seconds": self.prefill_seconds,
            "decode_seconds": self.decode_seconds,
            "quant_weights": self.quant_weights,
            "quant_kv": self.quant_kv,
            "kv_pool_bytes": self.kv_pool_bytes,
            "weights_bytes": self.weights_bytes,
            "quant_bytes_saved": self.quant_bytes_saved,
        }
        if self.kv_cache == "paged":
            pool = self._table_state.pool
            out.update(
                max_len=self.max_len,
                block_size=self.block_size,
                num_blocks=self.num_blocks,
                free_blocks=pool.free_count,
                kv_scale_bytes=self.kv_scale_bytes,
                prefix_sharing=self.prefix_sharing,
                prefix_hit_requests=self.prefix_hit_requests,
                prefix_hit_blocks=self.prefix_hit_blocks,
                prefix_hit_tokens=self.prefix_hit_tokens,
                cow_copies=self.cow_copies,
                cow_executables=int(self.cow_copies > 0),
                shared_blocks=pool.shared_count,
                prefix_index_size=self._table_state.prefix_index_size,
                spec_k=self.spec.k,
                verify_steps=self.verify_steps,
                verify_executables=len(self._verify_shapes),
                spec_proposed=self.spec_proposed,
                spec_accepted=self.spec_accepted,
                spec_emitted=self.spec_emitted,
                prefill_chunk_count=self.prefill_chunk_count,
            )
        return out

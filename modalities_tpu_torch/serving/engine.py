"""Continuous-batching decode engine over the GPT2 ring KV cache: the port of
modalities_tpu/serving/engine.py, ring cache only.

- The cache is two preallocated tensors [layers, slots, capacity, kv_heads,
  head_dim] (GPT2Module.init_slot_cache), updated in place by every prefill
  chunk and decode step.
- decode: ONE batched forward advances every slot by one token. Idle slots
  compute garbage harmlessly (their rows are overwritten by the next
  admission's prefill). Per-slot stopping is folded into the step on the
  device, and the host makes one small fetch of (tokens, finished, ok) per
  step.
- scheduling (plain Python): a FIFO queue, arrival-gated, admits requests into
  idle slots at token boundaries; a prompt is prefilled in chunks from the
  (64, 16, 4, 1) ladder, and its last chunk yields the first token.
- sampling: greedy is `argmax` of the fp32 logits row. A sampled slot draws
  Gumbel noise from its own `torch.Generator`, seeded with the request's seed
  and advanced only when that slot samples, so a request's tokens depend on
  its seed alone, never on what else is in the batch. (JAX's Threefry draws
  cannot be reproduced in torch; greedy tokens are what matches the JAX
  engine exactly.)

Batch invariance: every shape a request meets — the decode batch of `slots`
rows, its prefill chunks — is the same whether it runs alone or beside others,
and no op mixes rows, so a request's tokens are bitwise the same either way.

Not here yet (later slices): the paged cache, prefix sharing, speculative
decoding, tenants, deadlines, brownout, telemetry, hot swap, disaggregation.
"""

from __future__ import annotations

import time
from collections import deque
from dataclasses import dataclass, field
from typing import Optional

import numpy as np
import torch

from modalities_tpu_torch.device import resolve_device
from modalities_tpu_torch.quant.core import tree_bytes
from modalities_tpu_torch.quant.weights import (
    infer_quant_mode,
    quantize_params,
    quantized_model,
    resolve_quant_weights_mode,
    weights_bytes_saved,
)

PREFILL_CHUNKS = (64, 16, 4, 1)  # descending, ending in 1: every prompt length fits

_IDLE_REMAINING = 2**30  # idle slots never trip the budget stop


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


class ServingEngine:
    """See module docstring. `model` is a GPT2LLM, `params` its state dict
    (fp32 from `init_params` or `params_from_jax`, or already quantized).
    Everything runs on `device` (default: the CUDA card; raises without one)."""

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
        quant_weights: Optional[str] = None,
    ):
        self.device = resolve_device(device)
        self.quant_weights = resolve_quant_weights_mode(quant_weights)
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

        spec_len = int(model.config_spec.sequence_length)
        self.slots = int(max_batch_slots)
        self.capacity = min(int(cache_capacity), spec_len) if cache_capacity else spec_len
        self.eod_token_id = int(eod_token_id)
        self.default_temperature = default_temperature
        if self.slots < 1:
            raise ValueError("max_batch_slots must be >= 1")
        if self.capacity < 2:
            raise ValueError("cache_capacity must be >= 2 (1 prompt token + 1 generated)")
        self.cache = self.module.init_slot_cache(self.slots, self.capacity)
        self.kv_pool_bytes = self.cache.nbytes
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

        self._queue: deque[ServeRequest] = deque()
        self._results: dict[int, ServeResult] = {}
        self._next_rid = 0
        self.decode_steps = 0
        self.decode_token_count = 0
        self.prefill_chunk_count = 0
        self._occupancy_sum = 0
        self.max_concurrent = 0
        self.truncated_requests = 0
        self.request_errors = 0
        # host wall time of the dispatches, each ending in its device fetch
        self.prefill_seconds = 0.0
        self.decode_seconds = 0.0

    # ---------------------------------------------------------------- sampling
    def _sample(self, rows, slots: list[int]):
        """Tokens for logits `rows` [R, V] (fp32): argmax, except where the slot
        listed for that row samples — then argmax(row / temp + Gumbel noise)
        with noise from the slot's own generator."""
        toks = rows.argmax(dim=-1)
        for i, slot in enumerate(slots):
            temp = float(self._temps[slot])
            if temp > 0.0:
                u = torch.rand(rows.shape[-1], generator=self._gens[slot], device=rows.device)
                gumbel = -torch.log(-torch.log(u.clamp_min(torch.finfo(torch.float32).tiny)))
                toks[i] = (rows[i] / max(temp, 1e-6) + gumbel).argmax()
        return toks

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

    def _finish(self, slot: int, reason: str, now: float) -> None:
        self._record_result(self._slot_states[slot].result, reason, now)
        self._slot_states[slot] = None
        self._remaining[slot] = _IDLE_REMAINING
        self._eods[slot] = -1
        self._temps[slot] = 0.0
        self._positions[slot] = 0  # idle rows decode at position 0, inside the ring
        self._gens[slot] = None

    def _truncate_window(self, req: ServeRequest, result: ServeResult) -> list[int]:
        """Clip the prompt to capacity-1 tokens so at least one can be generated;
        the clipping is recorded on the result and counted."""
        window = req.prompt_tokens[-(self.capacity - 1) :]
        if len(window) < len(req.prompt_tokens):
            result.truncated = True
            self.truncated_requests += 1
        return window

    def _admit(self, t0: float) -> None:
        """Fill idle slots from the queue (FIFO, arrival-gated): chunked prefill
        into the freed slot right here, the first token taken from the last
        chunk's logits."""
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
            result = ServeResult(
                rid=req.rid, prompt_len=len(req.prompt_tokens), arrival_s=max(req.arrival_offset_s, 0.0)
            )
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
                    chunk = next(c for c in PREFILL_CHUNKS if c <= len(window) - pos)
                    toks = torch.tensor([window[pos : pos + chunk]], dtype=torch.long).to(self.device)
                    logits = self.module.prefill_slot(self.cache, toks, slot, pos)
                    self.prefill_chunk_count += 1
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
            self._slot_states[slot] = _SlotState(request=req, result=result, remaining=req.max_new_tokens - 1)
            self._tokens[slot] = first_tok
            self._positions[slot] = len(window)
            self._eods[slot] = self.eod_token_id
            self._remaining[slot] = req.max_new_tokens - 1

    def _active_count(self) -> int:
        return sum(s is not None for s in self._slot_states)

    def _decode_dispatch(self, t0: float) -> None:
        """ONE batched forward for every slot, then host bookkeeping on the
        single (tokens, finished, ok) fetch."""
        start = time.perf_counter()
        host = torch.from_numpy(np.stack([self._tokens, self._positions, self._eods, self._remaining]))
        dev = host.to(self.device, non_blocking=True)
        tokens, positions, eods, remaining = dev[0], dev[1], dev[2], dev[3]
        with torch.inference_mode():
            logits = self.module.decode_slots(self.cache, tokens[:, None], positions)
            rows = logits[:, 0, :]  # [slots, V]
            toks = self._sample(rows, list(range(self.slots)))
            # per-slot stopping folded into the step: eod never emits, budget
            # emits its last token then stops — the host only reads flags
            finished = (toks == eods) | (remaining <= 1)
            ok = torch.isfinite(rows).all(dim=-1)
            fetched = torch.stack([toks, finished.long(), ok.long()]).cpu()
        toks_h, finished_h, ok_h = fetched.numpy()
        self.decode_seconds += time.perf_counter() - start
        now = self._now() - t0
        active = self._active_count()
        emitted = 0
        for slot in range(self.slots):
            state = self._slot_states[slot]
            if state is None:
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
            if self._positions[slot] >= self.capacity:
                # ring full: the request finishes (the interactive path would
                # re-forward a sliding window instead)
                self._finish(slot, "capacity", now)
        self.decode_steps += 1
        self._occupancy_sum += active
        self.max_concurrent = max(self.max_concurrent, active)
        self.decode_token_count += emitted

    @staticmethod
    def _now() -> float:
        return time.monotonic()

    def step(self, t0: float) -> bool:
        """One scheduler round: admit, then one decode step. Returns True if any
        device work was dispatched."""
        chunks_before = self.prefill_chunk_count
        self._admit(t0)
        did = self.prefill_chunk_count != chunks_before
        if self._active_count():
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
        return {
            "kv_cache": "ring",
            "device": str(self.device),
            "decode_steps": self.decode_steps,
            "decode_tokens": self.decode_token_count,
            "prefill_chunks": self.prefill_chunk_count,
            "forward_calls": self.decode_steps + self.prefill_chunk_count,
            "slot_occupancy": occupancy,
            "max_concurrent": self.max_concurrent,
            "slots": self.slots,
            "capacity": self.capacity,
            "truncated_requests": self.truncated_requests,
            "queue_depth": len(self._queue),
            "active_slots": self._active_count(),
            "request_errors": self.request_errors,
            "prefill_seconds": self.prefill_seconds,
            "decode_seconds": self.decode_seconds,
            "quant_weights": self.quant_weights,
            "kv_pool_bytes": self.kv_pool_bytes,
            "weights_bytes": self.weights_bytes,
            "quant_bytes_saved": self.quant_bytes_saved,
        }

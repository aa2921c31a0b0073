"""Interactive text generation: the port of
modalities_tpu/inference/text/inference_component.py (`TextInferenceComponent`
and its config).

The prompt prefills the model's KV cache (`GPT2Module.decode_step`) in groups
of (64, 16, 4, 1) tokens, then each new token is one cached step. The decode
loop keeps the sampled tokens on the device: each step feeds the previous
step's token tensor to the next without a host round trip, and the host reads
the tokens back every `CHECK_EVERY` steps to stop at the eod token (steps run
past the eod token are discarded, never emitted). When the cache fills, the
rest continues on the sliding-window re-forward path (a full forward of the
last `sequence_length` tokens, padded to a power-of-two bucket), as in the
JAX component, so both paths emit the same continuation.

Greedy decoding (`temperature` 0 or None) takes the first maximal logit, as
`jnp.argmax` does. Temperature sampling draws from the port's own
`torch.Generator` seeded with `seed` (the JAX component splits a
`jax.random` key): the same seed repeats the same continuation, but not the
JAX package's.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional

import torch

from modalities_tpu_torch.config.config import check_float, check_int, check_str


@dataclasses.dataclass
class TextInferenceComponentConfig:
    """The reference's `inference_component.text` node (JAX
    TextInferenceComponentConfig); `device` is accepted for config parity
    (the entry point places the component)."""

    model: Any
    tokenizer: Any
    prompt_template: str
    sequence_length: int
    temperature: Optional[float] = 1.0
    seed: int = 0
    eod_token: Optional[str] = "<eod>"
    device: Optional[Any] = None

    def __post_init__(self):
        check_str("prompt_template", self.prompt_template)
        check_int("sequence_length", self.sequence_length, ge=1)
        self.temperature = check_float("temperature", self.temperature, ge=0.0, optional=True)
        check_int("seed", self.seed)
        check_str("eod_token", self.eod_token, optional=True)


class TextInferenceComponent:
    _PREFILL_CHUNKS = (64, 16, 4, 1)  # power-of-two groups, as the JAX component's
    CHECK_EVERY = 16  # decode steps between the host's reads of the sampled tokens

    def __init__(self, model, tokenizer, prompt_template: str, sequence_length: int,
                 temperature: Optional[float] = 1.0, seed: int = 0, eod_token: str = "<eod>", device=None,
                 params: Optional[dict] = None):
        self.model = model
        self.params = params
        self.tokenizer = tokenizer
        self.prompt_template = prompt_template
        self.sequence_length = sequence_length
        # None means greedy, as 0.0 does
        self.temperature = 0.0 if temperature is None else float(temperature)
        self.seed = seed
        self.eod_token = eod_token
        self.device: Optional[torch.device] = None
        self._module = None

    @property
    def module(self):
        """The serving module over `params` (built once, on the component's
        device; the weights quantized as MODALITIES_TPU_QUANT_WEIGHTS says)."""
        if self._module is None:
            from modalities_tpu_torch.device import resolve_device
            from modalities_tpu_torch.quant.weights import (
                quantize_params,
                quantized_model,
                resolve_quant_weights_mode,
            )

            if self.params is None:
                raise ValueError("params not resolved — generate_text loads or initializes them first")
            self.device = resolve_device(self.device)
            mode = resolve_quant_weights_mode(None)
            params = quantize_params({k: v.to(self.device) for k, v in self.params.items()}, mode)
            self._module = quantized_model(self.model, mode).build_module(params)
        return self._module

    def _eod_id(self) -> int:
        try:
            return self.tokenizer.get_token_id(self.eod_token)
        except Exception:
            return -1

    def _sample(self, logits: torch.Tensor, generator: torch.Generator) -> torch.Tensor:
        """logits [1, V] -> the next token [1] (int64, on the logits' device)."""
        if self.temperature > 0:
            probs = torch.softmax(logits.float() / self.temperature, dim=-1)
            return torch.multinomial(probs, 1, generator=generator)[:, 0]
        return torch.argmax(logits, dim=-1)

    def _generator(self, seed: Optional[int]) -> torch.Generator:
        return torch.Generator(device=self.module.device).manual_seed(self.seed if seed is None else seed)

    def generate_token_ids(self, context: str, max_new_tokens: Optional[int] = None,
                           seed: Optional[int] = None) -> list[int]:
        """The generated token ids of `context` (eod not included)."""
        token_ids = list(self.tokenizer.tokenize(context))
        budget = max_new_tokens if max_new_tokens is not None else self.sequence_length - len(token_ids)
        generator = self._generator(seed)
        with torch.no_grad():
            return self._generate_cached(token_ids, self._eod_id(), max(0, budget), generator)

    def generate_tokens(self, context: str, max_new_tokens: Optional[int] = None,
                        seed: Optional[int] = None) -> str:
        return self.tokenizer.decode(self.generate_token_ids(context, max_new_tokens, seed))

    def _generate_cached(self, token_ids: list[int], eod_id: int, budget: int, generator) -> list[int]:
        """The KV-cache path: the grouped prefill, then the decode loop; when the
        cache fills, the rest on the sliding-window re-forward path."""
        module = self.module
        capacity = min(self.sequence_length, self.model.config_spec.sequence_length)
        window = token_ids[-capacity:]
        if budget <= 0 or not window:
            return []
        cache = module.init_decode_cache(batch_size=1)
        pos = 0
        while pos < len(window):
            chunk = next(c for c in self._PREFILL_CHUNKS if c <= len(window) - pos)
            toks = torch.tensor([window[pos:pos + chunk]], dtype=torch.int64, device=module.device)
            logits, cache = module.decode_step(cache, toks)
            pos += chunk
        consumed = len(window)
        max_steps = min(budget, capacity - consumed)
        generated, stopped = self._decode_loop(cache, logits[:, -1, :], generator, eod_id, max_steps)
        if stopped:
            return generated
        consumed += len(generated)
        if consumed >= capacity and len(generated) < budget:
            generated += self._generate_reforward(window + generated, eod_id, budget - len(generated), generator)
        return generated

    def _decode_loop(self, cache, logits, generator, eod_id: int, max_steps: int) -> tuple[list[int], bool]:
        """Up to `max_steps` tokens from `logits` [1, V]; returns (the tokens
        before the first eod, whether the eod stopped them)."""
        module = self.module
        out = torch.empty(max(max_steps, 1), dtype=torch.int64, device=module.device)
        produced = 0
        for i in range(max_steps):
            tok = self._sample(logits, generator)
            out[i:i + 1].copy_(tok)
            produced = i + 1
            if produced % self.CHECK_EVERY == 0 and bool((out[:produced] == eod_id).any()):
                break
            if produced < max_steps:
                logits = module.decode_step(cache, tok.view(1, 1))[0][:, -1, :]
        tokens = out[:produced].tolist()
        if eod_id in tokens:
            return tokens[:tokens.index(eod_id)], True
        return tokens, False

    def _generate_reforward(self, token_ids: list[int], eod_id: int, budget: int, generator) -> list[int]:
        """The bucketed full re-forward per token, sliding the context window
        once it passes `sequence_length`."""
        module = self.module
        token_ids = list(token_ids)
        generated: list[int] = []
        for _ in range(budget):
            window = token_ids[-self.sequence_length:]
            bucket = min(max(1 << (len(window) - 1).bit_length(), 8), self.sequence_length)
            padded = torch.zeros((1, bucket), dtype=torch.int64, device=module.device)
            padded[0, :len(window)] = torch.tensor(window, dtype=torch.int64)
            logits = module(padded)[:, len(window) - 1]
            next_id = int(self._sample(logits, generator))
            if next_id == eod_id:
                break
            token_ids.append(next_id)
            generated.append(next_id)
        return generated

    def run(self) -> None:
        """The interactive prompt loop: one completion per line of input, until EOF."""
        while True:
            try:
                prompt = input("enter prompt> ").strip()
            except (EOFError, KeyboardInterrupt):
                print()
                break
            if not prompt:
                continue
            text = self.prompt_template.format(prompt=prompt) if self.prompt_template else prompt
            print(self.generate_tokens(context=text), flush=True)

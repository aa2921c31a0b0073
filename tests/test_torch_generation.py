"""Text generation in the port against the JAX package, on the tiny GPT2 of
tests/models/test_gpt2_model.py:tiny_gpt2 with the JAX weights carried across
by `params_from_jax`, all in f32:

- `GPT2Module.init_decode_cache` / `decode_step` (models/gpt2/gpt2_model.py)
  against the JAX `decode_step` over the prefill ladder's groups (64 is past
  the model; 16, 4, 1) and single steps, batch 2, at 1e-5, and against the
  port's own full forward;
- `TextInferenceComponent` (inference/text/inference_component.py) greedy
  against the JAX component token for token: a run that stops at the eod
  token, a run that fills the cache and continues on the re-forward path,
  a prompt longer than the window, and a budget of 0;
- temperature sampling repeats itself for a seed and stops at eod (the port
  samples from its own generator, so not the JAX package's continuation).
Imports JAX for the oracles; the port's modules import none."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.core import meta

from modalities_tpu.inference.text.inference_component import TextInferenceComponent as JaxComponent
from modalities_tpu_torch.conversion.from_jax import params_from_jax
from modalities_tpu_torch.inference.text.inference_component import TextInferenceComponent
from modalities_tpu_torch.models.gpt2.gpt2_model import GPT2LLM
from tests.models.test_gpt2_model import tiny_gpt2
from tests.test_torch_gpt2 import port_config

TOL = dict(atol=1e-5, rtol=1e-5)


class _Tok:
    """Characters as token ids; `eod` names the eod token's id."""

    vocab_size = 128

    def __init__(self, eod: int = 127):
        self.eod = eod

    def tokenize(self, text):
        return [ord(c) % 120 for c in text]

    def decode(self, ids):
        return " ".join(str(i) for i in ids)

    def get_token_id(self, token):
        return self.eod


@pytest.fixture(scope="module")
def models():
    jm = tiny_gpt2("manual").with_spec_updates(compute_dtype="float32")
    params = meta.unbox(jm.init_params(jax.random.PRNGKey(0)))
    pm = GPT2LLM(**port_config()).with_spec_updates(compute_dtype="float32")
    return jm, params, pm, params_from_jax(jax.tree.map(np.asarray, params), pm)


def test_decode_step_matches_jax_over_the_prefill_groups_and_single_steps(models):
    jm, params, pm, pparams = models
    module = pm.build_module(pparams)
    toks = np.random.default_rng(3).integers(0, 128, size=(2, 27)).astype(np.int32)
    jc = jm.init_decode_cache(params, batch_size=2)
    pc = module.init_decode_cache(batch_size=2)
    outs, pos = [], 0
    for group in (16, 4, 1, 1, 1, 4):  # the ladder's groups, then single steps
        jl, jc = jm.decode_step(params, jc, jnp.asarray(toks[:, pos:pos + group]))
        with torch.no_grad():
            pl, pc = module.decode_step(pc, torch.as_tensor(toks[:, pos:pos + group], dtype=torch.int64))
        assert pl.shape == (2, group, 128) and pl.dtype == torch.float32 and pc.index == pos + group
        np.testing.assert_allclose(pl.numpy(), np.asarray(jl), **TOL)
        outs.append(pl)
        pos += group
    with torch.no_grad():
        full = module(torch.as_tensor(toks, dtype=torch.int64))
    np.testing.assert_allclose(torch.cat(outs, dim=1).numpy(), full.numpy(), **TOL)
    with pytest.raises(ValueError, match="overflow the cache"):
        module.decode_step(pc, torch.zeros((2, 6), dtype=torch.int64))


def _pair(models, eod: int, sequence_length: int = 32):
    jm, params, pm, pparams = models
    kwargs = dict(prompt_template="{prompt}", sequence_length=sequence_length, temperature=0, eod_token="<eod>")
    port = TextInferenceComponent(model=pm, params=pparams, tokenizer=_Tok(eod), **kwargs)
    port.device = torch.device("cpu")
    return JaxComponent(model=jm, params=params, tokenizer=_Tok(eod), **kwargs), port


def _jax_ids(component, prompt: str, budget: int) -> list[int]:
    ids = component.tokenizer.tokenize(prompt)
    return component._generate_cached(ids, component.tokenizer.eod, budget, jax.random.PRNGKey(0))


@pytest.mark.parametrize("prompt,budget,eod,ends", [
    ("hello", 20, 127, "budget"),
    ("hello", 20, None, "eod"),  # eod: a token the unstopped run emits
    ("a cache-filling prompt", 20, 127, "reforward"),
    ("x" * 40, 6, 127, "reforward"),  # longer than the window: only its last 32 tokens prefill
    ("hello", 0, 127, "nothing"),
], ids=["budget", "eod-stop", "cache-full-reforward", "window-longer-than-cache", "zero-budget"])
def test_greedy_completions_equal_the_jax_components_token_for_token(models, prompt, budget, eod, ends):
    if eod is None:  # stop on the 5th token the unstopped run emits
        _, port = _pair(models, 127)
        eod = port.generate_token_ids(prompt, budget)[4]
    jax_c, port = _pair(models, eod)
    want = _jax_ids(jax_c, prompt, budget)
    got = port.generate_token_ids(prompt, budget)
    assert got == want
    if ends == "budget":
        assert len(got) == budget
    elif ends == "eod":
        assert eod not in got and len(got) < budget
    elif ends == "reforward":
        assert len(_Tok().tokenize(prompt)[-32:]) + len(got) > 32 and len(got) == budget
    else:
        assert got == []
    assert port.generate_tokens(prompt, budget) == " ".join(str(i) for i in got)


def test_temperature_sampling_repeats_for_a_seed(models):
    _, port = _pair(models, 127)
    port.temperature = 0.8
    first = port.generate_token_ids("hello", 24, seed=5)
    assert first == port.generate_token_ids("hello", 24, seed=5) and len(first) == 24
    assert first != port.generate_token_ids("hello", 24, seed=6)

"""Port parity for the continuous-batching engine: modalities_tpu_torch's
ServingEngine (ring cache) against the JAX ServingEngine with the same weights,
on the CPU in f32.

Greedy tokens and finish reasons must be identical — including an `eod` and a
`capacity` finish. Sampled tokens cannot match JAX (Threefry vs torch's
generator), so they are held to determinism instead: the same seed gives the
same tokens, alone or batched."""

import jax
import numpy as np
import pytest
import torch

from modalities_tpu.serving.engine import ServingEngine as JaxServingEngine
from modalities_tpu.telemetry.metrics import MetricsRegistry
from modalities_tpu_torch.conversion.from_jax import params_from_jax
from modalities_tpu_torch.serving.engine import ServingEngine
from tests.test_torch_gpt2 import jax_and_port

CAPACITY = 24
# (prompt, budget): the last one outgrows the 24-token ring and finishes "capacity"
GREEDY_REQS = [([3, 17, 42, 9, 77, 5, 23], 8), ([7, 7, 7], 6), (list(range(1, 19)), 12)]


def _serve(engine, reqs, temperature=0.0, seed=0):
    rids = [engine.submit(p, b, temperature=temperature, seed=seed + i) for i, (p, b) in enumerate(reqs)]
    results = engine.run()
    return [(results[r].tokens, results[r].finish_reason) for r in rids]


@pytest.fixture(scope="module")
def pair():
    """(jax model, jax params, port model) sharing f32 weights, untied head."""
    jm, jparams, pm, _ = jax_and_port("float32", use_weight_tying=False)
    return jm, jparams, pm


def _jax_engine(jm, jparams, eod, quant=None):
    return JaxServingEngine(
        jm, jparams, max_batch_slots=2, cache_capacity=CAPACITY, eod_token_id=eod,
        quant_weights=quant, metrics=MetricsRegistry(),
    )


def _port_engine(pm, params, eod, quant=None):
    return ServingEngine(
        pm, params, device="cpu", max_batch_slots=2, cache_capacity=CAPACITY, eod_token_id=eod,
        quant_weights=quant,
    )


@pytest.mark.parametrize("quant", [None, "int8"], ids=["f32-weights", "int8-weights"])
def test_greedy_tokens_and_finish_reasons_match_jax(pair, quant):
    jm, jparams, pm = pair
    # eod = a greedy token of the first request that the others never emit,
    # so exactly that request finishes "eod" on both sides; the JAX engine
    # quantizes inside its constructor, and its quantized tree is what crosses
    probes = [toks for toks, _ in _serve(_jax_engine(jm, jparams, -1, quant), GREEDY_REQS)]
    eod = next(t for t in probes[0][1:] if t not in probes[1] + probes[2])
    jax_engine = _jax_engine(jm, jparams, eod, quant)
    want = _serve(jax_engine, GREEDY_REQS)
    port_params = params_from_jax(jax.tree.map(np.asarray, jax_engine.params), pm)
    got = _serve(_port_engine(pm, port_params, eod, quant), GREEDY_REQS)
    assert got == want
    assert [reason for _, reason in got] == ["eod", "budget", "capacity"]


def test_sampled_tokens_depend_on_the_seed_alone(pair):
    jm, jparams, pm = pair
    params = params_from_jax(jax.tree.map(np.asarray, jparams), pm)
    req = ([5, 9, 2, 31, 4], 8)

    def alone(seed):
        engine = _port_engine(pm, params, -1)
        rid = engine.submit(*req, temperature=0.8, seed=seed)
        return engine.run()[rid].tokens

    engine = _port_engine(pm, params, -1)
    rids = [
        engine.submit([11, 12, 13], 6, temperature=0.8, seed=7),
        engine.submit(*req, temperature=0.8, seed=1),
        engine.submit([1, 2], 5, temperature=0.0),
    ]
    batched = engine.run()[rids[1]].tokens
    assert alone(1) == batched == alone(1)
    assert alone(2) != alone(1)


def test_engine_counts_and_prefill_ladder(pair):
    jm, jparams, pm = pair
    params = params_from_jax(jax.tree.map(np.asarray, jparams), pm)
    engine = _port_engine(pm, params, -1)
    rids = [engine.submit(list(range(1, 22)), 2, temperature=0.0), engine.submit([4], 3, temperature=0.0)]
    results = engine.run()
    stats = engine.stats()
    # 21 prompt tokens on the (64, 16, 4, 1) ladder: 16 + 4 + 1 = 3 chunks; 1 token: 1 chunk
    assert stats["prefill_chunks"] == 4
    assert stats["forward_calls"] == stats["prefill_chunks"] + stats["decode_steps"]
    assert stats["decode_tokens"] == sum(len(results[r].tokens) for r in rids) - len(rids)
    assert stats["kv_pool_bytes"] == 2 * 2 * 2 * CAPACITY * 2 * 32 * 4  # k+v, L, slots, cap, Hkv, D, f32


def test_engine_defaults_to_the_card(pair, monkeypatch):
    _, jparams, pm = pair
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ServingEngine(pm, params_from_jax(jax.tree.map(np.asarray, jparams), pm))


def test_truncation_and_zero_budget_follow_jax(pair):
    jm, jparams, pm = pair
    params = params_from_jax(jax.tree.map(np.asarray, jparams), pm)
    reqs = [(list(range(1, 31)), 3), ([1, 2], 0)]  # 30 tokens > window of 23
    want_engine = _jax_engine(jm, jparams, -1)
    want = _serve(want_engine, reqs)
    engine = _port_engine(pm, params, -1)
    assert _serve(engine, reqs) == want
    assert engine.stats()["truncated_requests"] == 1 == want_engine.stats()["truncated_requests"]

"""Port parity for quantized serving on the paged engine (JAX
tests/serving/test_quant_serving.py:56-159): int8 weights and the int8 KV
pool against the JAX engine on the same weights, on the CPU (f32 compute).
Greedy tokens, finish reasons and the shared counters must be equal (the two
quantizers give the same codes here: tests/test_torch_paged_model.py counts
the codes off by one); the port's own invariants hold on the quantized pool
(one shape each, a clean pool audit, preemption replayed bitwise, the same
tokens from raw and pre-quantized parameters). Also the two repairs of the
quant mode resolution: MODALITIES_TPU_QUANT_WEIGHTS is applied before the
config, as in the JAX package, and MODALITIES_TPU_QUANT_KV=int8 on the ring
raises as the JAX engine does."""

import jax
import numpy as np
import pytest
import torch

from modalities_tpu.quant.weights import resolve_quant_weights_mode as jax_resolve_weights
from modalities_tpu.serving.engine import ServingEngine as JaxServingEngine
from modalities_tpu.telemetry.metrics import MetricsRegistry
from modalities_tpu_torch.quant.weights import quantize_params, resolve_quant_weights_mode
from modalities_tpu_torch.serving.engine import ServingEngine
from tests.test_torch_paged_engine import compare, pair, serve  # noqa: F401  (pair: the module's fixture)

REQS = [
    ([3, 17, 42, 9, 77], 8, 0.0, 0),
    ([7, 7, 7], 5, 0.8, 1),
    (list(range(1, 18)), 6, 0.0, 2),  # prompt spans 3 blocks
    ([99, 3, 55, 8, 120], 6, 0.8, 3),
]
QUANT = dict(max_batch_slots=2, quant_weights="int8", quant_kv="int8")


def test_int8_weights_and_kv_match_jax_and_keep_every_invariant(pair):
    _, got, port = compare(pair, REQS, **QUANT)
    assert [r.finish_reason for r in got] == ["budget"] * 4 and all(r.tokens for r in got)
    stats = port.stats()
    assert stats["decode_executables"] == stats["prefill_executables"] == 1
    assert stats["quant_weights"] == stats["quant_kv"] == "int8" and stats["quant_bytes_saved"] > 0
    assert port.cache.k.dtype == torch.int8 and port.cache.k_scale.dtype == torch.float32
    assert stats["kv_scale_bytes"] == port.cache.scale_bytes > 0
    f32 = ServingEngine(pair[2], pair[3], device="cpu", max_batch_slots=2, kv_cache="paged", paged_block_size=8)
    # int8 data is a quarter of f32 data (half of bf16): the scales stand apart
    assert stats["kv_pool_bytes"] - stats["kv_scale_bytes"] == f32.stats()["kv_pool_bytes"] // 4


def test_int8_kv_alone_matches_jax(pair):
    compare(pair, REQS, max_batch_slots=2, quant_kv="int8")


def test_raw_and_prequantized_params_serve_the_same_tokens(pair):
    _, _, pm, pparams = pair
    kwargs = dict(device="cpu", kv_cache="paged", paged_block_size=8, **QUANT)
    raw = serve(ServingEngine(pm, pparams, **kwargs), REQS)
    pre = serve(ServingEngine(pm, quantize_params(pparams, "int8"), **kwargs), REQS)
    assert [r.tokens for r in raw] == [r.tokens for r in pre]
    with pytest.raises(ValueError, match="arrive quantized"):
        ServingEngine(pm, quantize_params(pparams, "fp8"), device="cpu", quant_weights="int8")


def test_preemption_replay_on_the_int8_pool(pair):
    reqs = [(list(range(1, 9)), 15, 0.0, 0), ([5, 9, 2], 20, 0.8, 1)]
    kwargs = dict(paged_block_size=4, paged_max_len=24, **QUANT)
    _, tight, port = compare(pair, reqs, paged_num_blocks=9, **kwargs)
    assert port.stats()["preemptions"] >= 1
    _, ample, _ = compare(pair, reqs, paged_num_blocks=16, **kwargs)
    assert [r.tokens for r in tight] == [r.tokens for r in ample]


def test_resolve_weights_mode_env_beats_config(monkeypatch):
    """JAX tests/quant/test_quant_weights.py:32-40, on both resolvers."""
    monkeypatch.delenv("MODALITIES_TPU_QUANT_WEIGHTS", raising=False)
    for resolve in (jax_resolve_weights, resolve_quant_weights_mode):
        assert resolve(None) == "none" and resolve("int8") == "int8" and resolve("off") == "none"
        with pytest.raises(ValueError, match="config quant.weights"):
            resolve("int3")
    monkeypatch.setenv("MODALITIES_TPU_QUANT_WEIGHTS", "fp8")
    assert resolve_quant_weights_mode("int8") == jax_resolve_weights("int8") == "fp8"
    monkeypatch.setenv("MODALITIES_TPU_QUANT_WEIGHTS", "int4")
    for resolve in (jax_resolve_weights, resolve_quant_weights_mode):
        with pytest.raises(ValueError, match="MODALITIES_TPU_QUANT_WEIGHTS"):
            resolve(None)


def test_weights_env_switch_quantizes_the_served_model(pair, monkeypatch):
    """With MODALITIES_TPU_QUANT_WEIGHTS=int8 and no config mode, both
    engines serve int8 weights (the port served f32 weights before), and the
    same greedy tokens."""
    monkeypatch.setenv("MODALITIES_TPU_QUANT_WEIGHTS", "int8")
    _, _, port = compare(pair, REQS[:1], max_batch_slots=1, kv_cache="ring")
    assert port.quant_weights == "int8" and port.stats()["quant_bytes_saved"] > 0
    assert port.module.blocks[0].attn.q_attn.kernel.dtype == torch.int8


def test_quant_kv_env_on_the_ring_raises_as_in_jax(pair, monkeypatch):
    jm, jparams, pm, pparams = pair
    monkeypatch.setenv("MODALITIES_TPU_QUANT_KV", "int8")
    with pytest.raises(ValueError, match="requires kv_cache='paged'"):
        JaxServingEngine(jm, jparams, metrics=MetricsRegistry(), kv_cache="ring")
    with pytest.raises(ValueError, match="requires kv_cache='paged'"):
        ServingEngine(pm, pparams, device="cpu", kv_cache="ring")
    assert ServingEngine(pm, pparams, device="cpu", kv_cache="paged", paged_block_size=8).quant_kv == "int8"


def test_quantized_params_cross_from_jax(pair):
    """The JAX engine's int8 tree, carried across, serves as the port's own
    quantization of the f32 weights does (the quantizers agree code for code
    on the weights)."""
    jm, jparams, pm, pparams = pair
    from modalities_tpu_torch.conversion.from_jax import params_from_jax
    from modalities_tpu_torch.quant.weights import quantized_model

    jax_engine = JaxServingEngine(jm, jparams, metrics=MetricsRegistry(), quant_weights="int8")
    crossed = params_from_jax(jax.tree.map(np.asarray, jax_engine.params), quantized_model(pm, "int8"))
    ours = quantize_params(pparams, "int8")
    assert all(torch.equal(crossed[k], ours[k]) for k in crossed if k.endswith(".kernel"))

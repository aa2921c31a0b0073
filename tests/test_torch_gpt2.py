"""Port parity: modalities_tpu_torch's GPT2 slot-cache model against the JAX
model with the same weights (carried across by params_from_jax) on the same
numpy-made tokens. Runs on the CPU, where the port's norm and dequant-matmul
take their plain PyTorch versions.

Tolerances: f32 logits atol 1e-4 (the two frameworks sum in different orders;
observed differences are ~1e-6). bf16 compute: atol 2e-2 on logits of
magnitude < 1, a few bf16 ulps, since the two frameworks round bf16
intermediates at different places."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.core import meta

from modalities_tpu.quant.weights import quantize_params as jax_quantize_params
from modalities_tpu.quant.weights import quantized_model as jax_quantized_model
from modalities_tpu_torch.conversion.from_jax import params_from_jax
from modalities_tpu_torch.models.gpt2.gpt2_model import GPT2LLM, rope_tables
from modalities_tpu_torch.quant.weights import quantized_model
from tests.models.test_gpt2_model import tiny_gpt2

F32_ATOL = 1e-4
BF16_ATOL = 2e-2


def port_config(**overrides) -> dict:
    """tests/models/test_gpt2_model.py:tiny_gpt2's configuration as a config dict."""
    cfg = dict(
        sample_key="input_ids",
        prediction_key="logits",
        poe_type="NOPE",
        sequence_length=32,
        vocab_size=128,
        n_layer=2,
        n_head_q=4,
        n_head_kv=2,
        n_embd=128,
        ffn_hidden=128,
        dropout=0.0,
        bias=False,
        attention_config={
            "qkv_transforms": [
                {"type_hint": "RotaryTransform", "config": {"n_embd": 128, "n_head": 4, "base_freq": 10000}}
            ]
        },
        attention_implementation="manual",
        activation_type="swiglu",
        attention_norm_config={"norm_type": "rms_norm", "config": {"ndim": 128, "bias": False}},
        ffn_norm_config={"norm_type": "rms_norm", "config": {"ndim": 128, "bias": False}},
        lm_head_norm_config={"norm_type": "rms_norm", "config": {"ndim": 128, "bias": False}},
        use_weight_tying=True,
        seed=0,
    )
    cfg.update(overrides)
    return cfg


def jax_and_port(compute_dtype="float32", quant="none", **overrides):
    """(jax model, jax params, port model, port params) with shared weights.
    A quantized pair quantizes on the JAX side and carries the quantized tree
    across, as the JAX engine's `.params` would be."""
    jm = tiny_gpt2("manual", **overrides).with_spec_updates(compute_dtype=compute_dtype)
    params = meta.unbox(jm.init_params(jax.random.PRNGKey(0)))
    pm = GPT2LLM(**port_config(**overrides)).with_spec_updates(compute_dtype=compute_dtype)
    if quant != "none":
        jm = jax_quantized_model(jm, quant)
        params = jax_quantize_params(params, quant)
        pm = quantized_model(pm, quant)
    return jm, params, pm, params_from_jax(jax.tree.map(np.asarray, params), pm)


CASES = [
    pytest.param({"use_weight_tying": True}, "none", id="tied"),
    pytest.param({"use_weight_tying": False}, "none", id="untied"),
    pytest.param({"use_weight_tying": False}, "int8", id="untied-int8"),
    pytest.param({"use_weight_tying": True}, "int8", id="tied-int8"),
    pytest.param({"use_weight_tying": False}, "fp8", id="untied-fp8"),
    pytest.param({"poe_type": "ABSOLUTE", "activation_type": "gelu", "bias": True}, "none", id="absolute-gelu-bias"),
]


def _run_both(jm, params, module, dtype_atol, steps=3):
    rng = np.random.default_rng(0)
    prompt = rng.integers(0, 128, size=(1, 6))
    jc = jm.init_slot_cache(params, 2, 16)
    pc = module.init_slot_cache(2, 16)
    jl, jc = jm.prefill_slot(params, jc, jnp.asarray(prompt, jnp.int32), 1, 0)
    with torch.inference_mode():
        pl = module.prefill_slot(pc, torch.as_tensor(prompt), 1, 0)
    np.testing.assert_allclose(pl.numpy(), np.asarray(jl), atol=dtype_atol, rtol=0)
    positions = np.array([2, 6])
    for _ in range(steps):
        toks = rng.integers(0, 128, size=(2, 1))
        jl, jc = jm.decode_slots(params, jc, jnp.asarray(toks, jnp.int32), jnp.asarray(positions, jnp.int32))
        with torch.inference_mode():
            pl = module.decode_slots(pc, torch.as_tensor(toks), torch.as_tensor(positions))
        assert pl.shape == (2, 1, 128) and pl.dtype == torch.float32
        np.testing.assert_allclose(pl.numpy(), np.asarray(jl), atol=dtype_atol, rtol=0)
        positions = positions + 1
    attn = jc["blocks"]["block"]["attn"]
    for ours, theirs in ((pc.k, attn["cached_key"]), (pc.v, attn["cached_value"])):
        assert tuple(ours.shape) == tuple(theirs.shape)  # [L, slots, capacity, Hkv, D]
        np.testing.assert_allclose(
            ours.float().numpy(), np.asarray(theirs.astype(jnp.float32)), atol=dtype_atol, rtol=0
        )


@pytest.mark.parametrize("overrides,quant", CASES)
def test_slot_prefill_and_decode_match_jax_f32(overrides, quant):
    jm, params, pm, pparams = jax_and_port("float32", quant, **overrides)
    _run_both(jm, params, pm.build_module(pparams), F32_ATOL)


def test_slot_prefill_and_decode_match_jax_bf16_compute():
    jm, params, pm, pparams = jax_and_port("bfloat16", use_weight_tying=False)
    module = pm.build_module(pparams)
    assert module.blocks[0].attn.q_attn.kernel.dtype == torch.bfloat16  # cast once at load
    assert module.lm_head.kernel.dtype == torch.float32  # the head stays fp32
    assert module.wte.dtype == torch.float32
    _run_both(jm, params, module, BF16_ATOL)


def test_rope_tables_match_jax():
    from modalities_tpu.models.gpt2.gpt2_model import _rope_tables

    for dtype, jdtype in ((torch.float32, jnp.float32), (torch.bfloat16, jnp.bfloat16)):
        cos, sin = rope_tables(32, 64, 10000, dtype=dtype)
        jcos, jsin = _rope_tables(32, 64, 10000, dtype=jdtype)
        np.testing.assert_allclose(cos.float().numpy(), np.asarray(jcos.astype(jnp.float32)), atol=1e-6, rtol=0)
        np.testing.assert_allclose(sin.float().numpy(), np.asarray(jsin.astype(jnp.float32)), atol=1e-6, rtol=0)


def test_init_params_cover_the_module_and_follow_jax_initializers():
    pm = GPT2LLM(**port_config(use_weight_tying=False, bias=True))
    params = pm.init_params(torch.Generator().manual_seed(0))
    module = pm.build_module(params)
    assert set(params) == set(module.state_dict())
    assert torch.equal(params["blocks.0.attention_norm.scale"], torch.ones(128))
    assert torch.equal(params["blocks.1.attn.q_attn.bias"], torch.zeros(128))
    assert abs(float(params["wte"].std()) - 0.02) < 2e-3
    again = pm.init_params(torch.Generator().manual_seed(0))
    assert all(torch.equal(params[k], again[k]) for k in params)  # seeded, reproducible


@pytest.mark.parametrize(
    "overrides,match",
    [
        ({"n_head_kv": 3}, "divisible"),
        ({"vocab_size": 100}, "divisible by 128"),
        ({"dropout": 0.1, "attention_implementation": "dao_flash"}, "dropout"),
        ({"poe_type": "LEARNED"}, "poe_type"),
        ({"n_layer": 2.0}, "n_layer"),
        ({"not_a_field": 1}, "Invalid keys"),
    ],
)
def test_config_validation_refuses_what_jax_refuses(overrides, match):
    with pytest.raises(ValueError, match=match):
        GPT2LLM(**port_config(**overrides))


def test_yaml_style_epsilon_string_is_read_as_a_number():
    """YAML 1.1 reads `1e-5` as a string; the port accepts it as pydantic does."""
    cfg = port_config(lm_head_norm_config={"norm_type": "rms_norm", "config": {"ndim": 128, "epsilon": "1e-5"}})
    assert GPT2LLM(**cfg).config_spec.lm_head_norm.eps == 1e-5


@pytest.mark.parametrize(
    "impl,overrides",
    [
        ("dao_flash", {"use_weight_tying": False}),
        ("manual", {"use_weight_tying": True}),
        ("pytorch_flash", {"use_weight_tying": False}),
        ("manual", {"poe_type": "ABSOLUTE", "activation_type": "gelu", "bias": True}),
    ],
    ids=["dao_flash-untied", "manual-tied", "pytorch_flash", "manual-absolute-gelu-bias"],
)
def test_training_forward_matches_jax_apply_f32(impl, overrides):
    """The full-sequence forward (GPT2Module.forward) against the JAX model's
    `apply` in f32; on the CPU the JAX dao_flash and pytorch_flash tiers are
    XLA SDPA and the port's are its plain attention."""
    jm = tiny_gpt2(impl, **overrides).with_spec_updates(compute_dtype="float32")
    params = meta.unbox(jm.init_params(jax.random.PRNGKey(1)))
    tokens = np.random.default_rng(2).integers(0, 128, size=(2, 32))
    want = np.asarray(jm.apply(params, {"input_ids": jnp.asarray(tokens, jnp.int32)})["logits"])
    pm = GPT2LLM(**port_config(attention_implementation=impl, **overrides)).with_spec_updates(compute_dtype="float32")
    module = pm.build_train_module(params_from_jax(jax.tree.map(np.asarray, params), pm))
    got = module(torch.as_tensor(tokens))
    assert got.shape == (2, 32, 128) and got.dtype == torch.float32 and module.training
    np.testing.assert_allclose(got.detach().numpy(), want, atol=F32_ATOL, rtol=0)

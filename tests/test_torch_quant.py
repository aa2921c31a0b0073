"""Port parity for weight-only quantization: the plain dequant-matmul
(modalities_tpu_torch/ops/quant_matmul.py) against the JAX package's
`reference_quant_matmul`, and `quantize_params` against the JAX
`quantize_params` on the same fp32 weights.

The JAX interpret kernel is not the oracle here: its [8-16-24-8-8] case fails
on the JAX side itself, so the pure-jnp reference is the one held to.

Tolerances: f32 x: |err| <= 1e-5 * max|ref| (fp32 sums of K products taken in
a different order); bf16 x: one bf16 ulp (rtol 2^-7) on the bf16 output of
the same fp32 sum. Codes: equal; scales: rtol 1e-6."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from modalities_tpu.ops.pallas.quant_matmul import reference_quant_matmul as jax_reference_quant_matmul
from modalities_tpu.quant.core import quantize_fp8 as jax_quantize_fp8
from modalities_tpu.quant.core import quantize_per_channel as jax_quantize_per_channel
from modalities_tpu.quant.weights import quantize_params as jax_quantize_params
from modalities_tpu_torch.conversion.from_jax import params_from_jax, to_torch
from modalities_tpu_torch.ops.quant_matmul import quant_matmul
from modalities_tpu_torch.quant.core import quantize_fp8, quantize_per_channel
from modalities_tpu_torch.quant.weights import infer_quant_mode, quantize_params, weights_bytes_saved
from tests.test_torch_gpt2 import jax_and_port


def _case(m, k, n, mode, x_dtype, seed=0):
    rng = np.random.default_rng(seed)
    x = jnp.asarray(rng.standard_normal((m, k)).astype(np.float32)).astype(x_dtype)
    w = jnp.asarray(rng.standard_normal((k, n)).astype(np.float32))
    tree = jax_quantize_params({"d": {"kernel": w}}, mode)["d"]
    return x, tree["kernel"], tree["scale"]


@pytest.mark.parametrize("mode", ["int8", "fp8"])
@pytest.mark.parametrize("x_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("m,k,n", [(1, 64, 16), (5, 128, 48), (16, 256, 64)])
def test_plain_quant_matmul_matches_jax_reference(mode, x_dtype, m, k, n):
    x, wq, scale = _case(m, k, n, mode, x_dtype, seed=m + k + n)
    want = np.asarray(jax_reference_quant_matmul(x, wq, scale).astype(jnp.float32))
    xt = to_torch(np.asarray(x))
    got = quant_matmul(xt, to_torch(np.asarray(wq)), to_torch(np.asarray(scale)))
    assert got.dtype == xt.dtype and got.shape == (m, n)
    if x_dtype == "float32":
        np.testing.assert_allclose(got.numpy(), want, atol=1e-5 * np.abs(want).max(), rtol=0)
    else:
        np.testing.assert_allclose(got.float().numpy(), want, atol=1e-6, rtol=2**-7)


@pytest.mark.parametrize("mode", ["int8", "fp8"])
def test_quantize_params_matches_jax_codes_and_scales(mode):
    """Same fp32 weights through both quantizers: identical codes, scales to
    rtol 1e-6 — over a real model tree, so the [E,H,D] / [H,D,E] kernels the
    converter flattens are covered."""
    _, jparams, pm, pparams = jax_and_port("float32", use_weight_tying=False)
    ours = quantize_params(pparams, mode)
    theirs = params_from_jax(jax.tree.map(np.asarray, jax_quantize_params(jparams, mode)), pm)
    assert set(ours) == set(theirs)
    for key, want in theirs.items():
        got = ours[key]
        assert got.dtype == want.dtype, key
        if key.endswith(".scale") and key in pparams:  # norm scales: untouched
            assert torch.equal(got, pparams[key])
        elif key.endswith(".scale"):
            np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-6, atol=0)
        elif got.dtype in (torch.int8, torch.float8_e4m3fn):
            assert torch.equal(got.view(torch.uint8), want.view(torch.uint8)), key
    assert infer_quant_mode(ours) == mode
    assert weights_bytes_saved(ours) > 0
    assert quantize_params(ours, mode) == ours  # idempotent: nothing re-quantized


def test_core_quantizers_match_jax():
    rng = np.random.default_rng(3)
    x = rng.standard_normal((6, 40)).astype(np.float32)
    x[2] = 0.0  # a zero row takes the clamped scale
    q, s = quantize_per_channel(torch.from_numpy(x))
    jq, js = jax_quantize_per_channel(jnp.asarray(x))
    assert torch.equal(q, to_torch(np.asarray(jq)))
    np.testing.assert_allclose(s.numpy(), np.asarray(js), rtol=1e-6)
    q8, s8 = quantize_fp8(torch.from_numpy(x))
    jq8, js8 = jax_quantize_fp8(jnp.asarray(x))
    assert torch.equal(q8.view(torch.uint8), to_torch(np.asarray(jq8)).view(torch.uint8))
    np.testing.assert_allclose(s8.numpy(), np.asarray(js8), rtol=1e-6)

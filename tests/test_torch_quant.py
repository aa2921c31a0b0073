"""Port parity for weight-only quantization: the plain dequant-matmul
(modalities_tpu_torch/ops/quant_matmul.py) against the JAX package's
`reference_quant_matmul` and against its Pallas kernel run in interpret mode,
and `quantize_params` against the JAX `quantize_params` on the same fp32
weights; the card kernel's launch plan (the K split over a cluster's ranks)
and its split of fp32 x into three bf16 pieces, as plain functions.

The interpret kernel is held with a tolerance, not bitwise: the JAX suite's
own [8-16-24-8-8] bitwise case fails on the JAX side.

Tolerances: f32 x: |err| <= 1e-5 * max|ref| (fp32 sums of K products taken in
a different order); bf16 x: one bf16 ulp (rtol 2^-7) on the bf16 output of
the same fp32 sum. Codes: equal; scales: rtol 1e-6."""

import inspect

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from modalities_tpu.ops.pallas.quant_matmul import quant_matmul as jax_pallas_quant_matmul
from modalities_tpu.ops.pallas.quant_matmul import reference_quant_matmul as jax_reference_quant_matmul
from modalities_tpu.quant.core import quantize_fp8 as jax_quantize_fp8
from modalities_tpu.quant.core import quantize_per_channel as jax_quantize_per_channel
from modalities_tpu.quant.weights import quantize_params as jax_quantize_params
from modalities_tpu_torch.conversion.from_jax import params_from_jax, to_torch
from modalities_tpu_torch.ops.quant_matmul import (
    BLOCK_K,
    MAX_CLUSTER,
    quant_matmul,
    rank_k_tiles,
    reference_quant_matmul,
    split_bf16x3,
    split_k,
)
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


def _assert_within_tolerance(got, want, x_dtype):
    if x_dtype == "float32":
        np.testing.assert_allclose(got, want, atol=1e-5 * np.abs(want).max(), rtol=0)
    else:
        np.testing.assert_allclose(got, want, atol=1e-6, rtol=2**-7)


@pytest.mark.parametrize("mode", ["int8", "fp8"])
@pytest.mark.parametrize("x_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("m,n", [(1, 200), (4, 48), (8, 200), (16, 48), (64, 200)])
def test_plain_quant_matmul_matches_the_pallas_kernel_in_interpret_mode(mode, x_dtype, m, n):
    """Every row count of the serving path (decode 8, prefill 64/16/4/1); N
    ragged against the Pallas kernel's 128-column blocks."""
    x, wq, scale = _case(m, 128, n, mode, x_dtype, seed=7 * m + n)
    want = np.asarray(jax_pallas_quant_matmul(x, wq, scale, interpret=True).astype(jnp.float32))
    xt = to_torch(np.asarray(x))
    got = quant_matmul(xt, to_torch(np.asarray(wq)), to_torch(np.asarray(scale)))
    assert got.dtype == xt.dtype and got.shape == (m, n)
    _assert_within_tolerance(got.float().numpy(), want, x_dtype)


@pytest.mark.parametrize("k,n", [(2560, 2560), (2560, 640), (2560, 7680), (7680, 2560), (2560, 50304),
                                 (128, 64), (64, 16), (384, 4096), (11520, 2560)])
def test_split_plan_depends_on_k_and_n_only_and_its_ranks_cover_the_k_tiles(k, n):
    """The card kernel splits K over the CTAs of a cluster: rank r sums k tiles
    [r T / s, (r + 1) T / s). The plan takes the weight's shape and nothing
    else (no row count: a row's sum order never depends on the batch), its
    ranks cover the k tiles exactly, in order, none empty, and a cluster has
    at most 8 CTAs (the portable cluster size)."""
    assert list(inspect.signature(split_k).parameters) == ["k", "n"]
    assert list(inspect.signature(rank_k_tiles).parameters) == ["k", "n"]
    ranks = rank_k_tiles(k, n)
    assert len(ranks) == split_k(k, n) and 1 <= len(ranks) <= MAX_CLUSTER == 8
    assert ranks[0][0] == 0 and ranks[-1][1] == k // BLOCK_K
    assert all(a < b for a, b in ranks)
    assert all(ranks[i][1] == ranks[i + 1][0] for i in range(len(ranks) - 1))
    assert rank_k_tiles(k, n) == ranks


def test_fp32_x_splits_into_three_bf16_pieces_that_rebuild_it_to_2_pow_minus_24():
    rng = np.random.default_rng(11)
    x = rng.standard_normal((64, 2560)) * np.exp(rng.uniform(-20, 20, (64, 1)))
    xt = torch.from_numpy(x.astype(np.float32))
    pieces = split_bf16x3(xt)
    assert all(p.dtype == torch.bfloat16 and p.shape == xt.shape for p in pieces)
    rebuilt = sum(p.double() for p in pieces)
    assert bool(((rebuilt - xt.double()).abs() <= 2**-24 * xt.double().abs()).all())
    hi, mid, lo = (p.double().abs() for p in pieces)
    assert bool((mid <= 2**-8 * hi).all() and (lo <= 2**-8 * mid).all())


@pytest.mark.parametrize("mode", ["int8", "fp8"])
@pytest.mark.parametrize("m", [8, 64])
def test_three_piece_product_is_within_the_f32_tolerance_of_the_plain_version(mode, m):
    """The head's x (fp32) through its three bf16 pieces, each times the
    widened weight (exact in bf16), summed in fp32: what the card kernel
    computes, held to the plain version at the f32 tolerance."""
    x, wq, scale = _case(m, 2560, 256, mode, "float32", seed=m)
    xt, wqt, st = to_torch(np.asarray(x)), to_torch(np.asarray(wq)), to_torch(np.asarray(scale))
    w = wqt.float()
    acc = sum(torch.matmul(p.float(), w) for p in reversed(split_bf16x3(xt)))
    want = reference_quant_matmul(xt, wqt, st)
    torch.testing.assert_close(acc * st, want, atol=1e-5 * float(want.abs().max()), rtol=0)


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

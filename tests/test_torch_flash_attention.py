"""Port parity for flash attention (modalities_tpu_torch/ops/flash_attention.py)
against the JAX package's Pallas kernels in interpret mode, as
tests/ops/test_flash_attention.py runs them: the same numpy inputs through
`flash_fwd_out_lse`, `flash_bwd_dq` and `flash_bwd_dkv` of both packages (the
port's plain versions on the CPU), and gradients of the port's
`flash_attention` against `jax.grad` of `pallas_flash_attention`.

Tolerance: f32 1e-5 (atol and rtol): the same fp32 math, summed in other
orders. The kernels on the card are held to these plain versions by
tests/test_torch_kernels.py and chip_smoke.py."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from modalities_tpu.ops.pallas import flash_attention as jfa
from modalities_tpu_torch.ops import flash_attention as fa

TOL = dict(atol=1e-5, rtol=1e-5)
HEADS = [(4, 4), (4, 2), (4, 1)]


def _inputs(hq, hkv, seed, b=2, s=32, d=16):
    """[B, H, S, D] q, k, v, dO as numpy f32."""
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((b, h, s, d)).astype(np.float32) for h in (hq, hkv, hkv, hq)]


def _t(a):
    return torch.from_numpy(np.array(a))


@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
@pytest.mark.parametrize("hq,hkv", HEADS, ids=lambda h: str(h))
@pytest.mark.parametrize("block", [8, 16])
def test_plain_kernels_match_jax_interpret_kernels(hq, hkv, causal, block):
    q, k, v, do = _inputs(hq, hkv, seed=hq * 10 + hkv + block)
    scale = 1.0 / np.sqrt(q.shape[-1])
    kw = dict(causal=causal, sm_scale=scale, block_q=block, block_k=block, interpret=True)
    j_out, j_lse = jfa.flash_fwd_out_lse(*map(jnp.asarray, (q, k, v)), **kw)
    out, lse = fa.flash_fwd_out_lse(_t(q), _t(k), _t(v), causal=causal, sm_scale=scale)
    assert out.shape == q.shape and lse.shape == (*q.shape[:3], 1) and lse.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), np.asarray(j_out), **TOL)
    np.testing.assert_allclose(lse.numpy(), np.asarray(j_lse), **TOL)

    # the backward kernels given the same GLOBAL (lse, delta)
    delta = (do * np.asarray(j_out)).sum(-1, keepdims=True).astype(np.float32)
    j_dq = jfa.flash_bwd_dq(*map(jnp.asarray, (q, k, v, do, j_lse, delta)), **kw)
    j_dk, j_dv = jfa.flash_bwd_dkv(*map(jnp.asarray, (q, k, v, do, j_lse, delta)), **kw)
    args = (_t(q), _t(k), _t(v), _t(do), _t(j_lse), _t(delta))
    dq = fa.flash_bwd_dq(*args, causal=causal, sm_scale=scale)
    dk, dv = fa.flash_bwd_dkv(*args, causal=causal, sm_scale=scale)
    assert dk.shape == k.shape and dv.shape == v.shape  # already summed to the kv heads
    for got, want in ((dq, j_dq), (dk, j_dk), (dv, j_dv)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_statistics_may_come_without_the_trailing_singleton():
    q, k, v, do = _inputs(4, 2, seed=7)
    out, lse = fa.flash_fwd_out_lse(_t(q), _t(k), _t(v))
    delta = (_t(do) * out).sum(-1)
    args = (_t(q), _t(k), _t(v), _t(do))
    torch.testing.assert_close(fa.flash_bwd_dq(*args, lse[..., 0], delta), fa.flash_bwd_dq(*args, lse, delta[..., None]))


@pytest.mark.parametrize("hq,hkv", HEADS, ids=lambda h: str(h))
def test_flash_attention_gradients_match_jax_grad_of_the_pallas_entry(hq, hkv):
    """Model layout [B, S, H, D], a non-uniform cotangent (exercises lse and
    delta), blocks of 8 on the JAX side."""
    rng = np.random.default_rng(hq + hkv)
    q, k, v = (rng.standard_normal((1, 32, h, 16)).astype(np.float32) for h in (hq, hkv, hkv))
    w = rng.standard_normal((1, 32, hq, 16)).astype(np.float32)

    def loss(q_, k_, v_):
        return (jfa.pallas_flash_attention(q_, k_, v_, causal=True, block_q=8, block_k=8, interpret=True) * w).sum()

    j_out = jfa.pallas_flash_attention(*map(jnp.asarray, (q, k, v)), causal=True, block_q=8, block_k=8,
                                       interpret=True)
    j_grads = jax.grad(loss, argnums=(0, 1, 2))(*map(jnp.asarray, (q, k, v)))
    leaves = [_t(a).requires_grad_(True) for a in (q, k, v)]
    out = fa.flash_attention(*leaves, causal=True)
    (out * _t(w)).sum().backward()
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(j_out), **TOL)
    for got, want in zip(leaves, j_grads):
        np.testing.assert_allclose(got.grad.numpy(), np.asarray(want), **TOL)


def test_reference_attention_is_the_jax_manual_attention():
    from modalities_tpu.models.gpt2.gpt2_model import manual_attention

    rng = np.random.default_rng(3)
    q, k, v = (rng.standard_normal((2, 24, h, 16)).astype(np.float32) for h in (4, 2, 2))
    np.testing.assert_allclose(fa.reference_attention(_t(q), _t(k), _t(v), causal=True).numpy(),
                               np.asarray(manual_attention(*map(jnp.asarray, (q, k, v)))), **TOL)

"""Port parity for the fused cross entropy (modalities_tpu_torch/ops/fused_ce.py)
against the JAX package's Pallas kernels in interpret mode
(modalities_tpu/ops/pallas/fused_ce.py:fused_ce_sum_and_count), on the cases
of tests/ops/test_fused_ce.py: ragged rows and vocab (the JAX wrapper pads
them), ignored rows, all rows ignored, bf16 hidden with an fp32 head, [B, S, E]
hidden. Inputs are made with numpy and handed to both.

Both sides are differentiated through total / max(count, 1). On the CPU the
port's `fused_ce_sum_and_count` is autograd of its plain version; `FusedCEFn`
runs the kernel-level plain versions (`reference_fused_ce_forward`,
`reference_fused_ce_backward`), which the card's kernels are held to.

Tolerances: totals rtol 1e-5 (fp32 sums in another order); gradients rtol 1e-4
/ atol 1e-5; gradient dtypes as the JAX custom_vjp returns them (h's and the
head weight's). The cases at the 7B's width (E = 4096) scale the head by
1/sqrt(E), as its init does: unit-variance rows over 4096 columns would give
logits of std 64, whose softmax turns the last-bit differences of two
summation orders into gradient differences above these tolerances."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from modalities_tpu.ops.pallas.fused_ce import fused_ce_sum_and_count as jax_fused_ce
from modalities_tpu_torch.ops import fused_ce as fce

TOTAL_RTOL = 1e-5
GRAD_TOL = dict(rtol=1e-4, atol=1e-5)


def _inputs(seed, shape, vocab, embd, h_dtype="float32", w_dtype="float32", ignored=0, w_scale=1.0):
    rng = np.random.default_rng(seed)
    h = rng.standard_normal((*shape, embd)).astype(np.float32)
    w = (w_scale * rng.standard_normal((vocab, embd))).astype(np.float32)
    y = rng.integers(0, vocab, size=shape).astype(np.int32)
    y.reshape(-1)[:ignored] = -100
    h = np.array(jnp.asarray(h, dtype=h_dtype).astype(jnp.float32)) if h_dtype == "bfloat16" else h
    w = np.array(jnp.asarray(w, dtype=w_dtype).astype(jnp.float32)) if w_dtype == "bfloat16" else w
    return h, w, y, h_dtype, w_dtype


def _jax(h, w, y, h_dtype, w_dtype, block_rows, block_vocab):
    hj, wj = jnp.asarray(h, dtype=h_dtype), jnp.asarray(w, dtype=w_dtype)
    yj = jnp.asarray(y)

    def loss(hh, ww):
        total, count = jax_fused_ce(hh, ww, yj, block_rows=block_rows, block_vocab=block_vocab, interpret=True)
        return total / jnp.maximum(count, 1.0), (total, count)

    (_, (total, count)), (gh, gw) = jax.value_and_grad(loss, argnums=(0, 1), has_aux=True)(hj, wj)
    return float(total), float(count), gh, gw


def _port(h, w, y, h_dtype, w_dtype, fn):
    ht = torch.from_numpy(h).to(getattr(torch, h_dtype)).requires_grad_(True)
    wt = torch.from_numpy(w).to(getattr(torch, w_dtype)).requires_grad_(True)
    total, count = fn(ht, wt, torch.from_numpy(y))
    (total / torch.clamp(count, min=1.0)).backward()
    return float(total.detach()), float(count), ht.grad, wt.grad


def _function(ht, wt, y):
    """FusedCEFn over flattened rows: the kernel-level plain versions on the CPU."""
    return fce.FusedCEFn.apply(ht.reshape(-1, ht.shape[-1]), wt, y.reshape(-1), -100)


def _assert_same(port, jax_side, dtypes):
    total, count, gh, gw = port
    j_total, j_count, j_gh, j_gw = jax_side
    np.testing.assert_allclose(total, j_total, rtol=TOTAL_RTOL, atol=1e-6)
    assert count == j_count
    assert (str(gh.dtype)[6:], str(gw.dtype)[6:]) == (str(j_gh.dtype), str(j_gw.dtype)) == dtypes
    np.testing.assert_allclose(gh.float().numpy(), np.asarray(j_gh, dtype=np.float32), **GRAD_TOL)
    np.testing.assert_allclose(gw.float().numpy(), np.asarray(j_gw, dtype=np.float32), **GRAD_TOL)


CASES = {
    "divisible": dict(shape=(32,), vocab=256, embd=64, blocks=(16, 128)),
    "ragged-rows": dict(shape=(21,), vocab=256, embd=64, blocks=(16, 128)),
    "ragged-vocab": dict(shape=(32,), vocab=200, embd=64, blocks=(16, 128)),
    "both-ragged": dict(shape=(21,), vocab=200, embd=64, blocks=(16, 128)),
    "ignored-rows": dict(shape=(24,), vocab=128, embd=32, blocks=(8, 128), ignored=7),
    "ignored-ragged-grads": dict(shape=(21,), vocab=200, embd=48, blocks=(8, 128), ignored=1),
    "bsd-hidden": dict(shape=(2, 9), vocab=100, embd=32, blocks=(8, 128)),
    # the 7B's width (the E = 4096 kernels' on the card): ragged rows and vocab, ignored rows
    "7b-width": dict(shape=(21,), vocab=200, embd=4096, blocks=(8, 128), ignored=3, w_scale=4096 ** -0.5),
}


@pytest.mark.parametrize("route", ["autograd-of-plain", "fused-ce-fn"])
@pytest.mark.parametrize("case", list(CASES))
def test_total_count_and_gradients_match_the_pallas_kernels(case, route):
    c = CASES[case]
    h, w, y, hd, wd = _inputs(list(CASES).index(case), c["shape"], c["vocab"], c["embd"], ignored=c.get("ignored", 0),
                              w_scale=c.get("w_scale", 1.0))
    fn = fce.fused_ce_sum_and_count if route == "autograd-of-plain" else _function
    port = _port(h, w, y, hd, wd, fn)
    assert port[2].shape == h.shape and port[3].shape == w.shape
    _assert_same(port, _jax(h, w, y, hd, wd, *c["blocks"]), ("float32", "float32"))


def test_all_rows_ignored_give_zero_total_count_and_gradients():
    h, w, y, hd, wd = _inputs(2, (16,), 128, 32, ignored=16)
    for fn in (fce.fused_ce_sum_and_count, _function):
        total, count, gh, gw = _port(h, w, y, hd, wd, fn)
        assert total == 0.0 and count == 0.0
        assert not gh.any() and not gw.any()
    j_total, j_count, _, _ = _jax(h, w, y, hd, wd, 8, 128)
    assert j_total == 0.0 and j_count == 0.0


@pytest.mark.parametrize("route", ["autograd-of-plain", "fused-ce-fn"])
def test_bf16_hidden_with_an_fp32_head(route):
    """bf16 activations, fp32 statistics: the same bf16 values widened to fp32
    on both sides; dh comes back in bf16, dW in fp32."""
    h, w, y, hd, wd = _inputs(4, (32,), 256, 64, h_dtype="bfloat16")
    fn = fce.fused_ce_sum_and_count if route == "autograd-of-plain" else _function
    port = _port(h, w, y, hd, wd, fn)
    j = _jax(h, w, y, hd, wd, 16, 128)
    np.testing.assert_allclose(port[0], j[0], rtol=TOTAL_RTOL)
    assert (port[2].dtype, port[3].dtype) == (torch.bfloat16, torch.float32)
    assert (str(j[2].dtype), str(j[3].dtype)) == ("bfloat16", "float32")
    # dh is rounded to bf16 on both sides from fp32 sums in another order: at most one bf16 ulp apart
    np.testing.assert_allclose(port[2].float().numpy(), np.asarray(j[2], dtype=np.float32), rtol=2**-7, atol=1e-6)
    np.testing.assert_allclose(port[3].numpy(), np.asarray(j[3]), **GRAD_TOL)


def test_kernel_level_plain_versions_match_the_pallas_statistics():
    """lse and corr per row against the JAX forward kernel; dh and dW for a
    given per-row weight gm against its backward kernels."""
    from modalities_tpu.ops.pallas.fused_ce import _ce_backward, _ce_forward

    h, w, y, _, _ = _inputs(6, (32,), 256, 64, ignored=3)
    gm = np.where(y != -100, 1.0 / 29, 0.0).astype(np.float32)
    lse_j, corr_j = _ce_forward(jnp.asarray(h), jnp.asarray(w), jnp.asarray(y)[:, None], 16, 128, 256, True)
    lse, corr = fce.fused_ce_forward(torch.from_numpy(h), torch.from_numpy(w), torch.from_numpy(y))
    np.testing.assert_allclose(lse.numpy(), np.asarray(lse_j)[:, 0], rtol=1e-6, atol=1e-5)
    np.testing.assert_allclose(corr.numpy()[y != -100], np.asarray(corr_j)[y != -100, 0], rtol=1e-6, atol=1e-5)
    dh_j, dw_j = _ce_backward(jnp.asarray(h), jnp.asarray(w), jnp.asarray(y)[:, None], lse_j, jnp.asarray(gm)[:, None],
                              16, 128, 256, True)
    args = (torch.from_numpy(h), torch.from_numpy(w), torch.from_numpy(y), lse, torch.from_numpy(gm))
    dh, dw = fce.fused_ce_backward_dh(*args), fce.fused_ce_backward_dw(*args)
    np.testing.assert_allclose(dh.numpy(), np.asarray(dh_j), **GRAD_TOL)
    np.testing.assert_allclose(dw.numpy(), np.asarray(dw_j), **GRAD_TOL)
    assert not dh.numpy()[y == -100].any()


def test_kernel_level_plain_versions_match_the_pallas_statistics_at_the_7b_width():
    """As above at E = 4096 (the 7B's), with 21 rows, a ragged vocab of 200
    and the head scaled as its init: lse, corr, dh and dW of the plain
    versions the card's E = 4096 kernels are held to, against the Pallas
    kernels (given rows and vocab padded to their blocks, as the JAX wrapper
    pads them: ignored rows, zero vocab rows masked by `vocab`)."""
    from modalities_tpu.ops.pallas.fused_ce import _ce_backward, _ce_forward

    n, v = 21, 200
    h, w, y, _, _ = _inputs(8, (n,), v, 4096, ignored=3, w_scale=4096 ** -0.5)
    gm = np.where(y != -100, 1.0 / 18, 0.0).astype(np.float32)
    hp, wp = np.pad(h, ((0, 3), (0, 0))), np.pad(w, ((0, 56), (0, 0)))  # rows to 24 (blocks of 8), vocab to 256
    yp, gmp = np.pad(y, (0, 3), constant_values=-100), np.pad(gm, (0, 3))
    lse_j, corr_j = _ce_forward(jnp.asarray(hp), jnp.asarray(wp), jnp.asarray(yp)[:, None], 8, 128, v, True)
    lse, corr = fce.fused_ce_forward(torch.from_numpy(h), torch.from_numpy(w), torch.from_numpy(y))
    np.testing.assert_allclose(lse.numpy(), np.asarray(lse_j)[:n, 0], rtol=1e-6, atol=1e-5)
    np.testing.assert_allclose(corr.numpy()[y != -100], np.asarray(corr_j)[:n][y != -100, 0], rtol=1e-6, atol=1e-5)
    dh_j, dw_j = _ce_backward(jnp.asarray(hp), jnp.asarray(wp), jnp.asarray(yp)[:, None], lse_j,
                              jnp.asarray(gmp)[:, None], 8, 128, v, True)
    args = (torch.from_numpy(h), torch.from_numpy(w), torch.from_numpy(y), lse, torch.from_numpy(gm))
    dh, dw = fce.fused_ce_backward_dh(*args), fce.fused_ce_backward_dw(*args)
    np.testing.assert_allclose(dh.numpy(), np.asarray(dh_j)[:n], **GRAD_TOL)
    np.testing.assert_allclose(dw.numpy(), np.asarray(dw_j)[:v], **GRAD_TOL)
    assert not dh.numpy()[y == -100].any()


def test_the_card_path_takes_the_7b_width_and_refuses_other_bf16_widths():
    """BF16_WIDTHS holds the 7B's 4096 beside 1536; the card path's width
    check (before it asks for a card) refuses any other bf16 width, while
    4096 passes it and reaches the card check (no card here)."""
    assert 4096 in fce.BF16_WIDTHS and 1536 in fce.BF16_WIDTHS
    for e in fce.BF16_WIDTHS:
        fce.check_bf16_width(e)
    labels = torch.zeros(4, dtype=torch.long)
    for e in (64, 96, 1024, 2048, 2560, 8192):
        with pytest.raises(ValueError, match=f"E={e} is not a width"):
            fce.check_bf16_width(e)
        with pytest.raises(ValueError, match=f"E={e} is not a width"):
            fce._kernel_inputs(torch.zeros(4, e, dtype=torch.bfloat16), torch.zeros(8, e, dtype=torch.bfloat16),
                               labels)
    with pytest.raises(Exception) as refused:  # past the width check: the card check, which fails here
        fce._kernel_inputs(torch.zeros(4, 4096, dtype=torch.bfloat16), torch.zeros(8, 4096, dtype=torch.bfloat16),
                           labels)
    assert "not a width" not in str(refused.value)


def test_cpu_tensors_take_the_plain_versions_and_never_count_a_launch():
    h, w = torch.randn(10, 32), torch.randn(40, 32)
    y = torch.randint(0, 40, (10,))
    before = (fce.fused_ce_forward.launches, fce.fused_ce_backward_dh.launches, fce.fused_ce_backward_dw.launches)
    lse, corr = fce.fused_ce_forward(h, w, y)
    fce.fused_ce_backward_dh(h, w, y, lse, torch.full((10,), 0.1))
    fce.fused_ce_backward_dw(h, w, y, lse, torch.full((10,), 0.1))
    fce.fused_ce_sum_and_count(h, w, y)
    assert (fce.fused_ce_forward.launches, fce.fused_ce_backward_dh.launches,
            fce.fused_ce_backward_dw.launches) == before
    with pytest.raises(ValueError, match="labels"):
        fce.fused_ce_sum_and_count(h, w, y[:9])

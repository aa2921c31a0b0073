"""The port's kernel wrappers (ops/rmsnorm.py, ops/quant_matmul.py,
ops/flash_attention.py, ops/fused_ce.py) without JAX: how they dispatch, and — on a card — each
kernel against its plain PyTorch version. This file imports no JAX, so the
`cuda`-marked tests run on a machine with a card and no JAX:

    python -m pytest --noconftest -m cuda tests/test_torch_kernels.py

Tolerances on the card: RMSNorm f32 1e-5 (warp-tree vs torch sum order), bf16
two bf16 ulps (rtol 2^-6); dequant-matmul f32 x 1e-5 * max|ref| (sums of 2560
products in another order), bf16 x the same plus two bf16 ulps. RMSNorm
backward: f32 1e-5 relative to the largest gradient; bf16 dx two bf16 ulps.
Flash attention: each output row (one query's out or dq, one key's dk or dv)
against its own norm, ||got - want|| <= rel * ||want|| + 1e-5 * sqrt(D): f32
rel 1e-4 (sums in another order); bf16 rel 1e-2, since the kernels round P and
dS to bf16 before their tensor-core products and round each output to bf16,
while the plain version stays fp32. Autograd's dq and dk of the fp32 plain
attention are first moved to the delta the kernels read (sum dO * out of the
kernel's own out, bf16 in bf16): they are linear in it. lse 1e-4 absolute.
Fused CE: lse and corr 1e-4 absolute (fp32 sums of E products in another
order), total rtol 1e-5, dh and dW of the total row by row against autograd of
the fp32 plain version: f32 1e-4, bf16 CE_ROW_REL_BF16 (ds reaches the tensor
cores as bf16 hi + lo; each output is rounded to bf16)."""

import pytest
import torch

from modalities_tpu_torch.device import resolve_device
from modalities_tpu_torch.ops import flash_attention as fa
from modalities_tpu_torch.ops import fused_ce as fce
from modalities_tpu_torch.ops.quant_matmul import (
    BLOCK_K,
    PreparedWeight,
    quant_matmul,
    reference_quant_matmul,
    split_k,
)
from modalities_tpu_torch.ops.rmsnorm import (
    fused_rms_norm,
    reference_rms_norm,
    rms_norm,
    rms_norm_backward,
)
from modalities_tpu_torch.quant.core import quantize_fp8, quantize_per_channel

EPS = 1e-5


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def test_cpu_tensor_takes_the_plain_rms_norm_and_never_counts_a_launch():
    x = torch.randn(4, 3, 64)
    before = rms_norm.launches
    got = rms_norm(x, torch.ones(64), None, eps=EPS)
    assert rms_norm.launches == before
    assert torch.equal(got, reference_rms_norm(x, torch.ones(64), None, eps=EPS))


def test_cpu_tensors_take_the_plain_quant_matmul():
    x = torch.randn(3, 64)
    wq = torch.randint(-127, 128, (64, 32), dtype=torch.int8)
    scale = torch.rand(32)
    before = quant_matmul.launches
    assert torch.equal(quant_matmul(x, wq, scale), reference_quant_matmul(x, wq, scale))
    assert quant_matmul.launches == before
    with pytest.raises(ValueError, match="contraction"):
        quant_matmul(x, wq[:32], scale)


def test_cuda_default_raises_without_a_cuda_device(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve_device("cuda")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve_device(None)  # the default is the card, never a silent CPU
    assert resolve_device("cpu") == torch.device("cpu")


def test_split_k_depends_on_the_weight_only_and_leaves_no_split_empty():
    for k, n in [(2560, 2560), (2560, 640), (2560, 7680), (7680, 2560), (2560, 50304), (128, 64), (64, 16)]:
        s = split_k(k, n)
        ktiles = k // BLOCK_K
        per = -(-ktiles // s)
        assert 1 <= s <= ktiles and (s - 1) * per < ktiles <= s * per


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_rms_norm_kernel_matches_the_plain_version_on_the_card(dtype):
    dev = _card()
    g = torch.Generator(device=dev).manual_seed(0)
    tol = dict(atol=1e-5, rtol=1e-5) if dtype == torch.float32 else dict(atol=1e-6, rtol=2**-6)
    # every row count the serving path gives it; then both kernels at every width class: a warp a row (E <= 1024,
    # or more than 528 rows of up to 8 KB) at 1 to 16 vectors a lane, and a CTA a row (at most 528 rows, or rows
    # over 8 KB), around the switch; the 32k config's training shape
    for n, e in ((1, 2560), (4, 2560), (8, 2560), (16, 2560), (64, 2560), (3, 128), (3, 8), (1000, 128),
                 (528, 1536), (529, 1536), (1057, 2560), (7, 2048), (600, 2048), (5, 4096), (600, 4096), (2, 8192),
                 (3, 8200), (2, 16384), (32768, 1536)):
        x = torch.randn(n, e, generator=g, device=dev).to(dtype)
        s, b = torch.randn(e, generator=g, device=dev), torch.randn(e, generator=g, device=dev)
        before = rms_norm.launches
        got, r = rms_norm(x, s, b, eps=EPS, residual=True)
        torch.cuda.synchronize()
        assert rms_norm.launches == before + 1 and r.shape == (n, 1)
        torch.testing.assert_close(got.float(), reference_rms_norm(x, s, b, eps=EPS).float(), **tol)
        torch.testing.assert_close(r, torch.rsqrt((x.float() ** 2).mean(-1, keepdim=True) + EPS), atol=0, rtol=1e-5)
    # scale and bias one float off 16-byte alignment (the kernel reads them as 16-byte vectors)
    x = torch.randn(5000, 2560, generator=g, device=dev).to(dtype)
    s, b = (torch.randn(2561, generator=g, device=dev)[1:] for _ in range(2))
    torch.testing.assert_close(rms_norm(x, s, b, eps=EPS).float(), reference_rms_norm(x, s, b, eps=EPS).float(), **tol)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_rms_norm_kernel_refuses_rows_it_cannot_load_in_16_byte_vectors(dtype):
    dev = _card()
    x = torch.randn(4 * 128 + 1, device=dev).to(dtype)[1:].view(4, 128)  # one element off alignment
    with pytest.raises(ValueError, match="16-byte"):
        rms_norm(x, None, None, eps=EPS)
    with pytest.raises(ValueError, match="16-byte"):
        rms_norm(torch.randn(4, 100, device=dev).to(torch.bfloat16), None, None, eps=EPS)  # 200-byte rows


# (K, N) of the serving path's dequant-matmuls (q and c_proj, k and v, W and V, W_2, the untied head), then
# small and ragged weights (one k tile; a tile narrower than the 128 columns of a cluster's tile)
QMM_CARD_SHAPES = [(2560, 2560), (2560, 640), (2560, 7680), (7680, 2560), (2560, 50304), (128, 64), (64, 16),
                   (192, 48)]


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["int8", "fp8"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_quant_matmul_kernel_matches_the_plain_version_on_the_card(mode, dtype):
    """Every serving shape at every row count of the decode step and the
    prefill ladder (and more rows than a CTA's 64); the rows of x[64, K]
    computed 1, 8 and 64 at a time equal each other bitwise, and two calls
    give the same bits."""
    dev = _card()
    g = torch.Generator(device=dev).manual_seed(0)
    for k, n in QMM_CARD_SHAPES:
        w = torch.randn(n, k, generator=g, device=dev) * 0.02  # [out, in]
        wq, scale = quantize_per_channel(w) if mode == "int8" else quantize_fp8(w)
        wq, scale = wq.t().contiguous(), scale[:, 0].contiguous()
        prepared = PreparedWeight(wq, scale)
        for m in (1, 4, 8, 16, 64, 100):
            x = torch.randn(m, k, generator=g, device=dev).to(dtype)
            before = quant_matmul.launches
            got = quant_matmul(x, wq, scale, prepared)
            torch.cuda.synchronize()
            assert quant_matmul.launches == before + 1
            want = reference_quant_matmul(x, wq, scale)
            atol = 1e-5 * float(want.float().abs().max())
            rtol = 0.0 if dtype == torch.float32 else 2**-6
            torch.testing.assert_close(got.float(), want.float(), atol=atol, rtol=rtol)
        x = torch.randn(64, k, generator=g, device=dev).to(dtype)
        y = quant_matmul(x, wq, scale, prepared)
        assert torch.equal(y, quant_matmul(x, wq, scale, prepared)), (k, n)
        for rows in (1, 8):
            for i0 in range(0, 64, rows):
                assert torch.equal(quant_matmul(x[i0:i0 + rows].clone(), wq, scale, prepared), y[i0:i0 + rows]), (
                    k, n, rows, i0)


@pytest.mark.cuda
def test_quant_matmul_refuses_a_bad_weight_once_when_it_is_prepared():
    """The weight's checks run when it is prepared; a call then checks x only,
    and refuses a weight the preparation was not made for."""
    dev = _card()
    wq = torch.randint(-127, 128, (256, 64), dtype=torch.int8, device=dev)
    scale = torch.rand(64, device=dev)
    misaligned = torch.empty(256 * 64 + 1, dtype=torch.int8, device=dev)[1:].view(256, 64)
    for bad_wq, bad_scale, exc, match in [
        (wq.to(torch.float16), scale, TypeError, "int8 or float8"),
        (wq, scale.double(), TypeError, "float32"),
        (wq[:, :40].contiguous(), scale[:40], ValueError, "N % 16"),
        (wq[:200].contiguous(), scale, ValueError, "K % 64"),
        (wq.t().contiguous().t(), scale, ValueError, "contiguous"),
        (misaligned, scale, ValueError, "16-byte"),
        (wq, scale[:32], ValueError, "scale shape"),
        (wq.cpu(), scale.cpu(), RuntimeError, "CUDA device"),
    ]:
        with pytest.raises(exc, match=match):
            PreparedWeight(bad_wq, bad_scale)
    prepared = PreparedWeight(wq, scale)
    x = torch.randn(4, 256, device=dev).to(torch.bfloat16)
    before = quant_matmul.launches
    quant_matmul(x, wq, scale, prepared)
    assert quant_matmul.launches == before + 1
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        quant_matmul(x.half(), wq, scale, prepared)
    with pytest.raises(ValueError, match="contiguous"):
        quant_matmul(torch.randn(256, 4, device=dev).to(torch.bfloat16).t(), wq, scale, prepared)
    with pytest.raises(ValueError, match="contraction"):
        quant_matmul(torch.randn(4, 128, device=dev).to(torch.bfloat16), wq, scale, prepared)
    with pytest.raises(ValueError, match="another weight"):
        quant_matmul(x, wq.clone(), scale, prepared)
    assert quant_matmul.launches == before + 1


@pytest.mark.cuda
def test_quant_linear_prepares_its_weight_once_and_again_when_the_tensor_changes():
    from modalities_tpu_torch.models.gpt2.gpt2_model import QuantLinear

    dev = _card()
    layer = QuantLinear(256, 64, False, torch.int8, device=dev)
    layer.kernel.copy_(torch.randint(-127, 128, (256, 64), dtype=torch.int8, device=dev))
    x = torch.randn(3, 5, 256, device=dev).to(torch.bfloat16)
    y = layer(x)
    prepared = layer._prepared
    assert y.shape == (3, 5, 64) and prepared is not None and prepared.holds(layer.kernel, layer.scale)
    torch.testing.assert_close(layer(x), y, atol=0, rtol=0)
    assert layer._prepared is prepared
    layer.kernel = layer.kernel.clone()  # a new tensor: prepared anew
    layer(x)
    assert layer._prepared is not prepared


def test_cpu_tensors_take_the_plain_flash_attention_and_rms_norm_backward():
    g = torch.Generator().manual_seed(0)
    q, k, v = (torch.randn(1, 16, h, 16, generator=g) for h in (4, 2, 2))
    counts = (fa.flash_fwd_out_lse.launches, fa.flash_bwd_dq.launches, fa.flash_bwd_dkv.launches,
              rms_norm_backward.launches)
    assert torch.equal(fa.flash_attention(q, k, v), fa.reference_attention(q, k, v))
    out, lse = fa.flash_fwd_out_lse(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2))
    assert out.shape == (1, 4, 16, 16) and lse.shape == (1, 4, 16, 1) and lse.dtype == torch.float32
    x = torch.randn(3, 64, generator=g, requires_grad=True)
    fused_rms_norm(x, torch.ones(64), None, eps=EPS).sum().backward()
    assert x.grad is not None
    assert counts == (fa.flash_fwd_out_lse.launches, fa.flash_bwd_dq.launches, fa.flash_bwd_dkv.launches,
                      rms_norm_backward.launches)


def _rel_close(got, want, rel, what, atol=1e-5):
    """|got - want| <= rel * max|want| + atol; the atol covers gradients that
    are exactly 0 in exact arithmetic (one key: p = 1, dp = delta)."""
    got, want = got.detach().float(), want.detach().float()
    err = float((got - want).abs().max())
    scale = float(want.abs().max())
    assert torch.isfinite(got).all() and err <= rel * scale + atol, f"{what}: max err {err:g} vs max {scale:g}"


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_rms_norm_backward_kernel_matches_autograd_of_the_plain_version(dtype):
    dev = _card()
    g = torch.Generator(device=dev).manual_seed(0)
    # fewer rows than the kernel's CTAs (100), CTAs of 2 rows and of 1 (1000), E from 128 to 4096
    for n, e in ((1, 2560), (64, 2560), (1000, 2560), (8192, 2560), (5, 128), (32768, 1536), (100, 128),
                 (1000, 128), (100, 1536), (1000, 1536), (100, 2560), (100, 4096), (1000, 4096), (100, 2048),
                 (1000, 2048)):
        x = torch.randn(n, e, generator=g, device=dev).to(dtype)
        dy = torch.randn(n, e, generator=g, device=dev).to(dtype)
        _, r = rms_norm(x, None, None, eps=EPS, residual=True)
        s32 = torch.randn(e, generator=g, device=dev)
        first, second = (rms_norm_backward(dy, x, s32, r) for _ in range(2))
        assert all(torch.equal(a, c) for a, c in zip(first, second)), f"N={n} E={e}: two calls differ"
        for scale_dtype in (None, torch.float32, torch.bfloat16):
            s = None if scale_dtype is None else torch.randn(e, generator=g, device=dev).to(scale_dtype)
            b = None if scale_dtype is None else torch.randn(e, generator=g, device=dev).to(scale_dtype)
            leaves = [t.clone().requires_grad_(True) if t is not None else None for t in (x, s, b)]
            fused_rms_norm(*leaves, eps=EPS).backward(dy)
            plain = [t.clone().requires_grad_(True) if t is not None else None for t in (x, s, b)]
            reference_rms_norm(*plain, eps=EPS).backward(dy)
            torch.cuda.synchronize()
            rel = 1e-5 if dtype == torch.float32 else 2**-6
            for got, want, name in zip(leaves, plain, ("dx", "dscale", "dbias")):
                if got is not None:
                    assert got.grad.dtype == got.dtype
                    _rel_close(got.grad, want.grad, rel if name == "dx" else max(rel, 1e-5 if scale_dtype ==
                               torch.float32 else 2**-7), f"{name} N={n} {dtype} scale {scale_dtype}")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("affine", [False, True], ids=["identity", "scale"])
def test_rms_norm_forward_kernel_is_batch_invariant(dtype, affine):
    """A row's output and r are bitwise the same normalised alone, among 8
    rows, among 64 or among 2048 (the last call on the warp-a-row kernel, the
    others on the team kernel): the serve engine's batch invariance rests on
    it."""
    dev = _card()
    g = torch.Generator(device=dev).manual_seed(0)
    x = torch.randn(2048, 2560, generator=g, device=dev).to(dtype)
    s = torch.randn(2560, generator=g, device=dev) if affine else None
    y, r = rms_norm(x, s, None, eps=EPS, residual=True)
    for n in (1, 8, 64):
        for i0 in range(0, 64, n):
            yi, ri = rms_norm(x[i0:i0 + n].clone(), s, None, eps=EPS, residual=True)
            assert torch.equal(yi, y[i0:i0 + n]) and torch.equal(ri, r[i0:i0 + n]), f"rows {i0}..{i0 + n}"


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,e", [(torch.bfloat16, 8200), (torch.float32, 4100)], ids=["bf16", "f32"])
def test_rms_norm_backward_kernel_refuses_widths_beyond_its_limit(dtype, e):
    dev = _card()
    x = torch.randn(4, e, device=dev).to(dtype)
    _, r = rms_norm(x, None, None, eps=EPS, residual=True)
    with pytest.raises(ValueError, match="at most"):
        rms_norm_backward(x, x, None, r)


FLASH_ROW_REL = {torch.float32: 1e-4, torch.bfloat16: 1e-2}


def _rows_close(got, want, rel, what):
    """Every row (last axis) within rel of its own norm, floored at 1e-3 x the
    RMS row norm, plus 1e-5 * sqrt(D) for rows that are 0 in exact arithmetic."""
    got, want = got.detach().float(), want.detach().float()
    err, size = (got - want).norm(dim=-1), want.norm(dim=-1)
    size = size.clamp_min(1e-3 * float(size.square().mean().sqrt()))
    allowed = rel * size + 1e-5 * want.shape[-1] ** 0.5
    assert torch.isfinite(got).all() and bool((err <= allowed).all()), (
        f"{what}: {int((err > allowed).sum())} rows outside rel {rel:g}, worst {float((err / size).max()):g}")


def _with_kernel_delta(q, k, do, out_ref, out_kernel, dq, dk, causal):
    """Autograd's dq, dk of the fp32 plain attention ([B, H, S, D]) at the
    delta the kernels read: with e = sum_D dO * (out_kernel - out_ref),
    dq_i - scale e_i sum_j P_ij k_j and dk_j - scale sum_i P_ij e_i q_i."""
    group, scale = q.shape[1] // k.shape[1], q.shape[-1] ** -0.5
    kx = k.float().repeat_interleave(group, 1)
    s = torch.matmul(q.float() * scale, kx.transpose(-1, -2))
    if causal:
        n = s.shape[-1]
        s = s.masked_fill(torch.ones(n, n, dtype=torch.bool, device=s.device).triu(1), float("-inf"))
    p = torch.softmax(s, dim=-1)
    e = (do.float() * (out_kernel.float() - out_ref.float())).sum(-1, keepdim=True)
    per_head = torch.matmul(p.transpose(-1, -2), e * q.float())
    b, hq, sk, d = per_head.shape
    return (dq.float() - scale * e * torch.matmul(p, kx),
            dk.float() - scale * per_head.reshape(b, hq // group, group, sk, d).sum(2))


def _qkv(dev, b, s, hq, hkv, d, dtype, seed=0):
    g = torch.Generator(device=dev).manual_seed(seed)
    return [torch.randn(b, s, h, d, generator=g, device=dev).to(dtype) for h in (hq, hkv, hkv)]


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(2, 512, 8, 2, 80), (1, 1000, 8, 2, 64), (2, 256, 4, 4, 128), (1, 1, 4, 1, 80),
                                   (1, 77, 4, 1, 16), (1, 130, 2, 2, 32), (1, 384, 6, 2, 128),
                                   (1, 2048, 12, 4, 128), (1, 1000, 3, 3, 80), (1, 4097, 8, 2, 80),
                                   (1, 1000, 6, 2, 128), (1, 4097, 12, 4, 128)], ids=str)
@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_flash_attention_kernels_match_autograd_of_the_plain_attention(shape, causal, dtype):
    dev = _card()
    b, s, hq, hkv, d = shape
    q, k, v = _qkv(dev, b, s, hq, hkv, d, dtype)
    w = torch.randn(b, s, hq, d, device=dev).to(dtype)
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    counts = (fa.flash_fwd_out_lse.launches, fa.flash_bwd_dq.launches, fa.flash_bwd_dkv.launches)
    out = fa.FlashAttentionFn.apply(*leaves, causal, 1.0 / d**0.5)
    out.backward(w)
    torch.cuda.synchronize()
    assert (fa.flash_fwd_out_lse.launches, fa.flash_bwd_dq.launches, fa.flash_bwd_dkv.launches) == tuple(
        c + 1 for c in counts)
    plain = [t.float().clone().requires_grad_(True) for t in (q, k, v)]
    ref = fa.reference_attention(*plain, causal=causal)
    ref.backward(w.float())
    rel = FLASH_ROW_REL[dtype]
    _rows_close(out, ref, rel, "out")
    bhsd = [t.detach().transpose(1, 2) for t in (q, k, w, ref, out, plain[0].grad, plain[1].grad)]
    want_dq, want_dk = _with_kernel_delta(*bhsd, causal)
    for got, want, name in zip(leaves, (want_dq, want_dk, plain[2].grad.transpose(1, 2)), "qkv"):
        assert got.grad.dtype == dtype and got.grad.shape == got.shape
        _rows_close(got.grad.transpose(1, 2), want, rel, f"d{name}")
    # the bhsd entries with an explicit global (lse, delta), and bitwise repeatability
    qt, kt, vt, wt = (t.transpose(1, 2) for t in (q, k, v, w))
    o1, lse = fa.flash_fwd_out_lse(qt, kt, vt, causal=causal)
    o_ref, lse_ref = fa.reference_flash_fwd_out_lse(qt, kt, vt, causal=causal)
    _rows_close(o1, o_ref, rel, "flash_fwd_out_lse out")
    assert float((lse - lse_ref).abs().max()) <= 1e-4
    delta = (wt.float() * o1.float()).sum(-1, keepdim=True)
    dq1 = fa.flash_bwd_dq(qt, kt, vt, wt, lse, delta, causal=causal)
    dk1, dv1 = fa.flash_bwd_dkv(qt, kt, vt, wt, lse, delta, causal=causal)
    dq2 = fa.flash_bwd_dq(qt, kt, vt, wt, lse, delta, causal=causal)
    dk2, dv2 = fa.flash_bwd_dkv(qt, kt, vt, wt, lse, delta, causal=causal)
    assert torch.equal(dq1, dq2) and torch.equal(dk1, dk2) and torch.equal(dv1, dv2)
    _rows_close(dq1, fa.reference_flash_bwd_dq(qt, kt, vt, wt, lse, delta, causal=causal), rel, "flash_bwd_dq")
    for got, want, name in zip((dk1, dv1), fa.reference_flash_bwd_dkv(qt, kt, vt, wt, lse, delta, causal=causal),
                               ("dk", "dv")):
        _rows_close(got, want, rel, f"flash_bwd_dkv {name}")


@pytest.mark.cuda
@pytest.mark.parametrize("d", [16, 32, 64, 80, 96, 128])
@pytest.mark.parametrize("group", [1, 3, 4])
@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
def test_flash_fwd_kernel_over_ragged_lengths(d, group, causal):
    """The wgmma forward (128 query rows a CTA, 128-key tiles through a TMA
    ring) at lengths around its tiles, and with Sq != Sk: out row by row and
    lse against the plain version, two calls bitwise equal."""
    dev = _card()
    lengths = [(s, s) for s in (1, 63, 64, 65, 127, 128, 129, 200, 255, 256, 257, 1000)] + [(100, 300), (300, 100)]
    for sq, sk in lengths:
        q = _qkv(dev, 2, sq, 2 * group, 2, d, torch.bfloat16, seed=sq)[0].transpose(1, 2)
        k, v = (t.transpose(1, 2) for t in _qkv(dev, 2, sk, 2 * group, 2, d, torch.bfloat16, seed=sk + 1)[1:])
        o, lse = fa.flash_fwd_out_lse(q, k, v, causal=causal)
        o2, lse2 = fa.flash_fwd_out_lse(q, k, v, causal=causal)
        assert torch.equal(o, o2) and torch.equal(lse, lse2)
        o_ref, lse_ref = fa.reference_flash_fwd_out_lse(q.float(), k.float(), v.float(), causal=causal)
        _rows_close(o, o_ref, FLASH_ROW_REL[torch.bfloat16], f"out Sq={sq} Sk={sk}")
        assert float((lse - lse_ref).abs().max()) <= 1e-4, f"lse Sq={sq} Sk={sk}"


@pytest.mark.cuda
@pytest.mark.parametrize("d", [16, 32, 64, 80, 96, 128])
@pytest.mark.parametrize("group", [1, 3, 4])
@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
def test_flash_dq_kernel_over_ragged_lengths(d, group, causal):
    """The wgmma dq kernel (128 query rows a CTA, 64-key tiles through a TMA
    ring) at lengths around its tiles, and with Sq != Sk: dq row by row
    against the plain version given the same (lse, delta), two calls bitwise
    equal."""
    dev = _card()
    lengths = [(s, s) for s in (1, 63, 64, 65, 127, 128, 129, 200, 255, 256, 257, 1000)] + [(100, 300), (300, 100)]
    for sq, sk in lengths:
        q = _qkv(dev, 2, sq, 2 * group, 2, d, torch.bfloat16, seed=sq)[0].transpose(1, 2)
        k, v = (t.transpose(1, 2) for t in _qkv(dev, 2, sk, 2 * group, 2, d, torch.bfloat16, seed=sk + 1)[1:])
        w = torch.randn(q.shape, device=dev).to(torch.bfloat16)
        o, lse = fa.flash_fwd_out_lse(q, k, v, causal=causal)
        delta = (w.float() * o.float()).sum(-1, keepdim=True)
        dq = fa.flash_bwd_dq(q, k, v, w, lse, delta, causal=causal)
        assert torch.equal(dq, fa.flash_bwd_dq(q, k, v, w, lse, delta, causal=causal))
        want = fa.reference_flash_bwd_dq(q.float(), k.float(), v.float(), w.float(), lse, delta, causal=causal)
        _rows_close(dq, want, FLASH_ROW_REL[torch.bfloat16], f"dq Sq={sq} Sk={sk}")


@pytest.mark.cuda
@pytest.mark.parametrize("d", [80, 96, 128])
@pytest.mark.parametrize("group", [1, 3, 4])
@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
def test_flash_dkv_kernel_over_ragged_lengths(d, group, causal):
    """The wgmma dk/dv kernel (128 key rows a CTA, 64-query tiles through a
    ring) at lengths around its tiles: each kv head's dk/dv row by row
    against the plain version given the same (lse, delta), and two calls
    bitwise equal."""
    dev = _card()
    for s in (1, 63, 64, 65, 127, 128, 129, 200, 1000):
        q, k, v = (t.transpose(1, 2) for t in _qkv(dev, 2, s, 2 * group, 2, d, torch.bfloat16, seed=s))
        w = torch.randn(q.shape, device=dev).to(torch.bfloat16)
        o, lse = fa.flash_fwd_out_lse(q, k, v, causal=causal)
        delta = (w.float() * o.float()).sum(-1, keepdim=True)
        dk, dv = fa.flash_bwd_dkv(q, k, v, w, lse, delta, causal=causal)
        dk2, dv2 = fa.flash_bwd_dkv(q, k, v, w, lse, delta, causal=causal)
        assert torch.equal(dk, dk2) and torch.equal(dv, dv2)
        want = fa.reference_flash_bwd_dkv(q.float(), k.float(), v.float(), w.float(), lse, delta, causal=causal)
        for got, ref, name in zip((dk, dv), want, ("dk", "dv")):
            _rows_close(got, ref, FLASH_ROW_REL[torch.bfloat16], f"{name} S={s}")


@pytest.mark.cuda
def test_flash_attention_kernels_at_the_32k_config_shape_head_by_head():
    """q [1, 12, 32768, 128], k/v [1, 4, 32768, 128] bf16, causal: the three
    kernels on the whole shape, each q head's out, lse and dq and each kv
    head's dk/dv (against the fp32 sum of its 3 q heads' plain dk/dv) held
    one head at a time, so that the plain fp32 scores (4.3 GB) fit."""
    dev = _card()
    b, s, hq, hkv, d = 1, 32768, 12, 4, 128
    q, k, v = (t.transpose(1, 2) for t in _qkv(dev, b, s, hq, hkv, d, torch.bfloat16))
    w = torch.randn(b, hq, s, d, device=dev).to(torch.bfloat16)
    o, lse = fa.flash_fwd_out_lse(q, k, v, causal=True)
    delta = (w.float() * o.float()).sum(-1, keepdim=True)
    dq = fa.flash_bwd_dq(q, k, v, w, lse, delta, causal=True)
    dk, dv = fa.flash_bwd_dkv(q, k, v, w, lse, delta, causal=True)
    rel, group = FLASH_ROW_REL[torch.bfloat16], hq // hkv
    for hk in range(hkv):
        ks, vs = k[:, hk:hk + 1], v[:, hk:hk + 1]
        want_dk = want_dv = 0.0
        for h in range(hk * group, (hk + 1) * group):
            qs, ws, lse_h, delta_h = q[:, h:h + 1], w[:, h:h + 1], lse[:, h:h + 1], delta[:, h:h + 1]
            o_ref, lse_ref = fa.reference_flash_fwd_out_lse(qs, ks, vs, causal=True)
            _rows_close(o[:, h:h + 1], o_ref, rel, f"out head {h}")
            assert float((lse_h - lse_ref).abs().max()) <= 1e-4
            del o_ref, lse_ref
            _rows_close(dq[:, h:h + 1], fa.reference_flash_bwd_dq(qs, ks, vs, ws, lse_h, delta_h, causal=True), rel,
                        f"dq head {h}")
            dk_h, dv_h = fa.reference_flash_bwd_dkv(qs.float(), ks.float(), vs.float(), ws.float(), lse_h, delta_h,
                                                    causal=True)
            want_dk, want_dv = want_dk + dk_h, want_dv + dv_h
            del dk_h, dv_h
        _rows_close(dk[:, hk:hk + 1], want_dk, rel, f"dk kv head {hk}")
        _rows_close(dv[:, hk:hk + 1], want_dv, rel, f"dv kv head {hk}")


@pytest.mark.cuda
def test_flash_attention_refuses_head_dims_it_was_not_built_for():
    dev = _card()
    q, k, v = _qkv(dev, 1, 8, 2, 2, 96, torch.bfloat16)
    with pytest.raises(ValueError, match="head dim"):
        fa.flash_attention(q, k, v)


def test_cpu_tensors_take_the_plain_fused_ce():
    g = torch.Generator().manual_seed(0)
    h, w = torch.randn(10, 32, generator=g), torch.randn(40, 32, generator=g)
    y = torch.randint(0, 40, (10,), generator=g)
    counts = (fce.fused_ce_forward.launches, fce.fused_ce_backward_dh.launches, fce.fused_ce_backward_dw.launches)
    lse, corr = fce.fused_ce_forward(h, w, y)
    assert torch.equal(lse, torch.logsumexp(h @ w.t(), -1))
    gm = torch.full((10,), 0.1)
    dh, dw = fce.fused_ce_backward_dh(h, w, y, lse, gm), fce.fused_ce_backward_dw(h, w, y, lse, gm)
    assert (dh.shape, dw.shape) == (h.shape, w.shape)
    assert counts == (fce.fused_ce_forward.launches, fce.fused_ce_backward_dh.launches,
                      fce.fused_ce_backward_dw.launches)


# (N, V, E, ignored rows): ragged rows and vocab, ignored rows, all rows ignored, the 32k config's width,
# vocab not a multiple of the dW kernel's 128 rows, tokens not a multiple of its 64-token tiles
FUSED_CE_CASES = [(100, 300, 128, 7), (37, 129, 256, 0), (16, 128, 128, 16), (45, 1000, 1536, 3),
                  (1000, 777, 128, 50), (4097, 1000, 256, 100), (300, 1000, 1536, 5), (64, 130, 1536, 0),
                  (45, 1000, 4096, 3), (300, 1000, 4096, 5), (129, 63, 4096, 7)]
# dh and dW of the bf16 kernels against the fp32 plain version, per row: ds reaches the tensor cores as
# bf16 hi + lo (about 16 bits), so what is left is mostly each output's own rounding to bf16
CE_ROW_REL_BF16 = 2.5e-3


@pytest.mark.cuda
@pytest.mark.parametrize("case", FUSED_CE_CASES, ids=str)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_fused_ce_kernels_match_autograd_of_the_plain_version(case, dtype):
    """lse and corr 1e-4 absolute; total rtol 1e-5; dh and dW of the total
    (rows of O(1), above the row check's absolute floor) row by row: f32 1e-4
    (sums in another order), bf16 CE_ROW_REL_BF16; each backward kernel
    twice, bitwise."""
    dev = _card()
    n, v, e, ignored = case
    g = torch.Generator(device=dev).manual_seed(1)
    h = torch.randn(n, e, generator=g, device=dev).to(dtype)
    w = (0.02 * torch.randn(v, e, generator=g, device=dev)).to(dtype)
    y = torch.randint(0, v, (n,), generator=g, device=dev)
    y[torch.randperm(n, generator=g, device=dev)[:ignored]] = -100
    counts = (fce.fused_ce_forward.launches, fce.fused_ce_backward_dh.launches, fce.fused_ce_backward_dw.launches)
    leaves = [h.clone().requires_grad_(True), w.clone().requires_grad_(True)]
    total, count = fce.fused_ce_sum_and_count(*leaves, y)
    total.backward()
    torch.cuda.synchronize()
    assert (fce.fused_ce_forward.launches, fce.fused_ce_backward_dh.launches,
            fce.fused_ce_backward_dw.launches) == tuple(c + 1 for c in counts)
    plain = [h.float().requires_grad_(True), w.float().requires_grad_(True)]
    total_ref, count_ref = fce.plain_sum_and_count(*plain, y)
    total_ref.backward()
    assert float(count) == float(count_ref) == n - ignored
    torch.testing.assert_close(total.detach(), total_ref.detach(), rtol=1e-5, atol=1e-6)
    rel = FLASH_ROW_REL[torch.float32] if dtype == torch.float32 else CE_ROW_REL_BF16
    for got, want, name in zip(leaves, plain, ("dh", "dW")):
        assert got.grad.dtype == dtype and got.grad.shape == got.shape
        _rows_close(got.grad, want.grad, rel, name)
    lse, corr = fce.fused_ce_forward(h, w, y)
    lse_ref, corr_ref = fce.reference_fused_ce_forward(h, w, y)
    assert float((lse - lse_ref).abs().max()) <= 1e-4 and float((corr - corr_ref).abs().max()) <= 1e-4
    gm = (y != -100).float()
    for fn in (fce.fused_ce_backward_dh, fce.fused_ce_backward_dw):
        assert torch.equal(fn(h, w, y, lse, gm), fn(h, w, y, lse, gm))


# (N, V, E, ignored rows) of the bf16 forward kernel (128 rows a CTA, 256-row vocab tiles): ragged rows and vocab,
# one row and one vocab column, all rows ignored, the 32k config's width and vocab, the 7B's width on a vocab shard
CE_FWD_CASES = [(1, 1, 128, 0), (37, 129, 256, 0), (100, 300, 128, 7), (16, 128, 128, 16), (129, 257, 1536, 3),
                (300, 1000, 1536, 5), (4097, 2049, 256, 100), (200, 50304, 1536, 10), (129, 257, 4096, 3),
                (200, 6288, 4096, 10)]


@pytest.mark.cuda
@pytest.mark.parametrize("case", CE_FWD_CASES, ids=str)
def test_fused_ce_forward_kernel_over_ragged_rows_and_vocab(case):
    """The wgmma forward: lse and corr 1e-4 absolute against the plain
    version, with a quarter of the labels in the last (partial) vocab tile and
    one past the vocab (corr 0); two calls bitwise equal."""
    dev = _card()
    n, v, e, ignored = case
    g = torch.Generator(device=dev).manual_seed(2)
    h = torch.randn(n, e, generator=g, device=dev).to(torch.bfloat16)
    w = (0.02 * torch.randn(v, e, generator=g, device=dev)).to(torch.bfloat16)
    y = torch.randint(0, v, (n,), generator=g, device=dev)
    y[: n // 4] = v - 1
    y[n // 2] = v
    y[torch.randperm(n, generator=g, device=dev)[:ignored]] = -100
    lse, corr = fce.fused_ce_forward(h, w, y)
    lse2, corr2 = fce.fused_ce_forward(h, w, y)
    assert torch.equal(lse, lse2) and torch.equal(corr, corr2)
    lse_ref, corr_ref = fce.reference_fused_ce_forward(h, w, y)
    assert float((lse - lse_ref).abs().max()) <= 1e-4
    assert float((corr - corr_ref).abs().max()) <= 1e-4


# (N, V, E, ignored rows) of the bf16 dh kernel (a cluster of 8 CTAs a block of 128 rows, 16 at E = 4096; 64-row
# vocab tiles): rows and vocab around those tiles, one row and one vocab column, all rows ignored, the 32k config's
# width and vocab, the 7B's width and a tp-8 vocab shard
CE_DH_CASES = [(1, 1, 128, 0), (127, 63, 256, 0), (128, 64, 128, 5), (129, 65, 1536, 3), (257, 129, 128, 257),
               (300, 1000, 1536, 5), (1000, 777, 256, 50), (200, 50304, 1536, 10), (1, 1, 4096, 0),
               (129, 65, 4096, 3), (257, 6288, 4096, 10)]


@pytest.mark.cuda
@pytest.mark.parametrize("case", CE_DH_CASES, ids=str)
def test_fused_ce_dh_kernel_over_ragged_rows_and_vocab(case):
    """The cluster dh kernel: dh of the sum (gm = mask) row by row against the
    fp32 plain backward given the same lse (CE_ROW_REL_BF16), a quarter of the
    labels in the last (partial) vocab tile, ignored rows exactly 0; two calls
    bitwise equal."""
    dev = _card()
    n, v, e, ignored = case
    g = torch.Generator(device=dev).manual_seed(3)
    h = torch.randn(n, e, generator=g, device=dev).to(torch.bfloat16)
    w = (0.02 * torch.randn(v, e, generator=g, device=dev)).to(torch.bfloat16)
    y = torch.randint(0, v, (n,), generator=g, device=dev)
    y[: n // 4] = v - 1
    y[torch.randperm(n, generator=g, device=dev)[:ignored]] = -100
    lse = fce.reference_fused_ce_forward(h, w, y)[0]
    gm = (y != -100).float()
    dh = fce.fused_ce_backward_dh(h, w, y, lse, gm)
    assert torch.equal(dh, fce.fused_ce_backward_dh(h, w, y, lse, gm))
    assert dh.dtype == torch.bfloat16 and bool((dh[y == -100] == 0).all())
    want = fce.reference_fused_ce_backward(h.float(), w.float(), y, lse, gm)[0]
    _rows_close(dh, want, CE_ROW_REL_BF16, f"dh N={n} V={v} E={e}")


@pytest.mark.cuda
def test_fused_ce_refuses_bf16_widths_it_was_not_built_for():
    dev = _card()
    h, w = torch.randn(8, 96, device=dev).to(torch.bfloat16), torch.randn(16, 96, device=dev).to(torch.bfloat16)
    with pytest.raises(ValueError, match="E=96"):
        fce.fused_ce_forward(h, w, torch.zeros(8, dtype=torch.long, device=dev))

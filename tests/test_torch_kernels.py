"""The port's kernel wrappers (ops/rmsnorm.py, ops/quant_matmul.py) without
JAX: how they dispatch, and — on a card — each kernel against its plain
PyTorch version. This file imports no JAX, so the `cuda`-marked tests run on a
machine with a card and no JAX:

    python -m pytest --noconftest -m cuda tests/test_torch_kernels.py

Tolerances on the card: RMSNorm f32 1e-5 (warp-tree vs torch sum order), bf16
two bf16 ulps (rtol 2^-6); dequant-matmul f32 x 1e-5 * max|ref| (sums of 2560
products in another order), bf16 x the same plus two bf16 ulps."""

import pytest
import torch

from modalities_tpu_torch.device import resolve_device
from modalities_tpu_torch.ops.quant_matmul import BLOCK_K, quant_matmul, reference_quant_matmul, split_k
from modalities_tpu_torch.ops.rmsnorm import reference_rms_norm, rms_norm
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
    # CTA per row at every row count the serving path gives it; warp per row
    for n, e in ((1, 2560), (4, 2560), (8, 2560), (16, 2560), (64, 2560), (3, 128)):
        x = torch.randn(n, e, generator=g, device=dev).to(dtype)
        s, b = torch.randn(e, generator=g, device=dev), torch.randn(e, generator=g, device=dev)
        before = rms_norm.launches
        got, r = rms_norm(x, s, b, eps=EPS, residual=True)
        torch.cuda.synchronize()
        assert rms_norm.launches == before + 1 and r.shape == (n, 1)
        torch.testing.assert_close(got.float(), reference_rms_norm(x, s, b, eps=EPS).float(), **tol)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_rms_norm_kernel_refuses_rows_it_cannot_load_in_16_byte_vectors(dtype):
    dev = _card()
    x = torch.randn(4 * 128 + 1, device=dev).to(dtype)[1:].view(4, 128)  # one element off alignment
    with pytest.raises(ValueError, match="16-byte"):
        rms_norm(x, None, None, eps=EPS)
    with pytest.raises(ValueError, match="16-byte"):
        rms_norm(torch.randn(4, 100, device=dev).to(torch.bfloat16), None, None, eps=EPS)  # 200-byte rows


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["int8", "fp8"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_quant_matmul_kernel_matches_the_plain_version_on_the_card(mode, dtype):
    dev = _card()
    g = torch.Generator(device=dev).manual_seed(0)
    w = torch.randn(640, 2560, generator=g, device=dev)  # [out, in]
    wq, scale = quantize_per_channel(w) if mode == "int8" else quantize_fp8(w)
    wq, scale = wq.t().contiguous(), scale[:, 0].contiguous()
    for m in (1, 4, 8, 16, 64):  # every row count of the decode step and the prefill ladder
        x = torch.randn(m, 2560, generator=g, device=dev).to(dtype)
        before = quant_matmul.launches
        got = quant_matmul(x, wq, scale)
        torch.cuda.synchronize()
        assert quant_matmul.launches == before + 1
        want = reference_quant_matmul(x, wq, scale)
        atol = 1e-5 * float(want.float().abs().max())
        rtol = 0.0 if dtype == torch.float32 else 2**-6
        torch.testing.assert_close(got.float(), want.float(), atol=atol, rtol=rtol)

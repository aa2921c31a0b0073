"""Port parity for the fused RMSNorm (modalities_tpu_torch/ops/rmsnorm.py) and
the norm modules (models/components/layer_norms.py) against the JAX package:
the Pallas kernel in interpret mode, its reference, and flax's modules, on the
same numpy inputs.

Tolerances: f32 atol 1e-6 (same expression, fp32 throughout); bf16 one bf16
ulp (rtol 2^-7, bf16 keeps 7 mantissa bits), since the two frameworks may round
the final cast differently where fp32 sums of different order straddle a
rounding boundary.

The checks that need no JAX — a CPU tensor takes the plain version, the
default device raises without a card, the kernel on a card — are in
tests/test_torch_kernels.py."""

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from modalities_tpu.models.components.layer_norms import NormSpec as JaxNormSpec
from modalities_tpu.ops.pallas.fused_rmsnorm import _fused_rms_fwd, fused_rms_norm
from modalities_tpu.ops.rmsnorm import reference_rms_norm as jax_reference_rms_norm
from modalities_tpu_torch.models.components.layer_norms import NormSpec, build_norm
from modalities_tpu_torch.ops.rmsnorm import rms_norm

EPS = 1e-5
TOL = {"float32": dict(atol=1e-6, rtol=0), "bfloat16": dict(atol=1e-6, rtol=2**-7)}
TORCH_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _inputs(n, e, dtype, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, e)).astype(np.float32)
    scale = rng.standard_normal(e).astype(np.float32)
    bias = rng.standard_normal(e).astype(np.float32)
    xj = jnp.asarray(x).astype(dtype)
    xt = torch.from_numpy(np.array(xj.astype(jnp.float32))).to(TORCH_DTYPES[dtype])  # same bf16 values
    return xj, xt, scale, bias


def _np(t):
    return t.float().numpy() if isinstance(t, torch.Tensor) else np.asarray(jnp.asarray(t).astype(jnp.float32))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("affine", [False, True], ids=["identity", "scale+bias"])
@pytest.mark.parametrize("n", [1, 7, 33])
def test_plain_rms_norm_matches_jax_interpret_kernel_and_reference(dtype, affine, n):
    e = 256
    xj, xt, scale, bias = _inputs(n, e, dtype, seed=n)
    sj, bj = (jnp.asarray(scale), jnp.asarray(bias)) if affine else (None, None)
    st, bt = (torch.from_numpy(scale), torch.from_numpy(bias)) if affine else (None, None)
    got = rms_norm(xt, st, bt, eps=EPS)
    assert got.dtype == xt.dtype and got.shape == xt.shape
    kernel = fused_rms_norm(xj, sj, bj, eps=EPS, block_rows=8, interpret=True)
    reference = jax_reference_rms_norm(xj, sj, bj, eps=EPS)
    np.testing.assert_allclose(_np(got), _np(kernel), **TOL[dtype])
    np.testing.assert_allclose(_np(got), _np(reference), **TOL[dtype])


def test_residual_matches_the_jax_kernels_saved_statistic():
    xj, xt, scale, bias = _inputs(16, 128, "float32")
    _, (_, _, _, r_jax) = _fused_rms_fwd(
        xj, jnp.asarray(scale)[None], jnp.asarray(bias)[None], EPS, 8, True
    )
    y, r = rms_norm(xt, torch.from_numpy(scale), torch.from_numpy(bias), eps=EPS, residual=True)
    assert r.shape == (16, 1) and r.dtype == torch.float32
    np.testing.assert_allclose(r.numpy(), np.asarray(r_jax), atol=1e-6, rtol=1e-6)


@pytest.mark.parametrize(
    "wrapper",
    [
        {"norm_type": "rms_norm", "config": {"ndim": 64, "bias": True, "epsilon": 1e-5}},
        {"norm_type": "rms_norm", "config": {"ndim": 64, "bias": False}},
        {"norm_type": "pytorch_rms_norm", "config": {"normalized_shape": 64, "eps": 1e-6}},
        {"norm_type": "layer_norm", "config": {"normalized_shape": 64, "eps": 1e-5, "bias": True}},
        {"norm_type": "layer_norm", "config": {"normalized_shape": 64, "elementwise_affine": False}},
        None,
    ],
    ids=["rms-bias", "rms", "pytorch-rms", "layer", "layer-noaffine", "default"],
)
def test_norm_modules_match_flax(wrapper):
    """NormSpec resolves as the JAX NormSpec does, and the module computes what
    the JAX package's reference module computes, with the same parameters."""
    from modalities_tpu.models.components.layer_norms import build_norm as jax_build_norm

    spec = NormSpec.from_wrapper_config(wrapper, 64)
    jspec = JaxNormSpec.from_wrapper_config(wrapper, 64)
    assert (spec.kind, spec.dim, spec.eps, spec.use_bias, spec.use_scale) == (
        jspec.kind.value, jspec.dim, jspec.eps, jspec.use_bias, jspec.use_scale
    )
    rng = np.random.default_rng(1)
    x = rng.standard_normal((5, 64)).astype(np.float32)
    jmod = jax_build_norm(jspec, "norm")
    variables = jmod.init(jax.random.PRNGKey(0), jnp.asarray(x))
    params = {k: np.asarray(v) + rng.standard_normal(v.shape).astype(np.float32) * 0.1
              for k, v in nn.meta.unbox(variables).get("params", {}).items()}
    want = np.asarray(jmod.apply({"params": params}, jnp.asarray(x)))
    module = build_norm(spec)
    module.load_state_dict({k: torch.from_numpy(v) for k, v in params.items()})
    got = module(torch.from_numpy(x))
    np.testing.assert_allclose(got.detach().numpy(), want, atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("affine", [False, True], ids=["identity", "scale+bias"])
@pytest.mark.parametrize("n", [1, 7, 33])
def test_backward_matches_the_jax_custom_vjp_in_interpret_mode(affine, n):
    """dx, dscale and dbias of the port (autograd through the plain version,
    and the plain backward kernel given r) against jax.vjp of the JAX
    `fused_rms_norm` custom_vjp, whose backward is the Pallas `_bwd_kernel` in
    interpret mode. Tolerance 1e-5 (f32; sums in other orders)."""
    from modalities_tpu_torch.ops.rmsnorm import fused_rms_norm as port_fused_rms_norm
    from modalities_tpu_torch.ops.rmsnorm import rms_norm_backward

    e = 256
    rng = np.random.default_rng(100 + n)
    x = rng.standard_normal((n, e)).astype(np.float32)
    dy = rng.standard_normal((n, e)).astype(np.float32)
    scale = rng.standard_normal(e).astype(np.float32)
    bias = rng.standard_normal(e).astype(np.float32)
    if affine:
        _, vjp = jax.vjp(lambda a, s, b: fused_rms_norm(a, s, b, eps=EPS, block_rows=8, interpret=True),
                         jnp.asarray(x), jnp.asarray(scale), jnp.asarray(bias))
        jdx, jds, jdb = vjp(jnp.asarray(dy))
    else:
        _, vjp = jax.vjp(lambda a: fused_rms_norm(a, eps=EPS, block_rows=8, interpret=True), jnp.asarray(x))
        (jdx,) = vjp(jnp.asarray(dy))
    leaves = [torch.from_numpy(a.copy()).requires_grad_(True) for a in ((x, scale, bias) if affine else (x,))]
    port_fused_rms_norm(*leaves, eps=EPS).backward(torch.from_numpy(dy))
    tol = dict(atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(leaves[0].grad.numpy(), np.asarray(jdx), **tol)
    if affine:
        np.testing.assert_allclose(leaves[1].grad.numpy(), np.asarray(jds), **tol)
        np.testing.assert_allclose(leaves[2].grad.numpy(), np.asarray(jdb), **tol)
    # the plain backward kernel itself, from the forward's r
    xt = torch.from_numpy(x)
    _, r = rms_norm(xt, torch.from_numpy(scale) if affine else None, None, eps=EPS, residual=True)
    dx, ds, db = rms_norm_backward(torch.from_numpy(dy), xt, torch.from_numpy(scale) if affine else None, r)
    np.testing.assert_allclose(dx.numpy(), np.asarray(jdx), **tol)
    if affine:
        np.testing.assert_allclose(ds.numpy(), np.asarray(jds), **tol)
        np.testing.assert_allclose(db.numpy(), np.asarray(jdb), **tol)


def test_bf16_scale_gradient_returns_in_the_parameters_dtype():
    from modalities_tpu_torch.ops.rmsnorm import fused_rms_norm as port_fused_rms_norm

    x = torch.randn(4, 64, requires_grad=True)
    scale = torch.randn(64).to(torch.bfloat16).requires_grad_(True)
    port_fused_rms_norm(x, scale, None, eps=EPS).sum().backward()
    assert scale.grad.dtype == torch.bfloat16 and x.grad.dtype == torch.float32


@pytest.mark.parametrize("n", [1, 7, 100, 527, 528, 529, 1000, 8192, 32768, 100003])
def test_backward_grid_depends_on_rows_alone_and_sizes_the_workspace(n, monkeypatch):
    """The backward kernel's CTA count, and with it the order of its
    dscale/dbias sums, is computed from N without asking the device: at most
    BWD_CTAS CTAs, each with ceil(N / CTAs) rows or one fewer, covering every
    row once; the workspace holds [CTAs, E] fp32 partials for dscale and for
    dbias (what the kernel indexes)."""
    from modalities_tpu_torch.ops import rmsnorm as port

    def no_device(*args, **kwargs):
        raise AssertionError("the grid sizing asked the device")

    for name in ("device_count", "get_device_properties", "current_device"):
        monkeypatch.setattr(torch.cuda, name, no_device)
    rows, ctas = port.backward_grid(n)
    assert 1 <= ctas <= port.BWD_CTAS and (ctas - 1) * rows < n <= ctas * rows
    assert port.backward_grid(n) == (rows, ctas)
    for e in (128, 1536, 2560):
        assert port.backward_workspace_floats(n, e, True, False) == 2 * ctas * e
        assert port.backward_workspace_floats(n, e, False, True) == 2 * ctas * e
        assert port.backward_workspace_floats(n, e, False, False) == 0

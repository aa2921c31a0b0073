"""The port's ring attention (modalities_tpu_torch/parallel/ring_attention.py)
on a 4-rank gloo world against the JAX package's `ring_attention` on a cp=4
mesh of the 8 CPU devices (tests/conftest.py):

- the flash ring, whose hops run the flash kernels' plain versions on the
  CPU, against the JAX flash ring in interpret mode (the `flash_ring` fixture
  of tests/parallel/test_ring_attention.py: MODALITIES_TPU_RING_IMPL=
  flash_interpret), causal and not, Hq/Hkv 4/4 and 4/2;
- the dense ring (`attention_implementation: manual`) against the JAX dense
  ring (its CPU default);
- out and the gradients of sum(out * w) (position-dependent w, so a misrouted
  dk/dv accumulator cannot cancel out) in f32 within 1e-5 (the same math in
  fp32, summed in other orders);
- `ring_in_process` (the hop driver chip_smoke.py runs at full width on one
  card) equals the gloo ring bitwise: the same hop functions, merged and
  accumulated in the same order.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from modalities_tpu.parallel.ring_attention import ring_attention as jax_ring_attention
from modalities_tpu_torch.parallel.ring_attention import CAUSAL, FULL, SKIP, branch, ring_in_process
from tests.test_torch_gloo import ring_worker, run_world

CP, B, S, D = 4, 2, 32, 16
TOL = dict(atol=1e-5, rtol=1e-5)
CASES = [("flash", True, 4, 4), ("flash", True, 4, 2), ("flash", False, 4, 4), ("flash", False, 4, 2),
         ("dense", True, 4, 2), ("dense", False, 4, 4)]
IDS = [f"{impl}-{'causal' if causal else 'full'}-hq{hq}-hkv{hkv}" for impl, causal, hq, hkv in CASES]


def _inputs(i: int, hq: int, hkv: int) -> dict:
    rng = np.random.default_rng(100 + i)
    q = rng.standard_normal((B, S, hq, D)).astype(np.float32)
    k = rng.standard_normal((B, S, hkv, D)).astype(np.float32)
    v = rng.standard_normal((B, S, hkv, D)).astype(np.float32)
    w = (np.arange(S, dtype=np.float32)[None, :, None, None] + 1.0) * rng.standard_normal((B, S, hq, D)).astype(
        np.float32)
    return {"q": q, "k": k, "v": v, "w": w}


@pytest.fixture(scope="module")
def port_ring():
    cases = [{**_inputs(i, hq, hkv), "impl": impl, "causal": causal} for i, (impl, causal, hq, hkv) in enumerate(CASES)]
    ranks = run_world(CP, ring_worker, cases)
    gathered = [{key: np.concatenate([r[i][key] for r in ranks], axis=1) for key in ranks[0][i]}
                for i in range(len(CASES))]
    return cases, gathered


def _jax_ring(case: dict, monkeypatch) -> dict:
    if case["impl"] == "flash":
        monkeypatch.setenv("MODALITIES_TPU_RING_IMPL", "flash_interpret")
    else:
        monkeypatch.delenv("MODALITIES_TPU_RING_IMPL", raising=False)
    mesh = Mesh(np.asarray(jax.devices()[:CP]), ("cp",))
    sharding = NamedSharding(mesh, P(None, "cp", None, None))
    q, k, v = (jax.device_put(jnp.asarray(case[n]), sharding) for n in ("q", "k", "v"))
    w = jnp.asarray(case["w"])

    @jax.jit
    def out_and_grads(q, k, v):  # the gradients of sum(out * w): the vjp of w
        out, vjp = jax.vjp(lambda q, k, v: jax_ring_attention(q, k, v, mesh, causal=case["causal"]), q, k, v)
        return out, vjp(w)

    out, grads = out_and_grads(q, k, v)
    return {"out": np.asarray(out), **{f"d{n}": np.asarray(g) for n, g in zip("qkv", grads)}}


@pytest.mark.parametrize("index", range(len(CASES)), ids=IDS)
def test_the_ring_matches_the_jax_ring(port_ring, index, monkeypatch):
    cases, gathered = port_ring
    want = _jax_ring(cases[index], monkeypatch)
    for key in ("out", "dq", "dk", "dv"):
        np.testing.assert_allclose(gathered[index][key], want[key], err_msg=key, **TOL)


@pytest.mark.parametrize("index", [i for i, c in enumerate(CASES) if c[0] == "flash"],
                         ids=[i for i, c in zip(IDS, CASES) if c[0] == "flash"])
def test_the_in_process_hop_driver_equals_the_gloo_ring_bitwise(port_ring, index):
    cases, gathered = port_ring
    case = cases[index]
    t = {n: torch.from_numpy(np.ascontiguousarray(case[n].transpose(0, 2, 1, 3))) for n in ("q", "k", "v", "w")}
    out, lse, dq, dk, dv = ring_in_process(t["q"], t["k"], t["v"], t["w"], CP, causal=case["causal"])
    assert lse.shape == (B, case["q"].shape[2], S, 1) and lse.dtype == torch.float32
    for key, got in (("out", out), ("dq", dq), ("dk", dk), ("dv", dv)):
        assert np.array_equal(got.transpose(1, 2).numpy(), gathered[index][key]), key


def test_the_hop_branches_follow_the_jax_branch_index():
    """j < i full, j == i the diagonal, j > i skipped (causal); all full
    otherwise: 4 causal, 6 full and 6 skipped hops at cp 4."""
    hops = [branch(True, i, j) for i in range(CP) for j in range(CP)]
    assert (hops.count(CAUSAL), hops.count(FULL), hops.count(SKIP)) == (4, 6, 6)
    assert all(branch(False, i, j) == FULL for i in range(CP) for j in range(CP))

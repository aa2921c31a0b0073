"""Port parity for the GPT2 paged-cache surface: `prefill_paged`,
`decode_paged` and `verify_paged` of modalities_tpu_torch against the JAX
model's, with the same weights (params_from_jax) and the same dispatches, on
the CPU in f32. The pool starts with one recycled block full of NaN (int8: its
codes random, its scales NaN), and every dispatch has cells that write
nowhere (a padded prefill tail, an idle decode slot, a verify column past the
budget), so a dropped write that lands on a live block, or a recycled row that
leaks into a product, shows in the logits or in the pools.

Tolerances, against the JAX model:
- bf16/f32 KV: logits within 1e-5 (the frameworks sum in different orders),
  pools within 1e-5 after `paged_cache_from_jax` (NaN where both are NaN).
- int8 KV: scales within 1e-6 relative; codes equal, or off by one where the
  two quantizers' fp32 `x / scale` straddle a rounding boundary (counted, at
  most 1 % of the written codes); logits within 1e-3 (a code off by one moves
  one element by one scale step, ~1/127 of its row's absmax).
The port's pools also hold the scratch block that takes the dropped writes;
it is never compared and never gathered."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from modalities_tpu_torch.conversion.from_jax import paged_cache_from_jax
from tests.test_torch_gpt2 import jax_and_port

NB, BS, MB = 10, 4, 4  # pool blocks, block size, table width (positions 0..15)
NAN_BLOCK = 7  # a recycled block: row A's second block, only partly written
F32_ATOL = 1e-5
INT8_LOGIT_ATOL = 1e-3
INT8_SCALE_RTOL = 1e-6
INT8_OFF_BY_ONE_SHARE = 0.01


def _dirty(cache_np: dict, quant: str) -> dict:
    attn = cache_np["blocks"]["block"]["attn"]
    rng = np.random.default_rng(5)
    if quant == "int8":
        for name in ("cached_key", "cached_value"):
            attn[name][:, NAN_BLOCK] = rng.integers(-127, 128, size=attn[name][:, NAN_BLOCK].shape)
        for name in ("cached_key_scale", "cached_value_scale"):
            attn[name][:, NAN_BLOCK] = np.nan
    else:
        for name in ("cached_key", "cached_value"):
            attn[name][:, NAN_BLOCK] = np.nan
    return cache_np


def _dispatches():
    """(kind, tokens, positions, tables, wblk, woff): requests A (blocks 2, 7,
    1) and B (blocks 5, 9) through a packed prefill, a decode step and a
    verify; block NB is the write-nowhere id."""
    rng = np.random.default_rng(3)
    tab_a, tab_b = [2, NAN_BLOCK, 1, 0], [5, 9, 0, 0]
    zeros = [0, 0, 0, 0]
    t = lambda *shape: rng.integers(0, 128, size=shape)  # noqa: E731
    # prefill: A 0..3, A 4..6 (+1 padded cell), B 0..1 (+2 padded cells)
    prefill = ("prefill", t(3, 4),
               np.array([[0, 1, 2, 3], [4, 5, 6, 0], [0, 1, 0, 0]]),
               np.array([tab_a, tab_a, tab_b]),
               np.array([[2, 2, 2, 2], [NAN_BLOCK] * 3 + [NB], [5, 5, NB, NB]]),
               np.array([[0, 1, 2, 3], [0, 1, 2, 0], [0, 1, 0, 0]]))
    # decode: A at 7, B at 2, slot 2 idle
    decode = ("decode", t(3, 1), np.array([7, 2, 0]), np.array([tab_a, tab_b, zeros]),
              np.array([NAN_BLOCK, 5, NB]), np.array([3, 2, 0]))
    # verify k=2: A at 8..10 (its budget drops column 2), B at 3..5, slot 2 idle
    verify = ("verify", t(3, 3), np.array([[8, 9, 10], [3, 4, 5], [0, 1, 2]]), np.array([tab_a, tab_b, zeros]),
              np.array([[1, 1, NB], [5, 9, 9], [NB, NB, NB]]), np.array([[0, 1, 0], [3, 0, 1], [0, 0, 0]]))
    return [prefill, decode, verify]


def _run(quant: str, **overrides):
    jm, jparams, pm, pparams = jax_and_port("float32", use_weight_tying=False, **overrides)
    module = pm.build_module(pparams)
    jc = _dirty(jax.tree.map(np.array, jm.init_paged_cache(jparams, NB, BS, kv_quant=quant)), quant)
    pc = paged_cache_from_jax(jc)
    jc = jax.tree.map(jnp.asarray, jc)
    steps = []
    for kind, toks, pos, tables, wblk, woff in _dispatches():
        jfn = {"prefill": jm.prefill_paged, "decode": jm.decode_paged, "verify": jm.verify_paged}[kind]
        pfn = {"prefill": module.prefill_paged, "decode": module.decode_paged, "verify": module.verify_paged}[kind]
        jl, jc = jfn(jparams, jc, *(jnp.asarray(a, jnp.int32) for a in (toks, pos, tables, wblk, woff)))
        with torch.inference_mode():
            pl = pfn(pc, *(torch.as_tensor(a, dtype=torch.long) for a in (toks, pos, tables, wblk, woff)))
        snapshot = dataclasses.replace(pc, **{f.name: getattr(pc, f.name).clone() for f in dataclasses.fields(pc)
                                              if getattr(pc, f.name) is not None})
        steps.append((kind, np.asarray(jl), pl.numpy(), paged_cache_from_jax(jax.tree.map(np.asarray, jc)), snapshot))
    return steps


def _live(t):
    return t[:, :NB].float().numpy()  # the scratch block (index NB) is never compared


@pytest.mark.parametrize("overrides", [{}, {"poe_type": "ABSOLUTE", "activation_type": "gelu", "bias": True}],
                         ids=["rope", "absolute-gelu-bias"])
def test_paged_dispatches_match_jax_f32(overrides):
    for kind, want, got, jcache, pcache in _run("none", **overrides):
        assert np.isfinite(got).all() and got.shape == want.shape, kind
        np.testing.assert_allclose(got, want, atol=F32_ATOL, rtol=0, err_msg=kind)
        for ours, theirs in ((pcache.k, jcache.k), (pcache.v, jcache.v)):
            np.testing.assert_allclose(_live(ours), _live(theirs), atol=F32_ATOL, rtol=0, err_msg=kind)


def test_paged_writes_land_only_on_their_coordinates():
    """After the three dispatches every written (block, offset) holds K/V and
    every other live cell is as it started (zero, or the recycled block's
    NaN): no dropped write reached a live block."""
    written = set()
    for _, _, _, _, wblk, woff in _dispatches():
        written |= {(int(b), int(o)) for b, o in zip(wblk.ravel(), woff.ravel()) if b != NB}
    (*_, pcache) = _run("none")[-1]
    k = _live(pcache.k)
    for block in range(NB):
        for off in range(BS):
            cell = k[:, block, off]
            if (block, off) in written:
                assert np.isfinite(cell).all() and np.abs(cell).sum() > 0, (block, off)
            elif block == NAN_BLOCK:
                assert np.isnan(cell).all(), (block, off)
            else:
                assert (cell == 0).all(), (block, off)


def test_int8_paged_dispatches_match_jax():
    off_by_one = written_codes = 0
    for kind, want, got, jcache, pcache in _run("int8"):
        assert np.isfinite(got).all(), kind
        np.testing.assert_allclose(got, want, atol=INT8_LOGIT_ATOL, rtol=0, err_msg=kind)
        for ours, theirs in ((pcache.k_scale, jcache.k_scale), (pcache.v_scale, jcache.v_scale)):
            np.testing.assert_allclose(_live(ours), _live(theirs), rtol=INT8_SCALE_RTOL, atol=0, err_msg=kind)
        for ours, theirs in ((pcache.k, jcache.k), (pcache.v, jcache.v)):
            assert ours.dtype == torch.int8
            diff = np.abs(_live(ours) - _live(theirs))
            assert diff.max() <= 1, kind
            off_by_one += int((diff == 1).sum())
            written_codes += int((_live(ours) != 0).sum())
    print(f"int8 KV codes off by one against JAX: {off_by_one} of {written_codes}")
    assert off_by_one <= INT8_OFF_BY_ONE_SHARE * written_codes


def test_paged_cache_layout_and_bytes():
    jm, jparams, pm, pparams = jax_and_port("float32", use_weight_tying=False)
    module = pm.build_module(pparams)
    for quant in ("none", "int8"):
        cache = module.init_paged_cache(NB, BS, kv_quant=quant)
        jcache = jm.init_paged_cache(jparams, NB, BS, kv_quant=quant)
        assert tuple(cache.k.shape) == (2, NB + 1, BS, 2, 32)  # [L, blocks + scratch, bs, Hkv, D]
        assert cache.num_blocks == NB and cache.block_size == BS and cache.kv_quant == quant
        assert cache.nbytes == sum(leaf.nbytes for leaf in jax.tree.leaves(jcache))  # the JAX kv_pool_bytes
        assert cache.scale_bytes == (2 * 2 * NB * BS * 2 * 4 if quant == "int8" else 0)
    with pytest.raises(ValueError, match="kv_quant"):
        module.init_paged_cache(NB, BS, kv_quant="int4")
    with pytest.raises(ValueError, match="num_blocks >= 1"):
        module.init_paged_cache(0, BS)


def test_cow_block_copy_copies_every_pool():
    jm, jparams, pm, pparams = jax_and_port("float32", use_weight_tying=False)
    cache = pm.build_module(pparams).init_paged_cache(NB, BS, kv_quant="int8")
    for t in (cache.k, cache.v, cache.k_scale, cache.v_scale):
        t[:, 3] = 1
    cache.copy_block(3, 8)
    for t in (cache.k, cache.v, cache.k_scale, cache.v_scale):
        assert torch.equal(t[:, 8], t[:, 3]) and (t[:, 8] == 1).all()

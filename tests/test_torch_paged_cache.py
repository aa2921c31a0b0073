"""Port parity for the paged KV cache's host bookkeeping: the same seeded
random sequences of allocate, fork, register, match, copy-on-write and release
replayed through the JAX `BlockTableState` and the port's, with a
`KVScaleMirror` on each pool. After every operation both sides hold the same
tables, refcounts, free list (in LIFO order), prefix index and scale slots,
and every operation returns the same answer. Pure Python on both sides."""

import numpy as np
import pytest

from modalities_tpu.quant import kv as jax_kv
from modalities_tpu.serving import paged_cache as jax_pc
from modalities_tpu_torch.quant import kv as port_kv
from modalities_tpu_torch.serving import paged_cache as port_pc


def _snapshot(state, mirror) -> dict:
    pool = state.pool
    return {
        "free": list(pool._free),
        "refcount": dict(pool._refcount),
        "tables": {rid: list(r.blocks) for rid, r in state._requests.items()},
        "index": dict(state._prefix_index),
        "block_key": dict(state._block_key),
        "scale_slots": set(mirror.live),
        "scale_counts": (mirror.allocs, mirror.frees),
    }


def _pair(num_blocks, block_size, width):
    sides = []
    for pc, kv in ((jax_pc, jax_kv), (port_pc, port_kv)):
        state = pc.BlockTableState(num_blocks, block_size, width)
        mirror = kv.KVScaleMirror(num_blocks)
        state.pool.add_observer(mirror)
        sides.append((state, mirror))
    return sides


def _call(side, name, *args):
    """(result, exception type name) of one operation on one side."""
    try:
        return getattr(side[0], name)(*args), None
    except (ValueError, KeyError, AssertionError) as e:
        return None, type(e).__name__


@pytest.mark.parametrize("seed", range(4))
def test_random_block_table_sequences_match_jax(seed):
    rng = np.random.default_rng(seed)
    bs, width = 4, 6
    num_blocks = int(rng.integers(width, 3 * width))
    jax_side, port_side = _pair(num_blocks, bs, width)
    prefixes = [[int(t) for t in rng.integers(0, 50, size=12)] for _ in range(3)]
    prompts: dict[int, list[int]] = {}
    next_rid = 0
    ops = {"admit": 0, "grow": 0, "cow": 0, "release": 0, "register": 0, "flush": 0}
    for _ in range(300):
        live = sorted(prompts)
        op = rng.choice(["admit", "grow", "cow", "release", "register", "flush"], p=[0.3, 0.25, 0.15, 0.15, 0.13, 0.02])
        if op == "admit" or not live:
            rid, next_rid = next_rid, next_rid + 1
            base = prefixes[int(rng.integers(len(prefixes)))]
            tail = [int(t) for t in rng.integers(0, 50, size=int(rng.integers(0, 6)))]
            prompt = base[: int(rng.integers(1, 13))] + tail
            prompt = prompt[: width * bs - 1] or [1]
            matched = [_call(s, "match_prefix", prompt) for s in (jax_side, port_side)]
            assert matched[0] == matched[1]
            blocks = matched[0][0]
            if blocks and rng.random() < 0.8:
                assert _call(jax_side, "fork_prefix", rid, blocks) == _call(port_side, "fork_prefix", rid, blocks)
            got = [_call(s, "ensure", rid, len(prompt)) for s in (jax_side, port_side)]
            assert got[0] == got[1]
            if got[0][0]:
                prompts[rid] = prompt
            else:  # pool dry at admission: a forked table is released again
                assert _call(jax_side, "release", rid) == _call(port_side, "release", rid)
        elif op == "grow":
            rid = live[int(rng.integers(len(live)))]
            n = min(len(prompts[rid]) + int(rng.integers(1, 6)), width * bs)
            assert _call(jax_side, "ensure", rid, n) == _call(port_side, "ensure", rid, n)
        elif op == "cow":
            rid = live[int(rng.integers(len(live)))]
            held = jax_side[0].blocks_held(rid)
            if held:
                position = int(rng.integers(held * bs))
                assert _call(jax_side, "ensure_writable", rid, position) == _call(
                    port_side, "ensure_writable", rid, position)
                assert jax_side[0].write_coords(rid, position) == port_side[0].write_coords(rid, position)
        elif op == "register":
            rid = live[int(rng.integers(len(live)))]
            upto = min(len(prompts[rid]), jax_side[0].blocks_held(rid) * bs)
            assert _call(jax_side, "register_prefix", rid, prompts[rid], upto) == _call(
                port_side, "register_prefix", rid, prompts[rid], upto)
        elif op == "flush":
            assert _call(jax_side, "flush_prefix_index") == _call(port_side, "flush_prefix_index")
        else:
            rid = live[int(rng.integers(len(live)))]
            assert _call(jax_side, "release", rid) == _call(port_side, "release", rid)
            del prompts[rid]
        ops[op] += 1
        assert _snapshot(*jax_side) == _snapshot(*port_side), op
        for rid in prompts:
            assert jax_side[0].table(rid) == port_side[0].table(rid)
        port_side[0].check()
        port_side[1].check(port_side[0].pool)
        assert port_side[0].pool.shared_count == jax_side[0].pool.shared_count
    assert all(n > 0 for op, n in ops.items() if op != "flush"), ops
    assert port_side[1].allocs > 0 and port_side[1].frees > 0


def test_pool_guards_and_helpers_match_jax():
    assert [port_pc.blocks_for_tokens(n, 4) for n in range(10)] == [jax_pc.blocks_for_tokens(n, 4) for n in range(10)]
    for pc in (jax_pc, port_pc):
        with pytest.raises(ValueError, match="num_blocks"):
            pc.BlockPool(0)
        pool = pc.BlockPool(2)
        b = pool.allocate()
        pool.free(b)
        with pytest.raises(ValueError, match="double free"):
            pool.free(b)
        state = pc.BlockTableState(4, 4, 2)
        with pytest.raises(ValueError, match="static table width"):
            state.ensure(0, 9)
    mirror = port_kv.KVScaleMirror(2)
    with pytest.raises(ValueError, match="out-of-range"):
        mirror.on_allocate(2)
    with pytest.raises(ValueError, match="without a live scale slot"):
        mirror.on_free(0)


def test_kv_byte_accounting_matches_jax():
    import jax.numpy as jnp
    import torch

    for bs, hkv, d in ((16, 8, 80), (4, 2, 32), (8, 1, 128)):
        for mode in ("none", "int8"):
            assert port_kv.kv_block_bytes(bs, hkv, d, mode) == jax_kv.kv_block_bytes(bs, hkv, d, mode)
            assert port_kv.kv_block_bytes(bs, hkv, d, mode, torch.float32) == jax_kv.kv_block_bytes(
                bs, hkv, d, mode, jnp.float32)
            for budget in (1 << 16, 1 << 20, 123456):
                assert port_kv.kv_blocks_for_budget(budget, bs, hkv, d, mode) == jax_kv.kv_blocks_for_budget(
                    budget, bs, hkv, d, mode)
        assert port_kv.kv_scale_bytes_per_block(bs, hkv) == jax_kv.kv_scale_bytes_per_block(bs, hkv)
        # half the budget in int8 holds at least the full budget's bf16 blocks
        assert port_kv.kv_blocks_for_budget(1 << 19, bs, hkv, d, "int8") >= port_kv.kv_blocks_for_budget(
            1 << 20, bs, hkv, d, "none")


@pytest.mark.parametrize("env,setting", [(None, None), (None, "int8"), (None, "off"), ("int8", None),
                                         ("none", "int8"), ("int4", None), (None, "int3")])
def test_quant_kv_mode_resolution_matches_jax(monkeypatch, env, setting):
    if env is None:
        monkeypatch.delenv("MODALITIES_TPU_QUANT_KV", raising=False)
    else:
        monkeypatch.setenv("MODALITIES_TPU_QUANT_KV", env)
    outcomes = []
    for kv in (jax_kv, port_kv):
        try:
            outcomes.append(kv.resolve_quant_kv_mode(setting))
        except ValueError as e:
            outcomes.append(str(e))
    assert outcomes[0] == outcomes[1]

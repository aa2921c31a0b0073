"""Port parity for the paged serving engine: modalities_tpu_torch's
ServingEngine with kv_cache="paged" against the JAX ServingEngine on the same
weights (params_from_jax), on the CPU in f32, on the mixes of JAX
tests/serving/test_paged_engine.py: the packed prefill, the budget clamp to
the table ceiling, truncation, preemption on a dry pool, the free-block
admission gate, the ring's length ceiling lifted, and the construction guards
and environment switches.

Greedy tokens, finish reasons and every scheduling counter that both engines
report must be equal. Sampled tokens cannot match JAX (Threefry against
torch's generator); with eod off a sampled request's length is its budget, so
the schedules still match, and its tokens are held to determinism instead:
the same tokens alone, under preemption and beside others."""

import jax
import numpy as np
import pytest
import torch

from modalities_tpu.serving.engine import ServingEngine as JaxServingEngine
from modalities_tpu.telemetry.metrics import MetricsRegistry
from modalities_tpu_torch.serving import engine as port_engine_module
from modalities_tpu_torch.serving.engine import ServingEngine
from tests.test_torch_gpt2 import jax_and_port

PROMPT = [3, 17, 42, 9, 77, 5, 23]
# the counters of stats() that both engines report and that a schedule fixes
SHARED_STATS = ("decode_steps", "decode_tokens", "max_concurrent", "preemptions", "truncated_requests",
                "decode_executables", "prefill_executables", "free_blocks", "num_blocks", "max_len", "block_size",
                "prefix_hit_requests", "prefix_hit_blocks", "prefix_hit_tokens", "cow_copies", "cow_executables",
                "shared_blocks", "prefix_index_size", "verify_steps", "verify_executables", "spec_proposed",
                "spec_accepted", "prefill_chunk_count", "kv_pool_bytes", "quant_kv", "quant_weights",
                "request_errors", "spec_k", "prefix_sharing", "kv_cache")


@pytest.fixture(scope="module")
def pair():
    """(jax model, jax params, port model, port params): tiny GPT2, f32."""
    return jax_and_port("float32")


def engines(pair, **kwargs):
    jm, jparams, pm, pparams = pair
    kwargs.setdefault("kv_cache", "paged")
    if kwargs["kv_cache"] == "paged":
        kwargs.setdefault("paged_block_size", 8)
    return (JaxServingEngine(jm, jparams, metrics=MetricsRegistry(), **kwargs),
            ServingEngine(pm, pparams, device="cpu", **kwargs))


def serve(engine, reqs):
    rids = [engine.submit(p, b, temperature=t, seed=s) for p, b, t, s in reqs]
    results = engine.run()
    return [results[r] for r in rids]


def compare(pair, reqs, **kwargs):
    """Both engines over `reqs` [(prompt, budget, temperature, seed)]: greedy
    tokens, finish reasons, prefix hits and the shared counters equal.
    Returns (jax results, port results, port engine)."""
    jax_engine, port = engines(pair, **kwargs)
    want, got = serve(jax_engine, reqs), serve(port, reqs)
    for (_, _, temp, _), w, g in zip(reqs, want, got):
        assert g.finish_reason == w.finish_reason
        assert g.truncated == w.truncated and g.prefix_hit_tokens == w.prefix_hit_tokens
        if not temp:
            assert g.tokens == w.tokens
        else:
            assert len(g.tokens) == len(w.tokens)
    jstats, pstats = jax_engine.stats(), port.stats()
    assert {k: pstats[k] for k in SHARED_STATS if k in jstats} == {k: jstats[k] for k in SHARED_STATS if k in jstats}
    if port.kv_cache == "paged":
        assert pstats["free_blocks"] == pstats["num_blocks"]  # every block returned
        port._table_state.check()
    return want, got, port


def test_mixed_batch_matches_jax_one_shape_each(pair):
    reqs = [
        (PROMPT, 10, 0.0, 0),
        ([7, 7, 7], 4, 0.8, 1),
        (list(range(1, 18)), 8, 0.0, 2),  # prompt spans 3 blocks: 3 packed rows
        ([99, 3, 55, 8, 120], 6, 0.8, 3),
        ([11] * 15, 12, 0.0, 4),
        ([4, 2], 5, None, 5),  # the default temperature rides along
    ]
    _, got, port = compare(pair, reqs, max_batch_slots=2)
    assert [r.finish_reason for r in got] == ["budget"] * 6
    stats = port.stats()
    assert stats["decode_executables"] == stats["prefill_executables"] == 1
    assert stats["forward_calls"] == stats["decode_steps"] + port.prefill_dispatches


def test_paged_tokens_equal_the_ring_tokens(pair):
    """One request at a time on both port caches: the same greedy tokens."""
    jm, jparams, pm, pparams = pair
    reqs = [(PROMPT, 10, 0.0, 0), (list(range(1, 18)), 8, 0.0, 2)]
    ring = serve(ServingEngine(pm, pparams, device="cpu", max_batch_slots=1), reqs)
    paged = serve(ServingEngine(pm, pparams, device="cpu", max_batch_slots=1, kv_cache="paged",
                                paged_block_size=8), reqs)
    assert [r.tokens for r in paged] == [r.tokens for r in ring]


def test_budget_clamped_to_the_table_ceiling_never_capacity(pair):
    _, got, _ = compare(pair, [([1, 2, 3, 4], 500, 0.0, 0)], max_batch_slots=1, paged_max_len=16,
                        paged_block_size=4)
    assert got[0].finish_reason == "budget" and len(got[0].tokens) == 16 - 4 + 1


def test_overlong_prompt_truncated_and_clamped(pair):
    _, got, port = compare(pair, [(list(range(1, 21)), 10, 0.0, 0)], max_batch_slots=1, paged_block_size=4,
                           paged_max_len=16)
    assert got[0].truncated and len(got[0].tokens) == 16 - 15 + 1
    assert port.stats()["truncated_requests"] == 1


def test_ring_length_ceiling_lifted(pair):
    """20 prompt tokens + 40 generated overflow the 32-token ring (finish
    "capacity"); paged with paged_max_len 64 runs the whole budget, and the
    ring's shorter run is its prefix."""
    jm, jparams, pm, pparams = pair
    prompt = list(range(1, 21))
    ring = serve(ServingEngine(pm, pparams, device="cpu", max_batch_slots=1), [(prompt, 40, 0.0, 0)])[0]
    assert ring.finish_reason == "capacity"
    _, got, _ = compare(pair, [(prompt, 40, 0.0, 0)], max_batch_slots=1, paged_max_len=64)
    assert got[0].finish_reason == "budget" and len(got[0].tokens) == 40
    assert got[0].tokens[: len(ring.tokens)] == ring.tokens


def test_pool_exhaustion_preempts_youngest_and_replays(pair):
    """A pool one block short of two requests' peak preempts the youngest; it
    restarts from its prompt and its sampler is seeded anew, so its sampled
    tokens equal those of an ample pool."""
    reqs = [(list(range(1, 9)), 15, 0.0, 0), ([5, 9, 2], 20, 0.8, 1)]
    kwargs = dict(max_batch_slots=2, paged_block_size=4, paged_max_len=24)
    _, tight, port = compare(pair, reqs, paged_num_blocks=9, **kwargs)
    assert port.stats()["preemptions"] >= 1
    _, ample, ample_port = compare(pair, reqs, paged_num_blocks=16, **kwargs)
    assert ample_port.stats()["preemptions"] == 0
    assert [r.tokens for r in tight] == [r.tokens for r in ample]
    assert [r.finish_reason for r in tight] == ["budget", "budget"]


def test_admission_gates_on_free_blocks(pair):
    _, got, port = compare(pair, [([1, 2, 3, 4, 5], 8, 0.0, 0), ([9, 8, 7, 6, 5, 4, 3, 2, 1], 8, 0.0, 1)],
                           max_batch_slots=2, paged_block_size=4, paged_max_len=16, paged_num_blocks=4)
    stats = port.stats()
    assert stats["max_concurrent"] == 1 and stats["preemptions"] == 0
    assert got[0].first_token_s < got[1].first_token_s


def test_sampled_tokens_depend_on_the_seed_alone(pair):
    jm, jparams, pm, pparams = pair
    req = ([5, 9, 2, 31, 4], 8, 0.8, 11)

    def alone(**kwargs):
        return serve(ServingEngine(pm, pparams, device="cpu", max_batch_slots=2, kv_cache="paged",
                                   paged_block_size=4, **kwargs), [req])[0].tokens

    batched = serve(ServingEngine(pm, pparams, device="cpu", max_batch_slots=2, kv_cache="paged",
                                  paged_block_size=4), [([1, 2], 6, 0.8, 3), req, ([1, 2, 3], 9, 0.0, 0)])
    assert alone() == batched[1].tokens == alone()
    assert alone(spec_decode={"k": 3}) == batched[1].tokens


def test_construction_guards_match_jax(pair):
    jm, jparams, pm, pparams = pair
    cases = [
        (dict(kv_cache="paged", paged_block_size=4, paged_max_len=32, paged_num_blocks=4), "table width"),
        (dict(kv_cache="flat"), "must be 'ring' or 'paged'"),
        (dict(kv_cache="paged", paged_block_size=0), "paged_block_size"),
        (dict(kv_cache="paged", paged_max_len=1), "paged_max_len must be >= 2"),
        (dict(kv_cache="ring", spec_decode={"k": 2}), "requires kv_cache='paged'"),
        (dict(kv_cache="ring", quant_kv="int8"), "requires kv_cache='paged'"),
        (dict(kv_cache="paged", spec_decode={"k": 2, "drafter": "tree"}), "only 'ngram'"),
    ]
    for kwargs, match in cases:
        with pytest.raises(ValueError, match=match):
            JaxServingEngine(jm, jparams, metrics=MetricsRegistry(), **kwargs)
        with pytest.raises(ValueError, match=match):
            ServingEngine(pm, pparams, device="cpu", **kwargs)
    # prefix sharing quietly falls back on the ring, as in JAX
    assert ServingEngine(pm, pparams, device="cpu", prefix_sharing=True).prefix_sharing is False


def test_paged_max_len_rejected_for_absolute_poe():
    _, _, pm, pparams = jax_and_port("float32", poe_type="ABSOLUTE")
    with pytest.raises(ValueError, match="ABSOLUTE"):
        ServingEngine(pm, pparams, device="cpu", kv_cache="paged", paged_max_len=64)
    assert ServingEngine(pm, pparams, device="cpu", kv_cache="paged", paged_max_len=32).max_len == 32


@pytest.mark.parametrize("name,value,attr,want", [
    ("MODALITIES_TPU_SERVE_KV_CACHE", "paged", "kv_cache", "paged"),
    ("MODALITIES_TPU_SERVE_PREFILL_CHUNKS", "32,8,1", "prefill_chunks", (32, 8, 1)),
    ("MODALITIES_TPU_SERVE_SPEC_K", "3", "spec", 3),
    ("MODALITIES_TPU_SERVE_PREFIX_SHARING", "off", "prefix_sharing", False),
    ("MODALITIES_TPU_QUANT_KV", "int8", "quant_kv", "int8"),
    ("MODALITIES_TPU_QUANT_WEIGHTS", "int8", "quant_weights", "int8"),
])
def test_env_switches_apply_as_in_jax(pair, monkeypatch, name, value, attr, want):
    jm, jparams, pm, pparams = pair
    monkeypatch.setenv(name, value)
    kv_cache = None if name.endswith("KV_CACHE") else "paged"
    port = ServingEngine(pm, pparams, device="cpu", kv_cache=kv_cache, paged_block_size=8)
    jax_engine = JaxServingEngine(jm, jparams, metrics=MetricsRegistry(), kv_cache=kv_cache, paged_block_size=8)
    got, expected = getattr(port, attr), getattr(jax_engine, attr)
    if attr == "spec":
        got, expected = got.k, expected.k
    assert got == expected == want


@pytest.mark.parametrize("name,value,match", [
    ("MODALITIES_TPU_SERVE_KV_CACHE", "vllm", "SERVE_KV_CACHE"),
    ("MODALITIES_TPU_SERVE_PREFILL_CHUNKS", "8,4", "PREFILL_CHUNKS"),
    ("MODALITIES_TPU_SERVE_PREFIX_SHARING", "maybe", "PREFIX_SHARING"),
])
def test_malformed_env_switches_raise_as_in_jax(monkeypatch, name, value, match):
    from modalities_tpu.serving import engine as jax_engine_module

    monkeypatch.setenv(name, value)
    reader = {"MODALITIES_TPU_SERVE_KV_CACHE": "_kv_cache_from_env",
              "MODALITIES_TPU_SERVE_PREFILL_CHUNKS": "_prefill_chunks_from_env",
              "MODALITIES_TPU_SERVE_PREFIX_SHARING": "_prefix_sharing_from_env"}[name]
    for module in (jax_engine_module, port_engine_module):
        with pytest.raises(ValueError, match=match):
            getattr(module, reader)()


@pytest.mark.parametrize("case_seed", [1, 2, 3])
def test_scheduler_property_randomized(pair, case_seed):
    """The JAX scheduler property (test_paged_engine.py:282, its paged cases
    without deadlines and tenants) on the port through a fake clock: every
    request finishes "eod" or "budget" within its budget, slots and blocks
    return to pristine, occupancy matches the decode tokens without
    speculation, admission is FIFO without preemption; and every greedy
    request's tokens equal the JAX engine's on the same trace. Seeds 1 and 3
    squeeze the pool to 8 blocks, seed 2 adds a shared 8-token prefix and k=2
    speculation, seed 3 the int8 pool under the squeeze."""
    jm, jparams, pm, pparams = pair
    rng = np.random.default_rng(1000 + case_seed)
    ticks = {"v": 0.0}

    def clock():
        ticks["v"] += 0.01
        return ticks["v"]

    slots = int(rng.integers(2, 4))
    kwargs = dict(max_batch_slots=slots, kv_cache="paged", paged_block_size=4, paged_max_len=24, paged_num_blocks=8)
    if case_seed == 2:
        kwargs.update(paged_num_blocks=12, spec_decode={"k": 2})
    if case_seed == 3:
        kwargs.update(quant_kv="int8")
    port = ServingEngine(pm, pparams, device="cpu", time_fn=clock, **kwargs)
    shared = [int(x) for x in rng.integers(0, 127, size=8)]  # 2 full blocks
    trace, t = [], 0.0
    for i in range(int(rng.integers(6, 11))):
        t += float(rng.exponential(0.05 if case_seed != 2 else 0.005))
        plen, budget = int(rng.integers(1, 13)), int(rng.integers(1, 9))
        prompt = [int(x) for x in rng.integers(0, 127, size=plen)]
        if case_seed == 2 and (i == 0 or rng.random() < 0.5):
            prompt = shared + prompt[:4]
            if i == 0:
                budget = 12
        trace.append((prompt, budget, float(rng.choice([0.0, 0.8])), i, t))
    rids = [port.submit(p, b, temperature=temp, seed=s, arrival_offset_s=a) for p, b, temp, s, a in trace]
    results = port.run()
    assert sorted(results) == sorted(rids)
    for rid, (_, budget, *_) in zip(rids, trace):
        assert results[rid].finish_reason in ("eod", "budget")
        assert len(results[rid].tokens) <= budget
    assert all(s is None for s in port._slot_states)
    if not port.spec.enabled:
        assert port._occupancy_sum == port.decode_token_count
    stats = port.stats()
    assert 0.0 < stats["slot_occupancy"] <= 1.0
    port._table_state.check()
    assert stats["free_blocks"] == stats["num_blocks"] and port._table_state.active_requests() == []
    if case_seed == 2:
        assert stats["prefix_hit_requests"] >= 1 and stats["verify_steps"] >= 1
        assert stats["shared_blocks"] == 0 and stats["prefix_index_size"] == 0
        assert 0 <= stats["spec_accepted"] <= stats["spec_proposed"]
    if stats["preemptions"] == 0:
        firsts = [results[r].first_token_s for r in sorted(results)]
        assert firsts == sorted(firsts)
    # greedy tokens are the schedule's business nowhere: the JAX engine on the same trace agrees
    greedy = [i for i, (_, _, temp, _, _) in enumerate(trace) if temp == 0.0]
    jax_engine = JaxServingEngine(jm, jparams, metrics=MetricsRegistry(), **kwargs)
    jrids = [jax_engine.submit(trace[i][0], trace[i][1], temperature=0.0, seed=i) for i in greedy]
    jresults = jax_engine.run()
    assert [jresults[r].tokens for r in jrids] == [results[rids[i]].tokens for i in greedy]


def test_non_finite_prefill_row_finishes_error_and_is_never_indexed():
    """A prompt whose embedding row is NaN: its packed-prefill row is
    non-finite, so it finishes "error" with no token and its blocks never
    enter the prefix index (a later request with the same prompt gets no
    hit); the request beside it is served as usual, as in the JAX engine."""
    jm, jparams, pm, pparams = jax_and_port("float32", use_weight_tying=False)
    jparams = jax.tree.map(np.array, jparams)
    jparams["params"]["wte"][99] = np.nan  # token 99's embedding row (the head is untied)
    nan_pair = (jm, jparams, pm, {**pparams, "wte": pparams["wte"].clone().index_fill_(0, torch.tensor([99]),
                                                                                         float("nan"))})
    poisoned = [99] * 8 + [5, 6]
    _, got, port = compare(nan_pair, [(poisoned, 4, 0.0, 0), (PROMPT, 6, 0.0, 1)], max_batch_slots=2,
                           paged_block_size=4)
    assert [r.finish_reason for r in got] == ["error", "budget"] and got[0].tokens == []
    assert port.stats()["request_errors"] == 1
    port = ServingEngine(pm, nan_pair[3], device="cpu", kv_cache="paged", max_batch_slots=2, paged_block_size=4)
    published, register = [], port._table_state.register_prefix
    port._table_state.register_prefix = lambda rid, *args, **kw: (published.append(rid), register(rid, *args, **kw))[1]
    assert [r.finish_reason for r in serve(port, [(poisoned, 4, 0.0, 0), (PROMPT, 6, 0.0, 1)])] == ["error", "budget"]
    assert published == [1]  # only the finite request's prompt blocks entered the index

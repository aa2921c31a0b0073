"""Port parity for prefix sharing with copy-on-write and for speculative
decoding on the paged engine: modalities_tpu_torch's ServingEngine against the
JAX ServingEngine on the same weights, on the CPU in f32, on the mixes of JAX
tests/serving/test_prefix_sharing.py and test_spec_decode.py. Greedy tokens,
finish reasons and the shared counters (prefix hits, copy-on-write copies,
proposals and acceptances, decode steps, preemptions) must be equal; each
feature must also leave the port's own tokens as they are with it off.

`test_spec_mixed_batch_bitwise_with_eod_and_sampled_rider` of the JAX package
fails there (ROADMAP.md, reference caveats), so the mixed spec batch here is
held to the two engines and to the port's spec-off run, not to that test."""

import torch

from modalities_tpu_torch.serving.engine import ServingEngine
from modalities_tpu_torch.serving.spec_decode import SpecDecodeConfig, propose_ngram, resolve_spec_config
from tests.test_torch_paged_engine import compare, pair, serve  # noqa: F401  (pair: the module's fixture)

# 32 deterministic tokens = 4 full blocks at block_size 8: the donor prompt
PREFIX = [(i * 7 + 3) % 127 for i in range(32)]
REPEAT = [1, 2, 3] * 6  # periodic: the drafter fires every step
EOD_PROMPT = [5, 9, 2, 31, 4]  # greedy in f32: six 4s, then 57 (the eod below), mid-run


def _shared_prefix_reqs():
    """JAX test_prefix_sharing.py's scenario through 2 slots: the donor, a
    long request that keeps slot 2 busy past the donor's registration, a
    full-window match (copy-on-write, one re-forwarded token) and a partial
    match (one block)."""
    return [
        (PREFIX + [60, 61, 62], 12, 0.0, 0),
        (list(range(87, 128)), 1, 0.8, 1),
        (PREFIX, 6, 0.0, 0),
        (PREFIX[:8] + [50, 51, 52], 4, 0.8, 3),
    ]


def test_prefix_sharing_forks_cow_and_matches_jax(pair):
    _, got, port = compare(pair, _shared_prefix_reqs(), max_batch_slots=2, paged_max_len=64)
    stats = port.stats()
    assert stats["prefix_hit_requests"] == 2
    assert got[2].prefix_hit_tokens == len(PREFIX) - 1 and got[3].prefix_hit_tokens == 8
    assert stats["prefix_hit_blocks"] == 4 + 1 and stats["cow_copies"] == 1
    assert stats["prefill_executables"] == stats["decode_executables"] == 1
    assert stats["shared_blocks"] == 0 and stats["prefix_index_size"] == 0
    _, off, off_port = compare(pair, _shared_prefix_reqs(), max_batch_slots=2, paged_max_len=64,
                               prefix_sharing=False)
    assert [r.tokens for r in off] == [r.tokens for r in got]  # sampled ones too: the same seeds
    assert off_port.stats()["prefix_hit_requests"] == 0 and off_port.stats()["cow_copies"] == 0


def test_full_window_match_reforwards_the_donors_last_token(pair):
    """The full match's copied block and re-forwarded token: the K/V of the
    block equal the donor's own, bitwise (the last position recomputed by the
    one-token row), and its tokens equal the prompt served alone."""
    _, _, pm, pparams = pair
    kwargs = dict(device="cpu", max_batch_slots=2, kv_cache="paged", paged_block_size=8, paged_max_len=64)
    engine = ServingEngine(pm, pparams, **kwargs)
    donor = engine.submit(PREFIX + [60, 61, 62], 30, temperature=0.0)
    t0 = engine._now()
    while engine._slot_states[0] is None or engine._slot_states[0].phase != "decode":
        engine.step(t0)
    sharer = engine.submit(PREFIX, 6, temperature=0.0)
    engine._admit(t0)
    donor_block, cow_block = engine._table_state.table(donor)[3], engine._table_state.table(sharer)[3]
    assert cow_block != donor_block and engine._slot_states[1].prefill_pos == len(PREFIX) - 1
    engine.step(t0)  # the sharer's one-token row re-forwards position 31 into its copy
    for pool in (engine.cache.k, engine.cache.v):
        assert torch.equal(pool[:, cow_block], pool[:, donor_block])
    results = engine.run()
    alone = serve(ServingEngine(pm, pparams, **kwargs), [(PREFIX, 6, 0.0, 0)])[0]
    assert results[sharer].tokens == alone.tokens and results[sharer].prefix_hit_tokens == len(PREFIX) - 1
    assert engine.stats()["cow_copies"] == 1


def test_preempting_a_sharer_never_frees_donor_blocks(pair):
    reqs = [(PREFIX[:12], 16, 0.0, 0), (list(range(80, 97)), 1, 0.8, 1), (PREFIX[:12] + [33], 14, 0.0, 2)]
    _, got, port = compare(pair, reqs, max_batch_slots=2, paged_block_size=4, paged_max_len=28,
                           paged_num_blocks=9)
    stats = port.stats()
    assert stats["prefix_hit_requests"] == 2 and stats["preemptions"] >= 1
    _, ample, _ = compare(pair, reqs, max_batch_slots=2, paged_block_size=4, paged_max_len=28,
                          paged_num_blocks=20, prefix_sharing=False)
    assert [r.tokens for r in got] == [r.tokens for r in ample]


def test_drafter_and_config_match_jax():
    from modalities_tpu.serving import spec_decode as jax_spec

    contexts = [[1, 2, 3, 1, 2, 3, 1, 2], [5, 6, 7, 9, 5, 6, 7, 8, 5, 6, 7], [4, 9, 9], [1, 2, 3, 4], [7]]
    for ctx in contexts:
        for k in (1, 2, 3, 4):
            assert propose_ngram(ctx, k, 3, 1) == jax_spec.propose_ngram(ctx, k, 3, 1)
    assert propose_ngram([1, 2, 3, 1, 2, 3, 1, 2], k=3, ngram_max=3, ngram_min=1) == [3, 1, 2]
    assert not SpecDecodeConfig().enabled and SpecDecodeConfig(k=4).enabled
    for bad in ({"k": -1}, {"k": 2, "drafter": "tree"}, {"k": 2, "ngram_min": 3, "ngram_max": 2}):
        for cls in (SpecDecodeConfig, jax_spec.SpecDecodeConfig):
            try:
                cls(**bad)
                raised = None
            except ValueError as e:
                raised = str(e)
            assert raised is not None
    assert resolve_spec_config({"k": 2, "ngram_max": 4}).ngram_max == 4
    try:
        resolve_spec_config("fast")
        raise AssertionError("a string spec_decode was accepted")
    except ValueError as e:
        assert "spec_decode must be" in str(e)


def test_spec_greedy_with_budget_clamp_matches_jax(pair):
    """k = 4 on the periodic prompt (near-total acceptance), then a budget of
    3 that cuts an accepted run: tokens, proposals, acceptances and steps as
    the JAX engine's, and the port's spec-off tokens."""
    reqs = [(REPEAT, 14, 0.0, 0), (REPEAT, 3, 0.0, 0)]
    _, got, port = compare(pair, reqs, max_batch_slots=1, spec_decode={"k": 4})
    stats = port.stats()
    assert stats["verify_steps"] > 0 and stats["spec_accepted"] > 0
    assert stats["verify_executables"] == 1 and stats["prefill_executables"] == 1
    assert stats["spec_emitted"] > stats["verify_steps"]  # more than one token per verify forward
    plain = serve(ServingEngine(pair[2], pair[3], device="cpu", max_batch_slots=1, kv_cache="paged",
                                paged_block_size=8), reqs)
    assert [r.tokens for r in got] == [r.tokens for r in plain]
    assert [r.finish_reason for r in got] == ["budget", "budget"]


def test_spec_mixed_batch_with_eod_and_sampled_rider(pair):
    """An accepting greedy slot, a greedy slot whose eod lands inside an
    accepted run, and a sampled slot drawn from column 0 of the verify."""
    _, _, pm, pparams = pair
    probe = serve(ServingEngine(pm, pparams, device="cpu", max_batch_slots=1, kv_cache="paged",
                                paged_block_size=8), [(EOD_PROMPT, 20, 0.0, 0)])[0].tokens
    eod = next(t for i, t in enumerate(probe) if i >= 3 and t not in probe[:i])  # first seen late in the run
    reqs = [(REPEAT, 12, 0.0, 0), (EOD_PROMPT, 20, 0.0, 0), ([7, 7, 7], 6, 0.8, 1)]
    kwargs = dict(max_batch_slots=3, eod_token_id=eod, kv_cache="paged", paged_block_size=8)
    spec = ServingEngine(pm, pparams, device="cpu", spec_decode={"k": 3}, **kwargs)
    got = serve(spec, reqs)
    plain = serve(ServingEngine(pm, pparams, device="cpu", **kwargs), reqs)
    assert [r.tokens for r in got] == [r.tokens for r in plain]
    assert got[1].finish_reason == "eod" and got[1].tokens == probe[: probe.index(eod)]
    stats = spec.stats()
    assert stats["spec_proposed"] > stats["spec_accepted"] >= 0 and stats["verify_executables"] == 1
    assert stats["free_blocks"] == stats["num_blocks"]
    # and the JAX engine on the greedy pair (its sampled rider draws from Threefry)
    compare(pair, reqs[:2], spec_decode={"k": 3}, max_batch_slots=3, eod_token_id=eod)


def test_spec_preemption_replays(pair):
    reqs = [(REPEAT[:12], 11, 0.0, 0), ([4, 9] * 4, 16, 0.0, 1)]
    _, got, port = compare(pair, reqs, max_batch_slots=2, paged_block_size=4, paged_max_len=24,
                           paged_num_blocks=8, spec_decode={"k": 3})
    assert port.stats()["preemptions"] >= 1 and port.stats()["verify_executables"] <= 1
    plain = serve(ServingEngine(pair[2], pair[3], device="cpu", max_batch_slots=2, kv_cache="paged",
                                paged_block_size=4, paged_max_len=24), reqs)
    assert [r.tokens for r in got] == [r.tokens for r in plain]

"""Hot weight swap on the port's engine (modalities_tpu_torch/serving/
engine.py: `swap_weights`, `request_swap`): the three cases of the JAX
package's tests/serving/test_fleet_hot_swap.py on the tiny GPT2 in f32, with
the JAX engine's greedy tokens on the same weights (params_from_jax) as the
reference (sampled tokens cannot match JAX's draws and are held to the
port's own swap-free run):

- a bitwise-identical copy of the weights swapped in every third step while
  requests are in flight changes no token, drops nothing, keeps the one
  decode shape, and moves no installed tensor (addresses and dtypes fixed);
- a NaN generation finishes requests "error"; swapping the donor back (its
  generation moving backward) restores the reference tokens;
- a swap that changes a shape, the parameter names or the quantization is
  refused before anything is copied.
Plus the cross-thread path: `request_swap` from another thread, installed at
a step boundary, flushing the paged engine's prefix index."""

import threading

import pytest
import torch

from modalities_tpu.serving.engine import ServingEngine as JaxServingEngine
from modalities_tpu.telemetry.metrics import MetricsRegistry as JaxMetrics
from modalities_tpu_torch.quant.weights import quantize_params
from modalities_tpu_torch.serving.engine import ServingEngine
from modalities_tpu_torch.telemetry.metrics import parse_prometheus_text
from tests.test_torch_gpt2 import jax_and_port

REQS = [
    ([3, 17, 42, 9], 8, 0.0, 0),
    ([7, 7, 7], 6, 0.8, 1),
    ([99, 3, 55, 8, 120], 8, 0.8, 3),
]


@pytest.fixture(scope="module")
def pair():
    return jax_and_port("float32")


@pytest.fixture(scope="module")
def engine(pair):
    _, _, pm, pparams = pair
    return ServingEngine(pm, pparams, device="cpu", max_batch_slots=2)


def _serve(engine, reqs=REQS):
    rids = [engine.submit(p, b, temperature=t, seed=s) for p, b, t, s in reqs]
    results = engine.run()
    return [results[rid].tokens for rid in rids]


@pytest.fixture(scope="module")
def reference(pair, engine):
    """Swap-free tokens: the JAX engine's for the greedy request, the port's
    own for the sampled ones (asserted equal to JAX's where greedy)."""
    jm, jparams, _, _ = pair
    want = _serve(JaxServingEngine(jm, jparams, max_batch_slots=2, metrics=JaxMetrics()))
    got = _serve(engine)
    assert got[0] == want[0]
    return [want[0], got[1], got[2]]


def test_same_weights_swap_is_bitwise_invisible_and_drops_nothing(pair, engine, reference):
    params_copy = {k: v.clone() for k, v in pair[3].items()}
    installed = {k: (t.data_ptr(), t.dtype) for k, t in engine.module.state_dict().items()}
    rids = [engine.submit(p, b, temperature=t, seed=s) for p, b, t, s in REQS]
    t0 = engine._now()
    swaps_before, steps = engine.weight_swaps, 0
    while engine._queue or engine._active_count():
        engine.step(t0)
        steps += 1
        if steps % 3 == 0:  # every third step, while requests are live
            engine.swap_weights(params_copy)
    assert engine.weight_swaps > swaps_before
    assert any(r["in_flight"] > 0 for r in engine.swap_history)
    results = engine._results
    for rid, expected in zip(rids, reference):
        assert results[rid].tokens == expected
        assert results[rid].finish_reason == "budget"
    assert engine.stats()["decode_executables"] == 1
    gens = [results[rid].weights_generation for rid in rids]
    assert min(gens) >= 1 and max(gens) <= engine.weights_generation
    # the swap copied into the installed tensors: nothing moved, nothing was recast
    assert {k: (t.data_ptr(), t.dtype) for k, t in engine.module.state_dict().items()} == installed


def test_nan_generation_errors_cleanly_then_donor_restores(pair, engine, reference):
    donor = {k: v.clone() for k, v in pair[3].items()}
    donor_gen = engine.weights_generation
    engine.swap_weights({k: torch.full_like(v, float("nan")) for k, v in donor.items()})
    bad_gen = engine.weights_generation
    prompt, budget, temperature, seed = REQS[0]
    rid = engine.submit(prompt, budget, temperature=temperature, seed=seed)
    result = engine.run()[rid]
    assert result.finish_reason == "error" and result.tokens == []
    assert result.weights_generation == bad_gen
    parsed = parse_prometheus_text(engine.metrics.render())
    assert parsed["serve_request_errors_total"][()] >= 1.0
    assert parsed["serve_weights_generation"][()] == float(bad_gen)
    engine.swap_weights(donor, donor_gen)  # rollback: the generation moves backward
    assert engine.weights_generation == donor_gen
    assert _serve(engine) == reference
    assert engine.stats()["decode_executables"] == 1


def test_swap_rejects_architecture_and_quantization_drift(pair, engine):
    params = pair[3]
    before = {k: t.clone() for k, t in engine.module.state_dict().items()}
    with pytest.raises(ValueError, match="does not match"):
        engine.swap_weights({k: torch.zeros(*v.shape, 1) for k, v in params.items()})
    with pytest.raises(ValueError, match="does not match"):
        engine.swap_weights({k: v.double() for k, v in params.items()})
    with pytest.raises(ValueError, match="param tree changed"):
        engine.swap_weights({k: v for k, v in params.items() if k != "wte"})
    with pytest.raises(ValueError, match="quantization mode drift"):
        engine.swap_weights(quantize_params(params, "int8"))
    after = engine.module.state_dict()
    assert all(torch.equal(after[k], before[k]) for k in before)  # nothing was copied


def test_the_engine_never_writes_the_callers_tensors(pair):
    """The engine clones what it would share with the caller's dict, so a
    swap leaves the caller's parameters as they were."""
    _, _, pm, pparams = pair
    kept = {k: v.clone() for k, v in pparams.items()}
    engine = ServingEngine(pm, pparams, device="cpu", max_batch_slots=1)
    engine.swap_weights({k: torch.zeros_like(v) for k, v in pparams.items()})
    assert all(torch.equal(pparams[k], kept[k]) for k in kept)


def test_request_swap_from_another_thread_flushes_the_prefix_index(pair):
    """The paged engine with prefix sharing and int8 weights: a swap queued
    from another thread while the donor decodes is installed at the next step
    boundary (its event set; a superseded one set unapplied), the prefix
    index is flushed (the later sharer forks nothing), and every token stays
    the swap-free run's."""
    _, _, pm, pparams = pair
    knobs = dict(device="cpu", max_batch_slots=2, kv_cache="paged", paged_block_size=4, quant_weights="int8")
    prefix = [5, 9, 11, 23, 40, 41, 42, 43]
    donor, sharer = (prefix + [1, 2], 12, 0.0, 0), (prefix + [3], 5, 0.0, 1)
    reference = ServingEngine(pm, pparams, **knobs)
    want = [_serve(reference, [donor])[0]]
    rid = reference.submit(*donor[:2], temperature=0.0, seed=0)
    t0 = reference._now()
    while not any(s is not None and s.phase == "decode" for s in reference._slot_states):
        reference.step(t0)
    want.append(_serve(reference, [sharer])[0])
    assert reference.run()[rid].tokens == want[0] and reference.stats()["prefix_hit_requests"] == 1

    engine = ServingEngine(pm, pparams, **knobs)
    rid = engine.submit(*donor[:2], temperature=0.0, seed=0)
    t0 = engine._now()
    while not any(s is not None and s.phase == "decode" for s in engine._slot_states):
        engine.step(t0)
    assert engine.stats()["prefix_index_size"] > 0
    done = []
    thread = threading.Thread(target=lambda: done.append(engine.request_swap(quantize_params(pparams, "int8"))))
    thread.start()
    thread.join()
    latest = engine.request_swap(quantize_params(pparams, "int8"), generation=7)
    assert done[0].is_set() and not latest.is_set()  # only the latest pending swap survives
    engine.step(t0)
    assert latest.is_set() and engine.weights_generation == 7 and engine.weight_swaps == 1
    assert engine.swap_history[-1]["prefix_entries_flushed"] > 0 and engine.swap_history[-1]["in_flight"] == 1
    assert _serve(engine, [sharer]) == want[1:]
    assert engine.run()[rid].tokens == want[0]
    stats = engine.stats()
    assert stats["prefix_hit_requests"] == 0 and stats["free_blocks"] == stats["num_blocks"]

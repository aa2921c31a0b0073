"""Checkpoints across ZeRO stages: the tiny GPT2 (f32) on a dp_replicate 2 x
dp_shard 2 gloo world (tests/test_torch_gloo.py: checkpoint_worker,
resume_worker), 2 of 4 steps, a save through the DCP execution, a fresh
build from another seed loaded from the folder.

- the unbroken zero-1 run equals the unbroken zero-0 run within 1e-5;
- a zero-1 folder resumes at zero 1 bitwise (losses, grad norms, lr, final
  parameters);
- a zero-1 folder loads at zero 0 on the same mesh, and a zero-0 folder at
  zero 1: the resumed steps equal the unbroken run's within 1e-5 (the zero-0
  step sums the replicas every microbatch, the zero-1 step once a step: the
  same fp32 sums in another order), so the moments saved under their full
  shapes carry across;
- the topology records name dp_replicate on the zero-1 moments' leaf specs,
  and the diff of the two records is a `leaf_specs` difference, not a
  `mesh_axes` one (JAX `test_zero_topology_record_round_trips`)."""

import numpy as np
import pytest

from modalities_tpu_torch.checkpointing.topology import diff_topology, read_topology
from tests.test_torch_gpt2 import port_config
from tests.test_torch_train_step import OPT, SCHED, TOL

ACC, MB, SEQ, STEPS = 2, 4, 32, 4
DEGREES = {"dp_replicate": 2, "dp_shard": 2}


def _spec(zero: int) -> dict:
    rng = np.random.default_rng(41)
    batches = []
    for _ in range(STEPS):
        tokens = rng.integers(0, 128, size=(ACC, MB, SEQ + 1))
        batches.append({"samples": {"input_ids": tokens[..., :-1]}, "targets": {"target_ids": tokens[..., 1:]}})
    return dict(degrees=DEGREES, zero=zero, acc=ACC, clip=1.0, opt=OPT, sched=SCHED, save_at=2,
                tokens_per_step=ACC * MB * SEQ, batches=batches, seed=0,
                model=port_config(attention_implementation="dao_flash"))


@pytest.fixture(scope="module")
def saved(tmp_path_factory):
    """Each stage's run: the unbroken 4 steps, the save at step 2 and its
    resume at the same stage."""
    from tests.test_torch_gloo import checkpoint_worker, run_world

    return {zero: run_world(4, checkpoint_worker, _spec(zero), str(tmp_path_factory.mktemp(f"zero{zero}")))
            for zero in (0, 1)}


def test_a_zero_1_folder_resumes_at_zero_1_bitwise(saved):
    for r in saved[1]:
        assert len(r["got"]) == len(r["want"]) == STEPS
        for i, (g, w) in enumerate(zip(r["got"], r["want"])):
            assert np.array_equal(g, w), f"step {i + 1}: {g.tolist()} != {w.tolist()}"
    unbroken, resumed = saved[1][0]["finals"]
    for key in unbroken:
        assert np.array_equal(unbroken[key], resumed[key]), key


def test_the_zero_1_steps_equal_the_zero_0_steps(saved):
    """The unbroken runs: the zero-0 step sums each gradient over the
    replicas every microbatch (FSDP2's HSDP all-reduce), the zero-1 step once
    a step, as the reduce-scatter onto its chunks: the same fp32 sums in
    another order, so the two agree within 1e-5 (metrics of every step on
    every rank, the parameters after the 4 steps)."""
    for one, naught in zip(saved[1], saved[0]):
        np.testing.assert_allclose(np.asarray(one["want"]), np.asarray(naught["want"]), **TOL)
    for key, value in saved[0][0]["finals"][0].items():
        np.testing.assert_allclose(saved[1][0]["finals"][0][key], value, err_msg=key, **TOL)


@pytest.mark.parametrize("saved_at,loaded_at", [(1, 0), (0, 1)], ids=["zero1-to-zero0", "zero0-to-zero1"])
def test_a_folder_loads_at_the_other_zero_stage(saved, saved_at, loaded_at):
    from tests.test_torch_gloo import resume_worker, run_world

    folder = saved[saved_at][0]["folder"]
    spec = _spec(loaded_at)
    ranks = run_world(4, resume_worker, {**spec, "batches": spec["batches"][spec["save_at"]:]}, folder)
    for r, unbroken in zip(ranks, saved[saved_at]):
        np.testing.assert_allclose(r, np.asarray(unbroken["want"][spec["save_at"]:]), **TOL)


def test_the_topology_records_name_the_zero_split_and_differ_in_leaf_specs(saved):
    records = {zero: read_topology(saved[zero][0]["folder"]) for zero in (0, 1)}
    assert records[0]["mesh_axes"] == records[1]["mesh_axes"] == DEGREES
    moments = {k: v for k, v in records[1]["leaf_specs"].items() if k.endswith((".exp_avg", ".exp_avg_sq"))}
    assert moments and all("dp_replicate" in v for v in moments.values()), moments
    assert not any("dp_replicate" in v for k, v in records[0]["leaf_specs"].items())
    assert records[1]["leaf_specs"]["optimizer.state.wte.exp_avg"] == "(('dp_replicate', 'dp_shard'), None)"
    mismatches = diff_topology(records[0], records[1])
    assert any("leaf_specs" in m for m in mismatches)
    assert not any("mesh_axes" in m for m in mismatches)

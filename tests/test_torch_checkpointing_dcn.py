"""Checkpoints across slices: the tiny GPT2 (f32) on a dcn 2 x dp_shard 2
gloo world (tests/test_torch_gloo.py: checkpoint_worker), 2 of 4 steps, a
save through the DCP execution (the slices hold the same shards, which DCP
writes once), a fresh build from another seed loaded from the folder.

- the folder resumes at dcn 2 bitwise;
- it loads at dcn 1 (one slice's dp_shard 2 mesh, 2 ranks): without a loss
  mask the slices' token counts are equal, so the mean of the slices' losses
  is the global token mean and the resumed steps equal the unbroken run's
  within 1e-5 (the same fp32 sums in another order);
- the topology record counts the slices: num_slices 2, devices_per_slice 2,
  the sampler's dp degree 4 (dcn folded in, as the JAX record does)."""

import numpy as np
import pytest

from modalities_tpu_torch.checkpointing.topology import read_topology
from tests.test_torch_checkpointing_zero import _spec
from tests.test_torch_train_step import TOL


@pytest.fixture(scope="module")
def saved(tmp_path_factory):
    from tests.test_torch_gloo import checkpoint_worker, run_world

    spec = {**_spec(0), "degrees": {"dcn": 2, "dp_shard": 2}}
    return spec, run_world(4, checkpoint_worker, spec, str(tmp_path_factory.mktemp("dcn")))


def test_a_dcn_2_folder_resumes_bitwise_and_loads_at_dcn_1(saved):
    from tests.test_torch_gloo import resume_worker, run_world

    spec, ranks = saved
    for r in ranks:
        for i, (g, w) in enumerate(zip(r["got"], r["want"])):
            assert np.array_equal(g, w), f"step {i + 1}: {g.tolist()} != {w.tolist()}"
    one_slice = {**spec, "degrees": {"dp_shard": 2}, "batches": spec["batches"][spec["save_at"]:]}
    resumed = run_world(2, resume_worker, one_slice, ranks[0]["folder"])
    for r in resumed:
        np.testing.assert_allclose(r, np.asarray(ranks[0]["want"][spec["save_at"]:]), **TOL)


def test_the_topology_record_counts_the_slices(saved):
    record = read_topology(saved[1][0]["folder"])
    assert record["mesh_axes"] == {"dcn": 2, "dp_shard": 2}
    assert record["slices"] == {"num_slices": 2, "devices_per_slice": 2}
    assert record["sampler_state"]["dp_degree"] == 4

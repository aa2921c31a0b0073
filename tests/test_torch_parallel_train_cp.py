"""The port's train step on context-parallel gloo worlds against the JAX
`TrainStepBuilder` on a mesh of the same degrees and against the port's
world-1 step: tests/test_torch_parallel_train.py's test (same model, steps,
optimizer, batches and tolerances) on

- dp_shard 2 x cp 2, with a loss mask that gives the ranks unequal token
  counts (row 0 of a microbatch keeps its first quarter, row 1 loses its last
  5 targets): the global count divides every rank's sum;
- cp 4 on the 32k config's route: the fused-CE head (chunks of 8, tied head)
  with full remat, each rank's head on its own chunk of the sequence."""

import pytest

from tests.test_torch_parallel_train import check_world

WORLDS = {
    "dp_shard-2-x-cp-2-masked": dict(degrees={"dp_shard": 2, "cp": 2}, mask=True),
    "cp-4-fused-ce-remat": dict(degrees={"cp": 4}, chunk=8, remat=True),
}


@pytest.mark.parametrize("name", list(WORLDS))
def test_the_gloo_world_matches_the_jax_mesh_step_and_the_world_1_step(name):
    check_world(WORLDS[name])

"""The port's train step on a tp 2 x cp 2 gloo world against the JAX
`TrainStepBuilder` on the same mesh and the port's world-1 step:
tests/test_torch_parallel_train.py's test on the 32k config's route, the
fused-CE head (chunks of 8, tied head: wte's vocabulary rows on tp) on each
rank's vocab shard with full remat, the cp ring over local heads, loss
parallelism on."""

from tests.test_torch_parallel_train import check_world


def test_the_gloo_world_matches_the_jax_mesh_step_and_the_world_1_step():
    check_world(dict(degrees={"tp": 2, "cp": 2}, loss_parallel=True, chunk=8, remat=True))

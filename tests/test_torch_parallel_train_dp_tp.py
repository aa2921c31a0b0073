"""The port's train step on a dp_shard 2 x tp 2 gloo world (FSDP2 over dp
of the tp DTensors, a 2-D mesh) with loss parallelism, against the JAX
`TrainStepBuilder` on the same mesh and the port's world-1 step:
tests/test_torch_parallel_train.py's test, with the loss mask that gives the
dp ranks unequal token counts. The grad norm is the world where counting a
tp-replicated gradient (the norm scales) tp times, or a 2-D gradient over
one dim only, gives another number."""

from tests.test_torch_parallel_train import check_world


def test_the_gloo_world_matches_the_jax_mesh_step_and_the_world_1_step():
    check_world(dict(degrees={"dp_shard": 2, "tp": 2}, loss_parallel=True, mask=True))

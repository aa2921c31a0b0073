"""Cross-slice data parallelism composed with ZeRO-1 and HSDP: a dcn 2 x
dp_replicate 2 x dp_shard 2 gloo world (8 ranks) at zero_stage 1 with the
loss mask, against the JAX `TrainStepBuilder` on the same mesh of the 8 CPU
devices: tests/test_torch_parallel_train.py's test (loss, grad norm and lr
of 3 steps, the parameters after them, 1e-5). Each slice normalizes its own
loss (the mask gives the slices unequal token counts), so the world-1 step
is not compared; the dcn reduction runs on the ZeRO chunks."""

from tests.test_torch_parallel_train import check_world


def test_the_dcn_zero_1_world_matches_the_jax_mesh_step():
    check_world(dict(degrees={"dcn": 2, "dp_replicate": 2, "dp_shard": 2}, zero=1, mask=True, mb=8, world_1=False))

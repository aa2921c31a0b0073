"""The port's train step on a dp_shard 2 x tp 2 x cp 2 gloo world (8 ranks)
against the JAX `TrainStepBuilder` on the same mesh over the 8 CPU devices
and the port's world-1 step: tests/test_torch_parallel_train.py's test on the
route of the 7B 32k warmstart recipe (config_7b_warmstart_32k.yaml: dp_shard
x cp x tp), all three axes at once. FSDP2 over dp_shard x cp, the cp ring
over each rank's local heads, the fused-CE head (chunks of 8, tied head:
wte's vocabulary rows on tp) on each rank's vocab shard with full remat, loss
parallelism on, and the loss mask that gives the dp ranks and cp chunks
unequal token counts. Loss, grad norm, lr and the parameters after 3 steps
at 1e-5 (f32)."""

from tests.test_torch_parallel_train import check_world


def test_the_gloo_world_matches_the_jax_mesh_step_and_the_world_1_step():
    check_world(dict(degrees={"dp_shard": 2, "tp": 2, "cp": 2}, loss_parallel=True, chunk=8, remat=True, mask=True))

"""ZeRO-1 composed with context parallelism: a dp_replicate 2 x cp 2 gloo
world at zero_stage 1 with the loss mask, against the JAX
`TrainStepBuilder` at zero_stage 1 on the same mesh of the CPU devices and
against the port's world-1 step: tests/test_torch_parallel_train.py's test
(loss, grad norm and lr of 3 steps, the parameters after them, 1e-5).

FSDP2 shards dim 0 of every parameter over the flattened (dp_shard, cp) mesh
dim, here of size 2, which the rule counts as dp_shard; the cp ring runs
within a replica, and the replicas' sum is the reduce-scatter onto each
rank's chunk. Every leaf of the tiny model takes a ZeRO dim, so each rank
holds moments of half its local shard."""

from tests.test_torch_parallel_train import check_world


def test_the_zero_1_cp_world_matches_the_jax_mesh_step_and_the_world_1_step():
    ranks, _ = check_world(dict(degrees={"dp_replicate": 2, "dp_shard": 1, "cp": 2}, zero=1, mask=True,
                                moments=True))
    for r in ranks:
        assert all(d is not None for d in r["zero_dims"].values()), r["zero_dims"]
        assert all(2 * moment == param for moment, param in r["moments"].values()), r["moments"]

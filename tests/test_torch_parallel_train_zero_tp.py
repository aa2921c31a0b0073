"""ZeRO-1 composed with tensor parallelism: a dp_replicate 2 x tp 2 gloo world
at zero_stage 1 against the JAX `TrainStepBuilder` at zero_stage 1 on the same
mesh of the CPU devices and against the port's world-1 step:
tests/test_torch_parallel_train.py's test (loss, grad norm and lr of 3 steps,
the parameters after them, 1e-5). The ZeRO dim of every leaf skips the dim
tp shards: each tp-sharded kernel's chunk is cut on its other dim."""

from tests.test_torch_parallel_train import check_world


def test_the_zero_1_tp_world_matches_the_jax_mesh_step_and_skips_the_tp_dims():
    ranks, _ = check_world(dict(degrees={"dp_replicate": 2, "dp_shard": 1, "tp": 2}, zero=1, loss_parallel=True,
                                mask=True, moments=True))
    for r in ranks:
        dims = r["zero_dims"]
        assert dims["blocks.0.attn.q_attn.kernel"] == 0  # tp shards dim 1 (the heads)
        assert dims["blocks.0.attn.c_proj.kernel"] == 1  # tp shards dim 0 (row-parallel)
        assert dims["wte"] == 1  # tp shards the vocabulary rows
        assert all(2 * moment == param for moment, param in r["moments"].values())

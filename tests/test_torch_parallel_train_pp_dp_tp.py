"""The port's train step on a pp 2 x dp_shard 2 x tp 2 gloo world (8 ranks)
with the `1f1b` schedule over 4 microbatches, the tied head and the loss
mask that gives the microbatches unequal token counts, against the JAX
`TrainStepBuilder` on the same mesh of the 8 CPU devices (its scheduled
executor) and the port's world-1 step: tests/test_torch_parallel_train.py's
test (loss, grad norm and lr of 3 steps, the parameters after them, 1e-5).

Each stage rank holds its share of the blocks under their global names (the
parameters after the steps are the union of the stages'), the tied `wte` a
copy on each of the two stages whose gradients are summed over pp and whose
norm counts once; each dp rank splits its 4 rows into the 4 microbatches,
where the JAX step splits the global 8. The grad norm is the world's only if
the tied copy is counted once and the stages' squares are summed over pp."""

from tests.test_torch_parallel_train import check_world


def test_the_pp_dp_tp_world_matches_the_jax_mesh_step_and_the_world_1_step():
    check_world(dict(degrees={"pp": 2, "dp_shard": 2, "tp": 2}, loss_parallel=True, mask=True, tied=True, mb=8,
                     n_layer=4, pipeline={"pp_schedule": "1f1b", "pp_num_microbatches": 4}))

"""The port's train step on a pp 2 x dp_shard 2 x cp 2 gloo world (8 ranks)
with the `zbv` schedule, against the JAX `TrainStepBuilder` on the same mesh
of the 8 CPU devices (the route of JAX tests/training/test_train_step.py::
test_dp_pp_cp_scheduled_equivalence: 4 layers, the scheduled executor with
the ring inside it) and the port's world-1 step: tests/test_torch_parallel_
train.py's test (loss, grad norm and lr of 3 steps, the parameters after
them, 1e-5), with the loss mask.

ZBV places the two chunks of each device in a V (device 0 runs global
stages 0 and 3: the embedding and the head, one tied `wte`), runs each B op
for the input gradient alone and every weight gradient in one pass after
the last tick; each stage's blocks attend over the cp ring of its chunk of
the sequence at its global offset.

A reference caveat: the JAX scheduled executor under pp x cp reports a grad
norm cp times the world's (2x here, with zbv and 1f1b alike; its pp x dp
steps and the port's world-1 step agree with each other): its gradients are
summed over cp once in the head's (sum, count) psum and once more after the
scan (modalities_tpu/parallel/pipeline_scheduled.py:637-641). Clipping to
max_norm 1 divides that factor out again, so its losses and parameters are
the world's; the test holds the port's norm to the JAX norm over cp, and
everything else to the JAX step as it is."""

from tests.test_torch_parallel_train import check_world


def test_the_pp_dp_cp_zbv_world_matches_the_jax_mesh_step_and_the_world_1_step():
    check_world(dict(degrees={"pp": 2, "dp_shard": 2, "cp": 2}, mask=True, tied=True, n_layer=4,
                     pipeline={"pp_schedule": "zbv", "pp_num_microbatches": 2, "pp_num_virtual": 2},
                     jax_grad_norm_factor=2.0))

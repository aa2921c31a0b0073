"""The port's train step on tensor-parallel gloo worlds against the JAX
`TrainStepBuilder` on a mesh of the same degrees and against the port's
world-1 step: tests/test_torch_parallel_train.py's test (the same tiny
SwiGLU/RoPE GPT2 of width 128 with 4/2 heads, vocab 128, f32, weights carried
over by `params_from_jax`; the same steps, optimizer, batches and
tolerances) on tp 2:

- with loss parallelism: the untied head's fp32 logits stay sharded over the
  vocabulary and the loss reduces over the tp group;
- without it: the logits are gathered before the loss.

The dp_shard 2 x tp 2 and tp 2 x cp 2 worlds run in files of their own
(tests/test_torch_parallel_train_dp_tp.py, test_torch_parallel_train_tp_cp.py),
one world each, so that each file stays short."""

import pytest

from tests.test_torch_parallel_train import check_world

WORLDS = {
    "tp-2-loss-parallel": dict(degrees={"tp": 2}, loss_parallel=True),
    "tp-2-gathered-logits": dict(degrees={"tp": 2}),
}


@pytest.mark.parametrize("name", list(WORLDS))
def test_the_gloo_world_matches_the_jax_mesh_step_and_the_world_1_step(name):
    check_world(WORLDS[name])

"""Cross-slice data parallelism composed with tensor parallelism, and the
row-parallel bias: a dcn 2 x tp 2 gloo world (each slice one tp pair, loss
parallelism on) of the tiny GPT2 with `bias: true` and the loss mask, against
the JAX `TrainStepBuilder` on the same mesh of the CPU devices:
tests/test_torch_parallel_train.py's test (loss, grad norm and lr of 3 steps,
the parameters after them, 1e-5).

The tp ranks of a slice feed the slice's rows; the tp collectives stay
within the slice, and each slice normalizes its own loss (the world-1 step
is not compared). The c_proj and W_2 biases are added once, after the
reduce-scatter; their gradients, each rank's over its rows, are summed over
tp with the other tp-replicated parameters'."""

import numpy as np
import pytest

from tests.test_torch_parallel_train import check_world


@pytest.fixture(scope="module")
def world():
    return check_world(dict(degrees={"dcn": 2, "dp_shard": 1, "tp": 2}, loss_parallel=True, bias=True, mask=True,
                            world_1=False))


def test_the_dcn_tp_world_matches_the_jax_mesh_step(world):
    ranks, _ = world
    assert len(ranks) == 4 and all(r["metrics"] == ranks[0]["metrics"] for r in ranks)


def test_the_tp_world_with_biases_matches_the_jax_mesh_step(world):
    ranks, params = world
    biases = [k for k in params if k.endswith(("c_proj.bias", "W_2.bias"))]
    assert len(biases) == 4, sorted(params)  # 2 blocks: attention's c_proj and the MLP's W_2
    for key in biases:  # the row-parallel biases trained (check_world held them to the JAX step's)
        assert not np.array_equal(ranks[0]["state"][key], params[key]), key

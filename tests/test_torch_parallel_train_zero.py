"""ZeRO-1 on a dp_replicate 2 x dp_shard 2 gloo world (HSDP, zero_stage 1)
with the loss mask, against the JAX `TrainStepBuilder` at zero_stage 1 on the
same mesh of the CPU devices: tests/test_torch_parallel_train.py's test
(loss, grad norm and lr of 3 steps, the parameters after them, 1e-5; the
world-1 step as well).

Every leaf the rule gives a ZeRO dim (every leaf of the tiny model: each has
a dim divisible by the replica count times its FSDP factor) holds moments of
half its local shard, the port's analogue of the JAX
`test_zero_moment_shards_shrink`. The same steps with both replicas in one
process (`zero_in_process=2`, the card's check of the path: `Zero1` over
`InProcessReplicas`, world 1 without a mesh) equal the gloo world's (loss,
grad norm, lr and parameters, 1e-5). The port's zero-0 world against the
zero-1 world is tests/test_torch_checkpointing_zero.py's (its unbroken
runs)."""

import numpy as np
import torch

from tests.test_torch_gloo import _tiny_step
from tests.test_torch_parallel_train import _batches, _spec, check_world
from tests.test_torch_train_step import TOL

DEGREES = {"dp_replicate": 2, "dp_shard": 2}


def test_the_zero_1_world_matches_the_jax_zero_1_step_and_zero_in_process():
    world = dict(degrees=DEGREES, zero=1, mask=True, moments=True)
    ranks, params = check_world(world)
    for r in ranks:
        halved = [name for name, (moment, param) in r["moments"].items() if 2 * moment == param]
        assert len(halved) == len(r["moments"]) >= 14, r["moments"]
    batches = _batches(True)
    in_process, _ = _tiny_step({**_spec(world, params, batches, None), "zero_in_process": 2}, 1)
    assert in_process.zero.replica.local == [0, 1]
    for batch, want in zip(batches, ranks[0]["metrics"]):
        m = in_process({part: {k: torch.from_numpy(v) for k, v in d.items()} for part, d in batch.items()})
        np.testing.assert_allclose([float(m[k]) for k in ("loss", "grad_norm", "lr")], want, **TOL)
    for key, value in in_process.state_dict().items():
        np.testing.assert_allclose(value.detach().numpy(), ranks[0]["state"][key], err_msg=key, **TOL)

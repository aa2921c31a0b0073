"""The port's ZeRO-1 partition rule (modalities_tpu_torch/parallel/zero.py)
against the JAX `zero_partition_spec`, with no process group:

- for every parameter of the tiny GPT2, with the spec the JAX step gives it
  on the hsdp mesh of tests/training/test_zero_sharding.py (dp_replicate 2 x
  dp_shard 4) and on the dcn mesh of tests/training/test_dcn_hierarchical.py
  (dcn 2 x dp_replicate 2 x dp_shard 2), the port's rule widens the spec as
  the JAX rule does (the same dim, the same spelling), and never with dcn;
- the JAX suite's own cases: a dim that already carries dp_shard is widened
  to (dp_replicate, dp_shard), an unsharded leaf takes its largest divisible
  dim, an indivisible one stays as it is, model-parallel dims are skipped,
  and without a replica axis the rule is inert;
- the tiny GPT2's world-1 step with ZeRO-1 over 4 replicas in this process
  (`TrainStep(zero_in_process=4)`: parallel/zero.py's `Zero1` over
  `InProcessReplicas`), 3 steps without clipping, against the same step at
  stage 0: the losses and rates bitwise, the norm over the chunks the whole
  leaves' to rounding (1e-6), the parameters after the steps bitwise, and
  every replica's moments a quarter of the leaf, bitwise the matching chunk
  of the stage-0 moments."""

import jax
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from modalities_tpu.parallel.sharding import zero_partition_spec as jax_zero_partition_spec
from modalities_tpu.running_env.device_mesh import get_device_mesh
from modalities_tpu_torch.parallel.zero import chunk, zero_dim, zero_partition_spec
from tests.models.test_gpt2_model import tiny_gpt2
from tests.training.test_train_step import _builder

MESHES = {
    "hsdp": dict(data_parallel_replicate_degree=2, data_parallel_shard_degree=4),
    "dcn": dict(data_parallel_replicate_degree=2, data_parallel_shard_degree=2, dcn_parallel_degree=2),
}


def _sizes(mesh) -> dict[str, int]:
    return dict(zip(mesh.axis_names, mesh.devices.shape))


@pytest.mark.parametrize("name", list(MESHES))
def test_the_rule_widens_every_tiny_gpt2_leaf_as_the_jax_rule(name):
    handle = get_device_mesh(device_type="cpu", world_size=8, zero_stage=1, **MESHES[name])
    state = _builder(tiny_gpt2("pytorch_flash"), handle, clip=1.0).build(seed=0).app_state_handle.state
    for path, leaf in jax.tree_util.tree_leaves_with_path(state.params):
        spec = tuple(leaf.sharding.spec)
        want = tuple(jax_zero_partition_spec(tuple(leaf.shape), leaf.sharding.spec, handle.mesh))
        got = zero_partition_spec(tuple(leaf.shape), spec, _sizes(handle.mesh))
        assert got == want, jax.tree_util.keystr(path)
        assert "dcn" not in str(got)
        if leaf.ndim >= 2:  # every kernel (the JAX suite's `test_zero_moment_shards_shrink`)
            assert zero_dim(tuple(leaf.shape), spec, _sizes(handle.mesh)) is not None, jax.tree_util.keystr(path)


def test_the_rule_cases_of_the_jax_suite():
    sizes = {"dp_replicate": 2, "dp_shard": 4}
    assert zero_partition_spec((64, 32), ("dp_shard", None), sizes) == (("dp_replicate", "dp_shard"), None)
    assert zero_partition_spec((16, 64), (), sizes) == (None, "dp_replicate")
    assert zero_partition_spec((3, 5), (), sizes) == ()
    spec = (("dp_replicate", "dp_shard"), None)
    assert zero_partition_spec((64, 32), spec, sizes) == spec
    assert zero_dim((64, 32), ("dp_shard", None), sizes) == 0 and zero_dim((3, 5), (), sizes) is None


def test_the_rule_skips_model_parallel_dims_and_is_inert_without_replicas():
    sizes = {"dp_replicate": 2, "dp_shard": 2, "tp": 2, "cp": 1}
    assert zero_partition_spec((64, 32), ("tp", None), sizes) == ("tp", "dp_replicate")
    assert zero_partition_spec((64, 32), ("tp", "cp"), sizes) == ("tp", "cp")
    assert zero_partition_spec((64, 32), ("dp_shard", None), {"dp_replicate": 1, "dp_shard": 8}) == ("dp_shard", None)
    for shape, spec in (((64, 32), P("tp", None)), ((64, 32), P("tp", "cp")), ((16, 64), P()), ((3, 5), P())):
        mesh = get_device_mesh(device_type="cpu", data_parallel_replicate_degree=2, data_parallel_shard_degree=2,
                               tensor_parallel_degree=2, world_size=8, zero_stage=1).mesh
        assert zero_partition_spec(shape, tuple(spec), _sizes(mesh)) == tuple(jax_zero_partition_spec(shape, spec, mesh))


def test_zero_in_process_updates_the_chunks_as_the_whole_step():
    from tests.test_torch_gloo import _tiny_step
    from tests.test_torch_parallel_train import _batches, _spec

    spec = {**_spec(dict(degrees=None), None, _batches(True), None), "clip": 1e9}  # never clips: bitwise
    whole, _ = _tiny_step(spec, 1)
    step, _ = _tiny_step({**spec, "zero_in_process": 4}, 1)
    zero = step.zero
    assert zero.replica.replicas == 4 and zero.replica.local == [0, 1, 2, 3]
    assert all(d is not None for d in zero.dims), zero.dims  # every tiny GPT2 leaf has a dim divisible by 4
    for batch in spec["batches"]:
        batch = {part: {k: torch.from_numpy(v) for k, v in d.items()} for part, d in batch.items()}
        want, got = whole(batch), step(batch)
        assert torch.equal(got["loss"], want["loss"]) and torch.equal(got["lr"], want["lr"])
        # the chunks' squares summed in another order than the whole leaves': equal to rounding
        torch.testing.assert_close(got["grad_norm"], want["grad_norm"], rtol=1e-6, atol=0)
    for key, value in whole.state_dict().items():
        assert torch.equal(step.state_dict()[key], value), key
    for (i, r), buffer in zip(zero.slots, zero.buffers):
        assert buffer.numel() * 4 == step.params[i].numel()
        for key in ("exp_avg", "exp_avg_sq"):
            want = whole.optimizer.state[whole.params[i]][key]
            assert torch.equal(step.optimizer.state[buffer][key], chunk(want, zero.dims[i], 4, r)), (zero.names[i], r)

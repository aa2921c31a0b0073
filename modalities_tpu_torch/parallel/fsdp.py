"""FSDP2 over the device mesh: the port of the `fsdp2_wrapped` variant's
sharding (modalities_tpu/parallel/sharding.py, models/model_factory.py:34).

Where GSPMD shards each parameter over dp_shard and leaves it replicated over
cp, so that gradients sum over both, `fully_shard` here shards every
parameter over one group made of the dp_shard and cp dims (flattened), and
with dp_replicate > 1 replicates it over dp_replicate (HSDP, a 2-D mesh).
Units: each group of `layers_per_fsdp_unit` transformer blocks, then the
root (embeddings, head).

Under tensor parallelism the parameters are already DTensors over the tp
dim of the same mesh, and FSDP2 shards each over the dp dims besides (2-D).

FSDP2 needs one dtype per unit, and the port stores matmul weights in the
policy's param dtype and norm parameters in fp32 (as flax does). Each module
whose parameters are in another dtype than most of its unit's is therefore
sharded as a unit of its own, inside its unit (in the GPT2 model: every
norm).

Under ZeRO-1 the mesh holds the FSDP dim only (`DeviceMesh.fsdp_mesh`):
each microbatch's gradients are reduce-scattered within a replica, and the
sum over dp_replicate happens once a step, as ZeRO's reduce-scatter
(parallel/zero.py).

Gradients: the reduction sums (divide factor 1, sum-only collectives) in the
policy's `reduce_dtype`; the train step divides each rank's loss by the
global token count, so the sum is the gradient of the global loss. Forward
methods other than `forward` that the train step calls (`train_forward` of a
block, `forward_hidden` and `stage_forward` of the model) are registered
with FSDP2, so they gather their unit's parameters as `forward` does.

Under pipeline parallelism the module is one pp rank's stage
(parallel/pipeline.py): its blocks and, where the stage holds them, the
embeddings, `lm_head_norm` and the head, so the root unit exists only on the
stages that hold those.
"""

from __future__ import annotations

import collections
from typing import Optional

import torch
from torch import nn


def _minority_dtype_modules(unit: list[nn.Module]) -> list[nn.Module]:
    """The submodules of `unit` (not inside a module already sharded) whose
    own parameters are in another dtype than most of the unit's parameter
    elements (a tensor-parallel DTensor counts its local elements)."""
    from torch.distributed.fsdp import FSDPModule
    from torch.distributed.tensor import DTensor

    elements: collections.Counter = collections.Counter()
    owners = []
    stack = list(unit)
    while stack:
        sub = stack.pop()
        own = list(sub.parameters(recurse=False))
        if own:
            owners.append((sub, {p.dtype for p in own}))
            for p in own:
                elements[p.dtype] += p.to_local().numel() if isinstance(p, DTensor) else p.numel()
        stack.extend(child for child in sub.children() if not isinstance(child, FSDPModule))
    if len(elements) < 2:
        return []
    major = elements.most_common(1)[0][0]
    return [sub for sub, dtypes in owners if major not in dtypes]


def shard_model(module: nn.Module, mesh, *, layers_per_fsdp_unit: Optional[int] = None,
                reshard_after_forward: bool = True, reduce_dtype: torch.dtype = torch.float32) -> nn.Module:
    """`fully_shard` the GPT2 module in place (blocks by units, then the
    root) over `mesh` (running_env.device_mesh.DeviceMesh.fsdp_mesh); returns it."""
    from torch.distributed.fsdp import FSDPModule, MixedPrecisionPolicy, fully_shard, register_fsdp_forward_method

    policy = MixedPrecisionPolicy(param_dtype=None, reduce_dtype=reduce_dtype)

    def shard(modules, reshard):
        for minority in _minority_dtype_modules(modules):
            fully_shard(minority, mesh=mesh, reshard_after_forward=reshard, mp_policy=policy)
        fully_shard(modules if len(modules) > 1 else modules[0], mesh=mesh, reshard_after_forward=reshard,
                    mp_policy=policy)

    blocks = list(module.blocks)
    per_unit = max(int(layers_per_fsdp_unit or 1), 1)
    for start in range(0, len(blocks), per_unit):
        unit = blocks[start:start + per_unit]
        shard(unit, reshard_after_forward)
        for block in unit:
            register_fsdp_forward_method(block, "train_forward")
    # the root keeps its parameters gathered from its forward to its backward (FSDP2's own choice for a root):
    # the train step reads the head weight after `forward_hidden` returns
    shard([module], False)
    register_fsdp_forward_method(module, "forward_hidden")
    register_fsdp_forward_method(module, "stage_forward")
    for sub in module.modules():
        if isinstance(sub, FSDPModule):
            sub.set_gradient_divide_factor(1.0)
            sub.set_force_sum_reduction_for_comms(True)
    return module

"""ZeRO-1: optimizer-state sharding over dp_replicate, the port of
modalities_tpu/parallel/sharding.py:180-250 (`zero_partition_spec`,
`zero_params_shardings`) and of the ZeRO parts of
modalities_tpu/training/train_step.py (:261-275, :590-596, :651-654).

The rule (`zero_partition_spec`, the JAX function's copy): each gradient and
AdamW moment gets the replica axis on its largest dim that is not sharded
over a model-parallel axis (tp, cp, pp, dcn) and divides by the dim's shard
factor times the replica count; ties go to the dim that carries dp_shard,
then to the lower index. A leaf with no such dim keeps the parameter's
layout. The train step applies it to the port's placements
(`param_spec`): FSDP2 shards dim 0 of every parameter over dp_shard x cp
flattened into one mesh dim, which counts here as the dp_shard axis (its
size the flattened dim's), where GSPMD shards the `embed` dim over dp_shard
alone.

`Zero1` runs it on a train step's parameters. FSDP2 shards them within a
replica (over the FSDP dim alone, `DeviceMesh.fsdp_mesh`) and sums nothing
over dp_replicate, so after the accumulation loop each fp32 accumulator is
a partial sum over the replicas; `reduce_scatter` sums it over the
replicas onto this rank's chunk of the ZeRO dim of its local shard (a leaf
without a ZeRO dim is all-reduced). The optimizer (the config's,
`OptimizerSpec.build`) holds one contiguous buffer a ZeRO leaf, this rank's
chunk of the parameter's local shard (refreshed from the parameter before
every update), and the local shard itself for the other leaves: its moments
are allocated at chunk size. `step` runs it, then one all-gather a ZeRO
leaf writes the updated chunks back into the parameter, which stays
replicated over dp_replicate (ZeRO-1, not ZeRO-3). AdamW is elementwise, so
the chunks' update is the unsplit update's, element for element.

The three collectives go through a replica transport, as the pipeline's
hops do: `ReplicaGroup` over the dp_replicate process group, or
`InProcessReplicas`, which holds every replica's chunks in this process
(`TrainStep(zero_in_process=R)`: the card's check of this class at full
width, on one GPU).

The chunks are DTensors of the parameter's global shape for the norm and the
checkpoint (`dtensor`), over the parameter's mesh with dp_replicate in
front: Shard(zero dim) on the replica dim, then the parameter's placements;
where the ZeRO dim is FSDP2's dim 0 (the chunk is cut from the FSDP shard, a
nested split) the replica dim's placement is `_StridedShard(0,
split_factor=the FSDP dim's size)`, the placement FSDP2 itself gives a dim
that tp cut first. `state_dict` gives the optimizer's state flattened by
parameter name exactly as `get_state_dict` does at stage 0 (`state.<fqn>.
exp_avg`, `param_groups.<fqn>.lr`), with the moments under their logical
full shapes: a folder loads at either stage, and a save gathers no moment.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor, Shard

REPLICA_AXIS = "dp_replicate"
# axes of model parallelism: the replica axis never joins a dim they shard (sharding.py:181-187)
MODEL_PARALLEL_AXES = frozenset({"tp", "cp", "pp", "dcn"})


def _axes(entry) -> tuple[str, ...]:
    if entry is None:
        return ()
    return entry if isinstance(entry, tuple) else (entry,)


def zero_partition_spec(shape: tuple[int, ...], spec: tuple, axis_sizes: dict[str, int]) -> tuple:
    """The JAX `zero_partition_spec` on a spec spelled as a tuple (one entry a
    dim: None, an axis name, or a tuple of names) and the mesh's axis sizes:
    the spec with dp_replicate prepended on the chosen dim, or `spec`
    unchanged."""
    replica = axis_sizes.get(REPLICA_AXIS, 1)
    if replica <= 1:
        return tuple(spec)
    entries = list(spec) + [None] * (len(shape) - len(spec))
    if any(REPLICA_AXIS in _axes(e) for e in entries):
        return tuple(spec)
    best = None  # (dim size, carries dp_shard, -index): the largest wins, dp_shard breaks ties
    for i, dim in enumerate(shape):
        axes = _axes(entries[i])
        if any(a in MODEL_PARALLEL_AXES for a in axes):
            continue
        factor = math.prod(axis_sizes[a] for a in axes)
        if dim % (factor * replica):
            continue
        key = (dim, "dp_shard" in axes, -i)
        if best is None or key > best[0]:
            best = (key, i)
    if best is None:
        return tuple(spec)
    i = best[1]
    existing = _axes(entries[i])
    entries[i] = (REPLICA_AXIS, *existing) if existing else REPLICA_AXIS
    return tuple(entries)


def zero_dim(shape: tuple[int, ...], spec: tuple, axis_sizes: dict[str, int]) -> Optional[int]:
    """The dim `zero_partition_spec` gives the replica axis, or None."""
    widened = zero_partition_spec(shape, spec, axis_sizes)
    padded = tuple(spec) + (None,) * (len(widened) - len(spec))
    return next((i for i, (new, old) in enumerate(zip(widened, padded)) if new != old), None)


def param_spec(p: DTensor, replicas: int) -> tuple[tuple, dict[str, int]]:
    """A parameter's spec and axis sizes from its placements over the port's
    mesh (within a replica), for the rule: the FSDP dim (`dp_shard_cp` under
    cp) counts as dp_shard, of its own size; a plain tensor is a whole leaf."""
    if not isinstance(p, DTensor):
        return (), {REPLICA_AXIS: replicas}
    mesh = p.device_mesh
    names = [("dp_shard" if n == "dp_shard_cp" else n) for n in mesh.mesh_dim_names]
    sizes = {**dict(zip(names, mesh.shape)), REPLICA_AXIS: replicas}
    entries: list = [()] * p.ndim
    for name, placement in zip(names, p.placements):
        if not (placement.is_replicate() or placement.is_partial()):  # Shard, or FSDP2's _StridedShard under tp
            entries[placement.dim] = entries[placement.dim] + (name,)
    return tuple(e[0] if len(e) == 1 else (e or None) for e in entries), sizes


def chunk(t: torch.Tensor, dim: int, replicas: int, index: int) -> torch.Tensor:
    """Replica `index`'s chunk of a local shard along `dim` (a view)."""
    return t.chunk(replicas, dim=dim)[index]


def _placements(p: DTensor, dim: Optional[int]) -> tuple:
    """Leaf placements over (dp_replicate, the parameter's mesh dims): the
    replica dim shards `dim`, after the parameter's dims that shard it too
    (the nested split); a leaf without a ZeRO dim is replicated over it."""
    from torch.distributed.tensor import Replicate
    from torch.distributed.tensor.placement_types import _StridedShard

    if dim is None:
        return (Replicate(), *p.placements)
    inner = [i for i, q in enumerate(p.placements) if not (q.is_replicate() or q.is_partial()) and q.dim == dim]
    rep = _StridedShard(dim, split_factor=math.prod(p.device_mesh.shape[i] for i in inner)) if inner else Shard(dim)
    return (rep, *p.placements)


def _contiguous_stride(shape) -> tuple[int, ...]:
    return torch.empty(shape, device="meta").stride()


def _local(t: torch.Tensor) -> torch.Tensor:
    return t.to_local() if isinstance(t, DTensor) else t


class ReplicaGroup:
    """The replicas as the dp_replicate process group: this rank holds one
    replica's chunks, its own."""

    def __init__(self, group):
        self.group = group
        self.replicas, self.local = group.size(), [group.rank()]

    def all_reduce(self, a: torch.Tensor) -> None:
        dist.all_reduce(a, group=self.group)

    def reduce_scatter(self, a: torch.Tensor, dim: int) -> list[torch.Tensor]:
        moved = a.movedim(dim, 0).contiguous()
        part = moved.new_empty((moved.shape[0] // self.replicas,) + tuple(moved.shape[1:]))
        dist.reduce_scatter_tensor(part, moved, group=self.group)
        return [part.movedim(0, dim).contiguous()]

    def all_gather(self, chunks: list[torch.Tensor], dim: int) -> torch.Tensor:
        moved = chunks[0].movedim(dim, 0).contiguous()
        whole = moved.new_empty((moved.shape[0] * self.replicas,) + tuple(moved.shape[1:]))
        dist.all_gather_into_tensor(whole, moved, group=self.group)
        return whole.movedim(0, dim)


class InProcessReplicas:
    """Every replica in this process (`TrainStep(zero_in_process=R)`, the
    card's check of ZeRO-1: the card has one H100, and NCCL refuses two ranks
    on one GPU). The process's accumulator already sums every replica's rows,
    so the reductions hand it over as it is: the reduce-scatter cuts it into
    the replicas' chunks, and the all-gather concatenates the chunks."""

    def __init__(self, replicas: int):
        self.replicas, self.local = replicas, list(range(replicas))

    def all_reduce(self, a: torch.Tensor) -> None:
        pass

    def reduce_scatter(self, a: torch.Tensor, dim: int) -> list[torch.Tensor]:
        return [c.contiguous() for c in a.chunk(self.replicas, dim=dim)]

    def all_gather(self, chunks: list[torch.Tensor], dim: int) -> torch.Tensor:
        return torch.cat(chunks, dim=dim)


class Zero1:
    """ZeRO-1 over the dp_replicate dim of `mesh` (the run's torch mesh) for
    the (name, parameter) pairs of a train step: every parameter a DTensor of
    FSDP2 over a sub-mesh of `mesh` without dp_replicate. Without a mesh,
    `replicas` replicas in this process (`InProcessReplicas`) over the
    parameters of a world-1 step.

    The optimizer's tensors are the slots: (leaf, replica) for each replica
    this process holds of a ZeRO leaf, (leaf, None) for a leaf without a ZeRO
    dim; `buffers[k]` is slot k's tensor and `owners[k]` its parameter."""

    def __init__(self, named_parameters, optimizer_spec, mesh=None, *, replicas: Optional[int] = None):
        named = list(named_parameters)
        self.names = [n for n, _ in named]
        self.params = [p for _, p in named]
        self.mesh = mesh
        self.replica = ReplicaGroup(mesh[REPLICA_AXIS].get_group()) if mesh is not None else InProcessReplicas(replicas)
        R = self.replica.replicas
        self.dims: list[Optional[int]] = []
        self.meshes, self.placements = [], []
        self.slots: list[tuple[int, Optional[int]]] = []
        buffers = []
        with torch.no_grad():
            for i, p in enumerate(self.params):
                d = zero_dim(tuple(p.shape), *param_spec(p, R))
                self.dims.append(d)
                if mesh is not None:
                    self.meshes.append(mesh[(REPLICA_AXIS, *p.device_mesh.mesh_dim_names)])
                    self.placements.append(_placements(p, d))
                local = _local(p).detach()
                for r in ([None] if d is None else self.replica.local):
                    self.slots.append((i, r))
                    buffers.append(local if r is None else chunk(local, d, R, r).clone(
                        memory_format=torch.contiguous_format))
        self.buffers = buffers
        self.owners = [self.params[i] for i, _ in self.slots]
        self._by_buffer = {id(b): k for k, b in enumerate(buffers)}
        self.optimizer = optimizer_spec.build((self.names[i], b) for (i, _), b in zip(self.slots, buffers))

    def dtensor(self, k: int, local: torch.Tensor) -> DTensor:
        """A local tensor of slot k's layout as a DTensor of its parameter's
        global shape (sharing `local`'s storage)."""
        i = self.slots[k][0]
        p = self.params[i]
        return DTensor.from_local(local, self.meshes[i], self.placements[i], shape=p.shape,
                                  stride=_contiguous_stride(p.shape), run_check=False)

    @torch.no_grad()
    def reduce_scatter(self, acc: list[torch.Tensor]) -> list[torch.Tensor]:
        """Each accumulator (a parameter's; a partial sum over the replicas)
        summed over them, slot by slot: each held replica's chunk of its ZeRO
        dim, or the whole local shard for a leaf without one (all-reduced)."""
        out = []
        for a, d in zip(acc, self.dims):
            if d is None:
                self.replica.all_reduce(a)
                out.append(a)
            else:
                out.extend(self.replica.reduce_scatter(a, d))
        return out

    def set_grads(self, grads: list[torch.Tensor]) -> list[torch.Tensor]:
        """Give the optimizer's buffers their gradients (slot by slot, in the
        owners' dtype); returns them for the norm and clipping, each element
        once: as DTensors (same storage) over the mesh, as they are in
        process (every replica's chunks, a leaf without a ZeRO dim once)."""
        for b, g in zip(self.buffers, grads):
            b.grad = g
        if self.mesh is None:
            return list(grads)
        return [self.dtensor(k, g) for k, g in enumerate(grads)]

    @torch.no_grad()
    def step(self) -> None:
        """The update on the chunks, then one all-gather a ZeRO leaf back into
        the parameter's local shard."""
        R = self.replica.replicas
        for (i, r), b in zip(self.slots, self.buffers):
            if r is not None:  # the chunk of the parameter as it stands (a checkpoint load writes the parameters)
                b.copy_(chunk(_local(self.params[i]), self.dims[i], R, r))
        self.optimizer.step()
        gathered: dict[int, list[torch.Tensor]] = {}
        for (i, r), b in zip(self.slots, self.buffers):
            b.grad = None
            if r is not None:
                gathered.setdefault(i, []).append(b)
        for i, chunks in gathered.items():
            _local(self.params[i]).copy_(self.replica.all_gather(chunks, self.dims[i]))

    def _init_state(self) -> None:
        """Create the moments where no step has run yet, as `get_state_dict`
        does: one update at lr 0 on zero gradients."""
        if self.optimizer.state:
            return
        lrs = [g["lr"] for g in self.optimizer.param_groups]
        for b in self.buffers:
            b.grad = torch.zeros_like(b)
        for g in self.optimizer.param_groups:
            g["lr"] = 0.0
        self.optimizer.step()
        for g, lr in zip(self.optimizer.param_groups, lrs):
            g["lr"] = lr
        for b in self.buffers:
            b.grad = None

    def state_dict(self) -> dict:
        """The optimizer's state flattened by parameter name (the stage-0
        `get_state_dict` layout): moments as DTensors of the parameters'
        global shapes over this rank's chunks (the optimizer's own tensors,
        so a DCP load writes into them), the step count and each group's
        hyperparameters under every one of its parameters' names."""
        if self.mesh is None:
            raise ValueError("ZeRO-1 over in-process replicas has no checkpoint layout: save from a mesh")
        self._init_state()
        out: dict = {}
        for group in self.optimizer.param_groups:
            for b in group["params"]:
                k = self._by_buffer[id(b)]
                for key, value in self.optimizer.state[b].items():
                    out[f"state.{self.names[self.slots[k][0]]}.{key}"] = (self.dtensor(k, value) if value.ndim
                                                                         else value)
            for b in group["params"]:
                name = self.names[self.slots[self._by_buffer[id(b)]][0]]
                out.update({f"param_groups.{name}.{k}": v for k, v in group.items() if k != "params"})
        return out

    def load_state_dict(self, state: dict) -> None:
        """Take a loaded `state_dict()`: the tensors were read into the
        optimizer's own; each group takes its hyperparameters."""
        for group in self.optimizer.param_groups:
            name = self.names[self.slots[self._by_buffer[id(group["params"][0])]][0]]
            for key in [k for k in group if k != "params"]:
                group[key] = state[f"param_groups.{name}.{key}"]

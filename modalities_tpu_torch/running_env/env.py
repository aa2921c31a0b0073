"""The process group: the port of modalities_tpu/running_env/env.py.

`python -m torch.distributed.run --nproc_per_node N -m modalities_tpu_torch run
...` starts one process per card and sets RANK, WORLD_SIZE, LOCAL_RANK,
MASTER_ADDR and MASTER_PORT; `init_process_group` reads them, selects card
LOCAL_RANK and joins the group through the launcher's store. Without a
launcher it builds a world-1 group on an in-process store, so one process
goes through the same distributed code as many.

On the card the group's backend is NCCL for CUDA tensors, with gloo beside it
for the CPU objects `torch.distributed.checkpoint` exchanges (its async save
requires a CPU backend); for `device="cpu"` the group is gloo. Nothing falls
back from one backend to the other.
"""

from __future__ import annotations

import contextlib
import os
from typing import Iterator

import torch
import torch.distributed as dist

_LAUNCHER_VARS = ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT")


def launched() -> bool:
    """Whether a launcher (torch.distributed.run or an equivalent) set the
    rendezvous variables of this process."""
    return all(name in os.environ for name in _LAUNCHER_VARS)


def local_rank() -> int:
    return int(os.environ.get("LOCAL_RANK", 0))


def rank() -> int:
    """This process's global rank: the group's, else the launcher's, else 0."""
    if dist.is_initialized():
        return dist.get_rank()
    return int(os.environ.get("RANK", 0))


def world_size() -> int:
    if dist.is_initialized():
        return dist.get_world_size()
    return int(os.environ.get("WORLD_SIZE", 1))


def init_process_group(device: torch.device) -> bool:
    """Join (or, without a launcher, build) the default process group for
    `device`. Returns whether this call created it; a group that already
    exists is left as it is and must serve `device`."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", local_rank())
    if dist.is_initialized():
        if device.type == "cuda" and dist.get_backend() == "gloo":
            raise RuntimeError("a gloo-only process group exists, but the run is on the card (NCCL)")
        return False
    backend = "cpu:gloo,cuda:nccl" if device.type == "cuda" else "gloo"
    if device.type == "cuda":
        torch.cuda.set_device(device)
    if launched():
        dist.init_process_group(backend, init_method="env://", rank=int(os.environ["RANK"]),
                                world_size=int(os.environ["WORLD_SIZE"]))
    else:
        dist.init_process_group(backend, store=dist.HashStore(), rank=0, world_size=1)
    return True


def destroy_process_group() -> None:
    if dist.is_initialized():
        dist.destroy_process_group()
    clear_dtensor_caches()


def clear_dtensor_caches() -> None:
    """Forget DTensor's sharding decisions. DTensor caches them (in C++ and
    in Python) keyed by DeviceMesh equality, which compares layouts, ranks and
    dim names but not process-group names: after the group is torn down, a
    new run whose tp mesh equals the old one would get back specs holding the
    old mesh (`nn.Parameter(dtensor)` goes through that cache), and its first
    collective over them names a group that no longer exists. The caches
    differ between torch versions: each one this build has is cleared."""
    from torch.distributed.tensor import DTensor
    from torch.distributed.tensor import _redistribute

    propagator = DTensor._op_dispatcher.sharding_propagator
    for clear in (getattr(torch._C, "_clear_DTensor_sharding_propagator_cache", None),
                  getattr(propagator.propagate_op_sharding, "cache_clear", None),
                  getattr(getattr(propagator, "_propagate_tensor_meta_cached", None), "cache_clear", None),
                  getattr(_redistribute, "clear_redistribute_planner_cache", None),
                  getattr(getattr(_redistribute, "_gen_transform_infos", None), "cache_clear", None)):
        if clear is not None:
            clear()


@contextlib.contextmanager
def process_group(device: torch.device) -> Iterator[bool]:
    """The default group for `device` for the length of the block; torn down
    at its end if the block built it."""
    created = init_process_group(device)
    try:
        yield created
    finally:
        if created:
            destroy_process_group()


def barrier() -> None:
    """A barrier over the default group; nothing without one."""
    if dist.is_initialized():
        dist.barrier()


def all_reduce_flat(tensors: list[torch.Tensor], group) -> None:
    """Sum `tensors` (of one dtype) over `group` in place, in one all-reduce
    of their concatenation (the dcn reduction of a step's gradients, the tp
    sum of the replicated ones)."""
    flat = torch.cat([t.reshape(-1) for t in tensors])
    dist.all_reduce(flat, group=group)
    offset = 0
    for t in tensors:
        t.copy_(flat[offset:offset + t.numel()].view_as(t))
        offset += t.numel()


def broadcast_object(value):
    """Rank 0's `value` on every rank (the value itself without a group of more than one)."""
    if not dist.is_initialized() or dist.get_world_size() == 1:
        return value
    box = [value]
    dist.broadcast_object_list(box, src=0)
    return box[0]


def check_global_rank(value: int, what: str) -> None:
    """A config's `global_rank` must be this process's rank."""
    if int(value) != rank():
        raise ValueError(f"{what}: global_rank {value} but this process is rank {rank()} of {world_size()}")

"""The pre-flight collective check, the port of
modalities_tpu/utils/communication_test.py (`run --test_comm`): every rank
contributes a tensor stamped with its rank, they are all-gathered over the
world group, and each rank checks every slot (the reference's NCCL check).
On the card the tensors live on the rank's device, so the check goes
through NCCL; with `--device cpu`, through gloo."""

from __future__ import annotations

import torch
import torch.distributed as dist


def run_communication_test(device) -> None:
    """All-gather rank-stamped tensors over the world group (the default
    process group must exist) and verify each slot; raises on a mismatch.
    Rank 0 prints one line."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    world, rank = dist.get_world_size(), dist.get_rank()
    stamped = torch.full((4,), rank, dtype=torch.int32, device=device)
    gathered = [torch.empty_like(stamped) for _ in range(world)]
    dist.all_gather(gathered, stamped)
    got = [t.cpu().tolist() for t in gathered]
    expected = [[r] * 4 for r in range(world)]
    if got != expected:
        raise RuntimeError(f"Communication test failed: expected {expected}, got {got}")
    if rank == 0:
        print(f"Communication test passed over {world} rank(s) on {device.type} "
              f"({dist.get_backend()}).", flush=True)

"""Cluster coordination, the stop-flag consensus: the port of the stop ballot
of modalities_tpu/resilience/coordination.py (`BALLOT_KEY`, the votes,
`resolve_consensus`, `make_ballot`), and `collect_verified_steps`, which the
supervisor's degradation ladder reads.

**Stop ballot.** A host-local stop decision (SIGTERM on one rank, an anomaly
rollback on one rank) that is not shared by every rank is a deadlock: the
other ranks wait in the next step's collectives. So each step carries this
rank's vote as one int32 element (`BALLOT_KEY` in the batch), the step
reduces it with MAX over the world group (one all-reduce, issued with the
step's other work and never waited for inside it), and every rank reads the
same reduced value. The trainer reads the previous step's ballot, which has
long completed by then, so the consensus costs no per-step host stall, and
all ranks leave the loop at the same step boundary.

Votes are ordered by severity and reduced with max:
``VOTE_CONTINUE (0) < VOTE_STOP (1, preemption) < VOTE_ROLLBACK (2, anomaly)``.

(The JAX module's cross-host resume vote, `agree_resume`, is the multi-host
supervisor's: ROADMAP.md Queue 1 item 7, cluster resilience.)
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import AbstractSet, Optional

import torch

from modalities_tpu_torch.resilience.manifest import _seen_steps_of, verify_manifest

# the batch-dict key the trainer adds and the train step reduces; present only
# with consensus on, so the step without it issues no extra collective
BALLOT_KEY = "stop_ballot"

VOTE_CONTINUE = 0
VOTE_STOP = 1  # preemption signal / request_stop on some rank
VOTE_ROLLBACK = 2  # anomaly skip budget exhausted under the rollback policy


def resolve_consensus(mode: str) -> bool:
    """"on" / "off" / "auto" (on iff the world has more than one rank)."""
    if mode == "on":
        return True
    if mode == "off":
        return False
    if mode != "auto":
        raise ValueError(f"unknown stop_consensus mode {mode!r}")
    from modalities_tpu_torch.running_env import env

    return env.world_size() > 1


def make_ballot(vote: int, device) -> torch.Tensor:
    """This rank's vote as a [1] int32 tensor on `device` (the train step
    all-reduces it with MAX over the world group)."""
    return torch.full((1,), int(vote), dtype=torch.int32).to(device, non_blocking=True)


def reduce_ballot(ballot: torch.Tensor) -> torch.Tensor:
    """The MAX of every rank's ballot (a copy; the one consensus collective)."""
    import torch.distributed as dist

    reduced = ballot.clone()
    if dist.is_initialized():
        dist.all_reduce(reduced, op=dist.ReduceOp.MAX)
    return reduced


def collect_verified_steps(info_path: Path, exclude_steps: AbstractSet[int] = frozenset()) -> dict[int, Path]:
    """Every verified checkpoint folder in the resume ring, by its seen-steps
    count (the pointer's target and its siblings); `exclude_steps` drops the
    steps the degradation ladder burned."""
    info_path = Path(info_path)
    candidates: dict[int, Path] = {}
    pointed: Optional[Path] = None
    try:
        pointed = Path(json.loads(info_path.read_text())["checkpoint_folder_path"])
    except (OSError, KeyError, ValueError):
        pass
    ring_parent = pointed.parent if pointed is not None and pointed.parent.is_dir() else info_path.parent
    for folder in ring_parent.glob("eid_*-seen_steps_*"):
        step = _seen_steps_of(folder)
        if step < 0 or not folder.is_dir() or step in exclude_steps:
            continue
        if verify_manifest(folder).ok:
            candidates[step] = folder
    return candidates

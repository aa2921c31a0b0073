"""Checkpoint topology record: the port of modalities_tpu/checkpointing/topology.py.

Every sealed checkpoint folder gains a ``topology.json`` beside its
``manifest.json``: the saving run's mesh axes (the built ones, as the JAX
mesh has them), process and device counts, each state leaf's sharding and
the sampler-state layout. It is written before the manifest, so the
manifest's digests seal it too. A leaf's sharding is spelled as the JAX
package spells a PartitionSpec, one entry a dim: an FSDP2 shard over the
flattened (dp_shard, cp) group is "(('dp_shard', 'cp'), None)", a whole
leaf "()"; a ZeRO-1 moment names dp_replicate on its ZeRO dim (before the
FSDP axes where it splits the FSDP shard: "(('dp_replicate', 'dp_shard'),
None)"), so a change of stage shows as a `leaf_specs` difference. The slice
block and the sampler's dp degree count the dcn axis, as the JAX record
does. `diff_topology` is what a resume at another world compares.

Unlike the JAX package's `write_topology`, a failure to write the record
raises: a save's seal does not carry on past a failed step.
"""

from __future__ import annotations

import json
import logging
from pathlib import Path
from typing import Optional

from modalities_tpu_torch.resilience.manifest import atomic_write_json

logger = logging.getLogger(__name__)

TOPOLOGY_FILE_NAME = "topology.json"
TOPOLOGY_VERSION = 1


def leaf_spec(tensor) -> str:
    """A state leaf's sharding in the JAX spelling: "()" for a whole tensor;
    for a DTensor one entry a dim, the mesh axes it is sharded over (a
    flattened dim's axes as a tuple) or None."""
    from torch.distributed.tensor import DTensor

    if not isinstance(tensor, DTensor):
        return "()"
    dims: list = [None] * tensor.ndim
    for mesh_dim, placement in enumerate(tensor.placements):
        if not (placement.is_replicate() or placement.is_partial()):  # Shard, or FSDP2's _StridedShard under tp
            name = tensor.device_mesh.mesh_dim_names[mesh_dim]
            axes = ("dp_shard", "cp") if name == "dp_shard_cp" else (name,)  # the FSDP mesh's flattened dim
            current = dims[placement.dim]
            dims[placement.dim] = (current if isinstance(current, tuple) else ()) + axes
    return str(tuple(d[0] if isinstance(d, tuple) and len(d) == 1 else d for d in dims))


def describe_topology(device_mesh, state_dict: dict) -> dict:
    """The topology record of a state dict on the port's mesh (`device_mesh`
    a running_env.device_mesh.DeviceMesh, or None for a world-1 step with no
    mesh)."""
    from modalities_tpu_torch.checkpointing.stateful.app_state import flatten_tensors
    from modalities_tpu_torch.running_env import env

    mesh_axes = dict(device_mesh.mesh_axes) if device_mesh is not None else {"dp_shard": 1}
    num_slices = mesh_axes.get("dcn", 1)
    dp_degree = num_slices * mesh_axes.get("dp_replicate", 1) * mesh_axes.get("dp_shard", 1)
    device_count = 1
    for degree in mesh_axes.values():
        device_count *= degree
    return {
        "version": TOPOLOGY_VERSION,
        "mesh_axes": mesh_axes,
        "process_count": env.world_size(),
        "device_count": device_count,
        "slices": {"num_slices": num_slices, "devices_per_slice": device_count // num_slices},
        "leaf_specs": {name: leaf_spec(t) for name, t in flatten_tensors(state_dict).items()},
        "sampler_state": {"dp_degree": dp_degree, "skip_semantics": "global"},
    }


def write_topology(folder: Path, record: dict) -> Path:
    """Write the record into a committed checkpoint folder (before
    `write_manifest`, so the manifest seals it)."""
    path = Path(folder) / TOPOLOGY_FILE_NAME
    atomic_write_json(path, record)
    return path


def read_topology(folder: Path) -> Optional[dict]:
    """The saved record, or None for a folder without one."""
    path = Path(folder) / TOPOLOGY_FILE_NAME
    if not path.is_file():
        return None
    return json.loads(path.read_text())


def diff_topology(saved: dict, current: dict) -> list[str]:
    """Mismatch lines between a saved record and the current one; empty when
    the checkpoint was written under this topology."""
    mismatches: list[str] = []
    for key in ("mesh_axes", "process_count", "device_count"):
        if saved.get(key) != current.get(key):
            mismatches.append(f"{key}: saved {saved.get(key)} != current {current.get(key)}")
    saved_slices = (saved.get("slices") or {}).get("num_slices", 1)
    current_slices = (current.get("slices") or {}).get("num_slices", 1)
    if saved_slices != current_slices:
        mismatches.append(f"num_slices: saved {saved_slices} != current {current_slices}")
    saved_specs = saved.get("leaf_specs") or {}
    current_specs = current.get("leaf_specs") or {}
    changed = sum(1 for k, v in current_specs.items() if k in saved_specs and saved_specs[k] != v)
    if changed:
        mismatches.append(f"leaf_specs: {changed} leaves shard differently")
    return mismatches

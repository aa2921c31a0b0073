"""Device mesh: the port of modalities_tpu/running_env/device_mesh.py.

The `device_mesh` component validates the degrees as the JAX
`DeviceMeshConfig` does (-1 infers data_parallel_shard_degree or
data_parallel_replicate_degree from the world size; the product of the
degrees must be the world size) and, once the process group exists, builds a
torch `DeviceMesh` whose axes follow the JAX order [pp, dp_replicate,
dp_shard, cp, tp]. An axis exists only when its degree is above 1, except
dp_shard, which always exists. Rank r sits at the row-major coordinate of r,
as device r does in the JAX mesh.

Pipeline parallelism (pp, the outermost axis: `pp_group`, `pp_rank`; which
stages a pp rank runs, and so whether it holds the first or the last, its
schedule says: parallel/pipeline.py), data parallelism (dp_replicate, dp_shard),
context parallelism (cp) and tensor parallelism (tp, the innermost axis,
with loss parallelism over it) run; DCN degrees above 1 and ZeRO raise
NotImplementedError (-1 for dcn resolves to 1: a GPU host is one slice).
Loss parallelism needs tp > 1, as the JAX validator says. The pp ranks of
one dp coordinate read the same rows (`get_data_loading_info`).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from modalities_tpu_torch.config.config import check_bool, check_int, check_str

PARALLEL_METHODS = ("dp_replicate", "dp_shard", "tp", "pp", "cp", "dcn")  # the JAX mesh's axis names
AXIS_ORDER = ("pp", "dp_replicate", "dp_shard", "cp", "tp")  # the JAX mesh's order (dcn outermost, never built here)
_MULTI_GPU = "is not ported yet (ROADMAP.md, Queue 1 item 5)"


@dataclasses.dataclass
class DeviceMesh:
    world_size: int
    device_type: str = "cuda"  # accepted for config parity ("tpu" in the JAX configs); --device decides
    data_parallel_replicate_degree: int = 1
    data_parallel_shard_degree: int = -1
    tensor_parallel_degree: int = 1
    pipeline_parallel_degree: int = 1
    context_parallel_degree: int = 1
    enable_loss_parallel: bool = False
    zero_stage: int = 0
    dcn_parallel_degree: int = -1

    def __post_init__(self):
        check_int("world_size", self.world_size, ge=1)
        check_str("device_type", self.device_type)
        for name in ("data_parallel_replicate_degree", "data_parallel_shard_degree", "dcn_parallel_degree"):
            check_int(name, getattr(self, name), ge=-1)
            if getattr(self, name) == 0:
                raise ValueError(f"{name} must be -1 or >= 1")
        for name in ("tensor_parallel_degree", "pipeline_parallel_degree", "context_parallel_degree"):
            check_int(name, getattr(self, name), ge=1)
        check_bool("enable_loss_parallel", self.enable_loss_parallel, optional=True)
        check_int("zero_stage", self.zero_stage, ge=0)
        if self.dcn_parallel_degree > 1:
            raise NotImplementedError(f"dcn_parallel_degree {self.dcn_parallel_degree}: cross-slice (DCN) data "
                                      f"parallelism {_MULTI_GPU}")
        if self.zero_stage:
            raise NotImplementedError(f"zero_stage {self.zero_stage}: ZeRO optimizer-state sharding {_MULTI_GPU}")
        self.dcn_parallel_degree = 1
        self._validate_product()
        if self.enable_loss_parallel and self.tensor_parallel_degree <= 1:
            raise ValueError(f"enable_loss_parallel={self.enable_loss_parallel} requires tensor_parallel_degree > 1")
        self._torch_mesh = None

    def _validate_product(self) -> None:
        """The JAX validator (device_mesh.py:98-127): at most one -1, inferred
        from the world size; the product must equal it."""
        rep, shard = self.data_parallel_replicate_degree, self.data_parallel_shard_degree
        if rep == -1 and shard == -1:
            raise ValueError("At most one of data_parallel_replicate_degree and data_parallel_shard_degree can be -1")
        other = (self.context_parallel_degree * self.tensor_parallel_degree * self.pipeline_parallel_degree
                 * self.dcn_parallel_degree)
        if shard == -1:
            self.data_parallel_shard_degree = self.world_size // (rep * other)
        if rep == -1:
            self.data_parallel_replicate_degree = self.world_size // (self.data_parallel_shard_degree * other)
        product = self.data_parallel_shard_degree * self.data_parallel_replicate_degree * other
        if product != self.world_size or min(self.data_parallel_shard_degree, self.data_parallel_replicate_degree) < 1:
            raise ValueError(
                f"Invalid parallel dims: data_parallel_shard_degree({self.data_parallel_shard_degree}) * "
                f"data_parallel_replicate_degree({self.data_parallel_replicate_degree}) * "
                f"tensor_parallel_degree({self.tensor_parallel_degree}) * "
                f"pipeline_parallel_degree({self.pipeline_parallel_degree}) * "
                f"context_parallel_degree({self.context_parallel_degree}) * "
                f"dcn_parallel_degree({self.dcn_parallel_degree}) != WORLD_SIZE({self.world_size})"
            )

    @property
    def degrees(self) -> dict[str, int]:
        """The JAX mesh's degree table by axis name (size-1 axes included)."""
        return {"dp_replicate": self.data_parallel_replicate_degree, "dp_shard": self.data_parallel_shard_degree,
                "tp": self.tensor_parallel_degree, "pp": self.pipeline_parallel_degree,
                "cp": self.context_parallel_degree, "dcn": self.dcn_parallel_degree}

    @property
    def mesh_axes(self) -> dict[str, int]:
        """The built axes in order, as the JAX mesh has them: degree > 1, and dp_shard always."""
        degrees = self.degrees
        return {name: degrees[name] for name in AXIS_ORDER if degrees[name] > 1 or name == "dp_shard"}

    @property
    def dp_degree(self) -> int:
        return self.data_parallel_replicate_degree * self.data_parallel_shard_degree

    def get_parallel_degree(self, method: str) -> int:
        if method not in PARALLEL_METHODS:
            raise ValueError(f"unknown parallelism method {method!r}; expected one of {PARALLEL_METHODS}")
        return self.degrees[method]

    def coordinates(self, rank: int) -> dict[str, int]:
        """Rank `rank`'s coordinate on each built axis (row-major, as a JAX
        mesh places device `rank`)."""
        coords = {}
        for name, size in reversed(list(self.mesh_axes.items())):
            coords[name] = rank % size
            rank //= size
        return {name: coords[name] for name in self.mesh_axes}

    def torch_mesh(self, device: torch.device):
        """The torch DeviceMesh over the default process group (built once)."""
        import torch.distributed as dist
        from torch.distributed.device_mesh import init_device_mesh

        if self._torch_mesh is None:
            if dist.get_world_size() != self.world_size:
                raise ValueError(f"device_mesh.world_size {self.world_size} but the process group has "
                                 f"{dist.get_world_size()} ranks")
            axes = self.mesh_axes
            mesh = init_device_mesh(torch.device(device).type, tuple(axes.values()), mesh_dim_names=tuple(axes))
            if "cp" in axes:
                mesh["dp_shard", "cp"]._flatten("dp_shard_cp")
            batch = self._batch_axes()
            if batch is not None and len(batch) > 1 and batch != ("dp_shard", "cp"):  # the loss's group
                mesh[batch]._flatten("batch")
            self._torch_mesh = mesh
        return self._torch_mesh

    def fsdp_mesh(self, device: torch.device):
        """The mesh FSDP2 shards over: dp_shard and cp flattened into one dim
        (`dp_shard_cp`), beside dp_replicate when that axis is built (HSDP)."""
        mesh = self.torch_mesh(device)
        shard = "dp_shard_cp" if "cp" in self.mesh_axes else "dp_shard"
        return mesh["dp_replicate", shard] if "dp_replicate" in self.mesh_axes else mesh[shard]

    def cp_group(self, device: torch.device):
        """The process group of this rank's cp ring (None without a cp axis)."""
        return self.torch_mesh(device)["cp"].get_group() if "cp" in self.mesh_axes else None

    def tp_mesh(self, device: torch.device):
        """The 1-D mesh of this rank's tp group (None without a tp axis)."""
        return self.torch_mesh(device)["tp"] if "tp" in self.mesh_axes else None

    def _batch_axes(self) -> Optional[tuple[str, ...]]:
        """The built axes whose ranks hold other rows of the global batch:
        all but tp (its ranks hold the same rows) and pp (its ranks hold other
        layers); None when that is every axis."""
        axes = tuple(self.mesh_axes)
        batch = tuple(name for name in axes if name not in ("tp", "pp"))
        return None if batch == axes else batch

    def batch_group(self, device: torch.device):
        """The ranks that hold other rows of the global batch (every built
        axis but tp and pp): the process group the loss's (sum, count) is
        summed over. None without a tp or pp axis (then it is every rank)."""
        batch = self._batch_axes()
        if batch is None:
            return None
        name = batch[0] if len(batch) == 1 else "dp_shard_cp" if batch == ("dp_shard", "cp") else "batch"
        return self.torch_mesh(device)[name].get_group()

    def pp_group(self, device: torch.device):
        """The process group of this rank's pipeline (None without a pp axis);
        its group rank is the stage's device index."""
        return self.torch_mesh(device)["pp"].get_group() if "pp" in self.mesh_axes else None

    def pp_rank(self, rank: Optional[int] = None) -> int:
        """This rank's pipeline device (its coordinate on pp)."""
        from modalities_tpu_torch.running_env import env

        return self.coordinates(env.rank() if rank is None else rank).get("pp", 0)


def get_parallel_degree(device_mesh: Optional[DeviceMesh], method: str) -> int:
    return 1 if device_mesh is None else device_mesh.get_parallel_degree(method)


def get_parallel_rank(device_mesh: Optional[DeviceMesh], method: str, rank: Optional[int] = None) -> int:
    """This rank's coordinate along `method`'s axis (0 when the axis is not built)."""
    from modalities_tpu_torch.running_env import env

    if device_mesh is None:
        return 0
    device_mesh.get_parallel_degree(method)  # refuses an unknown name
    return device_mesh.coordinates(env.rank() if rank is None else rank).get(method, 0)


def get_data_loading_info(device_mesh: Optional[DeviceMesh], rank: Optional[int] = None) -> tuple[int, int]:
    """(number of data-parallel replicas, this rank's flat dp coordinate):
    dp_replicate * dp_shard replicas, coordinate dp_replicate_rank * dp_shard +
    dp_shard_rank. The cp, tp and pp ranks of one dp coordinate read the same
    samples."""
    if device_mesh is None:
        return 1, 0
    rep = get_parallel_rank(device_mesh, "dp_replicate", rank)
    shard = get_parallel_rank(device_mesh, "dp_shard", rank)
    return device_mesh.dp_degree, rep * device_mesh.data_parallel_shard_degree + shard

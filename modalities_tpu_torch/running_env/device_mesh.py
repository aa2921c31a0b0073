"""Device mesh: the port of modalities_tpu/running_env/device_mesh.py.

The `device_mesh` component validates the degrees as the JAX
`DeviceMeshConfig` does (-1 infers data_parallel_shard_degree or
data_parallel_replicate_degree from the world size; the product of the
degrees must be the world size; `zero_stage` is 0 or 1) and, once the
process group exists, builds a torch `DeviceMesh` whose axes follow the JAX
order [dcn, pp, dp_replicate, dp_shard, cp, tp]. An axis exists only when
its degree is above 1, except dp_shard, which always exists. Rank r sits at
the row-major coordinate of r, as device r does in the JAX mesh.

Cross-slice data parallelism (dcn, the outermost axis: `dcn_group`) splits
the world into slices. Every other group is built within a slice (a
sub-mesh over the other axes), so FSDP2 shards and tp/cp/pp exchange inside
a slice and parameters are replicated over dcn by construction; the train
step reduces the gradients over dcn once a step. -1 for dcn resolves to 1,
the JAX GPU behaviour (a GPU host reports no slices); an explicit degree
above 1 builds the axis. Pipeline parallelism (pp: `pp_group`, `pp_rank`;
which stages a pp rank runs, its schedule says: parallel/pipeline.py), data
parallelism (dp_replicate, dp_shard), context parallelism (cp) and tensor
parallelism (tp, the innermost axis, with loss parallelism over it) run.
ZeRO-1 (`zero_active`: stage 1 with dp_replicate > 1) shards the optimizer
state over dp_replicate (parallel/zero.py). Loss parallelism needs tp > 1,
as the JAX validator says. The pp ranks of one dp coordinate read the same
rows (`get_data_loading_info`, which folds dcn into the data split).

Compositions the JAX `TrainStepBuilder` does not build are refused with
NotImplementedError: dcn with pp or with cp (its per-slice vmap cannot lower
the pipeline's or the ring's shard_map), and an active ZeRO-1 with pp (its
partitioner aborts).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from modalities_tpu_torch.config.config import check_bool, check_int, check_str

PARALLEL_METHODS = ("dp_replicate", "dp_shard", "tp", "pp", "cp", "dcn")  # the JAX mesh's axis names
AXIS_ORDER = ("dcn", "pp", "dp_replicate", "dp_shard", "cp", "tp")  # the JAX mesh's order
_NOT_BUILT = "the reference (the JAX TrainStepBuilder) does not build it"


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
        check_int("zero_stage", self.zero_stage, ge=0, le=1)
        if self.dcn_parallel_degree == -1:
            self.dcn_parallel_degree = 1  # a GPU host is one slice (JAX infer_num_slices: no slice_index)
        self._validate_product()
        if self.enable_loss_parallel and self.tensor_parallel_degree <= 1:
            raise ValueError(f"enable_loss_parallel={self.enable_loss_parallel} requires tensor_parallel_degree > 1")
        self._refuse_what_the_reference_does_not_build()
        self._torch_mesh = None

    def _refuse_what_the_reference_does_not_build(self) -> None:
        """Compositions the JAX TrainStepBuilder fails to build on its 8-device
        CPU mesh: NotImplementedError, naming the reference."""
        dcn = self.dcn_parallel_degree
        for name, degree in (("pipeline_parallel_degree", self.pipeline_parallel_degree),
                             ("context_parallel_degree", self.context_parallel_degree)):
            if dcn > 1 and degree > 1:
                raise NotImplementedError(f"dcn_parallel_degree {dcn} with {name} {degree}: {_NOT_BUILT} "
                                          "(ROADMAP.md, Queue 1 item 5)")
        if self.zero_active and self.pipeline_parallel_degree > 1:
            raise NotImplementedError(f"zero_stage 1 over data_parallel_replicate_degree "
                                      f"{self.data_parallel_replicate_degree} with pipeline_parallel_degree "
                                      f"{self.pipeline_parallel_degree}: {_NOT_BUILT} (ROADMAP.md, Queue 1 item 5)")

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
        """The data-parallel degree within a slice."""
        return self.data_parallel_replicate_degree * self.data_parallel_shard_degree

    @property
    def zero_active(self) -> bool:
        """ZeRO-1 shards anything: stage 1 over more than one replica (JAX
        train_step.py:268-272; at dp_replicate 1 stage 1 is the stage-0 program)."""
        return self.zero_stage >= 1 and self.data_parallel_replicate_degree > 1

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
        (`dp_shard_cp`), beside dp_replicate when that axis is built (HSDP)
        and ZeRO-1 is not active (ZeRO-1 sums over the replicas itself, once
        a step). A sub-mesh within this rank's slice: parameters are
        replicated over dcn."""
        mesh = self.torch_mesh(device)
        shard = "dp_shard_cp" if "cp" in self.mesh_axes else "dp_shard"
        return mesh["dp_replicate", shard] if "dp_replicate" in self.mesh_axes and not self.zero_active else mesh[shard]

    def cp_group(self, device: torch.device):
        """The process group of this rank's cp ring (None without a cp axis)."""
        return self.torch_mesh(device)["cp"].get_group() if "cp" in self.mesh_axes else None

    def tp_mesh(self, device: torch.device):
        """The 1-D mesh of this rank's tp group (None without a tp axis)."""
        return self.torch_mesh(device)["tp"] if "tp" in self.mesh_axes else None

    def _batch_axes(self) -> Optional[tuple[str, ...]]:
        """The built axes whose ranks hold other rows of the slice's batch:
        all but tp (its ranks hold the same rows), pp (its ranks hold other
        layers) and dcn (other slices); None when that is every axis."""
        axes = tuple(self.mesh_axes)
        batch = tuple(name for name in axes if name not in ("tp", "pp", "dcn"))
        return None if batch == axes else batch

    def batch_group(self, device: torch.device):
        """The ranks of this slice that hold other rows of its batch (every
        built axis but tp, pp and dcn): the process group the loss's (sum,
        count) is summed over. None without a tp, pp or dcn axis (then it is
        every rank)."""
        batch = self._batch_axes()
        if batch is None:
            return None
        name = batch[0] if len(batch) == 1 else "dp_shard_cp" if batch == ("dp_shard", "cp") else "batch"
        return self.torch_mesh(device)[name].get_group()

    def dcn_group(self, device: torch.device):
        """The process group of this rank's counterparts in the other slices
        (None without a dcn axis): the one cross-slice reduction a step."""
        return self.torch_mesh(device)["dcn"].get_group() if "dcn" in self.mesh_axes else None

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
    """(number of data-parallel replicas, this rank's flat dp coordinate) over
    (dcn, dp_replicate, dp_shard), as the JAX function folds dcn into the
    batch split (device_mesh.py:342): dcn * dp_replicate * dp_shard replicas,
    coordinate (dcn_rank * dp_replicate + dp_replicate_rank) * dp_shard +
    dp_shard_rank, so the ranks of slice k hold the k-th block of
    coordinates. The cp, tp and pp ranks of one dp coordinate read the same
    samples."""
    if device_mesh is None:
        return 1, 0
    flat = 0
    for name in ("dcn", "dp_replicate", "dp_shard"):
        flat = flat * device_mesh.degrees[name] + get_parallel_rank(device_mesh, name, rank)
    return device_mesh.dcn_parallel_degree * device_mesh.dp_degree, flat

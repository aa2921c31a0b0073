"""Device mesh: the port of modalities_tpu/running_env/device_mesh.py for one
card. The `device_mesh` component keeps the JAX config's fields; the port
trains on a world-1 mesh, and any parallel degree above 1 (data replicate or
shard, tensor, pipeline, context, DCN) or ZeRO raises NotImplementedError
(-1, "the rest of the world", resolves to 1).
"""

from __future__ import annotations

import dataclasses

from modalities_tpu_torch.config.config import check_bool, check_int, check_str

PARALLEL_METHODS = ("dp_replicate", "dp_shard", "tp", "pp", "cp", "dcn")  # the JAX mesh's axis names
_MULTI_GPU = "multi-GPU training is not ported yet (ROADMAP.md, Queue 1 item 5)"


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
        for name in ("tensor_parallel_degree", "pipeline_parallel_degree", "context_parallel_degree"):
            check_int(name, getattr(self, name), ge=1)
        check_bool("enable_loss_parallel", self.enable_loss_parallel, optional=True)
        check_int("zero_stage", self.zero_stage, ge=0)
        degrees = {
            "world_size": self.world_size,
            "dp_replicate": self.data_parallel_replicate_degree,
            "dp_shard": self.data_parallel_shard_degree,
            "tp": self.tensor_parallel_degree,
            "pp": self.pipeline_parallel_degree,
            "cp": self.context_parallel_degree,
            "dcn": self.dcn_parallel_degree,
        }
        over = {k: v for k, v in degrees.items() if v > 1}
        if over:
            raise NotImplementedError(f"device_mesh degrees {over}: {_MULTI_GPU}")
        if self.zero_stage:
            raise NotImplementedError(f"zero_stage {self.zero_stage}: ZeRO optimizer-state sharding needs {_MULTI_GPU}")

    @property
    def degrees(self) -> dict[str, int]:
        """The JAX mesh's axis degrees by name: all 1 on the world-1 mesh."""
        return {name: 1 for name in PARALLEL_METHODS}

    def get_parallel_degree(self, method: str) -> int:
        if method not in PARALLEL_METHODS:
            raise ValueError(f"unknown parallelism method {method!r}; expected one of {PARALLEL_METHODS}")
        return self.degrees[method]


def get_data_loading_info(device_mesh) -> tuple[int, int]:
    """(number of data-parallel replicas, this process's rank): (1, 0) on one card."""
    return 1, 0

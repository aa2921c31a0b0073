"""Checkpoint loading on `torch.distributed.checkpoint` (DCP): the port of
modalities_tpu/checkpointing/orbax/orbax_checkpoint_loading.py.

`load_app_state` gates before it reads: the folder must pass its manifest
(resilience/manifest.py; a folder without one is accepted, as in the JAX
package), then every tensor the built train step holds must have the shape
the checkpoint's DCP metadata gives it (another architecture is refused,
naming the leaves that differ). Then `dcp.load` reads into the train step's
own tensors, the AppState takes what it read, and is marked loaded; a second
load is refused before anything is read.

A saved topology record that differs from the current mesh (another world)
is logged; it refuses nothing, since DCP reshards the saved tensors onto the
current run's layout on load (the JAX loader also relaxes the manifest gate
then; the port keeps it: every rank's files are on the shared folder, so
none can be missing for that reason). Every rank runs the gates before it
reads.

`restore_tree_single_device` reads the model's parameters alone from a
folder onto one device, shaped by the checkpoint's own metadata: the serving
path's reader.
"""

from __future__ import annotations

import dataclasses
import logging
import warnings
from abc import ABC, abstractmethod
from pathlib import Path
from typing import Any, Optional

import torch

from modalities_tpu_torch.checkpointing.stateful.app_state import DOUBLE_LOAD, flatten_tensors
from modalities_tpu_torch.checkpointing.topology import describe_topology, diff_topology, read_topology
from modalities_tpu_torch.config.config import check_bool, check_int
from modalities_tpu_torch.device import resolve_device
from modalities_tpu_torch.resilience.manifest import verify_manifest
from modalities_tpu_torch.resilience.heartbeat import rendezvous
from modalities_tpu_torch.resilience.retry import retry_io
from modalities_tpu_torch.running_env import env

logger = logging.getLogger(__name__)


class CheckpointingError(Exception):
    """A checkpoint that must not be loaded."""


def _read_metadata(folder: Path):
    from torch.distributed.checkpoint import FileSystemReader

    return retry_io(lambda: FileSystemReader(str(folder)).read_metadata(), what="dcp_metadata")


class CheckpointLoadingIF(ABC):
    @abstractmethod
    def load_app_state(self, app_state, checkpoint_dir_path: Path): ...


@dataclasses.dataclass
class DCPCheckpointLoading(CheckpointLoadingIF):
    """A `global_rank` given must be this process's rank (unset: whatever rank
    runs it); `elastic` False skips the topology comparison."""

    global_rank: Optional[int] = None
    elastic: bool = True

    def __post_init__(self):
        check_int("global_rank", self.global_rank, ge=0, optional=True)
        check_bool("elastic", self.elastic)

    def _log_reshard(self, folder: Path, app_state, target: dict) -> None:
        if not self.elastic:
            return
        saved = read_topology(folder)
        if saved is None:
            return
        mismatches = diff_topology(saved, describe_topology(app_state.device_mesh, target))
        if mismatches:
            logger.warning("checkpoint %s was written under another topology: %s", folder.name, "; ".join(mismatches))

    @staticmethod
    def _reject_shape_mismatch(folder: Path, target: dict) -> None:
        """Each tensor's shape must equal the checkpoint's: another shape is
        another architecture."""
        saved = _read_metadata(folder).state_dict_metadata
        mismatched = []
        for name, tensor in flatten_tensors(target).items():
            meta = saved.get(name)
            if meta is None or not hasattr(meta, "size"):
                mismatched.append(f"{name}: not in the checkpoint")
            elif tuple(meta.size) != tuple(tensor.shape):
                mismatched.append(f"{name}: saved {tuple(meta.size)} != target {tuple(tensor.shape)}")
        if mismatched:
            shown = "; ".join(mismatched[:5])
            more = f" (+{len(mismatched) - 5} more)" if len(mismatched) > 5 else ""
            raise CheckpointingError(f"refusing to restore {folder}: architecture mismatch — {shown}{more}")

    def load_app_state(self, app_state, checkpoint_dir_path: Path):
        import torch.distributed.checkpoint as dcp

        folder = Path(checkpoint_dir_path)
        if self.global_rank is not None:
            env.check_global_rank(self.global_rank, "checkpoint_loading")
        if app_state.is_loaded:
            raise RuntimeError(DOUBLE_LOAD)
        if not folder.exists():
            raise FileNotFoundError(f"Checkpoint directory {folder} does not exist.")
        verification = verify_manifest(folder)
        if not verification.ok:
            raise CheckpointingError(f"refusing to restore {folder}: {verification.reason}")
        target = app_state.state_dict()
        self._log_reshard(folder, app_state, target)
        self._reject_shape_mismatch(folder, target)
        logger.info("Restoring checkpoint from %s ...", folder)
        with rendezvous("checkpoint_restore"):  # a peer's heartbeat deadline bounds the collective load
            retry_io(lambda: dcp.load(target, checkpoint_id=folder), what="dcp_load")
        app_state.load_state_dict(target)
        app_state.mark_loaded()
        logger.info("Checkpoint restored at step %d.", app_state.step_count)
        return app_state


def restore_tree_single_device(checkpoint_dir_path: Path,
                               device: Optional[torch.device | str] = None) -> dict[str, torch.Tensor]:
    """The model's parameters of a checkpoint, keyed as the module's state
    dict, as tensors on `device` (default: the CUDA card; raises without one,
    see device.resolve_device) with the dtypes and shapes the checkpoint
    holds. Checks nothing: callers verify the folder's manifest first."""
    import torch.distributed.checkpoint as dcp
    from torch.distributed.checkpoint.metadata import TensorStorageMetadata

    folder = Path(checkpoint_dir_path)
    device = resolve_device(device)
    prefix = "model."
    target = {
        name[len(prefix):]: torch.empty(tuple(meta.size), dtype=meta.properties.dtype, device=device)
        for name, meta in _read_metadata(folder).state_dict_metadata.items()
        if name.startswith(prefix) and isinstance(meta, TensorStorageMetadata)
    }
    if not target:
        raise CheckpointingError(f"{folder} holds no model parameters")
    retry_io(lambda: dcp.load({"model": target}, checkpoint_id=folder), what="dcp_restore")
    return target


# ------------------------------------------------------ the registry's variants


def _warn_unused(variant: str, config, names: tuple[str, ...], why: str) -> None:
    unused = [name for name in names if getattr(config, name) is not None]
    if unused:
        warnings.warn(f"checkpoint_loading.{variant}: {unused} have no effect here ({why})", stacklevel=3)


@dataclasses.dataclass
class FSDP1AliasCheckpointLoadingConfig(DCPCheckpointLoading):
    """`checkpoint_loading.fsdp1`: the DCP loader behind the reference's name.
    The FSDP1 wrapper-rebuild knobs are accepted for config parity with a
    warning and have no effect: DCP loads into the train step as it was
    built."""

    block_names: Optional[list] = None
    mixed_precision_settings: Any = None
    sharding_strategy: Any = None

    def __post_init__(self):
        super().__post_init__()
        _warn_unused("fsdp1", self, ("block_names", "mixed_precision_settings", "sharding_strategy"),
                     "DCP loads into the train step as built")


@dataclasses.dataclass
class TorchAliasCheckpointLoadingConfig(DCPCheckpointLoading):
    """`checkpoint_loading.torch`: the DCP loader behind the reference's name.
    Its `device` and `precision` are accepted for config parity with a
    warning and have no effect: placement follows the train step's device and
    dtypes follow the model's mixed-precision spec."""

    device: Any = None
    precision: Any = None

    def __post_init__(self):
        super().__post_init__()
        _warn_unused("torch", self, ("device", "precision"), "DCP loads in place")


def alias_checkpoint_loading(**config) -> DCPCheckpointLoading:
    """The loader of an alias variant's config (its extra knobs dropped)."""
    return DCPCheckpointLoading(global_rank=config["global_rank"], elastic=config["elastic"])

"""Checkpoint saving on `torch.distributed.checkpoint` (DCP): the port of
modalities_tpu/checkpointing/orbax/orbax_checkpoint_saving.py, in the JAX
package's layout and with its guarantees.

- The folder name is the metadata store:
  ``eid_{eid}-seen_steps_{s}-seen_tokens_{t}-target_steps_{S}-target_tokens_{T}``
  (parsed back by utils/number_conversion.py when a warmstart config is built).
- ``dcp.save`` of the AppState (checkpointing/stateful/app_state.py) writes the
  folder: each rank its own shards (``__<rank>_0.distcp``), the coordinator
  (rank 0) DCP's ``.metadata``; without a process group one process writes
  them all.
- Once the write has committed on every rank (a barrier), rank 0 alone seals
  the folder in this order: ``topology.json``, then ``manifest.json`` (sizes
  and sha256 of every file, the topology record included), then the resume
  pointer ``last_checkpoint_info.json`` beside the folders, written
  atomically; a second barrier holds every rank until the seal is on disk.
- With ``use_async``, ``dcp.async_save`` copies the state to the host and
  writes it in the background while training goes on. The folder is sealed,
  and the pointer moved to it, only once that write is confirmed: at the next
  save or at `wait_until_finished` (the Gym drains at the end of a run). A
  crash mid-write so never leaves a pointer to a folder that is not whole.
- Ring deletion (the strategy's k) first drains a pending write when the
  pointer still names the folder to delete.
- A failed write, seal or pointer update raises; IO errors are retried a
  bounded number of times first (resilience/retry.py).
"""

from __future__ import annotations

import dataclasses
import logging
import shutil
from pathlib import Path
from typing import Any, Optional

from modalities_tpu_torch.checkpointing.checkpoint_saving_execution import CheckpointSavingExecutionABC
from modalities_tpu_torch.checkpointing.topology import describe_topology, write_topology
from modalities_tpu_torch.config.config import check_bool, check_int, check_str
from modalities_tpu_torch.resilience.manifest import atomic_write_json, write_manifest
from modalities_tpu_torch.resilience.heartbeat import rendezvous
from modalities_tpu_torch.resilience.retry import retry_io
from modalities_tpu_torch.running_env import env
from modalities_tpu_torch.training.training_progress import TrainingProgress

logger = logging.getLogger(__name__)

CHECKPOINT_FOLDER_STRUCTURE = (
    "eid_{experiment_id}-seen_steps_{num_seen_steps}-seen_tokens_{num_seen_tokens}"
    "-target_steps_{num_target_steps}-target_tokens_{num_target_tokens}"
)
LAST_CHECKPOINT_INFO_FILE_NAME = "last_checkpoint_info.json"


def checkpoint_folder_path(checkpoint_path: Path, experiment_id: str, training_progress: TrainingProgress) -> Path:
    name = CHECKPOINT_FOLDER_STRUCTURE.format(
        experiment_id=experiment_id,
        num_seen_steps=training_progress.num_seen_steps_total,
        num_seen_tokens=training_progress.num_seen_tokens_total,
        num_target_steps=training_progress.num_target_steps,
        num_target_tokens=training_progress.num_target_tokens,
    )
    return Path(checkpoint_path, name)


@dataclasses.dataclass
class DCPCheckpointSavingConfig:
    """The JAX execution's keys; a `global_rank` given must be this process's
    rank (unset: whatever rank runs it)."""

    checkpoint_path: Path
    experiment_id: str
    global_rank: Optional[int] = None
    use_async: bool = False

    def __post_init__(self):
        self.checkpoint_path = Path(self.checkpoint_path)
        check_str("experiment_id", self.experiment_id)
        check_int("global_rank", self.global_rank, ge=0, optional=True)
        check_bool("use_async", self.use_async)


@dataclasses.dataclass
class _PendingSave:
    folder: Path
    topology: dict
    future: Any  # the Future of dcp.async_save


class DCPCheckpointSaving(CheckpointSavingExecutionABC):
    def __init__(self, checkpoint_path: Path, experiment_id: str, global_rank: Optional[int] = None,
                 use_async: bool = False):
        self.checkpoint_path = Path(checkpoint_path)
        self.experiment_id = experiment_id
        self.global_rank = global_rank
        self.use_async = use_async
        self._pending: Optional[_PendingSave] = None
        # the folder the resume pointer names: a ring deletion of it drains the pending write first
        self._last_info_folder: Optional[Path] = None

    def _save_checkpoint(self, app_state, training_progress: TrainingProgress) -> None:
        import torch.distributed.checkpoint as dcp

        if self.global_rank is not None:
            env.check_global_rank(self.global_rank, "checkpoint_saving_execution")
        folder = checkpoint_folder_path(self.checkpoint_path, self.experiment_id, training_progress)
        folder.parent.mkdir(parents=True, exist_ok=True)
        logger.info("Saving checkpoint to %s ...", folder)
        state = app_state.state_dict()
        topology = describe_topology(app_state.device_mesh, state)
        self.wait_until_finished()  # the previous write commits and is sealed before the next begins
        with rendezvous("checkpoint_save"):  # a peer's heartbeat deadline bounds the collective save
            if self.use_async:
                future = retry_io(lambda: dcp.async_save(state, checkpoint_id=folder), what="dcp_async_save")
                self._pending = _PendingSave(folder, topology, future)
            else:
                retry_io(lambda: dcp.save(state, checkpoint_id=folder), what="dcp_save")
                self._seal_committed(folder, topology)
        logger.info("Checkpoint saved.")

    def _seal_committed(self, folder: Path, topology: dict) -> None:
        """On rank 0, once every rank's write has committed: topology record,
        then manifest (its presence certifies a whole folder and its digests
        cover the topology file), then the resume pointer (naming the folder
        the manifest just certified)."""
        info_path = folder.parent / LAST_CHECKPOINT_INFO_FILE_NAME
        env.barrier()
        if env.rank() == 0:
            write_topology(folder, topology)
            write_manifest(folder)
            retry_io(lambda: atomic_write_json(info_path, {"checkpoint_folder_path": str(folder.absolute())}),
                     what="info_write")
        env.barrier()
        self._last_info_folder = folder
        logger.info("Checkpoint info saved to %s.", info_path)

    def _delete_checkpoint(self, training_progress: TrainingProgress) -> None:
        folder = checkpoint_folder_path(self.checkpoint_path, self.experiment_id, training_progress)
        # deleting the folder the pointer still names (a k = 1 ring with use_async) would leave it dangling for
        # a whole interval: drain the pending write first, so the pointer moves to the newest folder
        if self._pending is not None and self._last_info_folder == folder:
            self.wait_until_finished()
        env.barrier()  # no rank still reads the folder
        if env.rank() != 0:
            return
        if not folder.exists():
            logger.warning("Checkpoint folder %s already gone; skipping ring deletion.", folder)
            return
        shutil.rmtree(folder)

    def wait_until_finished(self) -> None:
        """Wait for a pending background write, then seal its folder and move
        the pointer to it. A failed write raises here."""
        pending, self._pending = self._pending, None
        if pending is not None:
            with rendezvous("checkpoint_drain"):
                pending.future.result()
                self._seal_committed(pending.folder, pending.topology)

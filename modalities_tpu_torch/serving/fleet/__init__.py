"""Fleet serving: the train -> serve continuous deployment, the port of
modalities_tpu/serving/fleet/.

- `watcher.CheckpointWatcher` polls a training checkpoint ring for newly
  SEALED checkpoints (a manifest present and clean), loads them through the
  shared `load_serving_params` and hands them to a deploy callback.
- `controller.RolloutController` + `controller.EngineWorker`: canary
  rollouts. ONE worker swaps to the next generation, its error and TTFT
  metrics are watched against the fleet's for a probation window, then the
  generation is promoted to every worker or the canary rolled back.
- `router.FleetRouter`: the asyncio HTTP front tier that load-balances
  `POST /generate` across workers (least-loaded), health-checks them with
  heartbeat deadlines, and replays a request whose worker died mid-stream
  on a peer.
"""

from modalities_tpu_torch.serving.fleet.controller import EngineWorker, RolloutController
from modalities_tpu_torch.serving.fleet.router import FleetRouter, WorkerHandle
from modalities_tpu_torch.serving.fleet.watcher import CheckpointWatcher

__all__ = ["CheckpointWatcher", "EngineWorker", "FleetRouter", "RolloutController", "WorkerHandle"]

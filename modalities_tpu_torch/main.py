"""Main: YAML config -> component graph -> train step -> Gym.run, the port of
modalities_tpu/main.py.

`Main(config_path).run()` loads the config with the port's `${...}`
interpolation (`cuda_env` reads the launcher's RANK / WORLD_SIZE /
LOCAL_RANK, or rank 0 of a world of 1 without a launcher), joins the process
group (running_env/env.py: under `torch.distributed.run` the launcher's, else
a world-1 group it builds), builds every node with the training catalog,
builds the `TrainStep` over the config's device mesh (FSDP2, and the cp ring
when the mesh has a cp axis) from the app state's model / optimizer /
scheduler, the loss, the clipper and the step profile (under a pp axis, of
this rank's pipeline stage), loads a checkpoint into it when the app state
names one (the `dcp` variant: a warmstart), and runs the trainer with the
evaluator over the eval dataloaders. The group is joined when `Main` is made (every rank takes
rank 0's experiment id); a group `Main` built is torn down at the end of
`run` (with DTensor's sharding caches, running_env/env.py, so a second run
on another mesh in the same process starts clean), one that existed before
is left to its owner. It runs on the CUDA card
LOCAL_RANK unless `device="cpu"`. `additional_resolver_funs` adds
`${name:...}` resolvers to the config's (warmstart adds `warmstart_env`).

Resilience (JAX main.py:78, :124-161, :196, :253-285): `run` arms the fault
points of $MODALITIES_TPU_FAULTS (resilience/faults.py) before the train
step is built, so `nan_grads` / `loss_spike` are baked into it; with a
`resilience` component it resolves the stop consensus once for the step and
the trainer, starts the peer-health heartbeat (and makes it the process's
active monitor) when its transport resolves on, hands the anomaly policy to
the train step and the tracker and preemption handler to the trainer, and
installs the handler's SIGTERM/SIGINT handlers for the training window only.

Telemetry (JAX main.py:71-106, :185, :202) is on by default: the config's
`telemetry` component, or a default `Telemetry()` when it has none, writes
its sink to `<experiments root>/<experiment id>/telemetry` (the root passed
to `Main`, else the config's `settings.paths.experiments_root_path`), is the
process's active telemetry for the run (deep call sites reach it through
`telemetry.span`), times the train step's build in an `init` span (a
checkpoint's load in `checkpoint_restore` inside it) and is closed, its sink
sealed with the run's summary, however the run ends. The trainer applies the
capture switches MODALITIES_TPU_PROFILE_AT_STEP / _PROFILE_DIR /
_MEMSCOPE_AT_STEP / _MEMSCOPE_DIR / _MEMSCOPE_FITS_CHECK (trainer.py) and
steps the config's `profiler` node (JAX main.py:249), beside them.
"""

from __future__ import annotations

import hashlib
import logging
import shutil
import time
from pathlib import Path
from typing import Callable, Optional

from modalities_tpu_torch.config.component_factory import ComponentFactory
from modalities_tpu_torch.config.instantiation_models import (
    UNPORTED_TRAINING_COMPONENTS,
    TrainingComponentsInstantiationModel,
    without_reference_only_settings,
)
from modalities_tpu_torch.config.yaml_interp import load_app_config_dict
from modalities_tpu_torch.device import resolve_device
from modalities_tpu_torch.registry.components import TRAINING_COMPONENTS
from modalities_tpu_torch.registry.registry import Registry
from modalities_tpu_torch.running_env import env
from modalities_tpu_torch.telemetry import Telemetry, set_active_telemetry, span

logger = logging.getLogger(__name__)

def experiment_id_of_run(config_path: Path) -> str:
    """<UTC time>_<first 8 hex digits of the config's sha256>."""
    digest = hashlib.sha256(Path(config_path).read_bytes()).hexdigest()[:8]
    return f"{time.strftime('%Y-%m-%d__%H-%M-%S', time.gmtime())}_{digest}"


class Main:
    def __init__(self, config_path: Path, experiments_root_path: Optional[Path] = None,
                 experiment_id: Optional[str] = None, device: Optional[str] = None,
                 additional_resolver_funs: Optional[dict[str, Callable]] = None):
        self.config_path = Path(config_path)
        self.device = resolve_device(device)
        self.registry = Registry(TRAINING_COMPONENTS)
        self._owns_group = False
        self._join_group()
        try:  # every rank names the run as rank 0 does: its checkpoint folders are one folder
            self.experiment_id = experiment_id or env.broadcast_object(experiment_id_of_run(self.config_path))
            self.experiments_root_path = Path(experiments_root_path) if experiments_root_path else None
            self.references: set[str] = set()
            self.config_dict = load_app_config_dict(self.config_path, experiments_root_path=self.experiments_root_path,
                                                    experiment_id=self.experiment_id,
                                                    additional_resolver_funs=additional_resolver_funs,
                                                    references=self.references)
        except BaseException:
            self._leave_group()
            raise

    def _join_group(self) -> None:
        self._owns_group = env.init_process_group(self.device) or self._owns_group

    def _leave_group(self) -> None:
        if self._owns_group:
            env.destroy_process_group()
            self._owns_group = False

    def test_communication(self) -> None:
        """`run --test_comm`: the pre-flight all-gather over the world group
        (utils/communication_test.py)."""
        from modalities_tpu_torch.utils.communication_test import run_communication_test

        self._join_group()
        try:
            run_communication_test(self.device)
        except BaseException:
            self._leave_group()
            raise

    def build_components(self, components_model_type: type = TrainingComponentsInstantiationModel):
        """The config's components as `components_model_type` names them
        (config/instantiation_models.py), checked against this process's rank."""
        for key, what in UNPORTED_TRAINING_COMPONENTS.items():
            if self.config_dict.get(key) is not None:
                raise NotImplementedError(f"config node {key!r}: {what} is not ported yet")
        self._join_group()
        try:
            config_dict = without_reference_only_settings(self.config_dict, self.references)
            components = ComponentFactory(self.registry).build_components(config_dict, components_model_type)
            self._check_ranks(components)
        except BaseException:
            self._leave_group()
            raise
        return components

    @staticmethod
    def _check_ranks(components: TrainingComponentsInstantiationModel) -> None:
        """The config's rank and world must be this process's (`cuda_env`
        reads them from the launcher; the mesh's world is checked when it is
        built)."""
        dist_env = components.settings.dist_env
        env.check_global_rank(dist_env.global_rank, "settings.cuda_env")
        if dist_env.world_size != env.world_size():
            raise ValueError(f"settings.cuda_env: world_size {dist_env.world_size} but the process group has "
                             f"{env.world_size()} ranks")

    def build_train_step(self, components: TrainingComponentsInstantiationModel):
        from modalities_tpu_torch.running_env.device_mesh import DeviceMesh
        from modalities_tpu_torch.training.train_step import TrainStep

        app_state = components.app_state
        resilience = getattr(components, "resilience", None)
        return TrainStep(
            app_state.model, components.loss_fn, app_state.optimizer, app_state.lr_scheduler,
            device=self.device,
            gradient_acc_steps=components.settings.step_profile.gradient_accumulation_steps,
            grad_clipper=components.gradient_clipper,
            device_mesh=components.device_mesh or DeviceMesh(world_size=env.world_size()),
            anomaly_policy=resilience.anomaly_policy if resilience is not None else None,
        )

    def load_app_state(self, components: TrainingComponentsInstantiationModel, train_step):
        """The AppState over the built step; a checkpoint the app state names
        is loaded into it (in a `checkpoint_restore` span), and must hold as
        many optimizer steps as the settings' training progress says were
        seen."""
        from modalities_tpu_torch.checkpointing.stateful.app_state import AppState

        spec = components.app_state
        app_state = AppState(train_step, device_mesh=components.device_mesh)
        if spec.checkpoint_dir_path is not None:
            loader = spec.checkpoint_loading
            if loader is None:
                from modalities_tpu_torch.checkpointing.dcp.dcp_checkpoint_loading import DCPCheckpointLoading

                loader = DCPCheckpointLoading()
            with span("checkpoint_restore"):
                loader.load_app_state(app_state, spec.checkpoint_dir_path)
            seen = components.settings.training_progress.num_seen_steps
            if app_state.step_count != seen:
                raise ValueError(f"checkpoint {spec.checkpoint_dir_path} holds {app_state.step_count} optimizer steps, "
                                 f"the settings' training_progress.num_seen_steps is {seen}")
        return app_state

    def run(self, components: Optional[TrainingComponentsInstantiationModel] = None) -> list[dict]:
        """Train; returns the interval results (published on rank 0)."""
        from modalities_tpu_torch.resilience.faults import load_faults_from_env

        load_faults_from_env()  # armed once per process, before the step that bakes them is built
        self._join_group()
        try:
            components = components or self.build_components()
            telemetry = components.telemetry or Telemetry()
            root = self.experiments_root_path
            if root is None:
                configured = ((self.config_dict.get("settings") or {}).get("paths") or {}).get("experiments_root_path")
                root = Path(configured) if configured else None
            if root is not None:
                telemetry.set_output_folder(root / self.experiment_id / "telemetry")
            self.telemetry = telemetry
            previous = set_active_telemetry(telemetry)
            try:
                return self._run(components, telemetry)
            finally:
                # sealed on the crash path too; the previous telemetry is restored for the next run in process
                try:
                    telemetry.close()
                finally:
                    set_active_telemetry(previous)
        finally:
            self._leave_group()

    def _run(self, components: TrainingComponentsInstantiationModel, telemetry: Telemetry) -> list[dict]:
        from modalities_tpu_torch.gym import Gym
        from modalities_tpu_torch.trainer import Trainer
        from modalities_tpu_torch.training.training_progress import TrainingProgress

        settings = components.settings
        rank = env.rank()
        if self.experiments_root_path is not None and rank == 0:
            folder = self.experiments_root_path / self.experiment_id
            folder.mkdir(parents=True, exist_ok=True)
            shutil.copy(self.config_path, folder / self.config_path.name)
        with telemetry.span("init"):
            train_step = self.build_train_step(components)
            app_state = self.load_app_state(components, train_step)
        if rank == 0:
            mesh = train_step.mesh.mesh_axes if train_step.mesh is not None else {}
            print(f"experiment {self.experiment_id}: {train_step.num_parameters:,} trainable parameters on "
                  f"{self.device}, {env.world_size()} rank(s), mesh {mesh}", flush=True)
        resilience = components.resilience
        consensus = resilience is not None and resilience.consensus_enabled()
        mfu = components.mfu_calculator.bind(self.device) if components.mfu_calculator is not None else None
        progress = settings.training_progress
        trainer = Trainer(
            components.progress_subscriber, components.evaluation_subscriber, self.device,
            gradient_acc_steps=settings.step_profile.gradient_accumulation_steps,
            global_num_tokens_per_train_step=settings.tokens_per_step,
            num_seen_train_steps=progress.num_seen_steps,
            training_log_interval_in_steps=settings.intervals.training_log_interval_in_steps,
            mfu_calculator=mfu,
            error_if_nonfinite=bool(getattr(components.gradient_clipper, "error_if_nonfinite", False)),
            global_rank=rank, world_size=env.world_size(),
            anomaly_tracker=resilience.anomaly if resilience is not None else None,
            preemption=resilience.preemption if resilience is not None else None,
            stop_consensus=consensus,
            telemetry=telemetry,
            profiler=components.profiler,
        )
        training_progress = TrainingProgress(
            num_seen_steps_current_run=0,
            num_seen_tokens_current_run=0,
            num_target_steps=settings.training_target.num_target_steps,
            num_target_tokens=settings.training_target.num_target_tokens,
            num_seen_steps_previous_run=progress.num_seen_steps,
            num_seen_tokens_previous_run=progress.global_num_seen_tokens,
        )
        self.train_step = train_step
        self.trainer = trainer
        from modalities_tpu_torch.evaluator import Evaluator
        from modalities_tpu_torch.running_env.device_mesh import get_data_loading_info

        evaluator = Evaluator(components.evaluation_subscriber, self.device,
                              num_data_parallel_ranks=get_data_loading_info(components.device_mesh)[0], global_rank=rank)
        heartbeat = None
        if resilience is not None:
            from modalities_tpu_torch.resilience.heartbeat import cluster_context, set_active_monitor

            artifact_dir = (self.experiments_root_path / self.experiment_id / "telemetry"
                            if self.experiments_root_path is not None else None)
            heartbeat = resilience.build_heartbeat(artifact_dir=artifact_dir)
            if heartbeat is not None:
                heartbeat.start()
                set_active_monitor(heartbeat)
            # the cluster view rides every watchdog dump, whether or not the heartbeat runs
            telemetry.register_watchdog_state_provider(lambda: {"cluster": cluster_context()})
            if resilience.preemption is not None:
                resilience.preemption.install()  # for the training window only
        try:
            return Gym(trainer, evaluator).run(
                app_state, components.train_dataloader, components.eval_dataloaders,
                checkpoint_saving=components.checkpoint_saving,
                training_progress=training_progress,
                evaluation_interval_in_steps=settings.intervals.evaluation_interval_in_steps,
                checkpointing_interval_in_steps=settings.intervals.checkpointing_interval_in_steps,
            )
        finally:
            if heartbeat is not None:
                set_active_monitor(None)
                heartbeat.stop()
            if resilience is not None and resilience.preemption is not None:
                resilience.preemption.uninstall()

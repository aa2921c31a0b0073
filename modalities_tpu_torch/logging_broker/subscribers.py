"""Progress and result subscribers: a plain counterpart of the JAX package's
`progress_subscriber.rich` (a progress line on stdout instead of a rich live
display), and the ports of its results subscribers
(modalities_tpu/logging_broker/subscriber_impl/results_subscriber.py):
`save_to_disc` and `to_disc` (one JSON line per result in
`<output_folder_path>/evaluation_results.jsonl`, or `output_file_path`),
`rich` (a panel a result on rank 0) and `wandb` (rank 0 logs each value under
`<tag>/<name>` at the result's step), plus the `dummy` variants. `rich` and
`wandb` import their package when used and raise a clear error where it is
missing (`wandb` is not a dependency of the port).
"""

from __future__ import annotations

import dataclasses
import json
from pathlib import Path
from typing import Any, Optional

from modalities_tpu_torch.config.config import check_int, check_str

WANDB_MODES = ("ONLINE", "OFFLINE", "DISABLED")


def _require(package: str, what: str):
    """Import `package` for `what`, or raise naming it."""
    import importlib

    try:
        return importlib.import_module(package)
    except ImportError as e:
        raise ImportError(f"{what} needs the `{package}` package, which is not installed; install it or pick "
                          "another results_subscriber variant (save_to_disc, to_disc, dummy)") from e


@dataclasses.dataclass
class PrintProgressSubscriber:
    """Prints `[train] step i/N` on rank 0 (the `rich` variant's fields)."""

    train_dataloader_tag: str
    num_seen_steps: int
    num_target_steps: int
    global_rank: int
    eval_dataloaders: Optional[list] = None

    def __post_init__(self):
        check_str("train_dataloader_tag", self.train_dataloader_tag)
        check_int("num_seen_steps", self.num_seen_steps, ge=0)
        check_int("num_target_steps", self.num_target_steps, ge=1)
        check_int("global_rank", self.global_rank, ge=0)

    def consume(self, step: int) -> None:
        if self.global_rank == 0:
            print(f"[{self.train_dataloader_tag}] step {step}/{self.num_target_steps}", flush=True)


@dataclasses.dataclass
class EvaluationResultToDiscSubscriber:
    """Appends each result as one JSON line to `output_file_path`, or to
    `<output_folder_path>/evaluation_results.jsonl`."""

    output_folder_path: Optional[Path] = None
    output_file_path: Optional[Path] = None

    def __post_init__(self):
        if (self.output_folder_path is None) == (self.output_file_path is None):
            raise ValueError("save_to_disc needs exactly one of output_folder_path and output_file_path")

    @property
    def path(self) -> Path:
        if self.output_file_path is not None:
            return Path(self.output_file_path)
        return Path(self.output_folder_path) / "evaluation_results.jsonl"

    def consume(self, result: dict[str, Any]) -> None:
        self.path.parent.mkdir(parents=True, exist_ok=True)
        with self.path.open("a") as f:
            f.write(json.dumps(result) + "\n")


class DummySubscriber:
    def consume(self, message) -> None:
        pass


def _values(result: dict[str, Any]) -> dict[str, float]:
    return {**result["losses"], **result["metrics"], **result["throughput_metrics"]}


@dataclasses.dataclass
class RichResultSubscriber:
    """A rich panel a result on rank 0: its losses, metrics and throughput
    metrics, titled `[tag] step n`."""

    num_ranks: int = 1
    global_rank: int = 0

    def __post_init__(self):
        check_int("num_ranks", self.num_ranks, ge=1)
        check_int("global_rank", self.global_rank, ge=0)

    def consume(self, result: dict[str, Any]) -> None:
        if self.global_rank != 0:
            return
        console = _require("rich.console", "results_subscriber.rich")
        panel = _require("rich.panel", "results_subscriber.rich")
        lines = [f"{name}: {value}" for name, value in _values(result).items()]
        console.Console().print(panel.Panel("\n".join(lines),
                                            title=f"[{result['dataloader_tag']}] step {result['num_train_steps_done']}"))


@dataclasses.dataclass
class WandBEvaluationResultSubscriberConfig:
    """The JAX config (its `experiment_path` the legacy alias of `directory`)."""

    project: str
    experiment_id: str
    global_rank: int = 0
    entity: Optional[str] = None
    mode: str = "OFFLINE"
    directory: Optional[Path] = None
    experiment_path: Optional[Path] = None
    config_file_path: Optional[Path] = None

    def __post_init__(self):
        check_str("project", self.project)
        check_str("experiment_id", self.experiment_id)
        check_int("global_rank", self.global_rank, ge=0)
        if self.mode.upper() not in WANDB_MODES:
            raise ValueError(f"unknown wandb mode {self.mode!r} (ONLINE | OFFLINE | DISABLED)")


def get_wandb_result_subscriber(project: str, experiment_id: str, global_rank: int = 0, entity: Optional[str] = None,
                                mode: str = "OFFLINE", directory: Optional[Path] = None,
                                experiment_path: Optional[Path] = None, config_file_path: Optional[Path] = None):
    """The JAX factory: only rank 0 logs, DISABLED gives a no-op subscriber,
    and `directory` (or `experiment_path`) pins wandb's folders through its
    environment variables."""
    import os

    if global_rank != 0 or mode.upper() == "DISABLED":
        return DummySubscriber()
    logging_dir = directory if directory is not None else experiment_path
    if logging_dir is not None:
        logging_dir = Path(logging_dir).absolute()
        (logging_dir / "wandb").mkdir(parents=True, exist_ok=True)
        for var in ("WANDB_CACHE_DIR", "WANDB_DIR", "WANDB_DATA_DIR", "WANDB_ARTIFACT_LOCATION", "WANDB_ARTIFACT_DIR",
                    "WANDB_CONFIG_DIR"):
            os.environ[var] = str(logging_dir)
    return WandBEvaluationResultSubscriber(project=project, experiment_id=experiment_id, mode=mode,
                                           experiment_path=logging_dir, config_file_path=config_file_path,
                                           entity=entity)


class WandBEvaluationResultSubscriber:
    """Logs every value of a result as `<tag>/<name>` at its step."""

    def __init__(self, project: str, experiment_id: str, mode: str = "offline", experiment_path: Optional[Path] = None,
                 config_file_path: Optional[Path] = None, entity: Optional[str] = None):
        wandb = _require("wandb", "results_subscriber.wandb")
        self._run = wandb.init(project=project, name=experiment_id, mode=mode.lower(), dir=experiment_path,
                               entity=entity)
        if config_file_path is not None and Path(config_file_path).exists():
            artifact = wandb.Artifact(name=f"config-{experiment_id}", type="config")
            artifact.add_file(str(config_file_path))
            self._run.log_artifact(artifact)

    def consume(self, result: dict[str, Any]) -> None:
        tag = result["dataloader_tag"]
        self._run.log(data={f"{tag}/{name}": float(value) for name, value in _values(result).items()},
                      step=result["num_train_steps_done"])

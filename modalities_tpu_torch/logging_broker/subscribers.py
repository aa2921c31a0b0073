"""Progress and result subscribers: plain counterparts of the JAX package's
`progress_subscriber.rich` (a progress line on stdout instead of a rich live
display) and `results_subscriber.save_to_disc` (one JSON line per result in
`<output_folder_path>/evaluation_results.jsonl`), under the same component
keys, plus the `dummy` variants.
"""

from __future__ import annotations

import dataclasses
import json
from pathlib import Path
from typing import Any, Optional

from modalities_tpu_torch.config.config import check_int, check_str


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

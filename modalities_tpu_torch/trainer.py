"""The training loop: the port of modalities_tpu/trainer.py:Trainer (the
train-steps / interval-publishing core; the JAX loop's telemetry, watchdog,
anomaly, preemption and consensus hooks are not ported).

Each step takes `gradient_accumulation_steps` microbatches from the loader,
moves them to the device as [acc, mb, S] tensors and runs the train step. The
step's metrics stay on the device until a logging interval ends; then they
are fetched once, and one line with loss, grad_norm, lr, tokens/s and MFU is
printed and published to the results subscriber. The loss is the global one
(every rank's step sums it over the ranks); tokens are the global tokens of a
step, and tokens/s per card divides them by the world. Only rank 0 prints and
publishes. On the card the run ends with the peak device memory and the
process's kernel launches (ops.launch_counts).
"""

from __future__ import annotations

import json
import logging
import math
import time
from typing import Callable, Iterator

import numpy as np
import torch

from modalities_tpu_torch.training.training_progress import TrainingProgress

logger = logging.getLogger(__name__)


def stack_microbatches(batches: list, device: torch.device) -> dict:
    """[acc] DatasetBatches of [mb, S] numpy arrays -> {"samples": {k: [acc, mb, S]},
    "targets": {...}} int64 tensors on `device`."""

    def stack(attr):
        keys = getattr(batches[0], attr).keys()
        return {
            k: torch.from_numpy(np.stack([np.asarray(getattr(b, attr)[k]) for b in batches]).astype(np.int64))
            .to(device, non_blocking=True)
            for k in keys
        }

    return {"samples": stack("samples"), "targets": stack("targets")}


class Trainer:
    def __init__(self, progress_subscriber, evaluation_subscriber, device: torch.device, gradient_acc_steps: int = 1,
                 global_num_tokens_per_train_step: int = 0, num_seen_train_steps: int = 0,
                 training_log_interval_in_steps: int = 1, mfu_calculator=None, error_if_nonfinite: bool = False,
                 global_rank: int = 0, world_size: int = 1):
        self.progress_subscriber = progress_subscriber
        self.evaluation_subscriber = evaluation_subscriber
        self.device = device
        self.gradient_acc_steps = gradient_acc_steps
        self.tokens_per_step = global_num_tokens_per_train_step
        self.num_seen_train_steps = num_seen_train_steps
        self.log_interval = training_log_interval_in_steps
        self.mfu_calculator = mfu_calculator
        self.error_if_nonfinite = error_if_nonfinite
        self.global_rank = global_rank
        self.world_size = world_size

    def _feed(self, loader) -> Iterator[dict]:
        group: list = []
        for batch in loader:
            group.append(batch)
            if len(group) == self.gradient_acc_steps:
                yield stack_microbatches(group, self.device)
                group = []
        if group:
            logger.warning("dropping %d trailing microbatches (< gradient_accumulation_steps=%d)",
                           len(group), self.gradient_acc_steps)

    def train(self, train_step, train_loader, training_progress: TrainingProgress,
              evaluation_callback: Callable[[int], None],
              checkpointing_callback: Callable[[TrainingProgress], None]) -> list[dict]:
        """Runs until the target step count or the end of the loader; returns
        the published interval results."""
        step_id = self.num_seen_train_steps
        evaluation_callback(step_id)
        pending: list[dict] = []
        results: list[dict] = []
        interval_start = time.perf_counter()
        for batch in self._feed(train_loader):
            pending.append(train_step(batch))
            step_id += 1
            training_progress.num_seen_steps_current_run += 1
            training_progress.num_seen_tokens_current_run += self.tokens_per_step
            self.progress_subscriber.consume(step_id)
            if step_id % self.log_interval == 0:
                results.append(self._publish(pending, step_id, train_loader.dataloader_tag, interval_start,
                                             training_progress))
                pending = []
                interval_start = time.perf_counter()
            evaluation_callback(step_id)
            checkpointing_callback(training_progress)
            if step_id >= training_progress.num_target_steps:
                break
        if pending:
            results.append(self._publish(pending, step_id, train_loader.dataloader_tag, interval_start,
                                         training_progress))
        if self.device.type == "cuda" and self.global_rank == 0:
            from modalities_tpu_torch.ops import launch_counts

            print(f"[train] peak device memory {torch.cuda.max_memory_allocated(self.device) / 1e9:.2f} GB "
                  f"(torch.cuda.max_memory_allocated, {torch.cuda.get_device_name(self.device)})", flush=True)
            print(f"[train] kernel launches in this process: {json.dumps(launch_counts())}", flush=True)
        return results

    def _publish(self, pending: list[dict], step_id: int, tag: str, interval_start: float,
                 progress: TrainingProgress) -> dict:
        """The one host sync of an interval: fetch its metrics, print a line,
        publish the result."""
        values = {k: torch.stack([m[k].detach().float().cpu() for m in pending]).numpy().astype(np.float64)
                  for k in ("loss", "grad_norm", "lr")}
        wall = max(time.perf_counter() - interval_start, 1e-9)
        if self.error_if_nonfinite and not np.isfinite(values["grad_norm"]).all():
            raise RuntimeError(f"non-finite gradient norm in the interval ending at step {step_id}")
        tokens_per_s = len(pending) * self.tokens_per_step / wall
        throughput = {"train steps/s": len(pending) / wall, "tokens/s": tokens_per_s,
                      "tokens/s per card": tokens_per_s / self.world_size}
        if self.mfu_calculator is not None:
            throughput["MFU"] = self.mfu_calculator.compute(tokens_per_s)
        result = {
            "dataloader_tag": tag,
            "num_train_steps_done": step_id,
            "losses": {"train loss avg": float(values["loss"].mean()), "train loss last": float(values["loss"][-1])},
            "metrics": {
                "grad norm avg": float(values["grad_norm"].mean()),
                "grad norm last": float(values["grad_norm"][-1]),
                "lr mean": float(values["lr"].mean()),
                "consumed tokens": progress.num_seen_tokens_total,
            },
            "throughput_metrics": throughput,
            "device": str(self.device),
        }
        if self.global_rank == 0:
            mfu = throughput.get("MFU", math.nan)
            print(f"[{tag}] step {step_id}: loss {values['loss'][-1]:.5f} grad_norm {values['grad_norm'][-1]:.5f} "
                  f"lr {values['lr'][-1]:.4e} tokens/s {tokens_per_s:.1f} "
                  f"({throughput['tokens/s per card']:.1f} per card of {self.world_size}) MFU {mfu:.4f} "
                  f"({self.device})", flush=True)
            self.evaluation_subscriber.consume(result)
        return result

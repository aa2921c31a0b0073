"""Evaluation over N dataloaders: the port of modalities_tpu/evaluator.py.

For each loader, every batch goes through the train step's `eval_step` (the
forward alone; the global token mean of the loss, under pp the F ops of the
schedule), and one result is published per loader through the evaluation
subscriber, as the JAX `EvaluationResultBatch`: `losses["loss avg"]` (the
mean over the loader's batches) and `throughput_metrics["eval samples/s"]`
(the global samples over the wall time, read after the losses are fetched,
so the clock covers the device's work). Only rank 0 publishes; every rank
returns the results. Each loader's pass runs under an `eval/<tag>` telemetry
span (goodput bucket: eval).
"""

from __future__ import annotations

import time

import numpy as np
import torch

from modalities_tpu_torch.dataloader.dataloader import device_tensor
from modalities_tpu_torch.telemetry import span


class Evaluator:
    def __init__(self, evaluation_subscriber, device: torch.device, num_data_parallel_ranks: int = 1,
                 global_rank: int = 0):
        self.evaluation_subscriber = evaluation_subscriber
        self.device = torch.device(device)
        self.num_data_parallel_ranks = num_data_parallel_ranks
        self.global_rank = global_rank

    def _batch(self, batch) -> dict:
        def tensors(part: dict) -> dict:
            return {k: device_tensor(v, self.device) for k, v in part.items()}

        return {"samples": tensors(batch.samples), "targets": tensors(batch.targets)}

    def evaluate(self, train_step, data_loaders: list, num_train_steps_done: int) -> dict[str, dict]:
        results: dict[str, dict] = {}
        for loader in data_loaders:
            with span(f"eval/{loader.dataloader_tag}"):
                start = time.perf_counter()
                losses, num_samples = [], 0
                for batch in loader:
                    device_batch = self._batch(batch)
                    losses.append(train_step.eval_step(device_batch)["loss"])
                    num_samples += len(batch) * self.num_data_parallel_ranks
                values = (torch.stack([loss.detach().float().cpu() for loss in losses]).numpy() if losses
                          else np.array([]))
                elapsed = max(time.perf_counter() - start, 1e-9)
            result = {
                "dataloader_tag": loader.dataloader_tag,
                "num_train_steps_done": num_train_steps_done,
                "losses": {"loss avg": float(values.mean()) if len(values) else float("nan")},
                "metrics": {},
                "throughput_metrics": {"eval samples/s": num_samples / elapsed},
            }
            if self.global_rank == 0:
                print(f"[{loader.dataloader_tag}] evaluation after step {num_train_steps_done}: loss avg "
                      f"{result['losses']['loss avg']:.5f} ({num_samples} samples, "
                      f"{result['throughput_metrics']['eval samples/s']:.1f} samples/s)", flush=True)
                self.evaluation_subscriber.consume(result)
            results[loader.dataloader_tag] = result
        return results

"""Loss functions: the port of modalities_tpu/loss_functions.py
(`CLMCrossEntropyLoss`).

Plain PyTorch is the port here: on the training path the JAX package computes
this loss outside any Pallas kernel, over the full fp32 logits.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F

from modalities_tpu_torch.config.config import check_int, check_str


@dataclasses.dataclass
class CLMCrossEntropyLoss:
    """Mean causal-LM cross entropy over the targets != `ignore_index`, in fp32
    (JAX loss_functions.py:30-67)."""

    target_key: str
    prediction_key: str
    tag: str = "CLMCrossEntropyLoss"
    ignore_index: int = -100

    def __post_init__(self):
        check_str("target_key", self.target_key)
        check_str("prediction_key", self.prediction_key)
        check_str("tag", self.tag)
        check_int("ignore_index", self.ignore_index)

    def sum_and_count(self, logits, labels):
        """(sum of per-token CE over the non-ignored positions, their count)."""
        total = F.cross_entropy(
            logits.float().reshape(-1, logits.shape[-1]), labels.reshape(-1).long(),
            ignore_index=self.ignore_index, reduction="sum",
        )
        return total, (labels != self.ignore_index).sum().float()

    def fused_sum_and_count(self, hidden, head_weight, labels):
        raise NotImplementedError(
            "the fused (vocab-streaming) cross entropy is the next slice of the port: it needs the fused-CE "
            "kernels (modalities_tpu/ops/pallas/fused_ce.py); ROADMAP.md, Queue 1 item 1"
        )

    def __call__(self, predictions: dict, targets: dict):
        total, count = self.sum_and_count(predictions[self.prediction_key], targets[self.target_key])
        return total / torch.clamp(count, min=1.0)

"""Loss functions: the port of modalities_tpu/loss_functions.py
(`CLMCrossEntropyLoss`, `NCELoss`).

`sum_and_count` and `__call__` are plain PyTorch over the full fp32 logits, as
the JAX package computes them outside any Pallas kernel. `fused_sum_and_count`
takes the hidden states and the head weight instead and goes through the
fused-CE kernels (ops/fused_ce.py), so the logits never exist. Given a
`vocab_group` (tensor parallelism), both take this rank's shard of the
vocabulary and reduce over the group (parallel/vocab_parallel_ce.py).
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F

from modalities_tpu_torch.config.config import check_bool, check_float, check_int, check_str
from modalities_tpu_torch.ops.fused_ce import fused_ce_sum_and_count
from modalities_tpu_torch.parallel.vocab_parallel_ce import (
    vocab_parallel_fused_sum_and_count,
    vocab_parallel_sum_and_count,
)


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

    def sum_and_count(self, logits, labels, vocab_group=None):
        """(sum of per-token CE over the non-ignored positions, their count);
        with `vocab_group`, over logits sharded on the vocabulary (loss
        parallelism)."""
        if vocab_group is not None:
            return vocab_parallel_sum_and_count(logits, labels, vocab_group, ignore_index=self.ignore_index)
        total = F.cross_entropy(
            logits.float().reshape(-1, logits.shape[-1]), labels.reshape(-1).long(),
            ignore_index=self.ignore_index, reduction="sum",
        )
        return total, (labels != self.ignore_index).sum().float()

    def fused_sum_and_count(self, hidden, head_weight, labels, vocab_group=None):
        """`sum_and_count` of the logits hidden [..., E] @ head_weight.T
        ([V, E], or this rank's [V / tp, E] with `vocab_group`) without
        materializing them (JAX loss_functions.py:51-61)."""
        if vocab_group is not None:
            return vocab_parallel_fused_sum_and_count(hidden, head_weight, labels, vocab_group,
                                                      ignore_index=self.ignore_index)
        return fused_ce_sum_and_count(hidden, head_weight, labels, ignore_index=self.ignore_index)

    def __call__(self, predictions: dict, targets: dict):
        total, count = self.sum_and_count(predictions[self.prediction_key], targets[self.target_key])
        return total / torch.clamp(count, min=1.0)


@dataclasses.dataclass
class NCELoss:
    """InfoNCE contrastive loss of two embedding predictions, CoCa's (JAX
    loss_functions.py:70-99): both L2-normalized in fp32 (norms clamped at
    1e-8), similarities e1 e2^T / temperature, the cross entropy of each row
    against its own column; the mean of both directions unless
    `is_asymmetric`. Row i of each prediction is one pair, so the loss is a
    mean over this process's rows (no sum_and_count form)."""

    prediction_key1: str
    prediction_key2: str
    is_asymmetric: bool = True
    temperature: float = 1.0
    tag: str = "NCELoss"

    def __post_init__(self):
        check_str("prediction_key1", self.prediction_key1)
        check_str("prediction_key2", self.prediction_key2)
        check_bool("is_asymmetric", self.is_asymmetric)
        self.temperature = check_float("temperature", self.temperature)
        check_str("tag", self.tag)

    def __call__(self, predictions: dict, targets: dict):
        e1, e2 = (F.normalize(predictions[k].float(), dim=-1, eps=1e-8)
                  for k in (self.prediction_key1, self.prediction_key2))
        sim = e1 @ e2.t() / self.temperature
        labels = torch.arange(sim.shape[0], device=sim.device)
        loss_12 = F.cross_entropy(sim, labels)
        if self.is_asymmetric:
            return loss_12
        return 0.5 * (loss_12 + F.cross_entropy(sim.t(), labels))

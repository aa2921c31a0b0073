"""The train step: the port of the non-mesh branch of
modalities_tpu/training/train_step.py:TrainStepBuilder (`build`, :337-354,
:413-507, :550-551, :553-691).

One optimizer step over `gradient_accumulation_steps` microbatches: for each,
the forward, the loss and its backward. The head and loss take one of three
routes, as in the JAX builder:
- no `lm_head_chunk_size`: logits [B, S, V] fp32, then the loss over them;
- a chunk size and `lm_head_fused_ce` auto/on: the backbone's hidden states
  and the head weight go to the loss's `fused_sum_and_count`, the fused-CE
  kernels (ops/fused_ce.py), and no logits exist;
- a chunk size and `off`: the chunked scan, chunk logits and their loss under
  `torch.utils.checkpoint` one sequence chunk at a time (a ragged tail is one
  shorter chunk), so the backward recomputes each chunk's logits.
The two chunked routes return total / max(count, 1) over the token-weighted
(sum, count) of the loss's `sum_and_count` form. The gradients
are added into an fp32 accumulator (`reduce_dtype`). Then they are divided by
the number of microbatches and cast to the parameters' dtype, their global
norm is taken in fp32 and reported, they are clipped, and `optimizer.step()`
and `scheduler.step()` run. The step returns its metrics as 0-d device
tensors (`loss`, the mean over microbatches; `grad_norm`; `lr`, the rate this
step used), so the trainer syncs with the device only when it logs.

Knobs of the JAX builder that this branch does not handle raise
NotImplementedError naming their ROADMAP.md item.
"""

from __future__ import annotations

from typing import Any, Optional

import torch

from modalities_tpu_torch.training.activation_checkpointing import checkpointed
from modalities_tpu_torch.training.gradient_clipping import GradientClippingMode, clip_, global_norm


class TrainStep:
    """Model + loss + optimizer + schedule + clipping on one device.

    `params` (a state dict, e.g. `conversion.from_jax.params_from_jax` of a JAX
    tree) replaces fresh initialization; otherwise `model.init_train_params`
    draws them from a generator seeded with `seed` (default: the model's)."""

    def __init__(self, model, loss_fn, optimizer_spec, scheduler_spec=None, *, device,
                 gradient_acc_steps: int = 1, grad_clipper=None, params: Optional[dict] = None,
                 seed: Optional[int] = None):
        spec = model.config_spec
        self.head_chunk = spec.lm_head_chunk_size
        if self.head_chunk is not None and not hasattr(loss_fn, "sum_and_count"):
            # silently materializing the [B, S, V] logits would be the memory blowup the chunking exists to prevent
            raise ValueError(
                f"lm_head_chunk_size={self.head_chunk} requires a loss with the sum_and_count accumulation form "
                f"(got loss {type(loss_fn).__name__}); unset the chunk size or use a CLM-style loss"
            )
        self.fused_ce = (self.head_chunk is not None and spec.lm_head_fused_ce in ("auto", "on")
                         and hasattr(loss_fn, "fused_sum_and_count"))
        mp = model.train_spec.mixed_precision
        model.with_spec_updates(param_dtype=mp.param_dtype, compute_dtype=mp.compute_dtype)
        self.reduce_dtype = getattr(torch, mp.reduce_dtype)
        self.model = model
        self.loss_fn = loss_fn
        self.device = torch.device(device)
        self.acc_steps = int(gradient_acc_steps)
        self.clipper = grad_clipper
        if params is None:
            generator = torch.Generator(device=self.device).manual_seed(model.seed if seed is None else seed)
            params = model.init_train_params(generator)
        else:
            params = {k: v.to(self.device) for k, v in params.items()}
        self.module = model.build_train_module(params)
        named = list(self.module.named_parameters())
        self.params = [p for _, p in named]
        self.optimizer = optimizer_spec.build(named)
        fn = scheduler_spec.schedule() if scheduler_spec is not None else (lambda step: 1.0)
        self.scheduler = torch.optim.lr_scheduler.LambdaLR(self.optimizer, fn)
        self._acc: Optional[list[torch.Tensor]] = None

    @property
    def num_parameters(self) -> int:
        return sum(p.numel() for p in self.params)

    def _zero_accumulators(self) -> list[torch.Tensor]:
        if self._acc is None:
            self._acc = [torch.zeros(p.shape, dtype=self.reduce_dtype, device=p.device) for p in self.params]
        else:
            for a in self._acc:
                a.zero_()
        return self._acc

    def _chunk_sum_count(self, hidden, labels):
        return self.loss_fn.sum_and_count(self.module.head_logits(hidden), labels)

    def _chunked_ce(self, hidden, labels):
        """The loss of the chunked routes (JAX train_step.py:457-492)."""
        if self.fused_ce:
            total, count = self.loss_fn.fused_sum_and_count(hidden, self.module.head_weight(), labels)
            return total / torch.clamp(count, min=1.0)
        seq = hidden.shape[1]
        if seq > self.head_chunk:
            total = torch.zeros((), dtype=torch.float32, device=hidden.device)
            count = torch.zeros((), dtype=torch.float32, device=hidden.device)
            for start in range(0, seq, self.head_chunk):  # the last chunk is the ragged tail, if any
                end = start + self.head_chunk
                s, c = checkpointed(self._chunk_sum_count, hidden[:, start:end], labels[:, start:end])
                total, count = total + s, count + c
        else:  # short sequences: one chunk, no recompute
            total, count = self._chunk_sum_count(hidden, labels)
        return total / torch.clamp(count, min=1.0)

    def _loss(self, inputs, targets: dict):
        if self.head_chunk is None:
            return self.loss_fn({self.model.prediction_key: self.module(inputs)}, targets)
        return self._chunked_ce(self.module.forward_hidden(inputs), targets[self.loss_fn.target_key])

    def __call__(self, batch: dict) -> dict[str, Any]:
        """batch: {"samples": {key: [acc, mb, S]}, "targets": {key: [acc, mb, S]}}
        (integer tensors on the step's device) -> metrics."""
        samples, targets = batch["samples"], batch["targets"]
        sample_key = self.model.sample_key
        if samples[sample_key].shape[0] != self.acc_steps:
            raise ValueError(f"batch holds {samples[sample_key].shape[0]} microbatches, the step takes {self.acc_steps}")
        acc = self._zero_accumulators()
        loss_sum = torch.zeros((), dtype=torch.float32, device=self.device)
        for i in range(self.acc_steps):
            loss = self._loss(samples[sample_key][i], {k: v[i] for k, v in targets.items()})
            grads = torch.autograd.grad(loss, self.params)
            for a, g in zip(acc, grads):
                a.add_(g)
            del grads
            loss_sum += loss.detach()
        lr = torch.tensor(self.optimizer.param_groups[0]["lr"], dtype=torch.float32)
        for p, a in zip(self.params, acc):
            p.grad = (a / self.acc_steps).to(p.dtype)
        grads = [p.grad for p in self.params]
        mode = self.clipper.norm_type if self.clipper is not None else GradientClippingMode.P2_NORM
        grad_norm = global_norm(grads, mode)
        if self.clipper is not None and self.clipper.max_norm is not None:
            clip_(grads, grad_norm, self.clipper.max_norm, mode)
        self.optimizer.step()
        self.scheduler.step()
        for p in self.params:
            p.grad = None
        return {"loss": loss_sum / self.acc_steps, "grad_norm": grad_norm, "lr": lr}

    def state_dict(self) -> dict[str, torch.Tensor]:
        return self.module.state_dict()

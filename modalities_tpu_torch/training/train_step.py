"""The train step: the port of
modalities_tpu/training/train_step.py:TrainStepBuilder (`build`, :337-354,
:413-507, :550-551, :553-691) for meshes of data, context and tensor
parallelism.

With a device mesh (running_env/device_mesh.py) the module takes the
tensor-parallel plan over the mesh's tp axis when it has one
(parallel/tensor_parallel.py), is sharded with FSDP2 over the dp dims
(parallel/fsdp.py), each rank feeds its own data-parallel rows (the
sampler's; the tp ranks of one dp coordinate feed the same rows), and under
cp each rank takes its contiguous chunk of every sequence and attends over
the cp ring. Without one (`device_mesh=None`) the module stays whole on its
device and nothing is exchanged.

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
Under tensor parallelism the logits are this rank's vocab columns under loss
parallelism (the loss reduces over tp) and gathered otherwise; the fused-CE
route always runs on this rank's vocab shard of the head
(parallel/vocab_parallel_ce.py). Every route gives this rank's
token-weighted (sum, count) of the loss's `sum_and_count` form; the count is
summed over the ranks that hold other rows (every rank but the other tp
ranks, which hold the same rows: `DeviceMesh.batch_group`), and the rank's
loss is its sum over max(global count, 1), so the losses of one tp
coordinate add up to the global loss of the JAX step (the mean over all rows
and chunks of the microbatch) and FSDP2's summed reduction gives its
gradient. `backward()` runs; each parameter's (sharded) gradient is added
into an fp32 accumulator (`reduce_dtype`) and cleared. The gradients of
tp-replicated parameters are then summed over tp (each rank's is a partial
sum over its rows or heads). Then the accumulators are divided by the number
of microbatches and cast to the parameters' dtype, their global norm is taken
in fp32 and reported, they are clipped, and `optimizer.step()` and
`scheduler.step()` run. The step returns its metrics as 0-d device
tensors (`loss`, the mean over microbatches; `grad_norm`; `lr`, the rate this
step used; the loss summed over the ranks), so the trainer syncs with the
device only when it logs.

Knobs of the JAX builder that this branch does not handle raise
NotImplementedError naming their ROADMAP.md item.
"""

from __future__ import annotations

from typing import Any, Optional

import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor

from modalities_tpu_torch.parallel.tensor_parallel import apply_tensor_parallel, sum_replicated_grads
from modalities_tpu_torch.training.activation_checkpointing import checkpointed
from modalities_tpu_torch.training.gradient_clipping import GradientClippingMode, clip_, global_norm


class TrainStep:
    """Model + loss + optimizer + schedule + clipping on this rank's device.

    `params` (a state dict, e.g. `conversion.from_jax.params_from_jax` of a JAX
    tree) replaces fresh initialization; otherwise `model.init_train_params`
    draws them from a generator seeded with `seed` (default: the model's).
    Every rank starts from the same whole parameters and keeps its shards.
    `device_mesh`: the mesh component (its process group must exist)."""

    def __init__(self, model, loss_fn, optimizer_spec, scheduler_spec=None, *, device,
                 gradient_acc_steps: int = 1, grad_clipper=None, params: Optional[dict] = None,
                 seed: Optional[int] = None, device_mesh=None):
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
        del params
        self.mesh = device_mesh
        self.cp_group = self.tp_group = self.batch_group = self.logits_group = None
        if device_mesh is not None:
            from modalities_tpu_torch.parallel.fsdp import shard_model

            if dist.get_world_size() > 1 and self.head_chunk is None and not hasattr(loss_fn, "sum_and_count"):
                raise ValueError(f"loss {type(loss_fn).__name__} has no sum_and_count form: the global loss over "
                                 "ranks needs each rank's (sum, count)")
            tp_mesh = device_mesh.tp_mesh(self.device)
            if tp_mesh is not None:
                apply_tensor_parallel(self.module, tp_mesh, loss_parallel=device_mesh.enable_loss_parallel)
                self.tp_group = tp_mesh.get_group()
                self.logits_group = self.tp_group if device_mesh.enable_loss_parallel else None
            self.batch_group = device_mesh.batch_group(self.device)
            fsdp = model.train_spec.fsdp
            shard_model(self.module, device_mesh.fsdp_mesh(self.device), layers_per_fsdp_unit=fsdp.layers_per_fsdp_unit,
                        reshard_after_forward=fsdp.reshard_after_forward, reduce_dtype=self.reduce_dtype)
            self.cp_group = device_mesh.cp_group(self.device)
            self.module.set_context_parallel(self.cp_group)
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
            self._acc = [torch.zeros(_local(p).shape, dtype=self.reduce_dtype, device=p.device) for p in self.params]
        else:
            for a in self._acc:
                a.zero_()
        return self._acc

    def _logits_sum_count(self, logits, labels):
        """The loss's (sum, count) of logits: over vocab shards under loss parallelism."""
        if self.logits_group is None:
            return self.loss_fn.sum_and_count(logits, labels)
        return self.loss_fn.sum_and_count(logits, labels, vocab_group=self.logits_group)

    def _chunk_sum_count(self, hidden, labels):
        return self._logits_sum_count(self.module.head_logits(hidden), labels)

    def _chunked_ce(self, hidden, labels):
        """(sum, count) of the chunked routes (JAX train_step.py:457-492)."""
        if self.fused_ce:
            if self.tp_group is not None:
                return self.loss_fn.fused_sum_and_count(hidden, self.module.head_weight(), labels,
                                                        vocab_group=self.tp_group)
            return self.loss_fn.fused_sum_and_count(hidden, self.module.head_weight(), labels)
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
        return total, count

    def _sum_count(self, inputs, targets: dict):
        """This rank's (loss sum, token count) of a microbatch; a loss without
        the sum_and_count form gives (its mean, 1)."""
        if self.head_chunk is not None:
            return self._chunked_ce(self.module.forward_hidden(inputs), targets[self.loss_fn.target_key])
        if hasattr(self.loss_fn, "sum_and_count"):
            return self._logits_sum_count(self.module(inputs), targets[self.loss_fn.target_key])
        mean = self.loss_fn({self.model.prediction_key: self.module(inputs)}, targets)
        return mean, torch.ones((), device=self.device)

    def _loss(self, inputs, targets: dict):
        """This rank's share of the microbatch's global loss: its sum over the
        token count of the ranks that hold other rows."""
        total, count = self._sum_count(inputs, targets)
        count = count.detach().float().clone()
        if self.mesh is not None:
            dist.all_reduce(count, group=self.batch_group)
        return total / torch.clamp(count, min=1.0)

    def _local_rows(self, t: torch.Tensor) -> torch.Tensor:
        """[mb, S] -> this rank's contiguous sequence chunk [mb, S / cp] under cp."""
        if self.cp_group is None:
            return t
        cp, seq = self.cp_group.size(), t.shape[-1]
        if seq % cp:
            raise ValueError(f"sequence length {seq} is not divisible by the cp degree {cp}")
        chunk = seq // cp
        return t[..., self.cp_group.rank() * chunk:(self.cp_group.rank() + 1) * chunk]

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
            loss = self._loss(self._local_rows(samples[sample_key][i]),
                              {k: self._local_rows(v[i]) for k, v in targets.items()})
            loss.backward()
            with torch.no_grad():
                for p, a in zip(self.params, acc):
                    if p.grad is not None:
                        a.add_(_local(p.grad))
                        p.grad = None
            loss_sum += loss.detach()
        if self.mesh is not None:
            dist.all_reduce(loss_sum, group=self.batch_group)
        if self.tp_group is not None:
            sum_replicated_grads(self.params, acc, self.tp_group)
        lr = torch.tensor(self.optimizer.param_groups[0]["lr"], dtype=torch.float32)
        with torch.no_grad():
            for p, a in zip(self.params, acc):
                g = (a / self.acc_steps).to(p.dtype)
                p.grad = (DTensor.from_local(g, p.device_mesh, p.placements, shape=p.shape, stride=p.stride())
                          if isinstance(p, DTensor) else g)
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
        """The module's parameters, whole: sharded ones are gathered from every
        rank (all ranks must call), except on a 1-rank mesh, whose one shard is
        the whole tensor (read without the process group, which may be gone)."""
        return {k: _full(v) for k, v in self.module.state_dict().items()}


def _local(t: torch.Tensor) -> torch.Tensor:
    return t.to_local() if isinstance(t, DTensor) else t


def _full(t: torch.Tensor) -> torch.Tensor:
    if not isinstance(t, DTensor):
        return t
    return t.to_local() if t.device_mesh.size() == 1 else t.full_tensor()

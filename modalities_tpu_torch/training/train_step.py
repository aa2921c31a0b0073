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
- a chunk size and `lm_head_fused_ce` auto/on (MODALITIES_TPU_FUSED_CE before
  it, as in JAX: ops/tiers.py): the backbone's hidden states
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

Pipeline parallelism (the mesh's pp axis; or `pp_in_process`, every stage
in one process, for the card's one-GPU checks): the train step holds this
rank's stage (parallel/pipeline.py, the tp plan and FSDP2 applied to it) and
each microbatch's rows are split into the schedule's M microbatches of
contiguous rows; the schedule's F and B ops run tick by tick
(parallel/pipeline_scheduled.py), the last stage's head giving each
microbatch's loss sum over the microbatch's global token count (known before
the first F op: the count over the batch group, never over pp); every
backward's gradients go into the fp32 accumulators at once, so each
pipeline microbatch is accumulated in fp32 as an accumulation microbatch
is. A tied
`wte` (a copy on the first and on the last stage) has its two gradients
summed over pp once a step, counted once in the norm, and takes the same
step on both. The norm's sum of squares is reduced over pp as well; the
loss of the last stage is broadcast over pp, so every rank reports it.

Cross-slice data parallelism (the mesh's dcn axis, JAX train_step.py:
277-335, 563-625, 706-715): each slice's ranks hold the slice's rows (a
contiguous block of each global microbatch, as JAX `to_dcn_groups` cuts
it: the sampler deals by the flat dp coordinate of `get_data_loading_info`,
dcn outermost), the
token count and the loss's sum run over the slice's batch group, and FSDP2,
tp and cp exchange within the slice, so each slice computes its own loss,
normalized by its own tokens, and its own gradient, with no cross-slice
traffic in the microbatch loop. After the loop the accumulators (and the
loss sums) are summed over the dcn group in one flat all-reduce and divided
by the number of slices, then by the number of microbatches: the loss is the
mean of the slices' losses, which with unequal token counts is not the
global token mean, as in the JAX step.

ZeRO-1 (stage 1 over dp_replicate > 1, parallel/zero.py): FSDP2 shards
within a replica and reduces each microbatch over the FSDP dim only; after
the loop each accumulator is reduce-scattered over dp_replicate onto this
rank's chunk of its ZeRO dim (the dcn reduction then runs on the chunks, as
the JAX step reduces over dcn in the ZeRO layout), the norm sums each chunk
once, the optimizer updates the chunks and one all-gather a leaf restores
the parameters.

`dcn_in_process` runs that many slices in this process (without a mesh or
on a 1-rank one), for the card's one-GPU check: each microbatch's rows are
cut into the slices' contiguous blocks, each slice's loss is normalized by
its own tokens and its gradients go into accumulators of its own, which are
summed in slice order after the loop, as the dcn all-reduce sums them.
`zero_in_process` runs ZeRO-1 for that many dp_replicate replicas in this
process (`Zero1` over `InProcessReplicas`): the one accumulator already
sums every replica's rows, each replica's chunks take the update, and the
chunks are gathered back into the parameters.

The rate (JAX: optax's schedule count in the optimizer state): the update
applies the schedule at the optimizer's own step count, the updates applied
so far, while `lr` reports the schedule at the step count, every step taken,
as JAX reports `lr_fn(state.step)`. The two part only after a skipped step.
The applied rate is a device tensor gathered from a table of the schedule's
rates at the optimizer's step count (clamped to the steps taken), so reading
the count needs no host sync. Every step takes this rate, so a run with and
one without the component update alike.

The anomaly skip (`anomaly_policy` skip_step or rollback, JAX
train_step.py:401-411, :631-679): a step whose loss or global gradient norm
is not finite keeps the parameters, both moments and AdamW's step count
bitwise, while the LR schedule's step still advances, and reports
`skipped_step`. As in JAX, the rate applied after a skip is then the one of
the updates applied so far (above). The norm is the reduced one, so every
rank takes the same branch. The flag stays on the device: it is the fused
optimizer's `found_inf` (optimizers/optimizer_factory.py), so there is no
host sync in the step and no copy of the parameters or moments. The fault points `nan_grads@N` and
`loss_spike@N[:magnitude]` (resilience/faults.py) armed when the step is
built poison the gradients, or raise the reported loss, at the step whose
count before the update is N; with none armed the step is unchanged. With
`BALLOT_KEY` in the batch (resilience/coordination.py, the stop consensus)
the step MAX-reduces the rank's vote over the world group and reports it.

`eval_step` is the forward alone on one batch ([mb, S]): the global token
mean of the loss, every head route, under pp the F ops of the tables; over
dcn, the mean of the slices' token means.

Knobs of the JAX builder that this branch does not handle raise
NotImplementedError naming their ROADMAP.md item.
"""

from __future__ import annotations

from typing import Any, Optional

import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor

from modalities_tpu_torch.ops.tiers import fused_ce_enabled
from modalities_tpu_torch.parallel.pipeline import PipelineStage, build_stage_module
from modalities_tpu_torch.parallel.pipeline_scheduled import InProcess, P2PTransport, run_schedule
from modalities_tpu_torch.parallel.pipeline_schedules import build_schedule_tables
from modalities_tpu_torch.parallel.tensor_parallel import apply_tensor_parallel, sum_replicated_grads
from modalities_tpu_torch.parallel.zero import Zero1
from modalities_tpu_torch.resilience.coordination import BALLOT_KEY, reduce_ballot
from modalities_tpu_torch.resilience.faults import get_fault
from modalities_tpu_torch.running_env import env
from modalities_tpu_torch.training.activation_checkpointing import checkpointed
from modalities_tpu_torch.training.gradient_clipping import GradientClippingMode, clip_, global_norm


class TrainStep:
    """Model + loss + optimizer + schedule + clipping on this rank's device.

    `params` (a state dict, e.g. `conversion.from_jax.params_from_jax` of a JAX
    tree) replaces fresh initialization; otherwise `model.init_train_params`
    draws them from a generator seeded with `seed` (default: the model's).
    Every rank starts from the same whole parameters and keeps its shards.
    `device_mesh`: the mesh component (its process group must exist).
    `pp_in_process`: run that many pipeline stages in this process (the
    in-process transport), without a mesh or on a 1-rank one (each stage
    then a root of FSDP2 of its own). `dcn_in_process`: run that many dcn
    slices in this process, likewise. `zero_in_process`: ZeRO-1 over that
    many dp_replicate replicas in this process, likewise.
    `anomaly_policy`: the resilience component's (None: no component; skip_step
    and rollback arm the anomaly skip)."""

    def __init__(self, model, loss_fn, optimizer_spec, scheduler_spec=None, *, device,
                 gradient_acc_steps: int = 1, grad_clipper=None, params: Optional[dict] = None,
                 seed: Optional[int] = None, device_mesh=None, pp_in_process: Optional[int] = None,
                 dcn_in_process: Optional[int] = None, zero_in_process: Optional[int] = None,
                 anomaly_policy: Optional[str] = None):
        spec = model.config_spec
        self.skip_on_anomaly = anomaly_policy in ("skip_step", "rollback")
        # fault baking: armed faults are resolved once, here (JAX train_step.py:401-411)
        self.nan_grads_fault = get_fault("nan_grads")
        self.loss_spike_fault = get_fault("loss_spike")
        self.head_chunk = spec.lm_head_chunk_size
        if self.head_chunk is not None and not hasattr(loss_fn, "sum_and_count"):
            # silently materializing the [B, S, V] logits would be the memory blowup the chunking exists to prevent
            raise ValueError(
                f"lm_head_chunk_size={self.head_chunk} requires a loss with the sum_and_count accumulation form "
                f"(got loss {type(loss_fn).__name__}); unset the chunk size or use a CLM-style loss"
            )
        self.fused_ce = (self.head_chunk is not None and fused_ce_enabled(spec.lm_head_fused_ce)
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
        self.mesh = device_mesh
        self.cp_group = self.tp_group = self.batch_group = self.logits_group = self.pp_group = self.dcn_group = None
        self.dcn = device_mesh.dcn_parallel_degree if device_mesh is not None else 1
        self.slices = 1  # the slices this process runs
        if dcn_in_process:
            if device_mesh is not None and dist.get_world_size() > 1 or pp_in_process:
                raise ValueError("dcn_in_process runs every slice in this process: without pp_in_process, and "
                                 "without a device mesh or on a 1-rank one")
            self.dcn = self.slices = int(dcn_in_process)
        zero = device_mesh is not None and device_mesh.zero_active
        if zero_in_process and (device_mesh is not None and dist.get_world_size() > 1 or pp_in_process
                                or dcn_in_process):
            raise ValueError("zero_in_process holds every replica in this process: without pp_in_process or "
                             "dcn_in_process, and without a device mesh or on a 1-rank one")
        pp = device_mesh.pipeline_parallel_degree if device_mesh is not None else 1
        if pp_in_process:
            if device_mesh is not None and dist.get_world_size() > 1:
                raise ValueError("pp_in_process runs every stage in this process: without a device mesh or on a "
                                 f"1-rank one (the world has {dist.get_world_size()} ranks)")
            pp = int(pp_in_process)
        self.stages: list[PipelineStage] = []
        self.pp_degree = pp
        self._tables_by_count: dict = {}
        if pp > 1:
            if not hasattr(loss_fn, "sum_and_count"):
                raise ValueError(f"loss {type(loss_fn).__name__} has no sum_and_count form: the pipeline's loss is "
                                 "each microbatch's (sum, count)")
            self.pp_microbatches = spec.pp_num_microbatches or pp
            layout = self._tables(pp, self.pp_microbatches)
            self._first_device, self._last_device = layout.device_of(0), layout.device_of(layout.num_stages_global - 1)
            devices = range(pp) if pp_in_process else [device_mesh.pp_rank()]
            self.stages = [PipelineStage(build_stage_module(
                model, {k: v.clone() for k, v in params.items()} if pp_in_process else params, layout, d),
                layout, d) for d in devices]
            self.module = None if pp_in_process else self.stages[0].module
        else:
            self.module = model.build_train_module(params)
        del params
        modules = [st.module for st in self.stages] or [self.module]
        if device_mesh is not None:
            from modalities_tpu_torch.parallel.fsdp import shard_model

            if dist.get_world_size() > 1 and self.head_chunk is None and not hasattr(loss_fn, "sum_and_count"):
                raise ValueError(f"loss {type(loss_fn).__name__} has no sum_and_count form: the global loss over "
                                 "ranks needs each rank's (sum, count)")
            tp_mesh = device_mesh.tp_mesh(self.device)
            if tp_mesh is not None:
                for module in modules:
                    apply_tensor_parallel(module, tp_mesh, loss_parallel=device_mesh.enable_loss_parallel)
                self.tp_group = tp_mesh.get_group()
                self.logits_group = self.tp_group if device_mesh.enable_loss_parallel else None
            self.batch_group = device_mesh.batch_group(self.device)
            fsdp = model.train_spec.fsdp
            self.cp_group = device_mesh.cp_group(self.device)
            for module in modules:  # under pp_in_process every stage is a root of its own
                shard_model(module, device_mesh.fsdp_mesh(self.device), layers_per_fsdp_unit=fsdp.layers_per_fsdp_unit,
                            reshard_after_forward=fsdp.reshard_after_forward, reduce_dtype=self.reduce_dtype)
                module.set_context_parallel(self.cp_group)
            self.dcn_group = device_mesh.dcn_group(self.device)
            self.pp_group = device_mesh.pp_group(self.device)
            if self.pp_group is not None:  # NCCL: a group's first call must include all its ranks; the
                dist.barrier(group=self.pp_group)  # schedule's P2P calls pair two
        named = [item for module in modules for item in module.named_parameters()]
        self.params = [p for _, p in named]
        # a tied wte on two pp devices: the first stage's and the last stage's copy (summed, counted once)
        self._tied_first = self._tied_copy = None
        if self.stages and spec.use_weight_tying and self._first_device != self._last_device:
            for st in self.stages:
                index = next(i for i, p in enumerate(self.params) if p is st.module.wte) if hasattr(
                    st.module, "wte") else None
                if st.is_first:
                    self._tied_first = index
                elif st.is_last:
                    self._tied_copy = index
        self.zero = (Zero1(named, optimizer_spec, device_mesh.torch_mesh(self.device)) if zero
                     else Zero1(named, optimizer_spec, replicas=int(zero_in_process)) if zero_in_process else None)
        self.optimizer = self.zero.optimizer if self.zero is not None else optimizer_spec.build(named)
        fn = scheduler_spec.schedule() if scheduler_spec is not None else (lambda step: 1.0)
        self.scheduler = torch.optim.lr_scheduler.LambdaLR(self.optimizer, fn)
        self._rates: Optional[torch.Tensor] = None  # [groups, steps]: the schedule's rates, filled ahead
        self._acc: Optional[list[torch.Tensor]] = None
        self._slice_acc: list[list[torch.Tensor]] = []  # the other in-process slices' accumulators

    @property
    def num_parameters(self) -> int:
        return sum(p.numel() for p in self.params)

    def _zero_accumulators(self) -> list[torch.Tensor]:
        """The step's accumulators, zeroed (and, under dcn_in_process, the
        other slices' in `_slice_acc`)."""
        if self._acc is None:
            self._acc, *self._slice_acc = [
                [torch.zeros(_local(p).shape, dtype=self.reduce_dtype, device=p.device) for p in self.params]
                for _ in range(self.slices)]
        else:
            for acc in [self._acc, *self._slice_acc]:
                for a in acc:
                    a.zero_()
        return self._acc

    @torch.no_grad()
    def _accumulate(self, acc: Optional[list[torch.Tensor]] = None) -> None:
        """Each parameter's (sharded) gradient into its fp32 accumulator (of
        `acc`, default the step's), cleared."""
        for p, a in zip(self.params, self._acc if acc is None else acc):
            if p.grad is not None:
                a.add_(_local(p.grad))
                p.grad = None

    def _logits_sum_count(self, logits, labels):
        """The loss's (sum, count) of logits: over vocab shards under loss parallelism."""
        if self.logits_group is None:
            return self.loss_fn.sum_and_count(logits, labels)
        return self.loss_fn.sum_and_count(logits, labels, vocab_group=self.logits_group)

    def _chunked_ce(self, module, hidden, labels):
        """(sum, count) of the chunked routes (JAX train_step.py:457-492)."""
        if self.fused_ce:
            if self.tp_group is not None:
                return self.loss_fn.fused_sum_and_count(hidden, module.head_weight(), labels,
                                                        vocab_group=self.tp_group)
            return self.loss_fn.fused_sum_and_count(hidden, module.head_weight(), labels)

        def chunk_sum_count(h, lab):
            return self._logits_sum_count(module.head_logits(h), lab)

        seq = hidden.shape[1]
        if seq > self.head_chunk:
            total = torch.zeros((), dtype=torch.float32, device=hidden.device)
            count = torch.zeros((), dtype=torch.float32, device=hidden.device)
            for start in range(0, seq, self.head_chunk):  # the last chunk is the ragged tail, if any
                end = start + self.head_chunk
                s, c = checkpointed(chunk_sum_count, hidden[:, start:end], labels[:, start:end])
                total, count = total + s, count + c
        else:  # short sequences: one chunk, no recompute
            total, count = chunk_sum_count(hidden, labels)
        return total, count

    def _head_sum_count(self, module, hidden, labels):
        """(loss sum, token count) of post-`lm_head_norm` hidden states: the
        chunked routes, or the fp32 logits."""
        if self.head_chunk is not None:
            return self._chunked_ce(module, hidden, labels)
        return self._logits_sum_count(module.head_logits(hidden), labels)

    def _sum_count(self, inputs, targets: dict):
        """This rank's (loss sum, token count) of a microbatch; a loss without
        the sum_and_count form gives (its mean, 1)."""
        if self.head_chunk is not None:
            return self._chunked_ce(self.module, self.module.forward_hidden(inputs), targets[self.loss_fn.target_key])
        if hasattr(self.loss_fn, "sum_and_count"):
            return self._logits_sum_count(self.module(inputs), targets[self.loss_fn.target_key])
        mean = self.loss_fn({self.model.prediction_key: self.module(inputs)}, targets)
        return mean, torch.ones((), device=self.device)

    def _global_count(self, count: torch.Tensor) -> torch.Tensor:
        """The token count over the ranks that hold other rows (not over tp or pp)."""
        count = count.detach().float().clone()
        if self.mesh is not None:
            dist.all_reduce(count, group=self.batch_group)
        return count

    def _loss(self, inputs, targets: dict):
        """This rank's share of the microbatch's global loss: its sum over the
        token count of the ranks that hold other rows."""
        total, count = self._sum_count(inputs, targets)
        return total / torch.clamp(self._global_count(count), min=1.0)

    def _tables(self, pp: int, microbatches: int):
        """The schedule's tables for `microbatches` (built once per count)."""
        spec = self.model.config_spec
        if microbatches not in self._tables_by_count:
            self._tables_by_count[microbatches] = build_schedule_tables(spec.pp_schedule, pp, microbatches,
                                                                        spec.pp_num_virtual)
        return self._tables_by_count[microbatches]

    def _pp_run(self, ids: torch.Tensor, labels: torch.Tensor, *, forward_only: bool = False):
        """One microbatch's rows through the pipeline: split into the
        schedule's M microbatches of contiguous rows (M at most the rows, as
        the JAX executor takes it), the tables run over this process's
        stages. Returns (the loss sum of the microbatches whose head ran
        here, the global token count); in training each head's value is its
        sum over that count, so the gradients are the global mean's."""
        rows = ids.shape[0]
        m = min(self.pp_microbatches, rows)
        if rows % m:
            raise ValueError(f"a rank's {rows} rows of a microbatch must be divisible by the pipeline's "
                             f"{m} microbatches")
        tables = self._tables(self.pp_degree, m)
        ignore = getattr(self.loss_fn, "ignore_index", None)
        count = labels.numel() if ignore is None else (labels != ignore).sum()
        count = torch.clamp(self._global_count(torch.as_tensor(count, device=self.device)), min=1.0)
        ids_mb, labels_mb = ids.chunk(m), labels.chunk(m)

        def head(module, hidden, i):
            total = self._head_sum_count(module, hidden, labels_mb[i])[0]
            return total if forward_only else total / count

        if self.pp_group is None:  # every stage in this process
            transport = InProcess()
        else:
            tp = self.tp_group.size() if self.tp_group is not None else 1
            e = self.model.config_spec.n_embd
            shape = (rows // m, ids.shape[1] // tp, e)
            transport = P2PTransport(self.pp_group, shape, self.stages[0].module.compute_dtype, self.device)
        losses = run_schedule(tables, self.stages, list(ids_mb), head, transport, forward_only=forward_only,
                              after_backward=self._accumulate)
        total = torch.zeros((), dtype=torch.float32, device=self.device)
        for i in sorted(losses):
            total = total + losses[i].float()
        return total, count

    def _last_stage_broadcast(self, value: torch.Tensor) -> torch.Tensor:
        """The last stage's `value` on every pp rank (the loss)."""
        if self.pp_group is not None:
            dist.broadcast(value, group_src=self._last_device, group=self.pp_group)
        return value

    def _sum_tied(self, acc: list[torch.Tensor]) -> None:
        """The tied wte's gradient: its first-stage copy's plus its last-stage
        copy's, the same sum on both (in that order)."""
        if self._tied_first is not None and self._tied_copy is not None:  # both copies in this process
            total = acc[self._tied_first] + acc[self._tied_copy]
            acc[self._tied_first].copy_(total)
            acc[self._tied_copy].copy_(total)
            return
        mine = self._tied_first if self._tied_first is not None else self._tied_copy
        if mine is None:
            return  # no tied weight here, or one copy (the V placement puts the first and last stage on one device)
        other = self._last_device if mine == self._tied_first else self._first_device
        theirs = torch.empty_like(acc[mine])
        peer = dist.get_global_rank(self.pp_group, other)
        for work in dist.batch_isend_irecv([dist.P2POp(dist.isend, acc[mine], peer, self.pp_group),
                                            dist.P2POp(dist.irecv, theirs, peer, self.pp_group)]):
            work.wait()
        total = acc[mine] + theirs if mine == self._tied_first else theirs + acc[mine]
        acc[mine].copy_(total)

    def _slice_rows(self, t: torch.Tensor, k: int) -> torch.Tensor:
        """[mb, S] -> in-process slice k's contiguous block of rows (JAX
        `to_dcn_groups`); the rows themselves with one slice."""
        if self.slices == 1:
            return t
        if t.shape[0] % self.slices:
            raise ValueError(f"a microbatch's {t.shape[0]} rows are not divisible by {self.slices} slices: every "
                             "slice must own an equal share of each microbatch")
        return t.chunk(self.slices)[k]

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
        slice_accs = [self._zero_accumulators(), *self._slice_acc]
        loss_sums = [torch.zeros((), dtype=torch.float32, device=self.device) for _ in slice_accs]
        for i in range(self.acc_steps):
            for k, acc in enumerate(slice_accs):
                inputs = self._local_rows(self._slice_rows(samples[sample_key][i], k))
                mb_targets = {key: self._local_rows(self._slice_rows(v[i], k)) for key, v in targets.items()}
                if self.stages:
                    loss, _ = self._pp_run(inputs, mb_targets[self.loss_fn.target_key])
                else:
                    loss = self._loss(inputs, mb_targets)
                    loss.backward()
                    self._accumulate(acc)
                loss_sums[k] += loss.detach()
        acc, loss_sum = slice_accs[0], loss_sums[0]
        with torch.no_grad():
            for other, other_loss in zip(slice_accs[1:], loss_sums[1:]):  # in-process slices, summed in slice order
                for a, b in zip(acc, other):
                    a.add_(b)
                loss_sum = loss_sum + other_loss
        if self.mesh is not None:
            dist.all_reduce(loss_sum, group=self.batch_group)
        loss_sum = self._last_stage_broadcast(loss_sum)
        if self.tp_group is not None:
            sum_replicated_grads(self.params, acc, self.tp_group)
        self._sum_tied(acc)
        if self.zero is not None:
            acc = self.zero.reduce_scatter(acc)
        if self.dcn_group is not None:  # the step's one cross-slice reduction: the slices' gradients, then losses
            env.all_reduce_flat(acc, self.dcn_group)
            dist.all_reduce(loss_sum, group=self.dcn_group)
        if self.dcn > 1:
            loss_sum = loss_sum / self.dcn
        lr = torch.tensor(self.optimizer.param_groups[0]["lr"], dtype=torch.float32)
        done = self.scheduler.last_epoch  # the step count before this update, skipped steps included (JAX state.step)
        loss = loss_sum / self.acc_steps
        if self._fault_fires(self.loss_spike_fault, done):
            loss = loss + float(self.loss_spike_fault.arg or 1e3)
        with torch.no_grad():
            owners = self.zero.owners if self.zero is not None else self.params  # each accumulator's parameter
            local = [((a / self.dcn if self.dcn > 1 else a) / self.acc_steps).to(p.dtype) for p, a in zip(owners, acc)]
            if self._fault_fires(self.nan_grads_fault, done):
                local = [g * float("nan") for g in local]
            if self.zero is not None:
                grads = self.zero.set_grads(local)
            else:
                for p, g in zip(self.params, local):
                    p.grad = (DTensor.from_local(g, p.device_mesh, p.placements, shape=p.shape, stride=p.stride())
                              if isinstance(p, DTensor) else g)
                grads = [p.grad for p in self.params]
        mode = self.clipper.norm_type if self.clipper is not None else GradientClippingMode.P2_NORM
        counted = [g for i, g in enumerate(grads) if i != self._tied_copy]  # a tied weight counts once
        grad_norm = global_norm(counted, mode, across=self.pp_group)
        if self.clipper is not None and self.clipper.max_norm is not None:
            clip_(grads, grad_norm, self.clipper.max_norm, mode)
        metrics = {"loss": loss, "grad_norm": grad_norm, "lr": lr}
        if self.skip_on_anomaly:
            # the branch-free skip: the fused update reads the flag on the device
            skipped = ~(torch.isfinite(loss) & torch.isfinite(grad_norm))
            self.optimizer.found_inf = skipped.to(device=self.device, dtype=torch.float32)
            metrics["skipped_step"] = skipped.to(torch.int32)
        groups = self.optimizer.param_groups
        reported = [g["lr"] for g in groups]
        for g, rate in zip(groups, self._applied_rates(done)):
            g["lr"] = rate
        try:
            if self.zero is not None:
                self.zero.step()
            else:
                self.optimizer.step()
        finally:
            for g, rate in zip(groups, reported):
                g["lr"] = rate
        self.scheduler.step()
        for p in self.params:
            p.grad = None
        if BALLOT_KEY in batch:  # the one consensus collective (resilience/coordination.py)
            metrics[BALLOT_KEY] = reduce_ballot(batch[BALLOT_KEY])
        return metrics

    def _applied_rates(self, done: int) -> list[torch.Tensor]:
        """Each param group's rate for this update, a 0-d float32 tensor on the
        step's device: the schedule at the optimizer's step count (clamped to
        `done`, the steps taken), gathered from `_rates` without a host sync.
        The table holds LambdaLR's own rates (base rate x lambda, in double)
        and is extended by doubling, on the CPU and copied once a doubling."""
        filled = 0 if self._rates is None else self._rates.shape[1]
        if done >= filled:
            size = max(64, 2 * filled, done + 1)
            rows = torch.tensor([[base * lam(i) for i in range(filled, size)] for base, lam in
                                 zip(self.scheduler.base_lrs, self.scheduler.lr_lambdas)], dtype=torch.float32)
            if self.device.type == "cuda":
                rows = rows.pin_memory().to(self.device, non_blocking=True)
            self._rates = rows if self._rates is None else torch.cat([self._rates, rows.to(self.device)], dim=1)
        first = self.optimizer.param_groups[0]["params"][0]
        count = self.optimizer.state.get(first, {}).get("step")
        if count is None:  # no update has run: the optimizer's count is 0
            index = torch.zeros(1, dtype=torch.int64, device=self.device)
        else:
            index = _local(count).detach().to(self.device).reshape(1).clamp(max=done).to(torch.int64)
        return list(self._rates.index_select(1, index).reshape(-1).unbind())

    @staticmethod
    def _fault_fires(fault, step: int) -> bool:
        """Whether a baked fault targets the step whose count before the update
        is `step` (every step when the fault names none)."""
        return fault is not None and (fault.step is None or fault.step == step)

    def memscope_report(self, batch: dict) -> dict:
        """The static memory report of this step at `batch`'s shapes, before
        any dispatch (JAX `StepFunctions.memscope_report`, trainer.py:138-160,
        which reads a compiled executable's memory_analysis(); see
        telemetry/memscope.py): argument bytes are this rank's parameters and
        optimizer state, temp bytes its gradients (the float32 accumulators
        and the parameter-dtype gradients) plus the activation estimate at the
        batch's microbatch and the model's remat variant, output and alias
        bytes 0."""
        from types import SimpleNamespace

        from modalities_tpu_torch.telemetry.memscope import memscope_from_categories, train_step_known_bytes
        from modalities_tpu_torch.utils.recipe_validation import _estimate_activation_bytes

        known = train_step_known_bytes(self)
        _, micro, seq = batch["samples"][self.model.sample_key].shape
        mesh = self.mesh if self.mesh is not None else SimpleNamespace(degrees={}, enable_loss_parallel=False)
        profile = SimpleNamespace(local_train_micro_batch_size=int(micro), sequence_length=int(seq))
        activations = _estimate_activation_bytes(self.model, mesh, profile)
        categories = {"argument_bytes": known["params"] + known["optimizer_moments"],
                      "temp_bytes": known["gradients_accumulators"] + activations["total"],
                      "output_bytes": 0, "alias_bytes": 0}
        context = {
            "kind": "train",
            "zero_stage": 1 if self.zero is not None else 0,
            "gradient_accumulation_steps": self.acc_steps,
            "dp_replicate": int(mesh.degrees.get("dp_replicate", 1) or 1),
            "remat_variant": getattr(self.model.config_spec, "remat_variant", None),
        }
        report = memscope_from_categories(categories, known, context)
        report["activation_estimate"] = activations
        return report

    def eval_step(self, batch: dict) -> dict[str, Any]:
        """batch: {"samples": {key: [mb, S]}, "targets": {key: [mb, S]}} (this
        rank's rows) -> {"loss": the global token mean of the loss} (JAX
        train_step.py:702-720), without a graph."""
        losses = []
        with torch.no_grad():
            for k in range(self.slices):
                inputs = self._local_rows(self._slice_rows(batch["samples"][self.model.sample_key], k))
                targets = {key: self._local_rows(self._slice_rows(v, k)) for key, v in batch["targets"].items()}
                if self.stages:
                    total, count = self._pp_run(inputs, targets[self.loss_fn.target_key], forward_only=True)
                else:
                    total, count = self._sum_count(inputs, targets)
                    total, count = total.float(), self._global_count(count)
                if self.mesh is not None:
                    dist.all_reduce(total, group=self.batch_group)
                total = self._last_stage_broadcast(total)
                losses.append(total / torch.clamp(count, min=1.0))
            loss = losses[0]
            for other in losses[1:]:
                loss = loss + other
            if self.dcn_group is not None:  # the mean of the slices' token means
                dist.all_reduce(loss, group=self.dcn_group)
            if self.dcn > 1:
                loss = loss / self.dcn
        return {"loss": loss}

    def state_dict(self) -> dict[str, torch.Tensor]:
        """The module's parameters, whole: sharded ones are gathered from every
        rank (all ranks must call), except on a 1-rank mesh, whose one shard is
        the whole tensor (read without the process group, which may be gone).
        Under pp, this rank's stage's (in process: every stage's)."""
        modules = [st.module for st in self.stages] or [self.module]
        return {k: _full(v) for module in modules for k, v in module.state_dict().items()}


def _local(t: torch.Tensor) -> torch.Tensor:
    return t.to_local() if isinstance(t, DTensor) else t


def _full(t: torch.Tensor) -> torch.Tensor:
    if not isinstance(t, DTensor):
        return t
    return t.to_local() if t.device_mesh.size() == 1 else t.full_tensor()

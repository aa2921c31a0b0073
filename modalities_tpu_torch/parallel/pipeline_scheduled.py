"""The scheduled pipeline executor: the port of
modalities_tpu/parallel/pipeline_scheduled.py (`scheduled_pipeline_loss_and_grads`,
`_scheduled_local`), and of the GPipe of modalities_tpu/parallel/pipeline.py
through the `gpipe` tables.

`run_schedule` runs the tables (parallel/pipeline_schedules.py) tick by tick
over the stages this process holds (parallel/pipeline.py): in each tick
every F op, then every B op, then the tick-end hops. One code path serves
two transports:
- `P2PTransport`: one stage a process, the hops are `dist.batch_isend_irecv`
  of activations forward and of cotangents backward over the pp group (NCCL
  on the card, gloo on the CPU). Every rank derives the tick's messages from
  the same tables, so each send meets its receive;
- `InProcess` (`pp_in_process`): every stage in one process, the ops of a
  tick run one after another and the tensors are handed over by reference
  (the card has one H100, and NCCL refuses two ranks on one GPU).

F op (chunk c, microbatch m, global stage g): the chunk's forward over the
received activation (a leaf that requires grad), or over the embeddings at
g = 0; the graph is kept until the B op. At the last global stage the F op
also runs the head and loss (`head(module, hidden, m)`, inside the stage's
forward), which the H table places between that F and its B: here it runs
with the F. B op: the backward of the kept graph, seeded with the received
cotangent (or from the microbatch's loss at the last stage); the input's
gradient is the cotangent sent to global stage g - 1. So an in-flight bound
of the tables (1F1B's) caps the graphs a device keeps, where the JAX
executor keeps stage inputs and recomputes their forward under `jax.vjp` at
the B tick: the numbers are the same.

ZBV / DualPipeV (`deferred_w`): the B op computes the input's gradient only
(`torch.autograd.grad` with `retain_graph`), and after the last tick one
pass over the kept graphs, in (chunk, microbatch) order, runs the full
backward for the weight gradients (its input gradient, computed again, is
dropped), as the JAX executor's post-scan W pass does.

Loss weighting and the tied weight's sum over pp are the train step's
(training/train_step.py): `head` returns the microbatch's share of the global
token mean, so gradients accumulate the global loss's.
"""

from __future__ import annotations

import contextlib
from typing import Callable

import torch
import torch.distributed as dist

from modalities_tpu_torch.parallel.pipeline import PipelineStage
from modalities_tpu_torch.parallel.pipeline_schedules import ScheduleTables, _validate


def check_tables(tables: ScheduleTables) -> None:
    """Every op once, every dependency in order (the tables' own
    `_validate`), or ValueError: the executor runs no other tables."""
    try:
        _validate(tables)
    except AssertionError as error:
        raise ValueError(f"pipeline tables refused: {error}") from None


def tick_messages(tables: ScheduleTables, t: int, forward_only: bool = False) -> list[tuple]:
    """Every hop at the end of tick t, in one order every rank agrees on:
    (kind "act" | "cot", src device, dst device, chunk at dst, microbatch)."""
    P, M, G = tables.num_stages, tables.num_microbatches, tables.num_stages_global
    out = []
    for kind, table, step in (("act", tables.f, 1), ("cot", tables.b, -1)):
        if kind == "cot" and forward_only:
            continue
        for d in range(P):
            op = int(table[t, d])
            if op < 0:
                continue
            c, m = divmod(op, M)
            g = tables.global_stage(c, d) + step
            if 0 <= g < G:
                out.append((kind, d, tables.device_of(g), tables.chunk_of(g), m))
    return out


class InProcess:
    """Every stage in this process: a hop hands the tensor over by reference."""

    def exchange(self, messages: list[tuple], produced: dict, local: set[int]) -> dict:
        return {(kind, dst, c, m): produced[(kind, src)] for kind, src, dst, c, m in messages}


class P2PTransport:
    """One stage in this process (pp device `device` of `group`): hops to and
    from the other devices are point-to-point over the group; a hop within
    the device (the V placement's turn) is handed over by reference."""

    def __init__(self, group, act_shape: tuple, act_dtype: torch.dtype, device: torch.device):
        self.group = group
        self.act_shape, self.act_dtype, self.device = tuple(act_shape), act_dtype, device

    def exchange(self, messages: list[tuple], produced: dict, local: set[int]) -> dict:
        received, ops = {}, []
        for kind, src, dst, c, m in messages:
            if src in local and dst in local:
                received[(kind, dst, c, m)] = produced[(kind, src)]
            elif src in local:
                ops.append(dist.P2POp(dist.isend, produced[(kind, src)].contiguous(),
                                      dist.get_global_rank(self.group, dst), self.group))
            elif dst in local:
                buf = torch.empty(self.act_shape, dtype=self.act_dtype, device=self.device)
                received[(kind, dst, c, m)] = buf
                ops.append(dist.P2POp(dist.irecv, buf, dist.get_global_rank(self.group, src), self.group))
        if ops:
            for work in dist.batch_isend_irecv(ops):
                work.wait()
        return received


def run_schedule(tables: ScheduleTables, stages: list[PipelineStage], ids: list[torch.Tensor], head: Callable,
                 transport, *, forward_only: bool = False,
                 after_backward: Callable[[], None] = lambda: None) -> dict[int, torch.Tensor]:
    """Run `tables` over the local `stages` on microbatches `ids` ([rows, S]
    each). `head(module, hidden, m)` gives microbatch m's loss at the last
    global stage; its gradients go into the stages' parameters' `.grad`, and
    `after_backward()` runs after every backward that wrote some (the train
    step moves them into its fp32 accumulators there). `forward_only`: no
    graph, no B op. Returns the loss of every microbatch whose head ran here
    (detached)."""
    check_tables(tables)
    M, G = tables.num_microbatches, tables.num_stages_global
    local = {st.device for st in stages}
    inputs: dict = {}  # (device, chunk, m) -> the received activation
    cotangents: dict = {}  # (device, chunk, m) -> the received cotangent of the chunk's output
    live: dict = {}  # (device, chunk, m) -> (input, output): the graph kept from F to B
    deferred: list = []  # deferred_w: (chunk, m, output, seed) for the weight-gradient pass
    losses: dict[int, torch.Tensor] = {}
    grad_mode = torch.no_grad() if forward_only else contextlib.nullcontext()
    for t in range(tables.num_ticks):
        produced: dict = {}
        for st in stages:
            op = int(tables.f[t, st.device])
            if op < 0:
                continue
            c, m = divmod(op, M)
            g = tables.global_stage(c, st.device)
            x = None if g == 0 else inputs.pop((st.device, c, m))
            last = g == G - 1
            with grad_mode:
                out = st.forward(c, ids[m], x, (lambda module, hidden, m=m: head(module, hidden, m)) if last else None)
            if last:
                losses[m] = out.detach()
            else:
                produced[("act", st.device)] = out.detach()
            if not forward_only:
                live[(st.device, c, m)] = (x, out)
        for st in stages if not forward_only else ():
            op = int(tables.b[t, st.device])
            if op < 0:
                continue
            c, m = divmod(op, M)
            g = tables.global_stage(c, st.device)
            x, out = live.pop((st.device, c, m))
            seed = None if g == G - 1 else cotangents.pop((st.device, c, m))
            if tables.deferred_w:
                deferred.append((c, m, out, seed))
                if g > 0:
                    produced[("cot", st.device)] = torch.autograd.grad(out, x, seed, retain_graph=True)[0]
            else:
                torch.autograd.backward(out, seed)
                after_backward()
                if g > 0:
                    produced[("cot", st.device)] = x.grad
        received = transport.exchange(tick_messages(tables, t, forward_only), produced, local)
        for (kind, dst, c, m), tensor in received.items():
            if kind == "act":
                inputs[(dst, c, m)] = tensor.detach().requires_grad_(not forward_only)
            else:
                cotangents[(dst, c, m)] = tensor
    for _, _, out, seed in sorted(deferred, key=lambda item: (item[0], item[1])):
        torch.autograd.backward(out, seed)
        after_backward()
    assert not inputs and not cotangents and not live, "the tables left ops undone"
    return losses


def pp_in_process(stages: list[PipelineStage], tables: ScheduleTables, microbatches: list[torch.Tensor],
                  head: Callable, forward_only: bool = False) -> dict[int, torch.Tensor]:
    """Every pp device's stage in this process, tick by tick (`run_schedule`
    with the in-process transport)."""
    if sorted(st.device for st in stages) != list(range(tables.num_stages)):
        raise ValueError(f"pp_in_process needs the stages of devices 0..{tables.num_stages - 1}")
    return run_schedule(tables, stages, microbatches, head, InProcess(), forward_only=forward_only)


def mutant_tables(tables: ScheduleTables, device: int, first: int, second: int) -> ScheduleTables:
    """`tables` with device `device`'s B ops of microbatches `first` and
    `second` swapped (a schedule that runs one microbatch's backward where
    another's belongs): the executor must refuse it (`check_tables`)."""
    import dataclasses

    import numpy as np

    b = tables.b.copy()
    M = tables.num_microbatches
    col = b[:, device]
    a = np.flatnonzero((col >= 0) & (col % M == first))[0]
    z = np.flatnonzero((col >= 0) & (col % M == second))[0]
    col[a], col[z] = col[z], col[a]
    return dataclasses.replace(tables, b=b)


"""Cross entropy over a vocabulary sharded on the tp axis: loss parallelism
over fp32 logits, and the fused-CE head on vocab shards.

Rank r of a tp group of n holds the vocabulary rows [r * V/n, (r + 1) * V/n)
of the head (equal shards, in rank order). Labels are shifted by the shard's
offset, so a label outside the shard is no column of it: the plain versions
mask it and the kernels compare it with column indices only, so no label
makes a kernel read past W (csrc/fused_ce.cu: the forward maps a label
outside [0, V) to -1; dh and dW test `v == label` for v < V only).

- `vocab_parallel_sum_and_count(logits, labels, group)`: the JAX step under
  loss parallelism (`vocab_logits` on tp, XLA's psums): per row the shard's
  max, then an all-reduce (max); the shard's sum of exp(s - max) and label
  logit, then an all-reduce (sum). The backward needs no exchange: this
  shard's columns of softmax - onehot.
- `vocab_parallel_fused_sum_and_count(hidden, w, labels, group)`: the
  fused-CE kernels (ops/fused_ce.py) on this rank's shard W [V/n, E]. The
  forward kernel gives the shard's (lse, corr); the shards' are all-gathered
  and combined in rank order (`combine`): the global lse is the logsumexp of
  the shards', corr the sum of theirs. The backward runs dh and dW on the shard with the
  global lse. dW needs no exchange; the shards' dh add up to the whole dh,
  and that sum is the backward of the all-gather that gave every rank the
  whole hidden states (the lm_head_norm's sequence gather,
  parallel/tensor_parallel.py): a reduce-scatter.

Both keep `ignore_index` and the token-weighted (sum, count) of the
unsharded losses. `fused_ce_in_process` runs the fused version's shards one
after another in one process and combines them in rank order (the card
check at full width on one card).
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from modalities_tpu_torch.ops.fused_ce import fused_ce_backward_dh, fused_ce_backward_dw, fused_ce_forward


def _shard(labels, rows: int, rank: int):
    """Labels as column indices of rank `rank`'s shard of `rows` vocabulary rows."""
    return labels.long() - rank * rows


def combine(lses, corrs):
    """The whole vocabulary's (lse, corr) from the shards' ones, in rank order."""
    m = torch.stack(lses).amax(dim=0)
    total = torch.zeros_like(m)
    for lse in lses:
        total = total + torch.exp(lse - m)
    corr = corrs[0]
    for c in corrs[1:]:
        corr = corr + c
    return m + torch.log(total), corr


def _combine_over(group, lse, corr):
    """`combine` of every rank's (lse, corr), gathered over `group`."""
    stats = [torch.empty((2,) + lse.shape, dtype=lse.dtype, device=lse.device) for _ in range(group.size())]
    dist.all_gather(stats, torch.stack([lse, corr]), group=group)
    return combine([s[0] for s in stats], [s[1] for s in stats])


class VocabParallelCrossEntropy(torch.autograd.Function):
    """(total, count) of the CE over fp32 logits [N, V/n], this rank's vocab
    columns; `count` carries no gradient."""

    @staticmethod
    def forward(ctx, logits, labels, ignore_index, group):
        lab = _shard(labels, logits.shape[1], group.rank())
        hit = (lab >= 0) & (lab < logits.shape[1])
        m = logits.amax(dim=-1)
        dist.all_reduce(m, op=dist.ReduceOp.MAX, group=group)
        label_logit = torch.where(hit, logits.gather(1, lab.clamp(0, logits.shape[1] - 1)[:, None])[:, 0], 0.0)
        stats = torch.stack([torch.exp(logits - m[:, None]).sum(dim=-1), label_logit])
        dist.all_reduce(stats, group=group)
        lse = m + torch.log(stats[0])
        mask = (labels != ignore_index).float()
        ctx.save_for_backward(logits, lab, hit, lse, mask)
        count = mask.sum()
        ctx.mark_non_differentiable(count)
        return ((lse - stats[1]) * mask).sum(), count

    @staticmethod
    def backward(ctx, g_total, _g_count):
        logits, lab, hit, lse, mask = ctx.saved_tensors
        ds = torch.exp(logits - lse[:, None])
        rows = torch.arange(logits.shape[0], device=logits.device)[hit]
        ds[rows, lab[hit]] -= 1.0
        return ds * (g_total * mask)[:, None], None, None, None


def vocab_parallel_sum_and_count(logits, labels, group, *, ignore_index: int = -100):
    """(total, count) of the CLM cross entropy over fp32 logits [..., V/n]
    sharded over the vocabulary on `group`."""
    v = logits.shape[-1]
    return VocabParallelCrossEntropy.apply(logits.float().reshape(-1, v), labels.reshape(-1), int(ignore_index), group)


class VocabParallelFusedCE(torch.autograd.Function):
    """(total, count) over h [N, E] @ w.T for this rank's shard w [V/n, E]
    through the fused-CE wrappers (their plain versions on CPU tensors)."""

    @staticmethod
    def forward(ctx, h, w, labels, ignore_index, group):
        lab = _shard(labels, w.shape[0], group.rank())
        lse, corr = _combine_over(group, *fused_ce_forward(h, w, lab))
        mask = (labels != ignore_index).float()
        ctx.save_for_backward(h, w, lab, lse, mask)
        count = mask.sum()
        ctx.mark_non_differentiable(count)
        return ((lse - corr) * mask).sum(), count

    @staticmethod
    def backward(ctx, g_total, _g_count):
        h, w, lab, lse, mask = ctx.saved_tensors
        gm = (g_total * mask).float()
        dh = fused_ce_backward_dh(h, w, lab, lse, gm) if ctx.needs_input_grad[0] else None  # this shard's share
        dw = fused_ce_backward_dw(h, w, lab, lse, gm) if ctx.needs_input_grad[1] else None
        return dh, dw, None, None, None


def vocab_parallel_fused_sum_and_count(hidden, head_weight, labels, group, *, ignore_index: int = -100):
    """(total, count) of the CE over hidden [..., E] (the whole rows, on every
    rank of `group`) @ head_weight.T, head_weight this rank's [V/n, E] rows
    of the vocabulary."""
    e = hidden.shape[-1]
    return VocabParallelFusedCE.apply(hidden.reshape(-1, e), head_weight, labels.reshape(-1), int(ignore_index), group)


def fused_ce_in_process(h, w, labels, tp: int, gm):
    """The fused CE's tp ranks one after another in one process: each runs
    the forward, dh and dW wrappers on its shard of w [V, E]; the shards'
    statistics are combined (`combine`), their dh summed in rank order.
    Returns (lse, corr, dh, dW with the shards' rows in rank order)."""
    shards = w.chunk(tp, dim=0)
    stats = [fused_ce_forward(h, s, _shard(labels, s.shape[0], r)) for r, s in enumerate(shards)]
    lse, corr = combine([s[0] for s in stats], [s[1] for s in stats])
    dh, dws = None, []
    for r, s in enumerate(shards):
        lab = _shard(labels, s.shape[0], r)
        part = fused_ce_backward_dh(h, s, lab, lse, gm).float()
        dh = part if dh is None else dh + part
        dws.append(fused_ce_backward_dw(h, s, lab, lse, gm))
    return lse, corr, dh.to(h.dtype), torch.cat(dws, dim=0)

"""Tensor, sequence and loss parallelism over the tp axis of the device mesh:
the port of the JAX logical-axis rules (modalities_tpu/parallel/sharding.py:
35-76) for the GPT2 model, written as DTensor `ParallelStyle`s and applied
with torch's `parallelize_module` (`apply_tensor_parallel`).

The plan, as the JAX rules place the model's logical axes:
- column-parallel (`heads`, `kv_heads`, `mlp` on tp): q_attn, k_attn, v_attn,
  W, V and c_fc; a flax-layout [in, out] kernel is sharded on dim 1;
- row-parallel: c_proj and W_2, the kernel sharded on dim 0; the partial
  outputs are reduce-scattered over the sequence (summed in fp32, rounded
  once), and a bias (replicated over tp) is added to this rank's rows after
  the sum, once, as GSPMD places it after the reduction;
- vocab-parallel (`vocab` on tp): wte's rows (a masked local lookup, then a
  reduce-scatter, which sums the ranks' lookups) and the lm_head kernel's
  columns. The head's fp32 logits stay sharded over the vocab under loss
  parallelism (`vocab_logits` on tp) and are gathered otherwise;
- sequence parallelism through the norms: the residual stream between the
  blocks' sublayers holds this rank's contiguous 1/tp of the sequence;
  attention_norm, ffn_norm and lm_head_norm run on those rows and their
  outputs are all-gathered before q/k/v, W/V and the head.

Every parameter the plan does not shard (the norms, wpe, the qk norms, the
row-parallel biases) is a Replicate DTensor over tp. Each of them is used on
this rank's share of the work only (its rows, or its heads for the qk
norms), so its gradient on a rank is a partial sum: the train step adds them
over tp (`sum_replicated_grads`). The JAX package's GSPMD places its
activations itself (its `seq_sp` rule constrains no activation); SP changes
no value.

Module bodies compute on local tensors (`local`): no DTensor reaches a
kernel's autograd.Function. FSDP2 then shards the tp DTensors over the dp
dims of the same mesh (parallel/fsdp.py). `tp_in_process` drives the tp
ranks of one block one after another in one process, through the block's
own modules over each rank's shards, cut on the dims the plan's styles give
(`shard_dim`): the card check of the plan at full width on one card.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn
from torch.distributed.tensor import DTensor, Replicate, Shard
from torch.distributed.tensor.parallel import ParallelStyle

from modalities_tpu_torch.running_env import env

SEQUENCE_PARALLEL_NORMS = ("attention_norm", "ffn_norm")  # and the model's lm_head_norm


def local(t):
    """A parameter's local tensor: this rank's shard of a DTensor, else `t`."""
    return t.to_local() if isinstance(t, DTensor) else t


@dataclasses.dataclass(frozen=True)
class TensorParallel:
    """What the model's forward needs of the tp axis: the group, and whether
    the head's logits stay sharded over the vocab (loss parallelism)."""

    group: object
    loss_parallel: bool = False


# ------------------------------------------------------- activation collectives


def _all_gather(x, dim: int, group):
    parts = [torch.empty_like(x) for _ in range(group.size())]
    dist.all_gather(parts, x.contiguous(), group=group)
    return torch.cat(parts, dim=dim)


def _reduce_scatter(x, dim: int, group):
    """The sum over the group, this rank's 1/n of `dim`: summed in fp32 and
    rounded once to x's dtype (a bf16 sum of tp partials would round at
    every add)."""
    n = group.size()
    if x.shape[dim] % n:
        raise ValueError(f"tensor parallelism: dim {dim} of {tuple(x.shape)} is not divisible by the tp degree {n}")
    moved = x.movedim(dim, 0).float().contiguous()
    out = moved.new_empty((moved.shape[0] // n,) + moved.shape[1:])
    dist.reduce_scatter_tensor(out, moved, group=group)
    return out.movedim(0, dim).to(x.dtype).contiguous()


class _GatherSequence(torch.autograd.Function):
    """This rank's rows [B, S/tp, ...] -> every rank's rows [B, S, ...] in
    rank order; the backward sums the ranks' partial gradients and keeps
    this rank's rows (a reduce-scatter)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _all_gather(x, 1, group)

    @staticmethod
    def backward(ctx, grad):
        return _reduce_scatter(grad, 1, ctx.group), None


class _ReduceScatterSequence(torch.autograd.Function):
    """Partial sums [B, S, ...] -> this rank's rows of their sum [B, S/tp, ...];
    the backward gathers the rows' gradients."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _reduce_scatter(x, 1, group)

    @staticmethod
    def backward(ctx, grad):
        return _all_gather(grad, 1, ctx.group), None


class _GatherVocab(torch.autograd.Function):
    """Vocab-sharded logits [..., V/tp] -> [..., V]. Every rank computes the
    same loss from them, so the backward keeps this rank's columns of the
    gradient, with no exchange."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _all_gather(x, -1, group)

    @staticmethod
    def backward(ctx, grad):
        group = ctx.group
        return grad.chunk(group.size(), dim=-1)[group.rank()].contiguous(), None


def gather_sequence(x, group):
    return _GatherSequence.apply(x, group)


def reduce_scatter_sequence(x, group):
    return _ReduceScatterSequence.apply(x, group)


def gather_vocab(logits, group):
    return _GatherVocab.apply(logits, group)


def vocab_parallel_embedding(input_ids, weight, group):
    """The JAX vocab-parallel lookup (gpt2_model.py:983-995) under SP:
    input_ids [B, S], weight this rank's [V/tp, E] rows of the vocabulary
    (rank order) -> this rank's rows [B, S/tp, E] of the embeddings. Each
    token's row comes from the one rank that holds it; the others add zeros,
    so the sum is exactly the unsharded lookup."""
    rows = weight.shape[0]
    ids = input_ids.long() - group.rank() * rows
    hit = (ids >= 0) & (ids < rows)
    x = F.embedding(torch.where(hit, ids, 0), weight)
    x = torch.where(hit[..., None], x, torch.zeros((), dtype=x.dtype, device=x.device))
    return reduce_scatter_sequence(x, group)


# ------------------------------------------------------------- the styles


def _chunk(t, dim: int, mesh) -> torch.Tensor:
    n, rank = mesh.size(), mesh.get_local_rank()
    if t.shape[dim] % n:
        raise ValueError(f"tensor parallelism: dim {dim} of {tuple(t.shape)} is not divisible by the tp degree {n}")
    return t.detach().chunk(n, dim=dim)[rank].clone(memory_format=torch.contiguous_format)


def _distribute_own(module: nn.Module, mesh, shard_dims: dict[str, int]) -> None:
    """Turn `module`'s own parameters into DTensors over `mesh`: sharded on
    shard_dims[name] (this rank's chunk, cut locally: every rank holds the
    whole tensor), the others replicated."""
    for name, p in list(module.named_parameters(recurse=False)):
        if isinstance(p, DTensor):
            continue
        if name in shard_dims:
            dt = DTensor.from_local(_chunk(p, shard_dims[name], mesh), mesh, [Shard(shard_dims[name])],
                                    run_check=False)
        else:
            dt = DTensor.from_local(p.detach(), mesh, [Replicate()], run_check=False)
        module.register_parameter(name, nn.Parameter(dt, requires_grad=p.requires_grad))


class _Style(ParallelStyle):
    """A module's own parameters sharded on `shard_dims` (the rest replicated)
    and, with `_output_fn`, its output passed through that collective."""

    shard_dims: dict[str, int] = {}
    _output_fn = None

    def _apply(self, module: nn.Module, device_mesh) -> nn.Module:
        _distribute_own(module, device_mesh, self.shard_dims)
        output_fn = self._output_fn
        if output_fn is not None:
            module.register_forward_hook(lambda mod, inputs, out: output_fn(out, device_mesh.get_group()))
        return module


class ColwiseParallel(_Style):
    """A [in, out] dense layer computing this rank's output columns from the
    whole input."""

    shard_dims = {"kernel": 1, "bias": 0}


class RowwiseParallel(_Style):
    """A [in, out] dense layer over this rank's input columns: its partial
    outputs are reduce-scattered over the sequence, then its bias (whole on
    every rank) is added to this rank's rows."""

    shard_dims = {"kernel": 0}

    def _apply(self, module: nn.Module, device_mesh) -> nn.Module:
        _distribute_own(module, device_mesh, self.shard_dims)
        module.bias_after_sum = True
        group = device_mesh.get_group()

        def summed(mod, inputs, out):
            out = reduce_scatter_sequence(out, group)
            return out if mod.bias is None else out + local(mod.bias).to(out.dtype)

        module.register_forward_hook(summed)
        return module


class SequenceParallelNorm(_Style):
    """A norm over this rank's rows of the sequence; its output is gathered
    for the column-parallel layers after it."""

    _output_fn = staticmethod(gather_sequence)


class VocabParallelRoot(_Style):
    """The model's own parameters: wte's vocabulary rows on tp, the rest (and
    every parameter the plan leaves) replicated."""

    shard_dims = {"wte": 0}

    def _apply(self, module: nn.Module, device_mesh) -> nn.Module:
        for sub in module.modules():
            _distribute_own(sub, device_mesh, self.shard_dims if sub is module else {})
        return module


def check_divisible(spec, tp: int) -> None:
    """The JAX rules shard heads, kv heads, the MLP width and the vocabulary
    over tp: each must divide by it."""
    mlp = spec.ffn_hidden if spec.activation == "gelu" else spec.swiglu_hidden
    for name, value in (("n_head_q", spec.n_head_q), ("n_head_kv", spec.n_head_kv), ("vocab_size", spec.vocab_size),
                        ("the MLP width", mlp)):
        if value % tp:
            raise ValueError(f"tensor parallelism: {name} ({value}) is not divisible by tensor_parallel_degree {tp}")


def plan(spec) -> dict[str, ParallelStyle]:
    """The GPT2 module's plan by submodule path (torch `parallelize_module`
    wildcards)."""
    mlp_out = "c_proj" if spec.activation == "gelu" else "W_2"
    mlp_in = ("c_fc",) if spec.activation == "gelu" else ("W", "V")
    styles: dict[str, ParallelStyle] = {f"blocks.*.attn.{n}": ColwiseParallel() for n in ("q_attn", "k_attn", "v_attn")}
    styles["blocks.*.attn.c_proj"] = RowwiseParallel()
    styles.update({f"blocks.*.mlp.{n}": ColwiseParallel() for n in mlp_in})
    styles[f"blocks.*.mlp.{mlp_out}"] = RowwiseParallel()
    styles.update({f"blocks.*.{n}": SequenceParallelNorm() for n in SEQUENCE_PARALLEL_NORMS})
    styles["lm_head_norm"] = SequenceParallelNorm()
    if not spec.use_weight_tying:
        styles["lm_head"] = ColwiseParallel()
    return styles


def apply_tensor_parallel(module: nn.Module, mesh, *, loss_parallel: bool = False) -> nn.Module:
    """Apply the plan to a GPT2Module over the 1-D tp mesh, in place: the
    parameters become DTensors over tp (each rank keeps its chunk of the
    whole tensors it holds) and the model's forward runs the vocab-parallel
    lookup and head (`set_tensor_parallel`)."""
    from torch.distributed.tensor.parallel import parallelize_module

    spec = module.spec
    check_divisible(spec, mesh.size())
    # a pipeline stage (parallel/pipeline.py) holds lm_head_norm and lm_head only on the last stage
    parallelize_module(module, mesh, {k: v for k, v in plan(spec).items() if "*" in k or hasattr(module, k)})
    VocabParallelRoot()._apply(module, mesh)
    return module.set_tensor_parallel(TensorParallel(mesh.get_group(), bool(loss_parallel)))


def _is_tp_replicated(p) -> bool:
    if not isinstance(p, DTensor) or "tp" not in (p.device_mesh.mesh_dim_names or ()):
        return False
    return p.placements[p.device_mesh.mesh_dim_names.index("tp")].is_replicate()


def sum_replicated_grads(params, grads, group) -> None:
    """Add up, over the tp group, the (local) gradients `grads` of the
    parameters that are replicated over tp: each rank's is a partial sum over
    its share of the rows or heads. One all-reduce of their concatenation."""
    mine = [g for p, g in zip(params, grads) if _is_tp_replicated(p)]
    if mine:
        env.all_reduce_flat(mine, group)


# ------------------------------------------------- the tp ranks in one process


def shard_dim(spec, name: str):
    """The dim of a block parameter (`attn.q_attn.kernel`) that `plan(spec)`
    shards over tp, or None where it is replicated."""
    owner, leaf = name.rsplit(".", 1)
    style = plan(spec).get(f"blocks.*.{owner}")
    return None if style is None else style.shard_dims.get(leaf)


def local_block(block: nn.Module, rank: int, tp: int) -> nn.Module:
    """A copy of a GPT2 block holding rank `rank`'s shards of its parameters
    (plain leaf tensors; replicated ones copied whole): what that rank's
    modules compute with."""
    spec = block.attn.spec
    copy = type(block)(spec, device="meta")
    for name, p in block.named_parameters():
        dim = shard_dim(spec, name)
        t = p.detach() if dim is None else p.detach().chunk(tp, dim=dim)[rank]
        owner, leaf = name.rsplit(".", 1)
        setattr(copy.get_submodule(owner), leaf, nn.Parameter(t.clone(memory_format=torch.contiguous_format)))
        if isinstance(plan(spec).get(f"blocks.*.{owner}"), RowwiseParallel):
            copy.get_submodule(owner).bias_after_sum = True  # tp_in_process adds it after the sum
    return copy.train(block.training)


def _rank_order_sum(parts):
    total = parts[0]
    for p in parts[1:]:
        total = total + p
    return total


def _reduce(parts):
    """The reduce-scatter's sum of the ranks' partials: fp32, in rank order,
    rounded once."""
    return _rank_order_sum([p.float() for p in parts]).to(parts[0].dtype)


class _ToRanks(torch.autograd.Function):
    """The gathered activation handed to each of n ranks; the backward sums
    their gradients as the gather's reduce-scatter does (`_reduce`)."""

    @staticmethod
    def forward(ctx, x, n: int):
        return tuple(x.clone() for _ in range(n))

    @staticmethod
    def backward(ctx, *grads):
        return _reduce(grads), None


def tp_in_process(block: nn.Module, x, cos, sin, tp: int):
    """The tp ranks of one GPT2 block (its `train_forward` under the plan),
    driven one after another in this process: x [B, S, E] is the block's
    input over the whole sequence, of which rank r holds rows r * S/tp ...
    under SP. Each rank's norms run on its rows, the gathers concatenate in
    rank order, each rank's attention and MLP run on its shards
    (`local_block`) and give partial outputs, summed as the reduce-scatter
    sums them (and so are the ranks' gradients of the gathered input); a
    row-parallel bias is added after the sum, each rank's to its rows.
    Returns (the block's output [B, S, E], the ranks' blocks),
    differentiable through x and every rank's shards."""
    ranks = [local_block(block, r, tp) for r in range(tp)]
    rows_out = [name for name, style in plan(block.attn.spec).items() if isinstance(style, RowwiseParallel)]

    def sublayer(x, norm, body, out_layer):
        normed = torch.cat([getattr(ranks[r], norm)(rows) for r, rows in enumerate(x.chunk(tp, dim=1))], dim=1)
        y = _reduce([body(ranks[r], h) for r, h in enumerate(_ToRanks.apply(normed, tp))])
        biases = [getattr(r.get_submodule(out_layer), "bias", None) for r in ranks]
        if biases[0] is not None:  # each rank's bias on its own rows, after the sum
            y = torch.cat([rows + b.to(rows.dtype) for rows, b in zip(y.chunk(tp, dim=1), biases)], dim=1)
        return x + y

    attn_out, mlp_out = (name[len("blocks.*."):] for name in rows_out)
    x = sublayer(x, "attention_norm", lambda blk, h: blk.attn.train_forward(h, cos, sin), attn_out)
    return sublayer(x, "ffn_norm", lambda blk, h: blk.mlp(h), mlp_out), ranks


def gather_rank_grads(block: nn.Module, ranks: list[nn.Module]) -> dict[str, torch.Tensor]:
    """The whole block's gradients from its ranks' blocks after a backward:
    shards concatenated on the plan's dim, replicated ones summed in rank
    order (each rank's is partial)."""
    out = {}
    for name, _ in block.named_parameters():
        grads = [dict(r.named_parameters())[name].grad for r in ranks]
        dim = shard_dim(block.attn.spec, name)
        out[name] = _rank_order_sum(grads) if dim is None else torch.cat(grads, dim=dim)
    return out


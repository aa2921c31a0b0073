"""Ring attention over the cp process group: the port of
modalities_tpu/parallel/ring_attention.py.

The sequence is split into cp contiguous chunks, one per rank (no zigzag, as
in the JAX package: under causal attention rank i does i + 1 hops of work, so
the last rank is the slowest). Rank i keeps its query chunk; the key/value
chunks travel the ring, rank i sending to i + 1 and receiving from i - 1
(`batch_isend_irecv`, every rank posting its sends and receives together), so
at hop r rank i holds chunk j = (i - r) mod cp.

Two tiers, chosen by `attention_implementation` as the JAX package chooses by
platform:
- `flash` (dao_flash, pytorch_flash): each hop runs the flash kernels
  (ops/flash_attention.py) through their (out, lse) contract. Chunk-level
  causality is decided outside the kernel: j < i is a full hop (the
  non-causal kernel), j == i the diagonal (the causal kernel, offsets
  cancel), j > i is skipped (no launch; its zeros and NEG_INF lse would merge
  as the identity, so it is not merged). Hops merge their normalized
  partials with the flash-decoding rule (`merge`), in fp32. The backward
  (`RingFlashAttention`) takes the global (lse, delta) and runs the dq and
  dk/dv kernels a hop; dq accumulates in fp32 and is cast once, and the
  dk/dv accumulators (fp32) ride the ring with their chunk and arrive home
  after cp hops.
- `dense` (manual): the JAX `_ring_dense_local`: per hop the fp32 einsum
  statistics (o, m, l) under the global-position causal mask, k-blocked with
  recompute above 2 * BLOCK_K keys, merged online; differentiated by
  autograd through `Rotate`, whose backward sends the gradient the other way
  round the ring.

`hop_forward`, `merge` and `hop_backward` are the flash tier's arithmetic,
apart from the exchange: the ring calls them around P2P, and
`ring_in_process` drives the same functions for all ranks of a ring in one
process (the card check of the hops at full width on one card).
"""

from __future__ import annotations

import math
from typing import Callable, Optional

import torch
import torch.distributed as dist
import torch.utils.checkpoint

from modalities_tpu_torch.ops.flash_attention import NEG_INF, flash_bwd_dkv, flash_bwd_dq, flash_fwd_out_lse
from modalities_tpu_torch.ops.tiers import check_ring_impl

BLOCK_K = 1024  # the dense tier's key block above which a hop is k-blocked with recompute
FULL, CAUSAL, SKIP = 0, 1, 2  # a hop's branch (JAX `_branch_index`)


def branch(causal: bool, my_index: int, j_index: int) -> int:
    """Rank `my_index`'s hop over key chunk `j_index`: FULL, CAUSAL (the
    diagonal) or SKIP (every key after every query)."""
    if not causal:
        return FULL
    return CAUSAL if j_index == my_index else (FULL if j_index < my_index else SKIP)


# ----------------------------------------------------------- the flash tier


def hop_forward(q, k, v, hop: int, sm_scale: float):
    """One hop, [B, H, S, D] layout: (out fp32 [B, Hq, S, D], lse fp32
    [B, Hq, S, 1]); a SKIP hop launches nothing."""
    if hop == SKIP:
        b, hq, s, d = q.shape
        return (torch.zeros((b, hq, s, d), dtype=torch.float32, device=q.device),
                torch.full((b, hq, s, 1), NEG_INF, dtype=torch.float32, device=q.device))
    out, lse = flash_fwd_out_lse(q, k, v, causal=hop == CAUSAL, sm_scale=sm_scale)
    return out.float(), lse


def merge(out_a, lse_a, out_b, lse_b):
    """Flash-decoding merge of two normalized partials (JAX `_merge_out_lse`).
    NEG_INF sentinels (not -inf) keep it NaN-free."""
    lse_m = torch.maximum(lse_a, lse_b)
    lse_new = lse_m + torch.log(torch.exp(lse_a - lse_m) + torch.exp(lse_b - lse_m))
    return out_a * torch.exp(lse_a - lse_new) + out_b * torch.exp(lse_b - lse_new), lse_new


def hop_backward(q, k, v, do, lse, delta, hop: int, sm_scale: float):
    """One hop's (dq, dk, dv) in fp32 from the GLOBAL lse and delta; None for
    a SKIP hop (no launch)."""
    if hop == SKIP:
        return None
    causal = hop == CAUSAL
    dq = flash_bwd_dq(q, k, v, do, lse, delta, causal=causal, sm_scale=sm_scale)
    dk, dv = flash_bwd_dkv(q, k, v, do, lse, delta, causal=causal, sm_scale=sm_scale)
    return dq.float(), dk.float(), dv.float()


def forward_hops(q, k, v, my_index: int, cp: int, causal: bool, sm_scale: float,
                 next_kv: Callable[[int, torch.Tensor, torch.Tensor], tuple]):
    """Rank `my_index`'s cp hops over its query chunk q, starting from its own
    key/value chunk; `next_kv(r, k, v)` gives the chunk of hop r + 1.
    Returns the merged (out fp32, lse fp32)."""
    b, hq, s, d = q.shape
    out = torch.zeros((b, hq, s, d), dtype=torch.float32, device=q.device)
    lse = torch.full((b, hq, s, 1), NEG_INF, dtype=torch.float32, device=q.device)
    for r in range(cp):
        hop = branch(causal, my_index, (my_index - r) % cp)
        if hop != SKIP:
            out, lse = merge(out, lse, *hop_forward(q, k, v, hop, sm_scale))
        if r != cp - 1:
            k, v = next_kv(r, k, v)
    return out, lse


def _delta(do, out):
    return (do.float() * out.float()).sum(dim=-1, keepdim=True)


def _exchange(tensors, group, step: int):
    """Each rank sends `tensors` to rank + step of the group and receives as
    many from rank - step, all posted together."""
    cp, me = group.size(), group.rank()
    to = dist.get_global_rank(group, (me + step) % cp)
    source = dist.get_global_rank(group, (me - step) % cp)
    received = [torch.empty(t.shape, dtype=t.dtype, device=t.device) for t in tensors]
    ops = []
    for t, r in zip(tensors, received):
        ops.append(dist.P2POp(dist.isend, t.contiguous(), to, group))
        ops.append(dist.P2POp(dist.irecv, r, source, group))
    for request in dist.batch_isend_irecv(ops):
        request.wait()
    return received


class RingFlashAttention(torch.autograd.Function):
    """The flash ring over `group` in the model layout [B, S, H, D]."""

    @staticmethod
    def forward(ctx, q, k, v, group, causal: bool, sm_scale: float):
        cp, me = group.size(), group.rank()
        qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
        out, lse = forward_hops(qt, kt, vt, me, cp, causal, sm_scale,
                                lambda r, k_, v_: _exchange([k_, v_], group, 1))
        out_t = out.to(q.dtype)
        ctx.save_for_backward(qt, kt, vt, out_t, lse)
        ctx.group, ctx.causal, ctx.sm_scale = group, causal, sm_scale
        return out_t.transpose(1, 2)

    @staticmethod
    def backward(ctx, do):
        qt, kt, vt, out_t, lse = ctx.saved_tensors
        group, causal, sm_scale = ctx.group, ctx.causal, ctx.sm_scale
        cp, me = group.size(), group.rank()
        do_t = do.transpose(1, 2).to(qt.dtype).contiguous()
        delta = _delta(do_t, out_t)
        dq = torch.zeros(qt.shape, dtype=torch.float32, device=qt.device)
        dk = torch.zeros(kt.shape, dtype=torch.float32, device=kt.device)
        dv = torch.zeros(vt.shape, dtype=torch.float32, device=vt.device)
        k_cur, v_cur = kt, vt
        for r in range(cp):
            grads = hop_backward(qt, k_cur, v_cur, do_t, lse, delta, branch(causal, me, (me - r) % cp), sm_scale)
            if grads is not None:
                dq += grads[0]
                dk += grads[1]
                dv += grads[2]
            if r != cp - 1:
                k_cur, v_cur, dk, dv = _exchange([k_cur, v_cur, dk, dv], group, 1)
            else:  # k/v are not read again: only the accumulators take the last hop home
                dk, dv = _exchange([dk, dv], group, 1)
        return (dq.to(qt.dtype).transpose(1, 2), dk.to(kt.dtype).transpose(1, 2), dv.to(vt.dtype).transpose(1, 2),
                None, None, None)


def ring_in_process(q, k, v, do, cp: int, *, causal: bool = True, sm_scale: Optional[float] = None):
    """The flash ring's cp ranks driven one after another in one process, on
    the whole sequence split into cp contiguous chunks: q [B, Hq, S, D], k/v
    [B, Hkv, S, D], do like q (kernel layout). Each rank runs `forward_hops`
    with its chunks looked up instead of received; the backward runs the
    ranks hop by hop in lockstep, each dk/dv accumulator passed to the next
    rank as the ring passes it. Returns (out, lse, dq, dk, dv) over the whole
    sequence, as the ring's ranks hold them."""
    sm_scale = 1.0 / math.sqrt(q.shape[-1]) if sm_scale is None else float(sm_scale)
    qs, ks, vs, dos = ([c.contiguous() for c in t.chunk(cp, dim=2)] for t in (q, k, v, do))
    outs, lses = [], []
    for i in range(cp):
        out, lse = forward_hops(qs[i], ks[i], vs[i], i, cp, causal, sm_scale,
                                lambda r, k_, v_, i=i: (ks[(i - r - 1) % cp], vs[(i - r - 1) % cp]))
        outs.append(out.to(q.dtype))
        lses.append(lse)
    deltas = [_delta(dos[i].to(q.dtype), outs[i]) for i in range(cp)]
    dq = [torch.zeros(c.shape, dtype=torch.float32, device=q.device) for c in qs]
    dk = [torch.zeros(c.shape, dtype=torch.float32, device=q.device) for c in ks]  # dk[i]: the one rank i holds
    dv = [torch.zeros(c.shape, dtype=torch.float32, device=q.device) for c in vs]
    for r in range(cp):
        for i in range(cp):
            j = (i - r) % cp
            grads = hop_backward(qs[i], ks[j], vs[j], dos[i].to(q.dtype), lses[i], deltas[i],
                                 branch(causal, i, j), sm_scale)
            if grads is not None:
                dq[i] += grads[0]
                dk[i] += grads[1]
                dv[i] += grads[2]
        dk = [dk[(i - 1) % cp] for i in range(cp)]  # each accumulator moves one rank on
        dv = [dv[(i - 1) % cp] for i in range(cp)]
    # after cp moves rank i holds chunk i's accumulator again
    return (torch.cat(outs, dim=2), torch.cat(lses, dim=2), torch.cat(dq, dim=2).to(q.dtype),
            torch.cat(dk, dim=2).to(k.dtype), torch.cat(dv, dim=2).to(v.dtype))


# ----------------------------------------------------------- the dense tier


class Rotate(torch.autograd.Function):
    """x from rank i to rank i + 1 of `group`; the gradient goes back."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _exchange([x], group, 1)[0]

    @staticmethod
    def backward(ctx, grad):
        return _exchange([grad], ctx.group, -1)[0], None


def _dense_chunk_stats(q, k, v, q_offset: int, k_offset: int, causal: bool, sm_scale: float):
    """One dense logits block, [B, S, H, D] layout -> (o unnormalized fp32
    [B, Sq, Hq, D], m and l fp32 [B, Sq, Hq]) (JAX `_dense_chunk_stats`)."""
    b, sq, hq, d = q.shape
    hkv = k.shape[2]
    qg = q.reshape(b, sq, hkv, hq // hkv, d).float()
    s = torch.einsum("bshgd,bthd->bhgst", qg * sm_scale, k.float())
    if causal:
        q_pos = q_offset + torch.arange(sq, device=q.device)
        k_pos = k_offset + torch.arange(k.shape[1], device=q.device)
        s = s.masked_fill(~(q_pos[:, None] >= k_pos[None, :]), NEG_INF)
    m = s.amax(dim=-1)
    p = torch.exp(s - m[..., None])
    p = p.masked_fill((m == NEG_INF)[..., None], 0.0)  # fully masked rows: l stays 0
    l = p.sum(dim=-1)
    o = torch.einsum("bhgst,bthd->bshgd", p, v.float()).reshape(b, sq, hq, d)
    return o, m.permute(0, 3, 1, 2).reshape(b, sq, hq), l.permute(0, 3, 1, 2).reshape(b, sq, hq)


def _merge_stats(acc, m_run, l_run, o, m, l):
    """Online-softmax merge of one partial block into the running (acc, m, l)."""
    m_new = torch.maximum(m_run, m)
    alpha = torch.where(m_run == NEG_INF, 0.0, torch.exp(m_run - m_new))
    beta = torch.where(m == NEG_INF, 0.0, torch.exp(m - m_new))
    return acc * alpha[..., None] + o * beta[..., None], m_new, l_run * alpha + l * beta


def _chunk_attention_stats(q, k, v, q_offset: int, k_offset: int, causal: bool, sm_scale: float):
    """A hop's statistics, k-blocked with recompute above 2 * BLOCK_K keys
    (JAX `_chunk_attention_stats`)."""
    sk = k.shape[1]
    if sk <= 2 * BLOCK_K or sk % BLOCK_K:
        return _dense_chunk_stats(q, k, v, q_offset, k_offset, causal, sm_scale)
    b, sq, hq, d = q.shape
    acc = torch.zeros((b, sq, hq, d), dtype=torch.float32, device=q.device)
    m_run = torch.full((b, sq, hq), NEG_INF, dtype=torch.float32, device=q.device)
    l_run = torch.zeros((b, sq, hq), dtype=torch.float32, device=q.device)
    for start in range(0, sk, BLOCK_K):
        def block(acc, m_run, l_run, k_b, v_b, start=start):
            return _merge_stats(acc, m_run, l_run,
                                *_dense_chunk_stats(q, k_b, v_b, q_offset, k_offset + start, causal, sm_scale))

        acc, m_run, l_run = torch.utils.checkpoint.checkpoint(
            block, acc, m_run, l_run, k[:, start:start + BLOCK_K], v[:, start:start + BLOCK_K], use_reentrant=False)
    return acc, m_run, l_run


def ring_dense(q, k, v, group, causal: bool, sm_scale: float):
    """The dense ring (JAX `_ring_dense_local`), differentiable by autograd."""
    cp, me = group.size(), group.rank()
    b, s, hq, d = q.shape
    acc = torch.zeros((b, s, hq, d), dtype=torch.float32, device=q.device)
    m_run = torch.full((b, s, hq), NEG_INF, dtype=torch.float32, device=q.device)
    l_run = torch.zeros((b, s, hq), dtype=torch.float32, device=q.device)
    for r in range(cp):
        j = (me - r) % cp
        stats = _chunk_attention_stats(q, k, v, me * s, j * s, causal, sm_scale)
        acc, m_run, l_run = _merge_stats(acc, m_run, l_run, *stats)
        if r != cp - 1:
            k, v = Rotate.apply(k, group), Rotate.apply(v, group)
    return (acc / torch.clamp(l_run, min=1e-30)[..., None]).to(q.dtype)


def ring_attention(q, k, v, group, *, causal: bool = True, sm_scale: Optional[float] = None, impl: str = "flash"):
    """Context-parallel attention: q [B, S_local, Hq, D], k/v [B, S_local,
    Hkv, D], this rank's contiguous chunk of the sequence over `group` (the cp
    ring) -> [B, S_local, Hq, D]. `impl`: "flash" or "dense" (the model's
    attention implementation picks it; MODALITIES_TPU_RING_IMPL may only name
    the flash tier, ops/tiers.py)."""
    check_ring_impl()
    sm_scale = 1.0 / math.sqrt(q.shape[-1]) if sm_scale is None else float(sm_scale)
    if impl == "flash":
        return RingFlashAttention.apply(q, k, v, group, bool(causal), sm_scale)
    if impl == "dense":
        return ring_dense(q, k, v, group, bool(causal), sm_scale)
    raise ValueError(f"ring attention: impl {impl!r}, expected flash or dense")

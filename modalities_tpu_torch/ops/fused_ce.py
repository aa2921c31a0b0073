"""Fused (vocab-streaming) cross entropy: the port of
`modalities_tpu/ops/cross_entropy.py:fused_ce_sum_and_count` (its dispatch)
and of the Pallas kernels in `modalities_tpu/ops/pallas/fused_ce.py`
(`_fwd_kernel`, `_bwd_dh_kernel`, `_bwd_dw_kernel` and their `custom_vjp`).

`fused_ce_sum_and_count(hidden, head_weight, labels, *, ignore_index)` is the
CLM loss's `(total, count)` over `hidden @ head_weight.T` without the logits:
hidden [..., E], head_weight [V, E], labels [...]; rows whose label is
`ignore_index` count neither in the sum nor in `count`. Kernel-level entries,
in the kernels' flat-row layout (h [N, E], labels [N], statistics fp32 [N]):

- `fused_ce_forward(h, w, labels) -> (lse, corr)`: per row the logsumexp of
  the logits and the label's logit (0 where the label is not a vocab column);
- `fused_ce_backward_dh(h, w, labels, lse, gm) -> dh` in h's dtype and
  `fused_ce_backward_dw(...) -> dw` in w's dtype, for the per-row weight
  gm = g_total * mask.

Each dispatches on the tensors' device and nothing else: CPU tensors take the
plain PyTorch version beside it (dense fp32 logits for a block of rows at a
time), CUDA tensors launch the hand-written kernels in `csrc/fused_ce.cu` or
raise. `FusedCEFn` ties the kernels together under autograd. On the CPU,
`fused_ce_sum_and_count` is autograd of `plain_sum_and_count`.
"""

from __future__ import annotations

import ctypes

import torch

from modalities_tpu_torch.ops import _build

# E the bf16 kernels are compiled for: the 32k config's 1536 and the 7B's 4096 (dh and dW on a cluster of 16
# CTAs there, 8 below), and two for the tests
BF16_WIDTHS = (128, 256, 1536, 4096)
PLAIN_BLOCK_ROWS = 4096  # rows of dense fp32 logits the plain versions hold at a time
FWD_SPLITS = 8  # vocab splits of the bf16 forward kernel: CTAs per 128-row block of h
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


class _CEParams(ctypes.Structure):
    """Mirror of `struct CEParams` in csrc/fused_ce.cu."""

    _fields_ = [
        ("h", ctypes.c_void_p),
        ("w", ctypes.c_void_p),
        ("labels", ctypes.c_void_p),
        ("lse", ctypes.c_void_p),
        ("gm", ctypes.c_void_p),
        ("lse_out", ctypes.c_void_p),
        ("corr_out", ctypes.c_void_p),
        ("dh", ctypes.c_void_p),
        ("dw", ctypes.c_void_p),
        ("part", ctypes.c_void_p),
        ("n", ctypes.c_int),
        ("v", ctypes.c_int),
        ("e", ctypes.c_int),
        ("splits", ctypes.c_int),
    ]


# ------------------------------------------------------------ plain versions


def _row_blocks(n: int):
    return ((i, min(i + PLAIN_BLOCK_ROWS, n)) for i in range(0, n, PLAIN_BLOCK_ROWS))


def _label_logit(s, labels):
    """s[i, labels[i]] where the label is a column of s, else 0."""
    lab = labels.long()
    ok = (lab >= 0) & (lab < s.shape[1])
    return torch.where(ok, s.gather(1, lab.clamp(0, s.shape[1] - 1)[:, None])[:, 0], torch.zeros_like(s[:, 0]))


def reference_fused_ce_forward(h, w, labels):
    """The plain version of the forward kernel: (lse, corr) fp32 [N]."""
    wf = w.float()
    lse, corr = [], []
    for a, b in _row_blocks(h.shape[0]):
        s = h[a:b].float() @ wf.t()
        lse.append(torch.logsumexp(s, dim=-1))
        corr.append(_label_logit(s, labels[a:b]))
    return torch.cat(lse), torch.cat(corr)


def reference_fused_ce_backward(h, w, labels, lse, gm):
    """The plain version of the two backward kernels: ds = gm * (exp(s - lse)
    - onehot(label)) per block of rows in fp32; (dh = ds W in h's dtype,
    dw = ds^T h in w's dtype)."""
    wf = w.float()
    dh = torch.empty(h.shape, dtype=h.dtype, device=h.device)
    dw = torch.zeros(w.shape, dtype=torch.float32, device=w.device)
    for a, b in _row_blocks(h.shape[0]):
        hb = h[a:b].float()
        ds = torch.exp(hb @ wf.t() - lse[a:b, None].float())
        lab = labels[a:b].long()
        hit = (lab >= 0) & (lab < w.shape[0])
        rows = torch.arange(b - a, device=h.device)[hit]
        ds[rows, lab[hit]] -= 1.0
        ds *= gm[a:b, None].float()
        dh[a:b] = (ds @ wf).to(h.dtype)
        dw += ds.t() @ hb
    return dh, dw.to(w.dtype)


def plain_sum_and_count(h, w, labels, *, ignore_index: int = -100):
    """(total, count) of the CE over h [N, E] @ w.T, differentiable by
    autograd: dense fp32 logits for a block of rows at a time, logsumexp and
    the label's logit (the JAX package's `_dense_sum_and_count`)."""
    wf = w.float()
    mask = labels != ignore_index
    total = torch.zeros((), dtype=torch.float32, device=h.device)
    for a, b in _row_blocks(h.shape[0]):
        s = h[a:b].float() @ wf.t()
        safe = torch.where(mask[a:b], labels[a:b].long(), 0)
        per_row = torch.logsumexp(s, dim=-1) - s.gather(1, safe[:, None])[:, 0]
        total = total + (per_row * mask[a:b]).sum()
    return total, mask.sum().float()


# ------------------------------------------------------------------- kernels


def _on_card(fn_name, t) -> bool:
    if t.device.type == "cpu":
        return False
    if t.device.type != "cuda":
        raise RuntimeError(f"{fn_name}: no kernel for device {t.device}")
    return True


def _kernel_inputs(h, w, labels):
    """Checked, contiguous kernel operands and the dtype code: bf16 when h and
    w are both bf16 (E must be one of BF16_WIDTHS), else both widened to fp32
    (exactly what the TPU kernel computes from mixed dtypes)."""
    if h.dim() != 2 or w.dim() != 2 or h.shape[1] != w.shape[1]:
        raise ValueError(f"fused CE kernels: h [N, E] and w [V, E], got {tuple(h.shape)}, {tuple(w.shape)}")
    if labels.numel() != h.shape[0]:
        raise ValueError(f"fused CE kernels: {labels.numel()} labels for {h.shape[0]} rows")
    if h.shape[0] == 0 or w.shape[0] == 0:
        raise ValueError("fused CE kernels: need at least one row and one vocab column")
    if h.dtype not in _DTYPE_CODES or w.dtype not in _DTYPE_CODES:
        raise TypeError(f"fused CE kernels: h and w must be float32 or bfloat16, got {h.dtype}/{w.dtype}")
    if w.device != h.device or labels.device != h.device:
        raise ValueError("fused CE kernels: h, w and labels must lie on one device")
    bf16 = h.dtype == w.dtype == torch.bfloat16
    if bf16:
        check_bf16_width(h.shape[1])
    _build.require_hopper(h)
    if bf16:
        h, w = h.contiguous(), w.contiguous()
        if h.data_ptr() % 16 or w.data_ptr() % 16:
            raise ValueError("fused CE bf16 kernels: h and w must be 16-byte aligned")
        code = 1
    else:
        h, w = h.float().contiguous(), w.float().contiguous()
        code = 0
    return h, w, labels.reshape(-1).to(torch.int32).contiguous(), code


def check_bf16_width(e: int) -> None:
    """Raise unless the bf16 kernels are built for width `e` (BF16_WIDTHS)."""
    if e not in BF16_WIDTHS:
        raise ValueError(f"fused CE bf16 kernels: E={e} is not a width they are built for {BF16_WIDTHS}")


def clusters(kernel: str, e: int) -> tuple[int, int]:
    """The clusters of the bf16 `kernel` ("dh" or "dw") at width `e` on the
    current card: (CTAs a cluster, each owning E / CTAs columns; how many
    clusters it holds at once, cudaOccupancyMaxActiveClusters)."""
    check_bf16_width(e)
    ctas, resident = ctypes.c_int(0), ctypes.c_int(0)
    status = _build.library().mt_fused_ce_clusters({"dh": 1, "dw": 2}[kernel], e, ctypes.byref(ctas),
                                                   ctypes.byref(resident))
    _build.check(status, f"mt_fused_ce_clusters({kernel}, {e})")
    return ctas.value, resident.value


def _params(h, w, labels) -> _CEParams:
    p = _CEParams()
    p.h, p.w, p.labels = h.data_ptr(), w.data_ptr(), labels.data_ptr()
    p.n, p.e = h.shape
    p.v = w.shape[0]
    return p


def _run(fn_name: str, p: _CEParams, code: int, t) -> None:
    lib = _build.library()
    with torch.cuda.device(t.device):
        status = getattr(lib, fn_name)(ctypes.addressof(p), code, _build.stream_of(t))
    _build.check(status, fn_name)


def _stat(t):
    return t.reshape(-1).float().contiguous()


# ------------------------------------------------------------ public entries


def fused_ce_forward(h, w, labels):
    """h [N, E], w [V, E], labels [N] -> (lse, corr), fp32 [N]."""
    if not _on_card("fused_ce_forward", h):
        return reference_fused_ce_forward(h, w, labels)
    hk, wk, lab, code = _kernel_inputs(h, w, labels)
    lse = torch.empty(hk.shape[0], dtype=torch.float32, device=h.device)
    corr = torch.empty_like(lse)
    p = _params(hk, wk, lab)
    p.lse_out, p.corr_out = lse.data_ptr(), corr.data_ptr()
    if code == 1:  # the bf16 kernel's per-split (m2, l, corr), merged by its second kernel
        part = torch.empty(3 * FWD_SPLITS * hk.shape[0], dtype=torch.float32, device=h.device)
        p.part, p.splits = part.data_ptr(), FWD_SPLITS
    _run("mt_fused_ce_fwd", p, code, h)
    fused_ce_forward.launches += 1
    return lse, corr


def fused_ce_backward_dh(h, w, labels, lse, gm):
    """dh [N, E] in h's dtype for the per-row weights gm (fp32 [N])."""
    if not _on_card("fused_ce_backward_dh", h):
        return reference_fused_ce_backward(h, w, labels, lse, gm)[0]
    hk, wk, lab, code = _kernel_inputs(h, w, labels)
    lse, gm = _stat(lse), _stat(gm)
    dh = torch.empty(hk.shape, dtype=hk.dtype, device=h.device)
    p = _params(hk, wk, lab)
    p.lse, p.gm, p.dh = lse.data_ptr(), gm.data_ptr(), dh.data_ptr()
    _run("mt_fused_ce_bwd_dh", p, code, h)
    fused_ce_backward_dh.launches += 1
    return dh.to(h.dtype)


def fused_ce_backward_dw(h, w, labels, lse, gm):
    """dw [V, E] in w's dtype for the per-row weights gm (fp32 [N])."""
    if not _on_card("fused_ce_backward_dw", h):
        return reference_fused_ce_backward(h, w, labels, lse, gm)[1]
    hk, wk, lab, code = _kernel_inputs(h, w, labels)
    lse, gm = _stat(lse), _stat(gm)
    dw = torch.empty(wk.shape, dtype=wk.dtype, device=h.device)
    p = _params(hk, wk, lab)
    p.lse, p.gm, p.dw = lse.data_ptr(), gm.data_ptr(), dw.data_ptr()
    _run("mt_fused_ce_bwd_dw", p, code, h)
    fused_ce_backward_dw.launches += 1
    return dw.to(w.dtype)


fused_ce_forward.launches = 0  # kernel launches since the last reset (the CPU path never counts)
fused_ce_backward_dh.launches = 0
fused_ce_backward_dw.launches = 0


class FusedCEFn(torch.autograd.Function):
    """(total, count) over h [N, E] @ w.T through the kernels (the JAX
    `_fused_ce` custom_vjp): the forward saves h, w, labels, lse and the row
    mask; the backward launches dh and dw with gm = g_total * mask. `count`
    depends on the integer labels only and carries no gradient."""

    @staticmethod
    def forward(ctx, h, w, labels, ignore_index):
        lse, corr = fused_ce_forward(h, w, labels)
        mask = (labels != ignore_index).float()
        ctx.save_for_backward(h, w, labels, lse, mask)
        count = mask.sum()
        ctx.mark_non_differentiable(count)
        return ((lse - corr) * mask).sum(), count

    @staticmethod
    def backward(ctx, g_total, _g_count):
        h, w, labels, lse, mask = ctx.saved_tensors
        gm = (g_total * mask).float()
        dh = fused_ce_backward_dh(h, w, labels, lse, gm) if ctx.needs_input_grad[0] else None
        dw = fused_ce_backward_dw(h, w, labels, lse, gm) if ctx.needs_input_grad[1] else None
        return dh, dw, None, None


def fused_ce_sum_and_count(hidden, head_weight, labels, *, ignore_index: int = -100):
    """(total, count), fp32 scalars, of the CE over hidden [..., E] @
    head_weight.T for labels [...]: `FusedCEFn` on CUDA tensors, autograd of
    `plain_sum_and_count` on CPU tensors. Rows are flattened; gradients come
    back in hidden's and head_weight's shapes and dtypes."""
    e = hidden.shape[-1]
    h2, lab = hidden.reshape(-1, e), labels.reshape(-1)
    if lab.shape[0] != h2.shape[0]:
        raise ValueError(f"fused CE: {lab.shape[0]} labels for {h2.shape[0]} rows of hidden {tuple(hidden.shape)}")
    if not _on_card("fused_ce_sum_and_count", hidden):
        return plain_sum_and_count(h2, head_weight, lab, ignore_index=ignore_index)
    return FusedCEFn.apply(h2, head_weight, lab, int(ignore_index))

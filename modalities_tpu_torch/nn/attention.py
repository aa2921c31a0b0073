"""Generic multi-head attention for the models other than GPT2 (the ViT and
CoCa): the port of modalities_tpu/nn/attention.py.

Causal self-attention, non-causal self-attention and cross-attention (k and
v from `context`), the three kinds the JAX module computes with
`jax.nn.dot_product_attention`, XLA's fused SDPA tier. The port runs that
tier on its flash kernels (ops/flash_attention.py:flash_attention), as the
GPT2 port does for `pytorch_flash`: causal for `CAUSAL_SELF_ATTENTION`,
non-causal for the other two. On the CPU that is the plain attention.

The projections are flax `DenseGeneral` kernels stored 2-D as the GPT2 port
stores them: q/k/v [E_in, H x D] ([E_in, H, D] in JAX), c_proj [H x D, E]
([H, D, E]). Every product runs in x's dtype (flax's `dtype=x.dtype`).
"""

from __future__ import annotations

from enum import Enum
from typing import Optional

from torch import nn

from modalities_tpu_torch.models.gpt2.gpt2_model import Linear
from modalities_tpu_torch.ops.flash_attention import flash_attention


class AttentionType(str, Enum):
    CAUSAL_SELF_ATTENTION = "causal_self_attention"
    NON_CAUSAL_SELF_ATTENTION = "non_causal_self_attention"
    CROSS_ATTENTION = "cross_attention"


def refuse_dropout(dropout: float) -> None:
    """The training forward has no dropout yet (as the GPT2 port's)."""
    if dropout > 0.0:
        raise NotImplementedError("dropout > 0 in the training forward is not ported yet (ROADMAP.md, Queue 1 "
                                  "item 7); set dropout: 0.0")


class MultiHeadAttention(nn.Module):
    """q from x, k and v from x (self-attention) or from `context`
    (cross-attention, whose width `context_features` may differ from
    `n_embd`), attention over the heads, then c_proj back to `n_embd`."""

    def __init__(self, n_embd: int, n_head: int, bias: bool = True, dropout: float = 0.0,
                 attention_type: AttentionType = AttentionType.CAUSAL_SELF_ATTENTION,
                 context_features: Optional[int] = None, device=None):
        super().__init__()
        if n_embd % n_head:
            raise ValueError(f"n_embd {n_embd} is not divisible by n_head {n_head}")
        self.n_head, self.head_dim = n_head, n_embd // n_head
        self.dropout = float(dropout)
        self.attention_type = AttentionType(attention_type)
        cross = self.attention_type == AttentionType.CROSS_ATTENTION
        kv_in = context_features if cross and context_features else n_embd
        self.q_attn = Linear(n_embd, n_embd, bias, device=device)
        self.k_attn = Linear(kv_in, n_embd, bias, device=device)
        self.v_attn = Linear(kv_in, n_embd, bias, device=device)
        self.c_proj = Linear(n_embd, n_embd, bias, device=device)

    def forward(self, x, context=None):
        """x [B, Sq, E] (and context [B, Sk, E_ctx]) -> [B, Sq, E] in x's dtype."""
        if self.training:
            refuse_dropout(self.dropout)
        cross = self.attention_type == AttentionType.CROSS_ATTENTION
        if cross and context is None:
            raise ValueError("cross_attention requires a context tensor")
        kv_source = context.to(x.dtype) if cross else x
        b, sq, _ = x.shape
        sk = kv_source.shape[1]
        q = self.q_attn(x).reshape(b, sq, self.n_head, self.head_dim)
        k = self.k_attn(kv_source).reshape(b, sk, self.n_head, self.head_dim)
        v = self.v_attn(kv_source).reshape(b, sk, self.n_head, self.head_dim)
        y = flash_attention(q, k, v, causal=self.attention_type == AttentionType.CAUSAL_SELF_ATTENTION)
        return self.c_proj(y.reshape(b, sq, -1))

"""GPT2-family decoder LLM on Hopper: the port of
modalities_tpu/models/gpt2/gpt2_model.py for the serving engine's ring KV
cache and for training.

Kept from the JAX model: the config surface and its validation
(`GPT2LLMConfig`), GQA attention with RoPE, SwiGLU or GELU MLPs, pre-norm
blocks, NOPE/ABSOLUTE positions, tied or untied fp32 heads, weight-only
quantized dense layers, the slot-cache API over the ring (`init_slot_cache`,
`prefill_slot`, `decode_slots`), the same over the paged block pool
(`init_paged_cache`, `prefill_paged`, `decode_paged`, `verify_paged`; bf16 or
int8 KV) and the full-sequence training forward
(`GPT2Module.forward`, logits [B, S, V] fp32; `forward_hidden` stops after
`lm_head_norm` for the chunked and fused-CE heads), with the same numerics at
every cast point. Attention in training follows `attention_implementation`:
`manual` runs the plain oracle; `dao_flash` and `pytorch_flash` (the JAX
package's Pallas and XLA-SDPA tiers, both fused exact attention) run the
port's flash kernels (ops/flash_attention.py). Under context parallelism
(`set_context_parallel`) the training forward sees this rank's contiguous
chunk of the sequence: RoPE and `wpe` take the chunk's global offset and
attention runs the ring over the cp group (parallel/ring_attention.py; the
flash ring, or the dense ring under `manual`). Under tensor parallelism
(`set_tensor_parallel`, applied by parallel/tensor_parallel.py) the
parameters are DTensors over tp and every body computes on its local shard:
attention on this rank's heads, the vocab-parallel lookup and head, the
residual stream on this rank's rows of the sequence. Blocks chosen by the
spec's remat variant run under `torch.utils.checkpoint`
(training/activation_checkpointing.py). Not here yet: selective-op remat and
dropout. Pipeline parallelism
runs a stage's share of the blocks (`stage_forward`) on a module that holds
only that share (parallel/pipeline.py).

Layout: parameters follow the flax tree with the scan axis unrolled — the
state dict key `blocks.3.attn.q_attn.kernel` is `params/blocks/block/attn/
q_attn/kernel[3]` — and every dense kernel is stored 2-D as [in, out]
(flax's DenseGeneral kernel with its input and output dims flattened), so the
JAX weights convert by reshaping (conversion/from_jax.py).

`GPT2LLM` is the framework-level model (what the registry builds from a config
node): it holds the static spec, makes fp32 parameters from a
`torch.Generator`, and builds the `GPT2Module` (an `nn.Module`) that serves
them. Building casts the blocks' dense kernels to the compute dtype once, which
is bitwise what flax's per-call cast does; norm scales, the embedding and the
head stay fp32, as the JAX model computes them. For training it builds the
module over parameters in `param_dtype` (norm parameters stay fp32, as flax's
default param dtype leaves them) and casts to the compute dtype per call.
"""

from __future__ import annotations

import dataclasses
import math
import re
from enum import Enum
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from modalities_tpu_torch.config.config import (
    check_bool,
    check_choice,
    check_dict,
    check_float,
    check_int,
    check_str,
    validate_config,
)
from modalities_tpu_torch.models.components.layer_norms import NormSpec, build_norm
from modalities_tpu_torch.ops.flash_attention import flash_attention, reference_attention
from modalities_tpu_torch.ops.quant_matmul import PreparedWeight, quant_matmul
from modalities_tpu_torch.ops.tiers import check_kernel_switches
from modalities_tpu_torch.parallel.ring_attention import ring_attention
from modalities_tpu_torch.parallel.tensor_parallel import gather_vocab, local, vocab_parallel_embedding
from modalities_tpu_torch.quant.core import quantize_per_channel
from modalities_tpu_torch.quant.weights import quant_storage_dtype
from modalities_tpu_torch.training.activation_checkpointing import checkpointed, layer_remats


class PositionTypes(str, Enum):
    ABSOLUTE = "ABSOLUTE"
    NOPE = "NOPE"


class ActivationType(str, Enum):
    GELU = "gelu"
    SWIGLU = "swiglu"
    FUSED_SWIGLU = "fused_swiglu"  # config-compat alias of swiglu


class AttentionImplementation(str, Enum):
    # serving: every tier goes through the same masked attention on the ring
    # cache, as in the JAX model's slot path; training dispatches on the tier
    MANUAL = "manual"
    PYTORCH_FLASH = "pytorch_flash"
    DAO_FLASH = "dao_flash"


class QueryKeyValueTransformType(Enum):
    IdentityTransform = "IdentityTransform"
    RotaryTransform = "RotaryTransform"


@dataclasses.dataclass
class RotaryTransformConfig:
    n_embd: int
    n_head: int
    seq_length_dim: int = -2
    base_freq: int = 10000

    def __post_init__(self):
        check_int("n_embd", self.n_embd, ge=0)
        check_int("n_head", self.n_head, ge=0)
        check_int("seq_length_dim", self.seq_length_dim)
        check_int("base_freq", self.base_freq, ge=10000)


@dataclasses.dataclass
class QueryKeyValueTransformConfig:
    type_hint: str
    config: dict

    def __post_init__(self):
        self.type_hint = check_choice("type_hint", self.type_hint, QueryKeyValueTransformType)
        check_dict("config", self.config)
        if self.type_hint == QueryKeyValueTransformType.RotaryTransform.value:
            self.config = validate_config(RotaryTransformConfig, self.config)
        elif self.config:
            raise ValueError(f"IdentityTransform takes no config, got {self.config}")


@dataclasses.dataclass
class AttentionConfig:
    qkv_transforms: list = dataclasses.field(default_factory=list)
    qk_norm_config: Optional[dict] = None

    def __post_init__(self):
        if not isinstance(self.qkv_transforms, list):
            raise ValueError(f"qkv_transforms: expected a list, got {self.qkv_transforms!r}")
        self.qkv_transforms = [
            t if isinstance(t, QueryKeyValueTransformConfig) else validate_config(QueryKeyValueTransformConfig, t)
            for t in self.qkv_transforms
        ]
        check_dict("qk_norm_config", self.qk_norm_config, optional=True)


@dataclasses.dataclass
class GPT2LLMConfig:
    """The JAX GPT2LLMConfig's fields and checks (gpt2_model.py:94-156)."""

    sample_key: str
    prediction_key: str
    poe_type: str
    sequence_length: int
    vocab_size: int
    n_layer: int
    n_head_q: int
    n_head_kv: int
    n_embd: int
    ffn_hidden: int
    dropout: float
    bias: bool
    attention_config: dict
    attention_implementation: str
    activation_type: str
    attention_norm_config: dict
    ffn_norm_config: dict
    lm_head_norm_config: dict
    use_weight_tying: bool
    use_meta_device: Optional[bool] = False
    seed: Optional[int] = None
    enforce_swiglu_hidden_dim_multiple_of: int = 256
    lm_head_chunk_size: Optional[int] = None  # training: the chunked / fused-CE head (train_step.py)
    lm_head_fused_ce: str = "auto"  # with a chunk size: auto/on the fused-CE kernels, off the chunked scan

    def __post_init__(self):
        check_str("sample_key", self.sample_key)
        check_str("prediction_key", self.prediction_key)
        self.poe_type = check_choice("poe_type", self.poe_type, PositionTypes)
        for name in ("sequence_length", "vocab_size", "n_layer", "n_head_q", "n_head_kv", "n_embd", "ffn_hidden"):
            check_int(name, getattr(self, name), ge=1)
        self.dropout = check_float("dropout", self.dropout, ge=0.0)
        check_bool("bias", self.bias)
        if not isinstance(self.attention_config, AttentionConfig):
            self.attention_config = validate_config(AttentionConfig, check_dict("attention_config", self.attention_config))
        self.attention_implementation = check_choice(
            "attention_implementation", self.attention_implementation, AttentionImplementation
        )
        self.activation_type = check_choice("activation_type", self.activation_type, ActivationType)
        for name in ("attention_norm_config", "ffn_norm_config", "lm_head_norm_config"):
            check_dict(name, getattr(self, name))
        check_bool("use_weight_tying", self.use_weight_tying)
        check_bool("use_meta_device", self.use_meta_device, optional=True)
        check_int("seed", self.seed, optional=True)
        check_int("enforce_swiglu_hidden_dim_multiple_of", self.enforce_swiglu_hidden_dim_multiple_of)
        check_int("lm_head_chunk_size", self.lm_head_chunk_size, ge=1, optional=True)
        if self.lm_head_fused_ce not in ("auto", "on", "off"):
            raise ValueError(f"lm_head_fused_ce: expected auto/on/off, got {self.lm_head_fused_ce!r}")
        if self.n_head_q % self.n_head_kv != 0:
            raise ValueError("n_head_q must be divisible by n_head_kv")
        if self.dropout > 0.0 and self.attention_implementation == AttentionImplementation.DAO_FLASH.value:
            raise ValueError(
                "dropout > 0 is not supported with attention_implementation: dao_flash; "
                "use manual or pytorch_flash, or set dropout: 0.0"
            )
        for value, name in ((self.ffn_hidden, "ffn_hidden"), (self.vocab_size, "vocab_size"), (self.n_embd, "n_embd")):
            if value % 128 != 0:
                raise ValueError(f"{name} with value {value} should be divisible by 128 for efficient training.")


def swiglu_hidden_dim(ffn_hidden: int, multiple_of: int = 256) -> int:
    """2/3 scale-down rounded up to a multiple (JAX gpt2_model.py:159)."""
    adjusted = int(2 * ffn_hidden / 3)
    return ((adjusted + multiple_of - 1) // multiple_of) * multiple_of


@dataclasses.dataclass(frozen=True)
class GPT2ModelSpec:
    """Static hyperparameters of the model (the serving subset of the JAX spec)."""

    vocab_size: int
    sequence_length: int
    n_layer: int
    n_head_q: int
    n_head_kv: int
    n_embd: int
    ffn_hidden: int
    bias: bool
    poe_type: str
    activation: str
    use_rope: bool
    rope_base_freq: int
    use_weight_tying: bool
    swiglu_hidden: int
    attn_norm: NormSpec
    ffn_norm: NormSpec
    lm_head_norm: NormSpec
    qk_norm: Optional[NormSpec]
    compute_dtype: str = "bfloat16"  # block compute dtype
    # weight-only quantized serving: "none" | "int8" | "fp8" (quant/weights.py)
    quant_weights: str = "none"
    attention_impl: str = AttentionImplementation.MANUAL.value  # the training forward's tier
    dropout: float = 0.0
    param_dtype: str = "float32"  # storage dtype of the training parameters (norms stay fp32)
    lm_head_chunk_size: Optional[int] = None
    lm_head_fused_ce: str = "auto"
    remat_variant: Optional[str] = None  # None, "full" or "selective_layer" (activation_checkpointing.py)
    remat_freq: int = 1
    # pipeline parallelism (the `pipelined` variant; the mesh's pp axis decides whether it runs)
    pp_schedule: str = "gpipe"
    pp_num_microbatches: Optional[int] = None  # default: the pp degree
    pp_num_virtual: int = 1

    @property
    def head_dim(self) -> int:
        return self.n_embd // self.n_head_q


# ------------------------------------------------------------------ numerics


def rope_tables(head_dim: int, seq_len: int, base_freq: int, dtype=torch.float32):
    """cos/sin tables [seq_len, head_dim], rotate-half convention. Computed in
    fp32 on the CPU and cast to `dtype` — the cast point the JAX model uses
    (gpt2_model.py:301-305), which greedy tokens in bf16 depend on."""
    inv_freq = 1.0 / (base_freq ** (torch.arange(0, head_dim, 2, dtype=torch.float32) / head_dim))
    t = torch.arange(seq_len, dtype=torch.float32)
    freqs = torch.outer(t, inv_freq)
    emb = torch.cat([freqs, freqs], dim=-1)
    return emb.cos().to(dtype), emb.sin().to(dtype)


def _rotate_half(x):
    x1, x2 = x.chunk(2, dim=-1)
    return torch.cat([-x2, x1], dim=-1)


def apply_rope(x, cos, sin):
    """x: [B, S, H, D]; cos/sin: [S, D] shared across the batch, or [B, S, D]
    per batch row (decode: each slot at its own position)."""
    if cos.ndim == 2:
        cos, sin = cos[None, :, None, :], sin[None, :, None, :]
    else:
        cos, sin = cos[:, :, None, :], sin[:, :, None, :]
    return x * cos + _rotate_half(x) * sin


def masked_attention(q, k, v, mask):
    """Attention with an explicit boolean mask, [Sq, Sk] or per row [B, Sq, Sk].
    q: [B, Sq, Hq, D], k/v: [B, Sk, Hkv, D]; q head h reads kv head h // group.

    Numerics as the JAX function (gpt2_model.py:344-371): q.k in the compute
    dtype, then fp32 divided by sqrt(D); masked logits filled with the fp32
    minimum; softmax in fp32; probabilities cast to v's dtype before P.V."""
    b, sq, hq, d = q.shape
    hkv = k.shape[2]
    qg = q.reshape(b, sq, hkv, hq // hkv, d)
    logits = torch.einsum("bshgd,bthd->bhgst", qg, k).float() / math.sqrt(d)
    mask_b = mask[None, None, None] if mask.ndim == 2 else mask[:, None, None]
    logits = logits.masked_fill(~mask_b, torch.finfo(torch.float32).min)
    probs = torch.softmax(logits, dim=-1).to(v.dtype)
    out = torch.einsum("bhgst,bthd->bshgd", probs, v)
    return out.reshape(b, sq, hq, d)


# -------------------------------------------------------------------- layers


class Linear(nn.Module):
    """Dense layer over a 2-D [in, out] kernel (flax DenseGeneral, flattened).
    A row-parallel layer under tensor parallelism (`bias_after_sum`) returns
    its partial product without the bias: whoever sums the partials adds the
    bias once, after the sum (parallel/tensor_parallel.py)."""

    bias_after_sum = False

    def __init__(self, in_features: int, out_features: int, bias: bool, device=None):
        super().__init__()
        self.kernel = nn.Parameter(torch.empty(in_features, out_features, device=device))
        self.bias = nn.Parameter(torch.zeros(out_features, device=device)) if bias else None

    def forward(self, x):
        """In x's dtype: the kernel (and bias) are cast per call when they are
        stored in another dtype (flax's `dtype` semantics; a no-op in serving,
        where kernels are cast once at load). Under tensor parallelism, this
        rank's shard."""
        y = torch.matmul(x, local(self.kernel).to(x.dtype))
        return y if self.bias is None or self.bias_after_sum else y + local(self.bias).to(y.dtype)

    def cast_(self, dtype):
        self.kernel.data = self.kernel.data.to(dtype)
        if self.bias is not None:
            self.bias.data = self.bias.data.to(dtype)


class QuantLinear(nn.Module):
    """Dense layer over a weight-only quantized [in, out] kernel (int8 or
    float8_e4m3fn) and its fp32 per-output-channel `scale` — the port of
    QuantDenseGeneral (gpt2_model.py:395-455). The matmul runs through
    ops/quant_matmul.py: the fused dequant kernel on the card, with the weight
    checked and its tensor map built once (`PreparedWeight`, made anew when
    the kernel or scale tensor is replaced)."""

    def __init__(self, in_features: int, out_features: int, bias: bool, storage: torch.dtype, device=None):
        super().__init__()
        self.register_buffer("kernel", torch.empty(in_features, out_features, dtype=storage, device=device))
        self.register_buffer("scale", torch.ones(out_features, device=device))
        self.bias = nn.Parameter(torch.zeros(out_features, device=device)) if bias else None
        self._prepared = None

    def forward(self, x):
        x2, kernel, scale = x.reshape(-1, x.shape[-1]), self.kernel, self.scale
        prepared = None
        if x2.is_cuda:
            prepared = self._prepared
            if prepared is None or not prepared.holds(kernel, scale):
                prepared = self._prepared = PreparedWeight(kernel, scale)
        y = quant_matmul(x2, kernel, scale, prepared)
        y = y.reshape(*x.shape[:-1], y.shape[-1])
        return y + self.bias if self.bias is not None else y

    def cast_(self, dtype):
        if self.bias is not None:
            self.bias.data = self.bias.data.to(dtype)


def _dense(spec: GPT2ModelSpec, in_f: int, out_f: int, bias: bool, device):
    if spec.quant_weights != "none":
        return QuantLinear(in_f, out_f, bias, quant_storage_dtype(spec.quant_weights), device=device)
    return Linear(in_f, out_f, bias, device=device)


class CausalSelfAttention(nn.Module):
    """GQA attention over the ring KV cache (JAX `_slot_attention`,
    gpt2_model.py:724-787) or the paged block pool (JAX
    `_paged_slot_attention`, gpt2_model.py:614-722)."""

    def __init__(self, spec: GPT2ModelSpec, device=None):
        super().__init__()
        self.spec = spec
        hd = spec.head_dim
        self.q_attn = _dense(spec, spec.n_embd, spec.n_head_q * hd, spec.bias, device)
        self.k_attn = _dense(spec, spec.n_embd, spec.n_head_kv * hd, spec.bias, device)
        self.v_attn = _dense(spec, spec.n_embd, spec.n_head_kv * hd, spec.bias, device)
        self.c_proj = _dense(spec, spec.n_head_q * hd, spec.n_embd, spec.bias, device)
        if spec.qk_norm is not None:
            cd = getattr(torch, spec.compute_dtype)
            self.q_norm = build_norm(spec.qk_norm, dtype=cd, device=device)
            self.k_norm = build_norm(spec.qk_norm, dtype=cd, device=device)
        self.cp_group = None  # the cp ring's process group under context parallelism

    def forward(self, x, cache, layer: int, step):
        """x: [B, S, E]; `cache` the ring (SlotCache, this layer's [slots,
        capacity, Hkv, D]) or the block pool (PagedCache), written IN PLACE at
        the step's positions before it is read."""
        spec = self.spec
        b, s, _ = x.shape
        hd = spec.head_dim
        q = self.q_attn(x).reshape(b, s, spec.n_head_q, hd)
        k = self.k_attn(x).reshape(b, s, spec.n_head_kv, hd)
        v = self.v_attn(x).reshape(b, s, spec.n_head_kv, hd)
        if spec.qk_norm is not None:
            q, k = self.q_norm(q), self.k_norm(k)
        if step.cos is not None:
            q = apply_rope(q, step.cos, step.sin)
            k = apply_rope(k, step.cos, step.sin)
        if step.tables is not None:
            k_all, v_all = cache.write_and_gather(layer, k, v, step)
        elif step.slot is not None:  # prefill: one chunk into row `slot` at step.start
            cache_k, cache_v = cache.k[layer], cache.v[layer]
            cache_k[step.slot, step.start : step.start + s] = k[0]
            cache_v[step.slot, step.start : step.start + s] = v[0]
            k_all = cache_k[step.slot : step.slot + 1]
            v_all = cache_v[step.slot : step.slot + 1]
        else:  # decode: one token per slot at its own position
            cache_k, cache_v = cache.k[layer], cache.v[layer]
            rows = torch.arange(b, device=x.device)
            cache_k[rows, step.positions] = k[:, 0]
            cache_v[rows, step.positions] = v[:, 0]
            k_all, v_all = cache_k, cache_v
        y = masked_attention(q, k_all, v_all, step.mask)
        return self.c_proj(y.reshape(b, s, spec.n_head_q * hd))

    def train_forward(self, x, cos, sin):
        """Full-sequence causal attention (JAX `CausalSelfAttention.__call__`,
        gpt2_model.py:496-576): x [B, S, E] in the compute dtype (this rank's
        chunk under context parallelism); cos/sin the RoPE rows of x's
        positions or None. Under tensor parallelism q/k/v hold this rank's
        n_head_q / tp and n_head_kv / tp heads."""
        spec = self.spec
        b, s, _ = x.shape
        hd = spec.head_dim
        q = self.q_attn(x).reshape(b, s, -1, hd)
        k = self.k_attn(x).reshape(b, s, -1, hd)
        v = self.v_attn(x).reshape(b, s, -1, hd)
        if spec.qk_norm is not None:
            q, k = self.q_norm(q), self.k_norm(k)
        if cos is not None:
            q, k = apply_rope(q, cos, sin), apply_rope(k, cos, sin)
        manual = spec.attention_impl == AttentionImplementation.MANUAL.value
        if self.cp_group is not None:  # the JAX ring: dense under manual, flash hops otherwise
            y = ring_attention(q, k, v, self.cp_group, causal=True, impl="dense" if manual else "flash")
        elif manual:  # the JAX manual_attention oracle
            y = reference_attention(q, k, v, causal=True)
        else:  # dao_flash, pytorch_flash: fused exact attention
            y = flash_attention(q, k, v, causal=True)
        return self.c_proj(y.reshape(b, s, -1))


class MLP(nn.Module):
    """GELU MLP or SwiGLU (JAX gpt2_model.py:820)."""

    def __init__(self, spec: GPT2ModelSpec, device=None):
        super().__init__()
        self.gelu = spec.activation == ActivationType.GELU.value
        if self.gelu:
            self.c_fc = _dense(spec, spec.n_embd, spec.ffn_hidden, spec.bias, device)
            self.c_proj = _dense(spec, spec.ffn_hidden, spec.n_embd, spec.bias, device)
        else:
            self.W = _dense(spec, spec.n_embd, spec.swiglu_hidden, spec.bias, device)
            self.V = _dense(spec, spec.n_embd, spec.swiglu_hidden, spec.bias, device)
            self.W_2 = _dense(spec, spec.swiglu_hidden, spec.n_embd, spec.bias, device)

    def forward(self, x):
        if self.gelu:  # flax nn.gelu defaults to the tanh approximation
            return self.c_proj(F.gelu(self.c_fc(x), approximate="tanh"))
        return self.W_2(F.silu(self.W(x)) * self.V(x))


class GPT2Block(nn.Module):
    """Pre-norm residual block (JAX gpt2_model.py:843)."""

    def __init__(self, spec: GPT2ModelSpec, device=None):
        super().__init__()
        cd = getattr(torch, spec.compute_dtype)
        self.attention_norm = build_norm(spec.attn_norm, dtype=cd, device=device)
        self.attn = CausalSelfAttention(spec, device=device)
        self.ffn_norm = build_norm(spec.ffn_norm, dtype=cd, device=device)
        self.mlp = MLP(spec, device=device)

    def forward(self, x, cache, layer: int, step):
        x = x + self.attn(self.attention_norm(x), cache, layer, step)
        return x + self.mlp(self.ffn_norm(x))

    def train_forward(self, x, cos, sin):
        x = x + self.attn.train_forward(self.attention_norm(x), cos, sin)
        return x + self.mlp(self.ffn_norm(x))


@dataclasses.dataclass
class SlotCache:
    """The serving engine's ring KV cache: two preallocated tensors
    [layers, slots, capacity, kv_heads, head_dim] in the compute dtype, updated
    in place by `prefill_slot` and `decode_slots`."""

    k: torch.Tensor
    v: torch.Tensor

    @property
    def capacity(self) -> int:
        return int(self.k.shape[2])

    @property
    def nbytes(self) -> int:
        return self.k.numel() * self.k.element_size() + self.v.numel() * self.v.element_size()


@dataclasses.dataclass
class DecodeCache:
    """The interactive batch-first KV cache of `decode_step` (JAX
    `init_decode_cache`, gpt2_model.py:1272-1279): a ring of one row per batch
    row and `index`, the positions written so far (the same for every row)."""

    slots: SlotCache
    index: int = 0

    @property
    def capacity(self) -> int:
        return self.slots.capacity


@dataclasses.dataclass
class PagedCache:
    """The serving engine's paged KV cache (JAX `init_paged_cache`,
    gpt2_model.py:1385-1409): ONE block pool per layer, [layers, num_blocks +
    1, block_size, kv_heads, head_dim], in the compute dtype, or int8 with
    float32 scale pools [layers, num_blocks + 1, block_size, kv_heads, 1]
    beside them (one scale per written row and kv head: quantized on write,
    dequantized at the gather). Block `num_blocks` is scratch: the write
    coordinates of a cell that writes nowhere (an idle slot, a padded
    prefill cell, a verify column past the budget) point there, as the JAX
    scatter's `mode="drop"` drops them, and no table ever gathers it."""

    k: torch.Tensor
    v: torch.Tensor
    k_scale: Optional[torch.Tensor] = None
    v_scale: Optional[torch.Tensor] = None

    @property
    def num_blocks(self) -> int:
        return int(self.k.shape[1]) - 1

    @property
    def block_size(self) -> int:
        return int(self.k.shape[2])

    @property
    def kv_quant(self) -> str:
        return "int8" if self.k_scale is not None else "none"

    def _tensors(self) -> list[torch.Tensor]:
        return [t for t in (self.k, self.v, self.k_scale, self.v_scale) if t is not None]

    @property
    def nbytes(self) -> int:
        """Bytes of the num_blocks blocks (pools and scales; the scratch block
        left out): the JAX engine's `kv_pool_bytes`."""
        return sum(t[:, : self.num_blocks].numel() * t.element_size() for t in self._tensors())

    @property
    def scale_bytes(self) -> int:
        return sum(t[:, : self.num_blocks].numel() * 4 for t in (self.k_scale, self.v_scale) if t is not None)

    def copy_block(self, src: int, dst: int) -> None:
        """Copy-on-write's device row copy: block `src` -> `dst` in every
        layer's pools and scales (JAX engine `cow_fn`, engine.py:975-986)."""
        for t in self._tensors():
            t[:, dst] = t[:, src]

    def write_and_gather(self, layer: int, k, v, step):
        """Scatter this step's k/v [R, C, Hkv, D] into layer `layer`'s pool at
        the step's (block, offset) coordinates, ALL rows before any gather (so
        the rows of one packed dispatch see each other's writes), then gather
        each row's K/V through its block table, position-ordered: [R,
        table_width * block_size, Hkv, D] in k's dtype. V rows that no query
        of the row references are zeroed: a recycled block keeps its last
        owner's bytes, and 0 x NaN would poison P.V (masked K logits are
        replaced, not added to, inside `masked_attention`)."""
        hkv, d = k.shape[-2], k.shape[-1]
        k_flat, v_flat = k.reshape(-1, hkv, d), v.reshape(-1, hkv, d)
        blk, off = step.wblk, step.woff
        k_pool, v_pool = self.k[layer], self.v[layer]
        if self.k_scale is not None:
            k_flat, k_s = quantize_per_channel(k_flat, dim=-1)
            v_flat, v_s = quantize_per_channel(v_flat, dim=-1)
            ks_pool, vs_pool = self.k_scale[layer], self.v_scale[layer]
            ks_pool[blk, off] = k_s
            vs_pool[blk, off] = v_s
        k_pool[blk, off] = k_flat
        v_pool[blk, off] = v_flat
        rows, width = step.tables.shape

        def gather(pool):
            return pool[step.tables].reshape(rows, width * self.block_size, hkv, pool.shape[-1])

        if self.k_scale is not None:
            k_all = (gather(k_pool).float() * gather(ks_pool)).to(k.dtype)
            v_all = (gather(v_pool).float() * gather(vs_pool)).to(v.dtype)
        else:
            k_all, v_all = gather(k_pool), gather(v_pool)
        return k_all, v_all.masked_fill(~step.valid[:, :, None, None], 0)


@dataclasses.dataclass
class _Step:
    """What every layer of one forward shares: RoPE rows, the attention mask,
    and where the new K/V land (ring: slot+start for prefill, positions for
    decode; paged: the block tables, the flat write coordinates and the key
    rows any query references)."""

    mask: torch.Tensor
    cos: Optional[torch.Tensor]
    sin: Optional[torch.Tensor]
    slot: Optional[int] = None
    start: int = 0
    positions: Optional[torch.Tensor] = None
    tables: Optional[torch.Tensor] = None
    wblk: Optional[torch.Tensor] = None
    woff: Optional[torch.Tensor] = None
    valid: Optional[torch.Tensor] = None


class GPT2Module(nn.Module):
    """wte (+wpe) -> blocks -> lm_head_norm -> fp32 head: the full-sequence
    training forward (`forward`) and the serving API over the ring cache and
    the paged block pool."""

    def __init__(self, spec: GPT2ModelSpec, device=None):
        super().__init__()
        check_kernel_switches()  # the JAX RMSNorm and dequant-matmul tier switches (ops/tiers.py)
        self.spec = spec
        self.wte = nn.Parameter(torch.empty(spec.vocab_size, spec.n_embd, device=device))
        if spec.poe_type == PositionTypes.ABSOLUTE.value:
            self.wpe = nn.Parameter(torch.empty(spec.sequence_length, spec.n_embd, device=device))
        self.blocks = nn.ModuleList(GPT2Block(spec, device=device) for _ in range(spec.n_layer))
        self.lm_head_norm = build_norm(spec.lm_head_norm, device=device)
        if not spec.use_weight_tying:
            self.lm_head = _dense(spec, spec.n_embd, spec.vocab_size, False, device)
        self._rope: dict = {}
        self.cp_group = None
        self.tp = None  # parallel/tensor_parallel.TensorParallel under tensor parallelism

    def set_context_parallel(self, group) -> "GPT2Module":
        """Train on this rank's chunk of each sequence, with attention over the
        cp ring `group` (None: the whole sequence on this rank)."""
        self.cp_group = group
        for block in self.blocks:
            block.attn.cp_group = group
        return self

    def set_tensor_parallel(self, tp) -> "GPT2Module":
        """Run the vocab-parallel lookup and head over `tp`
        (parallel/tensor_parallel.TensorParallel), or unsharded (None)."""
        self.tp = tp
        return self

    @property
    def compute_dtype(self) -> torch.dtype:
        return getattr(torch, self.spec.compute_dtype)

    @property
    def device(self) -> torch.device:
        return next(self.parameters()).device

    def cast_dense_(self) -> "GPT2Module":
        """Cast the blocks' dense kernels (and biases) to the compute dtype once;
        the head keeps fp32 (the JAX head computes in fp32)."""
        for block in self.blocks:
            for m in block.modules():
                if isinstance(m, (Linear, QuantLinear)):
                    m.cast_(self.compute_dtype)
        return self

    def _rope_tables(self, capacity: int):
        key = (capacity, self.device)
        if key not in self._rope:
            hd = self.spec.head_dim
            cos, sin = rope_tables(hd, capacity, self.spec.rope_base_freq, dtype=self.compute_dtype)
            self._rope[key] = (cos.to(self.device), sin.to(self.device))
        return self._rope[key]

    # ------------------------------------------------------------- training
    def forward(self, input_ids):
        """The full-sequence forward of the JAX `GPT2Module.__call__`
        (gpt2_model.py:977-1121): input_ids [B, S] -> logits [B, S, V] fp32,
        RoPE over positions [0, S), blocks in the compute dtype, the head in
        fp32."""
        return self.head_logits(self._hidden(input_ids))

    def forward_hidden(self, input_ids):
        """The backbone through `lm_head_norm` (JAX `apply_hidden`,
        gpt2_model.py:1243-1251): input_ids [B, S] -> [B, S, E] in the norm's
        output dtype. Blocks the remat variant picks run under checkpoint.
        Under context parallelism input_ids is this rank's chunk, at global
        offset cp_rank * S (JAX `cp_shard_offset`, gpt2_model.py:516-520,
        :1495-1496)."""
        return self._hidden(input_ids)

    def _hidden(self, input_ids):
        return self.lm_head_norm(self._blocks(input_ids, None, 0, self.spec.n_layer))

    def stage_forward(self, input_ids, x, first: int, count: int, head=None):
        """Blocks [first, first + count) of the training forward (a pipeline
        stage's layers, parallel/pipeline.py): over the embeddings of
        input_ids when x is None, else over x, the previous stage's output
        (this rank's rows of the sequence under tensor parallelism).
        input_ids [B, S] give the positions (this rank's chunk under cp).
        Blocks are named by their global index, so a stage that holds only
        some of them finds each in `blocks`. With `head` (the last stage):
        returns head(self, lm_head_norm(blocks' output)), computed inside this
        call, so that under FSDP2 the head reads gathered parameters."""
        x = self._blocks(input_ids, x, first, count)
        return x if head is None else head(self, self.lm_head_norm(x))

    def _blocks(self, input_ids, x, first: int, count: int):
        """`stage_forward`'s body (an FSDP2 forward method must not call
        another: `forward_hidden` calls this)."""
        spec = self.spec
        if spec.dropout > 0.0 and self.cp_group is not None:
            raise NotImplementedError(
                "attention-probability dropout (dropout > 0) is not implemented for ring attention (context "
                "parallelism): the ring merges per-chunk softmax statistics that dropout would invalidate. Set "
                "dropout: 0.0 or run without a cp mesh axis."
            )
        if spec.dropout > 0.0:
            raise NotImplementedError(
                "dropout > 0 in the training forward is not ported yet (ROADMAP.md, Queue 1 item 7); "
                "set dropout: 0.0"
            )
        s = input_ids.shape[1]
        offset = 0 if self.cp_group is None else self.cp_group.rank() * s
        if x is None:
            x = self._train_embed(input_ids, offset)
        cos = sin = None
        if spec.use_rope:
            cos, sin = self._rope_tables(offset + s)
            cos, sin = cos[offset:], sin[offset:]
        for i in range(first, first + count):
            block = self.blocks.get_submodule(str(i))
            if layer_remats(spec.remat_variant, spec.remat_freq, i):
                x = checkpointed(block.train_forward, x, cos, sin)
            else:
                x = block.train_forward(x, cos, sin)
        return x

    def _train_embed(self, input_ids, offset: int):
        if self.tp is None:
            x, start = F.embedding(input_ids, self.wte).to(self.compute_dtype), offset
        else:  # this rank's rows of the sequence (SP) from the vocab-parallel lookup
            x = vocab_parallel_embedding(input_ids, local(self.wte), self.tp.group).to(self.compute_dtype)
            start = offset + self.tp.group.rank() * x.shape[1]
        if self.spec.poe_type == PositionTypes.ABSOLUTE.value:
            x = x + local(self.wpe)[start:start + x.shape[1]].to(self.compute_dtype)
        return x

    def head_logits(self, hidden):
        """fp32 vocab logits of post-`lm_head_norm` hidden states [..., E]
        (JAX `head_project`, gpt2_model.py:899-914). Under tensor parallelism
        this rank's vocab columns [..., V / tp] under loss parallelism, else
        gathered."""
        h = hidden.float()
        if self.spec.use_weight_tying:
            logits = torch.matmul(h, local(self.wte).float().t())
        else:
            logits = self.lm_head(h)
        if self.tp is not None and not self.tp.loss_parallel:
            logits = gather_vocab(logits, self.tp.group)
        return logits

    def head_weight(self):
        """The [V, E] head projection: the tied `wte`, or the lm_head kernel
        transposed (JAX `head_weight`, gpt2_model.py:1259-1269); this rank's
        [V / tp, E] rows under tensor parallelism."""
        if self.spec.use_weight_tying:
            return local(self.wte)
        return local(self.lm_head.kernel).t()

    # ----------------------------------------------------------- slot cache API
    def init_slot_cache(self, max_batch_slots: int, cache_capacity: Optional[int] = None) -> SlotCache:
        """Zeroed ring KV cache of `max_batch_slots` rows of `cache_capacity`."""
        spec = self.spec
        cap = spec.sequence_length if cache_capacity is None else int(cache_capacity)
        if cap > spec.sequence_length and spec.poe_type == PositionTypes.ABSOLUTE.value:
            raise ValueError(
                f"cache_capacity {cap} exceeds sequence_length {spec.sequence_length}: ABSOLUTE "
                "position embeddings have no rows past the trained sequence length"
            )
        shape = (spec.n_layer, int(max_batch_slots), cap, spec.n_head_kv, spec.head_dim)
        return SlotCache(
            k=torch.zeros(shape, dtype=self.compute_dtype, device=self.device),
            v=torch.zeros(shape, dtype=self.compute_dtype, device=self.device),
        )

    def prefill_slot(self, cache: SlotCache, tokens, slot: int, start_pos: int):
        """Forward a [1, C] prompt chunk, writing its K/V into cache row `slot`
        at positions start_pos..start_pos+C-1 (in place). Returns logits
        [1, C, V] in fp32."""
        c = tokens.shape[1]
        cap = cache.capacity
        if not (0 <= start_pos and start_pos + c <= cap):
            raise ValueError(f"prefill chunk [{start_pos}, {start_pos + c}) outside the ring of {cap}")
        key_pos = torch.arange(cap, device=self.device)
        mask = key_pos[None, :] <= (start_pos + torch.arange(c, device=self.device))[:, None]
        cos = sin = None
        if self.spec.use_rope:
            cos_t, sin_t = self._rope_tables(cap)
            cos, sin = cos_t[start_pos : start_pos + c], sin_t[start_pos : start_pos + c]
        step = _Step(mask=mask, cos=cos, sin=sin, slot=int(slot), start=int(start_pos))
        x = self._embed(tokens, torch.arange(start_pos, start_pos + c, device=self.device)[None])
        return self._forward(x, cache, step)

    def decode_slots(self, cache: SlotCache, tokens, positions):
        """ONE batched decode step: tokens [slots, 1] written at per-slot
        `positions` [slots] (an int64 tensor on the module's device, each in
        [0, capacity)). Returns logits [slots, 1, V] in fp32."""
        cap = cache.capacity
        mask = torch.arange(cap, device=self.device)[None, None, :] <= positions[:, None, None]
        cos = sin = None
        if self.spec.use_rope:
            cos_t, sin_t = self._rope_tables(cap)
            cos, sin = cos_t[positions][:, None, :], sin_t[positions][:, None, :]
        step = _Step(mask=mask, cos=cos, sin=sin, positions=positions)
        x = self._embed(tokens, positions[:, None])
        return self._forward(x, cache, step)

    # --------------------------------------------------- interactive decode
    def init_decode_cache(self, batch_size: int) -> DecodeCache:
        """Zeroed KV caches of `sequence_length` positions for `batch_size`
        rows, and the position counter at 0 (JAX `init_decode_cache`)."""
        return DecodeCache(self.init_slot_cache(batch_size))

    def decode_step(self, cache: DecodeCache, tokens):
        """One cached autoregressive step (JAX `decode_step`,
        gpt2_model.py:1281-1292): tokens [B, S_in] are the NEW positions only
        (S_in > 1 prefills the prompt), written at the cache's counter, which
        advances by S_in. Returns (logits [B, S_in, V] fp32, the cache)."""
        b, s = tokens.shape
        if cache.index + s > cache.capacity:
            raise ValueError(f"decode_step: {s} new positions at {cache.index} overflow the cache of "
                             f"{cache.capacity}")
        if s == 1:
            positions = torch.full((b,), cache.index, dtype=torch.int64, device=self.device)
            logits = self.decode_slots(cache.slots, tokens, positions)
        else:
            logits = torch.cat([self.prefill_slot(cache.slots, tokens[r:r + 1], r, cache.index) for r in range(b)])
        cache.index += s
        return logits, cache

    def _embed(self, tokens, pos):
        x = self.wte[tokens].to(self.compute_dtype)
        if self.spec.poe_type == PositionTypes.ABSOLUTE.value:
            x = x + self.wpe[pos].to(self.compute_dtype)
        return x

    # ------------------------------------------------------- paged cache API
    def init_paged_cache(self, num_blocks: int, block_size: int, kv_quant: str = "none") -> PagedCache:
        """Zeroed block pool of `num_blocks` blocks of `block_size` positions
        (plus the scratch block), in the compute dtype, or int8 with float32
        scale pools for kv_quant="int8"."""
        nb, bs = int(num_blocks), int(block_size)
        if nb < 1 or bs < 1:
            raise ValueError(f"paged cache needs num_blocks >= 1 and block_size >= 1, got {nb}/{bs}")
        if kv_quant not in ("none", "int8"):
            raise ValueError(f"unknown kv_quant {kv_quant!r} (expected none|int8)")
        spec = self.spec
        shape = (spec.n_layer, nb + 1, bs, spec.n_head_kv, spec.head_dim)
        dtype = torch.int8 if kv_quant == "int8" else self.compute_dtype
        cache = PagedCache(k=torch.zeros(shape, dtype=dtype, device=self.device),
                           v=torch.zeros(shape, dtype=dtype, device=self.device))
        if kv_quant == "int8":
            cache.k_scale = torch.zeros(shape[:-1] + (1,), device=self.device)
            cache.v_scale = torch.zeros(shape[:-1] + (1,), device=self.device)
        return cache

    def prefill_paged(self, cache: PagedCache, tokens, positions, tables, wblk, woff):
        """Cross-request packed prefill (JAX `prefill_paged`,
        gpt2_model.py:1411-1428): row r of `tokens` [R, C] is a chunk of some
        request at absolute positions `positions` [R, C], gathered through the
        row's block table `tables` [R, MB], its K/V written at wblk/woff [R, C]
        (block `cache.num_blocks` writes nowhere). All int64 tensors on the
        module's device. Returns logits [R, C, V] in fp32."""
        return self._paged_forward(cache, tokens, positions, tables, wblk.reshape(-1), woff.reshape(-1))

    def decode_paged(self, cache: PagedCache, tokens, positions, tables, wblk, woff):
        """ONE batched paged decode step (JAX `decode_paged`,
        gpt2_model.py:1430-1446): tokens [S, 1] at per-slot `positions` [S],
        K/V through the tables [S, MB], written at wblk/woff [S]. Returns
        logits [S, 1, V] in fp32."""
        return self._paged_forward(cache, tokens, positions[:, None], tables, wblk, woff)

    def verify_paged(self, cache: PagedCache, tokens, positions, tables, wblk, woff):
        """The speculative-decoding verify forward (JAX `verify_paged`,
        gpt2_model.py:1448-1461): row s of `tokens` [S, k+1] is the fed token
        and the drafts at positions [S, k+1]; the packed prefill's math, so a
        draft column attends exactly the K/V a sequential decode at that
        position would."""
        return self.prefill_paged(cache, tokens, positions, tables, wblk, woff)

    def _paged_forward(self, cache: PagedCache, tokens, pos, tables, wblk, woff):
        width = int(tables.shape[1]) * cache.block_size
        key_pos = torch.arange(width, device=self.device)
        mask = key_pos[None, None, :] <= pos[:, :, None]  # [R, C, L]
        # a verify column past the table ceiling (drafts beyond the budget,
        # never emitted, their writes dropped) reads its tables at the last
        # row and references no key rows for the V scrub
        limit = width if self.spec.poe_type != PositionTypes.ABSOLUTE.value else min(width, self.wpe.shape[0])
        inside = pos < limit
        lookup = pos.clamp(max=limit - 1)
        cos = sin = None
        if self.spec.use_rope:  # tables at the table ceiling, which may pass sequence_length
            cos_t, sin_t = self._rope_tables(width)
            cos, sin = cos_t[lookup], sin_t[lookup]
        valid = (mask & inside[:, :, None]).any(dim=1)
        step = _Step(mask=mask, cos=cos, sin=sin, tables=tables, wblk=wblk, woff=woff, valid=valid)
        return self._forward(self._embed(tokens, lookup), cache, step)

    def _forward(self, x, cache, step: _Step):
        if self.tp is not None:
            raise NotImplementedError("serving a tensor-parallel module is not ported yet (ROADMAP.md, Queue 1 "
                                      "item 3)")
        for i, block in enumerate(self.blocks):
            x = block(x, cache, i, step)
        h = self.lm_head_norm(x).float()
        if self.spec.use_weight_tying:
            return torch.matmul(h, self.wte.float().t())
        return self.lm_head(h)


# ------------------------------------------------------------- the model


@dataclasses.dataclass
class MixedPrecisionSpec:
    """The `fsdp2_wrapped` mixed-precision policy (JAX models/model.py:35-38)."""

    param_dtype: str = "float32"
    compute_dtype: str = "bfloat16"
    reduce_dtype: str = "float32"


@dataclasses.dataclass
class FSDPSpec:
    """The `fsdp2_wrapped` variant's sharding knobs (parallel/fsdp.py)."""

    layers_per_fsdp_unit: Optional[int] = None
    reshard_after_forward: bool = True


@dataclasses.dataclass
class TrainSpec:
    """Model-transform descriptors recorded by the registry's model variants and
    applied when the train step is built (JAX models/model.py:41-49)."""

    mixed_precision: MixedPrecisionSpec = dataclasses.field(default_factory=MixedPrecisionSpec)
    init_routines: tuple = ()
    fsdp: FSDPSpec = dataclasses.field(default_factory=FSDPSpec)


# weight-decay groups, the JAX model's regexes (gpt2_model.py:1158-1164); they
# match the port's state-dict names (`blocks.0.attn.q_attn.kernel`) as they
# match the flax paths
WEIGHT_DECAY_GROUPS = {
    "linear": [r".*(q_attn|k_attn|v_attn|c_proj|c_fc|W|V|W_2|lm_head).*kernel.*"],
    "embedding": [r".*(wte|wpe).*"],
    "layernorm": [r".*(norm).*"],
}


def _is_norm_param(name: str) -> bool:
    return re.search(r"norm\.(scale|bias)$", name) is not None


class GPT2LLM:
    """Framework-level GPT2 (the registry's `model.gpt2`): the static spec plus
    parameter creation and module building. Holds no tensors itself."""

    weight_decay_groups = WEIGHT_DECAY_GROUPS

    def __init__(self, **config):
        cfg = validate_config(GPT2LLMConfig, config)
        self.sample_key = cfg.sample_key
        self.prediction_key = cfg.prediction_key
        self.seed = cfg.seed if cfg.seed is not None else 42  # the JAX NNModel default
        self.train_spec = TrainSpec()
        if cfg.n_embd % cfg.n_head_q != 0:
            raise ValueError("n_embd must be divisible by n_head_q")
        rope = [
            t for t in cfg.attention_config.qkv_transforms
            if t.type_hint == QueryKeyValueTransformType.RotaryTransform.value
        ]
        qk_norm_cfg = cfg.attention_config.qk_norm_config
        self.config_spec = GPT2ModelSpec(
            vocab_size=cfg.vocab_size,
            sequence_length=cfg.sequence_length,
            n_layer=cfg.n_layer,
            n_head_q=cfg.n_head_q,
            n_head_kv=cfg.n_head_kv,
            n_embd=cfg.n_embd,
            ffn_hidden=cfg.ffn_hidden,
            bias=cfg.bias,
            poe_type=cfg.poe_type,
            activation=cfg.activation_type,
            use_rope=bool(rope),
            rope_base_freq=rope[-1].config.base_freq if rope else 10000,
            use_weight_tying=cfg.use_weight_tying,
            swiglu_hidden=swiglu_hidden_dim(cfg.ffn_hidden, cfg.enforce_swiglu_hidden_dim_multiple_of),
            attn_norm=NormSpec.from_wrapper_config(cfg.attention_norm_config, cfg.n_embd),
            ffn_norm=NormSpec.from_wrapper_config(cfg.ffn_norm_config, cfg.n_embd),
            lm_head_norm=NormSpec.from_wrapper_config(cfg.lm_head_norm_config, cfg.n_embd),
            qk_norm=(
                NormSpec.from_wrapper_config(qk_norm_cfg, cfg.n_embd // cfg.n_head_q)
                if qk_norm_cfg is not None
                else None
            ),
            attention_impl=cfg.attention_implementation,
            dropout=cfg.dropout,
            lm_head_chunk_size=cfg.lm_head_chunk_size,
            lm_head_fused_ce=cfg.lm_head_fused_ce,
        )

    def with_spec_updates(self, **changes) -> "GPT2LLM":
        """Rebuild with updated static spec fields (compute dtype, quant mode)."""
        self.config_spec = dataclasses.replace(self.config_spec, **changes)
        return self

    def init_params(self, generator: torch.Generator) -> dict[str, torch.Tensor]:
        """Fresh fp32 parameters drawn from `generator`, on its device: normal(0.02)
        embeddings and dense kernels, ones for norm scales, zeros for biases (the
        JAX initializers). Keys are `GPT2Module.state_dict()`'s."""
        device = generator.device
        spec = dataclasses.replace(self.config_spec, quant_weights="none")
        shapes = {k: v.shape for k, v in GPT2Module(spec, device="meta").state_dict().items()}
        params = {}
        for name, shape in shapes.items():
            leaf = name.rsplit(".", 1)[-1]
            if leaf == "scale":
                params[name] = torch.ones(shape, device=device)
            elif leaf == "bias":
                params[name] = torch.zeros(shape, device=device)
            else:
                params[name] = torch.empty(shape, device=device).normal_(0.0, 0.02, generator=generator)
        return params

    def num_parameters(self) -> int:
        return sum(v.numel() for v in GPT2Module(self.config_spec, device="meta").state_dict().values())

    def update_train_spec(self, **changes) -> "GPT2LLM":
        self.train_spec = dataclasses.replace(self.train_spec, **changes)
        return self

    def init_train_params(self, generator: torch.Generator) -> dict[str, torch.Tensor]:
        """Training parameters drawn from `generator`, on its device: the
        default initializers (`init_params`), drawn instead by the last
        recorded init routine (the `model_initialized` variant) that targets
        the parameter, then stored in the spec's `param_dtype` except the norm
        parameters, which stay fp32 as flax leaves them. Drawn whole, one
        tensor at a time, so only one fp32 tensor is alive beside the stored
        ones and no value depends on how the parameters are sharded later."""
        spec = self.config_spec
        device = generator.device
        dtype = getattr(torch, spec.param_dtype)
        shapes = {k: v.shape for k, v in GPT2Module(spec, device="meta").state_dict().items()}
        routines = self.train_spec.init_routines
        for routine in routines:
            routine.validate(list(shapes))
        params = {}
        for name, shape in shapes.items():
            leaf = name.rsplit(".", 1)[-1]
            targeting = [r for r in routines if r.targets(name)]
            if targeting:
                t = targeting[-1].draw(name, shape, generator)
            elif leaf == "scale":
                t = torch.ones(shape, device=device)
            elif leaf == "bias":
                t = torch.zeros(shape, device=device)
            else:
                t = torch.empty(shape, device=device).normal_(0.0, 0.02, generator=generator)
            params[name] = t if _is_norm_param(name) else t.to(dtype)
        return params

    def build_train_module(self, params: dict[str, torch.Tensor]) -> GPT2Module:
        """The training module over `params` (adopted as its parameters, on
        their device, in their dtypes), in train mode."""
        module = GPT2Module(self.config_spec, device="meta")
        module.load_state_dict(params, strict=True, assign=True)
        return module.train()

    def build_module(self, params: dict[str, torch.Tensor]) -> GPT2Module:
        """The serving module over `params` (fp32, or a quantize_params tree for
        a quantized spec), on the params' device, dense kernels in the compute
        dtype. The params' tensors are adopted, not copied, where no cast is
        needed."""
        module = GPT2Module(self.config_spec, device="meta")
        module.load_state_dict(params, strict=True, assign=True)
        return module.cast_dense_().eval()

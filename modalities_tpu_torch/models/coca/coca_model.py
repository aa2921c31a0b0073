"""CoCa, the Contrastive Captioner: the port of
modalities_tpu/models/coca/coca_model.py (paper arXiv:2205.01917).

A ViT encoder (models/vision_transformer, encoder mode) -> attention pooling
with learned queries (`n_vision_queries` for the cross-attention, and one
more as the contrastive vision cls token); the unimodal text decoder (causal,
its cls token appended at position `block_size`, no final norm); the
multimodal decoder, causal with cross-attention over the pooled vision
tokens, `mm_ln_f`, and the fp32 head tied to `wte`. Every attention runs
through the flash kernels (nn/attention.py). The module takes the samples
dict (images [B, H, W, C] float, NHWC; token ids [B, S]) and returns the
predictions dict: logits [B, S, V] fp32, the vision cls and the text cls
[B, E].

`CoCaCollateFn` stacks the samples and shifts the text for the causal LM
(inputs text[:, :-1], targets text[:, 1:]).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from modalities_tpu_torch.config.config import check_bool, check_float, check_int, check_str, validate_config
from modalities_tpu_torch.dataloader.dataloader import DatasetBatch
from modalities_tpu_torch.models.components.layer_norms import InputDtypeLayerNorm
from modalities_tpu_torch.models.model import NNModel
from modalities_tpu_torch.models.vision_transformer.vision_transformer_model import (
    VisionTransformer,
    VisionTransformerConfig,
    VisionTransformerModule,
)
from modalities_tpu_torch.nn.attention import AttentionType, MultiHeadAttention, refuse_dropout
from modalities_tpu_torch.nn.mlp import MLP

_WEIGHT_DECAY_GROUPS = {  # the JAX model's regexes over flax paths (models/model.py:jax_param_path)
    "linear": [r".*(attn|mlp)/.*kernel.*"],
    "embedding": [r".*(wte|wpe|vision_queries|cls_token|embedding_fn).*"],
    "norm": [r".*(ln_|norm).*"],
}


@dataclasses.dataclass
class TextDecoderConfig:
    sample_key: str
    prediction_key: str
    block_size: int
    vocab_size: int
    n_layer_text: int
    n_layer_multimodal_text: int
    n_head: int
    n_embd: int
    ffn_hidden: int
    dropout: float
    bias: bool
    attention_config: Optional[dict] = None
    activation: str = "gelu"
    epsilon: float = 1e-5

    def __post_init__(self):
        check_str("sample_key", self.sample_key)
        check_str("prediction_key", self.prediction_key)
        for name in ("block_size", "vocab_size", "n_layer_text", "n_layer_multimodal_text", "n_head", "n_embd",
                     "ffn_hidden"):
            check_int(name, getattr(self, name), ge=1)
        self.dropout = check_float("dropout", self.dropout, ge=0.0)
        check_bool("bias", self.bias)
        check_str("activation", self.activation)
        self.epsilon = check_float("epsilon", self.epsilon, ge=0.0)


@dataclasses.dataclass
class CoCaConfig:
    vision_embd_prediction_key: str
    text_embd_prediction_key: str
    vision_cls_prediction_key: str
    text_cls_prediction_key: str
    vision_encoder_config: Any
    text_decoder_config: Any
    n_pool_head: int
    n_vision_queries: int
    bias_attn_pool: bool
    epsilon_attn_pool: float
    prediction_key: str = "logits"

    def __post_init__(self):
        for name in ("prediction_key", "vision_embd_prediction_key", "text_embd_prediction_key",
                     "vision_cls_prediction_key", "text_cls_prediction_key"):
            check_str(name, getattr(self, name))
        if isinstance(self.vision_encoder_config, dict):
            self.vision_encoder_config = validate_config(VisionTransformerConfig, self.vision_encoder_config)
        if isinstance(self.text_decoder_config, dict):
            self.text_decoder_config = validate_config(TextDecoderConfig, self.text_decoder_config)
        check_int("n_pool_head", self.n_pool_head, ge=1)
        check_int("n_vision_queries", self.n_vision_queries, ge=1)
        check_bool("bias_attn_pool", self.bias_attn_pool)
        self.epsilon_attn_pool = check_float("epsilon_attn_pool", self.epsilon_attn_pool, ge=0.0)


class AttentionPooling(nn.Module):
    """Learned-query cross-attention pooling (JAX :63-88): `ln_1` normalizes
    the context (the queries enter raw), `ln_2` the pooled output; the
    attention always carries bias, `bias` governs only the two norms."""

    def __init__(self, n_embd: int, n_head: int, bias: bool, epsilon: float, device=None):
        super().__init__()
        self.ln_1 = InputDtypeLayerNorm(n_embd, epsilon, True, bias, device=device)
        self.attn = MultiHeadAttention(n_embd, n_head, True, attention_type=AttentionType.CROSS_ATTENTION,
                                       device=device)
        self.ln_2 = InputDtypeLayerNorm(n_embd, epsilon, True, bias, device=device)

    def forward(self, queries, context):
        return self.ln_2(self.attn(queries, context=self.ln_1(context)))


class DecoderBlock(nn.Module):
    """A causal text block (JAX `_DecoderBlock`, :91-123), with
    cross-attention over `context` between its attention and its MLP when
    `with_cross_attention` (the multimodal blocks; `context_features` the
    vision width)."""

    def __init__(self, n_embd: int, n_head: int, ffn_hidden: int, bias: bool, dropout: float, epsilon: float,
                 with_cross_attention: bool = False, context_features: Optional[int] = None, device=None):
        super().__init__()
        self.ln_1 = InputDtypeLayerNorm(n_embd, epsilon, True, bias, device=device)
        self.attn = MultiHeadAttention(n_embd, n_head, bias, dropout, AttentionType.CAUSAL_SELF_ATTENTION,
                                       device=device)
        if with_cross_attention:
            self.ln_cross = InputDtypeLayerNorm(n_embd, epsilon, True, bias, device=device)
            self.cross_attn = MultiHeadAttention(n_embd, n_head, bias, dropout, AttentionType.CROSS_ATTENTION,
                                                 context_features=context_features, device=device)
        self.ln_2 = InputDtypeLayerNorm(n_embd, epsilon, True, bias, device=device)
        self.mlp = MLP(n_embd, ffn_hidden, bias=bias, dropout=dropout, device=device)

    def forward(self, x, context=None):
        x = x + self.attn(self.ln_1(x))
        if hasattr(self, "cross_attn"):
            x = x + self.cross_attn(self.ln_cross(x), context=context)
        return x + self.mlp(self.ln_2(x))


class CoCaModule(nn.Module):
    """The module of `CoCa` (JAX `_CoCaModule`, :126-179)."""

    def __init__(self, model: "CoCa", device=None):
        super().__init__()
        td, e_vision = model.text_decoder, model.vision_spec["n_embd"]
        self.sample_key, self.vision_sample_key = model.sample_key, model.vision_sample_key
        self.keys = (model.prediction_key, model.vision_cls_prediction_key, model.text_cls_prediction_key)
        self.dropout = td.dropout
        self.vision_encoder = VisionTransformerModule(model.vision_spec, device=device)
        self.vision_queries = nn.Parameter(torch.empty(model.n_vision_queries + 1, e_vision, device=device))
        self.attn_pool = AttentionPooling(e_vision, model.n_pool_head, model.bias_attn_pool,
                                          model.epsilon_attn_pool, device=device)
        self.wte = nn.Parameter(torch.empty(td.vocab_size, td.n_embd, device=device))
        self.wpe = nn.Parameter(torch.empty(td.block_size + 1, td.n_embd, device=device))
        self.text_cls_token = nn.Parameter(torch.empty(1, 1, td.n_embd, device=device))
        block = dict(n_embd=td.n_embd, n_head=td.n_head, ffn_hidden=td.ffn_hidden, bias=td.bias, dropout=td.dropout,
                     epsilon=td.epsilon, device=device)
        self.text_block = nn.ModuleList(DecoderBlock(**block) for _ in range(td.n_layer_text))
        self.multimodal_block = nn.ModuleList(
            DecoderBlock(**block, with_cross_attention=True, context_features=e_vision)
            for _ in range(td.n_layer_multimodal_text))
        self.mm_ln_f = InputDtypeLayerNorm(td.n_embd, td.epsilon, True, td.bias, device=device)

    @property
    def blocks(self) -> list[nn.Module]:
        """The three block stacks (FSDP2's units, parallel/fsdp.py)."""
        return [*self.vision_encoder.blocks, *self.text_block, *self.multimodal_block]

    def forward(self, samples: dict) -> dict:
        if self.training:
            refuse_dropout(self.dropout)
        dtype = self.wte.dtype
        images, text_ids = samples[self.vision_sample_key].to(dtype), samples[self.sample_key]
        b = text_ids.shape[0]
        # the vision encoder and the attention pooling
        vision_embd = self.vision_encoder(images)
        queries = self.vision_queries.to(vision_embd.dtype).expand(b, *self.vision_queries.shape)
        pooled = self.attn_pool(queries, vision_embd)
        vision_context, vision_cls = pooled[:, :-1], pooled[:, -1].contiguous()
        # the unimodal text decoder: the cls token appended, block_size + 1 positions, no final norm
        x = F.embedding(text_ids.long(), self.wte)
        x = torch.cat([x, self.text_cls_token.expand(b, 1, x.shape[-1])], dim=1)
        x = x + self.wpe[:x.shape[1]]
        for block in self.text_block:
            x = block(x)
        text_embd, text_cls = x[:, :-1], x[:, -1].contiguous()
        # the multimodal decoder over the pooled vision tokens, its norm, the fp32 head tied to wte
        y = text_embd
        for block in self.multimodal_block:
            y = block(y, context=vision_context)
        y = self.mm_ln_f(y)
        logits = torch.matmul(y.float(), self.wte.float().t())
        return dict(zip(self.keys, (logits, vision_cls, text_cls)))


class CoCa(NNModel):
    """The registry's `model.coca` (JAX :182-259)."""

    _EMBEDDINGS = {"vision_queries": 1.0, "wte": 0.02, "wpe": 0.02, "text_cls_token": 0.02, "cls_token": 0.0,
                   "positional_embedding": 0.02}

    def __init__(self, prediction_key: str, vision_cls_prediction_key: str, text_cls_prediction_key: str,
                 vision_embd_prediction_key: str, text_embd_prediction_key: str, n_vision_queries: int,
                 n_pool_head: int, bias_attn_pool: bool, epsilon_attn_pool: float, vision_encoder_config,
                 text_decoder_config, seed: Optional[int] = None):
        if isinstance(vision_encoder_config, dict):
            vision_encoder_config = validate_config(VisionTransformerConfig, vision_encoder_config)
        if isinstance(text_decoder_config, dict):
            text_decoder_config = validate_config(TextDecoderConfig, text_decoder_config)
        super().__init__(text_decoder_config.sample_key, prediction_key, seed, _WEIGHT_DECAY_GROUPS)
        self.vision_cls_prediction_key = vision_cls_prediction_key
        self.text_cls_prediction_key = text_cls_prediction_key
        self.vision_embd_prediction_key = vision_embd_prediction_key
        self.text_embd_prediction_key = text_embd_prediction_key
        self.vision_sample_key = vision_encoder_config.sample_key
        # the ViT's own spec (the ffn_hidden and block_size defaults), in encoder mode, as the JAX model composes it
        self.vision_spec = VisionTransformer(**{**dataclasses.asdict(vision_encoder_config), "n_classes": None}).spec
        self.text_decoder = text_decoder_config
        self.n_vision_queries, self.n_pool_head = n_vision_queries, n_pool_head
        self.bias_attn_pool, self.epsilon_attn_pool = bias_attn_pool, epsilon_attn_pool

    def _build(self, device) -> nn.Module:
        return CoCaModule(self, device=device)


@dataclasses.dataclass
class CoCaCollatorConfig:
    sample_keys: list
    target_keys: list
    text_sample_key: str
    text_target_key: str

    def __post_init__(self):
        for name in ("sample_keys", "target_keys"):
            value = getattr(self, name)
            if not isinstance(value, list) or not all(isinstance(k, str) for k in value):
                raise ValueError(f"{name}: expected a list of strings, got {value!r}")
        check_str("text_sample_key", self.text_sample_key)
        check_str("text_target_key", self.text_target_key)


class CoCaCollateFn:
    """(image, text) samples -> a DatasetBatch of numpy arrays, the text
    shifted for the causal LM (JAX :262-284)."""

    def __init__(self, sample_keys: list, target_keys: list, text_sample_key: str, text_target_key: str):
        self.sample_keys = sample_keys
        self.target_keys = target_keys
        self.text_sample_key = text_sample_key
        self.text_target_key = text_target_key

    def __call__(self, batch: list[dict]) -> DatasetBatch:
        samples = {key: np.stack([np.asarray(d[key]) for d in batch]) for key in self.sample_keys}
        targets = {key: np.stack([np.asarray(d[key]) for d in batch]) for key in self.target_keys}
        text = samples[self.text_sample_key]
        samples[self.text_sample_key] = text[:, :-1]
        targets[self.text_target_key] = text[:, 1:]
        return DatasetBatch(samples=samples, targets=targets)

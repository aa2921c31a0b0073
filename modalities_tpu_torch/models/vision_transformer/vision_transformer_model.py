"""Vision Transformer: the port of
modalities_tpu/models/vision_transformer/vision_transformer_model.py.

Images enter NHWC, the JAX package's layout (the reference's is NCHW). The
patch embedding is flax's strided `Conv` with VALID padding, its kernel kept
in flax's HWIO layout [ph, pw, C, E] and computed by `F.conv2d` (the images
and the kernel permuted to NCHW and OIHW).
Pre-norm blocks (attention always with bias, as in the reference; `bias`
governs the MLP), a learned positional embedding over the patches (and the
cls token), then either the classification path (pool, `norm`, `head`) or
the encoder's raw block output (CoCa's vision tower). Attention is
non-causal through the flash kernels (nn/attention.py).
"""

from __future__ import annotations

import dataclasses
import logging
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from modalities_tpu_torch.config.config import check_bool, check_float, check_int, check_str
from modalities_tpu_torch.models.components.layer_norms import InputDtypeLayerNorm
from modalities_tpu_torch.models.gpt2.gpt2_model import Linear
from modalities_tpu_torch.models.model import NNModel
from modalities_tpu_torch.nn.attention import AttentionType, MultiHeadAttention, refuse_dropout
from modalities_tpu_torch.nn.mlp import MLP

logger = logging.getLogger(__name__)

_WEIGHT_DECAY_GROUPS = {  # the JAX model's regexes over flax paths (models/model.py:jax_param_path)
    "linear": [r".*(attention|mlp|head)/.*kernel.*"],
    "embedding": [r".*(embedding_fn|cls_token).*"],
    "norm": [r".*(norm).*"],
}


def _img_size(value) -> tuple[int, int]:
    return (value, value) if isinstance(value, int) else tuple(value)


@dataclasses.dataclass
class VisionTransformerConfig:
    sample_key: str
    prediction_key: str
    img_size: int | tuple[int, int] | list = 224
    n_classes: Optional[int] = 1000
    n_layer: int = 12
    attention_config: Optional[dict] = None
    n_head: int = 8
    n_embd: int = 768
    dropout: float = 0.0
    patch_size: int = 16
    patch_stride: int = 16
    n_img_channels: int = 3
    add_cls_token: bool = True
    bias: bool = True
    ffn_hidden: Optional[int] = None  # unset: 3072 (see VisionTransformer)

    def __post_init__(self):
        check_str("sample_key", self.sample_key)
        check_str("prediction_key", self.prediction_key)
        if isinstance(self.img_size, (list, tuple)):
            if len(self.img_size) != 2:
                raise ValueError(f"img_size: an int or two ints, got {self.img_size!r}")
            self.img_size = tuple(check_int("img_size", v, ge=1) for v in self.img_size)
        else:
            check_int("img_size", self.img_size, ge=1)
        check_int("n_classes", self.n_classes, ge=1, optional=True)
        for name in ("n_layer", "n_head", "n_embd", "patch_size", "patch_stride", "n_img_channels"):
            check_int(name, getattr(self, name), ge=1)
        self.dropout = check_float("dropout", self.dropout, ge=0.0)
        check_bool("add_cls_token", self.add_cls_token)
        check_bool("bias", self.bias)
        check_int("ffn_hidden", self.ffn_hidden, ge=1, optional=True)


def get_block_size(img_size, patch_size: int, patch_stride: int, add_cls_token: bool) -> int:
    """Positions the encoder sees: the VALID conv's output grid, plus the cls token."""
    h, w = _img_size(img_size)
    return ((h - patch_size) // patch_stride + 1) * ((w - patch_size) // patch_stride + 1) + int(add_cls_token)


class _Conv(nn.Module):
    """flax `nn.Conv(padding="VALID")` over NHWC with its HWIO kernel."""

    def __init__(self, channels: int, features: int, size: int, stride: int, device=None):
        super().__init__()
        self.stride = stride
        self.kernel = nn.Parameter(torch.empty(size, size, channels, features, device=device))
        self.bias = nn.Parameter(torch.zeros(features, device=device))

    def forward(self, x):
        """x [B, H, W, C] -> [B, H', W', E] in x's dtype."""
        kernel, bias = self.kernel.to(x.dtype), self.bias.to(x.dtype)
        y = F.conv2d(x.permute(0, 3, 1, 2), kernel.permute(3, 2, 0, 1), bias, stride=self.stride)
        return y.permute(0, 2, 3, 1)


class ImagePatchEmbedding(nn.Module):
    """The conv patchifier and the optional (zero-initialized) cls token, in
    front (JAX :39-62)."""

    def __init__(self, n_img_channels: int = 3, n_embd: int = 768, patch_size: int = 16, patch_stride: int = 16,
                 add_cls_token: bool = True, device=None):
        super().__init__()
        self.conv = _Conv(n_img_channels, n_embd, patch_size, patch_stride, device=device)
        self.cls_token = nn.Parameter(torch.zeros(1, 1, n_embd, device=device)) if add_cls_token else None

    def forward(self, x):
        x = self.conv(x)
        x = x.reshape(x.shape[0], -1, x.shape[-1])  # b (h w) c
        if self.cls_token is not None:
            x = torch.cat([self.cls_token.to(x.dtype).expand(x.shape[0], 1, x.shape[-1]), x], dim=1)
        return x


class VisionTransformerBlock(nn.Module):
    """Pre-norm non-causal attention and MLP (JAX :65-100); the attention
    always carries bias."""

    def __init__(self, n_embd: int = 768, n_head: int = 8, ffn_hidden: int = 3072, bias: bool = True,
                 dropout: float = 0.0, device=None):
        super().__init__()
        self.norm1 = InputDtypeLayerNorm(n_embd, 1e-5, True, True, device=device)
        self.attention = MultiHeadAttention(n_embd, n_head, True, dropout,
                                            AttentionType.NON_CAUSAL_SELF_ATTENTION, device=device)
        self.norm2 = InputDtypeLayerNorm(n_embd, 1e-5, True, True, device=device)
        self.mlp = MLP(n_embd, ffn_hidden, bias=bias, dropout=dropout, device=device)

    def forward(self, x):
        x = x + self.attention(self.norm1(x))
        return x + self.mlp(self.norm2(x))


class VisionTransformerModule(nn.Module):
    """embedding_fn -> + positional_embedding -> blocks -> the classification
    path (pool, norm, head; JAX :134-140) when `n_classes` is set, else the
    raw block output [B, block_size, E]."""

    def __init__(self, spec: dict, device=None):
        super().__init__()
        self.spec = spec
        e = spec["n_embd"]
        self.embedding_fn = ImagePatchEmbedding(spec["n_img_channels"], e, spec["patch_size"], spec["patch_stride"],
                                                spec["add_cls_token"], device=device)
        self.positional_embedding = nn.Parameter(torch.empty(1, spec["block_size"], e, device=device))
        self.blocks = nn.ModuleList(VisionTransformerBlock(e, spec["n_head"], spec["ffn_hidden"], spec["bias"],
                                                           spec["dropout"], device=device)
                                    for _ in range(spec["n_layer"]))
        if spec["n_classes"] is not None:
            self.norm = InputDtypeLayerNorm(e, 1e-5, True, True, device=device)
            self.head = Linear(e, spec["n_classes"], spec["bias"], device=device)

    def forward(self, images):
        """images [B, H, W, C] -> logits [B, n_classes] (classification) or
        the encoder output [B, block_size, E], in the images' dtype."""
        if self.training:
            refuse_dropout(self.spec["dropout"])
        x = self.embedding_fn(images)
        x = x + self.positional_embedding.to(x.dtype)
        for block in self.blocks:
            x = block(x)
        if self.spec["n_classes"] is None:
            return x
        pooled = x[:, 0] if self.spec["add_cls_token"] else x.mean(dim=1)
        return self.head(self.norm(pooled))


class _ViTPredictions(VisionTransformerModule):
    """The framework ViT's module: samples dict in (the images cast to the
    parameters' dtype), predictions dict out."""

    def __init__(self, model: "VisionTransformer", device=None):
        super().__init__(model.spec, device=device)
        self.sample_key, self.prediction_key = model.sample_key, model.prediction_key

    def forward(self, samples: dict) -> dict:
        images = samples[self.sample_key].to(self.positional_embedding.dtype)
        return {self.prediction_key: super().forward(images)}


class VisionTransformer(NNModel):
    """The registry's `model.vision_transformer` (JAX :144-234): predictions
    {prediction_key: logits [B, n_classes] or the encoder output}."""

    _EMBEDDINGS = {"cls_token": 0.0, "positional_embedding": 0.02}

    def __init__(self, sample_key: str, prediction_key: str, img_size=224, n_classes: Optional[int] = 1000,
                 n_layer: int = 12, attention_config=None, n_head: int = 8, n_embd: int = 768, dropout: float = 0.0,
                 patch_size: int = 16, patch_stride: int = 16, n_img_channels: int = 3, add_cls_token: bool = True,
                 bias: bool = True, ffn_hidden: Optional[int] = None, seed: Optional[int] = None):
        super().__init__(sample_key, prediction_key, seed, _WEIGHT_DECAY_GROUPS)
        self.img_size = _img_size(img_size)
        if ffn_hidden is None and n_embd != 768:
            logger.warning("VisionTransformer ffn_hidden unset with n_embd=%d: the default is 3072 (reference parity; "
                           "before 2026-07 it was 4*n_embd=%d). Checkpoints from the old default need ffn_hidden: %d "
                           "set explicitly.", n_embd, 4 * n_embd, 4 * n_embd)
        self.block_size = get_block_size(self.img_size, patch_size, patch_stride, add_cls_token)
        # unset ffn_hidden is 3072, the reference's constructor default (it never forwards the field; JAX :190-206)
        self.spec = {"ffn_hidden": ffn_hidden or 3072, "block_size": self.block_size, "n_embd": n_embd,
                     "n_head": n_head, "n_layer": n_layer, "n_classes": n_classes, "dropout": dropout,
                     "patch_size": patch_size, "patch_stride": patch_stride, "add_cls_token": add_cls_token,
                     "bias": bias, "n_img_channels": n_img_channels}

    get_block_size = staticmethod(get_block_size)

    def _build(self, device) -> nn.Module:
        return _ViTPredictions(self, device=device)

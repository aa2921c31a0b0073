"""Generic GELU MLP for the models other than GPT2: the port of
modalities_tpu/nn/mlp.py (fc1, the exact erf GELU, fc2, in x's dtype)."""

from __future__ import annotations

from typing import Optional

import torch.nn.functional as F
from torch import nn

from modalities_tpu_torch.models.gpt2.gpt2_model import Linear
from modalities_tpu_torch.nn.attention import refuse_dropout


class MLP(nn.Module):
    def __init__(self, in_features: int, hidden_features: Optional[int] = None, out_features: Optional[int] = None,
                 bias: bool = True, dropout: float = 0.0, device=None):
        super().__init__()
        hidden = hidden_features or 4 * in_features
        self.dropout = float(dropout)
        self.fc1 = Linear(in_features, hidden, bias, device=device)
        self.fc2 = Linear(hidden, out_features or in_features, bias, device=device)

    def forward(self, x):
        if self.training:
            refuse_dropout(self.dropout)
        return self.fc2(F.gelu(self.fc1(x), approximate="none"))

"""Activation checkpointing (remat): the port of
modalities_tpu/training/activation_checkpointing.py and of the block-level
remat decision in modalities_tpu/models/gpt2/gpt2_model.py (`_layer_remats`).

The `activation_checkpointed` model variant records the variant on the
model's spec; the training forward then runs each chosen block under
`torch.utils.checkpoint` (non-reentrant): only the block's input is kept, and
the backward runs the block's forward again, kernels included, before its
backward.
- full_activation_checkpointing: every block;
- selective_layer_activation_checkpointing: every `ac_freq`-th block (block
  i with i % ac_freq == 0, as in the JAX package's unrolled blocks);
- selective_op_activation_checkpointing (save lists of ops): not ported.
"""

from __future__ import annotations

import torch.utils.checkpoint

_SPEC_NAMES = {  # config variant -> the spec's remat_variant
    "full_activation_checkpointing": "full",
    "selective_layer_activation_checkpointing": "selective_layer",
}


def apply_activation_checkpointing(model, variant: str, ac_freq: int = 1):
    """Record the variant on the model's spec (`remat_variant`, `remat_freq`)."""
    if variant == "selective_op_activation_checkpointing":
        raise NotImplementedError(
            "selective_op_activation_checkpointing (save-list policies) is not ported yet "
            "(ROADMAP.md, Queue 1 item 7); use full_activation_checkpointing or "
            "selective_layer_activation_checkpointing"
        )
    if variant not in _SPEC_NAMES:
        raise ValueError(f"Unknown activation checkpointing variant {variant!r}")
    if int(ac_freq) < 1:
        raise ValueError(f"ac_freq must be >= 1, got {ac_freq}")
    return model.with_spec_updates(remat_variant=_SPEC_NAMES[variant], remat_freq=int(ac_freq))


def layer_remats(remat_variant, remat_freq: int, layer_index: int) -> bool:
    """Whether block `layer_index` runs under checkpoint."""
    if remat_variant == "full":
        return True
    if remat_variant == "selective_layer":
        return layer_index % max(remat_freq, 1) == 0
    return False


def checkpointed(fn, *args):
    """fn(*args) keeping only its inputs; recomputed in the backward."""
    return torch.utils.checkpoint.checkpoint(fn, *args, use_reentrant=False)

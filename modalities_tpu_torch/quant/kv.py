"""Quantized paged-KV helpers: the port of modalities_tpu/quant/kv.py. Mode
resolution, byte accounting, and the host-side scale-allocation mirror.

The device-side work (int8 pools, per-(block, row, head) float32 scales,
quantize-on-write and dequant-at-gather) lives in the model's paged
attention (models/gpt2/gpt2_model.py); this module owns the HOST-side
contracts:

- `kv_blocks_for_budget` sizes a pool against a byte budget. The budget is
  defined over the K/V DATA tensors only: int8 data is exactly half of bf16,
  so a half-budget int8 pool holds >= the full-budget bf16 block count. The
  float32 scales are real memory but are accounted separately
  (`kv_scale_bytes_per_block`, the engine's `kv_scale_bytes`), never folded
  into the sizing rule: folding them in would make "half budget" quietly mean
  "fewer blocks" at small head counts.
- `KVScaleMirror` subscribes to `BlockPool`'s observer hooks and tracks which
  blocks' scale slots are live: scale allocation tracks block allocation
  exactly, so a leaked block is also a leaked scale row and vice versa.
"""

from __future__ import annotations

import os

import torch

KV_MODES = ("none", "int8")
_ENV_VAR = "MODALITIES_TPU_QUANT_KV"


def resolve_quant_kv_mode(setting=None) -> str:
    """Env > config > "none". Malformed values raise naming the source."""
    env = os.environ.get(_ENV_VAR)
    if env is not None:
        source, value = f"env {_ENV_VAR}", env
    else:
        source, value = "config quant.kv", setting
    if value is None:
        return "none"
    v = str(value).strip().lower()
    if v in ("", "none", "off", "0", "no", "false"):
        return "none"
    if v in KV_MODES:
        return v
    raise ValueError(f"{source}: invalid KV quant mode {value!r} (expected none|int8)")


def kv_block_bytes(block_size: int, n_head_kv: int, head_dim: int, mode: str = "none",
                   cache_dtype: torch.dtype = torch.bfloat16) -> int:
    """K+V data bytes of ONE pool block for one layer (scales excluded: see
    the module docstring for why the budget is data-only)."""
    itemsize = 1 if mode == "int8" else torch.empty((), dtype=cache_dtype).element_size()
    return int(2 * block_size * n_head_kv * head_dim * itemsize)


def kv_scale_bytes_per_block(block_size: int, n_head_kv: int) -> int:
    """Float32 scale bytes of one block: one scale per (row, kv-head) for each
    of K and V. Rows land in a block at different decode steps, so the scale
    granularity must be per written row, not per block."""
    return int(2 * block_size * n_head_kv * 4)


def kv_blocks_for_budget(budget_bytes: int, block_size: int, n_head_kv: int, head_dim: int, mode: str = "none",
                         cache_dtype: torch.dtype = torch.bfloat16) -> int:
    """How many pool blocks (per layer) a byte budget buys. int8 doubles the
    answer against bf16 at the same budget."""
    per_block = kv_block_bytes(block_size, n_head_kv, head_dim, mode, cache_dtype)
    return max(1, int(budget_bytes) // per_block)


class KVScaleMirror:
    """Host mirror of the per-block scale slots, driven by BlockPool's
    observer hooks (`pool.add_observer(mirror)`).

    Invariant: a scale slot is live iff its block is allocated. Any divergence
    (double-allocate, free-without-allocate, leak) raises at once with the
    offending block id rather than surfacing later as a corrupt gather.
    """

    def __init__(self, num_blocks: int):
        self.num_blocks = int(num_blocks)
        self.live: set = set()
        self.allocs = 0
        self.frees = 0

    def on_allocate(self, block: int) -> None:
        if not (0 <= block < self.num_blocks):
            raise ValueError(f"scale mirror: allocate of out-of-range block {block}")
        if block in self.live:
            raise ValueError(f"scale mirror: block {block} allocated while its scale slot is live")
        self.live.add(block)
        self.allocs += 1

    def on_free(self, block: int) -> None:
        if block not in self.live:
            raise ValueError(f"scale mirror: block {block} freed without a live scale slot")
        self.live.remove(block)
        self.frees += 1

    def check(self, pool) -> None:
        """Scale slots must equal the pool's allocated set, exactly."""
        allocated = set(pool.allocated_blocks())
        if self.live != allocated:
            leaked = sorted(self.live - allocated)
            missing = sorted(allocated - self.live)
            raise AssertionError(
                f"scale mirror diverged from pool: leaked scale slots {leaked}, "
                f"blocks without scale slots {missing}"
            )

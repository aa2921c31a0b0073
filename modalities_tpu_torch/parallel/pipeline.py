"""Pipeline stages: the GPT2 module split over the pp axis. The port of the
stage split of modalities_tpu/parallel/pipeline.py and pipeline_scheduled.py,
where the scan-stacked [L, ...] parameters are sharded over pp (so device s
holds chunks {c * P + s}, or the V pair under zbv / dualpipev).

Here the split is a module fact: each pp rank builds a `GPT2Module` that
holds only its share (`build_stage_module`):
- the blocks of its chunks: global stage g owns layers [g * L / G, (g + 1) *
  L / G) of G = V * P global stages; chunk c of device s is global stage c *
  P + s (`loop` placement), or s and 2P - 1 - s (`v` placement);
- where it runs global stage 0: `wte` (and `wpe`), the embeddings;
- where it runs the last global stage: `lm_head_norm` and the head (`wte`
  again when tied, else `lm_head`).
Blocks keep their GLOBAL names (`blocks.5.attn.q_attn.kernel` on whichever
stage holds layer 5), so a stage's state dict is a part of the unsplit
model's and checkpoints load across pp degrees. A tied `wte` is a copy on the
first and on the last stage (two devices under `loop` placement, one under
`v`); the train step sums the copies' gradients over pp and steps both alike.

`PipelineStage` is what the executor (parallel/pipeline_scheduled.py) runs:
the module and its chunks, `forward(chunk, ids, x, head)` runs one chunk.
GPipe is no code path of its own: the `gpipe` tables run through the same
executor.
"""

from __future__ import annotations

import dataclasses
import re
from typing import Callable, Optional

import torch

from modalities_tpu_torch.parallel.pipeline_schedules import ScheduleTables

_BLOCK = re.compile(r"^blocks\.(\d+)\.")


@dataclasses.dataclass(frozen=True)
class StageChunk:
    """One virtual chunk of a device: its global stage and layers."""

    chunk: int
    stage: int
    first: int
    count: int


def stage_layers(n_layer: int, num_stages_global: int, stage: int) -> tuple[int, int]:
    """Global stage `stage`'s layers (first, count): every stage holds as
    many, in order."""
    if n_layer % num_stages_global:
        raise ValueError(f"n_layer ({n_layer}) must be divisible by num_virtual*pp ({num_stages_global} global "
                         "stages)")
    per = n_layer // num_stages_global
    return stage * per, per


def stage_chunks(tables: ScheduleTables, device: int, n_layer: int) -> list[StageChunk]:
    """Device `device`'s chunks, in chunk order."""
    return [StageChunk(c, g, *stage_layers(n_layer, tables.num_stages_global, g))
            for c, g in ((c, tables.global_stage(c, device)) for c in range(tables.num_virtual))]


def holds_first(tables: ScheduleTables, device: int) -> bool:
    return tables.device_of(0) == device


def holds_last(tables: ScheduleTables, device: int) -> bool:
    return tables.device_of(tables.num_stages_global - 1) == device


def keeps(name: str, layers: set[int], first: bool, last: bool, tied: bool) -> bool:
    """Whether a stage with `layers` (and the first / last global stage or
    not) holds the unsplit model's parameter `name`."""
    block = _BLOCK.match(name)
    if block is not None:
        return int(block.group(1)) in layers
    if name == "wte":
        return first or (last and tied)
    if name == "wpe":
        return first
    return last  # lm_head_norm.*, lm_head.*


def build_stage_module(model, params: dict[str, torch.Tensor], tables: ScheduleTables, device: int):
    """The training module of pp device `device` over its share of the whole
    `params` (adopted where no other stage of this process needs the same
    tensor: pass copies for in-process stages)."""
    from modalities_tpu_torch.models.gpt2.gpt2_model import GPT2Module

    spec = model.config_spec
    layers = {i for c in stage_chunks(tables, device, spec.n_layer) for i in range(c.first, c.first + c.count)}
    first, last = holds_first(tables, device), holds_last(tables, device)
    module = GPT2Module(spec, device="meta")
    for name in [n for n in module.blocks._modules if int(n) not in layers]:
        del module.blocks._modules[name]
    for name in ("wte", "wpe", "lm_head_norm", "lm_head"):
        if hasattr(module, name) and not keeps(name, layers, first, last, spec.use_weight_tying):
            delattr(module, name)
    own = {k: v for k, v in params.items() if keeps(k, layers, first, last, spec.use_weight_tying)}
    module.load_state_dict(own, strict=True, assign=True)
    return module.train()


class PipelineStage:
    """Pp device `device`'s share of the model, as the executor runs it."""

    def __init__(self, module, tables: ScheduleTables, device: int):
        self.module = module
        self.device = device
        self.chunks = {c.chunk: c for c in stage_chunks(tables, device, module.spec.n_layer)}
        self.is_first = holds_first(tables, device)
        self.is_last = holds_last(tables, device)

    def forward(self, chunk: int, ids: torch.Tensor, x: Optional[torch.Tensor],
                head: Optional[Callable] = None):
        """Chunk `chunk` over x (the embeddings of ids where x is None); with
        `head`, the head's value of the chunk's output (the last stage)."""
        c = self.chunks[chunk]
        return self.module.stage_forward(ids, x, c.first, c.count, head)

"""Model FLOPs utilization: the port of modalities_tpu/utils/mfu.py.

The same flops-per-token formula, 6N + 12*L*s*h; the peak is the card's dense
bf16 tensor-core rate, keyed by `torch.cuda.get_device_name()` (NVIDIA's data
sheets). The CPU gets a nominal 1 TFLOP/s, so CPU runs print a number that is
no device metric.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional

from modalities_tpu_torch.config.config import check_int

# dense bf16 FLOP/s by device name (substring match, longest first)
GPU_PEAK_FLOPS = {
    "H100 80GB HBM3": 989.4e12,  # SXM
    "H100 PCIe": 756e12,
}
CPU_NOMINAL_PEAK = 1e12


def get_peak_flops(device) -> float:
    import torch

    device = torch.device(device)
    if device.type == "cpu":
        return CPU_NOMINAL_PEAK
    name = torch.cuda.get_device_name(device)
    for key in sorted(GPU_PEAK_FLOPS, key=len, reverse=True):
        if key in name:
            return GPU_PEAK_FLOPS[key]
    raise ValueError(f"no bf16 peak known for {name!r}; add it to GPU_PEAK_FLOPS")


@dataclasses.dataclass
class GPT2MFUCalculatorConfig:
    n_layer: int
    sequence_length: int
    n_embd: int
    world_size: int
    num_parameters: Optional[int] = None
    wrapped_model: Any = None
    device_mesh: Any = None

    def __post_init__(self):
        for name in ("n_layer", "sequence_length", "n_embd", "world_size"):
            check_int(name, getattr(self, name), ge=1)
        check_int("num_parameters", self.num_parameters, optional=True)


class GPT2MFUCalculator:
    """MFU = tokens/s * (6N + 12*L*s*h) / (world * peak). N is counted from
    the model's parameter shapes unless given; the peak is resolved for the
    device the trainer runs on (`bind`)."""

    def __init__(self, n_layer: int, sequence_length: int, n_embd: int, world_size: int,
                 num_parameters: Optional[int] = None, wrapped_model=None, device_mesh=None):
        self.n_layer = n_layer
        self.sequence_length = sequence_length
        self.n_embd = n_embd
        self.world_size = world_size
        if num_parameters is None and wrapped_model is not None:
            num_parameters = wrapped_model.num_parameters()
        self.num_parameters = num_parameters or 0
        self.peak: Optional[float] = None

    def bind(self, device) -> "GPT2MFUCalculator":
        self.peak = get_peak_flops(device)
        return self

    @property
    def flops_per_token(self) -> int:
        return 6 * self.num_parameters + 12 * self.n_layer * self.sequence_length * self.n_embd

    def compute(self, tokens_per_second: float) -> float:
        if self.peak is None:
            raise RuntimeError("GPT2MFUCalculator: bind(device) before compute")
        return tokens_per_second * self.flops_per_token / (self.world_size * self.peak)

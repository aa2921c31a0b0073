"""Device resolution for the port's entry points.

Entry points run on the card unless the caller asks for the CPU: `device`
defaults to "cuda", and with no CUDA device present that default raises
instead of dropping to the CPU. Tests pass `device="cpu"`. "cuda" without an
index is the launcher's card, LOCAL_RANK (0 without a launcher).
"""

from __future__ import annotations

import os

import torch

DEFAULT_DEVICE = "cuda"


def resolve_device(device: str | torch.device | None = None) -> torch.device:
    dev = torch.device(DEFAULT_DEVICE if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"device {dev} requested but no CUDA device is available; pass device='cpu' "
                "to run the plain PyTorch path on the CPU"
            )
        if dev.index is None:
            dev = torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0)))
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {dev}: expected 'cuda' or 'cpu'")
    return dev

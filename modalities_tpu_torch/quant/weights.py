"""Weight-only quantization for serving: the port of
modalities_tpu/quant/weights.py. Parameters are quantized ONCE at load time
and dequantized on the fly inside the fused matmul (ops/quant_matmul.py).

Layout contract (the JAX package's, on the port's 2-D [in, out] kernels): a
quantized dense layer keeps its `<name>.kernel` key, now in the quantized
dtype, and gains a float32 `<name>.scale` [out] — one symmetric absmax scale
per output channel, reduced over the input dim. A JAX kernel's input dims are
exactly what the port flattened into `in`, so both quantize to the same codes
and scales. Bias, embeddings and norm scales are untouched. `quantize_params`
is idempotent: a layer that already has its scale passes through.
"""

from __future__ import annotations

import copy
import dataclasses
import os

import torch

from modalities_tpu_torch.quant.core import quantize_fp8, quantize_per_channel

WEIGHT_MODES = ("none", "int8", "fp8")
_ENV_VAR = "MODALITIES_TPU_QUANT_WEIGHTS"


def resolve_quant_weights_mode(setting=None) -> str:
    """Env > config > "none", as the JAX function resolves it. Malformed
    values raise naming the source: a typo'd mode must never silently serve
    unquantized weights."""
    env = os.environ.get(_ENV_VAR)
    if env is not None:
        source, value = f"env {_ENV_VAR}", env
    else:
        source, value = "config quant.weights", setting
    if value is None:
        return "none"
    v = str(value).strip().lower()
    if v in ("", "none", "off", "0", "no", "false"):
        return "none"
    if v in WEIGHT_MODES:
        return v
    raise ValueError(f"{source}: invalid weight quant mode {value!r} (expected none|int8|fp8)")


def quant_storage_dtype(mode: str) -> torch.dtype:
    """The dtype quantized kernels are stored in."""
    if mode == "int8":
        return torch.int8
    if mode == "fp8":
        return torch.float8_e4m3fn
    raise ValueError(f"no storage dtype for quant mode {mode!r}")


def quantize_kernel(kernel, mode: str):
    """Per-output-channel quantization of an [in, out] kernel: (q, scale [out])."""
    if mode == "int8":
        q, scale = quantize_per_channel(kernel, dim=0)
    elif mode == "fp8":
        q, scale = quantize_fp8(kernel.t())
        q, scale = q.t().contiguous(), scale.t()
    else:
        raise ValueError(f"unknown quant mode {mode!r}")
    return q, scale[0]


def quantize_params(params: dict, mode: str) -> dict:
    """Quantize every 2-D dense kernel of a flat state dict; returns a new
    dict (tensors that do not change are shared, never copied)."""
    if mode == "none":
        return params
    if mode not in WEIGHT_MODES:
        raise ValueError(f"unknown quant mode {mode!r} (expected none|int8|fp8)")
    out = dict(params)
    for name, tensor in params.items():
        if not name.endswith(".kernel") or tensor.ndim != 2:
            continue
        prefix = name[: -len(".kernel")]
        if prefix + ".scale" in params:  # already quantized: idempotent
            continue
        out[name], out[prefix + ".scale"] = quantize_kernel(tensor, mode)
    return out


def infer_quant_mode(params: dict) -> str:
    """"none" | "int8" | "fp8" | "mixed", read off the kernel dtypes."""
    modes = set()
    total = quantized = 0
    for name, tensor in params.items():
        if not name.endswith(".kernel") or tensor.ndim != 2:
            continue
        total += 1
        if name[: -len(".kernel")] + ".scale" in params:
            quantized += 1
            modes.add("int8" if tensor.dtype == torch.int8 else "fp8")
    if not modes:
        return "none"
    if len(modes) > 1 or quantized != total:
        return "mixed"
    return modes.pop()


def weights_bytes_saved(params: dict) -> int:
    """Bytes the quantized kernels save against fp32 storage, net of scales."""
    saved = 0
    for name, tensor in params.items():
        scale = params.get(name[: -len(".kernel")] + ".scale") if name.endswith(".kernel") else None
        if scale is not None and tensor.ndim == 2:
            saved += tensor.numel() * (4 - tensor.element_size()) - scale.numel() * 4
    return saved


def quantized_model(model, mode: str):
    """A COPY of `model` whose spec selects quantized dense layers (the
    original, possibly shared, is never touched)."""
    if mode == "none":
        return model
    m = copy.copy(model)
    m.config_spec = dataclasses.replace(model.config_spec, quant_weights=mode)
    return m

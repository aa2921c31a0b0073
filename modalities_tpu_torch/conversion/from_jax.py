"""JAX GPT2 parameters -> the port's state dict: the one bridge between the
two packages.

Input: the flax params tree (`{"params": {...}}` or the inner dict) as nested
dicts of numpy arrays, so the port never sees a JAX type (a caller converts
with `jax.tree.map(np.asarray, params)`). The tree may be fp32, bf16
(ml_dtypes) or weight-only quantized (an int8 or float8_e4m3fn `kernel` plus
its float32 `scale`, quant/weights.py's layout on the JAX side).

The walk is convert_gpt2.py's (modalities_tpu/conversion/gpt2/convert_gpt2.py
:72-110): scan-stacked `blocks/block/...` leaves carry a leading [L] axis that
becomes the layer index; DenseGeneral kernels [E, H, D] (q/k/v) and
[H, D, E] (attention c_proj) flatten to the port's 2-D [in, out] kernels, and
their scales [H, D] / [E] flatten to [out].
"""

from __future__ import annotations

from typing import Mapping

import numpy as np
import torch


def to_torch(a) -> torch.Tensor:
    """numpy (incl. ml_dtypes bfloat16 / float8_e4m3fn) -> a CPU tensor with the
    same bits. ml_dtypes arrays cross as raw bytes and are viewed back."""
    a = np.ascontiguousarray(a)
    name = a.dtype.name
    if name == "float8_e4m3fn":
        return torch.from_numpy(a.view(np.uint8).copy()).view(torch.float8_e4m3fn)
    if name == "bfloat16":
        return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
    return torch.from_numpy(a.copy())


def _dense_2d(node: Mapping, name: str, n_in: int) -> dict[str, np.ndarray]:
    """One (per-layer) DenseGeneral node -> port leaves with `n_in` leading
    input dims flattened into `in` and the rest into `out`."""
    out = {}
    kernel = np.asarray(node["kernel"])
    k_in = int(np.prod(kernel.shape[:n_in]))
    out[f"{name}.kernel"] = kernel.reshape(k_in, -1)
    if "scale" in node:
        out[f"{name}.scale"] = np.asarray(node["scale"]).reshape(-1)
    if "bias" in node:
        out[f"{name}.bias"] = np.asarray(node["bias"]).reshape(-1)
    return out


def _norm(node: Mapping, name: str) -> dict[str, np.ndarray]:
    return {f"{name}.{k}": np.asarray(v) for k, v in node.items() if k in ("scale", "bias")}


def _layer(tree: Mapping, layer: int) -> Mapping:
    """The per-layer slice of a scan-stacked subtree."""
    if isinstance(tree, Mapping):
        return {k: _layer(v, layer) for k, v in tree.items()}
    return np.asarray(tree)[layer]


def params_from_jax(tree: Mapping, config) -> dict[str, torch.Tensor]:
    """The port's state dict for a GPT2 with spec `config` (GPT2LLM or its
    GPT2ModelSpec) from the JAX params tree."""
    spec = getattr(config, "config_spec", config)
    p = tree["params"] if "params" in tree else tree
    flat: dict[str, np.ndarray] = {"wte": np.asarray(p["wte"])}
    if "wpe" in p:
        flat["wpe"] = np.asarray(p["wpe"])
    for i in range(spec.n_layer):
        blk = _layer(p["blocks"]["block"], i)
        pre = f"blocks.{i}"
        attn = blk["attn"]
        flat.update(_norm(blk.get("attention_norm", {}), f"{pre}.attention_norm"))
        for name in ("q_attn", "k_attn", "v_attn"):
            flat.update(_dense_2d(attn[name], f"{pre}.attn.{name}", 1))
        flat.update(_dense_2d(attn["c_proj"], f"{pre}.attn.c_proj", 2))
        for name in ("q_norm", "k_norm"):
            flat.update(_norm(attn.get(name, {}), f"{pre}.attn.{name}"))
        flat.update(_norm(blk.get("ffn_norm", {}), f"{pre}.ffn_norm"))
        for name, node in blk["mlp"].items():
            flat.update(_dense_2d(node, f"{pre}.mlp.{name}", 1))
    flat.update(_norm(p.get("lm_head_norm", {}), "lm_head_norm"))
    if not spec.use_weight_tying:
        flat.update(_dense_2d(p["lm_head"], "lm_head", 1))
    return {k: to_torch(v) for k, v in flat.items()}

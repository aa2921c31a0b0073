"""JAX parameters -> the port's state dict: the one bridge between the two
packages.

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

The dict-in models (the ViT, CoCa; models/model.py) name their parameters
after the flax tree: each state-dict key's flax path (`jax_param_path`)
picks its leaf, reshaped to the port's shape (DenseGeneral kernels [E, H, D]
and [H, D, E] flattened to 2-D, biases [H, D] to [H x D]; the patch
embedding's HWIO conv kernel and the tied `wte` as they are).

`paged_cache_from_jax` carries a JAX paged KV cache tree (its pools, and the
scale pools of an int8 cache) into the port's `PagedCache`, so the contents of
the two pools can be compared after the same dispatches.

`app_state_from_jax` carries a whole JAX training state {params, opt_state,
step} (as numpy, e.g. from the JAX package's `restore_tree_single_device`)
into a train step's app-state dict (checkpointing/stateful/app_state.py).
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


def _flax_leaves(node, prefix: str = "") -> dict[str, np.ndarray]:
    """{flax path: leaf} of a nested params tree."""
    if not isinstance(node, Mapping):
        return {prefix: np.asarray(node)}
    out = {}
    for key, child in node.items():
        out.update(_flax_leaves(child, f"{prefix}/{key}" if prefix else str(key)))
    return out


def params_by_path(tree: Mapping, shapes: Mapping, path_of) -> dict[str, torch.Tensor]:
    """{name: tensor of shapes[name]} from the JAX params tree, each name's
    leaf at the flax path `path_of(name)`: every leaf used once, every
    parameter found (a dict-in model, or one of its layers in a test)."""
    leaves = _flax_leaves(tree if "params" in tree else {"params": tree})
    out = {}
    for name, shape in shapes.items():
        path = path_of(name)
        if path not in leaves:
            raise KeyError(f"{name}: no JAX leaf {path!r}")
        out[name] = to_torch(leaves.pop(path).reshape(tuple(shape)))
    if leaves:
        raise KeyError(f"JAX leaves with no port parameter: {sorted(leaves)}")
    return out


def params_from_jax(tree: Mapping, config) -> dict[str, torch.Tensor]:
    """The port's state dict from the JAX params tree: for a GPT2 with spec
    `config` (GPT2LLM or its GPT2ModelSpec), or for a dict-in model."""
    if hasattr(config, "jax_param_path"):
        return params_by_path(tree, config.param_shapes(), config.jax_param_path)
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


_PAGED_LEAVES = ("cached_key", "cached_value", "cached_key_scale", "cached_value_scale")


def paged_cache_from_jax(tree: Mapping):
    """The port's PagedCache from a JAX paged cache tree (numpy leaves): the
    scan-stacked `blocks/block/attn/<leaf>` [L, NB, bs, Hkv, D | 1], or the
    unrolled `h_<i>/attn/<leaf>` [NB, ...] stacked in layer order. The port's
    pools carry one more block, the scratch block of dropped writes, zeroed."""
    from modalities_tpu_torch.models.gpt2.gpt2_model import PagedCache

    if "blocks" in tree:
        attn = tree["blocks"]["block"]["attn"]
        leaves = {name: np.asarray(attn[name]) for name in _PAGED_LEAVES if name in attn}
    else:
        layers = sorted((k for k in tree if k.startswith("h_")), key=lambda k: int(k[2:]))
        leaves = {name: np.stack([np.asarray(tree[k]["attn"][name]) for k in layers])
                  for name in _PAGED_LEAVES if name in tree[layers[0]]["attn"]}

    def with_scratch(a):
        t = to_torch(a)
        return torch.cat([t, torch.zeros_like(t[:, :1])], dim=1)

    pools = [with_scratch(leaves[name]) if name in leaves else None for name in _PAGED_LEAVES]
    return PagedCache(k=pools[0], v=pools[1], k_scale=pools[2], v_scale=pools[3])


def _find_adam_state(node):
    """The optax Adam state ({count, mu, nu}, as a namedtuple or the dict a
    restored checkpoint makes of it) inside an opt_state tree."""
    if isinstance(node, Mapping) and {"count", "mu", "nu"} <= set(node):
        return node
    if all(hasattr(node, k) for k in ("count", "mu", "nu")):
        return {"count": node.count, "mu": node.mu, "nu": node.nu}
    children = node.values() if isinstance(node, Mapping) else node if isinstance(node, (list, tuple)) else ()
    for child in children:
        found = _find_adam_state(child)
        if found is not None:
            return found
    return None


def app_state_from_jax(tree: Mapping, train_step) -> dict:
    """The app-state dict of `train_step` (checkpointing/stateful/app_state.py)
    from the JAX {params, opt_state, step} tree: the parameters through
    `params_from_jax`; optax Adam's `mu` and `nu` become AdamW's `exp_avg`
    and `exp_avg_sq` and its `count` each parameter's `step`. The JAX
    optimizer's hyperparameters are config and its schedule a function of the
    step, so the param groups and the LR scheduler's state are the train
    step's own, put at `step`: the scheduler's position and every group's lr
    are those of a run that took `step` steps."""
    from modalities_tpu_torch.checkpointing.stateful.app_state import AppState

    adam = _find_adam_state(tree["opt_state"])
    if adam is None:
        raise ValueError("the JAX opt_state holds no Adam state (count, mu, nu)")
    config = train_step.model
    exp_avg, exp_avg_sq = params_from_jax(adam["mu"], config), params_from_jax(adam["nu"], config)
    count = torch.tensor(float(np.asarray(adam["count"])), dtype=torch.float32)
    step = int(np.asarray(tree["step"]))
    built = AppState(train_step).state_dict()
    scheduler = train_step.scheduler
    rates = [base * fn(step) for base, fn in zip(scheduler.base_lrs, scheduler.lr_lambdas)]
    names = {p: name for name, p in train_step.module.named_parameters()}
    rate_of = {names[p]: lr for group, lr in zip(train_step.optimizer.param_groups, rates) for p in group["params"]}
    # the optimizer's flattened form (AppState): state.<name>.<key>, param_groups.<name>.<hyperparameter>
    optimizer = {f"state.{name}.{key}": value for name in exp_avg for key, value in
                 (("step", count.clone()), ("exp_avg", exp_avg[name]), ("exp_avg_sq", exp_avg_sq[name]))}
    for key, value in built["optimizer"].items():
        if key.startswith("param_groups."):
            name, field = key[len("param_groups."):].rsplit(".", 1)
            optimizer[key] = rate_of[name] if field == "lr" else value
    lr_scheduler = {**built["lr_scheduler"], "last_epoch": step, "_step_count": step + 1, "_last_lr": rates}
    return {"model": params_from_jax(tree["params"], config), "optimizer": optimizer,
            "lr_scheduler": lr_scheduler, "step": torch.tensor(step, dtype=torch.int64)}

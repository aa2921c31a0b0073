"""Framework-level base of the dict-in / dict-out models (the ViT, CoCa): the
port of modalities_tpu/models/model.py:NNModel.

A model holds its static description and makes parameters and modules; it
holds no tensors itself. Its module's `forward` takes the microbatch's
samples dict and returns a predictions dict, so the train step feeds it every
sample key (`takes_samples`) and gives the loss the predictions
(training/train_step.py). The GPT2 port keeps its own class
(models/gpt2/gpt2_model.py:GPT2LLM), whose module takes the token tensor.

Parameters follow the flax tree: the state-dict key
`vision_encoder.blocks.3.attention.q_attn.kernel` is the flax path
`params/vision_encoder/blocks_3/attention/q_attn/kernel` (`jax_param_path`),
dense kernels stored 2-D as [in, out]. So the JAX weight-decay regexes
resolve against `jax_param_path` to the JAX mask
(optimizers/optimizer_factory.py), and the JAX weights convert by reshaping
(conversion/from_jax.py).

Fresh parameters take the flax initializers: lecun normal (a normal
truncated at two deviations, fan in the kernel's input dims) for dense and
conv kernels, zeros for biases, ones for norm scales, and each model's own
for its embeddings (`_EMBEDDINGS`). They are drawn from a `torch.Generator`,
so they are not the JAX package's numbers: parity tests carry the JAX
weights across. The compute follows the inputs' dtype (flax's
`dtype=x.dtype`): the mixed-precision policy's `param_dtype` stores the
parameters, and the inputs are cast to it where they enter.
"""

from __future__ import annotations

import dataclasses
import math
import re
from typing import Optional

import torch
from torch import nn

from modalities_tpu_torch.models.gpt2.gpt2_model import TrainSpec

_LECUN_STD = 0.87962566103423978  # the deviation of a unit normal truncated at +-2 (flax's variance_scaling)


def jax_param_path(name: str) -> str:
    """The flax path of the state-dict key `name`: dots become slashes and a
    list index joins its list's name (`blocks.3` -> `blocks_3`)."""
    return "params/" + re.sub(r"(\w+)/(\d+)(?=/|$)", r"\1_\2", name.replace(".", "/"))


class NNModel:
    """Subclasses give `_build(device)` (the module on `device`) and
    `_EMBEDDINGS` (parameter name suffix -> the normal's deviation, 0 for
    zeros)."""

    takes_samples = True  # the module's forward takes the samples dict and returns the predictions dict
    _EMBEDDINGS: dict[str, float] = {}

    def __init__(self, sample_key: str, prediction_key: str, seed: Optional[int],
                 weight_decay_groups: dict[str, list[str]]):
        self.sample_key = sample_key
        self.prediction_key = prediction_key
        self.seed = seed if seed is not None else 42  # the JAX NNModel default
        self.weight_decay_groups = weight_decay_groups
        self.train_spec = TrainSpec()
        self.param_dtype = "float32"

    def _build(self, device) -> nn.Module:  # pragma: no cover - abstract
        raise NotImplementedError

    jax_param_path = staticmethod(jax_param_path)

    def update_train_spec(self, **changes) -> "NNModel":
        self.train_spec = dataclasses.replace(self.train_spec, **changes)
        return self

    def with_spec_updates(self, param_dtype: Optional[str] = None, compute_dtype: Optional[str] = None) -> "NNModel":
        """The mixed-precision policy, as the train step applies it: the
        parameters are stored in `param_dtype`; the compute follows the
        inputs, which enter in the parameters' dtype (`compute_dtype` has no
        separate effect, as in the JAX models, which compute in x's dtype)."""
        if param_dtype is not None:
            self.param_dtype = param_dtype
        return self

    def param_shapes(self) -> dict[str, torch.Size]:
        return {k: v.shape for k, v in self._build("meta").state_dict().items()}

    def _draw(self, name: str, shape, generator: torch.Generator) -> torch.Tensor:
        device = generator.device
        leaf = name.rsplit(".", 1)[-1]
        for suffix, std in self._EMBEDDINGS.items():
            if name.endswith(suffix):
                t = torch.zeros(shape, device=device)
                return t.normal_(0.0, std, generator=generator) if std else t
        if leaf == "scale":
            return torch.ones(shape, device=device)
        if leaf == "bias":
            return torch.zeros(shape, device=device)
        if leaf != "kernel":
            raise ValueError(f"no initializer for parameter {name!r}")
        std = math.sqrt(1.0 / math.prod(shape[:-1])) / _LECUN_STD
        return nn.init.trunc_normal_(torch.empty(shape, device=device), 0.0, std, -2.0 * std, 2.0 * std,
                                     generator=generator)

    def init_params(self, generator: torch.Generator) -> dict[str, torch.Tensor]:
        """Fresh fp32 parameters drawn from `generator`, on its device, one
        tensor at a time in the state dict's order."""
        return {name: self._draw(name, shape, generator) for name, shape in self.param_shapes().items()}

    def init_train_params(self, generator: torch.Generator) -> dict[str, torch.Tensor]:
        """`init_params`, drawn instead by the last recorded init routine (the
        `model_initialized` variant) that targets a parameter, stored in
        `param_dtype`."""
        shapes = self.param_shapes()
        routines = self.train_spec.init_routines
        for routine in routines:
            routine.validate(list(shapes))
        dtype = getattr(torch, self.param_dtype)
        params = {}
        for name, shape in shapes.items():
            targeting = [r for r in routines if r.targets(name)]
            t = targeting[-1].draw(name, shape, generator) if targeting else self._draw(name, shape, generator)
            params[name] = t.to(dtype)
        return params

    def num_parameters(self) -> int:
        return sum(math.prod(shape) for shape in self.param_shapes().values())

    def build_train_module(self, params: dict[str, torch.Tensor]) -> nn.Module:
        """The module over `params` (adopted, on their device, in their
        dtypes), in train mode."""
        module = self._build("meta")
        module.load_state_dict(params, strict=True, assign=True)
        return module.train()

    def build_module(self, params: dict[str, torch.Tensor]) -> nn.Module:
        """The same in eval mode."""
        return self.build_train_module(params).eval()

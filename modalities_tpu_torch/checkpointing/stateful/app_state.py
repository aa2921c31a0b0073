"""AppState: the state a run trains and checkpoints, over the port's
`TrainStep`; the port of modalities_tpu/checkpointing/stateful/app_state.py.

The JAX AppState is the pytree {params, opt_state, step}; here the state lives
in the train step's module, optimizer and LR scheduler, and `AppState` is
their `Stateful` face for `torch.distributed.checkpoint` (DCP):

- "model": the module's parameters and "optimizer": the optimizer's state and
  param groups, both from `torch.distributed.checkpoint.state_dict.get_state_dict`,
  so optimizer state is keyed by parameter name (as it is under FSDP2). The
  optimizer's dict is flattened (`flatten_optimizer_state_dict`): each
  parameter's state and its group's hyperparameters under its own name
  (`state.<fqn>.exp_avg`, `param_groups.<fqn>.lr`). Under pipeline
  parallelism each pp rank holds other parameters in its groups, and a
  group's list of names saved under one key for every rank would keep one
  rank's list; by name, every rank's entries are its own and a folder loads
  at any pp degree;
  Under ZeRO-1 the optimizer holds chunks, not the module's parameters: its
  state comes from the train step's `zero.state_dict()` in the same flat
  layout, the moments as DTensors of the parameters' full shapes over each
  rank's chunk (parallel/zero.py), so a folder loads at either stage;
- "lr_scheduler": the `LambdaLR` position (`last_epoch`, the last rates, the
  base rates). The schedule function is config, not state, and is never
  saved;
- "step": the number of optimizer steps done.

`load_state_dict` writes into the train step's own tensors (`set_state_dict`
copies into the parameters the optimizer holds), so no reference goes stale.

`mark_loaded` refuses a second load, as the JAX AppStateHandle does.
"""

from __future__ import annotations

import torch
from torch.distributed.checkpoint.state_dict import (
    StateDictOptions,
    get_model_state_dict,
    get_state_dict,
    set_model_state_dict,
    set_state_dict,
)
from torch.distributed.checkpoint.stateful import Stateful


DOUBLE_LOAD = "AppState was already loaded from checkpoint; refusing double-load."
OPTIONS = StateDictOptions(flatten_optimizer_state_dict=True)


def flatten_tensors(tree: dict, prefix: str = "") -> dict[str, torch.Tensor]:
    """A nested state dict's tensor leaves under DCP's flattened names (nested
    keys joined by dots, as in the checkpoint's metadata)."""
    out = {}
    for key, value in tree.items():
        name = f"{prefix}.{key}" if prefix else str(key)
        if isinstance(value, dict):
            out.update(flatten_tensors(value, name))
        elif isinstance(value, torch.Tensor):
            out[name] = value
    return out


class AppState(Stateful):
    """`device_mesh`: the run's running_env.device_mesh.DeviceMesh (None: the
    default world-1 mesh), recorded in each checkpoint's topology.json."""

    def __init__(self, train_step, device_mesh=None):
        self.train_step = train_step
        self.device_mesh = device_mesh
        self._loaded = False

    @property
    def step_count(self) -> int:
        """Optimizer steps done: the scheduler steps once per optimizer step."""
        return int(self.train_step.scheduler.last_epoch)

    def state_dict(self) -> dict:
        step = self.train_step
        if step.zero is not None:
            model_sd, optim_sd = get_model_state_dict(step.module, options=OPTIONS), step.zero.state_dict()
        else:
            model_sd, optim_sd = get_state_dict(step.module, step.optimizer, options=OPTIONS)
        scheduler_sd = {k: v for k, v in step.scheduler.state_dict().items() if k != "lr_lambdas"}
        return {"model": model_sd, "optimizer": optim_sd, "lr_scheduler": scheduler_sd,
                "step": torch.tensor(self.step_count, dtype=torch.int64)}

    def load_state_dict(self, state_dict: dict) -> None:
        step = self.train_step
        if step.zero is not None:
            set_model_state_dict(step.module, state_dict["model"], options=OPTIONS)
            step.zero.load_state_dict(state_dict["optimizer"])
        else:
            set_state_dict(step.module, step.optimizer, model_state_dict=state_dict["model"],
                           optim_state_dict=state_dict["optimizer"], options=OPTIONS)
        scheduler = step.scheduler
        scheduler.load_state_dict({**state_dict["lr_scheduler"], "lr_lambdas": [None] * len(scheduler.lr_lambdas)})
        num_steps = int(state_dict["step"])
        if self.step_count != num_steps:
            raise ValueError(f"app state: step {num_steps} but the scheduler's position is {self.step_count}")

    def mark_loaded(self) -> None:
        if self._loaded:
            raise RuntimeError(DOUBLE_LOAD)
        self._loaded = True

    @property
    def is_loaded(self) -> bool:
        return self._loaded

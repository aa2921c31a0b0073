"""LR schedules: the port of modalities_tpu/optimizers/scheduler_factory.py.

Each scheduler component is its own config dataclass (the JAX config's
fields) and resolves to `schedule() -> fn(step) -> multiplier` of the
optimizer's base lr. The train step applies it as
`torch.optim.lr_scheduler.LambdaLR(optimizer, fn)`: the update of optimizer
step k uses base * fn(k), as optax reads `schedule(count)` before its
increment.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Optional

from modalities_tpu_torch.config.config import check_float, check_int, check_str


@dataclasses.dataclass
class DummyLRScheduler:
    optimizer: Any

    def schedule(self) -> Callable[[int], float]:
        return lambda step: 1.0


@dataclasses.dataclass
class StepLRScheduler:
    optimizer: Any
    step_size: int
    gamma: float
    last_epoch: int = -1

    def __post_init__(self):
        check_int("step_size", self.step_size, ge=1)
        self.gamma = check_float("gamma", self.gamma, ge=0.0)

    def schedule(self):
        return lambda step: self.gamma ** (step // self.step_size)


@dataclasses.dataclass
class ConstantLRScheduler:
    optimizer: Any
    factor: float
    total_iters: int
    last_epoch: int = -1

    def __post_init__(self):
        self.factor = check_float("factor", self.factor, ge=0.0)
        check_int("total_iters", self.total_iters, ge=1)

    def schedule(self):
        return lambda step: self.factor if step < self.total_iters else 1.0


@dataclasses.dataclass
class LinearLRScheduler:
    optimizer: Any
    start_factor: float
    end_factor: float
    total_iters: int
    last_epoch: int = -1

    def __post_init__(self):
        self.start_factor = check_float("start_factor", self.start_factor, gt=0.0)
        self.end_factor = check_float("end_factor", self.end_factor, ge=0.0)
        check_int("total_iters", self.total_iters, ge=1)

    def schedule(self):
        def fn(step):
            step = min(max(step, 0), self.total_iters)
            return self.start_factor + (self.end_factor - self.start_factor) * step / self.total_iters

        return fn


@dataclasses.dataclass
class CosineAnnealingLRScheduler:
    optimizer: Any
    t_max: int
    eta_min: float
    last_epoch: int = -1

    def __post_init__(self):
        check_int("t_max", self.t_max, ge=1)
        self.eta_min = check_float("eta_min", self.eta_min, ge=0.0)

    def schedule(self):
        base = self.optimizer.lr

        def fn(step):
            lr = self.eta_min + (base - self.eta_min) * 0.5 * (1 + math.cos(math.pi * step / self.t_max))
            return lr / base

        return fn


@dataclasses.dataclass
class OneCycleLRScheduler:
    """torch OneCycleLR semantics (one max_lr for every group)."""

    optimizer: Any
    max_lr: float
    total_steps: Optional[int] = None
    epochs: Optional[int] = None
    steps_per_epoch: Optional[int] = None
    pct_start: float = 0.3
    anneal_strategy: str = "cos"
    cycle_momentum: bool = False
    base_momentum: float = 0.85
    max_momentum: float = 0.95
    div_factor: float = 25.0
    final_div_factor: float = 1e4
    last_epoch: int = -1

    def __post_init__(self):
        self.max_lr = check_float("max_lr", self.max_lr)
        check_str("anneal_strategy", self.anneal_strategy)
        if self.total_steps is None and (self.epochs is None or self.steps_per_epoch is None):
            raise ValueError("OneCycleLR requires total_steps or (epochs and steps_per_epoch)")

    def schedule(self):
        total = self.total_steps if self.total_steps is not None else self.epochs * self.steps_per_epoch
        up = max(1, int(self.pct_start * total))
        down = max(1, total - up)
        initial = self.max_lr / self.div_factor
        final = initial / self.final_div_factor
        base = self.optimizer.lr

        def anneal(frac, start, end):
            if self.anneal_strategy == "cos":
                return end + (start - end) * 0.5 * (1 + math.cos(math.pi * frac))
            return start + (end - start) * frac

        def fn(step):
            if step <= up:
                return anneal(min(max(step / up, 0.0), 1.0), initial, self.max_lr) / base
            return anneal(min(max((step - up) / down, 0.0), 1.0), self.max_lr, final) / base

        return fn


@dataclasses.dataclass
class LinearWarmupCosineAnnealingLRScheduler:
    """Linear warmup from initial_lr to max_lr over warmup_steps, then cosine
    annealing to final_lr at total_steps (JAX scheduler_factory.py:156-177)."""

    optimizer: Any
    warmup_steps: int
    total_steps: int
    initial_lr: float
    final_lr: float
    max_lr: float
    last_epoch: int = -1

    def __post_init__(self):
        check_int("warmup_steps", self.warmup_steps, ge=1)
        check_int("total_steps", self.total_steps, ge=1)
        self.initial_lr = check_float("initial_lr", self.initial_lr, ge=0.0)
        self.final_lr = check_float("final_lr", self.final_lr, ge=0.0)
        self.max_lr = check_float("max_lr", self.max_lr, ge=0.0)
        check_int("last_epoch", self.last_epoch, ge=-1)

    def schedule(self):
        base = self.optimizer.lr

        def fn(step):
            if step < self.warmup_steps:
                lr = self.initial_lr + (self.max_lr - self.initial_lr) * step / max(1, self.warmup_steps)
            else:
                frac = min(max((step - self.warmup_steps) / max(1, self.total_steps - self.warmup_steps), 0.0), 1.0)
                lr = self.final_lr + (self.max_lr - self.final_lr) * 0.5 * (1 + math.cos(math.pi * frac))
            return lr / base

        return fn


SCHEDULERS = {
    "dummy_lr": DummyLRScheduler,
    "step_lr": StepLRScheduler,
    "constant_lr": ConstantLRScheduler,
    "linear_lr": LinearLRScheduler,
    "onecycle_lr": OneCycleLRScheduler,
    "cosine_annealing_lr": CosineAnnealingLRScheduler,
    "linear_warmup_cosine_annealing_lr": LinearWarmupCosineAnnealingLRScheduler,
}

"""Steppable profilers: the port of modalities_tpu/utils/profilers/profilers.py.

The same protocol (`with profiler:`, `profiler.step()` once a step, `len`)
steps the profiler harness (`profile distributed`) and a training config's
`profiler` node (trainer.py). Where JAX writes a `jax.profiler` xplane trace,
`SteppableKernelProfiler` records each active cycle of its schedule with
`torch.profiler.profile` and writes one Chrome trace a cycle
(`kernel_trace_rank_<r>_steps_<a>-<b>.json`, steps counted from 1), applying
the torch.profiler knobs JAX's config accepts and ignores
(`profiler_activities`, `profile_memory`, `record_shapes`, `with_flops`,
`with_modules`, `tracked_ranks`). Where JAX saves `memory.prof`,
`SteppableMemoryProfiler` dumps the caching allocator's snapshot with its
allocation history (`memory_snapshot.pickle`, for `torch.cuda.memory`'s
viewer), recorded from `__enter__`; the CPU has nothing to dump. On a card a
profiler failure raises.
"""

from __future__ import annotations

import dataclasses
import json
import logging
import os
from abc import ABC, abstractmethod
from pathlib import Path
from typing import Optional

from modalities_tpu_torch.config.config import check_bool, check_int

logger = logging.getLogger(__name__)

SNAPSHOT_FILE = "memory_snapshot.pickle"
_HISTORY_ENTRIES = 100_000  # allocator events kept for the snapshot


def _rank() -> int:
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return dist.get_rank()
    return int(os.environ.get("RANK", 0))


def _on_card() -> bool:
    import torch

    return torch.cuda.is_available()


class SteppableProfilerIF(ABC):
    """Protocol: `with profiler: ... profiler.step()` once per train step."""

    @abstractmethod
    def __enter__(self): ...

    @abstractmethod
    def __exit__(self, exc_type, exc_val, exc_tb): ...

    @abstractmethod
    def step(self) -> None: ...

    def __len__(self) -> int:
        """Number of steps the profiling schedule spans (0 = unbounded)."""
        return 0


class SteppableNoProfiler(SteppableProfilerIF):
    def __enter__(self):
        return self

    def __exit__(self, exc_type, exc_val, exc_tb):
        return False

    def step(self) -> None:
        pass


class SteppableKernelProfiler(SteppableProfilerIF):
    """wait / warmup / active steps, `repeat` cycles (JAX's schedule): the
    active steps of each cycle are recorded by `torch.profiler.profile` and
    written as one Chrome trace into `output_folder_path`. CPU activity
    always, CUDA activity on a card, unless `profiler_activities` names them.
    A rank outside `tracked_ranks` does not trace."""

    def __init__(self, output_folder_path: Path, wait_steps: int = 1, warmup_steps: int = 1, active_steps: int = 3,
                 repeat: int = 1, with_python_stack: bool = False, profiler_activities: Optional[list] = None,
                 profile_memory: Optional[bool] = None, record_shapes: Optional[bool] = None,
                 with_flops: Optional[bool] = None, with_modules: Optional[bool] = None,
                 tracked_ranks: Optional[list] = None):
        self.output_folder_path = Path(output_folder_path)
        self.wait_steps = wait_steps
        self.warmup_steps = warmup_steps
        self.active_steps = active_steps
        self.repeat = max(1, repeat)
        self.with_python_stack = with_python_stack
        self.profiler_activities = profiler_activities
        self.knobs = {"profile_memory": bool(profile_memory), "record_shapes": bool(record_shapes),
                      "with_flops": bool(with_flops), "with_modules": bool(with_modules)}
        self.tracked_ranks = tracked_ranks
        self.trace_paths: list[Path] = []
        self._step = 0
        self._profiler = None
        self._active_from = 0

    def __len__(self) -> int:
        return (self.wait_steps + self.warmup_steps + self.active_steps) * self.repeat

    def _cycle_position(self) -> tuple[int, int]:
        cycle_len = self.wait_steps + self.warmup_steps + self.active_steps
        return self._step // cycle_len, self._step % cycle_len

    def _activities(self) -> list:
        from torch.profiler import ProfilerActivity

        if self.profiler_activities is not None:
            return [ProfilerActivity[str(name).upper()] for name in self.profiler_activities]
        return [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if _on_card() else [])

    def _start(self) -> None:
        import torch
        from torch.profiler import profile

        if _on_card():
            torch.cuda.synchronize()  # earlier steps' device work stays out of the cycle
        self._profiler = profile(activities=self._activities(), with_stack=self.with_python_stack, **self.knobs)
        self._profiler.start()
        self._active_from = self._step
        logger.info("kernel profiler: trace started at step %d", self._step)

    def _stop(self) -> None:
        import torch

        if _on_card():
            torch.cuda.synchronize()  # the cycle's device work is in the trace
        self._profiler.stop()
        self.output_folder_path.mkdir(parents=True, exist_ok=True)
        path = self.output_folder_path / (f"kernel_trace_rank_{_rank()}_steps_{self._active_from + 1}-"
                                          f"{self._step}.json")
        self._profiler.export_chrome_trace(str(path))
        self._profiler = None
        self.trace_paths.append(path)
        logger.info("kernel profiler: trace stopped at step %d -> %s", self._step, path)

    def __enter__(self):
        self._maybe_toggle()
        return self

    def __exit__(self, exc_type, exc_val, exc_tb):
        if self._profiler is not None:
            self._stop()
        return False

    def _maybe_toggle(self) -> None:
        if self.tracked_ranks is not None and _rank() not in self.tracked_ranks:
            return
        cycle, pos = self._cycle_position()
        if cycle >= self.repeat:
            if self._profiler is not None:
                self._stop()
            return
        if pos == self.wait_steps + self.warmup_steps and self._profiler is None:
            self._start()
        elif pos == 0 and self._profiler is not None:
            self._stop()

    def step(self) -> None:
        self._step += 1
        self._maybe_toggle()


class SteppableMemoryProfiler(SteppableProfilerIF):
    """Per-step device memory stats -> memory_stats.jsonl (appended and
    flushed every step, so a run killed mid-profile keeps its samples), and
    on `__exit__` on a card the allocator's snapshot with the history
    recorded since `__enter__`."""

    def __init__(self, output_folder_path: Path, max_steps: int = 0):
        self.output_folder_path = Path(output_folder_path)
        self.max_steps = max_steps
        self.snapshot_path: Optional[Path] = None
        self._step = 0
        self._file = None
        self._recording = False

    def __len__(self) -> int:
        return self.max_steps

    def _open(self) -> None:
        self.output_folder_path.mkdir(parents=True, exist_ok=True)
        self._file = open(self.output_folder_path / "memory_stats.jsonl", "w")

    def __enter__(self):
        self._open()
        if _on_card():
            import torch

            torch.cuda.memory._record_memory_history(max_entries=_HISTORY_ENTRIES, stacks="python")
            self._recording = True
        return self

    def __exit__(self, exc_type, exc_val, exc_tb):
        if self._file is not None and not self._file.closed:
            self._file.close()
        if not self._recording:
            logger.info("memory profiler: no device allocator to snapshot on the CPU")
            return False
        import torch

        self.snapshot_path = self.output_folder_path / SNAPSHOT_FILE
        try:
            torch.cuda.memory._dump_snapshot(str(self.snapshot_path))
        finally:
            torch.cuda.memory._record_memory_history(enabled=None)
            self._recording = False
        logger.info("memory profiler: allocator snapshot -> %s", self.snapshot_path)
        return False

    def step(self) -> None:
        from modalities_tpu_torch.telemetry.device_memory import worst_case_memory_stats

        record = {"step": self._step, **worst_case_memory_stats()}
        self._step += 1
        if self._file is None:  # step() without __enter__ (harness misuse): open lazily
            self._open()
        if not self._file.closed:
            self._file.write(json.dumps(record) + "\n")
            self._file.flush()


class SteppableCombinedProfiler(SteppableProfilerIF):
    def __init__(self, profilers: list[SteppableProfilerIF]):
        self.profilers = profilers

    def __len__(self) -> int:
        return max((len(p) for p in self.profilers), default=0)

    def __enter__(self):
        for p in self.profilers:
            p.__enter__()
        return self

    def __exit__(self, exc_type, exc_val, exc_tb):
        for p in self.profilers:
            p.__exit__(exc_type, exc_val, exc_tb)
        return False

    def step(self) -> None:
        for p in self.profilers:
            p.step()


# ------------------------------------------------------------------- configs

_KERNEL_ALIASES = {"num_wait_steps": "wait_steps", "num_warmup_steps": "warmup_steps",
                   "num_active_steps": "active_steps", "with_stack": "with_python_stack"}


@dataclasses.dataclass
class SteppableKernelProfilerConfig:
    """JAX's field names and the reference names it accepts (`num_wait_steps`,
    `num_warmup_steps`, `num_active_steps`, `with_stack`); the torch.profiler
    knobs are applied as the `torch.profiler.profile` arguments they name."""

    output_folder_path: Path
    wait_steps: Optional[int] = None
    warmup_steps: Optional[int] = None
    active_steps: Optional[int] = None
    repeat: int = 1
    with_python_stack: Optional[bool] = None
    num_wait_steps: Optional[int] = None
    num_warmup_steps: Optional[int] = None
    num_active_steps: Optional[int] = None
    with_stack: Optional[bool] = None
    profiler_activities: Optional[list] = None
    profile_memory: Optional[bool] = None
    record_shapes: Optional[bool] = None
    with_flops: Optional[bool] = None
    with_modules: Optional[bool] = None
    tracked_ranks: Optional[list] = None

    def __post_init__(self):
        self.output_folder_path = Path(self.output_folder_path)
        for alias, name in _KERNEL_ALIASES.items():
            value = getattr(self, alias)
            if value is not None:
                if getattr(self, name) is not None:
                    raise ValueError(f"give {name} or its alias {alias}, not both")
                setattr(self, name, value)
            setattr(self, alias, None)
        for name, default in (("wait_steps", 1), ("warmup_steps", 1), ("active_steps", 3)):
            setattr(self, name, check_int(name, default if getattr(self, name) is None else getattr(self, name),
                                          ge=0))
        check_int("repeat", self.repeat, ge=1)
        self.with_python_stack = bool(check_bool("with_python_stack", self.with_python_stack, optional=True))
        for name in ("profile_memory", "record_shapes", "with_flops", "with_modules"):
            check_bool(name, getattr(self, name), optional=True)
        for name in ("profiler_activities", "tracked_ranks"):
            if getattr(self, name) is not None and not isinstance(getattr(self, name), list):
                raise ValueError(f"{name}: expected a list, got {getattr(self, name)!r}")


def steppable_kernel_profiler(**config) -> SteppableKernelProfiler:
    """The registry's component: the validated config without its alias fields."""
    return SteppableKernelProfiler(**{k: v for k, v in config.items() if k not in _KERNEL_ALIASES})


@dataclasses.dataclass
class SteppableMemoryProfilerConfig:
    output_folder_path: Path
    max_steps: int = 0

    def __post_init__(self):
        self.output_folder_path = Path(self.output_folder_path)
        check_int("max_steps", self.max_steps, ge=0)


@dataclasses.dataclass
class SteppableCombinedProfilerConfig:
    profilers: list

    def __post_init__(self):
        if not isinstance(self.profilers, list):
            raise ValueError(f"profilers: expected a list, got {self.profilers!r}")

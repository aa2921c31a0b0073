"""Performance-attribution scope: the port of
modalities_tpu/telemetry/perfscope.py.

1. **The static cost walk.** JAX buckets the instructions of a compiled
   step's optimized HLO. torch compiles nothing to read, so `StaticWalk`
   runs one train step of the config's card path on fake tensors (no
   storage, no device: utils/recipe_validation.py builds the step on a fake
   process group of the config's world size) and buckets every op a
   `TorchDispatchMode` sees, with its FLOPs, bytes and roofline time, into
   JAX's classes: `matmul` (aten mm / addmm / bmm / baddbmm / _scaled_mm),
   `custom_call` (the hand-written kernels, each one op with the work of the
   kernel table's bound formulas: ops/static_walk.py), `collective:<axis>`
   (each c10d op by the mesh dim of its process group), `host_transfer`
   (copies across host and device, a host read of a device value),
   `elementwise` (pointwise and reduction ops) and `other`. Views and
   metadata ops are skipped, as JAX skips its bookkeeping instructions.
   Eager torch fuses nothing, so each op carries its operands' and results'
   bytes (JAX: a fusion carries the traffic, its inner ops the flops). The
   total is the sum of the buckets by construction, in integers.
   `torch.utils.flop_counter.FlopCounterMode`'s total of the same step rides
   beside it (`flop_counter`) where JAX puts XLA's cost analysis. `HwSpec`
   holds the datasheet figures of an NVIDIA H100 80GB HBM3, 700.00 W.
2. **Profiler capture windows.** `ProfileWindow.from_env()` parses
   `MODALITIES_TPU_PROFILE_AT_STEP=N[:K]` and records steps [N, N+K) with
   `torch.profiler.profile` (CPU activity, plus CUDA on a card), then writes
   a Chrome trace (`profile_rank_<r>_steps_<N>-<N+K-1>.json`) into
   `MODALITIES_TPU_PROFILE_DIR`, or else the folder the trainer passes (its
   telemetry folder). The trainer calls `maybe_start`/`maybe_stop`
   unconditionally; both are no-ops outside the window. Capture never
   changes a step's result: only host-side trace collection toggles. A
   profiler failure is logged, never raised, as in the JAX package.
3. **Anomaly detection.** `AnomalyDetector` keeps a rolling window and scores
   each observation with a robust z (median/MAD, 0.6745 normalization) plus an
   EWMA; the `Telemetry` facade feeds per-step wall time and per-goodput-bucket
   deltas through detectors into the metrics registry
   (`training_step_time_anomaly_total`, `training_goodput_bucket_zscore`).

The module doubles as a subprocess entry point: `python -m
modalities_tpu_torch.telemetry.perfscope <config.yaml>` walks the config's
train step on its fake world and prints the report JSON (`data
analyze_perfscope`).
"""

from __future__ import annotations

import json
import logging
import math
import os
import statistics
from collections import deque
from dataclasses import dataclass
from pathlib import Path
from typing import Optional, Union

from torch.utils._python_dispatch import TorchDispatchMode

logger = logging.getLogger(__name__)

PROFILE_ENV = "MODALITIES_TPU_PROFILE_AT_STEP"
PROFILE_DIR_ENV = "MODALITIES_TPU_PROFILE_DIR"


def write_report(report: dict, path: Union[str, Path]) -> Path:
    """Atomic JSON write (a temp file, then a rename)."""
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    tmp = path.with_suffix(path.suffix + ".tmp")
    with open(tmp, "w") as f:
        json.dump(report, f, indent=1)
    tmp.rename(path)
    return path


def parse_window(raw: str, env_name: str, what: str) -> tuple[int, int]:
    """`N` -> (N, 1), `N:K` -> (N, K); anything else raises JAX's ValueError."""
    try:
        if ":" in raw:
            start_s, num_s = raw.split(":", 1)
            return int(start_s), int(num_s)
        return int(raw), 1
    except ValueError as e:
        raise ValueError(f"{env_name}={raw!r}: expected N or N:K ({what} K steps starting at step N)") from e


# ------------------------------------------------------------ the static walk


@dataclass
class HwSpec:
    """Roofline constants of the time estimate: the datasheet figures of an
    NVIDIA H100 80GB HBM3, 700.00 W (dense tensor-core peaks in bf16/fp16
    and fp8, fp32 outside the tensor cores, HBM3 rate, NVLink's rate a
    direction), the bounds of PERF.md's kernel table. An op is priced at the
    peak of the units it runs on: a matmul by its operands' dtype (the port
    runs fp32 matmuls without TF32), an elementwise op on the CUDA cores.
    The collective figures are not measured: one card has no peer. Bucket
    shares are what the report is for, not absolute seconds."""

    peak_flops: float = 989.4e12  # bf16 / fp16 tensor-core FLOP/s
    peak_flops_fp8: float = 1979e12  # fp8 tensor-core FLOP/s
    peak_flops_fp32: float = 67e12  # fp32 FLOP/s outside the tensor cores
    hbm_bw: float = 3.35e12  # bytes/s
    collective_bw: float = 450e9  # bytes/s over NVLink, one direction
    collective_latency_s: float = 0.0  # per-op cost: not measured

    def peak(self, dtype) -> float:
        """FLOP/s of a matmul whose operands are `dtype`."""
        import torch

        if dtype in (torch.float32, torch.float64):
            return self.peak_flops_fp32
        if dtype.is_floating_point and dtype.itemsize == 1:
            return self.peak_flops_fp8
        return self.peak_flops

    def as_dict(self) -> dict:
        return {
            "peak_flops": self.peak_flops,
            "peak_flops_fp8": self.peak_flops_fp8,
            "peak_flops_fp32": self.peak_flops_fp32,
            "hbm_bw": self.hbm_bw,
            "collective_bw": self.collective_bw,
            "collective_latency_s": self.collective_latency_s,
        }


_MATMUL_OPS = frozenset(("mm", "addmm", "bmm", "baddbmm", "_scaled_mm"))
# no data moved and no flops: allocations, shape queries, aliases (views are skipped by their schema)
_SKIP_OPS = frozenset(("empty", "empty_like", "empty_strided", "new_empty", "new_empty_strided", "_unsafe_view",
                       "lift_fresh", "set_", "resize_", "sym_size", "sym_stride", "sym_numel", "sym_storage_offset",
                       "record_stream", "is_same_size"))
_COPY_OPS = frozenset(("_to_copy", "copy_", "clone"))
_COLLECTIVE_NAMESPACES = frozenset(("c10d", "_c10d_functional", "c10d_functional"))
_WAIT_OPS = frozenset(("wait_tensor", "wait"))
_IN_PLACE_UPDATES = frozenset(("_fused_adamw_", "_fused_adam_"))


def _tensors(tree) -> list:
    import torch

    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, (list, tuple)):
        return [t for item in tree for t in _tensors(item)]
    if isinstance(tree, dict):
        return [t for item in tree.values() for t in _tensors(item)]
    return []


def _nbytes(t) -> int:
    return int(t.numel()) * t.element_size()


def _group_of(args) -> tuple[Optional[str], int]:
    """(name, size) of the process group a c10d op runs over: its
    ProcessGroup argument, or the group a functional collective names."""
    import torch
    import torch.distributed as dist
    from torch.distributed.distributed_c10d import _resolve_process_group

    for a in args:
        if isinstance(a, torch.ScriptObject):
            try:
                group = dist.ProcessGroup.unbox(a)
            except RuntimeError:  # another script object (a ReduceOp, a Work)
                continue
            return group.group_name, group.size()
        if isinstance(a, str):
            return a, _resolve_process_group(a).size()
    return None, 0


def _group_axes(device_mesh) -> dict[str, str]:
    """group name -> the mesh dim it serves (the first dim in mesh order, so
    a dim of the whole world is named, not the world)."""
    if device_mesh is None or getattr(device_mesh, "_torch_mesh", None) is None:
        return {}
    mesh, axes = device_mesh._torch_mesh, {}
    for name in (*device_mesh.mesh_axes, "dp_shard_cp", "batch"):
        try:
            group = mesh[name].get_group()
        except (KeyError, RuntimeError, ValueError):
            continue
        axes.setdefault(group.group_name, name)
    return axes


class StaticWalk(TorchDispatchMode):
    """Buckets every op of the block (one train step on fake tensors, built
    by utils/recipe_validation.py) and every kernel the stand-ins of
    ops/static_walk.py record while the block runs; `report()` gives JAX's report schema. An op
    on a DTensor is counted where its local ops run, once."""

    def __init__(self, device_mesh=None, hw: Optional[HwSpec] = None, top_ops: int = 5):
        super().__init__()
        self.hw = hw or HwSpec()
        self.top_ops = top_ops
        self.mesh_axes = dict(device_mesh.mesh_axes) if device_mesh is not None else {}
        self._axes = _group_axes(device_mesh)
        self.buckets: dict[str, dict] = {}

    def __enter__(self):
        from torch.utils.flop_counter import FlopCounterMode

        from modalities_tpu_torch.ops.static_walk import walking

        self._stand_ins = walking(self)
        self._stand_ins.__enter__()
        out = super().__enter__()
        self.flop_counter = FlopCounterMode(display=False)  # above this mode: it sees each op once too
        self.flop_counter.__enter__()
        return out

    def __exit__(self, exc_type, exc_val, exc_tb):
        try:
            self.flop_counter.__exit__(exc_type, exc_val, exc_tb)
            return super().__exit__(exc_type, exc_val, exc_tb)
        finally:
            self._stand_ins.__exit__(exc_type, exc_val, exc_tb)

    def _add(self, bucket: str, label: str, flops: int, nbytes: int, est: float) -> None:
        b = self.buckets.get(bucket)
        if b is None:
            b = self.buckets[bucket] = {"ops": 0, "flops": 0, "bytes": 0, "est_time_s": 0.0, "top_ops": {}}
        b["ops"] += 1
        b["flops"] += int(flops)
        b["bytes"] += int(nbytes)
        b["est_time_s"] += est
        top = b["top_ops"].setdefault(label, {"op": label, "calls": 0, "flops": 0, "bytes": 0, "est_time_s": 0.0})
        top["calls"] += 1
        top["flops"] += int(flops)
        top["bytes"] += int(nbytes)
        top["est_time_s"] += est

    def _roofline(self, flops: int, nbytes: int, peak: float) -> float:
        return max(flops / peak, nbytes / self.hw.hbm_bw)

    def custom_call(self, name: str, flops: int, nbytes: int, what: str = "", tensor_cores: bool = True) -> None:
        """One hand-written kernel, as its stand-in records it."""
        peak = self.hw.peak_flops if tensor_cores else self.hw.peak_flops_fp32
        self._add("custom_call", name, flops, nbytes, self._roofline(flops, nbytes, peak))

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch.distributed.tensor import DTensor

        kwargs = kwargs or {}
        namespace, name = func.namespace, func._schema.name.split("::")[-1]
        # the fused Adam updates write their operands in place and return nothing; torch has no fake kernel for
        # the tensor-rate overload the train step runs (the fake mode would run the CPU kernel on real copies)
        out = None if name in _IN_PLACE_UPDATES else func(*args, **kwargs)
        if func.is_view or namespace in ("profiler", "prim") or name in _SKIP_OPS or name in _WAIT_OPS:
            return out
        inputs = _tensors((args, kwargs))
        if any(isinstance(t, DTensor) for t in inputs):
            return out  # its local ops come through here on their own
        outputs = _tensors(out)
        seen, read = set(), 0
        for t in inputs:
            if id(t) not in seen:
                seen.add(id(t))
                read += _nbytes(t)
        nbytes = read + sum(_nbytes(t) for t in outputs)
        label = str(func)
        if namespace in _COLLECTIVE_NAMESPACES:
            group, size = _group_of(args)
            axis = self._axes.get(group) or (f"size{size}" if size > 1 else "all")  # JAX's tags for the unnamed
            self._add(f"collective:{axis}", label, 0, nbytes,
                      nbytes / self.hw.collective_bw + self.hw.collective_latency_s)
        elif name == "_local_scalar_dense" or name in _COPY_OPS and len({t.device.type for t in inputs + outputs}) > 1:
            self._add("host_transfer", label, 0, nbytes, nbytes / self.hw.hbm_bw)
        elif name in _MATMUL_OPS:
            a, b = (args[1], args[2]) if name in ("addmm", "baddbmm") else (args[0], args[1])
            flops = 2 * int(a.numel()) * int(b.shape[-1])
            self._add("matmul", label, flops, nbytes, self._roofline(flops, nbytes, self.hw.peak(a.dtype)))
        elif name not in _COPY_OPS and (_elementwise(func) or name.startswith("_foreach_")
                                         or name in _IN_PLACE_UPDATES):
            flops = max((int(t.numel()) for t in inputs + outputs), default=0)
            self._add("elementwise", label, flops, nbytes, self._roofline(flops, nbytes, self.hw.peak_flops_fp32))
        else:
            self._add("other", label, 0, nbytes, nbytes / self.hw.hbm_bw)
        return out

    def report(self, module: str = "train_step") -> dict:
        """JAX's report schema over what the block recorded; the total is the
        sum of the buckets."""
        buckets = {}
        for name in sorted(self.buckets):
            b = self.buckets[name]
            top = sorted(b["top_ops"].values(), key=lambda o: -o["est_time_s"])
            top = top if name == "custom_call" else top[:self.top_ops]  # every kernel: at most nine
            buckets[name] = {**{k: b[k] for k in ("ops", "flops", "bytes")},
                             "est_time_s": round(b["est_time_s"], 12),
                             "top_ops": [{**o, "est_time_s": round(o["est_time_s"], 12)} for o in top]}
        total = {
            "ops": sum(b["ops"] for b in buckets.values()),
            "flops": sum(b["flops"] for b in buckets.values()),
            "bytes": sum(b["bytes"] for b in buckets.values()),
            "est_time_s": round(sum(b["est_time_s"] for b in buckets.values()), 12),
        }
        return {"module": module, "mesh_axes": dict(self.mesh_axes), "hw": self.hw.as_dict(), "buckets": buckets,
                "total": total, "flop_counter": {"flops": int(self.flop_counter.get_total_flops())}}


def _elementwise(func) -> bool:
    """Pointwise and reduction ops, by their schema's tags (a torch without
    the reduction tag names none)."""
    import torch

    tags = set(func.tags)
    return torch.Tag.pointwise in tags or getattr(torch.Tag, "reduction", None) in tags


def format_perfscope_table(report: dict) -> str:
    """Aligned text table for one or many module reports ({"executables": ...}
    or a single report): JAX's text, with the FlopCounterMode cross-check
    line where the report has one."""
    modules = report.get("executables") or {report.get("module") or "module": report}
    lines = []
    for name, mod in modules.items():
        total = mod["total"]
        lines.append(
            f"{name}: {total['ops']} ops, {total['flops'] / 1e9:.3f} GFLOP, "
            f"{total['bytes'] / 1e6:.3f} MB, est {total['est_time_s'] * 1e3:.4f} ms"
        )
        lines.append(f"  {'bucket':<24} {'ops':>6} {'GFLOP':>10} {'MB':>10} {'est ms':>10} {'share':>7}")
        for bucket, b in sorted(
            mod["buckets"].items(), key=lambda kv: -kv[1]["est_time_s"]
        ):
            share = b["est_time_s"] / total["est_time_s"] if total["est_time_s"] else 0.0
            lines.append(
                f"  {bucket:<24} {b['ops']:>6} {b['flops'] / 1e9:>10.3f} "
                f"{b['bytes'] / 1e6:>10.3f} {b['est_time_s'] * 1e3:>10.4f} {share:>6.1%}"
            )
        xla = mod.get("xla_cost_analysis") or {}
        if "flops" in xla:
            lines.append(
                f"  xla cost_analysis cross-check: {xla['flops'] / 1e9:.3f} GFLOP, "
                f"{xla.get('bytes accessed', 0.0) / 1e6:.3f} MB"
            )
        counted = mod.get("flop_counter") or {}
        if "flops" in counted:
            lines.append(f"  torch FlopCounterMode cross-check: {counted['flops'] / 1e9:.3f} GFLOP")
        lines.append("")
    return "\n".join(lines).rstrip()


def kernel_counts(report: dict) -> dict[str, int]:
    """Kernel name -> the walk's calls of it in one step (the custom_call
    bucket lists every kernel)."""
    bucket = report.get("buckets", {}).get("custom_call") or {}
    return {o["op"]: o["calls"] for o in bucket.get("top_ops", [])}


def perfscope_for_config(config_file_path: Union[str, Path], warmstart_checkpoint_folder: Optional[str] = None,
                         hw: Optional[HwSpec] = None) -> dict:
    """One train step of the config walked on its fake world
    (utils/recipe_validation.py:build_train_step; for a profiler-harness
    config its forward pass's step): the report, under JAX's {config,
    world_size, executables: {train_step: ...}}."""
    from modalities_tpu_torch.utils.recipe_validation import build_train_step

    with build_train_step(Path(config_file_path), warmstart_checkpoint_folder) as built:
        walk = StaticWalk(built.device_mesh, hw)
        with walk:
            built.run()
        report = walk.report()
    return {"config": str(config_file_path), "world_size": built.world_size, "executables": {"train_step": report}}


def run_perfscope_subprocess(config_file_path: Union[str, Path],
                             warmstart_checkpoint_folder: Optional[str] = None) -> dict:
    """`python -m modalities_tpu_torch.telemetry.perfscope` in a child
    process with no card visible: works from any process (one that holds a
    process group or a card)."""
    from modalities_tpu_torch.utils.recipe_validation import run_module_subprocess

    args = ["--warmstart_checkpoint_folder", warmstart_checkpoint_folder] if warmstart_checkpoint_folder else []
    return run_module_subprocess("modalities_tpu_torch.telemetry.perfscope", Path(config_file_path), *args)


# ------------------------------------------------------------- profiler windows


class ProfileWindow:
    """A `torch.profiler` capture armed by env var: started right before step
    N, stopped after step N+K-1 (`MODALITIES_TPU_PROFILE_AT_STEP=N` or `N:K`),
    its Chrome trace written to `out_dir` (`MODALITIES_TPU_PROFILE_DIR`, or
    the `fallback_dir` the trainer passes)."""

    def __init__(self, start_step: int, num_steps: int = 1, out_dir: Optional[Path] = None, global_rank: int = 0):
        if num_steps < 1:
            raise ValueError(f"profile window needs num_steps >= 1, got {num_steps}")
        self.start_step = int(start_step)
        self.num_steps = int(num_steps)
        self.out_dir = Path(out_dir) if out_dir is not None else None
        self.global_rank = int(global_rank)
        self.active = False
        self.completed = False
        self.trace_path: Optional[Path] = None
        self._profiler = None

    @classmethod
    def from_env(cls, fallback_dir: Optional[Path] = None, global_rank: int = 0) -> Optional["ProfileWindow"]:
        raw = os.environ.get(PROFILE_ENV, "").strip()
        if not raw:
            return None
        start, num = parse_window(raw, PROFILE_ENV, "capture")
        out = os.environ.get(PROFILE_DIR_ENV)
        return cls(start, num, Path(out) if out else fallback_dir, global_rank=global_rank)

    def maybe_start(self, step_id: int) -> bool:
        """Call before dispatching `step_id`; starts the capture on the
        window's first step. Returns True while capture runs."""
        if self.active:
            return True
        if self.completed or step_id != self.start_step:
            return False
        try:
            import torch
            from torch.profiler import ProfilerActivity, profile

            activities = [ProfilerActivity.CPU]
            if torch.cuda.is_available():
                activities.append(ProfilerActivity.CUDA)
                torch.cuda.synchronize()  # earlier steps' device work stays out of the window
            self._profiler = profile(activities=activities)
            self._profiler.start()
            self.active = True
            logger.info("perfscope: profiler capture started at step %d for %d step(s) -> %s", step_id,
                        self.num_steps, self._out_dir())
        except Exception:
            logger.exception("perfscope: profiler start failed; window disabled")
            self._profiler = None
            self.completed = True
        return self.active

    def _out_dir(self) -> Path:
        return self.out_dir or Path(os.getcwd()) / "profile"

    def maybe_stop(self, step_id: int, block_on=None) -> bool:
        """Call after `step_id` completed; stops the capture once the window's
        last step is done and writes the trace. Returns True if capture
        stopped on this call. The card is synchronized first (JAX blocks on
        `block_on`), so the captured steps' device work is in the trace."""
        if not self.active or step_id < self.start_step + self.num_steps - 1:
            return False
        try:
            import torch

            if torch.cuda.is_available():
                torch.cuda.synchronize()
            self._profiler.stop()
            end = self.start_step + self.num_steps - 1
            out_dir = self._out_dir()
            out_dir.mkdir(parents=True, exist_ok=True)
            path = out_dir / f"profile_rank_{self.global_rank}_steps_{self.start_step}-{end}.json"
            self._profiler.export_chrome_trace(str(path))
            self.trace_path = path
            logger.info("perfscope: profiler capture stopped after step %d -> %s", step_id, path)
        except Exception:
            logger.exception("perfscope: profiler stop failed")
        self._profiler = None
        self.active = False
        self.completed = True
        return True


# ----------------------------------------------------------- anomaly detection


@dataclass
class Anomaly:
    value: float
    zscore: float
    ewma: float
    is_anomaly: bool


class AnomalyDetector:
    """Rolling robust z-score + EWMA over a univariate stream (per-step wall
    time, per-bucket goodput seconds). Robust z = 0.6745 * (v - median) / MAD —
    outliers in the window don't inflate their own yardstick the way a plain
    stdev z does. No verdicts until `min_history` observations; a zero MAD
    (constant window) scores any deviation as `inf`."""

    def __init__(
        self,
        window: int = 64,
        zscore_threshold: float = 6.0,
        min_history: int = 8,
        ewma_alpha: float = 0.2,
    ):
        if window < 2:
            raise ValueError(f"anomaly window must be >= 2, got {window}")
        self.window: deque[float] = deque(maxlen=int(window))
        self.zscore_threshold = float(zscore_threshold)
        self.min_history = max(2, int(min_history))
        self.ewma_alpha = float(ewma_alpha)
        self.ewma: Optional[float] = None
        self.anomalies = 0

    def observe(self, value: float) -> Anomaly:
        value = float(value)
        self.ewma = (
            value if self.ewma is None
            else self.ewma_alpha * value + (1.0 - self.ewma_alpha) * self.ewma
        )
        z = 0.0
        if len(self.window) >= self.min_history:
            med = statistics.median(self.window)
            mad = statistics.median(abs(v - med) for v in self.window)
            dev = value - med
            if mad > 0.0:
                z = 0.6745 * dev / mad
            elif dev != 0.0:
                z = math.copysign(math.inf, dev)
        is_anomaly = z > self.zscore_threshold  # one-sided: slow is the anomaly
        if is_anomaly:
            self.anomalies += 1
        self.window.append(value)
        return Anomaly(value=value, zscore=z, ewma=self.ewma, is_anomaly=is_anomaly)


# ---------------------------------------------------------- subprocess entry


def _main() -> None:
    import argparse

    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("config_file_path", type=Path)
    parser.add_argument("--warmstart_checkpoint_folder", default=None)
    args = parser.parse_args()
    print(json.dumps(perfscope_for_config(args.config_file_path,
                                          warmstart_checkpoint_folder=args.warmstart_checkpoint_folder)))


if __name__ == "__main__":
    _main()

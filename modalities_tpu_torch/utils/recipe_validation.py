"""Recipe validation: the port of modalities_tpu/utils/recipe_validation.py.

Answers two questions about a multi-card training config on a CPU host,
without a card and without a parameter's memory:

1. Does the train step BUILD and WALK? `build_train_step` builds the
   config's components on a fake process group of its
   `device_mesh.world_size` (rank 0's view) under `FakeTensorMode`, through
   the port's own `Main` / `TrainStep` path: every FSDP2 / tp / cp / pp
   placement is made as a launcher's rank 0 would make it, with tensors that
   hold shapes and no storage. `validate_recipe` then runs one step on them
   (the static walk of telemetry/perfscope.py: the kernels' stand-ins, the
   collectives recorded by the fake group).
2. Does the state FIT? Parameters, optimizer state and gradients are this
   rank's DTensor local shards (parameters with FSDP2's dim-0 padding, the
   storage it allocates); activations are `_estimate_activation_bytes`, the
   JAX formula. The total is held against the card's memory: the default
   budget is the total `torch.cuda.mem_get_info` reports on an NVIDIA H100
   80GB HBM3, 700.00 W, 85,017,493,504 bytes (79.18 GiB); with a card
   present, the card's own total.

The fake group is destroyed on every exit, so a process can build again.
"""

from __future__ import annotations

import contextlib
import os
from pathlib import Path
from typing import Iterator, Optional

# `torch.cuda.mem_get_info()[1]` of an NVIDIA H100 80GB HBM3, 700.00 W (chip_smoke.py phase 4)
H100_HBM_BUDGET_BYTES = 85_017_493_504

# A checkpoint folder name every number_conversion pattern accepts: a
# warmstart recipe validated without a checkpoint on disk (the JAX module's)
_FAKE_WARMSTART_FOLDER = (
    "data/checkpoints/validation/eid-seen_steps_100000-seen_tokens_13107200000"
    "-target_steps_100000-target_tokens_13107200000"
)
_RANK_VARS = ("RANK", "WORLD_SIZE", "LOCAL_RANK")


def default_budget_bytes() -> int:
    """The card's total memory, or without a card the H100's."""
    import torch

    if torch.cuda.is_available():
        return int(torch.cuda.mem_get_info()[1])
    return H100_HBM_BUDGET_BYTES


def _estimate_activation_bytes(model, mesh_handle, step_profile) -> dict:
    """Documented per-chip activation estimate for the GPT2LLM family.

    Let b = local microbatch rows, s_l = seq / cp, d_l = n_embd / tp, f_l = ffn / tp,
    act = 2 bytes (bf16 compute). Per layer the live set during backward is:
      - full remat: only the block input residual stream survives the forward
        (b*s_l*d_l) plus ONE block's recompute working set (counted once, not per
        layer): ~ b*s_l*(4*d_l + 3*f_l).
      - no remat: qkv+attn-out+norms+residuals ~ 10*d_l plus swiglu gate/up/act
        ~ 3*f_l per token, all stored for backward.
    Flash/ring attention never materializes the [s, s] score matrix, so no s^2 term.
    The lm head adds b*s_l*vocab/tp fp32 logits UNLESS lm_head_chunk_size caps it at
    b*chunk*vocab/tp.

    `mesh_handle` needs `degrees` and `enable_loss_parallel` (the port's
    `running_env/device_mesh.py:DeviceMesh`); `step_profile` needs
    `local_train_micro_batch_size` and `sequence_length`.
    """
    spec = getattr(model, "config_spec", None)
    required = ("n_embd", "n_layer", "vocab_size", "activation", "ffn_hidden")
    if spec is None or any(not hasattr(spec, a) for a in required):
        # validating a non-GPT2 recipe (CoCa/ViT/...): state bytes are still exact,
        # but the activation formula is GPT2LLM-specific — report that clearly
        # instead of crashing mid-report with an AttributeError
        return {
            "remat_mode": None,
            "layer_activation_bytes": 0,
            "lm_head_bytes": 0,
            "total": 0,
            "unavailable": (
                f"activation estimate unavailable for model family "
                f"{type(model).__name__}: the formula is GPT2LLM-specific; "
                "per-chip totals below cover params/optimizer/gradients only"
            ),
        }
    degrees = mesh_handle.degrees
    tp = max(1, degrees.get("tp", 1))
    cp = max(1, degrees.get("cp", 1))
    pp = max(1, degrees.get("pp", 1))

    b = step_profile.local_train_micro_batch_size
    s_l = step_profile.sequence_length // cp
    d_l = spec.n_embd // tp
    ffn = spec.swiglu_hidden if spec.activation == "swiglu" else spec.ffn_hidden
    f_l = (ffn or 4 * spec.n_embd) // tp
    n_layer_local = -(-spec.n_layer // pp)
    act = 2  # bf16

    mode = str(getattr(spec, "remat_variant", None) or "none")
    tokens = b * s_l
    if "full" in mode:
        per_layer = tokens * d_l * act
        working_set = tokens * (4 * d_l + 3 * f_l) * act  # one block recompute
        layer_bytes = n_layer_local * per_layer + working_set
    elif "selective" in mode:
        # between full and none; assume half the no-remat live set
        layer_bytes = n_layer_local * tokens * (10 * d_l + 3 * f_l) * act // 2
    else:
        layer_bytes = n_layer_local * tokens * (10 * d_l + 3 * f_l) * act

    chunk = getattr(spec, "lm_head_chunk_size", None)
    vocab_l = spec.vocab_size // tp if mesh_handle.enable_loss_parallel else spec.vocab_size
    head_rows = b * (chunk if chunk else s_l)
    head_bytes = head_rows * vocab_l * 4  # fp32 logits for the live chunk / sequence

    return {
        "remat_mode": mode,
        "layer_activation_bytes": int(layer_bytes),
        "lm_head_bytes": int(head_bytes),
        "total": int(layer_bytes + head_bytes),
    }


# ------------------------------------------------------------- the fake world


@contextlib.contextmanager
def fake_world(world_size: int) -> Iterator[None]:
    """Rank 0 of a fake process group of `world_size` (collectives return at
    once and move nothing) with the launcher's variables set to match; the
    group is destroyed (with DTensor's caches) and the variables restored on
    every exit."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore

    from modalities_tpu_torch.running_env import env

    if dist.is_initialized():
        raise RuntimeError("a process group exists: the fake world of a recipe's build needs the process to itself")
    saved = {name: os.environ.get(name) for name in _RANK_VARS}
    os.environ.update(RANK="0", WORLD_SIZE=str(world_size), LOCAL_RANK="0")
    try:
        dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=world_size)
        yield
    finally:
        env.destroy_process_group()
        for name, value in saved.items():
            if value is None:
                os.environ.pop(name, None)
            else:
                os.environ[name] = value


class BuiltTrainStep:
    """What `validate_recipe` and the static reports need from one fake
    build: the train step, the components, the mesh component (None for a
    harness config without one), a batch of the step's shapes (this rank's
    rows), the world size, and `run()`: the step as the trainer (or the
    profiler harness) runs it."""

    def __init__(self, train_step, components, device_mesh, batch, world_size, forward_only: bool = False):
        self.train_step = train_step
        self.components = components
        self.device_mesh = device_mesh
        self.batch = batch
        self.world_size = world_size
        self.forward_only = forward_only

    def run(self) -> dict:
        if self.forward_only:
            return self.train_step.eval_step({part: {k: v[0] for k, v in tensors.items()}
                                              for part, tensors in self.batch.items()})
        return self.train_step(self.batch)


def _world_size_of(raw: dict, config_file_path: Path) -> int:
    try:
        return int(raw["device_mesh"]["config"]["world_size"])
    except (KeyError, TypeError, ValueError) as e:
        raise ValueError(f"{config_file_path}: could not read a literal device_mesh.config.world_size — the fake "
                         "world of the recipe's build needs it") from e


def _batch(keys: tuple[str, str], shape: tuple[int, int, int]) -> dict:
    import torch

    tokens = torch.zeros(shape, dtype=torch.int64)
    return {"samples": {keys[0]: tokens}, "targets": {keys[1]: tokens}}


@contextlib.contextmanager
def _fake_build_patches() -> Iterator[None]:
    """What a build under FakeTensorMode cannot run as it stands: a device
    mesh FSDP2 makes (over tp's and dp's) computes its coordinates from a
    real rank table, so it is made outside the fake mode; a truncated normal
    draw reads values, which fake tensors do not hold, so it draws nothing."""
    from unittest import mock

    import torch
    from torch._subclasses.fake_tensor import unset_fake_temporarily
    from torch.distributed.device_mesh import DeviceMesh

    make_mesh = DeviceMesh.__init__

    def real_mesh(self, *args, **kwargs):
        with unset_fake_temporarily():
            make_mesh(self, *args, **kwargs)

    with contextlib.ExitStack() as stack:
        stack.enter_context(mock.patch.object(DeviceMesh, "__init__", real_mesh))
        stack.enter_context(mock.patch.object(torch.nn.init, "trunc_normal_", lambda tensor, *args, **kwargs: tensor))
        yield


@contextlib.contextmanager
def build_train_step(config_file_path: Path, warmstart_checkpoint_folder: Optional[str] = None
                     ) -> Iterator[BuiltTrainStep]:
    """The config's train step on rank 0 of a fake world of its world size,
    built by `Main` under `FakeTensorMode` (the CPU path's modules; the walk
    routes them to the kernels). A profiler-harness config (one with a
    `steppable_component`, `profile distributed`) gives its forward pass's
    step, on a world of 1 unless it names a device mesh. Usable inside the
    block only: its tensors are fake, and the world ends with the block."""
    import yaml
    from torch._subclasses.fake_tensor import FakeTensorMode

    from modalities_tpu_torch.config.instantiation_models import RecipeValidationInstantiationModel
    from modalities_tpu_torch.main import Main

    config_file_path = Path(config_file_path)
    raw = yaml.safe_load(config_file_path.read_text())
    harness = "steppable_component" in raw
    world_size = 1 if harness and "device_mesh" not in raw else _world_size_of(raw, config_file_path)

    def warmstart_env(key: str):
        if key in ("checkpoint_paths", "checkpoint_folder_path"):
            return warmstart_checkpoint_folder or _FAKE_WARMSTART_FOLDER
        raise ValueError(f"Unknown warmstart_env variable {key!r}")

    with fake_world(world_size):
        if harness:
            from modalities_tpu_torch.utils.profilers.modalities_profiler import build_steppable_component

            component = build_steppable_component(config_file_path, device="cpu")
            mesh = component.device_mesh
        else:
            main = Main(config_file_path, experiment_id="recipe_validation", device="cpu",
                        additional_resolver_funs={"warmstart_env": warmstart_env})
            components = main.build_components(RecipeValidationInstantiationModel)
            mesh = components.device_mesh
        if mesh is not None:
            mesh.torch_mesh("cpu")  # the device meshes hold real tensors: built before the fake mode
        with FakeTensorMode(allow_non_fake_inputs=True), _fake_build_patches():
            if harness:
                generator, acc = component.batch_generator, component.gradient_accumulation_steps
                rows = tuple(generator.dims.values())[:2] if generator.dims else (generator.micro_batch_size,
                                                                                 generator.sequence_length)
                step = component.train_step
                yield BuiltTrainStep(step, component, mesh, _batch((step.model.sample_key, generator.target_key),
                                                                   (acc, *rows)),
                                     world_size, forward_only=not component.include_backward)
            else:
                step = main.build_train_step(components)
                profile = components.settings.step_profile
                shape = (profile.gradient_accumulation_steps, profile.local_train_micro_batch_size,
                         profile.sequence_length)
                yield BuiltTrainStep(step, components, mesh, _batch((step.model.sample_key,
                                                                     components.loss_fn.target_key), shape),
                                     world_size)


# ---------------------------------------------------------------- the budget


def state_bytes(train_step) -> dict:
    """This rank's parameter bytes (the storage under each local shard:
    FSDP2 allocates its dim-0 padding with it), optimizer bytes and
    gradient bytes (telemetry/memscope.py's counts: the state the update
    made, or before one AdamW's two moments and step; the float32
    accumulators and the parameter-dtype gradients)."""
    from torch.distributed.tensor import DTensor

    from modalities_tpu_torch.telemetry.memscope import train_step_known_bytes

    known = train_step_known_bytes(train_step)
    params = sum((p.to_local() if isinstance(p, DTensor) else p).untyped_storage().nbytes() for p in train_step.params)
    return {"params_bytes": int(params), "optimizer_bytes": known["optimizer_moments"],
            "gradient_bytes": known["gradients_accumulators"]}


@contextlib.contextmanager
def _forward_methods_through_call(module) -> Iterator[None]:
    """For the block: each FSDP2 module's registered forward method (the
    GPT2 blocks' `train_forward`) runs as the module's `__call__`, so the
    module hooks FSDPMemTracker attributes memory through see it."""
    import types

    from torch.distributed.fsdp import FSDPModule

    routed = [(m, m.train_forward) for m in module.modules()
              if isinstance(m, FSDPModule) and "train_forward" in vars(m)]
    for m, _ in routed:
        m.forward = types.MethodType(type(m).train_forward, m)
        m.train_forward = m.__call__
    try:
        yield
    finally:
        for m, method in routed:
            m.train_forward = method
            del m.forward


def _mem_tracker_peak(built: BuiltTrainStep) -> dict:
    """FSDPMemTracker's peak over one more faked step: its own per-device
    accounting (parameters, gradients, optimizer state, activations,
    temporaries), beside the formula. As JAX records a failed compile, a
    failure of the tracker is recorded here and never changes the build's
    verdict."""
    from modalities_tpu_torch.telemetry.perfscope import StaticWalk

    backend = {"backend": "fsdp2_mem_tracker_fake_world"}
    step = built.train_step
    if step.module is None:
        return {"error": "FSDPMemTracker tracks one FSDP2 root: the step holds pipeline stages in process", **backend}
    try:
        from torch.distributed._tools.fsdp2_mem_tracker import FSDPMemTracker

        tracker = FSDPMemTracker(mod=step.module, optm=step.optimizer)
        # the walk's ops under the tracker: the kernels' stand-ins, the update not run
        with _forward_methods_through_call(step.module), tracker, StaticWalk(built.device_mesh):
            built.run()
        peak = tracker.get_tracker_snapshot("peak")
    except Exception as e:
        return {"error": f"{type(e).__name__}: {str(e)[:500]}", **backend}
    return {"peak_bytes": max((int(stats.get("Total", 0)) for stats in peak.values()), default=0), **backend}


def validate_recipe(config_file_path: Path, hbm_budget_bytes: Optional[int] = None,
                    warmstart_checkpoint_folder: Optional[str] = None, compile_memory_check: bool = False) -> dict:
    """Build the recipe's train step on its fake world, walk one step, and
    report this rank's memory against the budget (JAX's report keys)."""
    from modalities_tpu_torch.telemetry.perfscope import StaticWalk

    config_file_path = Path(config_file_path)
    budget = default_budget_bytes() if hbm_budget_bytes is None else int(hbm_budget_bytes)
    with build_train_step(config_file_path, warmstart_checkpoint_folder) as built:
        step, mesh = built.train_step, built.device_mesh
        try:
            with StaticWalk(mesh):
                built.run()
            lowering = "ok"
        except Exception as e:  # report the build's or the walk's failure, don't crash
            lowering = f"failed: {type(e).__name__}: {str(e)[:500]}"
        memory_check = _mem_tracker_peak(built) if compile_memory_check and lowering == "ok" else None
        state = state_bytes(step)
        profile = built.components.settings.step_profile
        act = _estimate_activation_bytes(step.model, mesh, profile)
        num_params = int(sum(p.numel() for p in step.params))
    warnings = [act["unavailable"]] if "unavailable" in act else []
    total = state["params_bytes"] + state["optimizer_bytes"] + state["gradient_bytes"] + act["total"]
    if memory_check is not None and "peak_bytes" in memory_check:
        memory_check["formula_total_bytes"] = int(total)
        memory_check["peak_over_formula"] = round(memory_check["peak_bytes"] / max(1, total), 3)
    report = {
        "config": str(config_file_path),
        "world_size": built.world_size,
        "mesh": dict(mesh.degrees),
        "num_params": num_params,
        "lowering": lowering,
        "per_device": {
            **state,
            "activation_estimate": act,
            **({"fsdp_mem_tracker": memory_check} if memory_check is not None else {}),
            "total_bytes": int(total),
            "total_gib": round(total / 1024**3, 3),
        },
        "hbm_budget_bytes": budget,
        "fits_budget": bool(total < budget),
    }
    if warnings:
        report["warnings"] = warnings
    return report


def run_module_subprocess(module: str, config_file_path: Path, *args: str) -> dict:
    """`python -m <module> <config> <args>` in a child process with no card
    visible (the fake world needs a process without a process group, and
    touches no device); returns the JSON of its last line."""
    import json
    import subprocess
    import sys

    child_env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    for name in _RANK_VARS + ("MASTER_ADDR", "MASTER_PORT"):  # not the launcher's world: the recipe's
        child_env.pop(name, None)
    proc = subprocess.run([sys.executable, "-m", module, str(config_file_path), *args], env=child_env,
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"{module} failed for {config_file_path} (exit {proc.returncode}):\n"
                           f"{proc.stdout[-2000:]}\n{proc.stderr[-4000:]}")
    return json.loads(proc.stdout.strip().splitlines()[-1])


def run_validation_subprocess(config_file_path: Path, hbm_budget_bytes: Optional[int] = None,
                              warmstart_checkpoint_folder: Optional[str] = None,
                              compile_memory_check: bool = False) -> dict:
    """`validate_recipe` in a child process (`run_module_subprocess`); the
    budget is resolved here, where a card may be visible."""
    budget = default_budget_bytes() if hbm_budget_bytes is None else int(hbm_budget_bytes)
    args = ["--hbm_budget_bytes", str(budget)]
    if warmstart_checkpoint_folder:
        args += ["--warmstart_checkpoint_folder", warmstart_checkpoint_folder]
    if compile_memory_check:
        args.append("--compile_memory_check")
    return run_module_subprocess("modalities_tpu_torch.utils.recipe_validation", config_file_path, *args)


def _main() -> None:
    import argparse
    import json

    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("config_file_path", type=Path)
    parser.add_argument("--hbm_budget_bytes", type=int, default=None)
    parser.add_argument("--warmstart_checkpoint_folder", default=None)
    parser.add_argument("--compile_memory_check", action="store_true")
    args = parser.parse_args()
    report = validate_recipe(args.config_file_path, hbm_budget_bytes=args.hbm_budget_bytes,
                             warmstart_checkpoint_folder=args.warmstart_checkpoint_folder,
                             compile_memory_check=args.compile_memory_check)
    print(json.dumps(report))


if __name__ == "__main__":
    _main()

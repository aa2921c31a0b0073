"""Gloo worlds on the CPU for the port's multi-rank tests, and the workers they
run. `run_world(world, worker, *args)` spawns `world` processes with the
variables `torch.distributed.run` sets (RANK, WORLD_SIZE, LOCAL_RANK,
MASTER_ADDR, MASTER_PORT), so each worker joins its group through the port's
own launcher path (running_env/env.py); each returns what its worker
returned. This module imports no JAX, so the spawned processes start fast; the
JAX oracles run in the test process (tests/test_torch_ring_attention.py,
test_torch_parallel_train.py, test_torch_checkpointing.py).

Its own tests: the ring's exchange on three ranks, and `run` then
`warmstart` of a tiny config on two ranks (dp_shard 2) through the CLI: the
resumed steps give bitwise the unbroken run's losses, and only rank 0 prints
and publishes. The same world then runs the stop ballot
(resilience/coordination.py): a third `run` with `stop_consensus: on` and
the skip policy, `nan_grads@1` on both ranks and `sigterm_one_rank@2:1`, so
only rank 1 votes to stop; both ranks skip step 2 alike (the reduced norm),
and both leave at step 4 (the vote rides step 3, the trainer reads it one
step late) with the forced save and exit 75."""

from __future__ import annotations

import contextlib
import io
import os
import pickle
import socket
import tempfile
from pathlib import Path

import numpy as np
import torch
import torch.multiprocessing as mp


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _entry(rank: int, world: int, port: int, out: str, worker, args) -> None:
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(world), LOCAL_RANK=str(rank), MASTER_ADDR="127.0.0.1",
                      MASTER_PORT=str(port))
    torch.set_num_threads(1)
    result = worker(rank, world, *args)
    Path(out, f"{rank}.pkl").write_bytes(pickle.dumps(result))


def run_world(world: int, worker, *args) -> list:
    """worker(rank, world, *args) in `world` spawned processes; their results by rank."""
    with tempfile.TemporaryDirectory() as out:
        mp.start_processes(_entry, args=(world, free_port(), out, worker, args), nprocs=world, join=True,
                           start_method="spawn")
        return [pickle.loads(Path(out, f"{r}.pkl").read_bytes()) for r in range(world)]


def _numpy(tensors: dict) -> dict:
    return {k: v.detach().float().numpy() if v.is_floating_point() else v.numpy() for k, v in tensors.items()}


# ------------------------------------------------------------------ workers


def ring_worker(rank: int, world: int, cases: list[dict]) -> list[dict]:
    """The port's ring on this rank's chunk of each case's q/k/v ([B, S, H, D]
    numpy): out and the gradients of sum(out * w) for q, k and v."""
    from modalities_tpu_torch.parallel.ring_attention import ring_attention
    from modalities_tpu_torch.running_env import env

    results = []
    with env.process_group(torch.device("cpu")):
        group = torch.distributed.group.WORLD
        for case in cases:
            chunk = case["q"].shape[1] // world
            local = [torch.from_numpy(case[n][:, rank * chunk:(rank + 1) * chunk].copy()).requires_grad_()
                     for n in ("q", "k", "v")]
            out = ring_attention(*local, group, causal=case["causal"], impl=case["impl"])
            w = torch.from_numpy(case["w"][:, rank * chunk:(rank + 1) * chunk].copy())
            (out * w).sum().backward()
            results.append({"out": out.detach().numpy(), **{f"d{n}": t.grad.numpy() for n, t in zip("qkv", local)}})
    return results


def batch_rows(device_mesh, rows: int, rank=None) -> list[int]:
    """The rows of a global microbatch of `rows` rows that rank `rank` feeds,
    for a test that holds the whole microbatch: slice k's contiguous block of
    rows / dcn (JAX `to_dcn_groups`, train_step.py:313-335), then within the
    slice rows dp, dp + n, ... of the block for the rank's flat dp
    coordinate dp among the slice's n (as the sampler deals a run's samples
    to ranks)."""
    from modalities_tpu_torch.running_env.device_mesh import get_data_loading_info

    n_dp, dp = get_data_loading_info(device_mesh, rank)
    dcn = device_mesh.dcn_parallel_degree if device_mesh is not None else 1
    if rows % dcn:
        raise ValueError(f"a microbatch's {rows} rows are not divisible by dcn_parallel_degree {dcn}: every slice "
                         "must own an equal share of each microbatch")
    block, inner = rows // dcn, n_dp // dcn
    start = (dp // inner) * block
    return list(range(start + dp % inner, start + block, inner))


def local_batch(batch: dict, mesh) -> dict:
    """This rank's rows of a global batch ({part: {key: [acc, mb, S]}}, numpy)
    as tensors: under dcn its slice's contiguous block, and within the slice
    rows dp, dp + n, ... (`batch_rows`)."""
    return {part: {k: torch.from_numpy(np.ascontiguousarray(v[:, batch_rows(mesh, v.shape[1])])) for k, v in d.items()}
            for part, d in batch.items()}


def train_worker(rank: int, world: int, spec: dict) -> dict:
    """A tiny GPT2 `TrainStep` over the mesh of `spec["degrees"]`, from the
    parameters `spec["params"]`; each rank feeds its data-parallel rows of
    the global batches (`local_batch`). Returns each step's (loss,
    grad_norm, lr) and the parameters after the steps (on rank 0; under pp
    on the first rank of each stage, which holds its share); with
    `spec["moments"]` each leaf's (local moment elements, local parameter
    elements); with `spec["count_dcn"]` the collectives on the dcn group
    (`_dcn_collectives`)."""
    from modalities_tpu_torch.running_env import env

    with env.process_group(torch.device("cpu")):
        step, mesh = _tiny_step(spec, world)
        events = _dcn_collectives(mesh) if spec.get("count_dcn") else None
        metrics = []
        for batch in spec["batches"]:
            m = step(local_batch(batch, mesh))
            metrics.append([float(m[k]) for k in ("loss", "grad_norm", "lr")])
        state = _numpy(step.state_dict())
        first_of_stage = mesh is None or not any(v for k, v in mesh.coordinates(rank).items() if k != "pp")
        moments = _moment_sizes(step) if spec.get("moments") else None
        zero_dims = dict(zip(step.zero.names, step.zero.dims)) if step.zero is not None else None
    return {"metrics": metrics, "state": state if first_of_stage else None, "moments": moments, "dcn": events,
            "zero_dims": zero_dims}


def _moment_sizes(step) -> dict[str, tuple[int, int]]:
    """Each parameter's (local exp_avg elements, local parameter elements)."""
    from modalities_tpu_torch.checkpointing.stateful.app_state import AppState
    from modalities_tpu_torch.training.train_step import _local

    optim = AppState(step).state_dict()["optimizer"]
    named = [item for module in [st.module for st in step.stages] or [step.module] for item in module.named_parameters()]
    return {name: (_local(optim[f"state.{name}.exp_avg"]).numel(), _local(p).numel()) for name, p in named}


def _dcn_collectives(mesh) -> list:
    """Record, in order, each train step's start ("step"), the end of each
    microbatch's backward ("microbatch") and every collective called on this
    rank's dcn group (its name), through `torch.distributed`."""
    import inspect

    import torch.distributed as dist
    from torch.distributed import distributed_c10d

    from modalities_tpu_torch.training.train_step import TrainStep

    dcn_ranks = dist.get_process_group_ranks(mesh.dcn_group(torch.device("cpu")))
    events: list = []

    def recorded(name, fn):
        signature = inspect.signature(fn)

        def call(*args, **kwargs):
            group = signature.bind(*args, **kwargs).arguments.get("group")
            if group is not None and dist.get_process_group_ranks(group) == dcn_ranks:
                events.append(name)
            return fn(*args, **kwargs)
        return call

    for name in ("all_reduce", "reduce_scatter_tensor", "all_gather_into_tensor", "all_gather", "broadcast",
                 "reduce_scatter", "all_to_all", "all_to_all_single", "send", "recv", "isend", "irecv", "barrier"):
        wrapped = recorded(name, getattr(dist, name))
        setattr(dist, name, wrapped)
        setattr(distributed_c10d, name, wrapped)
    call, accumulate = TrainStep.__call__, TrainStep._accumulate
    TrainStep.__call__ = lambda self, batch: (events.append("step"), call(self, batch))[1]
    TrainStep._accumulate = lambda self, acc=None: (accumulate(self, acc), events.append("microbatch"))[0]
    return events


def _tiny_step(spec: dict, world: int):
    from modalities_tpu_torch.loss_functions import CLMCrossEntropyLoss
    from modalities_tpu_torch.models.gpt2.gpt2_model import GPT2LLM, MixedPrecisionSpec
    from modalities_tpu_torch.optimizers.optimizer_factory import OptimizerFactory
    from modalities_tpu_torch.optimizers.scheduler_factory import LinearWarmupCosineAnnealingLRScheduler
    from modalities_tpu_torch.running_env.device_mesh import DeviceMesh
    from modalities_tpu_torch.training.activation_checkpointing import apply_activation_checkpointing
    from modalities_tpu_torch.training.gradient_clipping import GradientClipper
    from modalities_tpu_torch.training.train_step import TrainStep

    degrees = spec["degrees"]
    mesh = DeviceMesh(world_size=world, data_parallel_replicate_degree=degrees.get("dp_replicate", 1),
                      data_parallel_shard_degree=degrees.get("dp_shard", 1),
                      context_parallel_degree=degrees.get("cp", 1), tensor_parallel_degree=degrees.get("tp", 1),
                      pipeline_parallel_degree=degrees.get("pp", 1), dcn_parallel_degree=degrees.get("dcn", 1),
                      enable_loss_parallel=spec.get("loss_parallel", False),
                      zero_stage=spec.get("zero", 0)) if degrees is not None else None
    model = GPT2LLM(**spec["model"])
    if spec.get("pipeline"):  # {"pp_schedule": ..., "pp_num_microbatches": ..., "pp_num_virtual": ...}
        model.with_spec_updates(**spec["pipeline"])
    model.update_train_spec(mixed_precision=MixedPrecisionSpec(*spec.get("dtypes", ("float32",) * 3)))
    for routine in spec.get("init_routines", ()):
        model.update_train_spec(init_routines=model.train_spec.init_routines + (routine,))
    if spec.get("remat"):
        apply_activation_checkpointing(model, "full_activation_checkpointing")
    opt = OptimizerFactory.get_adam_w(wrapped_model=model, **spec["opt"])
    sched = LinearWarmupCosineAnnealingLRScheduler(optimizer=opt, **spec["sched"])
    params = spec.get("params")
    step = TrainStep(model, CLMCrossEntropyLoss("target_ids", "logits"), opt, sched, device="cpu",
                     gradient_acc_steps=spec["acc"], grad_clipper=GradientClipper(max_norm=spec["clip"]),
                     params=None if params is None else {k: torch.from_numpy(v.copy()) for k, v in params.items()},
                     seed=spec.get("seed"), device_mesh=mesh, pp_in_process=spec.get("pp_in_process"),
                     dcn_in_process=spec.get("dcn_in_process"), zero_in_process=spec.get("zero_in_process"))
    return step, mesh


def checkpoint_worker(rank: int, world: int, spec: dict, folder_root: str) -> dict:
    """On the mesh of `spec["degrees"]`: an unbroken run of len(batches)
    steps; a run of `save_at` steps saved through the DCP execution (each
    rank its shards, rank 0 the seal); a fresh build from another seed loaded
    from the folder and run on. Returns the metrics of both runs, the folder
    and, on rank 0, the initial parameters, the parameters at the save and
    both final states."""
    from modalities_tpu_torch.checkpointing import checkpoint_saving_strategies as strategies
    from modalities_tpu_torch.checkpointing.checkpoint_saving import CheckpointSaving
    from modalities_tpu_torch.checkpointing.dcp.dcp_checkpoint_loading import DCPCheckpointLoading
    from modalities_tpu_torch.checkpointing.dcp.dcp_checkpoint_saving import DCPCheckpointSaving, checkpoint_folder_path
    from modalities_tpu_torch.checkpointing.stateful.app_state import AppState
    from modalities_tpu_torch.running_env import env
    from modalities_tpu_torch.training.training_progress import TrainingProgress

    def run(step, batches, mesh):
        out = []
        for batch in batches:
            m = step(local_batch(batch, mesh))
            out.append(torch.stack([m[k].detach().float() for k in ("loss", "grad_norm", "lr")]).numpy())
        return out

    batches, save_at = spec["batches"], spec["save_at"]
    with env.process_group(torch.device("cpu")):
        unbroken, mesh = _tiny_step(spec, world)
        initial = {k: v.copy() for k, v in _numpy(unbroken.state_dict()).items()}  # the steps update in place
        want = run(unbroken, batches, mesh)
        first, mesh = _tiny_step(spec, world)
        got = run(first, batches[:save_at], mesh)
        progress = TrainingProgress(save_at, save_at * spec["tokens_per_step"], len(batches),
                                    len(batches) * spec["tokens_per_step"])
        saving = CheckpointSaving(strategies.SaveKMostRecentCheckpointsStrategy(k=-1),
                                  DCPCheckpointSaving(Path(folder_root), "multi", global_rank=rank))
        saving.save_checkpoint(progress, AppState(first, device_mesh=mesh))
        saving.wait_until_finished()
        folder = checkpoint_folder_path(Path(folder_root), "multi", progress)
        saved = _numpy(first.state_dict())
        resumed, mesh = _tiny_step({**spec, "params": None, "seed": 1}, world)  # every tensor from the folder
        DCPCheckpointLoading(global_rank=rank).load_app_state(AppState(resumed, device_mesh=mesh), folder)
        got += run(resumed, batches[save_at:], mesh)
        finals = (_numpy(unbroken.state_dict()), _numpy(resumed.state_dict()))
    return {"want": want, "got": got, "folder": str(folder), "saved": saved if rank == 0 else None,
            "finals": finals if rank == 0 else None, "initial": initial if rank == 0 else None}


def resume_worker(rank: int, world: int, spec: dict, folder: str) -> list:
    """A tiny GPT2 `TrainStep` over the mesh of `spec["degrees"]` built from
    another seed, loaded from the DCP `folder` (parameters, optimizer and
    scheduler), then run on `spec["batches"]`: each step's (loss, grad_norm,
    lr)."""
    from modalities_tpu_torch.checkpointing.dcp.dcp_checkpoint_loading import DCPCheckpointLoading
    from modalities_tpu_torch.checkpointing.stateful.app_state import AppState
    from modalities_tpu_torch.running_env import env

    with env.process_group(torch.device("cpu")):
        step, mesh = _tiny_step({**spec, "params": None, "seed": 1}, world)
        DCPCheckpointLoading(global_rank=rank).load_app_state(AppState(step, device_mesh=mesh), Path(folder))
        metrics = []
        for batch in spec["batches"]:
            m = step(local_batch(batch, mesh))
            metrics.append([float(m[k]) for k in ("loss", "grad_norm", "lr")])
    return metrics


def cli_worker(rank: int, world: int, run_cfg: str, warm_cfg: str, info: str, ports: tuple,
               ballot_cfg: str = None) -> dict:
    """`run` and then `warmstart` through the CLI (in process), each with its
    own rendezvous port; every train step's metrics and batch (numpy), and
    what each printed. With `ballot_cfg`, then the stop-ballot run on a third
    port (`ballot_worker`)."""
    out = _cli_commands([(ports[0], ["run", "--config_file_path", run_cfg, "--device", "cpu"]),
                         (ports[1], ["warmstart", "--config_file_path", warm_cfg, "--last_checkpoint_info_file_path",
                                     info, "--device", "cpu"])])
    if ballot_cfg is not None:  # the recording keeps appending: the two commands' own lists are copies
        out = {**out, "steps": list(out["steps"]), "batches": list(out["batches"])}
        out["ballot"] = ballot_worker(ports[2], ballot_cfg)
    return out


def ballot_worker(port: int, cfg: str) -> dict:
    """`run` of `cfg` with `nan_grads@1,sigterm_one_rank@2:1` armed: its exit
    code, each step's `skipped_step`, and the resilience events (name, step)."""
    import modalities_tpu_torch.resilience.anomaly as anomaly
    import modalities_tpu_torch.resilience.faults as faults
    import modalities_tpu_torch.trainer as trainer
    from modalities_tpu_torch.__main__ import main
    from modalities_tpu_torch.training.train_step import TrainStep

    events, skipped = [], []
    for module in (trainer, faults, anomaly):
        original = module.record_event
        module.record_event = lambda name, _original=original, **payload: (
            events.append((name, payload.get("step"))), _original(name, **payload))
    call = TrainStep.__call__

    def recording(self, batch):
        metrics = call(self, batch)
        skipped.append(int(metrics["skipped_step"]))
        return metrics

    TrainStep.__call__ = recording
    faults.clear_faults()
    os.environ.update(MASTER_PORT=str(port), MODALITIES_TPU_FAULTS="nan_grads@1,sigterm_one_rank@2:1",
                      MODALITIES_TPU_ERROR_LOG_DIR=str(Path(cfg).parent / "errors"))
    try:
        code = main(["run", "--config_file_path", cfg, "--device", "cpu"])
    except SystemExit as e:
        code = e.code
    return {"code": code, "skipped": skipped, "events": events}


def cli_command_worker(rank: int, world: int, argv: list) -> dict:
    """One CLI command (in process, `--device cpu` added) on the world's
    rendezvous port; as `cli_worker` reports it."""
    return _cli_commands([(None, [*argv, "--device", "cpu"])])


def _cli_commands(commands: list) -> dict:
    from modalities_tpu_torch.__main__ import main
    from modalities_tpu_torch.training.train_step import TrainStep

    seen, batches = [], []
    call = TrainStep.__call__

    def recording(self, batch):
        batches.append({part: {k: v.numpy().copy() for k, v in d.items()} for part, d in batch.items()
                        if isinstance(d, dict)})  # not the stop ballot's vote
        metrics = call(self, batch)
        seen.append([metrics[k].detach().clone().item() for k in ("loss", "grad_norm", "lr")])
        return metrics

    TrainStep.__call__ = recording
    printed = []
    for port, argv in commands:
        if port is not None:
            os.environ["MASTER_PORT"] = str(port)
        buffer = io.StringIO()
        with contextlib.redirect_stdout(buffer):
            assert main(argv) == 0
        printed.append(buffer.getvalue())
    return {"steps": seen, "batches": batches, "printed": printed}


def exchange_worker(rank: int, world: int) -> list:
    from modalities_tpu_torch.parallel.ring_attention import _exchange
    from modalities_tpu_torch.running_env import env

    with env.process_group(torch.device("cpu")):
        group = torch.distributed.group.WORLD
        x = torch.full((2, 3), float(rank))
        forward, back = _exchange([x, x + 10], group, 1), _exchange([x], group, -1)
    return [t[0, 0].item() for t in forward + back]


# -------------------------------------------------------------------- tests


def test_the_ring_exchange_passes_chunks_to_the_next_rank_and_back():
    got = run_world(3, exchange_worker)
    assert got == [[(r - 1) % 3, (r - 1) % 3 + 10, (r + 1) % 3] for r in range(3)]


def test_run_and_warmstart_train_on_two_ranks_through_the_cli(tmp_path):
    """A tiny copy of configs/config_2p7b_dp.yaml on a dp_shard 2 mesh (bf16
    parameters, fp32 norms): `run` saves at step 3 of 5, `warmstart` resumes
    from the pointer; the resumed steps' losses, grad norms and lr equal the
    unbroken run's bitwise on both ranks; the topology record names the
    2-rank mesh; only rank 0 prints the step lines."""
    import json

    from tests.test_torch_run_cli import tiny_config
    from tests.test_torch_warmstart import warmstart_config

    steps, save_at, per_step = 5, 3, 32 * 2 * 1 * 2  # sequence x micro batch x accumulation x dp ranks
    cfg = tiny_config(tmp_path, acc=1, **{"device_mesh.config.data_parallel_shard_degree": 2,
                                   "device_mesh.config.world_size": 2,
                                   "settings.training_target.num_target_steps": steps,
                                   "settings.training_target.num_target_tokens": steps * per_step,
                                   "settings.intervals.checkpointing_interval_in_steps": save_at,
                                   "settings.intervals.evaluation_interval_in_steps": steps,
                                   "settings.consistency_enforcement.enforce_last_step_evaluated": False})
    warm = warmstart_config(cfg, tmp_path / "warmstart.yaml")
    info = tmp_path / "checkpoints" / "last_checkpoint_info.json"
    (tmp_path / "ballot").mkdir()
    ballot = tiny_config(tmp_path / "ballot", acc=1, **{
        "device_mesh.config.data_parallel_shard_degree": 2, "device_mesh.config.world_size": 2,
        "settings.training_target.num_target_steps": 6, "settings.training_target.num_target_tokens": 6 * per_step,
        "settings.intervals.evaluation_interval_in_steps": 6,
        "resilience": {"component_key": "resilience", "variant_key": "default",
                       "config": {"anomaly_policy": "skip_step", "stop_consensus": "on"}}})
    ranks = run_world(2, cli_worker, str(cfg), str(warm), str(info), (free_port(), free_port(), free_port()),
                      str(ballot))
    for r in ranks:
        assert len(r["steps"]) == steps + steps - save_at
        assert r["steps"][steps:] == r["steps"][save_at:steps]
    assert ranks[0]["steps"] == ranks[1]["steps"]  # the global loss, grad norm and lr on every rank
    assert "[train] step 1:" in ranks[0]["printed"][0] and "[train] step 4:" in ranks[0]["printed"][1]
    assert "[train] step" not in ranks[1]["printed"][0] + ranks[1]["printed"][1]
    folder = Path(json.loads(info.read_text())["checkpoint_folder_path"])
    assert {"__0_0.distcp", "__1_0.distcp", ".metadata", "manifest.json", "topology.json"} <= {
        p.name for p in folder.iterdir()}
    topology = json.loads((folder / "topology.json").read_text())
    assert topology["mesh_axes"] == {"dp_shard": 2} and topology["process_count"] == 2
    assert topology["leaf_specs"]["model.wte"] == "('dp_shard', None)"
    # the stop ballot: both ranks skip step 2 and leave at step 4, saved out of schedule, exit 75
    votes = [r["ballot"] for r in ranks]
    assert [v["code"] for v in votes] == [75, 75] and [v["skipped"] for v in votes] == [[0, 1, 0, 0]] * 2
    leaving = [("consensus/shutdown_agreed", 4), ("preempt/shutdown_requested", 4), ("preempt/checkpoint_saved", 4)]
    assert votes[0]["events"] == [("anomaly/skipped", 2), *leaving]
    assert votes[1]["events"] == [("anomaly/skipped", 2), ("fault/sigterm_one_rank", 2),
                                  ("consensus/stop_vote_cast", 2), *leaving]
    forced = json.loads((tmp_path / "ballot" / "checkpoints" / "last_checkpoint_info.json").read_text())
    assert "-seen_steps_4-" in forced["checkpoint_folder_path"]
    assert all(json.loads((tmp_path / "ballot" / "errors" / f"error_rank_{r}.json").read_text())["resumable"]
               for r in range(2))

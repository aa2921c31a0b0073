"""The recipe chain on the CPU, pretrain to warmstart: a tiny twin of
configs/config_7b_tp_fsdp.yaml trains and saves, then `warmstart` on a tiny
twin of configs/config_7b_warmstart_32k.yaml resumes from its folder at twice
the context. The port's counterpart of the JAX package's
tests/end2end_tests/test_acceptance_recipe_twins.py::
test_7b_tp_fsdp_twin_then_32k_warmstart_twin.

Twins: each file's graph with the JAX twins' model widths (2 layers of 128,
8/2 heads, SwiGLU 256, vocab 256) and f32 parameters (the files' bf16
`param_dtype` set to float32; the blocks compute in bf16, the models'
default, as the files leave it). Pretrain: dp_shard 2 x tp 2 with loss
parallelism (4 gloo ranks), 2 sequences of 128 a rank a step, 4 steps, saved
at step 4. Warmstart: cp 2 x tp 2 (4 ranks), one sequence of 256 a step,
full remat, the fused-CE head in chunks of 64, steps 5 and 6 (saved at 6).
Each runs through the CLI in a world of its own (`run`, then `warmstart`),
as the recipe's two launches do: two runs on different meshes in one
process fail (ROADMAP.md, Queue 3).

What the JAX test asserts: the pretrain's 4 steps and tokens; the folder's
name holds them, and the warmstart reads its progress from it (steps 5-6,
the consumed tokens); losses finite and continuous across the seam. Beyond
it, the warmstart's first step from the step-4 folder: the port's train step
on the recipe's cp 2 x tp 2 gloo mesh, all in f32 (as
tests/test_torch_parallel_train_tp_cp.py builds it), loaded from the folder
through DCP, gives on the warmstart's batch the loss and grad norm of the JAX
`TrainStepBuilder` step on a cp 2 x tp 2 mesh of the 8 CPU devices from the
folder's parameters (1e-5); the CLI's step, whose blocks compute in bf16, is
within 1e-3 of it."""

import json
from pathlib import Path

import jax
import numpy as np

from modalities_tpu.loss_functions import CLMCrossEntropyLoss as JaxLoss
from modalities_tpu.models.gpt2.gpt2_model import GPT2LLM as JaxGPT2LLM
from modalities_tpu.models.model import MixedPrecisionSpec as JaxMixedPrecision
from modalities_tpu.optimizers.optimizer_factory import OptimizerFactory as JaxOptimizers
from modalities_tpu.optimizers.scheduler_factory import LinearWarmupCosineAnnealingLRScheduler as JaxWarmupCosine
from modalities_tpu.running_env.device_mesh import get_device_mesh
from modalities_tpu.training.activation_checkpointing import ActivationCheckpointing as JaxActivationCheckpointing
from modalities_tpu.training.gradient_clipping import GradientClipper as JaxClipper
from modalities_tpu.training.train_step import TrainStepBuilder
from modalities_tpu_torch.checkpointing.dcp.dcp_checkpoint_loading import restore_tree_single_device
from modalities_tpu_torch.config.yaml_interp import load_app_config_dict
from modalities_tpu_torch.conversion.from_jax import params_from_jax
from modalities_tpu_torch.models.gpt2.gpt2_model import GPT2LLM
from tests.test_torch_gloo import cli_command_worker, resume_worker, run_world
from tests.test_torch_run_cli import tiny_config
from tests.test_torch_train_step import OPT, SCHED, TOL

WORLD = 4
TWIN = {"model_raw.config.n_head_q": 8, "model_raw.config.n_head_kv": 2, "model_raw.config.ffn_hidden": 256,
        "sharded_model.config.mixed_precision_settings.param_dtype": "float32"}
PRE_STEPS, PRE_SEQ, PRE_MBS, PRE_DP = 4, 128, 2, 2
WARM_STEPS, WARM_SEQ, WARM_CHUNK = 2, 256, 64
SEEN_TOKENS = PRE_STEPS * PRE_SEQ * PRE_MBS * PRE_DP


def _twins(tmp: Path) -> tuple[Path, Path]:
    checkpoints = {"settings.paths.checkpoint_saving_path": str(tmp / "checkpoints"),
                   "settings.consistency_enforcement.enforce_last_step_checkpointed": True}
    (tmp / "pretrain").mkdir()
    (tmp / "warm").mkdir()
    pretrain = tiny_config(tmp / "pretrain", base="config_7b_tp_fsdp.yaml", seq=PRE_SEQ, mbs=PRE_MBS, acc=1,
                           **TWIN, **checkpoints,
                           **{"device_mesh.config.data_parallel_shard_degree": PRE_DP,
                              "device_mesh.config.tensor_parallel_degree": 2,
                              "device_mesh.config.world_size": WORLD,
                              "settings.training_target.num_target_steps": PRE_STEPS,
                              "settings.training_target.num_target_tokens": SEEN_TOKENS,
                              "settings.intervals.evaluation_interval_in_steps": PRE_STEPS,
                              "settings.intervals.checkpointing_interval_in_steps": PRE_STEPS})
    warm = tiny_config(tmp / "warm", base="config_7b_warmstart_32k.yaml", seq=WARM_SEQ, mbs=1, acc=1,
                       **TWIN, **checkpoints,
                       **{"device_mesh.config.data_parallel_shard_degree": 1,
                          "device_mesh.config.context_parallel_degree": 2,
                          "device_mesh.config.tensor_parallel_degree": 2,
                          "device_mesh.config.world_size": WORLD,
                          "model_raw.config.lm_head_chunk_size": WARM_CHUNK,
                          "settings.training_target.num_target_steps": PRE_STEPS + WARM_STEPS,
                          "settings.training_target.num_target_tokens": SEEN_TOKENS + WARM_STEPS * WARM_SEQ,
                          "settings.intervals.evaluation_interval_in_steps": WARM_STEPS,
                          "settings.intervals.checkpointing_interval_in_steps": WARM_STEPS})
    return pretrain, warm


def _rows(folder: Path) -> list[dict]:
    rows = [json.loads(line) for f in folder.rglob("evaluation_results.jsonl") for line in f.read_text().splitlines()]
    return sorted(rows, key=lambda r: r["num_train_steps_done"])


def _jax_params(port_params: dict, template, port_model):
    """The JAX params tree (`template`'s structure, numpy) holding the port's
    values: params_from_jax of a tree of element indices says where each JAX
    element lies in the port's tensors (the walk only reshapes)."""
    leaves, treedef = jax.tree.flatten(template)
    offsets = np.cumsum([0] + [leaf.size for leaf in leaves])
    tagged = jax.tree.unflatten(treedef, [np.arange(a, b, dtype=np.float64).reshape(leaf.shape)
                                          for a, b, leaf in zip(offsets, offsets[1:], leaves)])
    flat, covered = np.zeros(offsets[-1], dtype=np.float32), np.zeros(offsets[-1], dtype=bool)
    for key, where in params_from_jax(tagged, port_model).items():
        index = where.numpy().astype(np.int64).reshape(-1)
        flat[index] = port_params[key].float().numpy().reshape(-1)
        covered[index] = True
    assert covered.all(), "a JAX parameter element has no port counterpart"
    return jax.tree.unflatten(treedef, [flat[a:b].reshape(leaf.shape).astype(leaf.dtype)
                                        for a, b, leaf in zip(offsets, offsets[1:], leaves)])


def _jax_first_step(model_cfg: dict, port_params: dict, batch: dict) -> dict:
    """The JAX step on a cp 2 x tp 2 mesh from the port's parameters: its
    loss and grad norm on `batch`."""
    port_model = GPT2LLM(**model_cfg)
    model = JaxGPT2LLM(**{**model_cfg, "sequence_length": WARM_SEQ, "lm_head_chunk_size": WARM_CHUNK})
    model = model.update_train_spec(
        mixed_precision=JaxMixedPrecision(param_dtype="float32", compute_dtype="float32", reduce_dtype="float32"))
    JaxActivationCheckpointing.apply(model, "full_activation_checkpointing")
    mesh = get_device_mesh(device_type="cpu", data_parallel_replicate_degree=1, data_parallel_shard_degree=1,
                           context_parallel_degree=2, tensor_parallel_degree=2, world_size=WORLD,
                           devices=jax.devices()[:WORLD])
    opt = JaxOptimizers.get_adam_w(wrapped_model=model, **OPT)
    sched = JaxWarmupCosine(name="linear_warmup_cosine_annealing_lr", optimizer=opt, **SCHED)
    fns = TrainStepBuilder(model=model, loss_fn=JaxLoss("target_ids", "logits"), optimizer_spec=opt,
                           scheduler_spec=sched, mesh_handle=mesh, gradient_acc_steps=1, grad_clip_norm=1.0,
                           grad_clipper=JaxClipper(max_norm=1.0)).build(seed=0)
    handle = fns.app_state_handle
    params = _jax_params(port_params, jax.tree.map(np.asarray, handle.state.params), port_model)
    params = jax.tree.map(jax.device_put, params, handle.state_shardings.params)
    _, metrics = fns.train_step(handle.state.replace(params=params), fns.put_batch(batch))
    return {k: float(metrics[k]) for k in ("loss", "grad_norm")}


def test_the_7b_pretrain_twin_then_the_32k_warmstart_twin(tmp_path):
    pretrain, warm = _twins(tmp_path)
    info = tmp_path / "checkpoints" / "last_checkpoint_info.json"
    pre = run_world(WORLD, cli_command_worker, ["run", "--config_file_path", str(pretrain)])
    ranks = run_world(WORLD, cli_command_worker, ["warmstart", "--config_file_path", str(warm),
                                                  "--last_checkpoint_info_file_path", str(info)])

    # the pretrain: 4 steps, saved at step 4 with its progress in the folder's name
    steps = pre[0]["steps"] + ranks[0]["steps"]
    assert len(steps) == PRE_STEPS + WARM_STEPS
    assert all(r["steps"] == pre[0]["steps"] for r in pre) and all(r["steps"] == ranks[0]["steps"] for r in ranks)
    assert np.isfinite(steps).all()
    pre_rows, warm_rows = _rows(tmp_path / "pretrain" / "experiments"), _rows(tmp_path / "warm" / "experiments")
    assert [r["num_train_steps_done"] for r in pre_rows] == list(range(1, PRE_STEPS + 1))
    assert pre_rows[-1]["metrics"]["consumed tokens"] == SEEN_TOKENS
    folders = {p.name: p for p in (tmp_path / "checkpoints").iterdir() if p.is_dir()}
    pre_folder = [p for name, p in folders.items() if f"seen_steps_{PRE_STEPS}-seen_tokens_{SEEN_TOKENS}-" in name]
    assert len(pre_folder) == 1, sorted(folders)

    # the warmstart: progress from the folder's name, steps 5-6, the tokens on top, saved at step 6
    assert [r["num_train_steps_done"] for r in warm_rows] == [PRE_STEPS + 1, PRE_STEPS + WARM_STEPS]
    assert warm_rows[-1]["metrics"]["consumed tokens"] == SEEN_TOKENS + WARM_STEPS * WARM_SEQ
    assert f"[train] step {PRE_STEPS + 1}:" in ranks[0]["printed"][0]
    assert "mesh {'dp_shard': 1, 'cp': 2, 'tp': 2}" in ranks[0]["printed"][0]
    last = Path(json.loads(info.read_text())["checkpoint_folder_path"])
    assert f"seen_steps_{PRE_STEPS + WARM_STEPS}-" in last.name
    # loss continuity: the restored weights keep the trained regime at twice the context
    assert steps[PRE_STEPS][0] < steps[PRE_STEPS - 1][0] + 0.5

    # the warmstart's first step from the folder: the port's f32 step on the recipe's mesh against the JAX step
    batch = ranks[0]["batches"][0]
    assert batch["samples"]["input_ids"].shape == (1, 1, WARM_SEQ)
    model_cfg = load_app_config_dict(pretrain, experiment_id="chain")["model_raw"]["config"]
    spec = {"degrees": {"cp": 2, "tp": 2}, "remat": True, "opt": OPT, "sched": SCHED, "clip": 1.0, "acc": 1,
            "batches": [batch], "model": {**model_cfg, "sequence_length": WARM_SEQ, "lm_head_chunk_size": WARM_CHUNK}}
    port = run_world(WORLD, resume_worker, spec, str(pre_folder[0]))
    want = _jax_first_step(model_cfg, restore_tree_single_device(pre_folder[0], device="cpu"), batch)
    for r in port:
        np.testing.assert_allclose(r[0][:2], [want["loss"], want["grad_norm"]], **TOL)
    np.testing.assert_allclose(steps[PRE_STEPS][:2], port[0][0][:2], rtol=1e-3)  # the CLI's bf16 block compute

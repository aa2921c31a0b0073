"""The port's train step on gloo worlds (FSDP2 over the device mesh, the cp
ring) against the JAX package's `TrainStepBuilder` on a mesh of the same
degrees over the 8 CPU devices of tests/conftest.py, and against the port's
own world-1 step without a mesh.

The tiny GPT2 of tests/models/test_gpt2_model.py (2 layers of width 128: the
config's checks want widths divisible by 128), all in f32, takes 3 optimizer
steps of 2 microbatches with AdamW (weight decay 0.1, `[embedding, norm]`
excluded), linear-warmup-cosine and global-norm clipping at 1.0, from the
JAX state's parameters (`params_from_jax`). Both sides see the same global
rows: the JAX step puts a microbatch's rows on the dp coordinates in blocks,
each port rank takes rows dp_rank, dp_rank + dp, ... (as the sampler deals
them); the sums are over the same rows and chunks in other orders.

Worlds here: dp_shard 2; dp_replicate 2 x dp_shard 2 (HSDP). The context
parallel worlds run the same test in tests/test_torch_parallel_train_cp.py
(a file of their own, so that each file stays short). Tolerance: loss,
grad_norm and lr 1e-5, parameters after the steps 1e-5
(tests/test_torch_train_step.py's: the same fp32 math summed in other
orders)."""

import jax
import numpy as np
import pytest
import torch

from modalities_tpu.loss_functions import CLMCrossEntropyLoss as JaxLoss
from modalities_tpu.models.model import MixedPrecisionSpec as JaxMixedPrecision
from modalities_tpu.optimizers.optimizer_factory import OptimizerFactory as JaxOptimizers
from modalities_tpu.optimizers.scheduler_factory import LinearWarmupCosineAnnealingLRScheduler as JaxWarmupCosine
from modalities_tpu.running_env.device_mesh import get_device_mesh
from modalities_tpu.training.activation_checkpointing import ActivationCheckpointing as JaxActivationCheckpointing
from modalities_tpu.training.gradient_clipping import GradientClipper as JaxClipper
from modalities_tpu.training.train_step import TrainStepBuilder
from modalities_tpu_torch.conversion.from_jax import params_from_jax
from modalities_tpu_torch.models.gpt2.gpt2_model import GPT2LLM
from tests.models.test_gpt2_model import tiny_gpt2
from tests.test_torch_gloo import _tiny_step, run_world, train_worker
from tests.test_torch_gpt2 import port_config
from tests.test_torch_train_step import OPT, SCHED, TOL

STEPS, ACC, MB, SEQ, CLIP = 3, 2, 4, 32, 1.0  # MB: the global micro batch, split over the dp ranks
WORLDS = {
    "dp_shard-2": dict(degrees={"dp_shard": 2}),
    "dp_replicate-2-x-dp_shard-2": dict(degrees={"dp_replicate": 2, "dp_shard": 2}),
}


def _batches(mask: bool, mb: int = MB) -> list[dict]:
    rng = np.random.default_rng(23)
    out = []
    for _ in range(STEPS):
        tokens = rng.integers(0, 128, size=(ACC, mb, SEQ + 1))
        targets = tokens[..., 1:].astype(np.int32)
        if mask:  # unequal counts: row 0 keeps its first quarter, row 1 loses its last 5 tokens
            targets[:, 0, SEQ // 4:] = -100
            targets[:, 1, -5:] = -100
        out.append({"samples": {"input_ids": tokens[..., :-1].astype(np.int32)}, "targets": {"target_ids": targets}})
    return out


def _jax_run(world: dict, batches: list[dict]):
    chunk, remat = world.get("chunk"), world.get("remat", False)
    model = tiny_gpt2("dao_flash", use_weight_tying=chunk is not None or world.get("tied", False),
                      lm_head_chunk_size=chunk, n_layer=world.get("n_layer", 2), bias=world.get("bias", False)).update_train_spec(
        mixed_precision=JaxMixedPrecision(param_dtype="float32", compute_dtype="float32", reduce_dtype="float32"))
    if world.get("pipeline"):
        model.with_spec_updates(**world["pipeline"])
    if remat:
        JaxActivationCheckpointing.apply(model, "full_activation_checkpointing")
    degrees = world["degrees"]
    size = int(np.prod(list(degrees.values())))
    mesh = get_device_mesh(device_type="cpu", data_parallel_replicate_degree=degrees.get("dp_replicate", 1),
                           data_parallel_shard_degree=degrees.get("dp_shard", 1),
                           context_parallel_degree=degrees.get("cp", 1), tensor_parallel_degree=degrees.get("tp", 1),
                           pipeline_parallel_degree=degrees.get("pp", 1), dcn_parallel_degree=degrees.get("dcn", 1),
                           enable_loss_parallel=world.get("loss_parallel", False), zero_stage=world.get("zero", 0),
                           world_size=size, devices=jax.devices()[:size])
    opt = JaxOptimizers.get_adam_w(wrapped_model=model, **OPT)
    sched = JaxWarmupCosine(name="linear_warmup_cosine_annealing_lr", optimizer=opt, **SCHED)
    fns = TrainStepBuilder(model=model, loss_fn=JaxLoss("target_ids", "logits"), optimizer_spec=opt,
                           scheduler_spec=sched, mesh_handle=mesh, gradient_acc_steps=ACC, grad_clip_norm=CLIP,
                           grad_clipper=JaxClipper(max_norm=CLIP)).build(seed=0)
    state = fns.app_state_handle.state
    params0 = jax.tree.map(np.array, state.params)  # copied: the jitted step donates its state
    metrics = []
    for batch in batches:
        state, m = fns.train_step(state, fns.put_batch(batch))
        metrics.append([float(m[k]) for k in ("loss", "grad_norm", "lr")])
    return params0, metrics, jax.tree.map(np.asarray, state.params), size


def _spec(world: dict, params: dict, batches: list[dict], degrees) -> dict:
    chunk = world.get("chunk")
    model = port_config(attention_implementation="dao_flash", use_weight_tying=chunk is not None or world.get("tied", False),
                        lm_head_chunk_size=chunk, lm_head_fused_ce="auto", n_layer=world.get("n_layer", 2),
                        bias=world.get("bias", False))
    return {"degrees": degrees, "model": model, "remat": world.get("remat", False), "opt": OPT, "sched": SCHED,
            "clip": CLIP, "acc": ACC, "params": params, "batches": batches,
            "loss_parallel": world.get("loss_parallel", False) and degrees is not None,
            "pipeline": world.get("pipeline") if degrees is not None else None,
            "zero": world.get("zero", 0) if degrees is not None else 0,
            "moments": world.get("moments", False), "count_dcn": world.get("count_dcn", False)}


@pytest.mark.parametrize("name", list(WORLDS))
def test_the_gloo_world_matches_the_jax_mesh_step_and_the_world_1_step(name):
    check_world(WORLDS[name])


def check_world(world: dict) -> tuple[list[dict], dict]:
    """The gloo world of `world["degrees"]` against the JAX mesh step and
    (unless `world["world_1"]` is False: under dcn each slice normalizes its
    own loss) the port's world-1 step; returns what each rank returned and
    the initial parameters (the JAX state's, in the port's names)."""
    batches = _batches(world.get("mask", False), world.get("mb", MB))
    params0, jax_metrics, jax_final, size = _jax_run(world, batches)
    port_model = GPT2LLM(**_spec(world, None, batches, None)["model"])
    params = {k: v.numpy() for k, v in params_from_jax(params0, port_model).items()}
    ranks = run_world(size, train_worker, _spec(world, params, batches, world["degrees"]))

    # the port's world-1 step, no mesh, on the whole global batch
    single, single_metrics = None, None
    if world.get("world_1", True):
        single, _ = _tiny_step(_spec(world, params, batches, None), 1)
        single_metrics = []
        for batch in batches:
            m = single({part: {k: torch.from_numpy(v) for k, v in d.items()} for part, d in batch.items()})
            single_metrics.append([float(m[k]) for k in ("loss", "grad_norm", "lr")])

    # `jax_grad_norm_factor`: the JAX step's reported norm is that many times the world's (a reference caveat)
    jax_metrics = (np.asarray(jax_metrics) / [1.0, world.get("jax_grad_norm_factor", 1.0), 1.0]).tolist()
    for r in ranks:  # every rank reports the global metrics
        np.testing.assert_allclose(r["metrics"], jax_metrics, err_msg="gloo world vs JAX mesh", **TOL)
        if single_metrics is not None:
            np.testing.assert_allclose(r["metrics"], single_metrics, err_msg="gloo world vs world 1", **TOL)
    assert jax_metrics[0][1] > 0 and jax_metrics[-1][2] > 0
    want = {k: v.numpy() for k, v in params_from_jax(jax_final, port_model).items()}
    got = {k: v for r in ranks if r["state"] is not None for k, v in r["state"].items()}  # pp: each stage's share
    assert set(got) == set(want)
    for key in want:
        np.testing.assert_allclose(got[key], want[key], err_msg=key, **TOL)
    if single is not None:
        got_single = {k: v.detach().numpy() for k, v in single.state_dict().items()}
        assert set(got_single) == set(want)
        for key in want:
            np.testing.assert_allclose(got[key], got_single[key], err_msg=key, **TOL)
    return ranks, params

"""Port parity for the train step (modalities_tpu_torch/training/train_step.py)
against the JAX package's `TrainStepBuilder` with no mesh, on
tests/models/test_gpt2_model.py:tiny_gpt2 (dao_flash, untied head; on the CPU
JAX runs its XLA SDPA tier and the port its plain attention). The JAX state's
parameters are carried across with `params_from_jax`; both take 3 optimizer
steps of 2 microbatches on the same numpy tokens, with AdamW (weight decay
0.1, `[embedding, norm]` excluded), linear-warmup-cosine and global-norm
clipping, all in f32.

Tolerances: loss, grad_norm and lr 1e-5; parameters after the steps 1e-5
(measured maxima 4.8e-7 on the metrics and 3.5e-7 on the parameters: the same
fp32 math, summed in other orders; no Adam sign flips on near-zero grads)."""

import jax
import numpy as np
import pytest
import torch

from modalities_tpu.loss_functions import CLMCrossEntropyLoss as JaxLoss
from modalities_tpu.models.model import MixedPrecisionSpec as JaxMixedPrecision
from modalities_tpu.optimizers.optimizer_factory import OptimizerFactory as JaxOptimizers
from modalities_tpu.optimizers.optimizer_factory import build_weight_decay_mask
from modalities_tpu.optimizers.scheduler_factory import LinearWarmupCosineAnnealingLRScheduler as JaxWarmupCosine
from modalities_tpu.training.gradient_clipping import GradientClipper as JaxClipper
from modalities_tpu.training.train_step import TrainStepBuilder
from modalities_tpu_torch.conversion.from_jax import params_from_jax
from modalities_tpu_torch.loss_functions import CLMCrossEntropyLoss
from modalities_tpu_torch.models.gpt2.gpt2_model import GPT2LLM, MixedPrecisionSpec
from modalities_tpu_torch.optimizers.optimizer_factory import OptimizerFactory, weight_decay_mask
from modalities_tpu_torch.optimizers.scheduler_factory import LinearWarmupCosineAnnealingLRScheduler
from modalities_tpu_torch.training.gradient_clipping import GradientClipper
from modalities_tpu_torch.training.train_step import TrainStep
from tests.models.test_gpt2_model import tiny_gpt2
from tests.test_torch_gpt2 import port_config

TOL = dict(atol=1e-5, rtol=1e-5)
OPT = dict(lr=1e-3, betas=(0.9, 0.95), eps=1e-8, weight_decay=0.1, weight_decay_groups_excluded=["embedding", "norm"])
SCHED = dict(warmup_steps=2, total_steps=10, initial_lr=0.0, final_lr=1e-4, max_lr=1e-3)
STEPS, ACC, MB, SEQ = 3, 2, 2, 32


def _jax_side(clip):
    model = tiny_gpt2("dao_flash", use_weight_tying=False).update_train_spec(
        mixed_precision=JaxMixedPrecision(param_dtype="float32", compute_dtype="float32", reduce_dtype="float32")
    )
    opt = JaxOptimizers.get_adam_w(wrapped_model=model, **OPT)
    sched = JaxWarmupCosine(name="linear_warmup_cosine_annealing_lr", optimizer=opt, **SCHED)
    clipper = JaxClipper(max_norm=clip)
    builder = TrainStepBuilder(model=model, loss_fn=JaxLoss("target_ids", "logits"), optimizer_spec=opt,
                               scheduler_spec=sched, gradient_acc_steps=ACC, grad_clip_norm=clip,
                               grad_clipper=clipper)
    return model, opt, sched, builder.build(seed=0)


def _port_side(clip, params):
    model = GPT2LLM(**port_config(attention_implementation="dao_flash", use_weight_tying=False))
    model.update_train_spec(mixed_precision=MixedPrecisionSpec("float32", "float32", "float32"))
    opt = OptimizerFactory.get_adam_w(wrapped_model=model, **OPT)
    sched = LinearWarmupCosineAnnealingLRScheduler(optimizer=opt, **SCHED)
    step = TrainStep(model, CLMCrossEntropyLoss("target_ids", "logits"), opt, sched, device="cpu",
                     gradient_acc_steps=ACC, grad_clipper=GradientClipper(max_norm=clip),
                     params=params_from_jax(params, model))
    return model, step


def _batches():
    rng = np.random.default_rng(11)
    for _ in range(STEPS):
        tokens = rng.integers(0, 128, size=(ACC, MB, SEQ + 1))
        yield {"samples": {"input_ids": tokens[..., :-1].astype(np.int32)},
               "targets": {"target_ids": tokens[..., 1:].astype(np.int32)}}


@pytest.mark.parametrize("clip", [1.0, 1e-3], ids=["clip-1", "clip-1e-3-acts"])
def test_three_steps_match_the_jax_train_step(clip):
    _, _, _, fns = _jax_side(clip)
    state = fns.app_state_handle.state
    params0 = jax.tree.map(np.array, state.params)  # copied: the jitted step donates its state
    model, step = _port_side(clip, params0)
    clipped = False
    for batch in _batches():
        state, jm = fns.train_step(state, fns.put_batch(batch))
        pm = step({k: {kk: torch.from_numpy(v) for kk, v in d.items()} for k, d in batch.items()})
        for key in ("loss", "grad_norm", "lr"):
            np.testing.assert_allclose(float(pm[key]), float(jm[key]), err_msg=key, **TOL)
        clipped |= float(jm["grad_norm"]) > clip
    assert clipped or clip == 1.0  # the 1e-3 case really clips
    want = {k: v.numpy() for k, v in params_from_jax(jax.tree.map(np.asarray, state.params), model).items()}
    got = {k: v.detach().numpy() for k, v in step.state_dict().items()}
    assert set(got) == set(want)
    for name in want:
        np.testing.assert_allclose(got[name], want[name], err_msg=name, **TOL)


def test_weight_decay_masks_are_equal():
    jax_model, _, _, fns = _jax_side(1.0)
    params = jax.tree.map(np.asarray, fns.app_state_handle.state.params)
    mask = build_weight_decay_mask(params, jax_model, OPT["weight_decay_groups_excluded"])
    as_arrays = jax.tree.map(lambda m, p: np.full(np.shape(p), float(m), np.float32), mask, params)
    model = GPT2LLM(**port_config(attention_implementation="dao_flash", use_weight_tying=False))
    want = {k: bool(v.reshape(-1)[0]) for k, v in params_from_jax(as_arrays, model).items()}
    got = weight_decay_mask(list(want), model.weight_decay_groups, OPT["weight_decay_groups_excluded"])
    assert got == want
    assert not got["wte"] and not got["blocks.0.attention_norm.scale"] and got["lm_head.kernel"]


def test_schedule_values_match_for_every_step():
    jax_opt = JaxOptimizers.get_adam_w(wrapped_model=None, **OPT)
    for sched in (SCHED, dict(SCHED, warmup_steps=1, initial_lr=1.6e-4)):
        jax_lr = JaxWarmupCosine(name="s", optimizer=jax_opt, **sched).absolute_lr_schedule()
        port = LinearWarmupCosineAnnealingLRScheduler(optimizer=OptimizerFactory.get_adam_w(wrapped_model=None, **OPT),
                                                      **sched)
        fn = port.schedule()
        for step in range(0, 13):
            np.testing.assert_allclose(OPT["lr"] * fn(step), float(jax_lr(step)), rtol=1e-6, atol=1e-12)


def test_knobs_the_port_does_not_have_raise():
    model = GPT2LLM(**port_config(lm_head_chunk_size=16))
    opt = OptimizerFactory.get_adam_w(wrapped_model=model, **OPT)
    with pytest.raises(NotImplementedError, match="lm_head_chunk_size"):
        TrainStep(model, CLMCrossEntropyLoss("target_ids", "logits"), opt, device="cpu")
    with pytest.raises(NotImplementedError, match="fused-CE"):
        CLMCrossEntropyLoss("target_ids", "logits").fused_sum_and_count(None, None, None)

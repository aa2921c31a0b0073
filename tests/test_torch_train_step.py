"""Port parity for the train step (modalities_tpu_torch/training/train_step.py)
against the JAX package's `TrainStepBuilder` with no mesh. The full-logits
head runs on
tests/models/test_gpt2_model.py:tiny_gpt2 (dao_flash, untied head; on the CPU
JAX runs its XLA SDPA tier and the port its plain attention). The JAX state's
parameters are carried across with `params_from_jax`; both take 3 optimizer
steps of 2 microbatches on the same numpy tokens, with AdamW (weight decay
0.1, `[embedding, norm]` excluded), linear-warmup-cosine and global-norm
clipping, all in f32.

Tolerances: loss, grad_norm and lr 1e-5; parameters after the steps 1e-5
(measured maxima 4.8e-7 on the metrics and 3.5e-7 on the parameters: the same
fp32 math, summed in other orders; no Adam sign flips on near-zero grads).

The chunked heads (`lm_head_chunk_size` 8, and 5 with a ragged tail) run on
the tied tiny GPT2 with full remat on both sides: the port's fused-CE route
and its chunked scan against the JAX builder's chunked scan (its CPU tier),
at the same tolerances."""

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
from modalities_tpu.training.activation_checkpointing import ActivationCheckpointing as JaxActivationCheckpointing
from modalities_tpu.training.train_step import TrainStepBuilder
from modalities_tpu_torch.conversion.from_jax import params_from_jax
from modalities_tpu_torch.loss_functions import CLMCrossEntropyLoss
from modalities_tpu_torch.models.gpt2.gpt2_model import GPT2LLM, MixedPrecisionSpec
from modalities_tpu_torch.optimizers.optimizer_factory import OptimizerFactory, weight_decay_mask
from modalities_tpu_torch.optimizers.scheduler_factory import LinearWarmupCosineAnnealingLRScheduler
from modalities_tpu_torch.training.activation_checkpointing import apply_activation_checkpointing
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
    with pytest.raises(NotImplementedError, match="selective_op"):
        apply_activation_checkpointing(model, "selective_op_activation_checkpointing")
    with pytest.raises(ValueError, match="Unknown activation checkpointing"):
        apply_activation_checkpointing(model, "everything")


class _MeanOnlyLoss:
    """A loss without the (sum, count) accumulation form."""

    target_key, prediction_key = "target_ids", "logits"

    def __call__(self, predictions, targets):
        return predictions["logits"].mean()


def test_a_chunked_head_without_a_sum_and_count_loss_raises():
    model = GPT2LLM(**port_config(lm_head_chunk_size=16))
    opt = OptimizerFactory.get_adam_w(wrapped_model=model, **OPT)
    with pytest.raises(ValueError, match="sum_and_count"):
        TrainStep(model, _MeanOnlyLoss(), opt, device="cpu")


# ------------------------------------------------- the chunked / fused-CE head, with remat


def _jax_chunked(chunk, tied=True):
    model = tiny_gpt2("dao_flash", use_weight_tying=tied, lm_head_chunk_size=chunk).update_train_spec(
        mixed_precision=JaxMixedPrecision(param_dtype="float32", compute_dtype="float32", reduce_dtype="float32")
    )
    JaxActivationCheckpointing.apply(model, "full_activation_checkpointing")
    opt = JaxOptimizers.get_adam_w(wrapped_model=model, **OPT)
    sched = JaxWarmupCosine(name="linear_warmup_cosine_annealing_lr", optimizer=opt, **SCHED)
    builder = TrainStepBuilder(model=model, loss_fn=JaxLoss("target_ids", "logits"), optimizer_spec=opt,
                               scheduler_spec=sched, gradient_acc_steps=ACC, grad_clip_norm=1.0,
                               grad_clipper=JaxClipper(max_norm=1.0))
    return builder.build(seed=0)


def _port_chunked(chunk, route, params, remat="full_activation_checkpointing", tied=True):
    model = GPT2LLM(**port_config(attention_implementation="dao_flash", use_weight_tying=tied,
                                  lm_head_chunk_size=chunk, lm_head_fused_ce=route))
    model.update_train_spec(mixed_precision=MixedPrecisionSpec("float32", "float32", "float32"))
    if remat is not None:
        apply_activation_checkpointing(model, remat, ac_freq=2 if remat.startswith("selective") else 1)
    opt = OptimizerFactory.get_adam_w(wrapped_model=model, **OPT)
    sched = LinearWarmupCosineAnnealingLRScheduler(optimizer=opt, **SCHED)
    return model, TrainStep(model, CLMCrossEntropyLoss("target_ids", "logits"), opt, sched, device="cpu",
                            gradient_acc_steps=ACC, grad_clipper=GradientClipper(max_norm=1.0), params=params)


@pytest.mark.parametrize(
    "chunk,route,tied",
    [(8, "auto", True), (8, "off", True), (5, "auto", True), (5, "off", True), (8, "auto", False)],
    ids=["chunk-8-fused-ce", "chunk-8-chunked-scan", "chunk-5-ragged-tail-fused-ce",
         "chunk-5-ragged-tail-chunked-scan", "chunk-8-fused-ce-untied-head"],
)
def test_chunked_heads_with_full_remat_match_the_jax_train_step(chunk, route, tied):
    """The tiny GPT2 with `lm_head_chunk_size` and full remat: the port's
    fused-CE route (`auto`) and its chunked scan (`off`) against the JAX
    builder on its CPU tier (the chunked scan), 3 steps at 1e-5; the tied head
    throughout, and once the untied one (the head weight is lm_head's kernel
    transposed)."""
    fns = _jax_chunked(chunk, tied)
    state = fns.app_state_handle.state
    params0 = jax.tree.map(np.array, state.params)
    model = GPT2LLM(**port_config(use_weight_tying=tied))
    _, step = _port_chunked(chunk, route, params_from_jax(params0, model), tied=tied)
    assert step.fused_ce == (route == "auto") and step.model.config_spec.remat_variant == "full"
    for batch in _batches():
        state, jm = fns.train_step(state, fns.put_batch(batch))
        pm = step({k: {kk: torch.from_numpy(v) for kk, v in d.items()} for k, d in batch.items()})
        for key in ("loss", "grad_norm", "lr"):
            np.testing.assert_allclose(float(pm[key]), float(jm[key]), err_msg=key, **TOL)
    want = {k: v.numpy() for k, v in params_from_jax(jax.tree.map(np.asarray, state.params), model).items()}
    got = {k: v.detach().numpy() for k, v in step.state_dict().items()}
    for name in want:
        np.testing.assert_allclose(got[name], want[name], err_msg=name, **TOL)


@pytest.mark.parametrize("route", ["auto", "off"], ids=["fused-ce", "chunked-scan"])
def test_remat_on_and_off_give_equal_gradients(route):
    """The recomputed forward is the forward: full, every-other-block and no
    remat give the same loss and gradients."""
    model = GPT2LLM(**port_config(use_weight_tying=True))
    params = model.init_train_params(torch.Generator().manual_seed(3))
    tokens = torch.as_tensor(np.random.default_rng(4).integers(0, 128, size=(MB, SEQ + 1)))
    seen = []
    for remat in (None, "full_activation_checkpointing", "selective_layer_activation_checkpointing"):
        _, step = _port_chunked(5, route, {k: v.clone() for k, v in params.items()}, remat=remat)
        loss = step._loss(tokens[:, :-1], {"target_ids": tokens[:, 1:]})
        seen.append((loss.detach(), torch.autograd.grad(loss, step.params)))
    for loss, grads in seen[1:]:
        assert torch.equal(loss, seen[0][0])
        for a, b in zip(grads, seen[0][1]):
            torch.testing.assert_close(a, b, rtol=0, atol=1e-7)

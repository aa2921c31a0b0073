"""The anomaly skip of the port's train step (training/train_step.py,
`anomaly_policy` skip_step) against the JAX `TrainStepBuilder` with the same
policy, on tests/test_torch_train_step.py's tiny GPT2 (f32, AdamW with weight
decay, warmup-cosine, clipping at 1.0), weights carried across by
`params_from_jax`:

- 3 steps with `nan_grads@1` (the second step's gradients are NaN: skipped)
  and `loss_spike@2:1e3` (the third step's reported loss jumps; finite, so it
  updates), each package arming its own fault points: loss, grad norm, lr and
  `skipped_step` a step, then the parameters, both moments and the Adam step
  count, at 1e-5, against the JAX state as it runs. The skipped step leaves
  the parameters, the moments and the count bitwise as they were. Both sides
  report the schedule at the step count and apply it at the optimizer's own
  count, which the skip holds, so step 3 applies the rate of step 2 on both;
- with nothing armed, the skip_step step is bitwise the raise step, and the
  raise step bitwise a step without the component (policy None).
"""

import jax
import numpy as np
import pytest
import torch

from modalities_tpu.loss_functions import CLMCrossEntropyLoss as JaxLoss
from modalities_tpu.resilience import faults as jax_faults
from modalities_tpu.training.gradient_clipping import GradientClipper as JaxClipper
from modalities_tpu.training.train_step import TrainStepBuilder
from modalities_tpu_torch.conversion.from_jax import _find_adam_state, params_from_jax
from modalities_tpu_torch.resilience import faults
from tests.test_torch_train_step import ACC, TOL, _batches, _jax_side, _port_side

SPEC = "nan_grads@1,loss_spike@2:1e3"


@pytest.fixture
def armed():
    jax_faults.clear_faults()
    faults.clear_faults()
    jax_faults.arm_faults(SPEC)
    faults.arm_faults(SPEC)
    yield
    jax_faults.clear_faults()
    faults.clear_faults()


def _torch_batch(batch):
    return {k: {kk: torch.from_numpy(v) for kk, v in d.items()} for k, d in batch.items()}


def _port_state(step):
    """{name: (param, exp_avg, exp_avg_sq, step count)} as numpy."""
    out = {}
    for name, p in step.module.named_parameters():
        st = step.optimizer.state[p]
        out[name] = tuple(t.detach().clone().numpy() for t in (p, st["exp_avg"], st["exp_avg_sq"], st["step"]))
    return out


def test_three_faulted_steps_match_the_jax_skip_step(armed):
    model, opt, sched, _ = _jax_side(1.0)
    fns = TrainStepBuilder(model=model, loss_fn=JaxLoss("target_ids", "logits"), optimizer_spec=opt,
                           scheduler_spec=sched, gradient_acc_steps=ACC, grad_clip_norm=1.0,
                           grad_clipper=JaxClipper(max_norm=1.0), anomaly_policy="skip_step").build(seed=0)
    state = fns.app_state_handle.state
    pmodel, step = _port_side(1.0, jax.tree.map(np.array, state.params))
    step.skip_on_anomaly = True
    before = None
    for i, batch in enumerate(_batches()):
        if i == 1:
            before = _port_state(step)
        state, jm = fns.train_step(state, fns.put_batch(batch))
        pm = step(_torch_batch(batch))
        assert int(pm["skipped_step"]) == int(jm["skipped_step"]) == (1 if i == 1 else 0)
        for key in ("loss", "grad_norm", "lr"):
            if i == 1 and key == "grad_norm":
                assert not np.isfinite(float(pm[key])) and not np.isfinite(float(jm[key]))
                continue
            np.testing.assert_allclose(float(pm[key]), float(jm[key]), err_msg=f"step {i + 1} {key}", **TOL)
        if i == 1:  # the skipped step: everything bitwise as before it, the schedule advanced
            after = _port_state(step)
            for name in before:
                for a, b in zip(before[name], after[name]):
                    assert np.array_equal(a, b), name
            assert step.scheduler.last_epoch == 2
    assert float(pm["loss"]) > 1e3  # the spike rode the third step's loss
    adam = _find_adam_state(state.opt_state)
    mu, nu = params_from_jax(adam["mu"], pmodel), params_from_jax(adam["nu"], pmodel)
    params = params_from_jax(jax.tree.map(np.asarray, state.params), pmodel)
    got = _port_state(step)
    for name, (p, m, v, count) in got.items():
        np.testing.assert_allclose(p, params[name].numpy(), err_msg=name, **TOL)
        np.testing.assert_allclose(m, mu[name].numpy(), err_msg=name, **TOL)
        np.testing.assert_allclose(v, nu[name].numpy(), err_msg=name, **TOL)
        assert float(count) == float(np.asarray(adam["count"])) == 2.0


def test_skip_step_with_nothing_armed_is_bitwise_the_raise_step():
    faults.clear_faults()
    _, _, _, fns = _jax_side(1.0)
    params0 = jax.tree.map(np.array, fns.app_state_handle.state.params)
    runs = {}
    for policy in (None, "raise", "skip_step"):
        _, step = _port_side(1.0, params0)
        step.skip_on_anomaly = policy in ("skip_step", "rollback")
        metrics = [step(_torch_batch(b)) for b in _batches()]
        runs[policy] = (metrics, _port_state(step))
    for policy in ("raise", "skip_step"):
        for a, b in zip(runs[None][0], runs[policy][0]):
            assert all(torch.equal(a[k], b[k]) for k in ("loss", "grad_norm", "lr"))
        for name, tensors in runs[None][1].items():
            assert all(np.array_equal(x, y) for x, y in zip(tensors, runs[policy][1][name])), (policy, name)
    assert [int(m["skipped_step"]) for m in runs["skip_step"][0]] == [0, 0, 0]


@pytest.mark.parametrize("knob", [{"foreach": True}, {"fused": False}])
def test_a_config_asking_for_another_update_than_the_fused_one_is_refused(knob):
    from modalities_tpu_torch.optimizers.optimizer_factory import AdamOptimizerConfig

    with pytest.raises(NotImplementedError, match="Queue 3 item 21"):
        AdamOptimizerConfig(lr=1e-3, wrapped_model=None, betas=[0.9, 0.95], eps=1e-8, weight_decay=0.1,
                            weight_decay_groups_excluded=[], **knob)
    AdamOptimizerConfig(lr=1e-3, wrapped_model=None, betas=[0.9, 0.95], eps=1e-8, weight_decay=0.1,
                        weight_decay_groups_excluded=[], foreach=False, fused=True)

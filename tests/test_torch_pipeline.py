"""The port's pipeline executor in one process (`pp_in_process`,
parallel/pipeline_scheduled.py) on the tiny GPT2 (4 layers of width 128,
tied head, a loss mask that leaves the microbatches unequal token counts),
all in f32: for each of the five schedules, one microbatch of 4 rows split
into 4 pipeline microbatches gives the loss and every parameter's gradient
of the port's unpipelined step and of JAX `value_and_grad` of the same loss
(the JAX model's full logits, or its chunked scan for the chunked head) at
1e-5. The fused-CE route (chunks of 8) runs its plain version here. The
tied `wte` is a copy on the first and on the last stage (one under the V
placement); the sum of the copies' gradients is the gradient. Also: the
forward-only pass (eval) gives the unpipelined eval loss, a microbatch count
of 4 on pp 4, a schedule with two microbatches' B ops swapped is refused,
each stage holds its blocks under their global names, and the in-process
stages sharded with FSDP2 on a 1-rank mesh take the unsharded steps."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.core import meta

from modalities_tpu.loss_functions import CLMCrossEntropyLoss as JaxLoss
from modalities_tpu.models.model import MixedPrecisionSpec as JaxMixedPrecision
from modalities_tpu_torch.conversion.from_jax import params_from_jax
from modalities_tpu_torch.models.gpt2.gpt2_model import GPT2LLM
from modalities_tpu_torch.parallel.pipeline_scheduled import mutant_tables, pp_in_process
from tests.models.test_gpt2_model import tiny_gpt2
from tests.test_torch_gloo import _tiny_step
from tests.test_torch_gpt2 import port_config
from tests.test_torch_train_step import OPT, SCHED, TOL

ROWS, SEQ, LAYERS = 4, 32, 4
SCHEDULES = [("gpipe", 2, 1), ("1f1b", 2, 1), ("interleaved_1f1b", 2, 2), ("zbv", 2, 2), ("dualpipev", 2, 2),
             ("1f1b", 4, 1)]
ROUTES = {"full-logits": None, "fused-ce-chunk-8": 8}


def _data():
    tokens = np.random.default_rng(31).integers(0, 128, size=(ROWS, SEQ + 1))
    labels = tokens[:, 1:].copy()
    labels[0, 6:] = -100  # unequal counts over the microbatches of one row each
    labels[2, -9:] = -100
    return tokens[:, :-1].astype(np.int64), labels.astype(np.int64)


_JAX: dict = {}


def _jax_loss_and_grads(chunk):
    """JAX value_and_grad of the global token mean on the whole batch, and
    its parameters."""
    if chunk not in _JAX:
        model = tiny_gpt2("dao_flash", n_layer=LAYERS, use_weight_tying=True, lm_head_chunk_size=chunk)
        model.update_train_spec(mixed_precision=JaxMixedPrecision("float32", "float32", "float32"))
        model.with_spec_updates(param_dtype="float32", compute_dtype="float32")
        params = meta.unbox(model.init_params(jax.random.PRNGKey(0)))
        loss_fn = JaxLoss("target_ids", "logits")
        ids, labels = (jnp.asarray(a, jnp.int32) for a in _data())

        def loss(p):
            if chunk is None:
                return loss_fn(model.apply(p, {"input_ids": ids}), {"target_ids": labels})
            hidden = model.apply_hidden(p, {"input_ids": ids}, train=True)
            total = count = 0.0
            for start in range(0, SEQ, chunk):
                s, c = loss_fn.sum_and_count(model.head_logits(p, hidden[:, start:start + chunk]),
                                             labels[:, start:start + chunk])
                total, count = total + s, count + c
            return total / jnp.maximum(count, 1.0)

        value, grads = jax.value_and_grad(loss)(params)
        _JAX[chunk] = (float(value), jax.tree.map(np.asarray, grads), jax.tree.map(np.asarray, params))
    return _JAX[chunk]


def _spec(chunk, params, pipeline=None, pp=None):
    cfg = port_config(attention_implementation="dao_flash", use_weight_tying=True, n_layer=LAYERS,
                      lm_head_chunk_size=chunk, lm_head_fused_ce="auto")
    return {"degrees": None, "model": cfg, "opt": OPT, "sched": SCHED, "clip": 1.0, "acc": 1, "params": params,
            "pipeline": pipeline, "pp_in_process": pp}


def _named_grads(names, grads) -> dict:
    out: dict = {}
    for name, g in zip(names, grads):  # a tied copy's gradient adds to the other's
        out[name] = out[name] + g if name in out else g.clone()
    return {k: v.numpy() for k, v in out.items()}


@pytest.mark.parametrize("route", list(ROUTES))
@pytest.mark.parametrize("schedule,pp,virtual", SCHEDULES, ids=lambda v: str(v))
def test_each_schedule_gives_the_unpipelined_and_the_jax_loss_and_gradients(schedule, pp, virtual, route):
    chunk = ROUTES[route]
    jax_loss, jax_grads, jax_params = _jax_loss_and_grads(chunk)
    port_model = GPT2LLM(**_spec(chunk, None)["model"])
    params = {k: v.numpy() for k, v in params_from_jax(jax_params, port_model).items()}
    want = {k: v.numpy() for k, v in params_from_jax(jax_grads, port_model).items()}
    ids, labels = (torch.from_numpy(a) for a in _data())

    single, _ = _tiny_step(_spec(chunk, params), 1)
    loss = single._loss(ids, {"target_ids": labels})
    loss.backward()
    unpipelined = _named_grads([n for n, _ in single.module.named_parameters()], [p.grad for p in single.params])

    step, _ = _tiny_step(_spec(chunk, params, {"pp_schedule": schedule, "pp_num_microbatches": 4,
                                               "pp_num_virtual": virtual}, pp), 1)
    assert len(step.stages) == pp and step.fused_ce == (chunk is not None)
    acc = step._zero_accumulators()  # each backward's gradients go into the fp32 accumulators
    total, count = step._pp_run(ids, labels)
    got = _named_grads([n for st in step.stages for n, _ in st.module.named_parameters()], acc)

    assert int(count) == int((labels != -100).sum())
    np.testing.assert_allclose(float(total), float(loss), **TOL)
    np.testing.assert_allclose(float(total), jax_loss, **TOL)
    assert set(got) == set(want) == set(unpipelined)
    for name in want:
        np.testing.assert_allclose(got[name], unpipelined[name], err_msg=name, **TOL)
        np.testing.assert_allclose(got[name], want[name], err_msg=name, **TOL)


def test_the_forward_alone_gives_the_eval_loss_and_stages_keep_global_names():
    _, _, jax_params = _jax_loss_and_grads(None)
    params = {k: v.numpy() for k, v in params_from_jax(jax_params, GPT2LLM(**_spec(None, None)["model"])).items()}
    ids, labels = (torch.from_numpy(a) for a in _data())
    batch = {"samples": {"input_ids": ids}, "targets": {"target_ids": labels}}
    single, _ = _tiny_step(_spec(None, params), 1)
    step, _ = _tiny_step(_spec(None, params, {"pp_schedule": "interleaved_1f1b", "pp_num_microbatches": 4,
                                              "pp_num_virtual": 2}, 2), 1)
    np.testing.assert_allclose(float(step.eval_step(batch)["loss"]), float(single.eval_step(batch)["loss"]), **TOL)
    assert all(p.grad is None for p in step.params)
    # interleaved over 2 devices: device 0 runs global stages 0 and 2 (layers 0 and 2) and the embedding,
    # device 1 stages 1 and 3 (layers 1 and 3) and the head
    names = [set(st.module.state_dict()) for st in step.stages]
    assert {n.split(".")[1] for n in names[0] if n.startswith("blocks.")} == {"0", "2"}
    assert {n.split(".")[1] for n in names[1] if n.startswith("blocks.")} == {"1", "3"}
    assert "wte" in names[0] and "wte" in names[1] and "lm_head_norm.scale" in names[1]
    assert "lm_head_norm.scale" not in names[0]
    assert names[0] | names[1] == set(single.module.state_dict())


def test_a_schedule_with_two_backward_ops_swapped_is_refused():
    params = {k: v.numpy() for k, v in GPT2LLM(**_spec(None, None)["model"]).init_params(
        torch.Generator().manual_seed(0)).items()}
    step, _ = _tiny_step(_spec(None, params, {"pp_schedule": "1f1b", "pp_num_microbatches": 4}, 2), 1)
    ids, labels = (torch.from_numpy(a) for a in _data())
    tables = step._tables(2, 4)
    mutant = mutant_tables(tables, 0, 0, 1)
    with pytest.raises(ValueError, match="pipeline tables refused"):
        pp_in_process(step.stages, mutant, list(ids.chunk(4)), lambda module, hidden, m: hidden.sum())
    assert all(p.grad is None for p in step.params)


@pytest.mark.parametrize("schedule,virtual", [("gpipe", 1), ("1f1b", 1), ("interleaved_1f1b", 2), ("zbv", 2)])
def test_in_process_stages_under_fsdp2_on_a_1_rank_mesh_take_the_unsharded_steps(schedule, virtual):
    """`pp_in_process` on a world-1 mesh (each stage a root of FSDP2, as the
    card's one-GPU check runs it): 2 optimizer steps give the losses, grad
    norms, rates and parameters of the same stages without a mesh."""
    from torch.distributed.fsdp import FSDPModule

    from modalities_tpu_torch.running_env import env

    params = {k: v.numpy() for k, v in GPT2LLM(**_spec(None, None)["model"]).init_params(
        torch.Generator().manual_seed(0)).items()}
    ids, labels = (torch.from_numpy(a) for a in _data())
    batch = {"samples": {"input_ids": ids[None]}, "targets": {"target_ids": labels[None]}}
    pipeline = {"pp_schedule": schedule, "pp_num_microbatches": 4, "pp_num_virtual": virtual}
    runs = []
    for degrees in (None, {"dp_shard": 1}):
        with env.process_group(torch.device("cpu")):
            step, _ = _tiny_step({**_spec(None, params, pipeline, 2), "degrees": degrees}, 1)
            assert step.module is None and len(step.stages) == 2
            assert all(isinstance(st.module, FSDPModule) == (degrees is not None) for st in step.stages)
            metrics = [[float(m[k]) for k in ("loss", "grad_norm", "lr")] for m in (step(batch), step(batch))]
            runs.append((metrics, {k: v.clone() for k, v in step.state_dict().items()}))
    (plain, plain_params), (sharded, sharded_params) = runs
    np.testing.assert_allclose(sharded, plain, **TOL)
    assert set(sharded_params) == set(plain_params)
    for name, value in sharded_params.items():
        np.testing.assert_allclose(value.numpy(), plain_params[name].numpy(), err_msg=name, **TOL)

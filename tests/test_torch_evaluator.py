"""The port's `Evaluator` (modalities_tpu_torch/evaluator.py) against the JAX
package's on the same parameters and batches: for each head route (full
fp32 logits with the untied head; with `lm_head_chunk_size` 8 and the tied
head, the fused-CE route, here its plain version, and the chunked scan) the
JAX `Evaluator` over the JAX `TrainStepBuilder`'s eval step and the port's
over its train step's `eval_step` publish one result per loader with the
same tag, step count and `loss avg` (1e-5, f32), and an `eval samples/s`;
the port's pipelined step (1f1b over 2 stages in one process) gives the same
loss. The batches carry a loss mask, so the loss is the token-weighted mean
of each batch."""

import jax
import numpy as np
import pytest
import torch

from modalities_tpu.batch import DatasetBatch as JaxDatasetBatch
from modalities_tpu.evaluator import Evaluator as JaxEvaluator
from modalities_tpu.loss_functions import CLMCrossEntropyLoss as JaxLoss
from modalities_tpu.models.model import MixedPrecisionSpec as JaxMixedPrecision
from modalities_tpu.optimizers.optimizer_factory import OptimizerFactory as JaxOptimizers
from modalities_tpu.training.train_step import TrainStepBuilder
from modalities_tpu_torch.conversion.from_jax import params_from_jax
from modalities_tpu_torch.dataloader.dataloader import DatasetBatch
from modalities_tpu_torch.evaluator import Evaluator
from modalities_tpu_torch.models.gpt2.gpt2_model import GPT2LLM
from tests.models.test_gpt2_model import tiny_gpt2
from tests.test_torch_gloo import _tiny_step
from tests.test_torch_gpt2 import port_config
from tests.test_torch_train_step import OPT, SCHED, TOL

ROUTES = {"full-logits": (None, "auto", False), "fused-ce": (8, "auto", True), "chunked-scan": (8, "off", True)}


class _Loader(list):
    def __init__(self, batches, tag):
        super().__init__(batches)
        self.dataloader_tag = tag


class _Broker:  # the JAX publisher's broker: keeps what it is given
    def __init__(self):
        self.messages = []

    def distribute_message(self, message):
        self.messages.append(message.payload)


class _Subscriber:
    def __init__(self):
        self.results = []

    def consume(self, result):
        self.results.append(result)


def _batches(n=3, rows=4, seq=32):
    rng = np.random.default_rng(41)
    out = []
    for i in range(n):
        tokens = rng.integers(0, 128, size=(rows, seq + 1))
        labels = tokens[:, 1:].copy()
        labels[i % rows, 5:] = -100
        out.append((tokens[:, :-1].astype(np.int32), labels.astype(np.int32)))
    return out


@pytest.mark.parametrize("route", list(ROUTES))
def test_the_port_evaluator_publishes_the_jax_evaluators_results(route):
    from modalities_tpu.logging_broker.publisher import MessagePublisher

    chunk, fused, tied = ROUTES[route]
    model = tiny_gpt2("dao_flash", use_weight_tying=tied, lm_head_chunk_size=chunk).update_train_spec(
        mixed_precision=JaxMixedPrecision(param_dtype="float32", compute_dtype="float32", reduce_dtype="float32"))
    opt = JaxOptimizers.get_adam_w(wrapped_model=model, **OPT)
    fns = TrainStepBuilder(model=model, loss_fn=JaxLoss("target_ids", "logits"), optimizer_spec=opt).build(seed=0)
    params = jax.tree.map(np.array, fns.app_state_handle.state.params)
    data = _batches()
    broker = _Broker()
    jax_results = JaxEvaluator(MessagePublisher(_Broker()), MessagePublisher(broker)).evaluate(
        fns, [_Loader([JaxDatasetBatch({"input_ids": x}, {"target_ids": y}) for x, y in data], "val")], 7)

    cfg = port_config(attention_implementation="dao_flash", use_weight_tying=tied, lm_head_chunk_size=chunk,
                      lm_head_fused_ce=fused)
    port_params = {k: v.numpy() for k, v in params_from_jax(params, GPT2LLM(**cfg)).items()}
    spec = {"degrees": None, "model": cfg, "opt": OPT, "sched": SCHED, "clip": 1.0, "acc": 1, "params": port_params}
    loader = _Loader([DatasetBatch({"input_ids": x}, {"target_ids": y}) for x, y in data], "val")
    subscriber = _Subscriber()
    step, _ = _tiny_step(spec, 1)
    assert step.fused_ce == (chunk is not None and fused == "auto")
    results = Evaluator(subscriber, torch.device("cpu")).evaluate(step, [loader], 7)
    pipelined, _ = _tiny_step({**spec, "pipeline": {"pp_schedule": "1f1b", "pp_num_microbatches": 2},
                               "pp_in_process": 2}, 1)
    pp_results = Evaluator(_Subscriber(), torch.device("cpu")).evaluate(pipelined, [loader], 7)

    want = jax_results["val"]
    assert [m.dataloader_tag for m in broker.messages] == ["val"] and subscriber.results == [results["val"]]
    got = results["val"]
    assert (got["dataloader_tag"], got["num_train_steps_done"]) == (want.dataloader_tag, want.num_train_steps_done)
    assert set(got["losses"]) == set(want.losses) and set(got["throughput_metrics"]) == set(want.throughput_metrics)
    np.testing.assert_allclose(got["losses"]["loss avg"], float(want.losses["loss avg"].value), **TOL)
    np.testing.assert_allclose(pp_results["val"]["losses"]["loss avg"], got["losses"]["loss avg"], **TOL)
    assert got["throughput_metrics"]["eval samples/s"] > 0

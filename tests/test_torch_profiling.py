"""The profiling harness of the port (utils/profilers/) against the JAX
package's: the random batches bit for bit, `SteppableForwardPass` step for
step in f32 (weights carried across by `params_from_jax`), the profilers on
the CPU through `profile distributed` (a Chrome trace a kernel-profiler
cycle, memory_stats.jsonl appended each step), the serving engine's OOM
forensics at the `oom@N` fault point, and the three shipped recipes built on
a fake world of 64 (utils/recipe_validation.py) with the JAX models'
parameter counts."""

import json
from pathlib import Path

import jax
import numpy as np
import pytest
import torch
import yaml

from modalities_tpu.loss_functions import CLMCrossEntropyLoss as JaxLoss
from modalities_tpu.models.model import MixedPrecisionSpec as JaxMixedPrecision
from modalities_tpu.optimizers.optimizer_factory import OptimizerFactory as JaxOptimizers
from modalities_tpu.training.train_step import TrainStepBuilder
from modalities_tpu.utils.profilers import steppable_components as jax_steppable
from modalities_tpu_torch.__main__ import main
from modalities_tpu_torch.conversion.from_jax import params_from_jax
from modalities_tpu_torch.loss_functions import CLMCrossEntropyLoss
from modalities_tpu_torch.models.gpt2.gpt2_model import GPT2LLM, MixedPrecisionSpec
from modalities_tpu_torch.optimizers.optimizer_factory import OptimizerFactory
from modalities_tpu_torch.resilience import faults
from modalities_tpu_torch.resilience.errors import OutOfMemory
from modalities_tpu_torch.serving.engine import ServingEngine
from modalities_tpu_torch.telemetry.metrics import MetricsRegistry
from modalities_tpu_torch.training.train_step import TrainStep
from modalities_tpu_torch.utils.profilers.profilers import SteppableKernelProfiler, SteppableMemoryProfiler
from modalities_tpu_torch.utils.profilers.steppable_components import RandomDatasetBatchGenerator, SteppableForwardPass
from tests.models.test_gpt2_model import tiny_gpt2
from tests.test_torch_gpt2 import port_config

ROOT = Path(__file__).resolve().parents[1]
TOL = dict(atol=1e-5, rtol=1e-5)
OPT = dict(lr=1e-3, betas=(0.9, 0.95), eps=1e-8, weight_decay=0.1, weight_decay_groups_excluded=["embedding", "norm"])
GENERATORS = {
    "named": dict(micro_batch_size=2, sequence_length=32, vocab_size=128, seed=7),
    "dims": dict(dims={"batch": 3, "seq": 16, "hidden": 8}, data_type="int64", min_val=2, max_val=100, seed=5),
}


@pytest.mark.parametrize("shape", sorted(GENERATORS))
def test_the_batches_are_jaxs_bit_for_bit(shape):
    kwargs = GENERATORS[shape]
    ours, theirs = RandomDatasetBatchGenerator(**kwargs), jax_steppable.RandomDatasetBatchGenerator(**kwargs)
    for acc, cap in ((1, None), (2, 64), (3, 64)):  # a clamp below the draw ceiling, warned once
        got, want = ours.get_batch(acc, vocab_cap=cap), theirs.get_batch(acc, vocab_cap=cap)
        for part in ("samples", "targets"):
            assert got[part].keys() == want[part].keys()
            for key in got[part]:
                assert got[part][key].dtype == want[part][key].dtype == np.int32
                np.testing.assert_array_equal(got[part][key], want[part][key])
    for dtype in ("int64", "float32"):
        ours.data_type = theirs.data_type = dtype
        got, want = ours.get_dataset_batch(), theirs.get_dataset_batch()
        np.testing.assert_array_equal(got.samples["input_ids"], np.asarray(want.samples["input_ids"]))
        np.testing.assert_array_equal(got.targets["target_ids"], np.asarray(want.targets["target_ids"]))
    ours.data_type = theirs.data_type = "bfloat16"
    got, want = ours.get_dataset_batch(), theirs.get_dataset_batch()
    assert got.samples["input_ids"].dtype == torch.bfloat16
    np.testing.assert_array_equal(got.samples["input_ids"].float().numpy(),
                                  np.asarray(want.samples["input_ids"], dtype=np.float32))


def test_the_forward_pass_steps_as_jaxs_in_f32(monkeypatch):
    """Three train steps of each package's SteppableForwardPass (one layer)
    on the same seeded batches and the same f32 weights: losses within 1e-5."""
    jax_losses = []
    monkeypatch.setattr(jax_steppable, "hard_sync", lambda x: jax_losses.append(float(np.asarray(x))))
    f32 = ("float32", "float32", "float32")
    jax_model = tiny_gpt2("dao_flash", n_layer=1).update_train_spec(mixed_precision=JaxMixedPrecision(*f32))
    jax_pass = jax_steppable.SteppableForwardPass(
        lambda: TrainStepBuilder(model=jax_model, loss_fn=JaxLoss("target_ids", "logits"),
                                 optimizer_spec=JaxOptimizers.get_adam_w(wrapped_model=jax_model, **OPT)).build(seed=0),
        jax_steppable.RandomDatasetBatchGenerator(**GENERATORS["named"]))
    params = jax.tree.map(np.array, jax_pass.step_functions.app_state_handle.state.params)  # the step donates

    model = GPT2LLM(**port_config(attention_implementation="dao_flash", n_layer=1))
    model.update_train_spec(mixed_precision=MixedPrecisionSpec(*f32))
    optimizer = OptimizerFactory.get_adam_w(wrapped_model=model, **OPT)
    port_pass = SteppableForwardPass(
        lambda: TrainStep(model, CLMCrossEntropyLoss("target_ids", "logits"), optimizer, device="cpu",
                          params=params_from_jax(params, model)),
        RandomDatasetBatchGenerator(**GENERATORS["named"]))
    for _ in range(3):
        jax_pass.step()
        port_pass.step()
    assert len(port_pass.losses) == len(jax_losses) == 3
    np.testing.assert_allclose(port_pass.losses, jax_losses, **TOL)


def _profile_config(tmp_path: Path) -> Path:
    """configs/config_profile_gpt2.yaml at 2 layers of 128, vocab 128,
    sequences of 32; a kernel profiler of two cycles (wait 1, active 1) and
    the memory profiler over 4 steps, both writing into tmp_path/prof."""
    cfg = yaml.safe_load((ROOT / "configs" / "config_profile_gpt2.yaml").read_text())
    model = cfg["model"]["config"]
    model.update(sequence_length=32, vocab_size=128, n_layer=2, n_head_q=2, n_head_kv=2, n_embd=128, ffn_hidden=256)
    model["attention_config"]["qkv_transforms"][0]["config"].update(n_embd=128, n_head=2)
    for norm in ("attention_norm_config", "ffn_norm_config", "lm_head_norm_config"):
        model[norm]["config"]["ndim"] = 128
    cfg["steppable_component"]["config"]["batch_generator"]["config"].update(micro_batch_size=2, sequence_length=32,
                                                                              vocab_size=128)
    kernel, memory = cfg["profiler"]["config"]["profilers"]
    kernel["config"] = {"output_folder_path": str(tmp_path / "prof"), "wait_steps": 1, "warmup_steps": 0,
                        "active_steps": 1, "repeat": 2, "record_shapes": True}
    memory["config"] = {"output_folder_path": str(tmp_path / "prof"), "max_steps": 4}
    path = tmp_path / "profile.yaml"
    path.write_text(yaml.safe_dump(cfg, sort_keys=False))
    return path


def test_profile_distributed_writes_a_trace_a_cycle_and_a_memory_line_a_step(tmp_path, monkeypatch):
    monkeypatch.setenv("MODALITIES_TPU_ERROR_LOG_DIR", str(tmp_path / "errors"))
    assert main(["profile", "distributed", "--config_file_path", str(_profile_config(tmp_path)),
                 "--device", "cpu"]) == 0
    prof = tmp_path / "prof"
    assert sorted(p.name for p in prof.glob("kernel_trace_*.json")) == [
        "kernel_trace_rank_0_steps_2-2.json", "kernel_trace_rank_0_steps_4-4.json"]
    events = json.loads((prof / "kernel_trace_rank_0_steps_2-2.json").read_text())["traceEvents"]
    mm = [e for e in events if e.get("name") == "aten::mm"]
    assert mm and all("Input Dims" in e["args"] for e in mm)  # record_shapes applied
    lines = [json.loads(line) for line in (prof / "memory_stats.jsonl").read_text().splitlines()]
    assert [line["step"] for line in lines] == [0, 1, 2, 3]
    assert not (prof / "memory_snapshot.pickle").exists()  # the CPU has no allocator to snapshot


def test_the_kernel_profiler_traces_only_its_tracked_ranks(tmp_path):
    profiler = SteppableKernelProfiler(tmp_path, wait_steps=0, warmup_steps=0, active_steps=1, tracked_ranks=[1])
    with profiler:
        torch.ones(4) @ torch.ones(4)
        profiler.step()
    assert profiler.trace_paths == [] and not list(tmp_path.iterdir())


def test_the_memory_profiler_appends_each_step_not_only_on_exit(tmp_path):
    profiler = SteppableMemoryProfiler(output_folder_path=tmp_path, max_steps=10)
    profiler.__enter__()
    profiler.step()
    profiler.step()
    rows = [json.loads(line) for line in (tmp_path / "memory_stats.jsonl").read_text().splitlines()]
    assert [r["step"] for r in rows] == [0, 1]
    profiler.step()
    profiler.__exit__(None, None, None)
    rows = [json.loads(line) for line in (tmp_path / "memory_stats.jsonl").read_text().splitlines()]
    assert [r["step"] for r in rows] == [0, 1, 2]


def test_an_oom_in_a_serving_dispatch_leaves_the_dump_and_raises_resumable(tmp_path, monkeypatch):
    """`oom@2` fires at the engine's second dispatch round (JAX
    serving/engine.py:2553-2566): the dump lands in the working directory
    (no telemetry sink), names the levers, and OutOfMemory is raised."""
    monkeypatch.chdir(tmp_path)
    model = GPT2LLM(**port_config())
    engine = ServingEngine(model, model.init_params(torch.Generator().manual_seed(0)), device="cpu",
                           max_batch_slots=2, cache_capacity=24, metrics=MetricsRegistry())
    engine.submit([3, 17, 42], 6)
    faults.clear_faults()
    faults.arm_faults("oom@2")
    try:
        with pytest.raises(OutOfMemory, match="device allocation failed at step 2") as raised:
            engine.run()
    finally:
        faults.clear_faults()
    assert isinstance(raised.value.__cause__, torch.OutOfMemoryError)
    dump = json.loads((tmp_path / "oom_dump_rank_0_step_2.json").read_text())
    assert dump["event"] == "oom" and dump["step"] == 2 and "RESOURCE_EXHAUSTED" in dump["error"]
    assert dump["suggested_levers"] and dump["metrics"] is not None

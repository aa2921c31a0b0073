"""The static reports of the port (telemetry/perfscope.py, telemetry/memscope.py,
utils/recipe_validation.py) against the JAX package's: a config's train step
built on a fake process group of its world size under FakeTensorMode and
walked once, its ops in JAX's buckets (the kernels as one op each, the
collectives by mesh dim), the closure exact in integers, the matmul FLOPs
FlopCounterMode's; the tables JAX's text on the same report; `benchmark
validate_recipe` through the CLI against JAX's validate_recipe on the
8-device CPU mesh. The shipped recipes' builds at world 64 are in
tests/test_torch_profiling.py."""

import json
import threading
from pathlib import Path

import pytest
import torch

from chip_smoke import _flash_work
from modalities_tpu.telemetry.memscope import format_memscope_table as jax_format_memscope
from modalities_tpu.telemetry.perfscope import format_perfscope_table as jax_format_perfscope
from modalities_tpu.utils.recipe_validation import validate_recipe as jax_validate_recipe
from modalities_tpu_torch.__main__ import main
from modalities_tpu_torch.ops.rmsnorm import rms_norm
from modalities_tpu_torch.ops.static_walk import kernel_work, walking
from modalities_tpu_torch.telemetry.memscope import format_memscope_table, memscope_for_config
from modalities_tpu_torch.telemetry.perfscope import (
    HwSpec,
    StaticWalk,
    format_perfscope_table,
    kernel_counts,
    perfscope_for_config,
)
from modalities_tpu_torch.utils.recipe_validation import build_train_step
from tests.test_torch_run_cli import MBS, SEQ, STEPS, tiny_config

ROOT = Path(__file__).resolve().parents[1]
TINY_7B = {"model_raw.config.ffn_hidden": 384, "settings.intervals.evaluation_interval_in_steps": STEPS}


def _world(dp_shard: int, tp: int = 1) -> dict:
    return {"device_mesh.config.world_size": dp_shard * tp, "device_mesh.config.data_parallel_shard_degree": dp_shard,
            "device_mesh.config.tensor_parallel_degree": tp,
            "settings.training_target.num_target_tokens": STEPS * SEQ * MBS * dp_shard}


@pytest.fixture(scope="module")
def tp_world(tmp_path_factory):
    """configs/config_7b_tp_fsdp.yaml at 2 layers of 128 (tests/test_torch_run_cli.py),
    one microbatch a step, on a fake (dp_shard 2, tp 2) world: its path and
    its perfscope report."""
    cfg = tiny_config(tmp_path_factory.mktemp("tp"), base="config_7b_tp_fsdp.yaml", acc=1, **TINY_7B,
                      **_world(2, tp=2))
    return cfg, perfscope_for_config(cfg)


def test_the_buckets_close_and_the_collectives_land_in_their_mesh_dims(tp_world):
    _, report = tp_world
    step = report["executables"]["train_step"]
    assert report["world_size"] == 4 and step["mesh_axes"] == {"dp_shard": 2, "tp": 2}
    for key in ("ops", "flops", "bytes"):
        assert step["total"][key] == sum(b[key] for b in step["buckets"].values())
        assert all(isinstance(b[key], int) for b in step["buckets"].values())
    assert {"matmul", "custom_call", "elementwise", "other"} <= set(step["buckets"])
    assert step["buckets"]["matmul"]["flops"] == step["flop_counter"]["flops"] > 0
    assert step["buckets"]["collective:dp_shard"]["ops"] > 0 and step["buckets"]["collective:tp"]["ops"] > 0
    assert {name for name in step["buckets"] if name.startswith("collective:")} == {"collective:dp_shard",
                                                                                    "collective:tp"}
    # n_layer flash calls of each kind, 2 n_layer + 1 RMSNorms (two a block, the head's) forward and backward
    assert kernel_counts(step) == {"flash_fwd": 2, "flash_dq": 2, "flash_dkv": 2, "rms_fwd": 5, "rms_bwd": 5}


@pytest.mark.parametrize("shape", [(2, 4096, 32, 8, 80), (4, 2048, 12, 12, 64), (1, 32768, 12, 4, 128)])
def test_a_kernels_work_is_the_kernel_tables_bound(shape):
    """The walk's (operations, bytes) of a kernel call are chip_smoke.py's
    bound formulas (PERF.md's kernel table) at the path's shapes."""
    b, s, hq, hkv, d = shape
    for name, want in _flash_work(b, s, hq, hkv, d).items():
        assert kernel_work(f"flash_{name}", b=b, hq=hq, hkv=hkv, sq=s, sk=s, d=d, el=2, causal=True) == want
    n, e = b * s, hq * d
    assert kernel_work("rms_fwd", n=n, e=e, el=2, params=1)[1] == 2 * n * e * 2 + 4 * e + 4 * n
    assert kernel_work("rms_bwd", n=n, e=e, el=2, params=2)[1] == 3 * n * e * 2 + 4 * n + 2 * 4 * e
    n, v, e = 32768, 50304, 1536
    ce = {"ce_fwd": 2 * (n + v) * e + 4 * n + 2 * 4 * n, "ce_dh": 2 * (n + v) * e + 3 * 4 * n + 2 * n * e,
          "ce_dw": 2 * (n + v) * e + 3 * 4 * n + 2 * v * e}
    for name, nbytes in ce.items():
        assert kernel_work(name, n=n, v=v, e=e, hel=2, wel=2) == (2 * n * v * e * (1 if name == "ce_fwd" else 2),
                                                                    nbytes)
    m, k, n = 8, 2560, 7680
    assert kernel_work("quant_matmul", m=m, k=k, n=n, xel=2) == (2 * m * k * n, m * k * 2 + k * n + 4 * n + m * n * 2)


def test_a_walk_sends_only_its_own_threads_cpu_calls_to_the_stand_ins():
    """While a walk records on this thread, a wrapper's CPU call here takes
    its kernel's stand-in (recorded, empty output); the same call on another
    thread, and here after the walk, takes the plain version."""
    calls, other = [], []

    class Recorder:
        def custom_call(self, name, flops, nbytes, what="", tensor_cores=True):
            calls.append((name, flops, nbytes, tensor_cores))

    x = torch.randn(4, 16, generator=torch.Generator().manual_seed(0))
    plain = rms_norm(x)
    with walking(Recorder()):
        assert rms_norm(x).shape == x.shape
        thread = threading.Thread(target=lambda: other.append(rms_norm(x)))
        thread.start()
        thread.join()
    assert calls == [("rms_fwd", *kernel_work("rms_fwd", n=4, e=16, el=4, params=0), False)]
    assert torch.equal(other[0], plain) and torch.equal(rms_norm(x), plain)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_a_matmul_is_priced_at_the_peak_of_its_dtype(dtype):
    """fp32 GEMMs run on the CUDA cores (no TF32), bf16 ones on the tensor
    cores: the roofline time of one mm is the larger of its FLOPs over that
    peak and its bytes over the HBM rate."""
    a, b = torch.ones(256, 512, dtype=dtype), torch.ones(512, 384, dtype=dtype)
    with StaticWalk() as walk:
        torch.mm(a, b)
    hw, mm = HwSpec(), walk.report()["buckets"]["matmul"]
    peak = hw.peak_flops_fp32 if dtype == torch.float32 else hw.peak_flops
    nbytes = (256 * 512 + 512 * 384 + 256 * 384) * a.element_size()
    assert (mm["flops"], mm["bytes"]) == (2 * 256 * 512 * 384, nbytes)
    assert mm["est_time_s"] == round(max(mm["flops"] / peak, nbytes / hw.hbm_bw), 12)


def test_the_tables_are_jaxs_text(tp_world):
    cfg, report = tp_world
    step = {k: v for k, v in report["executables"]["train_step"].items() if k != "flop_counter"}
    step["xla_cost_analysis"] = {"flops": 1.5e9, "bytes accessed": 2.5e6}
    both = {**report, "executables": {"train_step": step}}
    assert format_perfscope_table(both) == jax_format_perfscope(both)
    counted = report["executables"]["train_step"]["flop_counter"]["flops"]
    assert format_perfscope_table(report).endswith(f"torch FlopCounterMode cross-check: {counted / 1e9:.3f} GFLOP")
    memory = memscope_for_config(cfg)
    step = memory["executables"]["train_step"]
    assert sum(step["buckets"].values()) == step["predicted_peak_bytes"]
    assert format_memscope_table(memory) == jax_format_memscope(memory)


def test_validate_recipe_through_the_cli_holds_jaxs_on_the_8_device_mesh(tmp_path, monkeypatch, capsys):
    """`benchmark validate_recipe` (its child process builds and walks the
    step, as the JAX CLI's does) on a tiny twin of configs/config_2p7b_dp.yaml
    at dp_shard 8, against JAX's validate_recipe on the 8-device CPU mesh.
    Every dim 0 the twin has divides by 8, so FSDP2 pads nothing: this rank
    holds an eighth of each parameter. JAX holds an eighth of each but the
    fp32 norm scales, which it replicates. The optimizer holds AdamW's two
    moments in the parameters' dtypes (JAX's mu and nu), with a 4-byte step a
    parameter where optax keeps two 4-byte counts."""
    monkeypatch.setenv("MODALITIES_TPU_ERROR_LOG_DIR", str(tmp_path))
    cfg = tiny_config(tmp_path, acc=1, **_world(8))
    assert main(["benchmark", "validate_recipe", "--config_file_path", str(cfg), "--compile_memory_check"]) == 0
    ours, theirs = json.loads(capsys.readouterr().out), jax_validate_recipe(cfg)
    tracker = ours["per_device"].pop("fsdp_mem_tracker")  # FSDPMemTracker's peak of a second faked step
    assert tracker["backend"] == "fsdp2_mem_tracker_fake_world" and tracker["peak_bytes"] > 0, tracker
    assert ours["lowering"] == theirs["lowering"] == "ok"
    assert ours["world_size"] == theirs["world_size"] == 8 and ours["mesh"]["dp_shard"] == 8
    assert ours["num_params"] == theirs["num_params"]
    mine, jax_side = ours["per_device"], theirs["per_device"]
    with build_train_step(cfg) as built:
        params = list(built.train_step.module.named_parameters())
        padded = sum(-(-p.shape[0] // 8) * p[0].numel() * p.element_size() for _, p in params)
        norms = sum(p.numel() * p.element_size() for name, p in params if name.endswith(".scale"))
    assert mine["params_bytes"] == padded == sum(p.numel() * p.element_size() for _, p in params) // 8
    assert jax_side["params_bytes"] == mine["params_bytes"] + norms - norms // 8
    assert mine["optimizer_bytes"] == 2 * mine["params_bytes"] + 4 * len(params)
    assert jax_side["optimizer_bytes"] == 2 * jax_side["params_bytes"] + 2 * 4
    assert mine["activation_estimate"] == jax_side["activation_estimate"]
    assert ours["hbm_budget_bytes"] == 85_017_493_504 and ours["fits_budget"]

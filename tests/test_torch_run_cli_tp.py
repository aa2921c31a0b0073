"""configs/config_7b_tp_fsdp.yaml through the CLI on a gloo world of 2
CPU ranks: `python -m torch.distributed.run --standalone --nproc_per_node 2
-m modalities_tpu_torch run --device cpu` on the file cut to tiny widths (2
layers of 128, 4/2 heads, SwiGLU 256, vocab 256, sequences of 32) and to
world 2 with tp 2 and dp_shard 1. Everything else stands as the file has it:
`model.gpt2_tp`, `fsdp2_wrapped` with bf16 parameters, the
`gpt2_llama3_like` init with depth_init, loss parallelism, AdamW, the
warmup-cosine schedule, clipping, the `orbax` checkpoint execution (DCP
here), the `rich` progress and `save_to_disc` results subscribers.

The run prints its tp mesh and one step line per step on rank 0 only; its
losses equal those of the same file at world 1 (no tp, no loss parallelism,
the same parameters from the same seed) within 1e-3 (7e-5 seen): with bf16
parameters the tp ranks' partial products are rounded to bf16 before they
are summed (the unsharded product sums in fp32), so the two are not the same
numbers."""

import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from tests.test_torch_run_cli import ROOT, STEPS, tiny_config

TINY_7B = {"model_raw.config.ffn_hidden": 384,  # SwiGLU hidden 2/3 * 384 = 256
           "settings.intervals.evaluation_interval_in_steps": STEPS}


def _rows(folder: Path) -> list[dict]:
    return [json.loads(line) for f in folder.rglob("evaluation_results.jsonl") for line in f.read_text().splitlines()]


def test_the_7b_tp_config_trains_on_two_ranks_through_the_launcher(tmp_path):
    (tmp_path / "tp").mkdir()
    (tmp_path / "single").mkdir()
    cfg = tiny_config(tmp_path / "tp", base="config_7b_tp_fsdp.yaml", **TINY_7B,
                      **{"device_mesh.config.world_size": 2, "device_mesh.config.tensor_parallel_degree": 2})
    env = dict(os.environ, PYTHONPATH=str(ROOT), OMP_NUM_THREADS="1")
    proc = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc_per_node", "2", "-m",
         "modalities_tpu_torch", "run", "--config_file_path", str(cfg), "--device", "cpu"],
        capture_output=True, text=True, env=env, cwd=tmp_path, timeout=300,
    )
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "mesh {'dp_shard': 1, 'tp': 2}" in proc.stdout
    lines = [line for line in proc.stdout.splitlines() if line.startswith("[train] step") and "loss" in line]
    assert len(lines) == STEPS  # rank 0 alone prints
    tp_rows = _rows(tmp_path / "tp" / "experiments")

    single = tiny_config(tmp_path / "single", base="config_7b_tp_fsdp.yaml", **TINY_7B,
                         **{"device_mesh.config.tensor_parallel_degree": 1,
                            "device_mesh.config.enable_loss_parallel": False})
    proc = subprocess.run([sys.executable, "-m", "modalities_tpu_torch", "run", "--config_file_path", str(single),
                           "--device", "cpu"], capture_output=True, text=True, env=env, cwd=tmp_path, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    single_rows = _rows(tmp_path / "single" / "experiments")
    tp_losses, single_losses = ([r["losses"]["train loss last"] for r in rows] for rows in (tp_rows, single_rows))
    assert len(tp_losses) == len(single_losses) == STEPS and np.isfinite(tp_losses).all()
    np.testing.assert_allclose(tp_losses, single_losses, atol=1e-3)
    # MFU: the tokens of a step are counted once per dp coordinate (not once per tp rank), over the world's peak
    for tp_row, single_row in zip(tp_rows, single_rows):
        th, th1 = tp_row["throughput_metrics"], single_row["throughput_metrics"]
        assert th["tokens/s"] / th["train steps/s"] == pytest.approx(32 * 2 * 2)  # seq x micro batch x acc x dp 1
        assert th["tokens/s per card"] == pytest.approx(th["tokens/s"] / 2)
        assert th["MFU"] / th["tokens/s"] == pytest.approx(th1["MFU"] / th1["tokens/s"] / 2)

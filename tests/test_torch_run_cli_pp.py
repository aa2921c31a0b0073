"""configs/config_lorem_ipsum_tpu_pp_tp.yaml through the CLI on 8 gloo CPU
ranks: `python -m torch.distributed.run --standalone --nproc_per_node 8 -m
modalities_tpu_torch run --device cpu`, the file as it stands but for the
corpus path (a seeded synthetic `.pbin`; the file's `data/lorem_ipsum.pbin`
is not in the repository). Its mesh pp 2 x dp_shard 2 x tp 2, the
`pipelined` 1F1B over batch_size 16 / microbatch_size 4, the tied head, the
eval loop over `val_dataloader` every 4 steps (and at step 0), checkpoints
every 4 steps.

Then the step-4 folder, which 8 ranks of two stages wrote under the unsplit
model's names. At pp 2: `warmstart` from it on the same mesh trains steps
5-8 to bitwise the unbroken run's losses and step-8 parameters (each stage's
optimizer groups, two a stage with the file's weight-decay groups, are saved
under its own parameters' names). At pp 1: loaded into a world-1 train
step it holds every parameter of the unsplit model, equal to the folder's
tensors; and
`warmstart` from it on pp 1 (dp_shard 2 x tp 2, 4 ranks) trains steps 5-8 to
the pp 2 run's losses (1e-3: the blocks compute in bf16, the file's
default, and pp splits each rank's rows into microbatches)."""

import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch
import yaml

from modalities_tpu_torch.checkpointing.dcp.dcp_checkpoint_loading import (
    DCPCheckpointLoading,
    restore_tree_single_device,
)
from modalities_tpu_torch.checkpointing.stateful.app_state import AppState
from modalities_tpu_torch.config.yaml_interp import load_app_config_dict
from modalities_tpu_torch.dataloader.packed_data import write_pbin_file
from modalities_tpu_torch.running_env import env
from tests.test_torch_gloo import _tiny_step
from tests.test_torch_run_cli import ROOT
from tests.test_torch_train_step import OPT, SCHED
from tests.test_torch_warmstart import warmstart_config

CONFIG = ROOT / "configs" / "config_lorem_ipsum_tpu_pp_tp.yaml"


def _launch(nproc: int, argv: list, cwd: Path) -> subprocess.CompletedProcess:
    environ = dict(os.environ, PYTHONPATH=str(ROOT), OMP_NUM_THREADS="1")
    proc = subprocess.run([sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc_per_node",
                           str(nproc), "-m", "modalities_tpu_torch", *argv, "--device", "cpu"],
                          capture_output=True, text=True, env=environ, cwd=cwd, timeout=300)
    assert proc.returncode == 0, proc.stderr[-4000:]
    return proc


def _rows(folder: Path) -> list[dict]:
    return [json.loads(line) for f in folder.rglob("evaluation_results.jsonl") for line in f.read_text().splitlines()]


def test_the_pp_tp_config_trains_evaluates_and_its_folder_loads_at_pp_1(tmp_path):
    corpus = tmp_path / "lorem_ipsum.pbin"
    write_pbin_file(corpus, [np.random.default_rng(5).integers(0, 256, size=64 * 200)], 2)
    cfg = yaml.safe_load(CONFIG.read_text())
    cfg["settings"]["paths"]["train_dataset_path"] = str(corpus)
    (run_dir := tmp_path / "pp2").mkdir()
    run_cfg = run_dir / CONFIG.name
    run_cfg.write_text(yaml.safe_dump(cfg, sort_keys=False))
    proc = _launch(8, ["run", "--config_file_path", str(run_cfg)], run_dir)
    assert "mesh {'pp': 2, 'dp_shard': 2, 'tp': 2}" in proc.stdout
    assert len([line for line in proc.stdout.splitlines() if line.startswith("[train] step") and "loss" in line]) == 4

    rows = _rows(run_dir / "data" / "experiments")
    train = {r["num_train_steps_done"]: r for r in rows if r["dataloader_tag"] == "train"}
    val = {r["num_train_steps_done"]: r for r in rows if r["dataloader_tag"] == "val"}
    assert sorted(train) == [2, 4, 6, 8] and sorted(val) == [0, 4, 8]
    assert all(np.isfinite(r["losses"]["loss avg"]) and r["throughput_metrics"]["eval samples/s"] > 0
               for r in val.values())
    assert val[8]["losses"]["loss avg"] < val[0]["losses"]["loss avg"]
    folders = {int(p.name.split("seen_steps_")[1].split("-")[0]): p
               for p in (run_dir / "data" / "checkpoints").iterdir() if p.is_dir()}
    assert sorted(folders) == [4, 8]

    # the step-4 folder at pp 1: every parameter of the unsplit model, as the folder holds it
    saved = restore_tree_single_device(folders[4], device="cpu")
    with env.process_group(torch.device("cpu")):
        model_cfg = load_app_config_dict(run_cfg, experiment_id="pp1")["model_raw"]["config"]
        step, mesh = _tiny_step({"degrees": {"dp_shard": 1}, "model": model_cfg, "opt": OPT, "sched": SCHED,
                                 "clip": 1.0, "acc": 1, "seed": 1}, 1)
        DCPCheckpointLoading(global_rank=0).load_app_state(AppState(step, device_mesh=mesh), folders[4])
        loaded = step.state_dict()
    assert set(loaded) == set(saved)
    for name, value in loaded.items():
        torch.testing.assert_close(value, saved[name], rtol=0, atol=0, msg=name)

    # warmstart on pp 2 from the step-4 folder: steps 5-8 and the step-8 folder bitwise the unbroken run's
    (same_dir := tmp_path / "pp2_resumed").mkdir()
    same = warmstart_config(run_cfg, same_dir / "warmstart.yaml")
    info = same_dir / "info.json"
    info.write_text(json.dumps({"checkpoint_folder_path": str(folders[4])}))
    proc = _launch(8, ["warmstart", "--config_file_path", str(same), "--last_checkpoint_info_file_path", str(info)],
                   same_dir)
    resumed = {r["num_train_steps_done"]: r for r in _rows(same_dir / "data" / "experiments")
               if r["dataloader_tag"] == "train"}
    assert sorted(resumed) == [6, 8]
    for s in (6, 8):
        assert resumed[s]["losses"] == train[s]["losses"], s
    (resumed_8,) = [p for p in (same_dir / "data" / "checkpoints").iterdir() if "seen_steps_8-" in p.name]
    unbroken, again = restore_tree_single_device(folders[8], device="cpu"), restore_tree_single_device(resumed_8,
                                                                                                        device="cpu")
    assert set(again) == set(unbroken)
    for name, value in again.items():
        torch.testing.assert_close(value, unbroken[name], rtol=0, atol=0, msg=name)

    # warmstart on pp 1 from the step-4 folder: steps 5-8 as the pp 2 run trained them
    (warm_dir := tmp_path / "pp1").mkdir()
    warm_cfg = yaml.safe_load(run_cfg.read_text())
    warm_cfg["device_mesh"]["config"].update(pipeline_parallel_degree=1, world_size=4)
    (warm_dir / "run.yaml").write_text(yaml.safe_dump(warm_cfg, sort_keys=False))
    warm = warmstart_config(warm_dir / "run.yaml", warm_dir / "warmstart.yaml")
    info = warm_dir / "info.json"
    info.write_text(json.dumps({"checkpoint_folder_path": str(folders[4])}))
    proc = _launch(4, ["warmstart", "--config_file_path", str(warm), "--last_checkpoint_info_file_path", str(info)],
                   warm_dir)
    assert "mesh {'dp_shard': 2, 'tp': 2}" in proc.stdout
    resumed = {r["num_train_steps_done"]: r for r in _rows(warm_dir / "data" / "experiments")
               if r["dataloader_tag"] == "train"}
    assert sorted(resumed) == [6, 8]
    for s in (6, 8):
        np.testing.assert_allclose([resumed[s]["losses"]["train loss avg"], resumed[s]["losses"]["train loss last"]],
                                   [train[s]["losses"]["train loss avg"], train[s]["losses"]["train loss last"]],
                                   atol=1e-3)

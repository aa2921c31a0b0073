"""The trainer's resilience drills in one process (the scenarios of the JAX
tests/resilience/test_chaos_e2e.py, run small), and the quick start through
the CLI, on the CPU:

- `sigterm_at_step@3` (resilience/faults.py) on a tiny copy of
  configs/config_2p7b_dp.yaml with a `resilience` block (raise policy,
  signal handlers on): the out-of-schedule save at step 3 (interval 4), then
  `PreemptionShutdown`; the events are the JAX trainer's, in its order; a
  `warmstart` from the pointer gives the unbroken run's steps 4-6 (losses,
  grad norms, lr) and its final parameters bitwise;
- `rollback` with `skip_budget` 1 and two non-finite steps (`nan_grads@1`,
  and `loss_spike@2:nan`, whose loss is NaN) at log interval 4: both steps
  skipped, then `AnomalyRollback` at the boundary, before the step-4 save;
- the quick start: `run --test_comm` over configs/config_lorem_ipsum_tpu.yaml
  with its mesh cut to world 1 (and its token target to the 8 steps of one
  rank's 8 x 64 tokens) and its own `resilience` block, then
  `generate_text` over configs/config_generate_text.yaml from that run's last
  folder with a word-level tokenizer (tests/conftest.py), prompts on stdin;
  each subprocess exits 0 (about 20 s together).
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
import yaml

import modalities_tpu_torch.resilience.anomaly as anomaly_module
import modalities_tpu_torch.resilience.faults as faults_module
import modalities_tpu_torch.trainer as trainer_module
from modalities_tpu_torch.__main__ import warmstart
from modalities_tpu_torch.dataloader.packed_data import write_pbin_file
from modalities_tpu_torch.main import Main
from modalities_tpu_torch.resilience import AnomalyRollback, PreemptionShutdown, faults
from modalities_tpu_torch.resilience.manifest import verify_manifest
from modalities_tpu_torch.training.train_step import TrainStep
from tests.conftest import make_word_level_tokenizer
from tests.test_torch_run_cli import tiny_config
from tests.test_torch_warmstart import warmstart_config

ROOT = Path(__file__).resolve().parents[1]
STEPS, PER_STEP = 6, 32 * 2 * 2


def _resilient_config(tmp_path: Path, steps: int = STEPS, **resilience) -> Path:
    tmp_path.mkdir(parents=True, exist_ok=True)
    return tiny_config(tmp_path, **{
        "settings.training_target.num_target_steps": steps,
        "settings.training_target.num_target_tokens": steps * PER_STEP,
        "settings.intervals.checkpointing_interval_in_steps": 4,
        "settings.intervals.evaluation_interval_in_steps": 1000,
        "settings.consistency_enforcement.enforce_last_step_evaluated": False,
        "resilience": {"component_key": "resilience", "variant_key": "default", "config": resilience}})


@pytest.fixture
def recorded(monkeypatch):
    """Every train step's metrics and every resilience event, in order."""
    steps, names = [], []
    call = TrainStep.__call__

    def recording(self, batch):
        metrics = call(self, batch)
        steps.append([metrics[k].detach().clone().item() for k in ("loss", "grad_norm", "lr")])
        return metrics

    monkeypatch.setattr(TrainStep, "__call__", recording)
    for module in (trainer_module, faults_module, anomaly_module):
        original = module.record_event
        monkeypatch.setattr(module, "record_event",
                            lambda name, _original=original, **payload: (names.append(name), _original(name, **payload)))
    faults.clear_faults()
    yield steps, names
    faults.clear_faults()


def _arm(monkeypatch, spec: str) -> None:
    faults.clear_faults()
    monkeypatch.setenv(faults.ENV_VAR, spec)


def test_a_sigterm_saves_out_of_schedule_and_the_resume_is_bitwise_the_unbroken_run(tmp_path, monkeypatch, recorded):
    steps, names = recorded
    unbroken = Main(_resilient_config(tmp_path / "unbroken"), device="cpu")
    unbroken.run()
    want_steps, want_params = list(steps), unbroken.train_step.state_dict()
    steps.clear()

    run_dir = tmp_path / "preempted"
    cfg = _resilient_config(run_dir)
    _arm(monkeypatch, "sigterm_at_step@3")
    with pytest.raises(PreemptionShutdown, match="at step 3; checkpoint saved"):
        Main(cfg, device="cpu").run()
    assert names == ["fault/sigterm_at_step", "preempt/shutdown_requested", "preempt/checkpoint_saved"]
    assert steps == want_steps[:3]
    info = run_dir / "checkpoints" / "last_checkpoint_info.json"
    folder = Path(json.loads(info.read_text())["checkpoint_folder_path"])
    assert "-seen_steps_3-" in folder.name and verify_manifest(folder).ok
    assert [p.name for p in (run_dir / "checkpoints").glob("eid_*")] == [folder.name]  # out of schedule: 3 % 4

    steps.clear()
    resumed, _ = warmstart(warmstart_config(cfg, run_dir / "warmstart.yaml"), info, device="cpu")
    assert steps == want_steps[3:]
    got = resumed.train_step.state_dict()
    assert all(torch.equal(got[k], want_params[k]) for k in want_params)


def test_rollback_with_its_budget_spent_raises_at_the_boundary(tmp_path, monkeypatch, recorded):
    steps, names = recorded
    cfg = _resilient_config(tmp_path, steps=8, anomaly_policy="rollback", skip_budget=1)
    text = yaml.safe_load(cfg.read_text())
    text["settings"]["intervals"]["training_log_interval_in_steps"] = 4
    cfg.write_text(yaml.safe_dump(text, sort_keys=False))
    _arm(monkeypatch, "nan_grads@1,loss_spike@2:nan")
    with pytest.raises(AnomalyRollback, match="2 anomalous steps in the trailing 100 steps \\(budget 1\\)"):
        Main(cfg, device="cpu").run()
    assert names == ["anomaly/skipped", "anomaly/skipped", "anomaly/budget_exhausted"]
    assert len(steps) == 4 and not np.isfinite(steps[1][1]) and not np.isfinite(steps[2][0])
    assert not list((tmp_path / "checkpoints").glob("eid_*"))  # the anomalous interval is never saved


def _quick_start(tmp_path: Path) -> tuple[Path, Path]:
    """configs/config_lorem_ipsum_tpu.yaml on one rank; the generate_text config and its tokenizer."""
    cfg = yaml.safe_load((ROOT / "configs" / "config_lorem_ipsum_tpu.yaml").read_text())
    write_pbin_file(tmp_path / "lorem.pbin", [np.random.default_rng(0).integers(0, 256, size=64 * 8 * 10)], 2)
    cfg["settings"]["paths"].update(train_dataset_path=str(tmp_path / "lorem.pbin"),
                                    checkpoint_saving_path=str(tmp_path / "checkpoints"),
                                    experiments_root_path=str(tmp_path / "experiments"))
    cfg["device_mesh"]["config"].update(data_parallel_shard_degree=1, world_size=1)
    cfg["settings"]["training_target"]["num_target_tokens"] = 8 * 8 * 64
    run = tmp_path / "lorem.yaml"
    run.write_text(yaml.safe_dump(cfg, sort_keys=False))
    vocab = {f"w{i}": i for i in range(255)}
    vocab["<eod>"] = 255
    make_word_level_tokenizer(vocab, tmp_path / "tokenizer", unk_token="w0", eos_token="<eod>")
    gen = yaml.safe_load((ROOT / "configs" / "config_generate_text.yaml").read_text())
    gen["tokenizer"]["config"]["pretrained_model_name_or_path"] = str(tmp_path / "tokenizer")
    return run, gen


def test_the_quick_start_trains_and_generates_through_the_cli(tmp_path):
    run, gen = _quick_start(tmp_path)
    env = dict(os.environ, PYTHONPATH=str(ROOT), MODALITIES_TPU_ERROR_LOG_DIR=str(tmp_path / "errors"))
    trained = subprocess.run([sys.executable, "-m", "modalities_tpu_torch", "run", "--config_file_path", str(run),
                              "--test_comm", "--device", "cpu"], capture_output=True, text=True, env=env,
                             cwd=tmp_path, timeout=120)
    assert trained.returncode == 0, trained.stderr[-3000:]
    assert "Communication test passed over 1 rank(s) on cpu (gloo)." in trained.stdout
    assert "[train] step 8:" in trained.stdout
    info = json.loads((tmp_path / "checkpoints" / "last_checkpoint_info.json").read_text())
    assert "-seen_steps_8-" in info["checkpoint_folder_path"]
    gen["settings"]["checkpoint_folder_path"] = info["checkpoint_folder_path"]
    (tmp_path / "generate.yaml").write_text(yaml.safe_dump(gen, sort_keys=False))
    generated = subprocess.run([sys.executable, "-m", "modalities_tpu_torch", "generate_text", "--config_file_path",
                                str(tmp_path / "generate.yaml"), "--device", "cpu"], input="w1 w2 w3\nw7 w8\n",
                               capture_output=True, text=True, env=env, cwd=tmp_path, timeout=120)
    assert generated.returncode == 0, generated.stderr[-3000:]
    completions = [line.split("> ", 1)[1] for line in generated.stdout.splitlines() if line.startswith("enter prompt> ")]
    assert len(completions) == 3 and completions[2] == ""  # two completions, then EOF
    for completion, prompt_length in zip(completions[:2], (3, 2)):
        words = completion.split()
        assert 0 < len(words) <= 64 - prompt_length and all(w.startswith("w") for w in words)
    assert not (tmp_path / "errors").exists()

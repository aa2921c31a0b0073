"""The port's training entry, `python -m modalities_tpu_torch run`, on a tiny
config derived from configs/config_2p7b_dp.yaml (the same nodes and keys, cut
to 2 layers of width 128 and one CPU), and the knobs it refuses. Imports no
JAX."""

import json
import os
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
import yaml

from modalities_tpu_torch.dataloader.packed_data import write_pbin_file
from modalities_tpu_torch.main import Main

ROOT = Path(__file__).resolve().parents[1]
SEQ, MBS, ACC, STEPS = 32, 2, 2, 2


def tiny_config(tmp_path: Path, base: str = "config_2p7b_dp.yaml", seq: int = SEQ, mbs: int = MBS, acc: int = ACC,
                **edits) -> Path:
    """configs/`base` on one device: 2 layers of 128, vocab 256, sequences of
    `seq`, 2 steps of `mbs` x `acc` sequences, no checkpoint in reach.
    `edits` maps dotted keys to values (applied last)."""
    cfg = yaml.safe_load((ROOT / "configs" / base).read_text())
    data = tmp_path / "corpus.pbin"
    write_pbin_file(data, [np.random.default_rng(0).integers(0, 256, size=seq * 40)], 2)
    values = {
        "settings.paths.train_dataset_path": str(data),
        "settings.paths.checkpoint_saving_path": str(tmp_path / "checkpoints"),
        "settings.paths.experiments_root_path": str(tmp_path / "experiments"),
        "settings.step_profile.sequence_length": seq,
        "settings.step_profile.local_train_micro_batch_size": mbs,
        "settings.step_profile.gradient_accumulation_steps": acc,
        "settings.training_target.num_target_steps": STEPS,
        "settings.training_target.num_target_tokens": STEPS * seq * mbs * acc,
        "settings.intervals.training_log_interval_in_steps": 1,
        "settings.intervals.evaluation_interval_in_steps": STEPS,
        "settings.intervals.checkpointing_interval_in_steps": 1000,
        "settings.consistency_enforcement.enforce_last_step_checkpointed": False,
        "device_mesh.config.data_parallel_shard_degree": 1,
        "device_mesh.config.world_size": 1,
        "model_raw.config.vocab_size": 256,
        "model_raw.config.n_layer": 2,
        "model_raw.config.n_head_q": 4,
        "model_raw.config.n_head_kv": 2,
        "model_raw.config.n_embd": 128,
        "model_raw.config.ffn_hidden": 256,
        **edits,
    }
    for dotted, value in values.items():
        node = cfg
        *parents, leaf = dotted.split(".")
        for key in parents:
            node = node[key]
        node[leaf] = value
    path = tmp_path / "tiny.yaml"
    path.write_text(yaml.safe_dump(cfg, sort_keys=False))
    return path


def _long_context_config(tmp_path: Path, **edits) -> Path:
    """configs/config_long_context_32k.yaml cut to 2 layers of 128, vocab 256,
    one sequence of 64 a step, head chunks of 16; its full remat and fused-CE
    head as they stand."""
    return tiny_config(tmp_path, base="config_long_context_32k.yaml", seq=64, mbs=1, acc=1,
                       **{"model_raw.config.lm_head_chunk_size": 16, **edits})


@pytest.mark.parametrize("base", ["config_2p7b_dp", "config_long_context_32k"])
def test_run_trains_on_the_cpu_and_prints_loss_lines(tmp_path, base):
    cfg = tiny_config(tmp_path) if base == "config_2p7b_dp" else _long_context_config(tmp_path)
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    proc = subprocess.run(
        [sys.executable, "-m", "modalities_tpu_torch", "run", "--config_file_path", str(cfg),
         "--experiments_root_path", str(tmp_path / "experiments"), "--device", "cpu"],
        capture_output=True, text=True, env=env, cwd=tmp_path, timeout=300,
    )
    assert proc.returncode == 0, proc.stderr[-3000:]
    lines = [line for line in proc.stdout.splitlines() if line.startswith("[train] step") and "loss" in line]
    assert len(lines) == STEPS and all("grad_norm" in x and "tokens/s" in x and "MFU" in x for x in lines)
    results = list((tmp_path / "experiments").rglob("evaluation_results.jsonl"))
    assert len(results) == 1 and len(results[0].read_text().splitlines()) == STEPS


def test_the_training_step_goes_through_the_config_components(tmp_path):
    main = Main(tiny_config(tmp_path), device="cpu")
    components = main.build_components()
    results = main.run(components)
    assert [r["num_train_steps_done"] for r in results] == [1, 2]
    assert all(np.isfinite(r["losses"]["train loss last"]) for r in results)
    step = main.train_step
    assert step.acc_steps == ACC and step.clipper.max_norm == 1.0
    # config_2p7b_dp.yaml's policy: bf16 parameters (norms fp32), fp32 accumulation
    assert step.module.blocks[0].attn.q_attn.kernel.dtype == torch.bfloat16
    assert step.module.blocks[0].attention_norm.scale.dtype == torch.float32
    assert step.reduce_dtype == torch.float32
    decayed = {len(g["params"]): g["weight_decay"] for g in step.optimizer.param_groups}
    assert sorted(decayed.values()) == [0.0, 0.1]


def test_the_default_device_raises_without_a_card(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Main(tiny_config(tmp_path))


@pytest.mark.parametrize(
    "edits,error,match",
    [
        ({"device_mesh.config.dcn_parallel_degree": 2}, ValueError,
         r"dcn_parallel_degree\(2\) != WORLD_SIZE\(1\)"),
        ({"device_mesh.config.zero_stage": 2}, ValueError, "zero_stage: must be <= 1"),
        ({"model_raw.config.dropout": 0.1}, ValueError, "dropout"),
        ({"model_raw.config.lm_head_chunk_size": 16, "model_raw.config.lm_head_fused_ce": "always"}, ValueError,
         "lm_head_fused_ce"),
        ({"model.variant_key": "activation_checkpointed",
          "model.config": {"model": {"instance_key": "model_raw", "pass_type": "BY_REFERENCE"},
                           "activation_checkpointing_variant": "selective_op_activation_checkpointing"}},
         NotImplementedError, "selective_op"),
        ({"model.variant_key": "activation_checkpointed",
          "model.config": {"model": {"instance_key": "model_raw", "pass_type": "BY_REFERENCE"},
                           "activation_checkpointing_variant": "full_activation_checkpointing",
                           "layers_fqn": "transformer.wte"}},
         ValueError, "layers_fqn"),
        ({"model.variant_key": "activation_checkpointed",
          "model.config": {"model": {"instance_key": "model_raw", "pass_type": "BY_REFERENCE"},
                           "activation_checkpointing_variant": "full_activation_checkpointing",
                           "save_list": ["attention"]}},
         NotImplementedError, "save_list"),
        ({"resilience": {"component_key": "resilience", "variant_key": "default",
                         "config": {"install_signal_handlers": True, "min_hosts": 2}}}, NotImplementedError,
         r"min_hosts: elastic repair is cluster resilience \(ROADMAP\.md, Queue 1 item 7\)"),
    ],
    ids=["mesh-degree", "zero", "dropout-dao-flash", "lm-head-chunk", "selective-op-remat", "remat-other-layers",
         "remat-save-list", "preemption"],
)
def test_what_the_port_does_not_have_raises(tmp_path, edits, error, match):
    with pytest.raises(error, match=match):
        Main(tiny_config(tmp_path, **edits), device="cpu").run()


def test_a_due_checkpoint_is_saved_and_sealed(tmp_path):
    from modalities_tpu_torch.resilience.manifest import verify_manifest

    cfg = tiny_config(tmp_path, **{"settings.intervals.checkpointing_interval_in_steps": 1,
                                   "settings.consistency_enforcement.enforce_last_step_checkpointed": True})
    Main(cfg, device="cpu").run()
    ckpts = tmp_path / "checkpoints"
    folders = sorted((p for p in ckpts.iterdir() if p.is_dir()), key=lambda p: p.name)
    assert [re.search(r"-seen_steps_(\d+)-", p.name).group(1) for p in folders] == ["1", "2"]  # k 3: both kept
    assert all(verify_manifest(p).ok and (p / "topology.json").is_file() and (p / "manifest.json").is_file()
               for p in folders)
    pointer = json.loads((ckpts / "last_checkpoint_info.json").read_text())
    assert pointer["checkpoint_folder_path"] == str(folders[-1].absolute())


def test_the_long_context_config_builds_full_remat_and_the_fused_ce_head(tmp_path):
    main = Main(_long_context_config(tmp_path), device="cpu")
    results = main.run(main.build_components())
    assert [r["num_train_steps_done"] for r in results] == [1, 2]
    step = main.train_step
    spec = step.model.config_spec
    assert (spec.remat_variant, spec.lm_head_chunk_size, step.fused_ce) == ("full", 16, True)
    assert step.module.wte.dtype == torch.bfloat16 and step.acc_steps == 1


def test_dropout_with_the_manual_tier_raises_in_the_forward(tmp_path):
    cfg = tiny_config(tmp_path, **{"model_raw.config.dropout": 0.1,
                                   "model_raw.config.attention_implementation": "manual"})
    with pytest.raises(NotImplementedError, match="dropout"):
        Main(cfg, device="cpu").run()


def test_run_turns_on_expandable_segments_unless_the_caller_chose_an_allocator(tmp_path, monkeypatch):
    import modalities_tpu_torch.main as main_module
    from modalities_tpu_torch.__main__ import main

    seen = []

    class _Recorder:
        def __init__(self, *args, **kwargs):
            pass

        def run(self):
            seen.append(os.environ.get("PYTORCH_CUDA_ALLOC_CONF"))

    monkeypatch.setattr(main_module, "Main", _Recorder)
    monkeypatch.setattr(os, "environ", {})
    argv = ["run", "--config_file_path", str(tmp_path / "config.yaml"), "--device", "cpu"]
    assert main(argv) == 0
    os.environ["PYTORCH_CUDA_ALLOC_CONF"] = "backend:native"
    assert main(argv) == 0
    assert seen == ["expandable_segments:True", "backend:native"]

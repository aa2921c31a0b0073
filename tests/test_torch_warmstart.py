"""The port's checkpoint path end to end on the CPU, through its CLI
(`python -m modalities_tpu_torch run | warmstart | serve`, in process), on a
tiny copy of configs/config_2p7b_dp.yaml (2 layers of 128, bf16 parameters):

- `run` saves and seals the checkpoint that falls due (step 3 of 5);
- `warmstart` on a warmstart config derived from the run's (as
  configs/config_lorem_ipsum_tpu_warmstart.yaml is: `number_conversion` nodes
  read the training progress from the folder name, `app_state` variant `dcp`,
  `warmstart_checkpoint_paths`) resumes from `last_checkpoint_info.json`: the
  resumed steps read the unbroken run's token ids and give bitwise its
  losses, grad norms and learning rates;
- `serve` from a checkpoint gives the tokens of the same parameters handed
  to the serving component in memory (bf16 and int8 weights), and a folder
  that fails its manifest is refused. Imports no JAX."""

import json
import shutil
from pathlib import Path

import numpy as np
import pytest
import torch
import yaml

from modalities_tpu_torch.__main__ import main
from modalities_tpu_torch.config.yaml_interp import load_app_config_dict
from modalities_tpu_torch.main import Main
from modalities_tpu_torch.resilience.manifest import verify_manifest
from modalities_tpu_torch.serving.serve import build_serving_components
from modalities_tpu_torch.training.train_step import TrainStep
from tests.test_torch_run_cli import tiny_config

STEPS, SAVE_AT, SEQ, MBS, ACC = 5, 3, 32, 2, 2
PER_STEP = SEQ * MBS * ACC


def warmstart_config(run_config: Path, out: Path) -> Path:
    """The run's config turned into a warmstart config: training progress
    from the checkpoint folder's name, the app state loaded from it."""
    cfg = yaml.safe_load(run_config.read_text())
    folder = "${settings.warmstart_checkpoint_paths.checkpoint_folder_path}"

    def conversion(variant, **config):
        return {"component_key": "number_conversion", "variant_key": variant, "config": config}

    cfg["settings"]["training_progress"] = {
        "global_num_seen_tokens": conversion("global_num_seen_tokens_from_checkpoint_path", checkpoint_path=folder),
        "num_seen_steps": conversion("num_seen_steps_from_checkpoint_path", checkpoint_path=folder),
        "num_seen_samples": conversion("num_samples_from_num_tokens",
                                       num_tokens="${settings.training_progress.global_num_seen_tokens}",
                                       sequence_length="${settings.step_profile.sequence_length}"),
        "last_step": conversion("last_step_from_checkpoint_path", checkpoint_path=folder),
    }
    cfg["settings"]["warmstart_checkpoint_paths"] = {"checkpoint_folder_path": "${warmstart_env:checkpoint_folder_path}"}
    cfg["app_state_raw"] = cfg.pop("app_state")
    cfg["app_state"] = {"component_key": "app_state", "variant_key": "dcp", "config": {
        "raw_app_state": {"instance_key": "app_state_raw", "pass_type": "BY_REFERENCE"},
        "checkpoint_dir_path": folder}}
    out.write_text(yaml.safe_dump(cfg, sort_keys=False))
    return out


def _record_steps(monkeypatch) -> list[dict]:
    """Every train step's input ids and metrics, in order."""
    seen = []
    call = TrainStep.__call__

    def recording(self, batch):
        metrics = call(self, batch)
        seen.append({"input_ids": batch["samples"]["input_ids"].clone(),
                     **{k: metrics[k].detach().clone() for k in ("loss", "grad_norm", "lr")}})
        return metrics

    monkeypatch.setattr(TrainStep, "__call__", recording)
    return seen


@pytest.fixture(scope="module")
def resumed(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("torch_warmstart")
    cfg = tiny_config(tmp, **{"settings.training_target.num_target_steps": STEPS,
                              "settings.training_target.num_target_tokens": STEPS * PER_STEP,
                              "settings.intervals.checkpointing_interval_in_steps": SAVE_AT,
                              "settings.intervals.evaluation_interval_in_steps": STEPS,
                              "settings.consistency_enforcement.enforce_last_step_evaluated": False})
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("PYTORCH_CUDA_ALLOC_CONF", "expandable_segments:True")
        recorded = _record_steps(mp)
        assert main(["run", "--config_file_path", str(cfg), "--device", "cpu"]) == 0
        unbroken = list(recorded)
        info = tmp / "checkpoints" / "last_checkpoint_info.json"
        warm = warmstart_config(cfg, tmp / "warmstart.yaml")
        resumed_steps = _record_steps(mp)
        assert main(["warmstart", "--config_file_path", str(warm), "--last_checkpoint_info_file_path", str(info),
                     "--device", "cpu"]) == 0
    return tmp, cfg, warm, unbroken, resumed_steps


def test_run_saves_and_seals_the_checkpoint_that_falls_due(resumed):
    tmp, *_ = resumed
    ckpts = tmp / "checkpoints"
    folders = [p for p in ckpts.iterdir() if p.is_dir()]
    assert len(folders) == 1 and f"seen_steps_{SAVE_AT}-seen_tokens_{SAVE_AT * PER_STEP}-target_steps_{STEPS}-" \
                                  f"target_tokens_{STEPS * PER_STEP}" in folders[0].name
    assert {"manifest.json", "topology.json", ".metadata"} <= {p.name for p in folders[0].iterdir()}
    assert verify_manifest(folders[0]).ok
    pointer = json.loads((ckpts / "last_checkpoint_info.json").read_text())
    assert Path(pointer["checkpoint_folder_path"]) == folders[0].absolute()


def test_warmstart_resumes_bitwise_where_the_run_saved(resumed):
    _, _, _, unbroken, resumed_steps = resumed
    assert len(unbroken) == STEPS and len(resumed_steps) == STEPS - SAVE_AT
    for i, (got, want) in enumerate(zip(resumed_steps, unbroken[SAVE_AT:]), start=SAVE_AT + 1):
        assert torch.equal(got["input_ids"], want["input_ids"]), f"step {i} read other tokens"
        for key in ("loss", "grad_norm", "lr"):
            assert torch.equal(got[key], want[key]), f"step {i} {key}: {got[key].item()} != {want[key].item()}"


def test_the_warmstart_settings_come_from_the_folder_name(resumed):
    tmp, _, warm, _, _ = resumed
    folder = next(p for p in (tmp / "checkpoints").iterdir() if p.is_dir())
    main_obj = Main(warm, device="cpu",
                    additional_resolver_funs={"warmstart_env": lambda key: str(folder)})
    components = main_obj.build_components()
    progress = components.settings.training_progress
    assert (progress.num_seen_steps, progress.global_num_seen_tokens, progress.num_seen_samples,
            progress.last_step) == (SAVE_AT, SAVE_AT * PER_STEP, SAVE_AT * MBS * ACC, SAVE_AT - 1)
    assert components.app_state.checkpoint_dir_path == folder
    assert components.train_dataloader.batch_sampler.sampler.skip_num_global_samples == SAVE_AT * MBS * ACC


# ------------------------------------------------------------ serve from a checkpoint


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """A 2-step run that saves at its last step, the saved folder and the
    parameters in memory."""
    from tests.conftest import make_word_level_tokenizer

    tmp = tmp_path_factory.mktemp("torch_serve_ckpt")
    cfg = tiny_config(tmp, **{"settings.intervals.checkpointing_interval_in_steps": 2})
    run = Main(cfg, device="cpu")
    run.run()
    params = {k: v.detach().clone() for k, v in run.train_step.state_dict().items()}
    folder = next(p for p in (tmp / "checkpoints").iterdir() if p.is_dir())
    vocab = {f"t{i}": i for i in range(255)}
    vocab["<eod>"] = 255
    make_word_level_tokenizer(vocab, tmp / "tokenizer", unk_token="t0", pad_token="t0", eos_token="<eod>")
    model_config = load_app_config_dict(cfg, experiment_id="serve")["model_raw"]["config"]
    return tmp, folder, params, model_config


def _serve_config(tmp: Path, folder, model_config: dict, quant: str, name: str = "serve") -> Path:
    cfg = yaml.safe_load(Path("configs/config_serve.yaml").read_text())
    node = cfg["serving_component"]["config"]
    node["tokenizer"]["config"]["pretrained_model_name_or_path"] = str(tmp / "tokenizer")
    node["slo"] = None  # brownout shedding: not ported, refused
    node["model"]["config"] = model_config
    node["quant"] = {"weights": quant}
    cfg["settings"]["checkpoint_folder_path"] = str(folder)
    path = tmp / f"{name}_{quant}.yaml"
    path.write_text(yaml.safe_dump(cfg))
    return path


REQUESTS = [{"prompt": "t5 t6 t7 t8", "max_new_tokens": 8}, {"prompt": "t9 t10", "max_new_tokens": 6},
            {"prompt": "t1", "max_new_tokens": 5}]


@pytest.mark.parametrize("quant", ["none", "int8"])
def test_serve_from_a_checkpoint_gives_the_tokens_of_the_same_parameters_in_memory(trained, quant):
    tmp, folder, params, model_config = trained
    cfg = _serve_config(tmp, folder, model_config, quant)
    requests, out = tmp / "requests.jsonl", tmp / f"out_{quant}.jsonl"
    requests.write_text("\n".join(json.dumps(r) for r in REQUESTS) + "\n")
    assert main(["serve", "--config_file_path", str(cfg), "--requests_file_path", str(requests),
                 "--output_file_path", str(out), "--device", "cpu"]) == 0
    rows = [json.loads(line) for line in out.read_text().splitlines()]
    component = build_serving_components(load_app_config_dict(cfg)).serving_component
    component.device, component.params = torch.device("cpu"), params
    want = component.run_requests(REQUESTS)
    assert [r["tokens"] for r in rows] == [r["tokens"] for r in want]
    assert all(r["finish_reason"] in ("eod", "budget") and r["tokens"] for r in rows)
    assert component.build_engine().quant_weights == quant


def test_serving_a_folder_that_fails_its_manifest_is_refused(trained):
    tmp, folder, _, model_config = trained
    broken = tmp / "broken" / folder.name
    shutil.copytree(folder, broken)
    data = broken / "__0_0.distcp"
    raw = bytearray(data.read_bytes())
    raw[len(raw) // 2] ^= 0x01
    data.write_bytes(bytes(raw))
    cfg = _serve_config(tmp, broken, model_config, "none", name="broken")
    requests = tmp / "broken" / "requests.jsonl"
    requests.write_text(json.dumps(REQUESTS[0]) + "\n")
    with pytest.raises(ValueError, match="refusing to serve .*digest mismatch"):
        main(["serve", "--config_file_path", str(cfg), "--requests_file_path", str(requests), "--device", "cpu"])


def test_load_serving_params_reads_the_trained_parameters_and_quantizes_them(trained):
    tmp, folder, params, _ = trained
    from modalities_tpu_torch.serving.serve import load_serving_params

    loaded = load_serving_params(folder, device="cpu")
    assert set(loaded) == set(params)
    assert all(torch.equal(loaded[k], params[k]) and loaded[k].dtype == params[k].dtype for k in params)
    quantized = load_serving_params(folder, device="cpu", quant_weights="int8")
    assert quantized["blocks.0.attn.q_attn.kernel"].dtype == torch.int8 and "blocks.0.attn.q_attn.scale" in quantized
    assert np.isfinite(quantized["blocks.0.attn.q_attn.scale"].numpy()).all()


@pytest.mark.parametrize("reader", ["load_serving_params", "restore_tree_single_device"])
def test_the_checkpoint_readers_default_to_the_card_and_raise_without_one(trained, reader, monkeypatch):
    from modalities_tpu_torch.checkpointing.dcp import dcp_checkpoint_loading
    from modalities_tpu_torch.serving import serve as serving

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    fn = {"load_serving_params": serving.load_serving_params,
          "restore_tree_single_device": dcp_checkpoint_loading.restore_tree_single_device}[reader]
    with pytest.raises(RuntimeError, match="no CUDA device is available"):
        fn(trained[1])

"""The port's checkpointing (modalities_tpu_torch/checkpointing, resilience,
utils/number_conversion) against the JAX package's, on the CPU.

- The retention strategies give the JAX classes' instructions for the same
  progress sequences; the number_conversion variants the JAX functions'
  values for the same inputs.
- Manifests interoperate: a folder sealed by either package verifies in the
  other, and one flipped byte fails both; `resolve_resume_folder` walks the
  ring back to the newest folder that verifies.
- A tiny GPT2 train step (f32, and bf16 parameters) resumed from a DCP
  checkpoint into a fresh build with another seed gives bitwise the unbroken
  run's losses, grad norms, learning rates and final state.
- A second load, another architecture, the async pointer and the k ring.
- The JAX train step's Orbax checkpoint carried to the port
  (`restore_tree_single_device` -> numpy -> `app_state_from_jax`): the port's
  next steps agree with the JAX run's continued steps within the train-step
  parity tolerance (1e-5: the same fp32 math summed in other orders).
"""

import dataclasses
import json
import pickle
import shutil
import warnings
from pathlib import Path
from typing import Any

import jax
import numpy as np
import pytest
import torch

from modalities_tpu.checkpointing import checkpoint_saving_strategies as jax_strategies
from modalities_tpu.resilience import manifest as jax_manifest
from modalities_tpu.training.training_progress import TrainingProgress as JaxProgress
from modalities_tpu_torch.checkpointing import checkpoint_saving_strategies as strategies
from modalities_tpu_torch.checkpointing.checkpoint_saving import CheckpointSaving
from modalities_tpu_torch.checkpointing.dcp.dcp_checkpoint_loading import (
    CheckpointingError,
    DCPCheckpointLoading,
    restore_tree_single_device,
)
from modalities_tpu_torch.checkpointing.dcp.dcp_checkpoint_saving import DCPCheckpointSaving, checkpoint_folder_path
from modalities_tpu_torch.checkpointing.stateful.app_state import AppState
from modalities_tpu_torch.checkpointing.topology import read_topology
from modalities_tpu_torch.conversion.from_jax import app_state_from_jax
from modalities_tpu_torch.dataloader.packed_data import write_pbin_file
from modalities_tpu_torch.loss_functions import CLMCrossEntropyLoss
from modalities_tpu_torch.models.gpt2.gpt2_model import GPT2LLM, MixedPrecisionSpec
from modalities_tpu_torch.optimizers.optimizer_factory import OptimizerFactory
from modalities_tpu_torch.optimizers.scheduler_factory import LinearWarmupCosineAnnealingLRScheduler
from modalities_tpu_torch.resilience import manifest
from modalities_tpu_torch.running_env.device_mesh import DeviceMesh
from modalities_tpu_torch.training.gradient_clipping import GradientClipper
from modalities_tpu_torch.training.train_step import TrainStep
from modalities_tpu_torch.training.training_progress import TrainingProgress
from modalities_tpu_torch.utils.number_conversion import NUMBER_CONVERSIONS, NumberConversion
from tests.test_torch_gpt2 import port_config
from tests.test_torch_train_step import ACC, MB, OPT, SCHED, SEQ, TOL, _jax_side, _port_side

TOKENS = ACC * MB * SEQ  # a step's tokens


# ------------------------------------------------------------------ strategies


def _progress_sequence(cls):
    return [cls(num_seen_steps_current_run=s, num_seen_tokens_current_run=s * 8, num_target_steps=7,
                num_target_tokens=56) for s in range(1, 8)]


@pytest.mark.parametrize("name,k", [("k_most_recent", -1), ("k_most_recent", 0), ("k_most_recent", 1),
                                    ("k_most_recent", 2), ("every_k", 1), ("every_k", 3)])
def test_strategies_give_the_jax_instruction_sequences(name, k):
    cls = {"k_most_recent": "SaveKMostRecentCheckpointsStrategy", "every_k": "SaveEveryKStepsCheckpointingStrategy"}
    port, ref = getattr(strategies, cls[name])(k=k), getattr(jax_strategies, cls[name])(k=k)

    def seq(strategy, progress_cls):
        out = []
        for p in _progress_sequence(progress_cls):
            ins = strategy.get_checkpoint_instruction(p)
            out.append((ins.savable, [d.num_seen_steps_total for d in ins.checkpoints_to_delete]))
        return out

    got, want = seq(port, TrainingProgress), seq(ref, JaxProgress)
    assert got == want
    assert any(s for s, _ in got) == (k != 0)


# ----------------------------------------------------------- number conversion


@pytest.fixture(scope="module")
def conversion_inputs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("number_conversion")
    data = tmp / "corpus.pbin"
    write_pbin_file(data, [np.random.default_rng(3).integers(0, 256, size=32 * 37 + 5)], 2)
    index = tmp / "raw.idx"
    index.write_bytes(pickle.dumps([(i * 10, 10) for i in range(103)]))
    folder = "eid_x-seen_steps_12-seen_tokens_6144-target_steps_40-target_tokens_20480"
    return {
        "local_num_batches_from_num_samples": dict(num_ranks=2, global_num_samples=1001, local_micro_batch_size=3),
        "local_num_batches_from_num_tokens": dict(num_ranks=2, global_num_tokens=100_000, sequence_length=64,
                                                  local_micro_batch_size=3),
        "num_samples_from_num_tokens": dict(num_tokens=100_001, sequence_length=64),
        "num_steps_from_num_samples": dict(dp_degree=2, local_micro_batch_size=3, global_num_samples=1001,
                                           gradient_accumulation_steps=2),
        "num_steps_from_num_tokens": dict(dp_degree=2, local_micro_batch_size=3, global_num_tokens=100_000,
                                          sequence_length=64, gradient_accumulation_steps=2),
        "num_tokens_from_num_steps": dict(num_steps=17, dp_degree=2, local_micro_batch_size=3, sequence_length=64,
                                          gradient_accumulation_steps=2),
        "last_step_from_checkpoint_path": dict(checkpoint_path=Path(folder)),
        "num_seen_steps_from_checkpoint_path": dict(checkpoint_path=Path(folder)),
        "global_num_seen_tokens_from_checkpoint_path": dict(checkpoint_path=Path(folder)),
        "global_num_target_tokens_from_checkpoint_path": dict(checkpoint_path=Path(folder)),
        "num_target_steps_from_checkpoint_path": dict(checkpoint_path=Path(folder)),
        "num_tokens_from_packed_mem_map_dataset_continuous": dict(
            dataset_path=data, sequence_length=32, dp_degree=1, local_micro_batch_size=2,
            gradient_accumulation_steps=3, sample_key="input_ids"),
        "num_steps_from_raw_dataset_index": dict(raw_index_path=index, num_ranks=2, local_micro_batch_size=3,
                                                 gradient_accumulation_steps=2),
        "parallel_degree": dict(device_mesh=DeviceMesh(world_size=1), parallelism_methods=["dp_replicate",
                                                                                            "dp_shard"]),
    }


@pytest.mark.parametrize("variant", [name for name, _, _ in NUMBER_CONVERSIONS])
def test_number_conversion_variants_equal_the_jax_functions(variant, conversion_inputs):
    from modalities_tpu.registry.components import COMPONENTS as JAX_COMPONENTS
    from modalities_tpu_torch.config.config import validate_config

    fn, config_type = {name: (f, c) for name, f, c in NUMBER_CONVERSIONS}[variant]
    jax_fn = next(e.component_type for e in JAX_COMPONENTS
                  if e.component_key == "number_conversion" and e.variant_key == variant)
    kwargs = conversion_inputs[variant]
    validated = validate_config(config_type, dict(kwargs))
    got = fn(**{f: getattr(validated, f) for f in validated.__dataclass_fields__})
    assert isinstance(got, int) and got == jax_fn(**kwargs)


def test_there_is_a_variant_for_every_jax_number_conversion():
    from modalities_tpu.registry.components import COMPONENTS as JAX_COMPONENTS

    want = {e.variant_key for e in JAX_COMPONENTS if e.component_key == "number_conversion"}
    assert {name for name, _, _ in NUMBER_CONVERSIONS} == want and len(want) == 14


def test_the_folder_name_round_trips_through_the_conversions(tmp_path):
    progress = TrainingProgress(4, 4 * 512, 40, 40 * 512, num_seen_steps_previous_run=8,
                                num_seen_tokens_previous_run=8 * 512)
    folder = checkpoint_folder_path(tmp_path, "2026-10-17__00-00-00_abcd", progress)
    assert NumberConversion.get_num_seen_steps_from_checkpoint_path(folder) == 12
    assert NumberConversion.get_last_step_from_checkpoint_path(folder) == 11
    assert NumberConversion.get_global_num_seen_tokens_from_checkpoint_path(folder) == 12 * 512
    assert NumberConversion.get_global_num_target_tokens_from_checkpoint_path(folder) == 40 * 512
    assert NumberConversion.get_num_target_steps_from_checkpoint_path(folder) == 40
    from modalities_tpu.checkpointing.orbax.orbax_checkpoint_saving import checkpoint_folder_path as jax_folder

    jax_progress = JaxProgress(4, 4 * 512, 40, 40 * 512, num_seen_steps_previous_run=8,
                               num_seen_tokens_previous_run=8 * 512)
    assert jax_folder(tmp_path, "2026-10-17__00-00-00_abcd", jax_progress) == folder


# ------------------------------------------------------------------ manifests


def _fake_checkpoint(root: Path, name: str) -> Path:
    folder = root / name
    (folder / "state").mkdir(parents=True)
    (folder / "state" / "arrays.bin").write_bytes(np.random.default_rng(len(name)).bytes(4096))
    (folder / ".metadata").write_text('{"step": 1}')
    return folder


def _flip_one_byte(path: Path, at: int = 100) -> None:
    data = bytearray(path.read_bytes())
    data[at] ^= 0x01
    path.write_bytes(bytes(data))


@pytest.mark.parametrize("writer,reader", [("port", "jax"), ("jax", "port")])
def test_a_manifest_written_by_one_package_verifies_in_the_other(tmp_path, writer, reader):
    write = {"port": manifest.write_manifest, "jax": jax_manifest.write_manifest}[writer]
    verify = {"port": manifest.verify_manifest, "jax": jax_manifest.verify_manifest}[reader]
    folder = _fake_checkpoint(tmp_path, "eid_a-seen_steps_8-x")
    write(folder)
    assert verify(folder).ok
    _flip_one_byte(folder / "state" / "arrays.bin")
    result = verify(folder)
    assert not result.ok and "digest mismatch" in result.reason


def test_manifests_are_the_same_json(tmp_path):
    folder = _fake_checkpoint(tmp_path, "eid_a-seen_steps_8-x")
    port = json.loads(manifest.write_manifest(folder).read_text())
    jax_side = json.loads(jax_manifest.write_manifest(folder).read_text())
    assert port == jax_side and port["step"] == 8 and len(port["files"]) == 2


def test_sizes_only_when_digests_are_off(tmp_path, monkeypatch):
    folder = _fake_checkpoint(tmp_path, "eid_a-seen_steps_8-x")
    manifest.write_manifest(folder)
    _flip_one_byte(folder / "state" / "arrays.bin")
    monkeypatch.setenv("MODALITIES_TPU_VERIFY_DIGESTS", "0")
    assert manifest.verify_manifest(folder).ok
    (folder / ".metadata").write_text("{}")
    assert not manifest.verify_manifest(folder).ok


def _pointer(tmp_path: Path, folder: Path) -> Path:
    info = tmp_path / "last_checkpoint_info.json"
    manifest.atomic_write_json(info, {"checkpoint_folder_path": str(folder)})
    return info


def test_resolve_walks_the_ring_back_to_the_newest_verifiable_folder(tmp_path):
    oldest = _fake_checkpoint(tmp_path, "eid_a-seen_steps_4-x")
    middle = _fake_checkpoint(tmp_path, "eid_a-seen_steps_8-x")
    newest = _fake_checkpoint(tmp_path, "eid_a-seen_steps_12-x")
    for folder in (oldest, middle, newest):
        manifest.write_manifest(folder)
    assert manifest.resolve_resume_folder(_pointer(tmp_path, newest)) == newest
    (newest / ".metadata").write_text("{ corrupted")
    (middle / "state" / "arrays.bin").unlink()
    assert manifest.resolve_resume_folder(_pointer(tmp_path, newest)) == oldest
    assert manifest.resolve_resume_folder(_pointer(tmp_path, newest)) == jax_manifest.resolve_resume_folder(
        tmp_path / "last_checkpoint_info.json")
    (oldest / "state" / "arrays.bin").unlink()
    with pytest.raises(FileNotFoundError, match="no verifiable checkpoint"):
        manifest.resolve_resume_folder(_pointer(tmp_path, newest))
    with pytest.raises(ValueError, match="stale temp file"):
        manifest.resolve_resume_folder(tmp_path / "last_checkpoint_info.json.tmp")


def test_retry_io_retries_os_errors_a_bounded_number_of_times_then_reraises():
    from modalities_tpu_torch.resilience.retry import retry_io

    calls = []

    def flaky():
        calls.append(1)
        if len(calls) < 3:
            raise OSError("transient")
        return "ok"

    assert retry_io(flaky, "test", attempts=4, base_delay_s=0.0) == "ok" and len(calls) == 3
    calls.clear()

    def down():
        calls.append(1)
        raise OSError(f"down {len(calls)}")

    with pytest.raises(OSError, match="down 2"):
        retry_io(down, "test", attempts=2, base_delay_s=0.0)
    with pytest.raises(ValueError):  # not an IO error: no retry
        retry_io(lambda: (_ for _ in ()).throw(ValueError("bad")), "test", attempts=3, base_delay_s=0.0)


# --------------------------------------------------------- bitwise resume


def _train_step(param_dtype: str, seed: int, n_embd: int = 128) -> TrainStep:
    model = GPT2LLM(**port_config(attention_implementation="dao_flash", use_weight_tying=False, n_embd=n_embd))
    compute = "float32" if param_dtype == "float32" else "bfloat16"
    model.update_train_spec(mixed_precision=MixedPrecisionSpec(param_dtype, compute, "float32"))
    opt = OptimizerFactory.get_adam_w(wrapped_model=model, **OPT)
    sched = LinearWarmupCosineAnnealingLRScheduler(optimizer=opt, **SCHED)
    return TrainStep(model, CLMCrossEntropyLoss("target_ids", "logits"), opt, sched, device="cpu",
                     gradient_acc_steps=ACC, grad_clipper=GradientClipper(max_norm=1.0), seed=seed)


def _batches(n: int, seed: int = 11) -> list[dict]:
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        tokens = torch.from_numpy(rng.integers(0, 128, size=(ACC, MB, SEQ + 1)))
        out.append({"samples": {"input_ids": tokens[..., :-1]}, "targets": {"target_ids": tokens[..., 1:]}})
    return out


def _run(step: TrainStep, batches) -> list[torch.Tensor]:
    return [torch.stack([m[k].detach().float() for k in ("loss", "grad_norm", "lr")]) for m in map(step, batches)]


def _full_state(step: TrainStep) -> dict[str, torch.Tensor]:
    out = {f"model.{k}": v for k, v in step.module.state_dict().items()}
    names = {id(p): n for n, p in step.module.named_parameters()}
    for p, state in step.optimizer.state.items():
        out.update({f"optimizer.{names[id(p)]}.{k}": v for k, v in state.items()})
    return out


def _progress(steps: int) -> TrainingProgress:
    return TrainingProgress(steps, steps * TOKENS, 6, 6 * TOKENS)


def _save(tmp_path: Path, step: TrainStep, steps: int, k: int = -1, use_async: bool = False):
    execution = DCPCheckpointSaving(tmp_path, "resume", use_async=use_async)
    saving = CheckpointSaving(strategies.SaveKMostRecentCheckpointsStrategy(k=k), execution)
    saving.save_checkpoint(_progress(steps), AppState(step))
    saving.wait_until_finished()
    return checkpoint_folder_path(tmp_path, "resume", _progress(steps))


@pytest.mark.parametrize("param_dtype", ["float32", "bfloat16"])
def test_a_save_fresh_build_and_load_resume_is_bitwise_the_unbroken_run(tmp_path, param_dtype):
    batches = _batches(6)
    unbroken = _train_step(param_dtype, seed=0)
    want = _run(unbroken, batches)

    first = _train_step(param_dtype, seed=0)
    got = _run(first, batches[:3])
    folder = _save(tmp_path, first, 3)
    assert sorted(p.name for p in folder.iterdir()) == [".metadata", "__0_0.distcp", "manifest.json", "topology.json"]
    saved = {k: v.clone() for k, v in _full_state(first).items()}
    del first

    resumed = _train_step(param_dtype, seed=1)  # another seed: every tensor must come from the checkpoint
    assert not torch.equal(resumed.module.wte, saved["model.wte"])
    app = DCPCheckpointLoading().load_app_state(AppState(resumed), folder)
    assert app.step_count == 3 and app.is_loaded
    loaded = _full_state(resumed)
    assert set(loaded) == set(saved)
    for name, tensor in saved.items():
        assert loaded[name].dtype == tensor.dtype and torch.equal(loaded[name], tensor), name
    assert resumed.module.blocks[0].attn.q_attn.kernel.dtype == getattr(torch, param_dtype)
    assert resumed.module.blocks[0].attention_norm.scale.dtype == torch.float32
    # the optimizer steps the module's own parameters (nothing rebound)
    assert all(a is b for a, b in zip(resumed.params, resumed.module.parameters()))
    assert all(p in resumed.optimizer.state for p in resumed.params)
    got += _run(resumed, batches[3:])
    for i, (g, w) in enumerate(zip(got, want)):
        assert torch.equal(g, w), f"step {i + 1}: {g.tolist()} != {w.tolist()}"
    final, final_want = _full_state(resumed), _full_state(unbroken)
    for name in final_want:
        assert torch.equal(final[name], final_want[name]), name


@pytest.mark.parametrize("variant,knob,value", [("fsdp1", "block_names", ["GPT2Block"]),
                                                ("fsdp1", "mixed_precision_settings", "BF_16"),
                                                ("fsdp1", "sharding_strategy", "FULL_SHARD"),
                                                ("torch", "device", "cpu"), ("torch", "precision", "BF16")])
def test_the_alias_loaders_warn_for_the_knobs_they_ignore(variant, knob, value):
    from modalities_tpu_torch.config.component_factory import ComponentFactory
    from modalities_tpu_torch.registry.components import TRAINING_COMPONENTS
    from modalities_tpu_torch.registry.registry import Registry

    @dataclasses.dataclass
    class _LoaderOnly:
        loader: Any

    def build(config):
        node = {"component_key": "checkpoint_loading", "variant_key": variant, "config": config}
        return ComponentFactory(Registry(TRAINING_COMPONENTS)).build_components({"loader": node}, _LoaderOnly).loader

    with warnings.catch_warnings():
        warnings.simplefilter("error")
        assert type(build({"global_rank": 0})) is DCPCheckpointLoading  # defaults: no warning
    with pytest.warns(UserWarning, match=rf"checkpoint_loading\.{variant}: \['{knob}'\] have no effect"):
        loader = build({"global_rank": 0, knob: value})
    assert type(loader) is DCPCheckpointLoading


def test_loading_twice_is_refused(tmp_path):
    step = _train_step("float32", seed=0)
    _run(step, _batches(1))
    folder = _save(tmp_path, step, 1)
    app = AppState(_train_step("float32", seed=1))
    DCPCheckpointLoading().load_app_state(app, folder)
    before = {k: v.clone() for k, v in _full_state(app.train_step).items()}
    with pytest.raises(RuntimeError, match="double-load"):
        DCPCheckpointLoading().load_app_state(app, folder)
    assert all(torch.equal(v, before[k]) for k, v in _full_state(app.train_step).items())


def test_another_architecture_is_refused_naming_the_leaf(tmp_path):
    step = _train_step("float32", seed=0)
    _run(step, _batches(1))
    folder = _save(tmp_path, step, 1)
    other = AppState(_train_step("float32", seed=0, n_embd=256))
    with pytest.raises(CheckpointingError, match=r"architecture mismatch — model\.wte: saved \(128, 128\) != target"):
        DCPCheckpointLoading().load_app_state(other, folder)
    assert not other.is_loaded


def test_a_folder_that_fails_its_manifest_is_refused(tmp_path):
    step = _train_step("float32", seed=0)
    _run(step, _batches(1))
    folder = _save(tmp_path, step, 1)
    _flip_one_byte(folder / "__0_0.distcp", at=(folder / "__0_0.distcp").stat().st_size // 2)
    app = AppState(_train_step("float32", seed=1))
    with pytest.raises(CheckpointingError, match="digest mismatch"):
        DCPCheckpointLoading().load_app_state(app, folder)
    assert not app.is_loaded


def test_async_save_defers_the_resume_pointer_until_the_commit(tmp_path):
    step = _train_step("float32", seed=0)
    execution = DCPCheckpointSaving(tmp_path, "async", use_async=True)
    saving = CheckpointSaving(strategies.SaveKMostRecentCheckpointsStrategy(k=2), execution)
    info = tmp_path / "last_checkpoint_info.json"
    app = AppState(step)
    batches = _batches(2)
    _run(step, batches[:1])
    at_save = {k: v.clone() for k, v in _full_state(step).items()}
    saving.save_checkpoint(_progress(1), app)
    assert not info.exists() and execution._pending is not None  # save 1's pointer waits for its commit
    _run(step, batches[1:])  # trains on while save 1 may still be writing
    saving.save_checkpoint(_progress(2), app)
    pointed = Path(json.loads(info.read_text())["checkpoint_folder_path"])
    assert "seen_steps_1-" in pointed.name and manifest.verify_manifest(pointed).ok
    assert not (checkpoint_folder_path(tmp_path, "async", _progress(2)) / "manifest.json").exists()
    saving.wait_until_finished()
    pointed = Path(json.loads(info.read_text())["checkpoint_folder_path"])
    assert "seen_steps_2-" in pointed.name and manifest.verify_manifest(pointed).ok
    # the async write took the state as it was at the save: step 1's folder holds step 1's state bitwise,
    # though the step after the save changed every parameter before the write was confirmed
    folder1 = checkpoint_folder_path(tmp_path, "async", _progress(1))
    step1 = restore_tree_single_device(folder1, device="cpu")
    assert set(step1) == {k[len("model."):] for k in at_save if k.startswith("model.")}
    for name, tensor in step1.items():
        assert torch.equal(tensor, at_save[f"model.{name}"]), name
        assert not torch.equal(tensor, step.module.state_dict()[name]), name
    resumed = _train_step("float32", seed=1)
    DCPCheckpointLoading().load_app_state(AppState(resumed), folder1)
    loaded = _full_state(resumed)
    assert set(loaded) == set(at_save)
    for name, tensor in at_save.items():
        assert torch.equal(loaded[name], tensor), name


@pytest.mark.parametrize("use_async", [False, True], ids=["sync", "async"])
def test_the_k2_ring_deletes_folders_on_disk_and_the_pointer_names_the_newest(tmp_path, use_async):
    step = _train_step("float32", seed=0)
    execution = DCPCheckpointSaving(tmp_path, "ring", use_async=use_async)
    saving = CheckpointSaving(strategies.SaveKMostRecentCheckpointsStrategy(k=2), execution)
    app = AppState(step)
    for s in range(1, 5):
        saving.save_checkpoint(_progress(s), app)
    saving.wait_until_finished()
    folders = sorted(p.name for p in tmp_path.iterdir() if p.is_dir())
    assert [NumberConversion.get_num_seen_steps_from_checkpoint_path(f) for f in folders] == [3, 4]
    pointed = Path(json.loads((tmp_path / "last_checkpoint_info.json").read_text())["checkpoint_folder_path"])
    assert "seen_steps_4-" in pointed.name and manifest.verify_manifest(pointed).ok
    topology = read_topology(pointed)
    assert topology["device_count"] == 1 and set(topology["mesh_axes"].values()) == {1}
    assert topology["leaf_specs"]["model.wte"] == "()"


def test_a_forced_save_ignores_the_schedule_and_keeps_the_ring(tmp_path):
    step = _train_step("float32", seed=0)
    saving = CheckpointSaving(strategies.SaveKMostRecentCheckpointsStrategy(k=0),
                              DCPCheckpointSaving(tmp_path, "force"))
    saving.save_checkpoint(_progress(1), AppState(step))
    assert not any(tmp_path.iterdir())
    saving.save_checkpoint(_progress(2), AppState(step), force=True)
    assert [p.name for p in tmp_path.iterdir() if p.is_dir()] == [checkpoint_folder_path(tmp_path, "force",
                                                                                         _progress(2)).name]


# --------------------------------------------------------- JAX -> port resume


def test_the_port_resumes_the_jax_train_steps_checkpoint(tmp_path):
    from modalities_tpu.checkpointing.orbax.orbax_checkpoint_loading import (
        restore_tree_single_device as jax_restore,
    )
    from modalities_tpu.checkpointing.orbax.orbax_checkpoint_saving import OrbaxCheckpointSaving

    n, m = 2, 2
    _, _, _, fns = _jax_side(1.0)
    state = fns.app_state_handle.state
    params0 = jax.tree.map(np.array, state.params)
    batches = [{k: {kk: v.numpy().astype(np.int32) for kk, v in d.items()} for k, d in b.items()}
               for b in _batches(n + m, seed=5)]
    for batch in batches[:n]:
        state, _ = fns.train_step(state, fns.put_batch(batch))
    fns.app_state_handle.state = state
    OrbaxCheckpointSaving(tmp_path, "jax")._save_checkpoint(fns.app_state_handle, JaxProgress(n, n * TOKENS, 10,
                                                                                              10 * TOKENS))
    folder = next(p for p in tmp_path.iterdir() if p.is_dir())
    assert manifest.verify_manifest(folder).ok  # the JAX package's seal verifies in the port
    tree = jax.tree.map(np.asarray, jax_restore(folder))
    want = []
    for batch in batches[n:]:
        state, jm = fns.train_step(state, fns.put_batch(batch))
        want.append([float(jm[k]) for k in ("loss", "grad_norm", "lr")])

    model, step = _port_side(1.0, params0)  # built from the step-0 parameters: the load must replace them
    app = AppState(step)
    app.load_state_dict(app_state_from_jax(tree, step))
    assert app.step_count == n  # the first resumed step's lr is held to the JAX step's below
    for p in step.params:
        assert float(step.optimizer.state[p]["step"]) == n
    got = []
    for b in batches[n:]:
        metrics = step({k: {kk: torch.from_numpy(v) for kk, v in d.items()} for k, d in b.items()})
        got.append([float(metrics[key]) for key in ("loss", "grad_norm", "lr")])
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), **TOL)
    from modalities_tpu_torch.conversion.from_jax import params_from_jax

    final = params_from_jax(jax.tree.map(np.asarray, state.params), model)
    for name, tensor in step.state_dict().items():
        np.testing.assert_allclose(tensor.detach().numpy(), final[name].numpy(), err_msg=name, **TOL)


def test_a_port_checkpoint_folder_is_sealed_like_a_jax_one(tmp_path):
    step = _train_step("float32", seed=0)
    folder = _save(tmp_path, step, 2)
    sealed = json.loads((folder / "manifest.json").read_text())
    assert sealed["step"] == 2 and {f["path"] for f in sealed["files"]} == {".metadata", "__0_0.distcp",
                                                                           "topology.json"}
    assert jax_manifest.verify_manifest(folder).ok
    shutil.copytree(folder, tmp_path / "copy")
    _flip_one_byte(tmp_path / "copy" / ".metadata", at=10)
    assert not jax_manifest.verify_manifest(tmp_path / "copy").ok


# ------------------------------------------------------ two ranks (gloo)
# The tiny GPT2 with bf16 parameters (fp32 norms, each norm an FSDP2 unit of
# its own) on a dp_shard 2 mesh of two gloo ranks (tests/test_torch_gloo.py:
# checkpoint_worker): 2 of 4 steps, a save (each rank its shards, rank 0 the
# seal), a fresh build from another seed loaded from the folder.
TWO_RANK = dict(degrees={"dp_shard": 2}, dtypes=("bfloat16", "bfloat16", "float32"), acc=ACC, clip=1.0, opt=OPT,
                sched=SCHED, save_at=2, tokens_per_step=ACC * 2 * MB * SEQ)


@pytest.fixture(scope="module")
def two_rank_checkpoint(tmp_path_factory):
    from tests.test_torch_gloo import checkpoint_worker, run_world

    rng = np.random.default_rng(31)
    batches = []
    for _ in range(4):
        tokens = rng.integers(0, 128, size=(ACC, 2 * MB, SEQ + 1))
        batches.append({"samples": {"input_ids": tokens[..., :-1]}, "targets": {"target_ids": tokens[..., 1:]}})
    spec = {**TWO_RANK, "batches": batches, "seed": 0,
            "model": port_config(attention_implementation="dao_flash", use_weight_tying=False)}
    root = tmp_path_factory.mktemp("two_rank_checkpoint")
    return spec, run_world(2, checkpoint_worker, spec, str(root))


def test_a_two_rank_save_resumes_bitwise_on_two_ranks(two_rank_checkpoint):
    _, ranks = two_rank_checkpoint
    for r in ranks:
        assert len(r["got"]) == len(r["want"]) == 4
        for i, (g, w) in enumerate(zip(r["got"], r["want"])):
            assert np.array_equal(g, w), f"step {i + 1}: {g.tolist()} != {w.tolist()}"
    unbroken, resumed = ranks[0]["finals"]
    assert set(unbroken) == set(resumed)
    for name in unbroken:
        assert np.array_equal(unbroken[name], resumed[name]), name
    folder = Path(ranks[0]["folder"])
    assert {p.name for p in folder.iterdir()} == {".metadata", "__0_0.distcp", "__1_0.distcp", "manifest.json",
                                                  "topology.json"}
    topology = read_topology(folder)
    assert topology["mesh_axes"] == {"dp_shard": 2} and topology["process_count"] == 2
    assert topology["leaf_specs"]["model.blocks.0.attention_norm.scale"] == "('dp_shard',)"


def test_a_two_rank_save_loads_at_world_1_with_equal_parameters_and_logs_the_mismatch(two_rank_checkpoint,
                                                                                      caplog):
    from tests.test_torch_gloo import _tiny_step

    spec, ranks = two_rank_checkpoint
    step, _ = _tiny_step({**spec, "degrees": None, "seed": 1}, 1)
    with caplog.at_level("WARNING"):
        app = DCPCheckpointLoading().load_app_state(AppState(step), Path(ranks[0]["folder"]))
    assert app.step_count == 2
    assert any("another topology" in r.message and "mesh_axes" in r.message for r in caplog.records)
    loaded, saved = step.state_dict(), ranks[0]["saved"]
    assert set(loaded) == set(saved)
    for name, tensor in loaded.items():
        assert np.array_equal(tensor.float().numpy(), saved[name]), name
    assert step.module.blocks[0].attn.q_attn.kernel.dtype == torch.bfloat16


def test_the_jax_manifest_accepts_the_two_rank_folder(two_rank_checkpoint):
    _, ranks = two_rank_checkpoint
    folder = Path(ranks[0]["folder"])
    assert jax_manifest.verify_manifest(folder).ok and manifest.verify_manifest(folder).ok
    sealed = json.loads((folder / "manifest.json").read_text())
    assert sealed["step"] == 2 and {"__0_0.distcp", "__1_0.distcp"} <= {f["path"] for f in sealed["files"]}

"""The port stands alone: no module of modalities_tpu_torch, not the chip
smoke script and not the port's scripts import JAX, its libraries, or anything
of the JAX package (statically, by walking every import statement).

Besides, a regression guard for the train step's dict-in path (the ViT and
CoCa): a tiny GPT2 step fed through the trainer's device copy, with a float
sample key beside its token ids, is bitwise the step fed the int64 token
tensors alone, as every GPT2 step was fed before that path existed."""

import ast
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
FILES = (
    sorted((ROOT / "modalities_tpu_torch").rglob("*.py"))
    + [ROOT / "chip_smoke.py"]
    + sorted((ROOT / "scripts").glob("torch_*.py"))
)
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax", "chex", "modalities_tpu")


def _imports(path: Path) -> list[str]:
    names = []
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            names += [alias.name for alias in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.append(node.module)
    return names


def test_the_port_has_modules_to_check():
    assert len(FILES) > 10 and all(p.exists() for p in FILES)


def test_the_walk_covers_the_checkpointing_modules():
    walked = {str(p.relative_to(ROOT / "modalities_tpu_torch")) for p in FILES if "modalities_tpu_torch" in p.parts}
    assert {"resilience/retry.py", "resilience/manifest.py", "utils/number_conversion.py",
            "checkpointing/checkpoint_saving.py", "checkpointing/checkpoint_saving_instruction.py",
            "checkpointing/checkpoint_saving_strategies.py", "checkpointing/checkpoint_saving_execution.py",
            "checkpointing/topology.py", "checkpointing/stateful/app_state.py",
            "checkpointing/stateful/app_state_factory.py", "checkpointing/dcp/dcp_checkpoint_saving.py",
            "checkpointing/dcp/dcp_checkpoint_loading.py"} <= walked


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_and_no_jax_package_imports(path):
    bad = [name for name in _imports(path) if name.split(".")[0] in FORBIDDEN]
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def test_the_walk_covers_the_parallel_modules():
    walked = {str(p.relative_to(ROOT / "modalities_tpu_torch")) for p in FILES if "modalities_tpu_torch" in p.parts}
    assert {"running_env/env.py", "running_env/device_mesh.py", "parallel/fsdp.py",
            "parallel/ring_attention.py", "parallel/tensor_parallel.py", "parallel/vocab_parallel_ce.py",
            "nn/llama3_initialization.py", "registry/registry.py", "registry/components.py"} <= walked


def test_the_walk_covers_the_resilience_and_generation_modules():
    walked = {str(p.relative_to(ROOT / "modalities_tpu_torch")) for p in FILES if "modalities_tpu_torch" in p.parts}
    assert {"resilience/__init__.py", "resilience/errors.py", "resilience/anomaly.py", "resilience/faults.py",
            "resilience/coordination.py", "resilience/heartbeat.py", "resilience/supervisor.py",
            "utils/communication_test.py", "inference/inference.py",
            "inference/text/inference_component.py"} <= walked


def test_the_walk_covers_the_multimodal_modules():
    walked = {str(p.relative_to(ROOT / "modalities_tpu_torch")) for p in FILES if "modalities_tpu_torch" in p.parts}
    assert {"nn/attention.py", "nn/mlp.py", "models/model.py", "models/vision_transformer/vision_transformer_model.py",
            "models/coca/coca_model.py", "loss_functions.py", "dataloader/dataset.py",
            "conversion/from_jax.py"} <= walked


@pytest.fixture
def one_torch_thread():
    """torch on one intra-op thread: a tiny model's small ops on one thread a
    core spin against a `-n 6` run's other xdist workers (as in
    tests/test_torch_coca.py)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def test_a_gpt2_step_is_bitwise_the_same_through_the_device_copy_with_float_samples_beside_it(one_torch_thread):
    from modalities_tpu_torch.dataloader.dataloader import DatasetBatch
    from modalities_tpu_torch.trainer import stack_microbatches
    from tests.test_torch_gloo import _tiny_step
    from tests.test_torch_gpt2 import port_config

    spec = {"degrees": None, "seed": 3, "acc": 2, "clip": 1.0, "model": port_config(),
            "opt": dict(lr=1e-3, betas=(0.9, 0.95), eps=1e-8, weight_decay=0.1,
                        weight_decay_groups_excluded=["embedding", "norm"]),
            "sched": dict(warmup_steps=2, total_steps=10, initial_lr=0.0, final_lr=1e-4, max_lr=1e-3)}
    rng = np.random.default_rng(4)
    tokens = rng.integers(0, 128, size=(2, 2, 2, 33)).astype(np.int32)  # [steps, acc, mb, S + 1]
    images = rng.standard_normal((2, 2, 2, 8, 8, 3))
    runs = []
    for through_the_trainer in (False, True):
        step, _ = _tiny_step(spec, 1)
        metrics = []
        for t, im in zip(tokens, images):
            if through_the_trainer:  # the trainer's copy; an extra float key the GPT2 step must leave alone
                batch = stack_microbatches([DatasetBatch(samples={"input_ids": a[:, :-1], "images": i},
                                                         targets={"target_ids": a[:, 1:]}) for a, i in zip(t, im)],
                                           torch.device("cpu"))
                assert batch["samples"]["input_ids"].dtype == torch.int64
                assert batch["samples"]["images"].dtype == torch.float32
            else:  # the token tensors as the trainer made them before the dict-in path: int64, nothing else
                batch = {"samples": {"input_ids": torch.from_numpy(t[..., :-1].astype(np.int64))},
                         "targets": {"target_ids": torch.from_numpy(t[..., 1:].astype(np.int64))}}
            metrics.append([step(batch)[k].clone() for k in ("loss", "grad_norm", "lr")])
        runs.append((metrics, step.state_dict()))
    (m0, p0), (m1, p1) = runs
    assert all(torch.equal(a, b) for x, y in zip(m0, m1) for a, b in zip(x, y))
    assert p0.keys() == p1.keys() and all(torch.equal(p0[k], p1[k]) for k in p0)

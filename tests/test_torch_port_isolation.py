"""The port stands alone: no module of modalities_tpu_torch, not the chip
smoke script and not the port's scripts import JAX, its libraries, or anything
of the JAX package (statically, by walking every import statement)."""

import ast
from pathlib import Path

import pytest

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

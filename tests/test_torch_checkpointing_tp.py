"""Checkpoints of a tensor-parallel world: the tiny GPT2 (untied head, bf16
parameters, fp32 norms, the `gpt2_llama3_like` init drawn from a seed) on a
tp 2 gloo world with loss parallelism (tests/test_torch_gloo.py:
checkpoint_worker): 2 of 4 steps, a save through the DCP execution (each
rank its shards of the tp DTensors, rank 0 the seal), a fresh build from
another seed loaded from the folder.

- the resumed steps and the final parameters are bitwise the unbroken run's
  at tp 2;
- the folder loads at world 1 (no mesh) with bitwise the saved parameters;
- topology.json records the tp degree and the vocab-sharded leaves; the
  manifest gate is the one of every folder (both packages accept the seal,
  and a flipped byte is refused);
- the initial parameters drawn on the tp-2 world equal those the world-1
  step draws from the same seed: the init does not depend on the tp degree."""

import json
from pathlib import Path

import numpy as np
import pytest
import torch

from modalities_tpu.resilience import manifest as jax_manifest
from modalities_tpu_torch.checkpointing.dcp.dcp_checkpoint_loading import DCPCheckpointLoading
from modalities_tpu_torch.checkpointing.stateful.app_state import AppState
from modalities_tpu_torch.checkpointing.topology import read_topology
from modalities_tpu_torch.nn.llama3_initialization import Llama3Initializer
from modalities_tpu_torch.resilience import manifest
from tests.test_torch_checkpointing import ACC, MB, OPT, SCHED, SEQ, _flip_one_byte
from tests.test_torch_gpt2 import port_config

TP_TWO = dict(degrees={"tp": 2}, loss_parallel=True, dtypes=("bfloat16", "bfloat16", "float32"), acc=ACC, clip=1.0,
              opt=OPT, sched=SCHED, save_at=2, tokens_per_step=ACC * MB * SEQ,
              init_routines=(Llama3Initializer(num_layers=2, n_embd=128),))


@pytest.fixture(scope="module")
def tp_checkpoint(tmp_path_factory):
    from tests.test_torch_gloo import checkpoint_worker, run_world

    rng = np.random.default_rng(37)
    batches = []
    for _ in range(4):
        tokens = rng.integers(0, 128, size=(ACC, MB, SEQ + 1))
        batches.append({"samples": {"input_ids": tokens[..., :-1]}, "targets": {"target_ids": tokens[..., 1:]}})
    spec = {**TP_TWO, "batches": batches, "seed": 0,
            "model": port_config(attention_implementation="dao_flash", use_weight_tying=False)}
    root = tmp_path_factory.mktemp("tp_checkpoint")
    return spec, run_world(2, checkpoint_worker, spec, str(root))


def test_a_tp_2_save_resumes_bitwise_at_tp_2(tp_checkpoint):
    _, ranks = tp_checkpoint
    for r in ranks:
        assert len(r["got"]) == len(r["want"]) == 4
        for i, (g, w) in enumerate(zip(r["got"], r["want"])):
            assert np.array_equal(g, w), f"step {i + 1}: {g.tolist()} != {w.tolist()}"
    unbroken, resumed = ranks[0]["finals"]
    assert set(unbroken) == set(resumed)
    for name in unbroken:
        assert np.array_equal(unbroken[name], resumed[name]), name


def test_a_tp_2_save_loads_at_world_1_with_equal_parameters(tp_checkpoint):
    from tests.test_torch_gloo import _tiny_step

    spec, ranks = tp_checkpoint
    step, _ = _tiny_step({**spec, "degrees": None, "seed": 1}, 1)
    app = DCPCheckpointLoading().load_app_state(AppState(step), Path(ranks[0]["folder"]))
    assert app.step_count == 2
    loaded, saved = step.state_dict(), ranks[0]["saved"]
    assert set(loaded) == set(saved)
    for name, tensor in loaded.items():
        assert np.array_equal(tensor.float().numpy(), saved[name]), name


def test_the_topology_records_tp_and_the_manifest_gate_holds(tp_checkpoint, tmp_path):
    import shutil

    _, ranks = tp_checkpoint
    folder = Path(ranks[0]["folder"])
    topology = read_topology(folder)
    assert topology["mesh_axes"] == {"dp_shard": 1, "tp": 2} and topology["process_count"] == 2
    assert topology["leaf_specs"]["model.wte"] == "(('dp_shard', 'tp'), None)"
    assert topology["leaf_specs"]["model.blocks.0.attn.q_attn.kernel"] == "('dp_shard', 'tp')"
    assert topology["leaf_specs"]["model.blocks.0.attention_norm.scale"] == "('dp_shard',)"
    assert jax_manifest.verify_manifest(folder).ok and manifest.verify_manifest(folder).ok
    assert json.loads((folder / "manifest.json").read_text())["step"] == 2
    shutil.copytree(folder, tmp_path / "copy")
    _flip_one_byte(tmp_path / "copy" / "__1_0.distcp", at=100)
    assert not manifest.verify_manifest(tmp_path / "copy").ok


def test_the_llama3_init_does_not_depend_on_the_tp_degree(tp_checkpoint):
    from tests.test_torch_gloo import _numpy, _tiny_step

    spec, ranks = tp_checkpoint
    single, _ = _tiny_step({**spec, "degrees": None}, 1)
    want, got = _numpy(single.state_dict()), ranks[0]["initial"]
    assert set(want) == set(got)
    for name in want:
        assert np.array_equal(got[name], want[name]), name
    assert float(np.std(want["wte"])) == pytest.approx(1.0, rel=0.05)  # drawn by the Llama3 init, not the default
    assert single.module.blocks[0].attn.q_attn.kernel.dtype == torch.bfloat16

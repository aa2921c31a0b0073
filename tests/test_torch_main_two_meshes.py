"""Two `Main` runs in one process on different meshes: on a world of 4 gloo
ranks, each rank's one process runs `run` on a dp_shard 2 x tp 2 twin of
configs/config_7b_tp_fsdp.yaml, then `warmstart` on a cp 2 x tp 2 twin of
configs/config_7b_warmstart_32k.yaml from that run's step-4 folder (the
twins of tests/test_torch_warmstart_7b_chain.py, which launches each run as
a world of its own). The JAX package runs its twin chain in one process too.

What broke it: DTensor caches its sharding decisions keyed by DeviceMesh
equality, which ignores process-group names, so the second run's tp
parameters came back on the first run's (torn down) tp mesh, and its first
grad norm asked for a group that no longer existed
(running_env/env.py:clear_dtensor_caches, run where `Main` tears its group
down).

The second run's steps are held against the same warmstart launched as a
world of its own from the same folder (the chain test's route): the first
resumed step's loss, grad norm and lr at 1e-6, and the step after it."""

import json

import numpy as np

from tests.test_torch_gloo import cli_command_worker, cli_worker, free_port, run_world
from tests.test_torch_warmstart_7b_chain import PRE_STEPS, SEEN_TOKENS, WARM_STEPS, WORLD, _twins


def test_run_then_warmstart_on_another_mesh_in_one_process(tmp_path):
    (tmp_path / "chain").mkdir()
    (tmp_path / "alone").mkdir()
    pretrain, warm = _twins(tmp_path / "chain")
    _, warm_alone = _twins(tmp_path / "alone")  # its own checkpoint and experiment folders
    info = tmp_path / "chain" / "checkpoints" / "last_checkpoint_info.json"
    chain = run_world(WORLD, cli_worker, str(pretrain), str(warm), str(info), (free_port(), free_port()))

    steps = chain[0]["steps"]
    assert len(steps) == PRE_STEPS + WARM_STEPS and np.isfinite(steps).all()
    assert all(r["steps"] == steps for r in chain)
    assert "mesh {'dp_shard': 2, 'tp': 2}" in chain[0]["printed"][0]
    assert "mesh {'dp_shard': 1, 'cp': 2, 'tp': 2}" in chain[0]["printed"][1]

    folders = [p for p in (tmp_path / "chain" / "checkpoints").iterdir()
               if f"seen_steps_{PRE_STEPS}-seen_tokens_{SEEN_TOKENS}-" in p.name]
    assert len(folders) == 1
    pre_info = tmp_path / "pretrain_info.json"
    pre_info.write_text(json.dumps({"checkpoint_folder_path": str(folders[0])}))
    alone = run_world(WORLD, cli_command_worker, ["warmstart", "--config_file_path", str(warm_alone),
                                                  "--last_checkpoint_info_file_path", str(pre_info)])
    assert len(alone[0]["steps"]) == WARM_STEPS
    np.testing.assert_allclose(steps[PRE_STEPS:], alone[0]["steps"], rtol=1e-6, atol=0)

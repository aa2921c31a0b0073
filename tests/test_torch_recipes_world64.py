"""The three shipped multi-card recipes built on a fake world of 64
(utils/recipe_validation.py: rank 0's view under FakeTensorMode, nothing
materialized), one at a time in this process, against the JAX models'
parameter counts (`jax.eval_shape`), their parameters sharded over the
mesh."""

from pathlib import Path

import jax
import numpy as np
import pytest
from pydantic import BaseModel

from modalities_tpu.config.component_factory import ComponentFactory as JaxComponentFactory
from modalities_tpu.config.yaml_interp import load_app_config_dict as jax_load_config
from modalities_tpu.registry.components import COMPONENTS as JAX_COMPONENTS
from modalities_tpu.registry.registry import Registry as JaxRegistry
from modalities_tpu_torch.utils.recipe_validation import _FAKE_WARMSTART_FOLDER, build_train_step, state_bytes

ROOT = Path(__file__).resolve().parents[1]


class _ModelRaw(BaseModel):
    model_raw: object


@pytest.mark.parametrize("name,mesh", [("config_2p7b_dp.yaml", {"dp_shard": 64}),
                                       ("config_7b_tp_fsdp.yaml", {"dp_shard": 8, "tp": 8}),
                                       ("config_7b_warmstart_32k.yaml", {"dp_shard": 2, "cp": 4, "tp": 8})])
def test_the_shipped_recipes_build_at_world_64_with_the_jax_models_parameters(name, mesh, monkeypatch):
    for var, value in (("RANK", "0"), ("WORLD_SIZE", "64"), ("LOCAL_RANK", "0")):
        monkeypatch.setenv(var, value)
    raw = jax_load_config(ROOT / "configs" / name, experiment_id="recipe_validation",
                          additional_resolver_funs={"warmstart_env": lambda key: _FAKE_WARMSTART_FOLDER})
    model = JaxComponentFactory(JaxRegistry(JAX_COMPONENTS)).build_components(
        {"model_raw": raw["model_raw"]}, _ModelRaw).model_raw
    shapes = jax.eval_shape(lambda: model.init_params(jax.random.PRNGKey(0)))
    want = sum(int(np.prod(leaf.shape)) for leaf in jax.tree.leaves(shapes))
    with build_train_step(ROOT / "configs" / name) as built:
        assert built.world_size == 64
        assert {k: v for k, v in built.device_mesh.degrees.items() if v > 1} == mesh
        step = built.train_step
        assert sum(p.numel() for p in step.params) == want
        params = state_bytes(step)["params_bytes"]
    assert params < 2 * 2 * want / 64 * mesh.get("cp", 1), "the parameters are not sharded over the mesh"

"""The schedules the JAX-parity worlds leave out, over the real transport
(point-to-point over the pp group) with tp and cp: gloo worlds of 4 ranks
(pp 2 x tp 2 with dualpipev, pp 2 x cp 2 with interleaved_1f1b, pp 2 x
dp_shard 2 with gpipe) against the port's world-1 step on the same global
batches, 3 steps of the tiny tied GPT2 at 4 layers with the loss mask: loss,
grad norm, lr and the parameters after the steps at 1e-5 (f32). The JAX
parity of the tables and of each schedule's step is
tests/test_torch_pipeline_schedules.py's and tests/test_torch_pipeline.py's;
1f1b and zbv meet the JAX mesh step in tests/test_torch_parallel_train_pp_*.py."""

import numpy as np
import pytest
import torch

from tests.test_torch_gloo import _tiny_step, run_world, train_worker
from tests.test_torch_gpt2 import port_config
from tests.test_torch_parallel_train import _batches
from tests.test_torch_train_step import OPT, SCHED, TOL

WORLDS = {
    "pp-2-x-tp-2-dualpipev": ({"pp": 2, "tp": 2}, "dualpipev", 2),
    "pp-2-x-cp-2-interleaved_1f1b": ({"pp": 2, "cp": 2}, "interleaved_1f1b", 2),
    "pp-2-x-dp_shard-2-gpipe": ({"pp": 2, "dp_shard": 2}, "gpipe", 1),
}


@pytest.mark.parametrize("name", list(WORLDS))
def test_the_schedule_over_p2p_gives_the_world_1_step(name):
    degrees, schedule, virtual = WORLDS[name]
    batches = _batches(True)
    spec = {"model": port_config(attention_implementation="dao_flash", use_weight_tying=True, n_layer=4), "opt": OPT,
            "sched": SCHED, "clip": 1.0, "acc": 2, "batches": batches, "params": None, "seed": 0}
    single, _ = _tiny_step({**spec, "degrees": None}, 1)
    want = []
    for batch in batches:
        m = single({part: {k: torch.from_numpy(v) for k, v in d.items()} for part, d in batch.items()})
        want.append([float(m[k]) for k in ("loss", "grad_norm", "lr")])
    ranks = run_world(4, train_worker, {**spec, "degrees": degrees, "loss_parallel": "tp" in degrees,
                                        "pipeline": {"pp_schedule": schedule, "pp_num_microbatches": 2,
                                                     "pp_num_virtual": virtual}})
    for r in ranks:  # every rank reports the global metrics
        np.testing.assert_allclose(r["metrics"], want, **TOL)
    got = {k: v for r in ranks if r["state"] is not None for k, v in r["state"].items()}
    expected = {k: v.detach().numpy() for k, v in single.state_dict().items()}
    assert set(got) == set(expected)
    for key in expected:
        np.testing.assert_allclose(got[key], expected[key], err_msg=key, **TOL)

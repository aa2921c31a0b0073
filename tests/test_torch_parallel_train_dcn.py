"""The port's train step on a dcn 2 x dp_shard 2 gloo world (two slices of
two ranks) against the JAX `TrainStepBuilder` on the same mesh of the CPU
devices: tests/test_torch_parallel_train.py's test (loss, grad norm and lr of
3 steps, the parameters after them, 1e-5).

The loss mask gives the slices unequal token counts (slice 0 holds the
global microbatch's rows 0-1, which lose targets; slice 1 rows 2-3, which
keep all), so each slice's own normalization shows: the loss is the mean of
the slices' token means, as in the JAX step, and not the global token mean
of the port's world-1 step (not compared here). A shim inside each worker
records the collectives on its dcn group: none runs while a microbatch is
in flight, and after the loop there is one reduction of the gradients and
one of the loss (the contract of the JAX reference caveat
`test_one_cross_slice_reduction_per_optimizer_step`, held on the port).

The same steps with both slices in one process (`dcn_in_process=2`, the
card's check of the path, world 1 without a mesh) equal the gloo world's
(loss, grad norm, lr and parameters, 1e-5), and so do their eval losses,
the mean of the slices' token means."""

import numpy as np
import torch

from tests.test_torch_gloo import _tiny_step
from tests.test_torch_parallel_train import ACC, STEPS, _batches, _spec, check_world
from tests.test_torch_train_step import TOL

WORLD = dict(degrees={"dcn": 2, "dp_shard": 2}, mask=True, world_1=False, count_dcn=True)


def test_the_dcn_world_matches_the_jax_mesh_step_with_one_cross_slice_reduction_a_step():
    ranks, params = check_world(WORLD)
    batches = _batches(True)
    in_process, _ = _tiny_step({**_spec(WORLD, params, batches, None), "dcn_in_process": 2}, 1)
    for batch, want in zip(batches, ranks[0]["metrics"]):
        m = in_process({part: {k: torch.from_numpy(v) for k, v in d.items()} for part, d in batch.items()})
        np.testing.assert_allclose([float(m[k]) for k in ("loss", "grad_norm", "lr")], want, **TOL)
    for key, value in in_process.state_dict().items():
        np.testing.assert_allclose(value.detach().numpy(), ranks[0]["state"][key], err_msg=key, **TOL)
    first = {part: {k: torch.from_numpy(v[0]) for k, v in d.items()} for part, d in batches[0].items()}
    mean_of_slices = float(in_process.eval_step(first)["loss"])
    in_process.slices = in_process.dcn = 1  # the same step as one slice: each slice's token mean
    token_means = [float(in_process.eval_step({part: {key: v[2 * k:2 * k + 2] for key, v in d.items()}
                                               for part, d in first.items()})["loss"]) for k in range(2)]
    assert abs(mean_of_slices - sum(token_means) / 2) < 1e-6
    assert abs(mean_of_slices - float(in_process.eval_step(first)["loss"])) > 1e-3  # not the global token mean
    for r in ranks:
        events = r["dcn"]
        steps = [i for i, e in enumerate(events) if e == "step"] + [len(events)]
        assert len(steps) == STEPS + 1
        for start, end in zip(steps, steps[1:]):
            window = events[start + 1:end]
            last_microbatch = max(i for i, e in enumerate(window) if e == "microbatch")
            assert window.count("microbatch") == ACC
            assert all(e == "microbatch" for e in window[:last_microbatch + 1]), window
            assert window[last_microbatch + 1:] == ["all_reduce", "all_reduce"], window
    # the mask bites: the slices' token counts differ
    targets = _batches(True)[0]["targets"]["target_ids"][0]
    counts = [(targets[2 * k:2 * k + 2] != -100).sum() for k in range(2)]
    assert counts[0] != counts[1]


"""The port's device mesh component (modalities_tpu_torch/running_env/
device_mesh.py) against the JAX package's `DeviceMeshConfig` and
`get_device_mesh` on the 8 CPU devices of tests/conftest.py:

- the same inputs are accepted or rejected, and -1 infers the same degree;
- the built axes and their order are the JAX mesh's;
- each rank's data-loading coordinate is that of JAX device `rank` in the
  JAX mesh of the same degrees (rank r of the port sits where device r
  sits), for (dp_shard 2, cp 2) and (dp_replicate 2, dp_shard 2): the cp
  ranks of one dp coordinate read the same samples, and so do the tp ranks
  of one dp coordinate;
- tensor parallelism builds the tp axis last; loss parallelism needs tp > 1
  (the JAX validator's check, a ValueError here);
- the pp axis is built outside the dp axes and the dcn axis outermost, as
  in the JAX mesh, and the pp ranks of one dp coordinate read the same
  samples (the JAX loader's flat dp coordinate of the device, dcn folded in:
  slice k's ranks read the k-th block of coordinates, and a global
  microbatch's k-th block of rows);
- `zero_stage` above 1 is a ValueError (the JAX field's `le=1`), and the
  compositions the JAX builder does not build (dcn with pp or cp, an active
  ZeRO-1 with pp) are refused with NotImplementedError, naming ROADMAP.md
  Queue 1 item 5."""

import jax
import numpy as np
import pytest

from modalities_tpu.exceptions import ConfigError
from modalities_tpu.running_env.device_mesh import DeviceMeshConfig, get_device_mesh
from modalities_tpu_torch.running_env.device_mesh import (
    DeviceMesh,
    get_data_loading_info,
    get_parallel_degree,
    get_parallel_rank,
)
from tests.test_torch_gloo import batch_rows

VALIDATION_CASES = [  # (world, dp_replicate, dp_shard, cp)
    (1, 1, -1, 1), (1, 1, 1, 1), (2, 1, -1, 1), (4, 2, -1, 1), (4, -1, 2, 1), (4, 1, -1, 2), (4, 1, 2, 2),
    (8, 2, 2, 2), (8, -1, 2, 2), (4, 1, 1, 4), (4, -1, -1, 1), (4, 1, 3, 1), (4, 2, 2, 2), (6, 1, -1, 4),
    (4, 0, 2, 1), (4, 1, 0, 4), (3, 2, -1, 1),
]


def _jax(world, rep, shard, cp):
    try:
        cfg = DeviceMeshConfig(world_size=world, data_parallel_replicate_degree=rep,
                               data_parallel_shard_degree=shard, context_parallel_degree=cp)
    except (ConfigError, ValueError):
        return None
    return cfg.data_parallel_replicate_degree, cfg.data_parallel_shard_degree


def _port(world, rep, shard, cp):
    try:
        mesh = DeviceMesh(world_size=world, data_parallel_replicate_degree=rep, data_parallel_shard_degree=shard,
                          context_parallel_degree=cp)
    except ValueError:
        return None
    return mesh.data_parallel_replicate_degree, mesh.data_parallel_shard_degree


@pytest.mark.parametrize("case", VALIDATION_CASES, ids=lambda c: "world{}-rep{}-shard{}-cp{}".format(*c))
def test_the_validator_accepts_rejects_and_infers_as_the_jax_one(case):
    assert _port(*case) == _jax(*case)


@pytest.mark.parametrize("degrees", [dict(dp_shard=1), dict(dp_shard=4), dict(dp_replicate=2, dp_shard=2),
                                     dict(dp_shard=2, cp=2), dict(cp=4), dict(dp_replicate=2, dp_shard=2, cp=2),
                                     dict(tp=2), dict(dp_shard=2, tp=2), dict(cp=2, tp=2),
                                     dict(dp_replicate=2, dp_shard=2, tp=2), dict(pp=2), dict(pp=2, dp_shard=2, tp=2),
                                     dict(pp=2, dp_shard=2, cp=2), dict(pp=4, dp_replicate=2), dict(dcn=2, dp_shard=4),
                                     dict(dcn=2, dp_replicate=2, dp_shard=2), dict(dcn=2, dp_shard=2, tp=2)],
                         ids=lambda d: "-".join(f"{k}{v}" for k, v in d.items()))
def test_the_axes_and_each_ranks_coordinates_are_the_jax_meshs(degrees):
    world = int(np.prod(list(degrees.values())))
    kw = dict(data_parallel_replicate_degree=degrees.get("dp_replicate", 1),
              data_parallel_shard_degree=degrees.get("dp_shard", 1), context_parallel_degree=degrees.get("cp", 1),
              tensor_parallel_degree=degrees.get("tp", 1), pipeline_parallel_degree=degrees.get("pp", 1),
              dcn_parallel_degree=degrees.get("dcn", 1))
    port = DeviceMesh(world_size=world, **kw)
    handle = get_device_mesh(device_type="cpu", world_size=world, devices=jax.devices()[:world], **kw)
    mesh = handle.mesh
    assert tuple(port.mesh_axes) == tuple(mesh.axis_names)
    assert tuple(port.mesh_axes.values()) == tuple(mesh.devices.shape)
    for rank in range(world):
        coords = np.argwhere(mesh.devices == jax.devices()[rank])[0]
        want = dict(zip(mesh.axis_names, (int(c) for c in coords)))
        assert port.coordinates(rank) == want
        for name in ("dp_replicate", "dp_shard", "cp", "tp", "pp", "dcn"):
            assert get_parallel_rank(port, name, rank) == want.get(name, 0)
            assert get_parallel_degree(port, name) == handle.get_parallel_degree(name)
        # the JAX loader's rows for device `rank` (get_data_loading_info's flat dp coordinate)
        dp_axes = [n for n in ("dcn", "dp_replicate", "dp_shard") if n in mesh.axis_names]
        flat = 0
        for n in dp_axes:
            flat = flat * mesh.shape[n] + want[n]
        assert get_data_loading_info(port, rank) == (int(np.prod([mesh.shape[n] for n in dp_axes])), flat)
        assert port.pp_rank(rank) == want.get("pp", 0)


def test_the_data_loading_info_gives_cp_ranks_the_same_samples():
    shard_cp = DeviceMesh(world_size=4, data_parallel_shard_degree=2, context_parallel_degree=2)
    assert [get_data_loading_info(shard_cp, r) for r in range(4)] == [(2, 0), (2, 0), (2, 1), (2, 1)]
    hsdp = DeviceMesh(world_size=4, data_parallel_replicate_degree=2, data_parallel_shard_degree=2)
    assert [get_data_loading_info(hsdp, r) for r in range(4)] == [(4, 0), (4, 1), (4, 2), (4, 3)]
    assert get_data_loading_info(DeviceMesh(world_size=1)) == (1, 0)
    assert get_data_loading_info(None) == (1, 0)


def test_the_data_loading_info_gives_tp_ranks_the_same_samples():
    shard_tp = DeviceMesh(world_size=4, data_parallel_shard_degree=2, tensor_parallel_degree=2)
    assert [get_data_loading_info(shard_tp, r) for r in range(4)] == [(2, 0), (2, 0), (2, 1), (2, 1)]
    full = DeviceMesh(world_size=16, data_parallel_replicate_degree=2, data_parallel_shard_degree=2,
                      context_parallel_degree=2, tensor_parallel_degree=2)
    assert [get_data_loading_info(full, r) for r in range(16)] == [(4, r // 4) for r in range(16)]


@pytest.mark.parametrize("edits,error,match", [
    (dict(world_size=8, pipeline_parallel_degree=2, data_parallel_replicate_degree=2, data_parallel_shard_degree=2,
          zero_stage=1), NotImplementedError, "zero_stage 1 .* pipeline_parallel_degree 2: the reference"),
    (dict(world_size=4, dcn_parallel_degree=2, pipeline_parallel_degree=2, data_parallel_shard_degree=1),
     NotImplementedError, "dcn_parallel_degree 2 with pipeline_parallel_degree 2: the reference"),
    (dict(world_size=2, zero_stage=2), ValueError, "zero_stage: must be <= 1"),
    (dict(world_size=4, dcn_parallel_degree=2, context_parallel_degree=2, data_parallel_shard_degree=1),
     NotImplementedError, "dcn_parallel_degree 2 with context_parallel_degree 2: the reference"),
], ids=["pp", "dcn", "zero", "dcn-cp"])
def test_what_item_5_still_holds_is_refused(edits, error, match):
    with pytest.raises(error, match=match):
        DeviceMesh(**edits)


def test_the_dcn_and_zero_knobs_validate_as_the_jax_config():
    for kw in (dict(world_size=8, data_parallel_shard_degree=4, dcn_parallel_degree=2),
               dict(world_size=8, data_parallel_shard_degree=-1, dcn_parallel_degree=2),
               dict(world_size=8, data_parallel_shard_degree=4, dcn_parallel_degree=3),
               dict(world_size=8, data_parallel_shard_degree=4, zero_stage=1),
               dict(world_size=8, data_parallel_shard_degree=4, zero_stage=2)):
        try:
            jax_cfg = DeviceMeshConfig(**kw)
            want = (jax_cfg.data_parallel_shard_degree, jax_cfg.dcn_parallel_degree, jax_cfg.zero_stage)
        except (ConfigError, ValueError):
            want = None
        try:
            port = DeviceMesh(**kw)
            got = (port.data_parallel_shard_degree, port.dcn_parallel_degree, port.zero_stage)
        except ValueError:
            got = None
        assert got == want, kw
    # -1 resolves to 1, as the JAX mesh does on devices without slices; zero is inert without replicas
    auto = DeviceMesh(world_size=8, data_parallel_shard_degree=8, zero_stage=1)
    handle = get_device_mesh(device_type="cpu", data_parallel_shard_degree=8, world_size=8, zero_stage=1)
    assert auto.dcn_parallel_degree == handle.dcn_degree == 1 and "dcn" not in auto.mesh_axes
    assert not auto.zero_active and DeviceMesh(world_size=4, data_parallel_replicate_degree=2, zero_stage=1).zero_active


def test_each_slice_feeds_its_contiguous_block_of_a_microbatch():
    """The union of slice k's ranks' rows (tests/test_torch_gloo.py's
    `batch_rows`, from `get_data_loading_info`) is the k-th block of
    a global microbatch, the rows the JAX batch sharding puts on the
    devices of dcn coordinate k; the tp ranks of a dp coordinate feed the
    same rows."""
    mesh = DeviceMesh(world_size=16, dcn_parallel_degree=2, data_parallel_replicate_degree=2,
                      data_parallel_shard_degree=2, tensor_parallel_degree=2)
    rows = {r: batch_rows(mesh, 16, r) for r in range(16)}
    for k in range(2):
        mine = sorted(i for r in range(16) if mesh.coordinates(r)["dcn"] == k for i in rows[r])
        assert sorted(set(mine)) == list(range(8 * k, 8 * k + 8))
    assert all(rows[r] == rows[r + 1] for r in range(0, 16, 2)) and len(rows[0]) == 2
    with pytest.raises(ValueError, match="not divisible by dcn_parallel_degree 2"):
        batch_rows(mesh, 7, 0)


TP_CASES = [  # (world, dp_shard, tp, cp, enable_loss_parallel)
    (2, 1, 2, 1, False), (2, -1, 2, 1, True), (8, -1, 2, 2, True), (8, 2, 4, 1, True), (4, 2, 2, 1, False),
    (2, 2, 1, 1, True), (1, 1, 1, 1, True), (4, 1, 2, 1, True), (8, -1, 8, 1, True),
]


@pytest.mark.parametrize("case", TP_CASES, ids=lambda c: "world{}-shard{}-tp{}-cp{}-lp{}".format(*c))
def test_tensor_and_loss_parallelism_validate_as_the_jax_mesh(case):
    world, shard, tp, cp, lp = case
    kw = dict(world_size=world, data_parallel_shard_degree=shard, tensor_parallel_degree=tp,
              context_parallel_degree=cp, enable_loss_parallel=lp)
    try:
        jax_cfg = DeviceMeshConfig(**kw)
        want = (jax_cfg.data_parallel_shard_degree, jax_cfg.tensor_parallel_degree)
    except (ConfigError, ValueError):
        want = None
    try:
        port = DeviceMesh(**kw)
        got = (port.data_parallel_shard_degree, port.tensor_parallel_degree)
    except ValueError:
        got = None
    assert got == want


def test_tp_validates_and_its_axis_is_built_last():
    mesh = DeviceMesh(world_size=2, tensor_parallel_degree=2, data_parallel_shard_degree=1)
    assert list(mesh.mesh_axes.items())[-1] == ("tp", 2)
    assert list(DeviceMesh(world_size=16, data_parallel_replicate_degree=2, data_parallel_shard_degree=2,
                           context_parallel_degree=2, tensor_parallel_degree=2).mesh_axes) == [
        "dp_replicate", "dp_shard", "cp", "tp"]


def test_loss_parallelism_needs_tp():
    with pytest.raises(ValueError, match="requires tensor_parallel_degree > 1"):
        DeviceMesh(world_size=2, enable_loss_parallel=True)
    assert DeviceMesh(world_size=2, tensor_parallel_degree=2, data_parallel_shard_degree=1,
                      enable_loss_parallel=True).enable_loss_parallel


def test_an_unknown_method_is_refused():
    with pytest.raises(ValueError, match="unknown parallelism method"):
        get_parallel_degree(DeviceMesh(world_size=1), "ep")

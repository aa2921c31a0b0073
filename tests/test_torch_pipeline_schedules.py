"""The port's copy of the schedule tables (modalities_tpu_torch/parallel/
pipeline_schedules.py, plain numpy, no JAX) against the JAX package's
`build_schedule_tables`: the F, B and head tables, the placement, the
split-backward flag, the in-flight bound and the bubble, array for array,
for every schedule at every (P, M, V) that tests/parallel/
test_pipeline_schedules.py builds; the JAX executor's buffer-slot plan; the
schedule names the configs accept (the reference's class names as aliases)
and the errors, with the JAX messages. Also the stage layout each pp device
runs (parallel/pipeline.py): every global stage once, on the device the
tables place it, its layers contiguous."""

import numpy as np
import pytest

from modalities_tpu.parallel import pipeline_schedules as jax_schedules
from modalities_tpu.parallel.pipeline_scheduled import _slot_assignment
from modalities_tpu_torch.parallel import pipeline_schedules as port
from modalities_tpu_torch.parallel.pipeline import holds_first, holds_last, stage_chunks
from modalities_tpu_torch.parallel.pipeline_scheduled import tick_messages

CASES = sorted({
    *[(s, P, M, 1) for s in ("gpipe", "1f1b") for P, M in [(2, 2), (2, 4), (4, 4), (4, 8), (4, 16), (8, 8), (4, 16),
                                                          (8, 32)]],
    *[("interleaved_1f1b", P, M, V) for P, M, V in [(2, 4, 2), (2, 8, 4), (4, 8, 2), (8, 16, 2), (4, 16, 2)]],
    *[("zbv", P, M, 1) for P, M in [(2, 2), (2, 4), (4, 4), (4, 8), (8, 8), (8, 16)]],
    *[("dualpipev", P, M, 1) for P, M in [(2, 4), (4, 8), (8, 8), (8, 10), (2, 2), (4, 4), (4, 2), (8, 16)]],
    ("1f1b", 4, 6, 1), ("interleaved_1f1b", 4, 6, 2),  # M not a multiple of P: the greedy builders
})


@pytest.mark.parametrize("case", CASES, ids=lambda c: "{}-P{}-M{}-V{}".format(*c))
def test_the_tables_are_the_jax_tables(case):
    schedule, P, M, V = case
    want = jax_schedules.build_schedule_tables(schedule, P, M, num_virtual=V)
    got = port.build_schedule_tables(schedule, P, M, num_virtual=V)
    for name in ("f", "b", "h"):
        np.testing.assert_array_equal(getattr(got, name), getattr(want, name), err_msg=name)
    for name in ("num_stages", "num_microbatches", "num_virtual", "placement", "deferred_w", "num_ticks",
                 "max_inflight", "bubble_fraction"):
        assert getattr(got, name) == getattr(want, name), name
    for g in range(got.num_stages_global):
        assert got.device_of(g) == want.device_of(g)
        assert got.global_stage(got.chunk_of(g), got.device_of(g)) == g


@pytest.mark.parametrize("case", [("gpipe", 4, 16, 1), ("1f1b", 4, 16, 1), ("interleaved_1f1b", 4, 16, 2),
                                  ("1f1b", 2, 4, 1), ("zbv", 2, 4, 1)], ids=lambda c: "{}-P{}-M{}-V{}".format(*c))
def test_the_slot_plan_is_the_jax_executors(case):
    schedule, P, M, V = case
    want = _slot_assignment(jax_schedules.build_schedule_tables(schedule, P, M, num_virtual=V))
    got = port.slot_assignment(port.build_schedule_tables(schedule, P, M, num_virtual=V))
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[2], want[2])
    assert (got[1], got[3]) == (want[1], want[3])


def test_the_alias_names_select_the_jax_factorys_schedules():
    for alias, name in {"ZBVZeroBubble": "zbv", "zb_v": "zbv", "zbv_zero_bubble": "zbv", "DualPipe_V": "dualpipev",
                        "dual_pipe_v": "dualpipev", "ScheduleDualPipeV": "dualpipev", " 1F1B ": "1f1b",
                        "Interleaved_1F1B": "interleaved_1f1b", "gpipe": "gpipe"}.items():
        assert port.canonical_schedule_name(alias) == name
    assert port.canonical_schedule_name("looped_bfs") == "looped_bfs"  # passes through; the factory refuses it
    assert port.SUPPORTED_SCHEDULES == jax_schedules.SUPPORTED_SCHEDULES


@pytest.mark.parametrize("args,error,match", [
    (("looped_bfs", 4, 8), NotImplementedError, "not supported"),
    (("zbv", 2, 4, 4), ValueError, "exactly 2 virtual chunks"),
    (("dualpipev", 2, 4, 3), ValueError, "exactly 2 virtual chunks"),
    (("1f1b", 4, 8, 2), ValueError, "requires num_virtual=1"),
    (("interleaved_1f1b", 4, 8, 1), ValueError, "num_virtual >= 2"),
], ids=["unknown", "zbv-virtual", "dualpipev-virtual", "1f1b-virtual", "interleaved-virtual"])
def test_the_errors_are_the_jax_ones(args, error, match):
    for build in (port.build_schedule_tables, jax_schedules.build_schedule_tables):
        with pytest.raises(error, match=match):
            build(*args)


@pytest.mark.parametrize("case", [("1f1b", 2, 4, 1), ("interleaved_1f1b", 2, 4, 2), ("zbv", 4, 8, 1),
                                  ("dualpipev", 2, 4, 1)], ids=lambda c: c[0])
def test_each_device_runs_its_global_stages_and_the_hops_meet(case):
    schedule, P, M, V = case
    tables = port.build_schedule_tables(schedule, P, M, num_virtual=V)
    layers = 2 * tables.num_stages_global
    seen = sorted((c.stage, c.first, c.count) for d in range(P) for c in stage_chunks(tables, d, layers))
    assert seen == [(g, 2 * g, 2) for g in range(tables.num_stages_global)]
    assert [d for d in range(P) if holds_first(tables, d)] == [0]
    assert [d for d in range(P) if holds_last(tables, d)] == [0 if tables.placement == "v" else P - 1]
    with pytest.raises(ValueError, match="divisible by num_virtual\\*pp"):
        stage_chunks(tables, 0, layers + 1)
    # every activation hop goes to the next global stage's device, every cotangent to the previous one's
    for t in range(tables.num_ticks):
        for kind, src, dst, chunk, m in tick_messages(tables, t):
            g = tables.global_stage(chunk, dst)
            table = tables.f if kind == "act" else tables.b
            c_src, m_src = divmod(int(table[t, src]), M)
            assert m_src == m and tables.global_stage(c_src, src) == g + (-1 if kind == "act" else 1)

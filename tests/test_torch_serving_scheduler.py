"""Port parity for the engine's admission control (modalities_tpu_torch/
serving/engine.py with serving/resilience.py) against the JAX ServingEngine
on the same weights (params_from_jax), tiny GPT2 in f32 on the CPU, ring and
paged caches: weighted DRR admission and slot quotas, burn-aware brownout
shedding and preemption victims, deadline seams 1-3 (finish reasons and the
tokens emitted before the cancellation), the drain, `overload_reason`,
`retry_after_s` and `tenant_reject_reason`, and stats() and the metric
families.

Every engine runs on a clock of its own that steps on each read (`time_fn`)
or jumps on an engine event, never on the wall clock; eod is off, so a
request's length is its budget unless admission control cuts it. Greedy
tokens, the order requests get their first token (`on_token`), finish
reasons and every shared counter are compared exactly."""

import pytest

from modalities_tpu.serving.engine import ServingEngine as JaxServingEngine
from modalities_tpu.serving.resilience import BrownoutController as JaxBrownout
from modalities_tpu.serving.resilience import TenantRegistry as JaxTenants
from modalities_tpu.telemetry.metrics import MetricsRegistry as JaxMetrics
from modalities_tpu_torch.serving.engine import ServingEngine
from modalities_tpu_torch.serving.resilience import BrownoutController, TenantRegistry
from modalities_tpu_torch.telemetry.metrics import MetricsRegistry
from tests.test_torch_gpt2 import jax_and_port

PAGED = dict(kv_cache="paged", paged_block_size=4, paged_max_len=24)
CACHES = [pytest.param({"kv_cache": "ring"}, id="ring"), pytest.param(PAGED, id="paged")]
TENANT_STATS = ("submitted", "finished", "tokens", "shed", "preemptions", "rate_limited", "tenant_class", "weight",
                "max_slots", "active_slots", "queued")
SHARED_STATS = ("decode_steps", "decode_tokens", "max_concurrent", "preemptions", "truncated_requests",
                "request_errors", "deadline_expired_requests", "shed_requests", "weights_generation", "weight_swaps",
                "queue_depth", "active_slots", "free_blocks", "num_blocks", "prefix_hit_requests", "cow_copies")


@pytest.fixture(scope="module")
def pair():
    return jax_and_port("float32")


def tick_clock(dt: float = 0.01):
    state = {"t": 0.0}

    def clock():
        state["t"] += dt
        return state["t"]

    return clock


def build(pair, *, tenants=None, queue_high=None, budgets=None, clock=tick_clock, **kw):
    """(jax engine, port engine) with the same knobs, each with its own clock
    (`clock()` makes one) and its own first-token log at `engine.firsts`."""
    jm, jparams, pm, pparams = pair
    kw.setdefault("eod_token_id", -1)
    out = []
    for side in ("jax", "port"):
        firsts = []

        def on_token(rid, tok, firsts=firsts, seen=set()):
            if rid not in seen:
                seen.add(rid)
                firsts.append(rid)

        budget_fn = (lambda t: budgets[t]) if budgets is not None else None
        if side == "jax":
            engine = JaxServingEngine(
                jm, jparams, metrics=JaxMetrics(), time_fn=clock(), on_token=on_token, tenant_budget_fn=budget_fn,
                tenants=JaxTenants.from_config(tenants) if tenants else None,
                brownout=JaxBrownout(queue_high=queue_high) if queue_high else None, **kw)
        else:
            engine = ServingEngine(
                pm, pparams, device="cpu", time_fn=clock(), on_token=on_token, tenant_budget_fn=budget_fn,
                tenants=TenantRegistry.from_config(tenants) if tenants else None,
                brownout=BrownoutController(queue_high=queue_high) if queue_high else None, **kw)
        engine.firsts = firsts
        out.append(engine)
    return tuple(out)


def serve_both(engines, reqs):
    """Submit `reqs` [(prompt, budget, kwargs)] to both engines and run them:
    [(jax results, port results)] in submission order."""
    got = []
    for engine in engines:
        rids = [engine.submit(p, b, temperature=0.0, seed=i, **kw) for i, (p, b, kw) in enumerate(reqs)]
        results = engine.run()
        got.append([results.get(r) for r in rids])
    return got


def assert_same(engines, reqs):
    """Both engines over `reqs`: finish reasons, tokens, first-token order,
    the shared counters and the per-tenant rows equal. Returns the port's
    results."""
    jax_engine, port = engines
    want, got = serve_both(engines, reqs)
    assert [r.finish_reason for r in got] == [r.finish_reason for r in want]
    assert [r.tokens for r in got] == [r.tokens for r in want]
    assert port.firsts == jax_engine.firsts
    jstats, pstats = jax_engine.stats(), port.stats()
    assert {k: pstats[k] for k in SHARED_STATS if k in jstats} == {k: jstats[k] for k in SHARED_STATS if k in jstats}
    if "tenants" in jstats:
        assert {t: {k: row[k] for k in TENANT_STATS} for t, row in pstats["tenants"].items()} == {
            t: {k: row[k] for k in TENANT_STATS} for t, row in jstats["tenants"].items()}
    if port.kv_cache == "paged":
        assert pstats["free_blocks"] == pstats["num_blocks"]
        port._table_state.check()
    assert all(s is None for s in port._slot_states)
    return got


def counters(registry) -> dict:
    """Every counter series of a registry, parsed from its exposition."""
    from modalities_tpu_torch.telemetry.metrics import parse_prometheus_text

    parsed = parse_prometheus_text(registry.render())
    return {name: parsed[name] for name in registry.names() if registry.get(name).kind == "counter"}


# ------------------------------------------------------------ DRR and quotas


@pytest.mark.parametrize("cache", CACHES)
@pytest.mark.parametrize("slots", [1, 2])
def test_drr_admission_order_equals_jax(pair, cache, slots):
    """Gold (weight 3) and bronze (weight 1) each queue 6 requests: the same
    admission order on both engines, converging to 3:1 (the JAX oracle's
    test_drr_admission_converges_to_weight_ratio), FIFO within a tenant."""
    engines = build(pair, tenants={"gold": {"weight": 3}, "bronze": {"weight": 1}}, max_batch_slots=slots, **cache)
    reqs = []
    for i in range(6):
        reqs += [([3, 4 + i], 2, {"tenant": "gold"}), ([5, 6 + i], 2, {"tenant": "bronze"})]
    assert_same(engines, reqs)
    port = engines[1]
    tenant_of = ["gold", "bronze"] * 6
    first8 = [tenant_of[r] for r in port.firsts[:8]]
    assert first8.count("gold") == 6 and first8.count("bronze") == 2
    for tenant in ("gold", "bronze"):
        mine = [r for r in port.firsts if tenant_of[r] == tenant]
        assert mine == sorted(mine)


@pytest.mark.parametrize("cache", CACHES)
def test_slot_quota_and_priority_classes_equal_jax(pair, cache):
    """`capped` may hold one slot of three at a time; a priority-1 request
    waits for the priority-0 class; an unarrived head does not block the
    others (tenants off it would)."""
    holders = []

    def decode_clock():  # time = 0.1 s a decode step: the late arrival lands after the second step on both sides
        holder = {}
        holders.append(holder)
        return lambda: 0.1 * holder["engine"]._m_decode_steps.value()

    engines = build(pair, tenants={"capped": {"max_slots": 1}, "free": {"weight": 2}}, max_batch_slots=3,
                    clock=decode_clock, **cache)
    for holder, engine in zip(holders, engines):
        holder["engine"] = engine
    held = []
    for engine in engines:
        engine._on_token = (lambda eng, prior: lambda rid, tok: (
            held.append(eng._tenant_slot_counts().get("capped", 0)), prior(rid, tok)))(engine, engine._on_token)
    reqs = [([3, 9], 3, {"tenant": "capped"}), ([4, 9], 3, {"tenant": "capped"}), ([5, 9], 2, {"tenant": "free"}),
            ([6, 9], 4, {"tenant": "capped", "priority": 1}), ([7, 9], 2, {"tenant": "free", "priority": 1}),
            ([8, 9], 3, {"tenant": "free", "arrival_offset_s": 0.15}), ([9, 9], 2, {"tenant": "capped"})]
    assert_same(engines, reqs)
    assert max(held) == 1


# ------------------------------------------------------- shedding and victims


@pytest.mark.parametrize("cache", CACHES)
@pytest.mark.parametrize("tenants", [False, True], ids=["tenant-off", "burn-aware"])
def test_brownout_sheds_the_same_requests_as_jax(pair, cache, tenants):
    """A queue-pressure brownout (high 4, low 2) over one slot and 9 queued
    requests of mixed priority: the same requests shed ("shed", no tokens),
    the same served. Tenant-off sheds the youngest of the lowest-priority
    class; burn-aware sheds bulk before interactive, the least-burned budget
    first."""
    spec = {"inter": {"class": "interactive"}, "bulk": {"class": "bulk"}, "bulk2": {"class": "bulk"}}
    engines = build(pair, queue_high=4, max_batch_slots=1, tenants=spec if tenants else None,
                    budgets={"inter": 0.1, "bulk": 0.3, "bulk2": 0.9}, **cache)
    names = ["inter", "bulk", "bulk2"]
    reqs = [([3 + i, 7], 2, {"priority": i % 3, "tenant": names[i % 3] if tenants else ""}) for i in range(9)]
    got = assert_same(engines, reqs)
    shed = [i for i, r in enumerate(got) if r.finish_reason == "shed"]
    assert shed and all(got[i].tokens == [] for i in shed)
    port = engines[1]
    assert port.stats()["shed_requests"] == len(shed)
    if tenants:  # the bulk tenants go first: every one of their queued requests before any interactive one
        inter = [i for i in shed if names[i % 3] == "inter"]
        assert len(shed) > len(inter) and (not inter or all(got[i].finish_reason == "shed" or got[i].tokens
                                                              for i in range(9) if names[i % 3] != "inter"))


def test_preemption_victims_are_burn_aware_as_in_jax(pair):
    """A pool of 8 blocks (a table is 6) under three long requests of two
    tenants: the same victims on both engines (an over-fair-share tenant
    first, then bulk before interactive, the youngest within a key), every
    request finished with the JAX engine's tokens."""
    spec = {"inter": {"class": "interactive", "max_slots": 2}, "bulk": {"class": "bulk"}}
    engines = build(pair, tenants=spec, budgets={"inter": 0.5, "bulk": 0.5}, max_batch_slots=3,
                    paged_num_blocks=8, **PAGED)
    reqs = [([3, 4, 5, 6, 7], 14, {"tenant": "inter"}), ([8, 9, 10], 16, {"tenant": "bulk"}),
            ([11, 12, 13, 14], 15, {"tenant": "inter"})]
    assert_same(engines, reqs)
    rows = engines[1].stats()["tenants"]
    assert rows["bulk"]["preemptions"] > 0 and rows["inter"]["preemptions"] > 0  # both orders of the key were met


# ------------------------------------------------------------ deadline seams


@pytest.mark.parametrize("cache", CACHES)
def test_deadline_seam1_expires_in_the_queue(pair, cache):
    engines = build(pair, max_batch_slots=1, **cache)
    got = assert_same(engines, [([3], 6, {}), ([7], 6, {"deadline_ms": 0.5}), ([9, 4], 3, {"deadline_ms": 1e6})])
    assert [r.finish_reason for r in got] == ["budget", "deadline", "budget"] and got[1].tokens == []
    assert engines[1].stats()["deadline_expired_requests"] == 1


def chunk_jump_clock(engines_ref):
    """A clock that jumps 10 s once the engine dispatched a prefill chunk."""
    def make():
        state = {"t": 0.0, "engine": None}
        engines_ref.append(state)

        def clock():
            state["t"] += 0.001
            engine = state["engine"]
            return state["t"] + (10.0 if engine is not None and engine._m_prefill_chunks.value() >= 1 else 0.0)

        return clock
    return make


@pytest.mark.parametrize("cache", [pytest.param(dict(kv_cache="ring", cache_capacity=32, prefill_chunks=(16, 4, 1)),
                                                id="ring-ladder"),
                                   pytest.param(dict(PAGED, max_batch_slots=1), id="paged-packed")])
def test_deadline_seam2_expires_at_a_prefill_chunk_boundary(pair, cache):
    """The clock jumps past the deadline once the first chunk is dispatched:
    the prompt dies mid-prefill on both engines, no token, no later chunk."""
    states = []
    cache = dict(cache)
    slots = cache.pop("max_batch_slots", 1)
    engines = build(pair, clock=chunk_jump_clock(states), max_batch_slots=slots, **cache)
    for state, engine in zip(states, engines):
        state["engine"] = engine
    got = assert_same(engines, [(list(range(1, 22)) if cache["kv_cache"] == "ring" else list(range(1, 11)), 4,
                                 {"deadline_ms": 5000.0})])
    assert got[0].finish_reason == "deadline" and got[0].tokens == []
    assert engines[1]._m_prefill_chunks.value() == engines[0]._m_prefill_chunks.value() == 1


@pytest.mark.parametrize("cache", CACHES)
def test_deadline_seam3_expires_at_a_decode_step_boundary(pair, cache):
    """The clock jumps once two tokens were streamed: the decoder is cancelled
    between steps with the tokens it had, the same ones as the JAX engine's,
    and (paged) its blocks return to the pool."""
    seen = []

    def make():
        state = {"t": 0.0, "n": len(seen)}
        seen.append(0)

        def clock():
            state["t"] += 0.001
            return state["t"] + (10.0 if seen[state["n"]] >= 2 else 0.0)

        return clock

    engines = build(pair, clock=make, max_batch_slots=2, **cache)
    for i, engine in enumerate(engines):
        prior = engine._on_token
        engine._on_token = lambda rid, tok, i=i, prior=prior: (seen.__setitem__(i, seen[i] + 1), prior(rid, tok))
    got = assert_same(engines, [([3, 4, 5], 8, {"deadline_ms": 5000.0}), ([6, 7], 8, {})])
    assert got[0].finish_reason == "deadline" and 1 <= len(got[0].tokens) < 8
    assert got[1].finish_reason == "budget"


@pytest.mark.parametrize("cache", CACHES)
def test_drain_leaves_queued_work_unserved_as_jax(pair, cache):
    """`stop_fn` trips after the third streamed token: in-flight requests
    finish, queued ones are never admitted."""
    streamed = [0, 0]
    engines = []
    for i, engine in enumerate(build(pair, max_batch_slots=2, **cache)):
        prior = engine._on_token
        engine._on_token = lambda rid, tok, i=i, prior=prior: (streamed.__setitem__(i, streamed[i] + 1),
                                                              prior(rid, tok))
        engine._stop_fn = lambda i=i: streamed[i] >= 3
        engines.append(engine)
    want, got = serve_both(engines, [([3, 4], 5, {}), ([5, 6], 5, {}), ([7, 8], 5, {}), ([9, 1], 5, {})])
    assert [r and (r.finish_reason, r.tokens) for r in got] == [r and (r.finish_reason, r.tokens) for r in want]
    assert got[2] is None and got[3] is None and got[0].finish_reason == "budget"


# ------------------------------------------------------ overload and the 429s


def test_overload_reason_and_retry_after_equal_jax(pair):
    """The HTTP layer's questions asked of both engines in the same states
    (the JAX oracles' test_queue_limit_and_note_rejected and
    test_retry_after_derived_from_queue_state)."""
    def both(**kw):
        return build(pair, max_batch_slots=2, **kw)

    for engines, submits, reasons in [
        (both(max_queue_depth=1), 5, ("queue_full", "unknown", "brownout_reject")),
        (both(queue_high=4), 6, ("brownout_reject", "queue_full")),
        (both(max_queue_depth=8), 0, ("queue_full",)),
    ]:
        for engine in engines:
            assert engine.overload_reason() is None
            for i in range(submits):
                engine.submit([3], 1, temperature=0.0, seed=i)
            if engine.brownout is not None:
                engine.brownout.update(len(engine._queue))
        assert engines[1].overload_reason() == engines[0].overload_reason()
        for reason in reasons:
            assert engines[1].retry_after_s(reason) == engines[0].retry_after_s(reason)
    jax_engine, port = both(max_queue_depth=1)
    for engine in (jax_engine, port):
        engine.submit([3], 2, temperature=0.0, seed=0)
        engine.note_rejected("queue_full")
    assert port.overload_reason() == jax_engine.overload_reason() == "queue_full"
    assert port.stats()["shed_requests"] == jax_engine.stats()["shed_requests"] == 1
    assert counters(port.metrics)["serve_shed_total"] == counters(jax_engine.metrics)["serve_shed_total"]


def test_tenant_rate_limit_gate_equals_jax(pair, monkeypatch):
    """The per-tenant token bucket charged at the ingress (the JAX oracle's
    test_rate_limit_gate_charges_bucket_and_derives_retry_after) on both
    engines' stepped clocks, and the tenant resolution at the seam."""
    monkeypatch.setenv("MODALITIES_TPU_SERVE_TENANT_DEFAULT", "team-a")
    clocks = []

    def make():
        clock = {"t": 0.0}
        clocks.append(clock)
        return lambda: clock["t"]

    engines = build(pair, clock=make, tenants={"metered": {"rate": 4.0, "burst": 8.0}})
    answers = [[], []]
    for step in range(8):
        for i, engine in enumerate(engines):
            clocks[i]["t"] = 0.4 * step
            answers[i].append(engine.tenant_reject_reason("metered", 4 if step % 3 else 7))
            answers[i].append(engine.tenant_reject_reason("ghost", 10_000))
            answers[i].append((engine.resolve_submit_tenant(None), engine.resolve_submit_tenant(" x ")))
    assert answers[1] == answers[0]
    assert any(isinstance(a, tuple) and a[0] == "rate_limited" for a in answers[1])
    for engine in engines:
        engine.note_rejected("rate_limited", tenant="metered")
    assert counters(engines[1].metrics) == counters(engines[0].metrics)
    off = build(pair)
    assert [e.tenant_reject_reason("metered", 10_000) for e in off] == [None, None]
    assert [e.resolve_submit_tenant("acme") for e in off] == ["", ""]


# ------------------------------------------------------ stats and the families


@pytest.mark.parametrize("cache", CACHES)
def test_metric_families_and_counters_equal_jax(pair, cache):
    """After a run with tenants, a deadline, shedding and truncation: the
    same metric families (names and kinds, the request-tracing and
    disaggregation families registered and empty) and every counter series
    equal, including the per-tenant and per-reason labels."""
    engines = build(pair, tenants={"a": {"weight": 2}, "b": {"class": "bulk"}}, queue_high=5, max_batch_slots=2,
                    **cache)
    reqs = [(list(range(1, 40)) if i == 0 else [3 + i, 5], 3, {"tenant": "ab"[i % 2]}) for i in range(8)]
    reqs.append(([9, 9], 3, {"tenant": "a", "deadline_ms": 0.5}))
    assert_same(engines, reqs)
    jax_engine, port = engines
    assert [(n, port.metrics.get(n).kind) for n in port.metrics.names()] == [
        (n, jax_engine.metrics.get(n).kind) for n in jax_engine.metrics.names()]
    assert counters(port.metrics) == counters(jax_engine.metrics)
    stats = port.stats()
    assert stats["truncated_requests"] == 1 and stats["shed_requests"] >= 1 and stats["deadline_expired_requests"] == 1
    parsed = counters(port.metrics)
    assert sum(parsed["serve_requests_finished_total"].values()) == len(reqs)
    assert parsed["serve_decode_steps_total"][()] == stats["decode_steps"]


def test_defaults_register_the_families_and_keep_stats_keys(pair):
    """Every knob at its default: the engine's own registry holds the JAX
    families; stats() keeps every PR-15 key and adds the JAX ones."""
    jm, jparams, pm, pparams = pair
    port = ServingEngine(pm, pparams, device="cpu", **PAGED)
    jax_engine = JaxServingEngine(jm, jparams, metrics=JaxMetrics(), **PAGED)
    assert port.metrics.names() == jax_engine.metrics.names() and isinstance(port.metrics, MetricsRegistry)
    stats = port.stats()
    assert {"weights_generation", "weight_swaps", "deadline_expired_requests", "shed_requests"} <= set(stats)
    assert {"forward_calls", "prefill_chunks", "decode_seconds", "weights_bytes"} <= set(stats)
    assert "tenants" not in stats and port.max_queue_depth is None and port.brownout is None

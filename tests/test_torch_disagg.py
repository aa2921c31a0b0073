"""Port parity for disaggregated prefill/decode
(modalities_tpu_torch/serving/disagg/ and the engine's roles) against the
JAX package, on the CPU, in f32 on the tiny GPT2 (weights carried across by
params_from_jax):

- the handoff record's digest and wire form byte-equal to the JAX record's
  for the same fields and bytes, with f32, bf16 (JAX side through ml_dtypes;
  the port carries bf16 as raw 16-bit words) and int8 + f32-scale payloads;
- the port's prefill tier + decode tier give the JAX combined engine's greedy
  tokens (sampled ones: the port's combined engine's, the torch generator's
  state riding the record), one export and one import a request;
- the port's record against the JAX prefill tier's for the same request: the
  same fields, the f32 payload within 1e-5; at int8 KV the scales within
  1e-6 relative and the codes equal or off by one (where the quantizers'
  fp32 x / scale straddle a rounding boundary; counted, at most 1 %);
- a JAX prefill-tier record imported into the port's decode tier continues
  with the JAX combined engine's greedy tokens; a sampled one is refused
  (`sampler_mismatch`: a Threefry key cannot drive a torch generator);
- every import rejection reason and its counter equal to the JAX engine's;
  the pool-full requeue; prefix sharing and speculation over imported blocks;
  deadline seam 4 (the deadline rides the record and restarts from the
  decode tier's arrival), on stepped clocks;
- over HTTP behind both packages' DisaggRouter, with the server's body limit
  patched small in both: an import body over the limit is a dead decode
  worker (peer_down), one replay through a fresh prefill, then "no healthy
  decode workers"; a corrupted export is rejected and replayed, the decode
  worker kept in rotation. The routers' health loops are off (the JAX one
  replaced by a no-op), so nothing races a wall clock."""

import copy
import http.client
import json
import math

import jax
import ml_dtypes
import numpy as np
import pytest
import torch

from modalities_tpu.resilience import events as jax_events
from modalities_tpu.serving import server as jax_server
from modalities_tpu.serving.disagg import handoff as jax_handoff
from modalities_tpu.serving.disagg.router import DisaggRouter as JaxDisaggRouter
from modalities_tpu.serving.engine import ServingEngine as JaxServingEngine
from modalities_tpu.serving.fleet.router import WorkerHandle as JaxWorkerHandle
from modalities_tpu.telemetry.metrics import MetricsRegistry as JaxMetricsRegistry
from modalities_tpu_torch.resilience import events
from modalities_tpu_torch.serving import server
from modalities_tpu_torch.serving.disagg import handoff
from modalities_tpu_torch.serving.disagg.pair import DisaggPair
from modalities_tpu_torch.serving.disagg.router import DisaggRouter
from modalities_tpu_torch.serving.engine import ServingEngine
from modalities_tpu_torch.serving.fleet.router import WorkerHandle
from modalities_tpu_torch.telemetry.metrics import parse_prometheus_text
from tests.test_torch_gpt2 import jax_and_port

# greedy and sampled, short and multi-block (17 tokens span 3 blocks of 8), and
# a budget of 1 that the prefill tier finishes itself (no handoff)
REQS = [([3, 17, 42, 9, 77], 8, 0.0, 0), ([7, 7, 7], 5, 0.8, 1), (list(range(1, 18)), 6, 0.0, 2),
        ([99, 3, 55, 8, 120], 6, 0.8, 3), ([5, 6], 1, 0.0, 4)]
KW = dict(max_batch_slots=2, paged_max_len=64, kv_cache="paged", paged_block_size=8, eod_token_id=-1)
F32_ATOL = 1e-5
INT8_SCALE_RTOL = 1e-6
INT8_OFF_BY_ONE_SHARE = 0.01


@pytest.fixture(scope="module")
def models():
    return jax_and_port("float32")


def jax_engine(models, role="combined", **kw):
    jm, jp, _, _ = models
    return JaxServingEngine(jm, jp, metrics=JaxMetricsRegistry(), role=role, **{**KW, **kw})


def port_engine(models, role="combined", **kw):
    _, _, pm, pp = models
    return ServingEngine(pm, pp, device="cpu", role=role, **{**KW, **kw})


def serve(engine, reqs=REQS):
    rids = [engine.submit(p, b, temperature=t, seed=s) for p, b, t, s in reqs]
    results = engine.run()
    return [results[r] for r in rids]


@pytest.fixture(scope="module")
def jax_combined(models):
    return [r.tokens for r in serve(jax_engine(models))]


@pytest.fixture(scope="module")
def jax_records(models):
    """The JAX prefill tier's records of REQS (None where it finished the request), f32 and int8 KV."""
    return {kv: [r.handoff for r in serve(jax_engine(models, "prefill", quant_kv=kv))] for kv in ("none", "int8")}


@pytest.fixture(scope="module")
def port_pair(models):
    prefill, decode = port_engine(models, "prefill"), port_engine(models, "decode")
    pair = DisaggPair(prefill, decode)
    rids = [pair.submit(p, b, temperature=t, seed=s) for p, b, t, s in REQS]
    results = pair.run()
    assert not pair.handoff_failures
    return prefill, decode, [results[r] for r in rids]


# ------------------------------------------------------------ the record
def _fields(key):
    return dict(version=1, generation=3, quant_kv="none", block_size=8, window=[5, 6, 7], last_token=11, key=key,
                temperature=0.0, remaining=4, seed=9, trace_id="t1", trace_hop=2, rid=4, prompt_len=3, truncated=False,
                deadline_ms=250.0, tenant="acme")


@pytest.mark.parametrize("kind", ["f32", "bf16", "int8"])
def test_record_digest_and_wire_equal_jax(kind):
    rng = np.random.default_rng(0)
    shape = (2, 2, 8, 2, 4)
    if kind == "int8":
        arrays = [rng.integers(-127, 128, size=shape, dtype=np.int8), rng.random(shape[:-1] + (1,), np.float32)] * 2
        fields = dict(_fields(np.array([0, 9], np.uint32)), quant_kv="int8")
    else:
        data = rng.standard_normal(shape, np.float32)
        arrays = [data.astype(ml_dtypes.bfloat16) if kind == "bf16" else data] * 2
        fields = _fields(np.array([0, 9], np.uint32))
    as_torch = [torch.from_numpy(a.view(np.uint16).copy()).view(torch.bfloat16) if a.dtype == ml_dtypes.bfloat16
                else torch.from_numpy(a.copy()) for a in arrays]
    theirs = jax_handoff.HandoffRecord(payload=arrays, **fields).seal()
    ours = handoff.HandoffRecord(payload=as_torch, **fields).seal()
    assert ours.digest == theirs.digest and ours.kv_bytes == theirs.kv_bytes
    assert json.dumps(ours.to_wire()) == json.dumps(theirs.to_wire())
    handoff.HandoffRecord.from_wire(theirs.to_wire()).verify_digest()
    jax_handoff.HandoffRecord.from_wire(ours.to_wire()).verify_digest()
    with pytest.raises(handoff.HandoffRejected) as exc:
        handoff.HandoffRecord.from_wire({k: v for k, v in ours.to_wire().items() if k != "window"})
    assert exc.value.reason == "malformed"


# ------------------------------------------------------- the tiers in process
def test_tiers_give_the_jax_combined_engines_greedy_tokens(models, port_pair, jax_combined):
    prefill, decode, results = port_pair
    port_combined = [r.tokens for r in serve(port_engine(models))]
    for (prompt, budget, temp, _), got, want, ours in zip(REQS, results, jax_combined, port_combined):
        assert got.tokens == ours and len(got.tokens) == budget and got.finish_reason == "budget"
        if not temp:
            assert got.tokens == want
    assert results[-1].decode is None  # budget 1: the prefill tier's answer
    ps, ds = prefill.stats(), decode.stats()
    assert (ps["role"], ds["role"]) == ("prefill", "decode")
    assert (ps["handoffs_exported"], ds["handoffs_imported"], ps["handoff_executables"], ds["import_executables"]) \
        == (4, 4, 1, 1)
    assert (ps["decode_executables"], ps["prefill_executables"], ds["prefill_executables"],
            ds["decode_executables"]) == (0, 1, 0, 1)
    shipped = parse_prometheus_text(prefill.metrics.render())
    assert shipped["disagg_handoffs_total"][()] == 4.0
    assert shipped["disagg_kv_bytes_shipped_total"][()] == ps["handoff_bytes_shipped"]
    assert parse_prometheus_text(decode.metrics.render())["disagg_handoff_seconds_count"][()] == 4.0
    for engine in (prefill, decode):
        s = engine.stats()
        assert s["free_blocks"] == s["num_blocks"]
        engine._table_state.check()


def test_the_ports_record_equals_the_jax_prefill_tiers(port_pair, jax_records):
    _, _, results = port_pair
    for (prompt, budget, temp, seed), res, theirs in zip(REQS, results, jax_records["none"]):
        ours = res.prefill.handoff
        if theirs is None:
            assert ours is None and res.finish_reason == "budget"
            continue
        names = ["version", "generation", "quant_kv", "block_size", "window", "temperature", "remaining", "seed",
                 "prompt_len", "truncated"] + ([] if temp else ["last_token"])  # a sampled first token is a draw
        for name in names:
            assert getattr(ours, name) == getattr(theirs, name), name
        assert len(ours.payload) == len(theirs.payload) == 2
        for a, b in zip(ours.payload, theirs.payload):
            assert handoff.dtype_name(a) == str(b.dtype) and tuple(a.shape) == b.shape
            np.testing.assert_allclose(a.numpy(), b, atol=F32_ATOL, rtol=0)
        if temp:  # the torch generator's state after the first draw: MT19937's 1264 words on the CPU
            assert len(ours.key) == 1264
        else:  # a greedy request's key is JAX's unsplit PRNGKey(seed)
            assert np.array_equal(ours.key, theirs.key)


def test_int8_payload_codes_equal_jax_off_by_one_counted(models, jax_records):
    ours = [r.handoff for r in serve(port_engine(models, "prefill", quant_kv="int8"))]
    off_by_one = codes = 0
    for a, b in zip(ours, jax_records["int8"]):
        if b is None:
            continue
        assert [handoff.dtype_name(t) for t in a.payload] == [str(x.dtype) for x in b.payload] == \
            ["int8", "float32", "int8", "float32"]
        for t, x in zip(a.payload, b.payload):
            if x.dtype == np.int8:
                diff = np.abs(t.numpy().astype(np.int32) - x.astype(np.int32))
                assert diff.max() <= 1
                off_by_one += int((diff == 1).sum())
                codes += diff.size
            else:
                np.testing.assert_allclose(t.numpy(), x, rtol=INT8_SCALE_RTOL, atol=0)
        assert a.kv_bytes == b.kv_bytes
    print(f"int8 handoff codes off by one against JAX: {off_by_one} of {codes}")
    assert off_by_one <= INT8_OFF_BY_ONE_SHARE * codes


def test_a_jax_record_imports_into_the_port_decode_tier(models, jax_records, jax_combined):
    decode = port_engine(models, "decode")
    rids = {}
    for i, rec in enumerate(jax_records["none"]):
        if rec is None:
            continue
        record = handoff.HandoffRecord.from_wire(rec.to_wire())
        if rec.temperature > 0:
            with pytest.raises(handoff.HandoffRejected) as exc:
                decode.import_handoff(record)
            assert exc.value.reason == "sampler_mismatch"
            continue
        rids[i] = decode.import_handoff(record)
    results = decode.run()
    assert sorted(rids) == [0, 2]
    for i, rid in rids.items():
        assert [jax_records["none"][i].last_token] + results[rid].tokens == jax_combined[i]
    assert decode._m_handoff_failures.value(reason="sampler_mismatch") == 2


# ---------------------------------------------------------- rejections
def _mutations(record, module):
    """(what, the mutated record, its expected reason) for every import check."""
    out = []
    tampered = copy.deepcopy(record)
    tampered.last_token = int(tampered.last_token) + 1  # not resealed
    out.append(("digest", tampered, "digest_mismatch"))
    for what, field, value, reason in (("generation", "generation", record.generation + 1, "generation_mismatch"),
                                       ("version", "version", module.HANDOFF_VERSION + 1, "version_mismatch"),
                                       ("quant_kv", "quant_kv", "int8", "config_mismatch"),
                                       ("block_size", "block_size", 16, "config_mismatch"),
                                       ("window", "window", list(range(1, 65)), "config_mismatch")):
        mutated = copy.deepcopy(record)
        setattr(mutated, field, value)
        out.append((what, mutated.seal(), reason))
    return out


def test_rejection_reasons_and_counters_equal_jax(models, port_pair, jax_records):
    _, _, results = port_pair
    ours, theirs = results[0].prefill.handoff, jax_records["none"][0]
    outcomes = []
    for engine, record, module, ev in ((port_engine(models, "decode"), ours, handoff, events),
                                       (jax_engine(models, "decode"), theirs, jax_handoff, jax_events)):
        free0 = engine._table_state.pool.free_count
        got = []
        for what, mutated, reason in _mutations(record, module):
            before = ev.snapshot_counts()
            with pytest.raises(module.HandoffRejected) as exc:
                engine.import_handoff(mutated)
            got.append((what, exc.value.reason, ev.counts_since(before).get("fleet", 0)))
            assert exc.value.reason == reason, what
        fails = engine._m_handoff_failures
        got.append(tuple(fails.value(reason=r) for r in ("digest_mismatch", "generation_mismatch",
                                                         "version_mismatch", "config_mismatch")))
        assert engine._table_state.pool.free_count == free0 and not engine._queue
        outcomes.append(got)
    assert outcomes[0] == outcomes[1]
    assert outcomes[0][1] == ("generation", "generation_mismatch", 1)  # a fleet/rollback stage=generation event
    assert outcomes[0][-1] == (1, 1, 1, 3)


def test_roles_are_checked_as_jax(models, port_pair):
    _, _, results = port_pair
    with pytest.raises(ValueError, match="role='decode'"):
        port_engine(models).import_handoff(results[0].prefill.handoff)
    with pytest.raises(ValueError, match="import_handoff"):
        port_engine(models, "decode").submit([1, 2], 3)
    with pytest.raises(ValueError, match="requires kv_cache='paged'"):
        port_engine(models, "prefill", kv_cache="ring")
    with pytest.raises(ValueError, match="excludes spec_decode"):
        port_engine(models, "prefill", spec_decode={"k": 2})
    with pytest.raises(ValueError, match="must be 'combined'"):
        port_engine(models, "both")


def test_pool_full_requeues_import_as_jax(models, port_pair, jax_records):
    """A decode pool too small for two concurrent imports: the second waits
    queued (one pool_full count) while the first decodes on intact blocks,
    then both finish with the same tokens; every block returns."""
    _, _, results = port_pair
    got = []
    for engine, record in ((port_engine(models, "decode", paged_max_len=40, paged_num_blocks=5, prefix_sharing=False),
                            results[2].prefill.handoff),
                           (jax_engine(models, "decode", paged_max_len=40, paged_num_blocks=5, prefix_sharing=False),
                            jax_records["none"][2])):
        r1, r2 = engine.import_handoff(copy.deepcopy(record)), engine.import_handoff(copy.deepcopy(record))
        out = engine.run()
        s = engine.stats()
        assert s["free_blocks"] == s["num_blocks"]
        engine._table_state.check()
        got.append((out[r1].tokens, out[r2].tokens, out[r1].finish_reason, s["import_requeues"],
                    engine._m_handoff_failures.value(reason="pool_full"), s["handoffs_imported"]))
    assert got[0] == got[1] and got[0][0] == got[0][1] and got[0][3:] == (1, 1.0, 2)


def test_prefix_sharing_and_speculation_on_imported_blocks_as_jax(models):
    """Two imports of one window in flight together: the second forks the
    window's full blocks from the prefix index (fewer scattered), and the
    n-gram drafter proposes over imported KV; tokens equal JAX's."""
    prompt, budget = [5, 6] * 8, 8
    got = []
    for make in (port_engine, jax_engine):
        record = serve(make(models, "prefill"), [(prompt, budget, 0.0, 9)])[0].handoff
        engine = make(models, "decode", spec_decode={"k": 2})
        r1, r2 = engine.import_handoff(copy.deepcopy(record)), engine.import_handoff(copy.deepcopy(record))
        out = engine.run()
        s = engine.stats()
        assert s["spec_proposed"] > 0 and s["free_blocks"] == s["num_blocks"]
        got.append(([record.last_token] + out[r1].tokens, out[r2].tokens, s["prefix_hit_requests"],
                     s["prefix_hit_blocks"], s["imported_blocks"], s["spec_proposed"], s["spec_accepted"]))
    assert got[0] == got[1]
    assert got[0][0][1:] == got[0][1] and got[0][2:5] == (1, 2, 2)


# --------------------------------------------------------------- over HTTP
def _tier_servers(package, models):
    mod, make = (server, port_engine) if package == "port" else (jax_server, jax_engine)
    out = []
    for role in ("prefill", "decode"):
        s = mod.ServingHTTPServer(make(models, role), encode=lambda t: [int(x) for x in t.split()],
                                  decode=lambda ids: " ".join(map(str, ids)), port=0)
        s.start()
        out.append(s)
    return out


def _disagg_router(package, servers):
    if package == "port":
        return DisaggRouter([WorkerHandle("p0", "127.0.0.1", servers[0].port)],
                            [WorkerHandle("d0", "127.0.0.1", servers[1].port)], health_loop=False).start()
    r = JaxDisaggRouter([JaxWorkerHandle("p0", "127.0.0.1", servers[0].port)],
                        [JaxWorkerHandle("d0", "127.0.0.1", servers[1].port)], metrics=JaxMetricsRegistry())

    async def no_loop():
        return None

    r._health_loop = no_loop
    return r.start()


def _post(port, prompt):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=120)
    try:
        conn.request("POST", "/generate", body=json.dumps({"prompt": prompt, "max_new_tokens": 4}))
        resp = conn.getresponse()
        raw = resp.read()
        return resp.status, [json.loads(c[6:]) for c in raw.split(b"\n\n") if c.startswith(b"data: ")]
    finally:
        conn.close()


@pytest.fixture(scope="module", params=["port", "jax"])
def tiers(request, models):
    servers = _tier_servers(request.param, models)
    yield request.param, servers
    for s in servers:
        s.close()


def _http_outcome(package, servers, prompts, corrupt=False):
    """POST `prompts` in turn through a fresh DisaggRouter over `servers`: the
    client's events, and the router's failovers, handoff failures, retry
    tokens and decode worker's health; with `corrupt`, the prefill engine's
    first export has one payload byte flipped after its seal."""
    engine = servers[0].engine
    export = engine._export_handoff
    flipped = []

    def corrupt_once(*args, **kwargs):
        record = export(*args, **kwargs)
        if not flipped:
            leaf = record.payload[0]
            if isinstance(leaf, torch.Tensor):
                leaf.view(-1)[0] += 1.0
            else:
                leaf.reshape(-1)[0] += 1.0
            flipped.append(True)
        return record

    if corrupt:
        engine._export_handoff = corrupt_once
    r = _disagg_router(package, servers)
    try:
        evs = [_post(r.port, p) for p in prompts]
        table = r.fleet_table() if package == "port" else r._fleet_table()
        fails = parse_prometheus_text(r.metrics.render()).get("disagg_handoff_failures_total", {})
        return (evs, table["failovers"], {dict(k).get("reason"): v for k, v in fails.items() if v},
                round(table["retry_budget_tokens"], 9), [w["healthy"] for w in table["workers"]])
    finally:
        r.close()
        if corrupt:
            engine._export_handoff = export


def test_an_import_over_the_body_limit_is_a_dead_decode_worker_as_jax(tiers, monkeypatch):
    """The decode worker's server closes the connection on an import body over
    its limit: the router counts the worker dead (peer_down, a failover),
    replays through a fresh prefill, finds no decode worker left, and ends
    the client's stream with an error after token #1. A body under the
    limit goes through."""
    package, servers = tiers
    block = 2 * 2 * 8 * 2 * 32 * 4  # K and V, 2 layers x 8 positions x 2 kv heads x 32 x f32
    limit = math.ceil(4 * block / 3) + 4096  # a one-block import body fits, a three-block one does not
    monkeypatch.setattr(server if package == "port" else jax_server, "_MAX_BODY_BYTES", limit)
    exported0 = servers[0].engine.stats()["handoffs_exported"]
    evs, failovers, fails, tokens, healthy = _http_outcome(package, servers, ["3 17 42 9 77",
                                                                              " ".join(map(str, range(1, 18)))])
    (s1, small), (s2, big) = evs
    assert s1 == s2 == 200 and small[-1]["done"] and len(small[-1]["token_ids"]) == 4
    assert [e.get("token_id", e.get("error")) for e in big] == [big[0]["token_id"], "no healthy decode workers"]
    assert (failovers, fails, tokens, healthy) == (1, {"peer_down": 1.0}, 9.2, [True, False])
    assert servers[0].engine.stats()["handoffs_exported"] - exported0 == 3  # the small one, the big one, its replay
    assert servers[1].engine.stats()["handoffs_imported"] >= 1


def test_a_rejected_import_replays_and_keeps_the_decode_worker_as_jax(tiers):
    package, servers = tiers
    evs, failovers, fails, _, healthy = _http_outcome(package, servers, ["3 17 42 9 77"], corrupt=True)
    (status, events_), = evs
    done = events_[-1]
    assert status == 200 and done["done"] and [e["token_id"] for e in events_ if "token_id" in e] == done["token_ids"]
    assert len(done["token_ids"]) == 4
    assert (failovers, fails, healthy) == (0, {"digest_mismatch": 1.0}, [True, True])


def test_tier_endpoints_answer_409_on_the_wrong_tier(models):
    servers = _tier_servers("port", models)
    combined = server.ServingHTTPServer(port_engine(models), encode=lambda t: [int(x) for x in t.split()],
                                        decode=lambda ids: " ".join(map(str, ids)), port=0)
    combined.start()
    try:
        for srv, path in ((combined, "/disagg/prefill"), (combined, "/disagg/import"), (servers[0], "/generate"),
                          (servers[0], "/disagg/import"), (servers[1], "/disagg/prefill"),
                          (servers[1], "/generate")):
            conn = http.client.HTTPConnection("127.0.0.1", srv.port, timeout=30)
            conn.request("POST", path, body=json.dumps({"prompt": "1 2", "record": {}}))
            resp = conn.getresponse()
            assert resp.status == 409, (srv.engine.role, path)
            resp.read()
            conn.close()
    finally:
        for srv in (combined, *servers):
            srv.close()


def _tick_clock(step: float):
    t = {"now": 0.0}

    def now():
        t["now"] += step
        return t["now"]

    return now


@pytest.mark.parametrize("deadline_ms,finish", [(40.0, "deadline"), (60000.0, "budget")])
def test_deadline_seam_4_rides_the_record_as_jax(models, deadline_ms, finish):
    """The deadline rides the record outside its digest and restarts from the
    decode tier's own arrival: on a clock of 50 ms a read, a 40 ms deadline
    lapses in the queue (cancelled before any block is allocated), a 60 s one
    does not; the JAX tiers give the same outcome on the same clocks."""
    got = []
    for make, module in ((port_engine, handoff), (jax_engine, jax_handoff)):
        prefill = make(models, "prefill", time_fn=_tick_clock(1e-6))
        rid = prefill.submit([3, 4, 5], 5, temperature=0.0, seed=0, deadline_ms=deadline_ms)
        record = module.HandoffRecord.from_wire(prefill.run()[rid].handoff.to_wire())
        record.verify_digest()
        decode = make(models, "decode", time_fn=_tick_clock(0.05))
        drid = decode.import_handoff(record)
        res = decode.run()[drid]
        s = decode.stats()
        assert s["free_blocks"] == s["num_blocks"]
        got.append((record.deadline_ms, res.finish_reason, len(res.tokens), s["deadline_expired_requests"],
                    s["handoffs_imported"]))
    assert got[0] == got[1]
    assert got[0][:2] == (deadline_ms, finish) and got[0][4] == (0 if finish == "deadline" else 1)

"""The port's streaming HTTP front end (modalities_tpu_torch/serving/
server.py) in process on an ephemeral loopback port, over the paged engine on
the tiny GPT2 in f32 (weights from the JAX model through params_from_jax),
one module-scoped server for the whole file, as the JAX package's
tests/serving/test_http_server.py keeps one:

- SSE: the streamed token ids equal the done event's, the port engine's on
  the same requests in process, and the JAX engine's for greedy requests;
  /healthz, /stats and /metrics answer, and /metrics' counters equal stats();
- 429 with a derived Retry-After for a full queue, a brownout and a tenant
  over its token rate, each as its JAX oracle in
  tests/resilience/test_serving_resilience.py answers, with the reason and
  Retry-After equal to the JAX engine's in the same state;
- /admin/swap answers 503 (no handler wired), /disagg/* 409 (a combined
  engine), a bad body 400, an unknown path 404;
- /stats and /metrics scraped while the engine decodes answer with one
  published snapshot, and the engine keeps no result the server delivered;
- the drain: 503 while draining, serve_forever's final stats, the listener
  closed.

The engine's clock is a value the test sets (`time_fn`), so the token bucket
refills only when the test says; the test holds the engine between steps
(its `step` answers "nothing done" while the gate is shut) to build a queue
in a known state. Every wait is bounded at 60 s."""

import http.client
import json
import math
import threading
import time

import pytest

from modalities_tpu.serving.engine import ServingEngine as JaxServingEngine
from modalities_tpu.serving.resilience import BrownoutController as JaxBrownout
from modalities_tpu.serving.resilience import TenantRegistry as JaxTenants
from modalities_tpu.telemetry.metrics import MetricsRegistry as JaxMetrics
from modalities_tpu_torch.serving.engine import ServingEngine
from modalities_tpu_torch.serving.resilience import BrownoutController, TenantRegistry
from modalities_tpu_torch.serving.server import ServingHTTPServer
from modalities_tpu_torch.telemetry.metrics import parse_prometheus_text
from tests.test_torch_gpt2 import jax_and_port

KNOBS = dict(max_batch_slots=2, kv_cache="paged", paged_block_size=4, eod_token_id=-1)
TENANTS = {"metered": {"rate": 0.5, "burst": 4.0}}
REQS = [{"prompt": "3 17 42 9", "max_new_tokens": 6, "temperature": 0.0, "seed": 0},
        {"prompt": "7 7 7", "max_new_tokens": 5, "temperature": 0.8, "seed": 1},
        {"prompt": "99 3 55 8 120 4", "max_new_tokens": 7, "temperature": 0.0, "seed": 2}]


def encode(s):
    return [int(t) for t in s.split()]


def decode(ids):
    return " ".join(str(i) for i in ids)


def request(port, method, path, body=None, headers=None):
    """(status, SSE events or the JSON body or the text, response headers)."""
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=60.0)
    try:
        conn.request(method, path, body=json.dumps(body) if body is not None else None,
                     headers={"Content-Type": "application/json", **(headers or {})})
        resp = conn.getresponse()
        raw, resp_headers = resp.read(), dict(resp.getheaders())
        ctype = resp_headers.get("Content-Type", "")
        if ctype.startswith("text/event-stream"):
            events = [json.loads(c[len(b"data: "):]) for c in raw.split(b"\n\n") if c.startswith(b"data: ")]
            return resp.status, events, resp_headers
        if ctype.startswith("application/json"):
            return resp.status, json.loads(raw), resp_headers
        return resp.status, raw.decode(), resp_headers
    finally:
        conn.close()


def wait_for(predicate, what: str):
    deadline = time.monotonic() + 60.0
    while not predicate():
        if time.monotonic() > deadline:
            pytest.fail(f"timed out waiting for {what}")
        time.sleep(0.002)


@pytest.fixture(scope="module")
def pair():
    return jax_and_port("float32")


@pytest.fixture(scope="module")
def served(pair):
    """(server, engine, gate, clock): the engine's `step` does nothing while
    `gate` is clear; `clock["t"]` is the engine's time."""
    _, _, pm, pparams = pair
    clock = {"t": 0.0}
    engine = ServingEngine(pm, pparams, device="cpu", tenants=TenantRegistry.from_config(TENANTS),
                           time_fn=lambda: clock["t"], **KNOBS)
    gate = threading.Event()
    gate.set()
    step = engine.step
    engine.step = lambda t0: step(t0) if gate.is_set() else False
    server = ServingHTTPServer(engine, encode=encode, decode=decode, port=0)
    server.start()
    yield server, engine, gate, clock
    server.close()


def post_in_thread(port, body, out: list, headers=None):
    thread = threading.Thread(target=lambda: out.append(request(port, "POST", "/generate", body, headers)))
    thread.start()
    return thread


def queue_up(served, bodies):
    """With the gate shut, POST `bodies` one at a time, each queued in the
    engine before the next is sent (a known order); returns the threads and
    their outcome lists."""
    server, engine, gate, _ = served
    assert not gate.is_set()
    posted = []
    for body in bodies:
        out: list = []
        depth = len(engine._queue)
        posted.append((post_in_thread(server.port, body, out), out))
        wait_for(lambda: len(engine._queue) == depth + 1, "the request to queue")
    return posted


def test_sse_tokens_equal_the_engines_and_jax(pair, served):
    server, engine, _, _ = served
    assert server.port > 0
    status, health, _ = request(server.port, "GET", "/healthz")
    assert (status, health) == (200, {"status": "ok", "weights_generation": 0})
    outs = [[] for _ in REQS]
    threads = [post_in_thread(server.port, body, out) for body, out in zip(REQS, outs)]
    for thread in threads:
        thread.join(60.0)
    streamed = []
    for (status, events, headers), req in zip([o[0] for o in outs], REQS):
        assert status == 200 and headers["Content-Type"].startswith("text/event-stream")
        done = [e for e in events if e.get("done")]
        assert len(done) == 1 and done[0]["finish_reason"] == "budget"
        tokens = [e["token_id"] for e in events if "token_id" in e]
        assert tokens == done[0]["token_ids"] and len(tokens) == req["max_new_tokens"]
        assert done[0]["completion"] == decode(tokens) and done[0]["prompt_len"] == len(encode(req["prompt"]))
        assert done[0]["weights_generation"] == 0 and done[0]["truncated"] is False
        streamed.append(tokens)
    # the HTTP seam is invisible in the tokens: the port engine in process, and JAX's greedy tokens
    jm, jparams, pm, pparams = pair
    for other in (ServingEngine(pm, pparams, device="cpu", **KNOBS),
                  JaxServingEngine(jm, jparams, metrics=JaxMetrics(), **KNOBS)):
        rids = [other.submit(encode(r["prompt"]), r["max_new_tokens"], temperature=r["temperature"], seed=r["seed"])
                for r in REQS]
        results = other.run()
        for rid, req, tokens in zip(rids, REQS, streamed):
            if isinstance(other, ServingEngine) or req["temperature"] == 0.0:
                assert results[rid].tokens == tokens
    status, stats, _ = request(server.port, "GET", "/stats")
    assert status == 200 and stats["http_requests"] == 3 and stats["http_rejected"] == 0
    assert stats["draining"] is False and stats["kv_cache"] == "paged" and stats["decode_executables"] == 1
    status, text, headers = request(server.port, "GET", "/metrics")
    assert status == 200 and headers["Content-Type"].startswith("text/plain; version=0.0.4")
    parsed = parse_prometheus_text(text)
    assert parsed["serve_decode_steps_total"][()] == stats["decode_steps"]
    assert parsed["serve_prefill_chunks_total"][()] == stats["prefill_chunk_count"]
    assert parsed["serve_tokens_generated_total"][()] == sum(len(t) for t in streamed)
    assert parsed["serve_requests_finished_total"] == {(("reason", "budget"),): 3.0}
    assert parsed["serve_http_requests_total"][()] == 3
    assert parsed["serve_paged_free_blocks"][()] == stats["free_blocks"]


def _jax_engine(pair, **kw):
    jm, jparams, _, _ = pair
    return JaxServingEngine(jm, jparams, metrics=JaxMetrics(), **KNOBS, **kw)


def test_queue_full_429_with_derived_retry_after(pair, served):
    """The oracle test_queue_limit_and_note_rejected at the HTTP seam: with
    the queue at its limit, a new POST gets 429 "queue_full" and the
    Retry-After of the JAX engine in the same state; the queued requests are
    served once the engine moves."""
    server, engine, gate, _ = served
    shed0, rejected0 = engine.stats()["shed_requests"], server.http_rejected
    gate.clear()
    engine.max_queue_depth = 2
    try:
        posted = queue_up(served, REQS[:2])
        status, body, headers = request(server.port, "POST", "/generate", REQS[2])
        jax_engine = _jax_engine(pair, max_queue_depth=2)
        for req in REQS[:2]:
            jax_engine.submit(encode(req["prompt"]), req["max_new_tokens"])
        assert (status, body["reason"]) == (429, jax_engine.overload_reason())
        assert headers["Retry-After"] == str(max(1, math.ceil(jax_engine.retry_after_s("queue_full"))))
    finally:
        engine.max_queue_depth = None
        gate.set()
    for thread, out in posted:
        thread.join(60.0)
        assert out[0][0] == 200 and out[0][1][-1]["finish_reason"] == "budget"
    assert engine.stats()["shed_requests"] == shed0 + 1 and server.http_rejected == rejected0 + 1
    assert engine._m_shed.value(reason="queue_full") == 1


def test_brownout_sheds_queued_work_and_429s_new_arrivals(pair, served):
    """The oracle test_http_429_retry_after_under_brownout on the queue
    signal: three requests queue behind a shut gate, the controller trips
    (high 3, low 1); a new POST gets 429 "brownout_reject" with the JAX
    engine's Retry-After; once the engine moves, the same two requests as
    the JAX engine's are shed (finish reason "shed" on their streams, no
    tokens) and the third is served."""
    server, engine, gate, _ = served
    shed0 = engine.stats()["shed_requests"]
    bodies = [dict(r, priority=p) for r, p in zip(REQS, (0, 1, 0))]
    gate.clear()
    engine.brownout = BrownoutController(queue_high=3)
    try:
        posted = queue_up(served, bodies)
        engine.brownout.update(len(engine._queue))  # the sweep the shut gate holds back
        status, body, headers = request(server.port, "POST", "/generate", REQS[0])
        jax_engine = _jax_engine(pair, brownout=JaxBrownout(queue_high=3))
        for req in bodies:
            jax_engine.submit(encode(req["prompt"]), req["max_new_tokens"], temperature=req["temperature"],
                              seed=req["seed"], priority=req["priority"])
        jax_engine.brownout.update(len(jax_engine._queue))
        assert (status, body["reason"]) == (429, jax_engine.overload_reason() or "")
        assert headers["Retry-After"] == str(max(1, math.ceil(jax_engine.retry_after_s("brownout_reject"))))
    finally:
        gate.set()
    finishes = []
    for thread, out in posted:
        thread.join(60.0)
        done = out[0][1][-1]
        finishes.append(done["finish_reason"])
        if done["finish_reason"] == "shed":
            assert done["token_ids"] == []
    jax_results = jax_engine.run()
    assert finishes == [jax_results[rid].finish_reason for rid in sorted(jax_results)]
    assert finishes.count("shed") == 2
    engine.brownout = None
    assert engine.stats()["shed_requests"] == shed0 + 3  # two queue sheds and one 429, as in JAX
    assert engine._m_shed.value(reason="brownout") == 2 and engine._m_shed.value(reason="brownout_reject") == 1


def test_tenant_rate_limit_429_with_the_refill_time(pair, served):
    """The oracle test_http_tenant_rate_limit_429_with_refill_retry_after:
    X-Tenant-Id rides the header seam; the metered tenant's second request
    outruns its bucket (rate 0.5/s, burst 4) and gets 429 "rate_limited"
    with the bucket's refill time, equal to the JAX engine's on the same
    clock; another tenant sails through; the refilled bucket admits again."""
    server, engine, _, clock = served
    jm, jparams, _, _ = pair
    jax_clock = {"t": clock["t"]}
    jax_engine = JaxServingEngine(jm, jparams, metrics=JaxMetrics(), tenants=JaxTenants.from_config(TENANTS),
                                  time_fn=lambda: jax_clock["t"], **KNOBS)
    body = {"prompt": "3", "max_new_tokens": 4}
    assert request(server.port, "POST", "/generate", body, {"X-Tenant-Id": "metered"})[0] == 200
    assert jax_engine.tenant_reject_reason("metered", 4) is None
    status, err, headers = request(server.port, "POST", "/generate", body, {"X-Tenant-Id": "metered"})
    reason, retry_after = jax_engine.tenant_reject_reason("metered", 4)
    assert (status, err["reason"]) == (429, reason) and headers["Retry-After"] == str(math.ceil(retry_after)) == "8"
    assert request(server.port, "POST", "/generate", body, {"X-Tenant-Id": "other"})[0] == 200
    clock["t"] += 8.0
    assert request(server.port, "POST", "/generate", dict(body, tenant="metered"))[0] == 200
    assert engine._m_tenant_rate_limited.value(tenant="metered") == 1
    assert engine.stats()["tenants"]["metered"]["rate_limited"] == 1


def test_admin_swap_disagg_and_bad_requests(served):
    server, _, _, _ = served
    status, body, _ = request(server.port, "POST", "/admin/swap", {"checkpoint_folder": "x"})
    assert status == 503 and body == {"error": "no swap handler wired"}
    for path in ("/disagg/prefill", "/disagg/import"):
        status, body, _ = request(server.port, "POST", path, {"prompt": "1 2"})
        assert status == 409 and "role='combined'" in body["error"]
    assert request(server.port, "POST", "/generate", {"prompt": ""})[0] == 400
    assert request(server.port, "POST", "/generate", {"max_new_tokens": 3})[0] == 400
    assert request(server.port, "GET", "/nowhere")[0] == 404


def test_scrapes_while_decoding_see_one_snapshot_and_no_result_is_kept(served):
    """/stats and /metrics scraped in a loop from two threads while the
    paged engine with tenants admits and decodes 8 requests through 2 slots:
    every scrape answers, and each /stats is one snapshot (its tenants'
    queued and active counts add up to its queue depth and active slots).
    The server takes every result through on_finish, so the engine keeps
    none: a long-running server's memory does not grow with its traffic."""
    server, engine, _, _ = served
    bodies = [{"prompt": "5 6 7 8" if i % 2 else f"{i} 9 {i}", "max_new_tokens": 24, "tenant": f"t{i % 3}"}
              for i in range(8)]
    outs = [[] for _ in bodies]
    threads = [post_in_thread(server.port, body, out) for body, out in zip(bodies, outs)]
    scrapes, failures = [], []

    def scrape(path):
        while any(t.is_alive() for t in threads):
            status, got, _ = request(server.port, "GET", path)
            if status != 200:
                failures.append((path, status, got))
            elif path == "/stats":
                rows = got["tenants"].values()
                if (sum(r["queued"] for r in rows), sum(r["active_slots"] for r in rows)) != (
                        got["queue_depth"], got["active_slots"]):
                    failures.append((path, got))
            else:
                parse_prometheus_text(got)
            scrapes.append(path)

    scrapers = [threading.Thread(target=scrape, args=(path,)) for path in ("/stats", "/metrics")]
    for thread in scrapers:
        thread.start()
    for thread in threads + scrapers:
        thread.join(60.0)
    assert failures == [] and {"/stats", "/metrics"} <= set(scrapes)
    assert [out[0][1][-1]["finish_reason"] for out in outs] == ["budget"] * len(bodies)
    assert engine._results == {} and server._streams == {}


def test_drain_answers_503_then_returns_the_final_stats(served):
    server, engine, _, _ = served
    server.stop()
    status, health, _ = request(server.port, "GET", "/healthz")
    assert (status, health["status"]) == (200, "draining")
    status, err, headers = request(server.port, "POST", "/generate", {"prompt": "1 2"})
    assert status == 503 and "draining" in err["error"] and headers["Retry-After"] == "1"
    final = server.serve_forever()
    assert final["decode_executables"] == 1 and final["free_blocks"] == final["num_blocks"]
    assert final["active_slots"] == 0 and final["queue_depth"] == 0
    with pytest.raises(OSError):
        request(server.port, "GET", "/healthz")

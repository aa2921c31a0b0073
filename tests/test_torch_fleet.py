"""Port parity for the serving fleet (modalities_tpu_torch/serving/fleet/ and
the routers' primitives in serving/resilience.py) against the JAX package's
modules, on the CPU, with no wall-clock race:

- CircuitBreaker, RetryBudget and ProbeBackoff against the JAX classes on the
  same scripted operations and clock readings (jitter draws fixed), and the
  event counters against the JAX ones;
- FleetRouter picks against the JAX router's on the same worker table, and
  both routers against scripted HTTP workers (the port's wire helpers):
  least-loaded, "degraded" last, the failover splice, the retry budget
  exhausted, 503 with no healthy worker. The port's router runs without its
  health loop and takes explicit `health_round()`s on a stepped clock (the
  heartbeat deadline); the JAX router's loop is replaced by explicit probes;
- RolloutController with scripted engines on a stepped clock: promotion,
  rollback on the error delta, rollback on a TTFT regression, outcomes equal
  to the JAX controller's;
- CheckpointWatcher over the port's own tiny checkpoint folders (sealed,
  torn, corrupt; `load_serving_params` reads the sealed one), choices and
  seal rejections equal to the JAX watcher's on the same folders;
- POST /admin/swap on a port worker with the fleet's handler, and 503
  without one."""

import asyncio
import http.client
import json
import threading

import pytest
import torch

from modalities_tpu.resilience import events as jax_events
from modalities_tpu.serving import resilience as jax_resilience
from modalities_tpu.serving.fleet import controller as jax_controller
from modalities_tpu.serving.fleet import router as jax_router
from modalities_tpu.serving.fleet import watcher as jax_watcher
from modalities_tpu.telemetry import metrics as jax_metrics
from modalities_tpu_torch.resilience import events
from modalities_tpu_torch.resilience.manifest import write_manifest
from modalities_tpu_torch.serving import resilience
from modalities_tpu_torch.serving.fleet import controller, router, watcher
from modalities_tpu_torch.serving.server import (
    SSE_HEADER_BYTES,
    json_response_bytes,
    read_http_request,
    sse_event_bytes,
)
from modalities_tpu_torch.telemetry import metrics as port_metrics
from modalities_tpu_torch.telemetry.metrics import parse_prometheus_text

ANSWER = [11, 12, 13, 14, 15]


class Clock:
    """A clock that moves only when told to."""

    def __init__(self, t: float = 100.0):
        self.t = t

    def __call__(self) -> float:
        return self.t


# ------------------------------------------------------------- primitives
BREAKER_SCRIPTS = {
    "trip_probe_close": (3, ["allow", "fail", "fail", "allow", "fail", ("tick", 0.5), "allow", ("tick", 0.8), "allow",
                             "allow", "ok", "allow"]),
    "half_open_fails_backoff_doubles": (2, ["fail", "fail", ("tick", 1.3), "allow", "fail", ("tick", 1.5), "allow",
                                            ("tick", 1.0), "allow", "fail", ("tick", 10.0), "allow", "ok", "fail"]),
    "success_resets_the_count": (2, ["fail", "ok", "fail", "allow", "fail", "allow"]),
}


def _run_breaker(module, threshold, script):
    clock = Clock()
    breaker = module.CircuitBreaker(failure_threshold=threshold, open_s=1.0, max_open_s=4.0, jitter=0.25,
                                    time_fn=clock, rng=lambda: 0.5)
    out = []
    for op in script:
        if isinstance(op, tuple):
            clock.t += op[1]
            continue
        got = {"allow": breaker.allow, "fail": breaker.record_failure, "ok": breaker.record_success}[op]()
        out.append((op, got, breaker.state, breaker.failures, breaker.state_value()))
    return out


@pytest.mark.parametrize("name", sorted(BREAKER_SCRIPTS))
def test_circuit_breaker_equals_jax(name):
    threshold, script = BREAKER_SCRIPTS[name]
    assert _run_breaker(resilience, threshold, script) == _run_breaker(jax_resilience, threshold, script)


BUDGET_SCRIPTS = {
    "full_bucket_drains_then_refuses": ({"cap": 3.0}, ["retry"] * 5 + ["ok"] * 4 + ["retry", "retry"]),
    "empty_start_funded_by_successes": ({"cap": 2.0, "initial": 0.0, "ratio": 0.5},
                                        ["retry", "ok", "retry", "ok", "ok", "retry", "ok"] + ["ok"] * 6 + ["retry"]),
}


def _run_budget(module, kwargs, script):
    budget = module.RetryBudget(**kwargs)
    out = []
    for op in script:
        got = budget.try_retry() if op == "retry" else budget.record_success()
        out.append((op, got, round(budget.tokens, 12), budget.exhausted))
    return out


@pytest.mark.parametrize("name", sorted(BUDGET_SCRIPTS))
def test_retry_budget_equals_jax(name):
    kwargs, script = BUDGET_SCRIPTS[name]
    assert _run_budget(resilience, kwargs, script) == _run_budget(jax_resilience, kwargs, script)


PROBE_SCRIPT = [("due", 0.0), ("failed", 0.0), ("due", 0.5), ("due", 0.7), ("failed", 0.7), ("due", 1.5),
                ("due", 2.0), ("failed", 2.0), ("failed", 5.0), ("failed", 9.0), ("due", 10.0), ("reset", 10.0),
                ("due", 10.0), ("failed", 10.0), ("due", 10.5)]


def _run_probe(module):
    backoff = module.ProbeBackoff(base_s=0.5, max_s=2.0, jitter=0.25, rng=lambda: 0.5)
    out = []
    for op, t in PROBE_SCRIPT:
        got = backoff.due(t) if op == "due" else (backoff.failed(t) if op == "failed" else backoff.reset())
        out.append((op, got, backoff.failures, backoff._next, backoff._delay))
    return out


def test_probe_backoff_equals_jax():
    assert _run_probe(resilience) == _run_probe(jax_resilience)


def test_event_counters_equal_jax():
    names = ["fleet/failover", "fleet/rollback", "serve/preempt", "fleet/canary", "anomaly/nonfinite", "fleet"]
    got = []
    for module in (events, jax_events):
        before = module.snapshot_counts()
        for name in names:
            module.record_event(name, worker="w0")
        got.append(module.counts_since(before))
    assert got[0] == got[1] == {"fleet": 4, "serve": 1, "anomaly": 1}


# ------------------------------------------------------ the router's picks
PICK_TABLE = [  # (name, healthy, load, degraded, tier)
    ("a", True, 3, False, "prefill"), ("b", True, 1, True, "prefill"), ("c", False, 0, False, "decode"),
    ("d", True, 1, False, "decode"), ("e", True, 1, False, "prefill"),
]
PICKS = [(set(), None)] * 4 + [({"d"}, None), ({"e", "a"}, "prefill"), (set(), "decode"), ({"d"}, "decode"),
                               ({"a", "e"}, None)]


def _picks(module_router, registry_module):
    handles = [module_router.WorkerHandle(name, "127.0.0.1", 1, tier=tier) for name, _, _, _, tier in PICK_TABLE]
    r = module_router.FleetRouter(handles, metrics=registry_module.MetricsRegistry())
    for w, (_, healthy, load, degraded, _) in zip(r.workers, PICK_TABLE):
        w.healthy, w.load, w.degraded = healthy, load, degraded
    for _ in range(3):  # an open breaker hides its worker (open for at least 1 s)
        r._record_worker_result(r.workers[4], ok=False)
    out = [getattr(r._pick(set(exclude), tier), "name", None) for exclude, tier in PICKS]
    r._record_worker_result(r.workers[4], ok=True)
    out += [getattr(r._pick(set(exclude), tier), "name", None) for exclude, tier in PICKS]
    return out, [w.picks for w in r.workers]


def test_router_picks_equal_jax():
    """Least load first, degraded last, the picks counter breaking ties, an
    open breaker hiding its worker, tiers and exclusions."""
    got, want = _picks(router, port_metrics), _picks(jax_router, jax_metrics)
    assert got == want
    assert got[0][:4] == ["d", "d", "d", "d"] and None in got[0]


# ------------------------------------------------ routers over scripted workers
class ScriptedWorker:
    """A loopback asyncio server speaking the worker protocol: /healthz
    (`status`), /stats (`load`), and POST /generate streaming `tokens`,
    cut without a done event after `abort_after` tokens when set."""

    def __init__(self, tokens=ANSWER, abort_after=None, load=0, status="ok"):
        self.tokens, self.abort_after, self.load, self.status = tokens, abort_after, load, status
        self.generates = 0
        self.headers = []
        self.port = None
        self._loop = None
        self._server = None

    async def _handle(self, reader, writer):
        req = await read_http_request(reader)
        if req is None:
            writer.close()
            return
        method, path, headers, _ = req
        try:
            if path == "/healthz":
                writer.write(json_response_bytes(200, {"status": self.status, "weights_generation": 0}))
            elif path == "/stats":
                writer.write(json_response_bytes(200, {"active_slots": self.load, "queue_depth": 0}))
            elif method == "POST" and path == "/generate":
                self.generates += 1
                self.headers.append(headers)
                writer.write(SSE_HEADER_BYTES)
                for i, tok in enumerate(self.tokens):
                    if self.abort_after is not None and i >= self.abort_after:
                        return  # the connection drops mid-stream
                    writer.write(sse_event_bytes({"token_id": tok, "text": str(tok)}))
                    await writer.drain()
                writer.write(sse_event_bytes({"done": True, "token_ids": self.tokens, "finish_reason": "budget"}))
            await writer.drain()
        finally:
            writer.close()

    def start(self) -> "ScriptedWorker":
        started = threading.Event()

        def main():
            self._loop = asyncio.new_event_loop()

            async def bind():
                self._server = await asyncio.start_server(self._handle, "127.0.0.1", 0)
                self.port = self._server.sockets[0].getsockname()[1]

            self._loop.run_until_complete(bind())
            started.set()
            self._loop.run_forever()

        threading.Thread(target=main, daemon=True).start()
        started.wait(10)
        return self

    def stop(self) -> None:
        async def close():
            self._server.close()
            await self._server.wait_closed()

        asyncio.run_coroutine_threadsafe(close(), self._loop).result(10)
        self._loop.call_soon_threadsafe(self._loop.stop)


def _post(port, body=None, timeout=30.0):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=timeout)
    try:
        conn.request("POST", "/generate", body=json.dumps(body or {"prompt": "x", "max_new_tokens": 5}))
        resp = conn.getresponse()
        raw = resp.read()
        if resp.status != 200:
            return resp.status, json.loads(raw)
        return 200, [json.loads(c[6:]) for c in raw.split(b"\n\n") if c.startswith(b"data: ")]
    finally:
        conn.close()


def _get(port, path):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=30)
    try:
        conn.request("GET", path)
        resp = conn.getresponse()
        raw = resp.read()
        return json.loads(raw) if path != "/metrics" else parse_prometheus_text(raw.decode())
    finally:
        conn.close()


def _router(package: str, workers: list, clock=None, **kwargs):
    """The package's FleetRouter over `workers`, started, its probes only the
    test's: the port's `health_loop=False`; the JAX loop replaced by a no-op."""
    handles = [(router if package == "port" else jax_router).WorkerHandle(f"w{i}", "127.0.0.1", w.port)
               for i, w in enumerate(workers)]
    if package == "port":
        return router.FleetRouter(handles, health_loop=False, time_fn=clock or Clock(), **kwargs).start()
    r = jax_router.FleetRouter(handles, metrics=jax_metrics.MetricsRegistry(), **kwargs)

    async def no_loop():
        return None

    r._health_loop = no_loop
    return r.start()


def _probe_all(package: str, r) -> None:
    if package == "port":
        r.health_round()
        return
    for w in r.workers:  # the JAX round's probe half, driven here
        if asyncio.run_coroutine_threadsafe(r._probe(w), r._loop).result(10):
            w.last_heartbeat = jax_router.time.monotonic()


@pytest.fixture(params=["port", "jax"])
def package(request):
    return request.param


def test_least_loaded_and_degraded_last(package):
    """Probes scrape /stats: the idle worker takes the traffic; a degraded
    worker serves only once every clean peer is out."""
    busy, idle, degraded = ScriptedWorker(load=7).start(), ScriptedWorker().start(), ScriptedWorker(
        status="degraded").start()
    r = _router(package, [busy, idle, degraded])
    try:
        _probe_all(package, r)
        assert [w.load for w in r.workers] == [7, 0, 0] and [w.degraded for w in r.workers] == [False, False, True]
        for _ in range(2):
            assert _post(r.port)[1][-1]["token_ids"] == ANSWER
        assert (busy.generates, idle.generates, degraded.generates) == (0, 2, 0)
        r.workers[1].healthy = False  # the idle worker out: the busy clean peer still beats the degraded one
        _post(r.port)
        assert (busy.generates, degraded.generates) == (1, 0)
        r.workers[0].healthy = False
        _post(r.port)
        assert degraded.generates == 1
    finally:
        r.close()
        for w in (busy, idle, degraded):
            w.stop()


def test_health_deadline_on_a_stepped_clock():
    """A worker that stops answering probes leaves rotation once its last
    heartbeat is older than the deadline, not before; traffic goes on on the
    survivor; with none left the router answers 503."""
    a, b = ScriptedWorker().start(), ScriptedWorker().start()
    clock = Clock()
    r = _router("port", [a, b], clock, heartbeat_deadline_s=5.0)
    try:
        r.health_round()
        b.stop()
        clock.t += 4.0
        r.health_round()  # b's probe fails, but its heartbeat is 4 s old: still healthy
        assert [w.healthy for w in r.workers] == [True, True]
        clock.t += 2.0
        r.health_round()
        assert [w.healthy for w in r.workers] == [True, False]
        assert _get(r.port, "/healthz")["workers_healthy"] == 1
        assert _get(r.port, "/metrics")["fleet_workers_healthy"][()] == 1.0
        assert _post(r.port)[1][-1]["token_ids"] == ANSWER and a.generates == 1
        a.stop()
        clock.t += 6.0
        r.health_round()
        status, body = _post(r.port)
        assert status == 503 and body["error"] == "no healthy workers"
    finally:
        r.close()


def test_no_healthy_worker_is_a_503_as_jax(package):
    w = ScriptedWorker().start()
    r = _router(package, [w])
    try:
        r.workers[0].healthy = False
        status, body = _post(r.port)
        assert status == 503 and body["error"] == "no healthy workers" and w.generates == 0
    finally:
        r.close()
        w.stop()


def test_mid_stream_failover_splices_one_answer(package):
    """The first worker dies after 2 of 5 tokens; the client gets the 5-token
    answer once, spliced from the peer's replay; the dead worker leaves
    rotation and one failover is counted."""
    dying, backup = ScriptedWorker(abort_after=2).start(), ScriptedWorker().start()
    r = _router(package, [dying, backup])
    try:
        status, evs = _post(r.port)
        assert status == 200 and [e["token_id"] for e in evs if "token_id" in e] == ANSWER
        assert [e for e in evs if e.get("done")][0]["token_ids"] == ANSWER
        assert (dying.generates, backup.generates, r.failovers) == (1, 1, 1)
        assert [h["x-trace-hop"] for h in dying.headers + backup.headers] == ["0", "1"]
        assert dying.headers[0]["x-trace-id"] == backup.headers[0]["x-trace-id"]
        table = _get(r.port, "/fleet")
        assert [w["healthy"] for w in table["workers"]] == [False, True] and table["failovers"] == 1
        parsed = _get(r.port, "/metrics")
        assert parsed["fleet_failovers_total"][()] == 1.0 and parsed["fleet_workers_healthy"][()] == 1.0
        status, evs = _post(r.port)  # the dead worker is out: no second failover
        assert [e["token_id"] for e in evs if "token_id" in e] == ANSWER and r.failovers == 1
    finally:
        r.close()
        dying.stop()
        backup.stop()


def test_retry_budget_exhausted_ends_the_request(package):
    """A dry retry budget: the failover is counted, the replay refused; the
    client's stream ends with the error event, the peer never asked."""
    dying, backup = ScriptedWorker(abort_after=2).start(), ScriptedWorker().start()
    r = _router(package, [dying, backup])
    r.retry_budget = (resilience if package == "port" else jax_resilience).RetryBudget(initial=0.0)
    try:
        status, evs = _post(r.port)
        assert status == 200 and [e.get("token_id", e.get("error")) for e in evs] == [11, 12, "retry budget exhausted"]
        assert (backup.generates, r.failovers, r.retry_budget.exhausted) == (0, 1, 1)
        assert _get(r.port, "/metrics")["fleet_retry_budget_exhausted_total"][()] == 1.0
    finally:
        r.close()
        dying.stop()
        backup.stop()


# ---------------------------------------------------------- the controller
class FakeEngine:
    """The engine surface both packages' EngineWorker reads: stats, a TTFT
    histogram, the installed weights, a synchronous swap."""

    def __init__(self, registry_module, load=0):
        self.weights_generation = 0
        self.metrics = registry_module.MetricsRegistry()
        self.ttft = self.metrics.histogram("serve_ttft_seconds", "ttft")
        self.request_errors = 0
        self._load = load
        self._queue = []
        self._installed = {"w": torch.tensor([1.0])}
        self.params = self._installed
        self.swaps = []

    def _stopping(self):
        return False

    def _active_count(self):
        return self._load

    def stats(self):
        return {"request_errors": self.request_errors, "weights_generation": self.weights_generation,
                "active_slots": self._load, "queue_depth": 0}

    def swap_weights(self, params, generation=None):
        self.swaps.append((float(params["w"][0]), generation))
        self._installed = self.params = {k: v.clone() for k, v in params.items()}
        self.weights_generation = generation


class StepClock:
    def __init__(self):
        self.t, self.on_tick = 0.0, None

    def now(self):
        return self.t

    def sleep(self, dt):
        self.t += dt
        if self.on_tick is not None:
            self.on_tick()


def _rollout(package: str, traffic: str, loads=(2, 0, 5)):
    mod, reg = (controller, port_metrics) \
        if package == "port" else (jax_controller, jax_metrics)
    workers = [mod.EngineWorker(f"w{i}", FakeEngine(reg, load)) for i, load in enumerate(loads)]
    clock = StepClock()
    registry = reg.MetricsRegistry()
    ctl = mod.RolloutController(workers, metrics=registry, probation_s=1.0, probation_tick_s=0.25,
                                time_fn=clock.now, sleep_fn=clock.sleep)
    canary = workers[1].engine

    def tick():
        if traffic == "errors" and canary.weights_generation == 1:
            canary.request_errors += 1
        elif traffic == "slow":
            canary.ttft.observe(0.4)
            for w in workers:
                if w.engine is not canary:
                    w.engine.ttft.observe(0.1)

    clock.on_tick = tick
    verdict = ctl.deploy({"w": torch.tensor([2.0])}, step=7)
    text = registry.render()
    parsed = parse_prometheus_text(text)
    return (verdict, ctl.generation, clock.t, [w.engine.swaps for w in workers],
            [float(w.engine._installed["w"][0]) for w in workers],
            parsed.get("fleet_rollouts_total", {}).get((), 0.0), parsed.get("fleet_rollbacks_total", {}).get((), 0.0))


@pytest.mark.parametrize("traffic,verdict", [("quiet", True), ("errors", False), ("slow", False)],
                         ids=["promote", "rollback_error_delta", "rollback_ttft"])
def test_rollout_outcomes_equal_jax(traffic, verdict):
    """The least-loaded worker is the canary; a clean window promotes to
    every worker, an error on the canary rolls it back at the first tick, a
    canary 4x slower than the fleet rolls back at the window's end; the
    canary ends on its donor weights."""
    got, want = _rollout("port", traffic), _rollout("jax", traffic)
    assert got == want and got[0] is verdict
    swaps = got[3]
    if verdict:
        assert swaps[1] == [(2.0, 1)] and got[4] == [2.0, 2.0, 2.0] and got[5] == 1.0
    else:
        assert swaps[1] == [(2.0, 1), (1.0, 0)] and swaps[0] == swaps[2] == [] and got[4] == [1.0] * 3
        assert got[6] == 1.0 and (got[2] < 1.0) == (traffic == "errors")


def test_controller_refuses_an_slo_verdict_naming_item_6():
    worker = controller.EngineWorker("w0", FakeEngine(port_metrics))
    with pytest.raises(NotImplementedError, match="Queue 1 item 6"):
        controller.RolloutController([worker], slo_verdict_fn=lambda w: [])


# ------------------------------------------------------------- the watcher
@pytest.fixture(scope="module")
def ring(tmp_path_factory):
    """Steps 2 (sealed), 4 (sealed, then a byte of its data changed) and 6
    (torn: no manifest) of the port's own checkpoint layout, each holding a
    tiny parameter tree under `model.` (what load_serving_params reads)."""
    import torch.distributed.checkpoint as dcp

    root = tmp_path_factory.mktemp("ring")
    trees = {}
    for step in (2, 4, 6):
        folder = root / f"eid_x-seen_steps_{step}-seen_tokens_{step * 64}-target_steps_9-target_tokens_576"
        trees[step] = {"wte": torch.full((4, 3), float(step)), "lm_head_norm.scale": torch.ones(3)}
        dcp.save({"model": trees[step]}, checkpoint_id=folder)
        if step != 6:
            write_manifest(folder)
        if step == 4:
            data = next(folder.glob("*.distcp"))
            raw = bytearray(data.read_bytes())
            raw[-1] ^= 0xFF
            data.write_bytes(bytes(raw))
    return root, trees


def module_events(module):
    return events if module is watcher else jax_events


def _watch(module, root, load_fn, on_params):
    """(a watcher over `root`, the event counts before it scans)."""
    before = module_events(module).snapshot_counts()
    return module.CheckpointWatcher(root, on_params, load_fn=load_fn, poll_interval_s=0.0), before


def test_watcher_deploys_the_newest_sealed_folder_as_jax(ring):
    """Torn (no manifest) and corrupt (a digest mismatch) seals are rejected,
    one event a folder, and the scan walks back to step 2, which
    load_serving_params reads; the JAX watcher chooses the same."""
    root, trees = ring
    from modalities_tpu_torch.serving.serve import load_serving_params

    deployed = []
    w, before = _watch(watcher, root, lambda folder: load_serving_params(folder, device="cpu"),
                       lambda params, step, folder: deployed.append((step, params)))
    jw, jbefore = _watch(jax_watcher, root, lambda folder, **kw: {"folder": folder},
                         lambda params, step, folder: deployed.append((step, None)))
    assert w.scan_once().name == jw.scan_once().name and w.scan_once().name.startswith("eid_x-seen_steps_2-")
    assert events.counts_since(before) == jax_events.counts_since(jbefore) == {"fleet": 2}  # torn + corrupt, once each
    assert w.poll_once() and jw.poll_once()
    (step, params), (jstep, _) = deployed
    assert step == jstep == 2 and w.deployed_step == jw.deployed_step == 2
    assert set(params) == set(trees[2]) and all(torch.equal(params[k], trees[2][k]) for k in params)
    assert not w.poll_once() and not jw.poll_once()  # nothing newer verifies
    assert sorted(w._rejected_seen) == sorted(jw._rejected_seen)


@pytest.mark.parametrize("failure", ["load", "deploy"])
def test_watcher_burns_a_step_as_jax(ring, failure):
    """A sealed step that fails to load (a fleet/rollback event) or whose
    deploy returns False (the canary rolled back) is burned: never retried."""
    root, _ = ring
    outcomes = []
    for module in (watcher, jax_watcher):

        def load(folder, **kwargs):
            if failure == "load":
                raise OSError("storage went away")
            return {}

        before = module_events(module).snapshot_counts()
        w = module.CheckpointWatcher(root, lambda *a: False, load_fn=load, poll_interval_s=0.0)
        first, second = w.poll_once(), w.poll_once()
        outcomes.append((first, second, w.deployed_step, sorted(w._rejected_steps), w.polls,
                         module_events(module).counts_since(before).get("fleet", 0)))
    assert outcomes[0] == outcomes[1]
    assert outcomes[0][:4] == (False, False, -1, [2])


# --------------------------------------------------------- POST /admin/swap
def test_admin_swap_with_and_without_a_handler():
    """503 with no handler wired; with the fleet's handler: 500 without a
    checkpoint_folder, then the named folder loaded and swapped in on the
    engine thread (generation 1), and the worker serves on."""
    from modalities_tpu_torch.serving.engine import ServingEngine
    from modalities_tpu_torch.serving.fleet.component import swap_handler
    from modalities_tpu_torch.serving.server import ServingHTTPServer
    from tests.test_torch_gpt2 import jax_and_port

    _, _, pm, pp = jax_and_port("float32")
    engine = ServingEngine(pm, pp, device="cpu", max_batch_slots=2, kv_cache="paged", paged_block_size=8)
    server = ServingHTTPServer(engine, encode=lambda s: [int(t) for t in s.split()],
                               decode=lambda ids: " ".join(map(str, ids)), port=0)
    server.start()
    loads = []
    try:
        def swap(body):
            conn = http.client.HTTPConnection("127.0.0.1", server.port, timeout=60)
            conn.request("POST", "/admin/swap", body=json.dumps(body))
            resp = conn.getresponse()
            return resp.status, json.loads(resp.read())

        status, body = swap({"checkpoint_folder": "ring/step9"})
        assert status == 503 and body == {"error": "no swap handler wired"}
        server.swap_handler = swap_handler(controller.EngineWorker("w0", engine, server),
                                           lambda folder: loads.append(folder) or pp)
        status, body = swap({})
        assert status == 500 and "checkpoint_folder" in body["error"]
        status, body = swap({"checkpoint_folder": "ring/step9"})
        assert (status, body, loads) == (200, {"ok": True, "worker": "w0", "weights_generation": 1}, ["ring/step9"])
        assert _get(server.port, "/healthz")["weights_generation"] == 1
        status, evs = _post(server.port, {"prompt": "3 4", "max_new_tokens": 3})
        assert status == 200 and evs[-1]["weights_generation"] == 1 and len(evs[-1]["token_ids"]) == 3
    finally:
        server.close()

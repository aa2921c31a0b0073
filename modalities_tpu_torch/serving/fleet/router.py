"""Fleet HTTP router: a load-balancing, failover-capable front tier over N
engine workers, the port of modalities_tpu/serving/fleet/router.py, on the
asyncio machinery of serving/server.py (whose wire helpers it reuses).

Routing: `POST /generate` goes to the healthy worker with the lowest live
load (active slots + queue depth, scraped from each worker's `/stats`),
ties broken by fewest picks. Health: a background task probes every
worker's `/healthz` and `/stats` each interval; a worker is healthy while
its last successful probe is within the heartbeat deadline
(``MODALITIES_TPU_FLEET_HEALTH_DEADLINE_S``, default 5 s) and it is not
draining. A worker whose /healthz reports ``degraded`` stays in rotation
but is deprioritized: clean peers win while any exist (the port's workers
report it once the SLO engine exists, ROADMAP.md Queue 1 item 6).

Failover: when a worker dies mid-stream (its connection drops before the
final SSE `done` event) the router marks it unhealthy, bumps
`fleet_failovers_total` and REPLAYS the request on a peer, forwarding only
the token events past the count the client already has, so the client sees
one answer. The splice is exact because the peers are deterministic
replicas (the same weights generation, seeded sampling). A per-worker
`CircuitBreaker`, one `RetryBudget` funded by successful requests and a
`ProbeBackoff` per dead worker (serving/resilience.py) bound the retries.

Endpoints: `POST /generate` (proxied SSE), `GET /healthz`, `GET /fleet`
(per-worker table), `GET /metrics` (the fleet registry's exposition).

`time_fn` is the clock of the heartbeats, breakers and probe backoffs;
`health_loop=False` leaves the probes to `health_round()`, so a test steps
the health state without racing a wall clock.
"""

from __future__ import annotations

import asyncio
import json
import logging
import os
import threading
import time
import uuid
from typing import Callable, Optional

from modalities_tpu_torch.resilience.events import record_event
from modalities_tpu_torch.serving.resilience import CircuitBreaker, ProbeBackoff, RetryBudget
from modalities_tpu_torch.serving.server import (
    RETRY_AFTER_S,
    SSE_HEADER_BYTES,
    json_response_bytes,
    read_http_request,
    response_bytes,
    sse_event_bytes,
)
from modalities_tpu_torch.telemetry.metrics import CONTENT_TYPE_LATEST, MetricsRegistry, register_process_metrics

logger = logging.getLogger(__name__)


def _default_heartbeat_deadline_s() -> float:
    return float(os.environ.get("MODALITIES_TPU_FLEET_HEALTH_DEADLINE_S", "5.0"))


class _ClientGone(Exception):
    """The downstream client hung up mid-stream: stop relaying, don't retry."""


class WorkerHandle:
    """The router's view of one worker: its address and live health and load."""

    def __init__(self, name: str, host: str, port: int, tier: str = "serve"):
        self.name = name
        self.host = host
        self.port = int(port)
        # disaggregation: "prefill" / "decode" split one fleet into tiers; the
        # flat fleet keeps the single "serve" tier
        self.tier = tier
        self.healthy = True  # optimistic until the first probe says otherwise
        self.draining = False
        self.degraded = False  # /healthz "degraded": serving, but in SLO breach
        self.slo_breaching: list[str] = []
        self.last_heartbeat = time.monotonic()
        self.load = 0  # active slots + queue depth, from the last /stats probe
        self.weights_generation = 0
        self.picks = 0  # least-loaded tiebreak: spread across idle workers

    @property
    def address(self) -> str:
        return f"{self.host}:{self.port}"


async def _read_response_head(reader: asyncio.StreamReader) -> tuple[int, dict]:
    """Status code and headers of an upstream response; the body stays on `reader`."""
    status_line = await reader.readline()
    if not status_line:
        raise ConnectionError("upstream closed before the status line")
    parts = status_line.decode("latin-1").split(None, 2)
    if len(parts) < 2 or not parts[1].isdigit():
        raise ConnectionError(f"malformed upstream status line: {status_line!r}")
    headers: dict[str, str] = {}
    while True:
        line = await reader.readline()
        if not line or line in (b"\r\n", b"\n"):
            break
        key, _, value = line.decode("latin-1").partition(":")
        headers[key.strip().lower()] = value.strip()
    return int(parts[1]), headers


async def _close(writer) -> None:
    writer.close()
    try:
        await writer.wait_closed()
    except (ConnectionError, OSError):
        pass


async def http_get_json(host: str, port: int, path: str, timeout_s: float = 2.0) -> tuple[int, dict]:
    """One GET round trip against a worker (Connection: close framing)."""

    async def _roundtrip():
        reader, writer = await asyncio.open_connection(host, port)
        try:
            writer.write(f"GET {path} HTTP/1.1\r\nHost: {host}\r\nConnection: close\r\n\r\n".encode())
            await writer.drain()
            status, header_map = await _read_response_head(reader)
            length = header_map.get("content-length")
            body = await (reader.readexactly(int(length)) if length else reader.read())
            return status, json.loads(body or b"{}")
        finally:
            await _close(writer)

    return await asyncio.wait_for(_roundtrip(), timeout_s)


def _leg_head(path: str, worker: WorkerHandle, state: dict, length: int) -> bytes:
    """A leg's request head: every leg of a request (failover replays too)
    carries the SAME trace id, the hop telling the legs apart, and the
    deadline and tenant ride along (the worker re-anchors the deadline to
    its own arrival clock)."""
    deadline = f"X-Deadline-Ms: {state['deadline_ms']}\r\n" if state.get("deadline_ms") else ""
    tenant = f"X-Tenant-Id: {state['tenant']}\r\n" if state.get("tenant") else ""
    return (f"POST {path} HTTP/1.1\r\nHost: {worker.host}\r\nContent-Type: application/json\r\n"
            f"X-Trace-Id: {state['trace_id']}\r\nX-Trace-Hop: {state['hop']}\r\n{deadline}{tenant}"
            f"Content-Length: {length}\r\nConnection: close\r\n\r\n").encode("latin-1")


class FleetRouter:
    """Asyncio front tier over `WorkerHandle`s (the lifecycle of
    ServingHTTPServer: start() binds, stop() drains, close() tears down)."""

    def __init__(
        self,
        workers: list[WorkerHandle],
        *,
        host: str = "127.0.0.1",
        port: int = 0,
        metrics: Optional[MetricsRegistry] = None,
        health_interval_s: float = 0.5,
        heartbeat_deadline_s: Optional[float] = None,
        connect_timeout_s: float = 2.0,
        time_fn: Callable[[], float] = time.monotonic,
        health_loop: bool = True,
    ):
        if not workers:
            raise ValueError("FleetRouter needs at least one worker")
        from modalities_tpu_torch import __version__

        self.workers = list(workers)
        self._host = host
        self._port_req = int(port)
        self.port: Optional[int] = None
        self.metrics = metrics if metrics is not None else MetricsRegistry()
        self.health_interval_s = health_interval_s
        self.heartbeat_deadline_s = (heartbeat_deadline_s if heartbeat_deadline_s is not None
                                     else _default_heartbeat_deadline_s())
        self.connect_timeout_s = connect_timeout_s
        self._now = time_fn
        self._run_health_loop = health_loop
        for w in self.workers:
            w.last_heartbeat = self._now()
        self.http_requests = 0
        self.failovers = 0
        self._shutdown = False
        self._active_relays = 0
        self._m_workers_healthy = self.metrics.gauge("fleet_workers_healthy", "Workers currently passing health checks")
        self._m_workers_healthy.set(len(self.workers))
        self._m_workers_degraded = self.metrics.gauge("fleet_workers_degraded", "Workers serving in sustained SLO breach")
        self._m_workers_degraded.set(0)
        self._degraded_seen: dict[str, bool] = {}
        self._m_failovers = self.metrics.counter("fleet_failovers_total",
                                                 "Generate requests re-routed off a dead worker")
        self._m_e2e = self.metrics.histogram("fleet_request_e2e_seconds",
                                             "Router-observed latency from generate arrival to the final SSE event")
        self._breakers = {w.name: CircuitBreaker(time_fn=time_fn) for w in self.workers}
        self.retry_budget = RetryBudget()
        self._probe_backoff = {w.name: ProbeBackoff(base_s=max(self.health_interval_s, 0.05)) for w in self.workers}
        self._probe_fail_seen: dict[str, bool] = {}
        self._m_retry_exhausted = self.metrics.counter("fleet_retry_budget_exhausted_total",
                                                       "Failover retries refused because the retry budget ran dry")
        self._m_circuit = self.metrics.gauge("fleet_circuit_state",
                                             "Per-worker circuit breaker state (0 closed, 1 half-open, 2 open)")
        for w in self.workers:
            self._m_circuit.set(0.0, worker=w.name)
        register_process_metrics(self.metrics, version=__version__)
        self._loop: Optional[asyncio.AbstractEventLoop] = None
        self._aio_server = None
        self._loop_thread: Optional[threading.Thread] = None

    # ---------------------------------------------------------------- health
    async def _probe(self, worker: WorkerHandle) -> bool:
        try:
            status, health = await http_get_json(worker.host, worker.port, "/healthz", self.connect_timeout_s)
            if status != 200:
                return False
            worker.draining = health.get("status") == "draining"
            worker.degraded = health.get("status") == "degraded"
            worker.slo_breaching = list(health.get("slo_breaching") or [])
            worker.weights_generation = int(health.get("weights_generation", 0))
            status, stats = await http_get_json(worker.host, worker.port, "/stats", self.connect_timeout_s)
            if status == 200:
                worker.load = int(stats.get("active_slots", 0)) + int(stats.get("queue_depth", 0))
            return True
        except (OSError, ConnectionError, asyncio.TimeoutError, ValueError):
            return False

    async def _health_round(self) -> None:
        """One probe of every worker (a dead one only once its backoff is
        due), then the health, degraded and gauge bookkeeping."""
        for worker in self.workers:
            backoff = self._probe_backoff.setdefault(worker.name,
                                                     ProbeBackoff(base_s=max(self.health_interval_s, 0.05)))
            if not worker.healthy and not backoff.due(self._now()):
                continue  # a dead worker: wait out the jittered backoff
            if await self._probe(worker):
                worker.last_heartbeat = self._now()
                backoff.reset()
                self._probe_fail_seen.pop(worker.name, None)
            elif not worker.healthy:
                backoff.failed(self._now())
                if not self._probe_fail_seen.get(worker.name):  # one line an outage
                    logger.info("fleet router: probe of dead worker %s failed; re-probing with exponential backoff",
                                worker.name)
                    self._probe_fail_seen[worker.name] = True
        now = self._now()
        for worker in self.workers:
            was_healthy = worker.healthy
            worker.healthy = now - worker.last_heartbeat <= self.heartbeat_deadline_s and not worker.draining
            if was_healthy and not worker.healthy:
                logger.warning("fleet router: worker %s unhealthy", worker.name)
                record_event("fleet/worker_unhealthy", worker=worker.name, address=worker.address,
                             draining=worker.draining)
            elif worker.healthy and not was_healthy:
                logger.info("fleet router: worker %s recovered", worker.name)
                record_event("fleet/worker_recovered", worker=worker.name, address=worker.address)
        for worker in self.workers:
            was_degraded = self._degraded_seen.get(worker.name, False)
            if worker.degraded and not was_degraded:
                logger.warning("fleet router: worker %s degraded (SLO breach)", worker.name)
                record_event("fleet/worker_degraded", worker=worker.name, address=worker.address)
            elif was_degraded and not worker.degraded:
                logger.info("fleet router: worker %s degradation cleared", worker.name)
                record_event("fleet/worker_degradation_cleared", worker=worker.name, address=worker.address)
            self._degraded_seen[worker.name] = worker.degraded
        self._m_workers_healthy.set(sum(1 for w in self.workers if w.healthy))
        self._m_workers_degraded.set(sum(1 for w in self.workers if w.degraded))
        tiers = {w.tier for w in self.workers}
        if tiers != {"serve"}:
            # a tiered fleet: one series a tier, so the sizing signal names the thin one
            for tier in sorted(tiers):
                self._m_workers_healthy.set(sum(1 for w in self.workers if w.tier == tier and w.healthy), tier=tier)
        self._after_health_round()

    async def _health_loop(self) -> None:
        while True:
            await self._health_round()
            await asyncio.sleep(self.health_interval_s)

    def health_round(self, timeout_s: float = 30.0) -> None:
        """Run one health round on the router's loop and wait for it."""
        asyncio.run_coroutine_threadsafe(self._health_round(), self._loop).result(timeout_s)

    def _after_health_round(self) -> None:
        """Hook: a subclass reacts to a finished probe round."""

    def _pick(self, exclude: set, tier: Optional[str] = None) -> Optional[WorkerHandle]:
        candidates = [w for w in self.workers
                      if w.healthy and w.name not in exclude and (tier is None or w.tier == tier)]
        # degraded last: an SLO-breaching worker still serves, but only when
        # every clean peer is excluded or down
        candidates.sort(key=lambda w: (w.degraded, w.load, w.picks))
        for w in candidates:
            # the breaker gate: open hides the worker, half-open admits this
            # request as its one probe
            breaker = self._breakers.get(w.name)
            allowed = breaker is None or breaker.allow()
            if breaker is not None:
                self._m_circuit.set(breaker.state_value(), worker=w.name)
            if not allowed:
                continue
            w.picks += 1
            return w
        return None

    def _record_worker_result(self, worker: WorkerHandle, *, ok: bool) -> None:
        """Feed one leg's outcome to the worker's breaker and, on success, the
        shared retry budget."""
        breaker = self._breakers.get(worker.name)
        if breaker is None:
            breaker = self._breakers[worker.name] = CircuitBreaker(time_fn=self._now)
        if ok:
            breaker.record_success()
            self.retry_budget.record_success()
        else:
            breaker.record_failure()
        self._m_circuit.set(breaker.state_value(), worker=worker.name)

    # ----------------------------------------------------------------- proxy
    async def _relay_from_worker(self, worker: WorkerHandle, body_bytes: bytes, client_writer, state: dict,
                                 path: str = "/generate", stream_offset: int = 0, done_transform=None) -> str:
        """Stream one worker's answer through to the client. Returns "done"
        (the client got its final event) or "failover" (the worker refused or
        died first: the caller retries a peer); raises _ClientGone when the
        client hangs up. `path` points the leg at a tier endpoint;
        `stream_offset` is how many of the request's tokens came before this
        worker's stream (the decode leg starts at the request's second
        token), so the replay's skip counts overall positions;
        `done_transform(event)` rewrites the final event, or returns None to
        turn a retryable error event into a failover."""

        async def send_client(data: bytes) -> None:
            try:
                client_writer.write(data)
                await client_writer.drain()
            except (ConnectionError, OSError) as exc:
                raise _ClientGone() from exc

        try:
            reader, writer = await asyncio.wait_for(asyncio.open_connection(worker.host, worker.port),
                                                    self.connect_timeout_s)
        except (OSError, asyncio.TimeoutError):
            return "failover"
        try:
            writer.write(_leg_head(path, worker, state, len(body_bytes)) + body_bytes)
            await writer.drain()
            status, headers = await asyncio.wait_for(_read_response_head(reader), self.connect_timeout_s)
            if status != 200:
                length = headers.get("content-length")
                body = await (reader.readexactly(int(length)) if length else reader.read())
                if status == 503:  # a draining worker: a peer can still serve it
                    return "failover"
                if state["headers_sent"]:  # mid-SSE: the status can't change now
                    await send_client(sse_event_bytes({"error": body.decode("utf-8", "replace")}))
                else:
                    await send_client(response_bytes(status, headers.get("content-type", "application/json"), body))
                return "done"
            if not state["headers_sent"]:
                await send_client(SSE_HEADER_BYTES)
                state["headers_sent"] = True
            # relay the SSE stream, skipping the token events the client
            # already has from an earlier worker (the replay's overlap)
            buf = b""
            seen_tokens = 0
            skip = state["forwarded"] - stream_offset
            while True:
                chunk = await reader.read(4096)
                if not chunk:
                    return "failover"  # the upstream died before its done event
                buf += chunk
                while b"\n\n" in buf:
                    raw, buf = buf.split(b"\n\n", 1)
                    if not raw.startswith(b"data: "):
                        continue
                    event = json.loads(raw[len(b"data: "):])
                    if "token_id" in event:
                        seen_tokens += 1
                        if seen_tokens <= skip:
                            continue
                        state["forwarded"] += 1
                        await send_client(raw + b"\n\n")
                    elif done_transform is not None:
                        rewritten = done_transform(event)
                        if rewritten is None:
                            return "failover"
                        await send_client(sse_event_bytes(rewritten))
                        return "done"
                    else:
                        # done, or an engine-side error: deterministic, never retried
                        await send_client(raw + b"\n\n")
                        return "done"
        except (ConnectionError, asyncio.TimeoutError, asyncio.IncompleteReadError, OSError):
            return "failover"
        finally:
            await _close(writer)

    async def _send_error(self, client_writer, state: dict, payload: dict) -> None:
        """An error to the client: an SSE event once the stream started, else a 503."""
        try:
            if state["headers_sent"]:
                client_writer.write(sse_event_bytes(payload))
            else:
                client_writer.write(json_response_bytes(503, payload, {"Retry-After": RETRY_AFTER_S}))
            await client_writer.drain()
        except (ConnectionError, OSError):
            pass

    def _fail_worker(self, worker: WorkerHandle, state: dict, reason: Optional[str] = None) -> None:
        """A worker failed under a request: out of rotation until a probe
        succeeds again (its heartbeat invalidated, so a probe that finished
        just before the death cannot revive it), its breaker fed."""
        worker.healthy = False
        worker.last_heartbeat = float("-inf")
        self._record_worker_result(worker, ok=False)
        self.failovers += 1
        self._m_failovers.inc()
        self._m_workers_healthy.set(sum(1 for w in self.workers if w.healthy))
        logger.warning("fleet router: failover off %s (%s tier) after %d forwarded tokens", worker.name, worker.tier,
                       state["forwarded"])
        record_event("fleet/failover", worker=worker.name, tier=worker.tier, forwarded_tokens=state["forwarded"],
                     trace_id=state["trace_id"], **({"reason": reason} if reason else {}))

    async def _retry_allowed(self, client_writer, state: dict, worker_name: str) -> bool:
        """Every replay spends one retry token; a dry budget ends the request
        instead of storming the survivors."""
        if self.retry_budget.try_retry():
            return True
        self._m_retry_exhausted.inc()
        record_event("fleet/retry_budget_exhausted", trace_id=state["trace_id"], worker=worker_name)
        await self._send_error(client_writer, state, {"error": "retry budget exhausted", "trace_id": state["trace_id"]})
        return False

    def _new_state(self, headers: Optional[dict]) -> dict:
        """A request's relay state: the fleet-wide trace id (minted here, or
        the one a client or an upper tier sent), the splice counter, the hop."""
        headers = headers or {}
        return {"forwarded": 0, "headers_sent": False, "trace_id": headers.get("x-trace-id") or uuid.uuid4().hex[:16],
                "hop": 0, "deadline_ms": headers.get("x-deadline-ms") or "", "tenant": headers.get("x-tenant-id") or ""}

    async def _proxy_generate(self, body_bytes: bytes, client_writer, headers: Optional[dict] = None) -> None:
        self.http_requests += 1
        if self._shutdown:
            client_writer.write(json_response_bytes(503, {"error": "router is draining"},
                                                    {"Retry-After": RETRY_AFTER_S}))
            return
        state = self._new_state(headers)
        t_arrival = time.monotonic()
        tried: set[str] = set()
        self._active_relays += 1
        try:
            while True:
                worker = self._pick(tried)
                if worker is None:
                    await self._send_error(client_writer, state,
                                           {"error": "no healthy workers", "trace_id": state["trace_id"]})
                    return
                tried.add(worker.name)
                outcome = await self._relay_from_worker(worker, body_bytes, client_writer, state)
                state["hop"] += 1
                if outcome == "done":
                    self._record_worker_result(worker, ok=True)
                    return
                self._fail_worker(worker, state)
                if not await self._retry_allowed(client_writer, state, worker.name):
                    return
        except _ClientGone:
            return
        finally:
            self._active_relays -= 1
            self._m_e2e.observe(time.monotonic() - t_arrival, exemplar=state["trace_id"])

    # -------------------------------------------------------------- endpoints
    def fleet_table(self) -> dict:
        return {
            "workers": [{"name": w.name, "address": w.address, "tier": w.tier, "healthy": w.healthy,
                         "draining": w.draining, "degraded": w.degraded, "load": w.load,
                         "weights_generation": w.weights_generation, "picks": w.picks,
                         "circuit": self._breakers[w.name].state if w.name in self._breakers else "closed"}
                        for w in self.workers],
            "failovers": self.failovers,
            "http_requests": self.http_requests,
            "retry_budget_tokens": self.retry_budget.tokens,
            "retry_budget_exhausted": self.retry_budget.exhausted,
        }

    async def _handle(self, reader, writer) -> None:
        try:
            req = await read_http_request(reader)
            if req is None:
                return
            method, path, headers, body_bytes = req
            if method == "GET" and path == "/healthz":
                writer.write(json_response_bytes(200, {"status": "draining" if self._shutdown else "ok",
                                                       "workers_healthy": sum(1 for w in self.workers if w.healthy),
                                                       "workers_total": len(self.workers)}))
            elif method == "GET" and path == "/fleet":
                writer.write(json_response_bytes(200, self.fleet_table()))
            elif method == "GET" and path == "/metrics":
                writer.write(response_bytes(200, CONTENT_TYPE_LATEST, self.metrics.render().encode("utf-8")))
            elif method == "POST" and path == "/generate":
                await self._proxy_generate(body_bytes, writer, headers)
            else:
                writer.write(json_response_bytes(404, {"error": f"unknown path {path}"}))
            await writer.drain()
        except (ConnectionError, BrokenPipeError, OSError):
            pass
        finally:
            await _close(writer)

    # -------------------------------------------------------------- lifecycle
    def _loop_main(self, started: threading.Event) -> None:
        loop = asyncio.new_event_loop()
        self._loop = loop
        asyncio.set_event_loop(loop)

        async def _bind():
            self._aio_server = await asyncio.start_server(self._handle, self._host, self._port_req)
            self.port = self._aio_server.sockets[0].getsockname()[1]
            if self._run_health_loop:
                loop.create_task(self._health_loop())

        try:
            loop.run_until_complete(_bind())
        finally:
            started.set()
        loop.run_forever()
        tasks = asyncio.all_tasks(loop)
        for task in tasks:
            task.cancel()
        if tasks:
            loop.run_until_complete(asyncio.gather(*tasks, return_exceptions=True))
        try:
            loop.run_until_complete(asyncio.wait_for(loop.shutdown_default_executor(), timeout=2.0))
        except (asyncio.TimeoutError, RuntimeError):
            pass
        loop.close()

    def start(self) -> "FleetRouter":
        started = threading.Event()
        self._loop_thread = threading.Thread(target=self._loop_main, args=(started,), name="fleet-router",
                                             daemon=True)
        self._loop_thread.start()
        started.wait(10.0)
        if self.port is None:
            raise RuntimeError(f"fleet router failed to bind {self._host}:{self._port_req}")
        return self

    def stop(self) -> None:
        """Drain: new generates get 503, in-flight relays finish."""
        self._shutdown = True

    def serve_forever(self, poll_s: float = 0.1) -> dict:
        """Block until stop() and every in-flight relay finished, then close."""
        try:
            while not (self._shutdown and self._active_relays == 0):
                time.sleep(poll_s)
        finally:
            self.close()
        return self.fleet_table()

    def close(self) -> None:
        self._shutdown = True
        loop = self._loop
        if loop is not None and not loop.is_closed():

            async def _close_listener():
                if self._aio_server is not None:
                    self._aio_server.close()
                    await self._aio_server.wait_closed()

            try:
                asyncio.run_coroutine_threadsafe(_close_listener(), loop).result(5.0)
            except Exception:
                pass
            try:
                loop.call_soon_threadsafe(loop.stop)
            except RuntimeError:
                pass
        if self._loop_thread is not None and self._loop_thread.is_alive():
            self._loop_thread.join(5.0)
        self._loop = None
        self._aio_server = None

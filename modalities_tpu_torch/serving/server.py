"""Streaming HTTP front end for the serving engine: the port of
modalities_tpu/serving/server.py.

Stdlib only: ONE asyncio event loop (its own thread) multiplexes every
connection, ONE engine thread owns the model and every tensor. The seam
between them:

- connection handlers never touch the engine's tensors: a POST pushes (body,
  stream queue) onto `_pending` (queue.Queue) and relays its own stream
  queue out as SSE; the admission checks it makes (`overload_reason`,
  `tenant_reject_reason`, `retry_after_s`) read host values only;
- the engine thread sets its CUDA device, drains `_pending` at token
  boundaries (engine.submit stays single-threaded), runs `engine.step`, and
  routes emitted tokens back through the engine's `on_token` / `on_finish`
  callbacks into the per-request stream queues.

Endpoints:
- `POST /generate`: body `{"prompt": str, "max_new_tokens": int,
  "temperature": float|null, "seed": int, "deadline_ms"?: float,
  "priority"?: int, "tenant"?: str}` (the `X-Deadline-Ms` and `X-Tenant-Id`
  headers are folded into the body, as are the fleet's `X-Trace-Id` and
  `X-Trace-Hop`; a body key wins); the answer is SSE
  (`text/event-stream`): one `data: {"token_id", "text"}` event a token, a
  final `data: {"done": true, "completion", "finish_reason", ...}` event,
  then the connection closes. 400 on a bad body, 409 on a prefill- or
  decode-tier engine (misrouted), 429 with a derived `Retry-After` when the
  queue is full, the engine is browned out or the tenant is over its token
  rate, 503 while draining.
- `POST /disagg/prefill` (prefill-tier engines only, 409 otherwise): the
  /generate body; runs the prompt to its first token and answers ONE JSON
  document with the token ids and, on finish reason "handoff", the wire
  form of the KV handoff record.
- `POST /disagg/import` (decode-tier engines only, 409 otherwise): body
  `{"record": <handoff wire dict>}`; imports the KV and streams the
  continuation as SSE in /generate's framing. A rejected record streams one
  error event with its `reason` and `retryable`.
- `POST /admin/swap`: body `{"checkpoint_folder": str, "generation": int?}`,
  forwarded to the wired `swap_handler` (the fleet's; it loads the folder
  and swaps through `engine.request_swap`); 503 when none is wired.
- `GET /healthz`: `{"status": "ok"|"degraded"|"draining", "weights_generation":
  int}`, plus `"slo_breaching"` (the breaching objectives' names) when an SLO
  engine is wired (`slo_status_fn`): "degraded" means serving but burning an
  objective, so a router prefers a clean peer; draining outranks it.
- `GET /stats`: one engine snapshot (taken under its stats lock) + the HTTP
  counters.
- `GET /metrics`: Prometheus text exposition of the engine's registry.

Graceful drain: `stop()` (or the engine's own `stop_fn`, e.g. the SIGTERM
flag) stops admission; in-flight requests finish and stream out; new POSTs
get 503; `serve_forever` returns the final stats.
"""

from __future__ import annotations

import asyncio
import json
import math
import queue
import threading
import time
from http import HTTPStatus
from typing import Callable, Optional

import torch

from modalities_tpu_torch.serving.resilience import DEADLINE_HEADER, TENANT_HEADER, resolve_deadline_ms
from modalities_tpu_torch.telemetry import get_active_telemetry, span
from modalities_tpu_torch.telemetry.metrics import CONTENT_TYPE_LATEST

_MAX_BODY_BYTES = 16 << 20  # refuse an absurd Content-Length before readexactly


async def read_http_request(reader: asyncio.StreamReader) -> Optional[tuple[str, str, dict, bytes]]:
    """Parse one HTTP/1.1 request from a stream: (method, path, headers, body).
    Returns None on EOF or a malformed request line (the caller just closes)."""
    try:
        request_line = await reader.readline()
        if not request_line:
            return None
        parts = request_line.decode("latin-1").strip().split()
        if len(parts) != 3:
            return None
        method, path, _version = parts
        headers: dict[str, str] = {}
        while True:
            line = await reader.readline()
            if not line or line in (b"\r\n", b"\n"):
                break
            key, _, value = line.decode("latin-1").partition(":")
            headers[key.strip().lower()] = value.strip()
        length = int(headers.get("content-length") or 0)
        if not 0 <= length <= _MAX_BODY_BYTES:
            return None
        body = await reader.readexactly(length) if length else b""
        return method, path, headers, body
    except (asyncio.IncompleteReadError, ConnectionError, ValueError):
        return None


def response_bytes(code: int, content_type: str, body: bytes, extra_headers: Optional[dict] = None) -> bytes:
    """A complete fixed-length HTTP/1.1 response (the connection closes after)."""
    phrase = HTTPStatus(code).phrase
    extra = "".join(f"{k}: {v}\r\n" for k, v in (extra_headers or {}).items())
    head = (
        f"HTTP/1.1 {code} {phrase}\r\n"
        f"Content-Type: {content_type}\r\n"
        f"Content-Length: {len(body)}\r\n"
        f"{extra}"
        "Connection: close\r\n\r\n"
    )
    return head.encode("latin-1") + body


def json_response_bytes(code: int, payload: dict, extra_headers: Optional[dict] = None) -> bytes:
    return response_bytes(code, "application/json", json.dumps(payload).encode(), extra_headers)


# a draining server tells clients to come back in 1 s: it is leaving, so
# clients should go elsewhere, not wait it out. Overload (429) rejections
# derive Retry-After from the engine's state instead (`_retry_after_header`).
RETRY_AFTER_S = "1"


def _retry_after_header(seconds: float) -> dict:
    """Retry-After carries integer seconds on the wire: the derived wait
    rounded UP (retrying early only earns another 429), at least 1."""
    return {"Retry-After": str(max(1, math.ceil(seconds)))}


SSE_HEADER_BYTES = (
    b"HTTP/1.1 200 OK\r\n"
    b"Content-Type: text/event-stream\r\n"
    b"Cache-Control: no-cache\r\n"
    b"Connection: close\r\n\r\n"
)


def sse_event_bytes(payload: dict) -> bytes:
    return f"data: {json.dumps(payload)}\n\n".encode()


class ServingHTTPServer:
    """Front end over a constructed ServingEngine.

    `encode(prompt) -> list[int]` / `decode(token_ids) -> str` bridge HTTP text
    to the engine's token ids (the serving component passes its tokenizer and
    prompt template through them)."""

    def __init__(
        self,
        engine,
        encode: Callable[[str], list],
        decode: Callable[[list], str],
        *,
        host: str = "127.0.0.1",
        port: int = 0,  # 0 = ephemeral; the bound port is self.port after start()
        default_max_new_tokens: int = 64,
        swap_handler: Optional[Callable[[dict], dict]] = None,
    ):
        self.engine = engine
        self._encode = encode
        self._decode = decode
        self._host = host
        self._port_req = int(port)
        self.port: Optional[int] = None
        self.default_max_new_tokens = int(default_max_new_tokens)
        # POST /admin/swap delegate: dict body -> dict result (None: 503)
        self.swap_handler = swap_handler
        # the SLO verdict hook (telemetry/slo.py): () -> the breaching
        # objectives' names; any turns /healthz "ok" into "degraded". None
        # keeps /healthz on its SLO-free shape
        self.slo_status_fn: Optional[Callable[[], list]] = None

        self._pending: queue.Queue = queue.Queue()  # (body dict, stream queue)
        self._streams: dict[int, queue.Queue] = {}  # rid -> stream (engine thread only)
        self._shutdown = False
        self._closing = False
        self.http_requests = 0
        self.http_rejected = 0
        self._m_http = engine.metrics.counter("serve_http_requests_total", "POST /generate requests received")
        self._m_http_rejected = engine.metrics.counter("serve_http_rejected_total",
                                                       "Generate requests rejected while draining")

        # the engine streams through us; its own stop_fn (e.g. the SIGTERM
        # flag) still counts, or'ed with the server's drain flag
        engine._on_token = self._on_token
        engine._on_finish = self._on_finish
        prior_stop = engine._stop_fn
        engine._stop_fn = lambda: self._shutdown or bool(prior_stop and prior_stop())

        self._loop: Optional[asyncio.AbstractEventLoop] = None
        self._aio_server = None
        self._loop_thread: Optional[threading.Thread] = None
        self._engine_thread: Optional[threading.Thread] = None
        self._engine_error: Optional[BaseException] = None

    # ------------------------------------------------------------- engine side
    def _on_token(self, rid: int, tok: int) -> None:
        stream = self._streams.get(rid)
        if stream is not None:
            stream.put(("token", int(tok)))

    def _on_finish(self, rid: int, result) -> None:
        stream = self._streams.pop(rid, None)
        if stream is not None:
            stream.put(("done", result))

    def _drain_pending(self, t0: float) -> int:
        drained = 0
        while True:
            try:
                body, stream = self._pending.get_nowait()
            except queue.Empty:
                return drained
            drained += 1
            try:
                if "disagg_record" in body:
                    self._import_pending(body, stream, t0)
                    continue
                prompt_tokens = self._encode(body["prompt"])
                rid = self.engine.submit(
                    prompt_tokens,
                    int(body.get("max_new_tokens") or self.default_max_new_tokens),
                    temperature=body.get("temperature"),
                    seed=int(body.get("seed") or 0),
                    arrival_offset_s=self.engine._now() - t0,
                    deadline_ms=resolve_deadline_ms(body.get("deadline_ms")),
                    priority=int(body.get("priority") or 0),
                    tenant=self.engine.resolve_submit_tenant(body.get("tenant")),
                    trace_id=body.get("trace_id") or None,
                    trace_hop=int(body.get("trace_hop") or 0),
                )
                self._streams[rid] = stream
                stream.put(("rid", rid))
            except Exception as exc:  # a bad prompt or parameter: surface it on the stream
                stream.put(("error", f"{type(exc).__name__}: {exc}"))

    def _import_pending(self, body: dict, stream: queue.Queue, t0: float) -> None:
        """A decode-tier import (POST /disagg/import), on the engine thread. A
        rejection streams back tagged with whether a replay through a fresh
        prefill can fix it: one on the current weights over a sound wire
        fixes a bad digest, a stale generation or a torn record; version,
        configuration or sampler skew is a deployment fault no replay fixes."""
        from modalities_tpu_torch.serving.disagg.handoff import HandoffRecord, HandoffRejected

        try:
            record = HandoffRecord.from_wire(body["disagg_record"])
            rid = self.engine.import_handoff(record, arrival_offset_s=self.engine._now() - t0,
                                             trace_id=body.get("trace_id") or None,
                                             trace_hop=int(body.get("trace_hop") or 0))
        except HandoffRejected as exc:
            stream.put(("error", {"error": exc.detail, "reason": exc.reason,
                                  "retryable": exc.reason in ("digest_mismatch", "generation_mismatch", "malformed")}))
            return
        self._streams[rid] = stream
        stream.put(("rid", rid))

    def _engine_loop(self) -> None:
        engine = self.engine
        if engine.device.type == "cuda":
            torch.cuda.set_device(engine.device)  # this thread launches every kernel
        t0 = engine._now()
        try:
            while True:
                drained = self._drain_pending(t0)
                stopping = engine._stopping()
                if stopping and engine._active_count() == 0:
                    break
                did = engine.step(t0)
                if not did and not drained:
                    if stopping:
                        break
                    time.sleep(0.002)  # idle: poll the submission queue
        except BaseException as exc:  # the engine failed: fail every open stream, then stop serving
            self._engine_error = exc
            self._shutdown = True
            for stream in list(self._streams.values()):
                stream.put(("error", f"engine failed: {type(exc).__name__}: {exc}"))
            self._streams.clear()
            raise
        finally:
            # anything still pending arrived after the drain decision: reject it
            while True:
                try:
                    _, stream = self._pending.get_nowait()
                except queue.Empty:
                    break
                self.http_rejected += 1
                self._m_http_rejected.inc()
                stream.put(("error", "server is draining"))
            get_active_telemetry().disarm_watchdog()  # the loop exited: nothing in flight

    # --------------------------------------------------------------- HTTP side
    @property
    def draining(self) -> bool:
        return self.engine._stopping()

    def submit_stream(self, body: dict, stream: queue.Queue) -> None:
        self._pending.put((body, stream))

    async def _relay_stream(self, stream: queue.Queue, writer: asyncio.StreamWriter) -> None:
        """Relay one request's engine stream out as SSE. The engine thread puts
        into `stream`; we poll it every 2 ms, so the event loop never blocks
        on a thread queue."""
        writer.write(SSE_HEADER_BYTES)
        try:
            while True:
                try:
                    kind, value = stream.get_nowait()
                except queue.Empty:
                    if self._closing:
                        return  # close() mid-stream: give the connection up
                    await asyncio.sleep(0.002)
                    continue
                if kind == "rid":
                    continue
                if kind == "token":
                    writer.write(sse_event_bytes({"token_id": value, "text": self._decode([value])}))
                    await writer.drain()
                elif kind == "done":
                    result = value
                    writer.write(sse_event_bytes({
                        "done": True,
                        "completion": self._decode(result.tokens),
                        "token_ids": list(result.tokens),
                        "finish_reason": result.finish_reason,
                        "truncated": result.truncated,
                        "prompt_len": result.prompt_len,
                        "ttft_s": result.ttft_s,
                        "weights_generation": result.weights_generation,
                        "trace_id": result.trace_id,
                    }))
                    await writer.drain()
                    return
                else:  # "error": dict payloads (import rejections) pass through
                    writer.write(sse_event_bytes(value if isinstance(value, dict) else {"error": value}))
                    await writer.drain()
                    return
        except (ConnectionError, BrokenPipeError):
            # the client went away mid-stream; the engine finishes the request
            # anyway (no cancellation path): its tokens drop here
            return

    async def _handle_generate(self, body_bytes: bytes, writer: asyncio.StreamWriter,
                               headers: Optional[dict] = None) -> None:
        with span("serve/http"):
            await self._generate(body_bytes, writer, headers)

    async def _generate(self, body_bytes: bytes, writer: asyncio.StreamWriter, headers: Optional[dict]) -> None:
        self.http_requests += 1
        self._m_http.inc()
        body = self._prompt_body(body_bytes, writer, headers)
        if body is None:
            return
        if self.engine.role != "combined":
            # a tier worker serves its tier endpoint only: a client here is
            # misrouted, not malformed
            writer.write(json_response_bytes(409, {
                "error": f"role={self.engine.role!r} worker: use /disagg/prefill (prefill tier) or /disagg/import "
                         "(decode tier) via the disagg router"}))
            return
        if self._reject_draining(writer) or self._reject_overload(writer, body):
            return
        stream: queue.Queue = queue.Queue()
        self.submit_stream(body, stream)
        await self._relay_stream(stream, writer)

    @staticmethod
    def _prompt_body(body_bytes: bytes, writer: asyncio.StreamWriter, headers: Optional[dict]) -> Optional[dict]:
        """The JSON body of a prompt request with the headers folded in
        (the trace id and hop, the deadline, re-anchored to this server's
        arrival clock, and the tenant; a body key wins), or None after a 400."""
        try:
            body = json.loads(body_bytes or b"{}")
            if headers and headers.get("x-trace-id"):
                body.setdefault("trace_id", headers["x-trace-id"])
                body.setdefault("trace_hop", headers.get("x-trace-hop") or 0)
            if headers and headers.get(DEADLINE_HEADER):
                body.setdefault("deadline_ms", headers[DEADLINE_HEADER])
            if headers and headers.get(TENANT_HEADER):
                body.setdefault("tenant", headers[TENANT_HEADER])
            prompt = body.get("prompt")
            if not isinstance(prompt, str) or not prompt:
                writer.write(json_response_bytes(400, {"error": "body needs a non-empty 'prompt'"}))
                return None
            return body
        except (ValueError, json.JSONDecodeError, AttributeError) as exc:
            writer.write(json_response_bytes(400, {"error": f"bad JSON body: {exc}"}))
            return None

    def _reject_draining(self, writer: asyncio.StreamWriter) -> bool:
        if not self.draining:
            return False
        self.http_rejected += 1
        self._m_http_rejected.inc()
        writer.write(json_response_bytes(503, {"error": "server is draining"}, {"Retry-After": RETRY_AFTER_S}))
        return True

    def _reject_overload(self, writer: asyncio.StreamWriter, body: dict) -> bool:
        """429 + Retry-After when the engine refuses new work: the bounded
        queue is full, the brownout controller is active, or the request's
        tenant is over its token rate. Retry-After is derived: a queue-drain
        estimate for global overload, the bucket's refill time for a tenant's
        rate limit. The engine counts the rejection on `serve_shed_total`
        (and `serve_tenant_shed_total`)."""
        tenant = self.engine.resolve_submit_tenant(body.get("tenant"))
        reason = self.engine.overload_reason()
        if reason is not None:
            retry_after = self.engine.retry_after_s(reason)
        else:
            limited = self.engine.tenant_reject_reason(
                tenant, int(body.get("max_new_tokens") or self.default_max_new_tokens))
            if limited is None:
                return False
            reason, retry_after = limited
        self.http_rejected += 1
        self._m_http_rejected.inc()
        self.engine.note_rejected(reason, tenant=tenant)
        writer.write(json_response_bytes(429, {"error": f"overloaded ({reason}), retry later", "reason": reason},
                                         _retry_after_header(retry_after)))
        return True

    def _wrong_tier(self, path: str, tier: str, writer: asyncio.StreamWriter) -> bool:
        if self.engine.role == tier:
            return False
        writer.write(json_response_bytes(409, {"error": f"role={self.engine.role!r}: {path} needs a {tier}-tier worker"}))
        return True

    async def _await_result(self, stream: queue.Queue):
        """The engine's ("done", result) or ("error", payload) for a stream
        whose tokens ride inside the result; None when close() gives up."""
        while True:
            try:
                kind, value = stream.get_nowait()
            except queue.Empty:
                if self._closing:
                    return None
                await asyncio.sleep(0.002)
                continue
            if kind in ("done", "error"):
                return kind, value

    async def _handle_disagg_prefill(self, body_bytes: bytes, writer: asyncio.StreamWriter,
                                     headers: Optional[dict] = None) -> None:
        """The prefill-tier leg: run the prompt to its first token and answer
        ONE JSON document: the token ids (0 or 1 of them), the finish reason
        and, on "handoff", the wire form of the sealed record the router ships
        to a decode worker."""
        with span("serve/http"):
            await self._disagg_prefill(body_bytes, writer, headers)

    async def _disagg_prefill(self, body_bytes: bytes, writer: asyncio.StreamWriter, headers: Optional[dict]) -> None:
        self.http_requests += 1
        self._m_http.inc()
        if self._wrong_tier("/disagg/prefill", "prefill", writer):
            return
        body = self._prompt_body(body_bytes, writer, headers)
        if body is None or self._reject_draining(writer) or self._reject_overload(writer, body):
            return
        stream: queue.Queue = queue.Queue()
        self.submit_stream(body, stream)
        got = await self._await_result(stream)
        if got is None:
            return
        kind, value = got
        if kind == "error":
            writer.write(json_response_bytes(500, value if isinstance(value, dict) else {"error": value}))
            return
        result = value
        record = result.handoff
        # the record's base64 is the body's bulk: encode it off the event loop
        wire = await asyncio.get_running_loop().run_in_executor(None, record.to_wire) if record is not None else None
        writer.write(json_response_bytes(200, {
            "rid": result.rid,
            "finish_reason": result.finish_reason,
            "token_ids": list(result.tokens),
            "completion": self._decode(result.tokens),
            "truncated": result.truncated,
            "prompt_len": result.prompt_len,
            "ttft_s": result.ttft_s,
            "weights_generation": result.weights_generation,
            "trace_id": result.trace_id,
            "record": wire,
        }))

    async def _handle_disagg_import(self, body_bytes: bytes, writer: asyncio.StreamWriter,
                                    headers: Optional[dict] = None) -> None:
        """The decode-tier leg: import the posted record and stream the
        continuation as SSE in /generate's framing, so the router's relay
        loop serves both. The deadline rides inside the record."""
        with span("serve/http"):
            await self._disagg_import(body_bytes, writer, headers)

    async def _disagg_import(self, body_bytes: bytes, writer: asyncio.StreamWriter, headers: Optional[dict]) -> None:
        self.http_requests += 1
        self._m_http.inc()
        if self._wrong_tier("/disagg/import", "decode", writer):
            return
        try:
            body = json.loads(body_bytes or b"{}")
            if headers and headers.get("x-trace-id"):
                body.setdefault("trace_id", headers["x-trace-id"])
                body.setdefault("trace_hop", headers.get("x-trace-hop") or 0)
            record = body.get("record")
        except (ValueError, json.JSONDecodeError, AttributeError) as exc:
            writer.write(json_response_bytes(400, {"error": f"bad JSON body: {exc}"}))
            return
        if not isinstance(record, dict):
            writer.write(json_response_bytes(400, {"error": "body needs a 'record' object"}))
            return
        if self._reject_draining(writer):
            return
        body["disagg_record"] = record
        stream: queue.Queue = queue.Queue()
        self.submit_stream(body, stream)
        await self._relay_stream(stream, writer)

    async def _handle_admin_swap(self, body_bytes: bytes, writer: asyncio.StreamWriter) -> None:
        if self.swap_handler is None:
            writer.write(json_response_bytes(503, {"error": "no swap handler wired"}))
            return
        try:
            body = json.loads(body_bytes or b"{}")
        except (ValueError, json.JSONDecodeError) as exc:
            writer.write(json_response_bytes(400, {"error": f"bad JSON body: {exc}"}))
            return
        try:
            # a checkpoint load and the swap's wait take seconds: off the loop
            result = await asyncio.get_running_loop().run_in_executor(None, self.swap_handler, body)
            writer.write(json_response_bytes(200, {"ok": True, **(result or {})}))
        except Exception as exc:
            writer.write(json_response_bytes(500, {"error": f"{type(exc).__name__}: {exc}"}))

    async def _handle(self, reader: asyncio.StreamReader, writer: asyncio.StreamWriter) -> None:
        try:
            req = await read_http_request(reader)
            if req is None:
                return
            method, path, headers, body_bytes = req
            if method == "GET" and path == "/healthz":
                health = {"status": "draining" if self.draining else "ok",
                          "weights_generation": self.engine.weights_generation}
                if self.slo_status_fn is not None:
                    breaching = list(self.slo_status_fn())
                    health["slo_breaching"] = breaching
                    if breaching and health["status"] == "ok":
                        # degraded is not unhealthy: it still serves, but a
                        # router prefers clean peers while the breach lasts
                        health["status"] = "degraded"
                writer.write(json_response_bytes(200, health))
            elif method == "GET" and path == "/stats":
                stats = dict(self.engine.stats())
                stats["http_requests"] = self.http_requests
                stats["http_rejected"] = self.http_rejected
                stats["draining"] = self.draining
                writer.write(json_response_bytes(200, stats))
            elif method == "GET" and path == "/metrics":
                writer.write(response_bytes(200, CONTENT_TYPE_LATEST, self.engine.metrics.render().encode("utf-8")))
            elif method == "POST" and path == "/generate":
                await self._handle_generate(body_bytes, writer, headers)
            elif method == "POST" and path == "/disagg/prefill":
                await self._handle_disagg_prefill(body_bytes, writer, headers)
            elif method == "POST" and path == "/disagg/import":
                await self._handle_disagg_import(body_bytes, writer, headers)
            elif method == "POST" and path == "/admin/swap":
                await self._handle_admin_swap(body_bytes, writer)
            else:
                writer.write(json_response_bytes(404, {"error": f"unknown path {path}"}))
            await writer.drain()
        except (ConnectionError, BrokenPipeError):
            pass
        finally:
            try:
                writer.close()
                await writer.wait_closed()
            except (ConnectionError, BrokenPipeError):
                pass

    # ------------------------------------------------------------- lifecycle
    def _loop_main(self, started: threading.Event) -> None:
        loop = asyncio.new_event_loop()
        self._loop = loop
        asyncio.set_event_loop(loop)

        async def _bind():
            self._aio_server = await asyncio.start_server(self._handle, self._host, self._port_req)
            self.port = self._aio_server.sockets[0].getsockname()[1]

        try:
            loop.run_until_complete(_bind())
        finally:
            started.set()  # start() unblocks even when the bind failed
        loop.run_forever()
        # close() stopped the loop: cancel stragglers and shut down cleanly
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

    def start(self) -> None:
        started = threading.Event()
        self._engine_thread = threading.Thread(target=self._engine_loop, name="serve-engine", daemon=True)
        self._loop_thread = threading.Thread(target=self._loop_main, args=(started,), name="serve-http", daemon=True)
        self._engine_thread.start()
        self._loop_thread.start()
        started.wait(10.0)
        if self.port is None:
            raise RuntimeError(f"HTTP front end failed to bind {self._host}:{self._port_req}")

    def stop(self) -> None:
        """Request a graceful drain: stop admitting, let in-flight finish."""
        self._shutdown = True

    def serve_forever(self, poll_s: float = 0.1) -> dict:
        """Block until the engine loop exits (stop() or stop_fn drain), then
        shut the listener down and return the final engine stats. Raises what
        the engine thread raised, if it failed."""
        try:
            while self._engine_thread.is_alive():
                self._engine_thread.join(poll_s)
        finally:
            self.close()
        if self._engine_error is not None:
            raise RuntimeError("the serving engine failed") from self._engine_error
        return self.engine.stats()

    def close(self) -> None:
        self._shutdown = True
        self._closing = True
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
        if self._engine_thread is not None and self._engine_thread.is_alive():
            self._engine_thread.join(5.0)

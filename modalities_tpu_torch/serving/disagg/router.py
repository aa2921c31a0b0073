"""DisaggRouter: two-leg dispatch over a tiered fleet, the port of
modalities_tpu/serving/disagg/router.py.

It extends the flat FleetRouter (serving/fleet/router.py) with the
disaggregated request: `POST /generate` becomes

    the prefill leg: POST /disagg/prefill on a prefill-tier worker; ONE JSON
                     answer with token #1 and the handoff record's wire form
    the decode leg:  POST /disagg/import on a decode-tier worker; the SSE
                     stream of tokens #2.. relayed to the client

and the client still sees ONE SSE answer: the router sends the prefill
token as the first event, relays the decode stream behind it and merges the
prefill token into the final `done` event. `X-Trace-Id` rides every leg, the
hop counting up a leg.

Failover by tier:
- the prefill leg dies (refused, or past ``MODALITIES_TPU_DISAGG_HANDOFF_TIMEOUT_S``):
  the worker leaves rotation and another prefill worker retries; nothing
  was streamed, so the replay is exact.
- the decode leg dies mid-stream (or never answers): the decode worker
  leaves rotation and the request REPLAYS through a fresh prefill, the
  same trace id, and the splice skips what the client has (the prefill's
  token #1; the new decode stream starts at overall position 2 through
  `stream_offset`).
- the decode worker REJECTS the import (a digest or generation mismatch, a
  torn record): the worker is sound, the record is not; it stays in
  rotation and the request replays through a fresh prefill, which exports
  on the current generation.

Every replay spends a retry token. A decode worker's server refuses a
request body over 16 MiB by closing the connection (serving/server.py
`_MAX_BODY_BYTES`), so an import whose record's base64 passes that limit
is the second case: the decode worker counts as dead (`peer_down`) and the
request replays until no decode worker is left or the retry budget runs dry.

The JAX router also turns sustained SLO breach into `fleet/tier_pressure`
recommendations; the port's workers report no breach before the SLO engine
(ROADMAP.md Queue 1 item 6), so here only a dead worker raises it.
"""

from __future__ import annotations

import asyncio
import json
import logging
import os
import time
from typing import Optional

from modalities_tpu_torch.resilience.events import record_event
from modalities_tpu_torch.serving.fleet.router import (
    FleetRouter,
    WorkerHandle,
    _ClientGone,
    _close,
    _leg_head,
    _read_response_head,
)
from modalities_tpu_torch.serving.server import RETRY_AFTER_S, SSE_HEADER_BYTES, json_response_bytes, sse_event_bytes

logger = logging.getLogger(__name__)


def _handoff_timeout_s() -> float:
    """The prefill leg's deadline: a long prompt's prefill takes real time,
    but a wedged prefill worker must not hold the client forever."""
    return float(os.environ.get("MODALITIES_TPU_DISAGG_HANDOFF_TIMEOUT_S", "30.0"))


class DisaggRouter(FleetRouter):
    """FleetRouter over a prefill tier and a decode tier (the module docstring)."""

    def __init__(self, prefill_workers: list[WorkerHandle], decode_workers: list[WorkerHandle], **kwargs):
        if not prefill_workers or not decode_workers:
            raise ValueError("DisaggRouter needs >= 1 worker in EACH tier")
        for w in prefill_workers:
            w.tier = "prefill"
        for w in decode_workers:
            w.tier = "decode"
        super().__init__(list(prefill_workers) + list(decode_workers), **kwargs)
        self.handoff_timeout_s = _handoff_timeout_s()
        # the reasons no engine can see (a decode peer that died before
        # answering), and the rejected-import reasons relayed off decode workers
        self._m_handoff_failures = self.metrics.counter(
            "disagg_handoff_failures_total",
            "Handoff legs that failed at the router, by reason (peer_down, "
            "and rejected-import reasons relayed off decode workers)")
        self._tier_pressure_seen: dict[str, bool] = {}

    def _after_health_round(self) -> None:
        """A tier is under pressure while any of its workers is SLO-breaching
        (degraded) or dead; each transition emits ONE `fleet/tier_pressure`
        event naming the tier to grow (action "hold" on recovery)."""
        for tier in ("prefill", "decode"):
            members = [w for w in self.workers if w.tier == tier]
            breaching = sorted({name for w in members if w.degraded for name in w.slo_breaching})
            unhealthy = sorted(w.name for w in members if not w.healthy)
            healthy = sum(1 for w in members if w.healthy)
            pressure = bool(breaching or unhealthy)
            was = self._tier_pressure_seen.get(tier, False)
            if pressure != was:
                if pressure:
                    logger.warning("disagg router: grow tier %s (breaching=%s unhealthy=%s)", tier, breaching,
                                   unhealthy)
                record_event("fleet/tier_pressure", tier=tier, action="grow" if pressure else "hold",
                             breaching=breaching, unhealthy=unhealthy, workers_healthy=healthy,
                             workers_total=len(members))
            self._tier_pressure_seen[tier] = pressure

    async def _prefill_leg(self, worker: WorkerHandle, body_bytes: bytes, state: dict) -> Optional[dict]:
        """One POST /disagg/prefill round trip: {"status", "body"}, or None
        when the worker is unreachable or timed out (the caller fails over).
        The tenant rides this leg as a header; the decode leg gets it inside
        the record."""
        try:
            reader, writer = await asyncio.wait_for(asyncio.open_connection(worker.host, worker.port),
                                                    self.connect_timeout_s)
        except (OSError, asyncio.TimeoutError):
            return None
        try:
            writer.write(_leg_head("/disagg/prefill", worker, state, len(body_bytes)) + body_bytes)
            await writer.drain()

            async def _read():
                status, headers = await _read_response_head(reader)
                length = headers.get("content-length")
                return status, await (reader.readexactly(int(length)) if length else reader.read())

            status, body = await asyncio.wait_for(_read(), self.handoff_timeout_s)
            return {"status": status, "body": json.loads(body or b"{}")}
        except (ConnectionError, asyncio.TimeoutError, asyncio.IncompleteReadError, OSError, ValueError):
            return None
        finally:
            await _close(writer)

    def _fail_worker(self, worker: WorkerHandle, state: dict, reason: Optional[str] = None) -> None:
        super()._fail_worker(worker, state, reason)
        self._m_handoff_failures.inc(reason=reason or "peer_down")

    async def _proxy_generate(self, body_bytes: bytes, client_writer, headers: Optional[dict] = None) -> None:
        self.http_requests += 1
        if self._shutdown:
            client_writer.write(json_response_bytes(503, {"error": "router is draining"},
                                                    {"Retry-After": RETRY_AFTER_S}))
            return
        state = self._new_state(headers)
        trace_id = state["trace_id"]
        t_arrival = time.monotonic()
        self._active_relays += 1

        async def send_client(data: bytes) -> None:
            try:
                client_writer.write(data)
                await client_writer.drain()
            except (ConnectionError, OSError) as exc:
                raise _ClientGone() from exc

        async def no_workers(which: str) -> None:
            await self._send_error(client_writer, state, {"error": f"no healthy {which} workers", "trace_id": trace_id})

        try:
            for _attempt in range(len(self.workers) + 1):
                # ------------------------------------------- the prefill leg
                pworker = self._pick(set(), tier="prefill")
                if pworker is None:
                    await no_workers("prefill")
                    return
                resp = await self._prefill_leg(pworker, body_bytes, state)
                state["hop"] += 1
                if resp is None:
                    self._fail_worker(pworker, state, "peer_down")
                    if not await self._retry_allowed(client_writer, state, pworker.name):
                        return
                    continue
                pbody = resp["body"]
                if resp["status"] != 200:
                    # an engine-side refusal (a bad prompt, the wrong role, a
                    # drain): deterministic, surfaced, not retried
                    await send_client(sse_event_bytes(pbody) if state["headers_sent"]
                                      else json_response_bytes(resp["status"], pbody))
                    return
                self._record_worker_result(pworker, ok=True)
                token_ids = [int(t) for t in (pbody.get("token_ids") or [])]
                completion = pbody.get("completion") or ""
                # token #1 to the client now (a replay skips it: the splice
                # counter says the client has it)
                if not state["headers_sent"]:
                    await send_client(SSE_HEADER_BYTES)
                    state["headers_sent"] = True
                for i, tok in enumerate(token_ids):
                    if i < state["forwarded"]:
                        continue
                    await send_client(sse_event_bytes({"token_id": tok, "text": completion}))
                    state["forwarded"] += 1
                if pbody.get("finish_reason") != "handoff" or not pbody.get("record"):
                    # the prefill tier finished the request (eod, a budget of
                    # one, an error): the prefill leg is the whole answer
                    await send_client(sse_event_bytes({
                        "done": True, "completion": completion, "token_ids": token_ids,
                        "finish_reason": pbody.get("finish_reason"), "truncated": bool(pbody.get("truncated")),
                        "prompt_len": int(pbody.get("prompt_len") or 0), "ttft_s": pbody.get("ttft_s"),
                        "weights_generation": int(pbody.get("weights_generation") or 0), "trace_id": trace_id}))
                    return
                # -------------------------------------------- the decode leg
                dworker = self._pick(set(), tier="decode")
                if dworker is None:
                    await no_workers("decode")
                    return
                import_body = json.dumps({"record": pbody["record"], "trace_id": trace_id,
                                          "trace_hop": state["hop"]}).encode()

                def merge_done(event, _toks=tuple(token_ids), _text=completion):
                    if event.get("retryable"):
                        # a rejected import: the worker is sound, the record
                        # is not; replay through a fresh prefill
                        state["reject_reason"] = event.get("reason") or "rejected"
                        return None
                    if event.get("done"):
                        event = dict(event)
                        event["token_ids"] = list(_toks) + list(event.get("token_ids") or [])
                        event["completion"] = _text + (event.get("completion") or "")
                        event["trace_id"] = trace_id
                    return event

                leg = await self._relay_from_worker(dworker, import_body, client_writer, state,
                                                    path="/disagg/import", stream_offset=len(token_ids),
                                                    done_transform=merge_done)
                state["hop"] += 1
                if leg == "done":
                    self._record_worker_result(dworker, ok=True)
                    return
                reject = state.pop("reject_reason", None)
                if reject is not None:
                    self._m_handoff_failures.inc(reason=reject)
                    record_event("fleet/handoff_rejected", worker=dworker.name, reason=reject, trace_id=trace_id)
                    if not await self._retry_allowed(client_writer, state, dworker.name):
                        return
                    continue  # the decode worker stays in rotation
                self._fail_worker(dworker, state, "peer_down")
                if not await self._retry_allowed(client_writer, state, dworker.name):
                    return
                # loop: a fresh prefill on a healthy pair, the SAME trace id
            await no_workers("pair")
        except _ClientGone:
            return
        finally:
            self._active_relays -= 1
            self._m_e2e.observe(time.monotonic() - t_arrival, exemplar=trace_id)

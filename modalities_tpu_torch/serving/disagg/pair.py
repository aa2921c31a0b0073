"""In-process prefill + decode pair: two ServingEngines driven by one loop,
the port of modalities_tpu/serving/disagg/pair.py.

It drives both engines' `step()` off ONE clock and hands `HandoffRecord`s
across by reference (serialization is the HTTP legs' business): a prefill
result that finished "handoff" becomes an `import_handoff()` on the decode
tier, its `arrival_offset_s` stamped at the handoff, so the decode engine's
`disagg_handoff_seconds` measures handoff -> slot seeded.

`step_hook(pair, dispatched)` fires after every round; `on_idle(wait_s)`
replaces the sleep while waiting for an arrival (for stepped clocks).
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Callable, Optional

from modalities_tpu_torch.serving.engine import ServeResult


@dataclass
class PairResult:
    """One request's merged view: its first token came off the prefill tier in
    the handoff, the rest from the decode tier. `tokens` is what a client of
    the combined engine gets."""

    rid: int  # the prefill side's rid (the pair's handle)
    tokens: list[int] = field(default_factory=list)
    finish_reason: str = ""
    trace_id: str = ""
    prefill: Optional[ServeResult] = None
    decode: Optional[ServeResult] = None  # None where the prefill tier finished the request

    @property
    def ttft_s(self) -> float:
        """End to end: prefill arrival to the first token (the prefill tier's)."""
        return self.prefill.ttft_s


class DisaggPair:
    """A `role="prefill"` engine and a `role="decode"` engine as one serving
    surface: `submit()` takes the combined engine's arguments, `run()`
    returns prefill rid -> PairResult. The engines must keep their results
    (no `on_finish` callback)."""

    def __init__(self, prefill, decode, *, time_fn: Optional[Callable[[], float]] = None,
                 step_hook: Optional[Callable[["DisaggPair", bool], None]] = None,
                 on_idle: Optional[Callable[[float], None]] = None):
        if prefill.role != "prefill" or decode.role != "decode":
            raise ValueError(f"DisaggPair needs (prefill, decode) roles, got ({prefill.role!r}, {decode.role!r})")
        self.prefill = prefill
        self.decode = decode
        self._now = time_fn if time_fn is not None else time.monotonic
        self._step_hook = step_hook
        self._on_idle = on_idle if on_idle is not None else time.sleep
        self._handled: set[int] = set()  # prefill rids already harvested
        self._imported: dict[int, int] = {}  # prefill rid -> decode rid
        self.handoff_failures: list[tuple[int, str]] = []  # (prefill rid, reason)

    def submit(self, *args, **kwargs) -> int:
        return self.prefill.submit(*args, **kwargs)

    def _harvest_handoffs(self, t0: float) -> None:
        """Move freshly finished prefill results across the tier boundary."""
        for rid, res in list(self.prefill._results.items()):
            if rid in self._handled:
                continue
            self._handled.add(rid)
            if res.finish_reason != "handoff":
                continue  # eod, budget or error at prefill: the whole answer
            try:
                drid = self.decode.import_handoff(res.handoff, arrival_offset_s=self._now() - t0,
                                                  trace_id=res.trace_id, trace_hop=res.trace_hop + 1)
            except Exception as exc:  # HandoffRejected: recorded, not fatal
                self.handoff_failures.append((rid, getattr(exc, "reason", "error")))
                continue
            self._imported[rid] = drid

    def _pending(self) -> bool:
        return bool(self.prefill._queue or self.prefill._active_count() or self.decode._queue
                    or self.decode._active_count())

    def run(self) -> dict[int, PairResult]:
        t0 = self._now()
        while True:
            did = self.prefill.step(t0)
            self._harvest_handoffs(t0)
            did = self.decode.step(t0) or did
            if self._step_hook is not None:
                self._step_hook(self, did)
            if not self._pending():
                break
            if not did:
                # nothing runs anywhere: wait for the earliest queued arrival
                heads = [q[0].arrival_offset_s for q in (self.prefill._queue, self.decode._queue) if q]
                if not heads:
                    continue
                wait = min(heads) - (self._now() - t0)
                if wait > 0:
                    self._on_idle(min(wait, 0.05))
        return self.results()

    def results(self) -> dict[int, PairResult]:
        out: dict[int, PairResult] = {}
        for rid, pres in self.prefill._results.items():
            merged = PairResult(rid=rid, tokens=list(pres.tokens), finish_reason=pres.finish_reason,
                                trace_id=pres.trace_id, prefill=pres)
            drid = self._imported.get(rid)
            if drid is not None and drid in self.decode._results:
                dres = self.decode._results[drid]
                merged.decode = dres
                merged.tokens += list(dres.tokens)
                merged.finish_reason = dres.finish_reason
            out[rid] = merged
        return out

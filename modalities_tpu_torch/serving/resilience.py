"""Serving-side admission control: deadlines, tenants with weighted
deficit-round-robin, token-rate limits and brownout shedding, and the fleet
routers' failure handling. The port of modalities_tpu/serving/resilience.py.

Consumed by the engine's scheduler (serving/engine.py) and the HTTP front end
(serving/server.py):

- **Deadlines** ride requests: the client sends ``X-Deadline-Ms`` (or the
  per-process default below applies), the header is folded into the request
  body, and the engine cancels the request at the next scheduler boundary
  once it expires (finish reason ``"deadline"``, its slot and blocks freed).
  A deadline is measured from the request's LOCAL arrival.
- **Tenants.** A request's tenant id rides ``X-Tenant-Id`` the same way;
  :func:`resolve_tenant` applies the explicit > env default resolution at
  both ingresses (HTTP and JSONL). :class:`TenantRegistry` holds the
  declared :class:`TenantSpec` rows (class, weight, slot quota, token-rate
  limit) plus one :class:`TokenBucket` per rate-limited tenant; the engine
  uses it for weighted deficit-round-robin admission and burn-aware victim
  selection, the HTTP layer for per-tenant 429s whose ``Retry-After`` is the
  bucket's refill time.
- :class:`BrownoutController`, an overload state machine on queue depth:
  at or over ``queue_high`` the engine sheds the lowest-priority queued
  requests down to ``queue_low`` (finish reason ``"shed"``) and the HTTP
  layer rejects new work with 429 + ``Retry-After``. Recovery needs the
  signal clear AND the queue at or below ``queue_low`` (hysteresis). With
  ``breaching_fn`` (the SLO engine's burn signal, serving/serve.py) it also
  trips while an objective breaches; without ``queue_high`` the burn signal
  alone drives it.
- The fleet routers' primitives (serving/fleet/router.py,
  serving/disagg/router.py): a :class:`CircuitBreaker` per worker, one
  shared :class:`RetryBudget` funded by successful requests
  (``MODALITIES_TPU_FLEET_RETRY_BUDGET_RATIO``), and a :class:`ProbeBackoff`
  per dead worker (``MODALITIES_TPU_FLEET_PROBE_BACKOFF_MAX_S``).

Everything here is plain host-side Python: nothing touches a tensor.
"""

from __future__ import annotations

import os
import random
import threading
import time
from typing import Callable, Optional

# header name as read_http_request lowercases it
DEADLINE_HEADER = "x-deadline-ms"


def default_deadline_ms() -> Optional[float]:
    """Per-process default request deadline (``MODALITIES_TPU_SERVE_DEADLINE_DEFAULT_MS``,
    0 = no default). Applied only when the client sent no deadline."""
    raw = os.environ.get("MODALITIES_TPU_SERVE_DEADLINE_DEFAULT_MS", "0")
    value = float(raw)
    return value if value > 0 else None


def resolve_deadline_ms(value) -> Optional[float]:
    """Client-supplied deadline (header/body, may be None/unparseable) or the
    env default; non-positive values disable the deadline explicitly."""
    if value is None:
        return default_deadline_ms()
    try:
        ms = float(value)
    except (TypeError, ValueError):
        return default_deadline_ms()
    return ms if ms > 0 else None


def deadline_expired(arrival_s: float, deadline_ms: Optional[float], now_s: float) -> bool:
    """True once ``deadline_ms`` elapsed since the request's local arrival."""
    if deadline_ms is None:
        return False
    return (now_s - max(arrival_s, 0.0)) * 1000.0 >= deadline_ms


# header name as read_http_request lowercases it
TENANT_HEADER = "x-tenant-id"


def default_tenant() -> str:
    """Per-process default tenant id (``MODALITIES_TPU_SERVE_TENANT_DEFAULT``)
    applied when the client sent none."""
    return os.environ.get("MODALITIES_TPU_SERVE_TENANT_DEFAULT", "").strip() or "default"


def resolve_tenant(value) -> str:
    """Client-supplied tenant id (header/body, may be None/blank) or the env
    default, applied identically at the HTTP and JSONL ingresses."""
    if value is None:
        return default_tenant()
    name = str(value).strip()
    return name or default_tenant()


class TenantSpec:
    """One declared tenant: scheduling class, DRR weight, slot quota, and an
    optional token-rate limit.

    ``tenant_class`` is ``"interactive"`` or ``"bulk"``: bulk tenants are the
    preferred victims of every destructive choice (shed, preempt).
    ``weight`` is the DRR quantum (admissions per round relative to peers).
    ``max_slots`` caps concurrently held batch slots (None = no quota).
    ``rate`` is a sustained new-token budget in tokens/second enforced by a
    :class:`TokenBucket` at the HTTP ingress (None = unlimited); ``burst``
    is the bucket depth (defaults to one second of rate, floor 1)."""

    CLASSES = ("interactive", "bulk")

    def __init__(
        self,
        name: str,
        tenant_class: str = "interactive",
        weight: float = 1.0,
        max_slots: Optional[int] = None,
        rate: Optional[float] = None,
        burst: Optional[float] = None,
    ):
        if tenant_class not in self.CLASSES:
            raise ValueError(f"tenant {name!r}: class must be one of {self.CLASSES}, got {tenant_class!r}")
        if weight < 1:
            raise ValueError(f"tenant {name!r}: weight must be >= 1, got {weight}")
        if max_slots is not None and int(max_slots) < 1:
            raise ValueError(f"tenant {name!r}: max_slots must be >= 1, got {max_slots}")
        if rate is not None and float(rate) <= 0:
            raise ValueError(f"tenant {name!r}: rate must be > 0 tokens/s, got {rate}")
        self.name = str(name)
        self.tenant_class = tenant_class
        self.weight = float(weight)
        self.max_slots = int(max_slots) if max_slots is not None else None
        self.rate = float(rate) if rate is not None else None
        if burst is None:
            burst = max(self.rate, 1.0) if self.rate is not None else 1.0
        self.burst = float(burst)

    @property
    def is_bulk(self) -> bool:
        return self.tenant_class == "bulk"


class TokenBucket:
    """Token-rate limiter with a refill-derived retry hint.

    ``try_take(n, now)`` withdraws ``n`` tokens or refuses (never partial);
    ``retry_after_s(n, now)`` is the exact time until ``n`` tokens will have
    refilled. The caller supplies ``now`` (the engine's clock), so fake-clock
    tests and the real ingress share one code path."""

    def __init__(self, rate: float, burst: float):
        if rate <= 0 or burst <= 0:
            raise ValueError(f"TokenBucket needs rate > 0 and burst > 0, got ({rate}, {burst})")
        self.rate = float(rate)
        self.burst = float(burst)
        self.tokens = self.burst
        self._last = None  # the first call pins the clock origin
        self._lock = threading.Lock()

    def _refill(self, now: float) -> None:
        if self._last is None:
            self._last = now
        elapsed = max(now - self._last, 0.0)
        self._last = now
        self.tokens = min(self.burst, self.tokens + elapsed * self.rate)

    def try_take(self, n: float, now: float) -> bool:
        with self._lock:
            self._refill(now)
            if self.tokens >= n:
                self.tokens -= n
                return True
            return False

    def retry_after_s(self, n: float, now: float) -> float:
        """Seconds until ``n`` tokens are available (0 when they already are).
        A demand beyond the bucket depth reports the full-burst refill time:
        finite, so the client retries a smaller request rather than never."""
        with self._lock:
            self._refill(now)
            need = min(n, self.burst) - self.tokens
            return max(need, 0.0) / self.rate


class TenantRegistry:
    """The declared tenants of one serving process: specs by name plus one
    rate-limit bucket per tenant that declared a ``rate``.

    Built from the ``tenants:`` config block (``from_config``). Undeclared
    tenant ids resolve to a default spec (interactive, weight 1, no quota,
    no rate limit). Iteration order is sorted by name, so the DRR rotation
    is deterministic."""

    def __init__(self, specs: Optional[dict] = None):
        self._specs: dict[str, TenantSpec] = dict(specs or {})
        self._buckets: dict[str, TokenBucket] = {
            name: TokenBucket(spec.rate, spec.burst) for name, spec in self._specs.items() if spec.rate is not None
        }

    @classmethod
    def from_config(cls, block: dict) -> "TenantRegistry":
        """Parse the ``tenants:`` config block: ``{name: {class, weight,
        max_slots, rate, burst}}`` with every per-tenant key optional."""
        specs = {}
        for name, raw in (block or {}).items():
            raw = dict(raw or {})
            unknown = set(raw) - {"class", "weight", "max_slots", "rate", "burst"}
            if unknown:
                raise ValueError(f"tenant {name!r}: unknown keys {sorted(unknown)}")
            specs[str(name)] = TenantSpec(
                str(name),
                tenant_class=raw.get("class") or "interactive",
                weight=float(raw.get("weight") or 1.0),
                max_slots=raw.get("max_slots"),
                rate=raw.get("rate"),
                burst=raw.get("burst"),
            )
        return cls(specs)

    def spec(self, name: str) -> TenantSpec:
        known = self._specs.get(name)
        return known if known is not None else TenantSpec(name)

    def names(self) -> list[str]:
        return sorted(self._specs)

    def rate_limit_retry_after_s(self, name: str, tokens: float, now: float) -> Optional[float]:
        """None when ``tokens`` were admitted (and charged); otherwise the
        refill-derived seconds until this tenant's bucket can admit them."""
        bucket = self._buckets.get(name)
        if bucket is None or bucket.try_take(tokens, now):
            return None
        return bucket.retry_after_s(tokens, now)


class BrownoutController:
    """Two-state overload machine: ``ok`` <-> ``brownout`` (see module doc).

    ``update(queue_depth)`` is called once per scheduler round by the engine;
    ``shed_target(queue_depth)`` says how many queued requests to shed this
    round (down to ``queue_low``). With no ``breaching_fn`` it is purely
    queue-driven."""

    def __init__(
        self,
        breaching_fn: Optional[Callable[[], bool]] = None,
        *,
        queue_high: Optional[int] = None,
        queue_low: Optional[int] = None,
    ):
        if breaching_fn is None and queue_high is None:
            raise ValueError("BrownoutController needs breaching_fn or queue_high")
        self.breaching_fn = breaching_fn
        self.queue_high = queue_high
        if queue_low is None:
            queue_low = queue_high // 2 if queue_high is not None else 0
        self.queue_low = queue_low
        self.state = "ok"
        self.transitions = 0

    def _signal(self, queue_depth: int) -> bool:
        slo = bool(self.breaching_fn()) if self.breaching_fn is not None else False
        pressure = self.queue_high is not None and queue_depth >= self.queue_high
        return slo or pressure

    def update(self, queue_depth: int) -> str:
        if self.state == "ok":
            if self._signal(queue_depth):
                self.state = "brownout"
                self.transitions += 1
        else:
            # hysteresis: a clear signal AND a drained queue, or brownout flaps
            if not self._signal(queue_depth) and queue_depth <= self.queue_low:
                self.state = "ok"
                self.transitions += 1
        return self.state

    @property
    def active(self) -> bool:
        return self.state == "brownout"

    def shed_target(self, queue_depth: int) -> int:
        if not self.active:
            return 0
        return max(0, queue_depth - self.queue_low)


class CircuitBreaker:
    """Per-worker circuit breaker (router side).

    closed: traffic flows; ``failure_threshold`` CONSECUTIVE failures trip it
    open. open: no traffic until a jittered exponential backoff elapses, then
    ONE half-open probe is allowed. half_open: the probe's success closes the
    breaker (backoff reset); its failure re-opens it with the backoff doubled."""

    _STATE_VALUES = {"closed": 0.0, "half_open": 1.0, "open": 2.0}

    def __init__(
        self,
        failure_threshold: int = 3,
        open_s: float = 1.0,
        max_open_s: float = 30.0,
        jitter: float = 0.25,
        time_fn: Callable[[], float] = time.monotonic,
        rng: Callable[[], float] = random.random,
    ):
        if failure_threshold < 1:
            raise ValueError("failure_threshold must be >= 1")
        self.failure_threshold = int(failure_threshold)
        self.base_open_s = float(open_s)
        self.max_open_s = float(max_open_s)
        self.jitter = float(jitter)
        self._time_fn = time_fn
        self._rng = rng
        self.state = "closed"
        self.failures = 0
        self._open_s = self.base_open_s
        self._until = float("-inf")
        self._probing = False

    def allow(self) -> bool:
        """May a request go to this worker now? Moves open -> half_open once
        the backoff has elapsed, and then admits ONE probe."""
        if self.state == "closed":
            return True
        if self.state == "open":
            if self._time_fn() < self._until:
                return False
            self.state = "half_open"
            self._probing = False
        if self._probing:
            return False  # one probe at a time in half_open
        self._probing = True
        return True

    def record_success(self) -> None:
        self.state = "closed"
        self.failures = 0
        self._open_s = self.base_open_s
        self._probing = False

    def record_failure(self) -> None:
        self.failures += 1
        if self.state == "half_open" or self.failures >= self.failure_threshold:
            self.state = "open"
            self._until = self._time_fn() + self._open_s * (1.0 + self.jitter * self._rng())
            self._open_s = min(self._open_s * 2.0, self.max_open_s)
            self._probing = False

    def state_value(self) -> float:
        """The `fleet_circuit_state{worker}` gauge: 0 closed, 1 half_open, 2 open."""
        return self._STATE_VALUES[self.state]


def _default_retry_budget_ratio() -> float:
    return float(os.environ.get("MODALITIES_TPU_FLEET_RETRY_BUDGET_RATIO", "0.2"))


class RetryBudget:
    """Token bucket capping retries at a fraction of recent successful
    traffic: ``record_success()`` deposits ``ratio`` tokens (capped at
    ``cap``), ``try_retry()`` withdraws one whole token or refuses. The bucket
    starts at ``initial`` (default: full), so a cold start still has a few
    retries before any success funded them."""

    def __init__(self, ratio: Optional[float] = None, cap: float = 10.0, initial: Optional[float] = None):
        self.ratio = _default_retry_budget_ratio() if ratio is None else float(ratio)
        self.cap = float(cap)
        self.tokens = self.cap if initial is None else float(initial)
        self.exhausted = 0  # refused retries
        self._lock = threading.Lock()

    def record_success(self) -> None:
        with self._lock:
            self.tokens = min(self.cap, self.tokens + self.ratio)

    def try_retry(self) -> bool:
        with self._lock:
            if self.tokens >= 1.0:
                self.tokens -= 1.0
                return True
            self.exhausted += 1
            return False


def _default_probe_backoff_max_s() -> float:
    return float(os.environ.get("MODALITIES_TPU_FLEET_PROBE_BACKOFF_MAX_S", "8.0"))


class ProbeBackoff:
    """Jittered exponential backoff for probing ONE dead worker: ``due(now)``
    gates the probe, ``failed(now)`` reschedules it with the delay doubled
    (jittered), ``reset()`` restores the healthy cadence. The jitter keeps
    routers from probing a recovering worker in lockstep."""

    def __init__(self, base_s: float = 0.5, max_s: Optional[float] = None, jitter: float = 0.25,
                 rng: Callable[[], float] = random.random):
        self.base_s = float(base_s)
        self.max_s = _default_probe_backoff_max_s() if max_s is None else float(max_s)
        self.jitter = float(jitter)
        self._rng = rng
        self._delay = self.base_s
        self._next = float("-inf")
        self.failures = 0

    def due(self, now: float) -> bool:
        return now >= self._next

    def failed(self, now: float) -> None:
        self.failures += 1
        self._next = now + self._delay * (1.0 + self.jitter * self._rng())
        self._delay = min(self._delay * 2.0, self.max_s)

    def reset(self) -> None:
        self._delay = self.base_s
        self._next = float("-inf")
        self.failures = 0

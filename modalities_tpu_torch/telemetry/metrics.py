"""Metrics registry: counters, gauges, and fixed log-bucket streaming histograms,
renderable as Prometheus text exposition format (version 0.0.4). The port's
copy of modalities_tpu/telemetry/metrics.py: the same classes, names and
bytes of exposition.

The serving engine registers its request-latency histograms, counters and
scheduler gauges here, and `GET /metrics` on serving/server.py renders the
registry.

- **Hot-path cheap.** `Histogram.observe` is a bisect over precomputed bounds
  plus one locked increment; `Gauge.set` / `Counter.inc` are one locked store.
  The engine calls these a handful of times a dispatch.
- **Get-or-create registration.** `registry.counter(name, help)` returns the
  existing metric when the name is already registered (re-registering with a
  different kind raises).
- **Streaming histograms.** Fixed log-spaced bucket bounds chosen at
  registration; observations update per-bucket counts + sum + count in O(log
  #buckets) with no per-sample storage. `quantile()` estimates percentiles by
  linear interpolation inside the winning bucket, as Prometheus's
  `histogram_quantile()` does.
- **Round-trip.** `parse_prometheus_text` parses what `render` emits; it is a
  small parser for this exposition subset, not a general one.
- **Every read takes the metric's lock** (`value`, `count`, `sum`,
  `quantile`, `series_snapshot`, `registry.get`): the SLO sampler thread
  reads while the engine thread writes.
"""

from __future__ import annotations

import math
import re
import threading
import time
from bisect import bisect_left
from typing import Iterable, Optional, Sequence

_NAME_RE = re.compile(r"^[a-zA-Z_:][a-zA-Z0-9_:]*$")
_LABEL_RE = re.compile(r"^[a-zA-Z_][a-zA-Z0-9_]*$")


def log_buckets(start: float, factor: float, count: int) -> tuple[float, ...]:
    """`count` log-spaced upper bounds: start, start*factor, ... (the implicit
    +Inf bucket is added by the histogram itself)."""
    if start <= 0 or factor <= 1.0 or count < 1:
        raise ValueError(f"log_buckets needs start>0, factor>1, count>=1, got "
                         f"({start}, {factor}, {count})")
    return tuple(start * factor**i for i in range(count))


# Default latency bounds: 0.5 ms .. ~8.4 s at factor 1.5. Factor-2 buckets make
# quantile estimates too coarse to compare against exact client percentiles;
# 1.5 keeps the interpolation error moderate at 24 buckets of bookkeeping.
LATENCY_BUCKETS = log_buckets(0.0005, 1.5, 24)


def _label_key(labels: dict) -> tuple[tuple[str, str], ...]:
    for k in labels:
        if not _LABEL_RE.match(k):
            raise ValueError(f"invalid label name {k!r}")
    return tuple(sorted((k, str(v)) for k, v in labels.items()))


def _escape(value: str) -> str:
    return value.replace("\\", "\\\\").replace("\n", "\\n").replace('"', '\\"')


def _fmt(value: float) -> str:
    if value == math.inf:
        return "+Inf"
    if value == -math.inf:
        return "-Inf"
    if float(value).is_integer() and abs(value) < 1e15:
        return str(int(value))
    return repr(float(value))


def _labels_text(key: tuple[tuple[str, str], ...]) -> str:
    if not key:
        return ""
    return "{" + ",".join(f'{k}="{_escape(v)}"' for k, v in key) + "}"


class _Metric:
    kind = "untyped"

    def __init__(self, name: str, help_text: str):
        if not _NAME_RE.match(name):
            raise ValueError(f"invalid metric name {name!r}")
        self.name = name
        self.help = help_text
        self._lock = threading.Lock()

    def render_lines(self) -> Iterable[str]:  # pragma: no cover - abstract
        raise NotImplementedError

    def reset(self) -> None:  # pragma: no cover - abstract
        raise NotImplementedError


class Counter(_Metric):
    """Monotonically increasing counter; optional labels create one series per
    distinct label set (`c.inc(reason="eod")`)."""

    kind = "counter"

    def __init__(self, name: str, help_text: str):
        super().__init__(name, help_text)
        self._series: dict[tuple, float] = {}

    def inc(self, amount: float = 1.0, **labels) -> None:
        if amount < 0:
            raise ValueError(f"counter {self.name} cannot decrease (inc {amount})")
        key = _label_key(labels)
        with self._lock:
            self._series[key] = self._series.get(key, 0.0) + amount

    def value(self, **labels) -> float:
        with self._lock:
            return self._series.get(_label_key(labels), 0.0)

    def reset(self) -> None:
        with self._lock:
            self._series.clear()

    def render_lines(self):
        with self._lock:
            series = dict(self._series)
        if not series:
            series = {(): 0.0}
        for key in sorted(series):
            yield f"{self.name}{_labels_text(key)} {_fmt(series[key])}"


class Gauge(_Metric):
    """Last-write-wins gauge; `set_fn` registers a scrape-time callback instead
    (evaluated at render, e.g. live pool headroom)."""

    kind = "gauge"

    def __init__(self, name: str, help_text: str):
        super().__init__(name, help_text)
        self._series: dict[tuple, float] = {}
        self._fns: dict[tuple, object] = {}

    def set(self, value: float, **labels) -> None:
        key = _label_key(labels)
        with self._lock:
            self._series[key] = float(value)

    def inc(self, amount: float = 1.0, **labels) -> None:
        key = _label_key(labels)
        with self._lock:
            self._series[key] = self._series.get(key, 0.0) + amount

    def set_fn(self, fn, **labels) -> None:
        key = _label_key(labels)
        with self._lock:
            self._fns[key] = fn

    def value(self, **labels) -> float:
        key = _label_key(labels)
        with self._lock:
            fn = self._fns.get(key)
            value = self._series.get(key, 0.0)
        return float(fn()) if fn is not None else value  # a scrape-time callback runs outside the lock

    def series_snapshot(self) -> dict:
        """Every series value keyed by its label tuple, scrape-time callbacks
        included — lets consumers (the SLO judge) aggregate across labels."""
        with self._lock:
            series = dict(self._series)
            fns = dict(self._fns)
        for key, fn in fns.items():
            try:
                series[key] = float(fn())
            except Exception:
                pass  # a broken callback must never take the reader down
        return series

    def reset(self) -> None:
        with self._lock:
            self._series.clear()

    def render_lines(self):
        with self._lock:
            series = dict(self._series)
            fns = dict(self._fns)
        for key, fn in fns.items():
            try:
                series[key] = float(fn())
            except Exception:
                pass  # a broken callback must never take the scrape down
        if not series:
            series = {(): 0.0}
        for key in sorted(series):
            yield f"{self.name}{_labels_text(key)} {_fmt(series[key])}"


class Histogram(_Metric):
    """Fixed-bound streaming histogram (Prometheus cumulative-`le` exposition).

    Per label set: one count per bucket bound (non-cumulative internally, made
    cumulative at render) plus running sum and count. No per-sample storage.
    """

    kind = "histogram"

    def __init__(self, name: str, help_text: str, buckets: Optional[Sequence[float]] = None):
        super().__init__(name, help_text)
        bounds = tuple(float(b) for b in (buckets if buckets is not None else LATENCY_BUCKETS))
        if not bounds or list(bounds) != sorted(bounds) or len(set(bounds)) != len(bounds):
            raise ValueError(f"histogram {name}: bucket bounds must be strictly increasing")
        self.bounds = bounds
        self._series: dict[tuple, list[float]] = {}  # [per-bucket.., +Inf, sum, count]
        # request tracing: last exemplar per label set, rendered as a
        # comment line so `parse_prometheus_text` (which skips '#') stays valid
        self._exemplars: dict[tuple, tuple[str, float]] = {}

    def _row(self, key: tuple) -> list[float]:
        row = self._series.get(key)
        if row is None:
            row = self._series[key] = [0.0] * (len(self.bounds) + 3)
        return row

    def observe(self, value: float, exemplar: Optional[str] = None, **labels) -> None:
        idx = bisect_left(self.bounds, value)  # first bound >= value; == len -> +Inf
        key = _label_key(labels)
        with self._lock:
            row = self._row(key)
            row[idx] += 1
            row[-2] += value
            row[-1] += 1
            if exemplar is not None:
                self._exemplars[key] = (str(exemplar), float(value))

    def exemplar(self, **labels) -> Optional[tuple[str, float]]:
        """(trace_id, value) of the last exemplar-tagged observation, or None."""
        with self._lock:
            return self._exemplars.get(_label_key(labels))

    def count(self, **labels) -> float:
        with self._lock:
            row = self._series.get(_label_key(labels))
            return row[-1] if row else 0.0

    def sum(self, **labels) -> float:
        with self._lock:
            row = self._series.get(_label_key(labels))
            return row[-2] if row else 0.0

    def quantile(self, q: float, **labels) -> Optional[float]:
        """Estimate the q-quantile (0..1) by linear interpolation inside the
        winning bucket — the server-side `histogram_quantile` view of the data.
        None when the series is empty."""
        if not 0.0 <= q <= 1.0:
            raise ValueError(f"quantile q must be in [0, 1], got {q}")
        with self._lock:
            row = self._series.get(_label_key(labels))
            if row is None or row[-1] == 0:
                return None
            counts = list(row[: len(self.bounds) + 1])
            total = row[-1]
        return _quantile_from_bucket_counts(self.bounds, counts, total, q)

    def reset(self) -> None:
        with self._lock:
            self._series.clear()
            self._exemplars.clear()

    def render_lines(self):
        with self._lock:
            series = {k: list(v) for k, v in self._series.items()}
            exemplars = dict(self._exemplars)
        if not series:
            series = {(): [0.0] * (len(self.bounds) + 3)}
        for key in sorted(series):
            row = series[key]
            cum = 0.0
            for bound, n in zip(self.bounds, row):
                cum += n
                le_key = key + (("le", _fmt(bound)),)
                yield f"{self.name}_bucket{_labels_text(le_key)} {_fmt(cum)}"
            cum += row[len(self.bounds)]
            inf_key = key + (("le", "+Inf"),)
            yield f"{self.name}_bucket{_labels_text(inf_key)} {_fmt(cum)}"
            yield f"{self.name}_sum{_labels_text(key)} {_fmt(row[-2])}"
            yield f"{self.name}_count{_labels_text(key)} {_fmt(row[-1])}"
            ex = exemplars.get(key)
            if ex is not None:
                # comment line by design: our exposition subset has no native
                # OpenMetrics exemplar syntax, and '#' lines are parse-safe
                yield (f"# EXEMPLAR {self.name}{_labels_text(key)} "
                       f'trace_id="{_escape(ex[0])}" value={_fmt(ex[1])}')


def _quantile_from_bucket_counts(
    bounds: Sequence[float], counts: Sequence[float], total: float, q: float
) -> float:
    target = q * total
    cum = 0.0
    lo = 0.0
    for bound, n in zip(bounds, counts):
        if cum + n >= target and n > 0:
            frac = (target - cum) / n
            return lo + frac * (bound - lo)
        cum += n
        lo = bound
    return float(bounds[-1])  # landed in +Inf: clamp to the largest finite bound


class MetricsRegistry:
    """Thread-safe name -> metric map with get-or-create registration and a
    single `render()` producing the full text exposition."""

    def __init__(self):
        self._lock = threading.Lock()
        self._metrics: dict[str, _Metric] = {}

    def _get_or_create(self, cls, name: str, help_text: str, **kwargs) -> _Metric:
        with self._lock:
            existing = self._metrics.get(name)
            if existing is not None:
                if not isinstance(existing, cls):
                    raise ValueError(
                        f"metric {name!r} already registered as {existing.kind}, "
                        f"not {cls.kind}"
                    )
                return existing
            metric = cls(name, help_text, **kwargs)
            self._metrics[name] = metric
            return metric

    def counter(self, name: str, help_text: str = "") -> Counter:
        return self._get_or_create(Counter, name, help_text)

    def gauge(self, name: str, help_text: str = "") -> Gauge:
        return self._get_or_create(Gauge, name, help_text)

    def histogram(
        self, name: str, help_text: str = "", buckets: Optional[Sequence[float]] = None
    ) -> Histogram:
        return self._get_or_create(Histogram, name, help_text, buckets=buckets)

    def get(self, name: str) -> Optional[_Metric]:
        with self._lock:
            return self._metrics.get(name)

    def names(self) -> list[str]:
        with self._lock:
            return sorted(self._metrics)

    def reset(self) -> None:
        """Zero every series, keeping registrations (a caller clears warmup
        observations this way before the measured window)."""
        with self._lock:
            metrics = list(self._metrics.values())
        for metric in metrics:
            metric.reset()

    def render(self) -> str:
        """Prometheus text exposition format 0.0.4 (the `GET /metrics` body)."""
        lines = []
        with self._lock:
            metrics = [self._metrics[name] for name in sorted(self._metrics)]
        for metric in metrics:
            if metric.help:
                lines.append(f"# HELP {metric.name} {_escape(metric.help)}")
            lines.append(f"# TYPE {metric.name} {metric.kind}")
            lines.extend(metric.render_lines())
        return "\n".join(lines) + "\n"

    def snapshot(self) -> dict[str, dict]:
        """JSON-safe point-in-time view of every registered series — what a
        watchdog crash artifact embeds so a hang has counters to correlate
        against, not just thread stacks. Histograms report sum/count (the
        per-bucket rows stay on the scrape surface)."""
        out: dict[str, dict] = {}
        with self._lock:
            metrics = {name: self._metrics[name] for name in sorted(self._metrics)}
        for name, metric in metrics.items():
            entry: dict = {"kind": metric.kind}
            try:
                if isinstance(metric, Histogram):
                    with metric._lock:
                        entry["series"] = {
                            _labels_text(k) or "{}": {"sum": row[-2], "count": row[-1]}
                            for k, row in metric._series.items()
                        }
                elif isinstance(metric, Gauge):
                    with metric._lock:
                        keys = set(metric._series) | set(metric._fns)
                    entry["series"] = {
                        _labels_text(k) or "{}": metric.value(**dict(k)) for k in keys
                    }
                else:
                    with metric._lock:
                        entry["series"] = {
                            _labels_text(k) or "{}": v for k, v in metric._series.items()
                        }
            except Exception as e:  # a broken gauge callback must not sink the dump
                entry["error"] = repr(e)
            out[name] = entry
        return out


_PROCESS_START_S = time.monotonic()


def _rss_bytes() -> float:
    """Resident set size from /proc (Linux); ru_maxrss fallback elsewhere."""
    try:
        with open("/proc/self/status") as f:
            for line in f:
                if line.startswith("VmRSS:"):
                    return float(line.split()[1]) * 1024.0
    except OSError:
        pass
    try:
        import resource

        return float(resource.getrusage(resource.RUSAGE_SELF).ru_maxrss) * 1024.0
    except Exception:
        return 0.0


def register_process_metrics(
    registry: "MetricsRegistry",
    version: str = "",
    config_hash: str = "",
) -> None:
    """Scrape identity + leak detection: a constant-1
    `modalities_tpu_build_info` gauge whose labels tell workers apart, plus
    live process uptime/RSS gauges. Idempotent (get-or-create semantics)."""
    registry.gauge(
        "modalities_tpu_build_info",
        "Constant 1; labels carry the package version and config hash",
    ).set(1, version=version or "unknown", config_hash=config_hash or "unknown")
    registry.gauge(
        "process_uptime_seconds", "Seconds since this process registered metrics"
    ).set_fn(lambda: time.monotonic() - _PROCESS_START_S)
    registry.gauge(
        "process_resident_memory_bytes", "Resident set size of this process"
    ).set_fn(_rss_bytes)


def config_hash_of(path) -> str:
    """Short stable hash of a config file's bytes for the build_info label."""
    import hashlib
    from pathlib import Path as _Path

    try:
        return hashlib.sha256(_Path(path).read_bytes()).hexdigest()[:12]
    except OSError:
        return "unknown"


CONTENT_TYPE_LATEST = "text/plain; version=0.0.4; charset=utf-8"

_SAMPLE_RE = re.compile(
    r"^(?P<name>[a-zA-Z_:][a-zA-Z0-9_:]*)"
    r"(?:\{(?P<labels>[^}]*)\})?"
    r"\s+(?P<value>\S+)\s*$"
)
_LABEL_PAIR_RE = re.compile(r'([a-zA-Z_][a-zA-Z0-9_]*)="((?:[^"\\]|\\.)*)"')


def parse_prometheus_text(text: str) -> dict[str, dict[tuple, float]]:
    """Parse OUR exposition subset back into {name: {label_key: value}}.
    Raises ValueError on a malformed sample line (the exposition-validity
    tests lean on this)."""
    out: dict[str, dict[tuple, float]] = {}
    for line in text.splitlines():
        line = line.strip()
        if not line or line.startswith("#"):
            continue
        m = _SAMPLE_RE.match(line)
        if m is None:
            raise ValueError(f"malformed exposition sample line: {line!r}")
        raw = m.group("value")
        value = math.inf if raw == "+Inf" else -math.inf if raw == "-Inf" else float(raw)
        labels = tuple(
            (k, v.replace('\\"', '"').replace("\\n", "\n").replace("\\\\", "\\"))
            for k, v in _LABEL_PAIR_RE.findall(m.group("labels") or "")
        )
        out.setdefault(m.group("name"), {})[tuple(sorted(labels))] = value
    return out


def histogram_quantile_from_parsed(
    parsed: dict[str, dict[tuple, float]], name: str, q: float
) -> Optional[float]:
    """`histogram_quantile(q, <name>_bucket)` over a parse_prometheus_text
    result (label-free series)."""
    buckets = parsed.get(f"{name}_bucket")
    if not buckets:
        return None
    rows = []
    for key, cum in buckets.items():
        le = dict(key).get("le")
        if le is None:
            continue
        rows.append((math.inf if le == "+Inf" else float(le), cum))
    rows.sort()
    total = rows[-1][1] if rows else 0.0
    if total == 0:
        return None
    bounds, counts, prev = [], [], 0.0
    for bound, cum in rows:
        if bound == math.inf:
            continue
        bounds.append(bound)
        counts.append(cum - prev)
        prev = cum
    if not bounds:
        return None
    return _quantile_from_bucket_counts(bounds, counts, total, q)

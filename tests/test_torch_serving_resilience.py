"""Port parity for the serving admission-control primitives
(modalities_tpu_torch/serving/resilience.py) and the metrics registry
(modalities_tpu_torch/telemetry/metrics.py) against the JAX package's
modules: the same inputs, the same clock, the same answers, and the same
bytes of Prometheus exposition. No model.

The cases are those of tests/resilience/test_serving_resilience.py's
primitive tests (deadlines, tenants, the token bucket, the brownout
hysteresis) plus a randomized walk: the same stream of operations on both
sides, compared exactly after every one."""

import math

import numpy as np
import pytest

from modalities_tpu.serving import resilience as jax_res
from modalities_tpu.telemetry import metrics as jax_metrics
from modalities_tpu_torch.serving import resilience as port_res
from modalities_tpu_torch.telemetry import metrics as port_metrics


def test_the_headers_are_the_jax_headers():
    assert (port_res.DEADLINE_HEADER, port_res.TENANT_HEADER) == (jax_res.DEADLINE_HEADER, jax_res.TENANT_HEADER)


@pytest.mark.parametrize("env", [None, "0", "1500", "-3", "250.5"])
def test_deadline_resolution_equals_jax(monkeypatch, env):
    if env is None:
        monkeypatch.delenv("MODALITIES_TPU_SERVE_DEADLINE_DEFAULT_MS", raising=False)
    else:
        monkeypatch.setenv("MODALITIES_TPU_SERVE_DEADLINE_DEFAULT_MS", env)
    assert port_res.default_deadline_ms() == jax_res.default_deadline_ms()
    for value in (None, "250", -5, 0, "nonsense", 40, 1e-3, "  ", [1]):
        assert port_res.resolve_deadline_ms(value) == jax_res.resolve_deadline_ms(value), value
    for arrival, ms, now in [(0.0, 100.0, 0.05), (0.0, 100.0, 0.1), (-3.0, 100.0, 0.05), (0.0, None, 1e9),
                             (2.5, 0.5, 2.5005), (1.0, 1000.0, 1.999)]:
        assert port_res.deadline_expired(arrival, ms, now) == jax_res.deadline_expired(arrival, ms, now)


@pytest.mark.parametrize("env", [None, "team-a", "  "])
def test_tenant_resolution_equals_jax(monkeypatch, env):
    if env is None:
        monkeypatch.delenv("MODALITIES_TPU_SERVE_TENANT_DEFAULT", raising=False)
    else:
        monkeypatch.setenv("MODALITIES_TPU_SERVE_TENANT_DEFAULT", env)
    assert port_res.default_tenant() == jax_res.default_tenant()
    for value in (None, "", "  ", " acme ", "acme", 7):
        assert port_res.resolve_tenant(value) == jax_res.resolve_tenant(value)


BAD_SPECS = [dict(tenant_class="batch"), dict(weight=0), dict(max_slots=0), dict(rate=0.0)]


@pytest.mark.parametrize("kwargs", BAD_SPECS, ids=["class", "weight", "max_slots", "rate"])
def test_tenant_spec_validation_raises_as_jax(kwargs):
    with pytest.raises(ValueError) as want:
        jax_res.TenantSpec("x", **kwargs)
    with pytest.raises(ValueError) as got:
        port_res.TenantSpec("x", **kwargs)
    assert str(got.value) == str(want.value)


def _spec_fields(spec):
    return (spec.name, spec.tenant_class, spec.weight, spec.max_slots, spec.rate, spec.burst, spec.is_bulk)


def test_tenant_registry_from_config_equals_jax():
    block = {"b": {"class": "bulk", "weight": 2, "rate": 5.0}, "a": {"max_slots": 3},
             "c": {"rate": 0.5, "burst": 4.0}, "d": None}
    jreg, preg = jax_res.TenantRegistry.from_config(block), port_res.TenantRegistry.from_config(block)
    assert preg.names() == jreg.names() == ["a", "b", "c", "d"]
    for name in preg.names() + ["ghost"]:
        assert _spec_fields(preg.spec(name)) == _spec_fields(jreg.spec(name))
    for mod in (jax_res, port_res):
        with pytest.raises(ValueError, match="unknown keys"):
            mod.TenantRegistry.from_config({"x": {"wieght": 2}})


def test_token_bucket_and_rate_limit_walk_equal_jax():
    """Random take / retry-after / rate-limit calls on a stepped clock: every
    answer and the bucket's level equal, call by call."""
    rng = np.random.default_rng(5)
    jb, pb = jax_res.TokenBucket(rate=10.0, burst=20.0), port_res.TokenBucket(rate=10.0, burst=20.0)
    block = {"metered": {"rate": 4.0, "burst": 8.0}, "free": {}}
    jreg, preg = jax_res.TenantRegistry.from_config(block), port_res.TenantRegistry.from_config(block)
    now = 0.0
    for _ in range(300):
        now += float(rng.choice([0.0, 0.05, 0.5, 1.3]))
        n = float(rng.choice([1.0, 4.0, 5.0, 20.0, 1000.0]))
        op = rng.integers(0, 3)
        if op == 0:
            assert pb.try_take(n, now) == jb.try_take(n, now)
        elif op == 1:
            assert pb.retry_after_s(n, now) == jb.retry_after_s(n, now)
        else:
            name = str(rng.choice(["metered", "free", "ghost"]))
            assert preg.rate_limit_retry_after_s(name, n, now) == jreg.rate_limit_retry_after_s(name, n, now)
        assert pb.tokens == jb.tokens
    with pytest.raises(ValueError, match="rate > 0"):
        port_res.TokenBucket(0.0, 1.0)


@pytest.mark.parametrize("high,low", [(4, 2), (8, None), (1, 0)])
def test_brownout_hysteresis_walk_equals_jax(high, low):
    rng = np.random.default_rng(high)
    jc = jax_res.BrownoutController(queue_high=high, queue_low=low)
    pc = port_res.BrownoutController(queue_high=high, queue_low=low)
    assert pc.queue_low == jc.queue_low
    for depth in rng.integers(0, 12, size=200):
        assert pc.update(int(depth)) == jc.update(int(depth))
        assert (pc.active, pc.shed_target(int(depth)), pc.transitions) == (jc.active, jc.shed_target(int(depth)),
                                                                          jc.transitions)
    with pytest.raises(ValueError, match="breaching_fn or queue_high"):
        port_res.BrownoutController()
    flag = {"v": True}
    pc = port_res.BrownoutController(lambda: flag["v"])  # the signal hook the SLO engine will drive
    assert pc.queue_low == 0 and pc.update(0) == "brownout"
    flag["v"] = False
    assert pc.update(0) == "ok"


# ------------------------------------------------------------------ metrics


def _same_ops(registries, rng, steps: int = 120):
    """The same random stream of metric operations on every registry."""
    values = [0.0, 1e-4, 0.0007, 0.012, 0.5, 3.0, 9.9, 1e6, 2.5]
    for _ in range(steps):
        op = int(rng.integers(0, 7))
        labels = {} if rng.random() < 0.4 else {"reason": str(rng.choice(["eod", "budget", 'q"u\\o\nte']))}
        value = float(rng.choice(values))
        for reg in registries:
            if op == 0:
                reg.counter("serve_requests_total", "Requests").inc(value, **labels)
            elif op == 1:
                reg.gauge("serve_queue_depth", "Queue depth").set(value, **labels)
            elif op == 2:
                reg.gauge("serve_live", "Live").inc(value, **labels)
            elif op == 3:
                reg.histogram("serve_ttft_seconds", "TTFT").observe(value, **labels)
            elif op == 4:
                reg.histogram("serve_custom_seconds", "Custom", buckets=(0.01, 0.1, 1.0)).observe(
                    value, exemplar="abc" if value > 1 else None)
            elif op == 5:
                reg.gauge("serve_fn", "Callback").set_fn(lambda v=value: v * 2, tenant="t1")
            else:
                reg.counter("serve_no_help").inc()


def test_exposition_is_byte_equal_to_jax():
    rng_a, rng_b = np.random.default_rng(9), np.random.default_rng(9)
    jreg, preg = jax_metrics.MetricsRegistry(), port_metrics.MetricsRegistry()
    _same_ops([jreg], rng_a)
    _same_ops([preg], rng_b)
    text = preg.render()
    assert text == jreg.render()
    assert port_metrics.parse_prometheus_text(text) == jax_metrics.parse_prometheus_text(text)
    assert preg.snapshot() == jreg.snapshot()
    for q in (0.0, 0.5, 0.9, 0.99, 1.0):
        assert (preg.get("serve_ttft_seconds").quantile(q, reason="eod")
                == jreg.get("serve_ttft_seconds").quantile(q, reason="eod"))
        assert (port_metrics.histogram_quantile_from_parsed(port_metrics.parse_prometheus_text(text),
                                                            "serve_custom_seconds", q)
                == jax_metrics.histogram_quantile_from_parsed(jax_metrics.parse_prometheus_text(text),
                                                              "serve_custom_seconds", q))
    preg.reset()
    jreg.reset()
    assert preg.render() == jreg.render()


def test_registry_rules_and_helpers_equal_jax(tmp_path):
    assert port_metrics.LATENCY_BUCKETS == jax_metrics.LATENCY_BUCKETS
    assert port_metrics.log_buckets(0.001, 2.0, 5) == jax_metrics.log_buckets(0.001, 2.0, 5)
    assert port_metrics.CONTENT_TYPE_LATEST == jax_metrics.CONTENT_TYPE_LATEST
    for mod in (jax_metrics, port_metrics):
        reg = mod.MetricsRegistry()
        reg.counter("a_total")
        with pytest.raises(ValueError, match="already registered"):
            reg.gauge("a_total")
        with pytest.raises(ValueError, match="invalid metric name"):
            reg.counter("1bad")
        with pytest.raises(ValueError, match="cannot decrease"):
            reg.counter("a_total").inc(-1)
        with pytest.raises(ValueError, match="malformed"):
            mod.parse_prometheus_text("not a sample line at all {")
    cfg = tmp_path / "c.yaml"
    cfg.write_text("a: 1\n")
    assert port_metrics.config_hash_of(cfg) == jax_metrics.config_hash_of(cfg)
    assert port_metrics.config_hash_of(tmp_path / "missing") == "unknown"
    reg = port_metrics.MetricsRegistry()
    port_metrics.register_process_metrics(reg, version="0.1.0", config_hash="abc")
    parsed = port_metrics.parse_prometheus_text(reg.render())
    assert parsed["modalities_tpu_build_info"] == {(("config_hash", "abc"), ("version", "0.1.0")): 1.0}
    assert parsed["process_uptime_seconds"][()] >= 0.0 and parsed["process_resident_memory_bytes"][()] > 0
    assert math.isinf(port_metrics.parse_prometheus_text('x_bucket{le="+Inf"} +Inf')["x_bucket"][(("le", "+Inf"),)])

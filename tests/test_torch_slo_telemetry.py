"""Port parity for the telemetry modules (modalities_tpu_torch/telemetry/:
slo, spans, sink, goodput, watchdog, device_memory; resilience/events):
the same inputs through the JAX module and the port's, the results compared.

- `parse_objective` on the JAX grammar's expressions (quantile, ratio, value,
  label selectors, whitespace) gives the same Objective, and the same errors;
- `evaluate_objective` over twin registries fed the same observations;
- the burn windows (`BurnRateEvaluator`) on one scripted clock: the same
  transitions, burn rates and budgets sample by sample;
- `SLOEngine`: verdicts, the slo_* gauges and counters, and the slo/breach
  and slo/recovered events (counted, and written to each package's sink);
- `load_slo_spec` (mapping and YAML) and `tenant_objectives`;
- the four replays into a registry and `evaluate_recorded`;
- the watchdog artifact's keys, the device memory under the JAX key names
  on the CPU, and the engine state a provider hands it;
- span exclusive times on a scripted `time.perf_counter`;
- the sink's records: the JAX `load_serve_records` and `summarize_sink` read
  a port sink as they read a JAX one.

Every clock here is scripted; nothing races the wall clock."""

import dataclasses
import json
import time

import pytest
import yaml

from modalities_tpu.resilience import events as jax_events
from modalities_tpu.serving.analyze import load_serve_records as jax_load_serve_records
from modalities_tpu.telemetry import Telemetry as JaxTelemetry
from modalities_tpu.telemetry import set_active_telemetry as jax_set_active
from modalities_tpu.telemetry import goodput as jax_goodput
from modalities_tpu.telemetry import metrics as jax_metrics
from modalities_tpu.telemetry import slo as jax_slo
from modalities_tpu.telemetry import spans as jax_spans
from modalities_tpu.telemetry.watchdog import Watchdog as JaxWatchdog
from modalities_tpu_torch.resilience import events as port_events
from modalities_tpu_torch.serving.analyze import load_serve_records
from modalities_tpu_torch.telemetry import Telemetry, set_active_telemetry
from modalities_tpu_torch.telemetry import goodput as port_goodput
from modalities_tpu_torch.telemetry import metrics as port_metrics
from modalities_tpu_torch.telemetry import slo as port_slo
from modalities_tpu_torch.telemetry import spans as port_spans
from modalities_tpu_torch.telemetry.device_memory import device_memory_stats
from modalities_tpu_torch.telemetry.sink import TelemetrySink
from modalities_tpu_torch.telemetry.watchdog import Watchdog

PACKAGES = {"jax": (jax_slo, jax_metrics), "port": (port_slo, port_metrics)}

EXPRESSIONS = [
    "serve_ttft_seconds p99 < 0.5",
    "serve_request_errors_total / serve_requests_total <= 0.01",
    "training_goodput_ratio >= 0.85",
    "  a_metric   <   1  ",
    'serve_ttft_seconds{tenant="acme"} p95 < 0.5',
    'serve_tenant_active_slots{tenant="acme"} <= 4',
    'serve_tenant_shed_total{tenant="bulk", reason="brownout"} / serve_tenant_requests_total{tenant="bulk"} <= 0.05',
    "x p99.9 > 1e-3",
    # the errors
    "serve_ttft_seconds is fast",
    "a == 1",
    "serve_ttft_seconds p100 < 0.5",
    "serve_ttft_seconds p0 < 0.5",
    'm{tenant=bulk} < 1',
]


def _parse(mod, expr, **opts):
    try:
        return ("ok", dataclasses.asdict(mod.parse_objective("o", expr, **opts)))
    except ValueError as exc:
        return ("ValueError", str(exc))


@pytest.mark.parametrize("expr", EXPRESSIONS)
def test_parse_objective_equals_jax(expr):
    assert _parse(port_slo, expr) == _parse(jax_slo, expr)
    assert _parse(port_slo, expr, budget=0.05, fast_window_s=30.0) == _parse(jax_slo, expr, budget=0.05,
                                                                              fast_window_s=30.0)


def _fill(metrics_mod):
    """One registry of each package fed the same observations."""
    reg = metrics_mod.MetricsRegistry()
    ttft = reg.histogram("serve_ttft_seconds", "")
    for v in (0.01, 0.2, 0.4, 0.9, 3.0):
        ttft.observe(v)
    for v in (0.05, 0.06):
        ttft.observe(v, tenant="acme")
    reg.counter("serve_request_errors_total", "").inc(2)
    reg.counter("serve_requests_total", "").inc(50)
    reg.counter("serve_requests_submitted_total", "")  # registered, never moved: an unjudgeable denominator
    shed, reqs = reg.counter("serve_tenant_shed_total", ""), reg.counter("serve_tenant_requests_total", "")
    for _ in range(10):
        reqs.inc(tenant="bulk")
    for _ in range(3):
        shed.inc(tenant="bulk")
    reg.gauge("training_goodput_ratio", "").set(0.8)
    headroom = reg.gauge("memscope_device_headroom_bytes", "")
    headroom.set(5e9, device="0")
    headroom.set(1e9, device="1")
    reg.gauge("serve_queue_depth", "").set_fn(lambda: 7.0)
    return reg


OBJECTIVES = [
    "serve_ttft_seconds p99 < 0.5",
    "serve_ttft_seconds p50 <= 0.5",
    'serve_ttft_seconds{tenant="acme"} p99 < 0.1',
    'serve_ttft_seconds{tenant="none"} p99 < 0.1',
    "serve_request_errors_total / serve_requests_total < 0.01",
    "serve_request_errors_total / serve_requests_submitted_total < 0.01",
    'serve_tenant_shed_total{tenant="bulk"} / serve_tenant_requests_total{tenant="bulk"} <= 0.05',
    "training_goodput_ratio >= 0.85",
    "memscope_device_headroom_bytes >= 2e9",
    "memscope_device_headroom_bytes < 6e9",
    "serve_queue_depth < 8",
    "absent_metric < 1",
    "serve_ttft_seconds < 1",
]


@pytest.mark.parametrize("expr", OBJECTIVES)
def test_evaluate_objective_equals_jax(expr):
    got = {name: mod.evaluate_objective(mod.parse_objective("o", expr), _fill(metrics))
           for name, (mod, metrics) in PACKAGES.items()}
    assert got["port"] == got["jax"]


# (seconds since the last sample, ok) of one scripted run: a quiet start, a
# burst of bad samples, good ones through the fast window, a jump past the
# slow window, unjudgeable ticks, and a second breach
SCRIPT = ([(1.0, True)] * 5 + [(1.0, False)] * 3 + [(10.0, True)] * 9 + [(700.0, True)] + [(1.0, None)] * 3
          + [(5.0, False)] * 2 + [(30.0, True)] * 4 + [(650.0, None)])


def test_burn_windows_equal_jax_on_one_scripted_clock():
    clock = {"t": 0.0}
    evaluators = {name: mod.BurnRateEvaluator(mod.parse_objective("x", "m < 1"), time_fn=lambda: clock["t"])
                  for name, (mod, _) in PACKAGES.items()}
    transitions = []
    for dt, ok in SCRIPT:
        clock["t"] += dt
        row = {}
        for name, ev in evaluators.items():
            transition = ev.observe(ok, None if ok is None else (0.5 if ok else 2.0))
            row[name] = (transition, ev.breaching, ev.fast_burn_rate, ev.slow_burn_rate, ev.budget_remaining())
        assert row["port"] == row["jax"]
        transitions.append(row["port"][0])
    assert transitions.count("breach") == 2 and transitions.count("recovered") == 2


def _sink_events(path):
    return [json.loads(line) for line in path.read_text().splitlines() if line.strip()]


def test_slo_engine_gauges_events_and_sink_equal_jax(tmp_path):
    """Both SLO engines over twin registries on one scripted clock, each
    package's telemetry active with a sink: the verdicts, the slo_* series
    and the slo/* events (counted and written) are the same."""
    clock = {"t": 0.0}
    spec = {"sample_interval_s": 2.0, "objectives": [
        {"name": "goodput", "expr": "training_goodput_ratio >= 0.85"},
        {"name": "ttft_p99", "expr": "serve_ttft_seconds p99 < 0.5", "budget": 0.05},
        {"name": "error_rate", "expr": "serve_request_errors_total / serve_requests_total < 0.01"}]}
    runs = {}
    for name, (mod, metrics) in PACKAGES.items():
        events = jax_events if name == "jax" else port_events
        telemetry_cls, set_active = (JaxTelemetry, jax_set_active) if name == "jax" else (Telemetry,
                                                                                         set_active_telemetry)
        telemetry = telemetry_cls(output_folder_path=tmp_path / name, watchdog_deadline_s=0.0)
        prior = set_active(telemetry)
        try:
            reg = metrics.MetricsRegistry()
            gauge = reg.gauge("training_goodput_ratio", "")
            objectives, options = mod.load_slo_spec(spec)
            engine = mod.SLOEngine(objectives, reg, time_fn=lambda: clock["t"], scope="w0", **options)
            snapshot = events.snapshot_counts()
            trail = []
            for value, ttft in ((0.9, None), (0.5, 3.0), (0.5, None), (0.9, 0.1), (0.9, None)):
                clock["t"] += 700.0 if value == 0.9 and trail else 1.0
                gauge.set(value)
                if ttft is not None:
                    reg.histogram("serve_ttft_seconds", "").observe(ttft)
                trail.append((engine.sample_once(), engine.breaching(), engine.status()))
            runs[name] = {"trail": trail, "interval": engine.sample_interval_s,
                          "text": sorted(line for line in reg.render().splitlines() if line.startswith("slo_")),
                          "events": events.counts_since(snapshot)}
        finally:
            telemetry.close()
            set_active(prior)
        runs[name]["sink"] = [{k: v for k, v in e.items() if k != "wall_time"}
                              for e in _sink_events(tmp_path / name / "telemetry_rank_0.jsonl")
                              if e.get("event") == "resilience"]
    assert runs["port"] == runs["jax"]
    # goodput breaches and recovers; ttft's cumulative histogram keeps its p99 over 0.5 s once a 3 s sample landed
    assert runs["port"]["events"] == {"slo": 3} and runs["port"]["interval"] == 2.0
    assert [e["name"] for e in runs["port"]["sink"]] == ["slo/breach", "slo/breach", "slo/recovered"]


SPECS = [
    {"objectives": [{"name": "a", "expr": "m < 1"}]},
    {"sample_interval_s": 3, "objectives": [{"name": "a", "expr": "m p90 < 1", "budget": 0.1,
                                              "fast_window_s": 5, "slow_window_s": 50, "fast_burn": 3,
                                              "slow_burn": 1}]},
    {"objectives": None},
    {"objectives": [{"name": "a", "expr": "m < 1", "bogus": 1}]},
    {"sample_interval_s": 1.0},
]


@pytest.mark.parametrize("spec", SPECS, ids=["plain", "tuned", "empty", "unknown_key", "no_objectives"])
def test_load_slo_spec_equals_jax_from_a_mapping_and_a_yaml_file(tmp_path, spec):
    path = tmp_path / "slo.yaml"
    path.write_text(yaml.safe_dump(spec))

    def load(mod, source):
        try:
            objectives, options = mod.load_slo_spec(source)
            return [dataclasses.asdict(o) for o in objectives], options
        except ValueError as exc:
            return str(exc)

    for source in (spec, path):
        assert load(port_slo, source) == load(jax_slo, source)


def test_tenant_objectives_equal_jax():
    for names, threshold in ((["bulk", "acme"], 0.05), ([], 0.01), (["interactive"], 0.2)):
        assert ([dataclasses.asdict(o) for o in port_slo.tenant_objectives(names, threshold)]
                == [dataclasses.asdict(o) for o in jax_slo.tenant_objectives(names, threshold)])


def _recording(tmp_path):
    """A sink (serve_request records, spans, an mfu waterfall, memscope
    timeline samples, a torn tail line), bench lines, a trajectory folder
    and a memscope report."""
    sink = tmp_path / "sink"
    sink.mkdir()
    rows = [{"rank": 0, "event": "serve_request", "rid": i, "finish_reason": "error" if i == 3 else "budget",
             "ttft_s": 0.1 * (i + 1), "latency_s": 0.5 + i} for i in range(6)]
    rows += [{"rank": 0, "event": "span", "name": n, "ts": 10.0 + i, "dur_s": 0.5, "self_s": 0.5, "thread": "t",
              "timeline": True} for i, n in enumerate(["train_step", "data_wait", "train_step", "eval"])]
    rows += [{"rank": 0, "event": "mfu_waterfall", "achieved": 0.41},
             {"rank": 0, "event": "memscope_timeline", "bytes_in_use": 7e9, "headroom_bytes": {"0": 3e9, "1": 5e9}},
             {"rank": 0, "event": "memscope_timeline", "bytes_in_use": 6e9, "headroom_bytes": {"0": 4e9, "1": 2e9}}]
    (sink / "telemetry_rank_0.jsonl").write_text("\n".join(json.dumps(r) for r in rows) + "\n{\"torn")
    bench = tmp_path / "bench.jsonl"
    bench.write_text(json.dumps({"ttft_p50": 9.0}) + "\n" + json.dumps({"ttft_p50": 0.2, "tok_s": 1234,
                                                                       "ok": True, "name": "x"}) + "\n")
    traj = tmp_path / "traj"
    traj.mkdir()
    (traj / "BENCH_r01.json").write_text(json.dumps({"n": 1, "rc": 0, "tail": "", "parsed": {"value": 3.5}}))
    (traj / "BENCH_r02.json").write_text(json.dumps({"n": 2, "rc": 124, "tail": "", "parsed": None}))
    (traj / "MULTICHIP_r01.json").write_text(json.dumps({"n_devices": 8, "rc": 1, "ok": False, "tail": ""}))
    memscope = tmp_path / "memscope.json"
    memscope.write_text(json.dumps({"executables": {"train_step": {"buckets": {"params": 1e9, "acts": 2e9},
                                                                   "memory_analysis": {"total_bytes": 3e9}}}}))
    return sink, bench, traj, memscope


def test_replays_and_evaluate_recorded_equal_jax(tmp_path):
    sink, bench, traj, memscope = _recording(tmp_path)
    spec = {"objectives": [
        {"name": "ttft", "expr": "serve_ttft_seconds p99 < 0.5"},
        {"name": "errors", "expr": "serve_request_errors_total / serve_requests_total < 0.01"},
        {"name": "goodput", "expr": "training_goodput_ratio >= 0.3"},
        {"name": "mfu", "expr": "training_mfu_achieved >= 0.4"},
        {"name": "hbm", "expr": "training_hbm_bytes_in_use < 6.5e9"},
        {"name": "headroom", "expr": "memscope_device_headroom_bytes >= 2.5e9"},
        {"name": "bench", "expr": "bench_ttft_p50 < 0.5"},
        {"name": "best", "expr": "bench_best_value >= 3"},
        {"name": "rounds", "expr": "bench_failed_rounds < 1"},
        {"name": "multichip", "expr": "multichip_failed_rounds < 1"},
        {"name": "peak", "expr": "memscope_predicted_peak_bytes < 4e9"},
        {"name": "missing", "expr": "never_recorded < 1"}]}
    got = {}
    for name, (mod, metrics) in PACKAGES.items():
        reg = metrics.MetricsRegistry()
        counts = (mod.replay_sink_into_registry(sink, reg), mod.replay_bench_lines_into_registry(bench, reg),
                  mod.replay_trajectory_into_registry(traj, reg), mod.replay_memscope_into_registry(memscope, reg))
        objectives, _ = mod.load_slo_spec(spec)
        got[name] = (counts, mod.evaluate_recorded(objectives, reg), reg.render())
    assert got["port"] == got["jax"]
    assert got["port"][1]["skipped"] == ["missing"] and "errors" in got["port"][1]["breaching"]


def _fire(cls, tmp_path, name):
    watchdog = cls(deadline_s=0.05, artifact_dir=tmp_path / name, global_rank=0, poll_interval_s=0.01,
                   metrics_provider=lambda: {"serve_requests_total": 3.0})
    watchdog.register_state_provider(lambda: {"serving_engine": {"weights_generation": 2, "queue_depth": 1}})
    watchdog.start()
    watchdog.arm(7)
    deadline = time.monotonic() + 30.0
    while not watchdog.fired_artifacts and time.monotonic() < deadline:
        time.sleep(0.01)
    watchdog.stop()
    assert len(watchdog.fired_artifacts) == 1
    return json.loads(watchdog.fired_artifacts[0].read_text()), watchdog.fired_artifacts[0].name


def test_watchdog_artifact_has_the_jax_keys(tmp_path):
    """Both watchdogs armed for step 7 with a 50 ms deadline dump one
    artifact each, under the same file name and keys, with the engine state
    and the metrics snapshot; the device memory section of a CPU process is
    empty per device in both."""
    (want, want_name), (got, got_name) = _fire(JaxWatchdog, tmp_path, "jax"), _fire(Watchdog, tmp_path, "port")
    assert got_name == want_name == "watchdog_dump_rank_0_step_7.json"
    assert set(got) == set(want)
    same = ("event", "rank", "armed_step", "deadline_s", "state", "metrics", "weights_generation")
    assert {k: got[k] for k in same} == {k: want[k] for k in same}
    # a CPU device reports no stats in either package (the JAX process holds 8 virtual CPU devices)
    assert list(got["device_memory"].values()) == [{}] and all(v == {} for v in want["device_memory"].values())
    assert any("test_watchdog_artifact_has_the_jax_keys" in "".join(s) for s in got["thread_stacks"].values())
    assert device_memory_stats() == {"cpu": {}}


def _spans(spans_mod, monkeypatch):
    """Nested spans on a perf_counter that steps 1 s a read: (name, dur_s,
    self_s, timeline) a span."""
    ticks = iter(range(1000))
    monkeypatch.setattr(time, "perf_counter", lambda: float(next(ticks)))
    out = []
    kwargs = {"use_jax_annotations": False} if spans_mod is jax_spans else {}
    recorder = spans_mod.SpanRecorder(on_record=out.append, **kwargs)
    with recorder.span("serve/decode"):
        with recorder.span("serve/admission"):
            with recorder.span("serve/prefill"):
                pass
        with recorder.span("serve/cow"):
            pass
    with recorder.span("train_step"):
        pass
    monkeypatch.undo()
    return [(r.name, r.dur_s, r.self_s, r.timeline) for r in out]


def test_span_exclusive_times_equal_jax(monkeypatch):
    got, want = _spans(port_spans, monkeypatch), _spans(jax_spans, monkeypatch)
    assert got == want
    assert [r[0] for r in got] == ["serve/prefill", "serve/admission", "serve/cow", "serve/decode", "train_step"]
    ledgers = []
    for mod, spans_mod in ((port_goodput, port_spans), (jax_goodput, jax_spans)):
        ledger = mod.GoodputLedger()
        for name, dur, self_s, timeline in got:
            ledger.add_record(spans_mod.SpanRecord(name, 0.0, dur, self_s, "MainThread", timeline))
        ledgers.append(ledger.summary(wall_s=20.0))
    assert ledgers[0] == ledgers[1]


def test_the_jax_readers_read_a_port_sink(tmp_path):
    """A port sink with serve_request records, spans and events, sealed with
    a run summary: the JAX `load_serve_records` and `summarize_sink` read it
    as the port's readers do."""
    sink = TelemetrySink(tmp_path, global_rank=0)
    for i in range(3):
        sink.emit({"event": "serve_request", "rid": i, "trace_id": f"t{i}", "hop": 0, "tokens": 4 + i,
                   "finish_reason": "budget", "ttft_s": 0.1 * i, "e2e_s": 1.0, "queue_wait_s": 0.0,
                   "tpot_mean_s": 0.01, "events": [{"name": "admit", "t": 0.0}, {"name": "finish", "t": 1.0}]})
        sink.emit_span(port_spans.SpanRecord("serve/decode", 100.0 + i, 0.5, 0.25, "serve-engine", True))
    sink.emit({"event": "resilience", "name": "fleet/request", "trace_id": "t0", "outcome": "done"})
    sink.close(run_summary=port_goodput.GoodputLedger().summary(wall_s=3.0))
    assert jax_load_serve_records(tmp_path) == load_serve_records(tmp_path)
    assert [r["rid"] for r in load_serve_records(tmp_path / "telemetry_rank_0.jsonl")] == [0, 1, 2]
    assert jax_goodput.summarize_sink(tmp_path) == port_goodput.summarize_sink(tmp_path)
    assert json.loads((tmp_path / "goodput_summary.json").read_text())["wall_s"] == 3.0

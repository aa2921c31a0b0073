"""Port parity for request tracing and the serving analysis: the port's
ServingEngine against the JAX ServingEngine on the tiny GPT2 in f32 (weights
carried across by `params_from_jax`), each under its package's active
Telemetry with a sink, one JAX run per case (module fixtures):

- the ring with tenants, multi-chunk and truncated prompts;
- the paged cache with prefix sharing (a copy-on-write full match),
  preemption on a small pool and speculation at k = 2;
- the disaggregated tiers (a prefill engine's records imported by a decode
  engine), whose records carry their role.

Every `serve_request` record equals JAX's in every field but the clock's
(queue wait, TTFT, end-to-end, mean TPOT, the events' times: the port reads
its clock fewer times than JAX), and its event names and their fields equal
JAX's, in order. The active registries' counters and histogram counts are
equal. Then the analysis: `summarize_serve` and `stitch_fleet_traces` of the
port give the JAX summaries of the same sinks; `data analyze_serve |
analyze_fleet | check_slo` give the JAX CLI's exit codes and JSON; and
a worker's /healthz reads "degraded" while an objective burns, and the
router writes one `fleet/request` record a request. (The fleet's SLO
rollback is held to JAX in tests/test_torch_fleet.py.) Every clock is scripted
or stepped; no sampler thread runs where a verdict is asserted."""

import json

import pytest
from click.testing import CliRunner

from modalities_tpu.__main__ import main as jax_cli
from modalities_tpu.serving import analyze as jax_analyze
from modalities_tpu.serving.engine import ServingEngine as JaxServingEngine
from modalities_tpu.serving.resilience import TenantRegistry as JaxTenants
from modalities_tpu.telemetry import Telemetry as JaxTelemetry
from modalities_tpu.telemetry import set_active_telemetry as jax_set_active
from modalities_tpu.telemetry.metrics import parse_prometheus_text
from modalities_tpu_torch.__main__ import main as port_cli
from modalities_tpu_torch.serving import analyze
from modalities_tpu_torch.serving.engine import ServingEngine
from modalities_tpu_torch.serving.fleet import router as port_router
from modalities_tpu_torch.serving.resilience import TenantRegistry
from modalities_tpu_torch.serving.server import ServingHTTPServer
from modalities_tpu_torch.telemetry import Telemetry, set_active_telemetry
from modalities_tpu_torch.telemetry.metrics import MetricsRegistry
from modalities_tpu_torch.telemetry.slo import SLOEngine, load_slo_spec
from tests.test_torch_gpt2 import jax_and_port

CLOCK_FIELDS = ("queue_wait_s", "ttft_s", "e2e_s", "tpot_mean_s")
PREFIX = [(i * 7 + 3) % 127 for i in range(16)]  # 4 full blocks at block_size 4
TENANTS = {"gold": {"class": "interactive", "weight": 3}, "bulk": {"class": "bulk", "weight": 1}}

CASES = {
    "ring_tenants": (
        dict(max_batch_slots=2, kv_cache="ring"),
        [(list(range(1, 22)), 6, 0.0, "gold"),  # 21 tokens: chunks of 16, 4 and 1
         ([7, 7, 7], 5, 0.8, "bulk"),
         (list(range(40, 80)), 4, 0.0, "gold"),  # 40 tokens: the window keeps the last 31
         ([9, 3], 40, 0.0, "bulk")],  # runs into the ring's end: "capacity"
    ),
    "paged_sharing_preempt_spec": (
        dict(max_batch_slots=2, kv_cache="paged", paged_block_size=4, paged_max_len=28, paged_num_blocks=8,
             spec_decode={"k": 2}),
        [(PREFIX + [60, 61], 12, 0.0, ""),  # the donor
         (list(range(90, 101)), 1, 0.8, ""),  # holds slot 2 past the donor's registration
         (PREFIX, 6, 0.0, ""),  # a full-window match: copy-on-write
         (PREFIX[:8] + [50, 51], 8, 0.0, ""),  # a partial match
         ([1, 2, 3] * 4, 10, 0.0, "")],  # periodic: the drafter fires
    ),
}


@pytest.fixture(scope="module")
def models():
    return jax_and_port("float32")


def _serve_traced(make_engine, telemetry, set_active, reqs):
    """Serve `reqs` on a fresh engine under `telemetry`; (sink records, registry text)."""
    prior = set_active(telemetry)
    try:
        engine = make_engine()
        for i, (prompt, budget, temp, tenant) in enumerate(reqs):
            engine.submit(prompt, budget, temperature=temp, seed=i, trace_id=f"trace{i}", tenant=tenant)
        engine.run()
        text = engine.metrics.render()
    finally:
        telemetry.close()
        set_active(prior)
    return _records(telemetry.sink_path), text


def _records(path):
    return [json.loads(line) for line in path.read_text().splitlines()
            if json.loads(line).get("event") == "serve_request"]


def _shape(record: dict) -> dict:
    """A record without the clock's values: the events' names and fields kept, their times dropped."""
    out = {k: v for k, v in record.items() if k not in CLOCK_FIELDS}
    out["events"] = [{k: v for k, v in e.items() if k != "t"} for e in record["events"]]
    return out


def _counts(text: str) -> dict:
    """Every counter series and histogram count of a rendered registry."""
    parsed = parse_prometheus_text(text)
    kinds = {line.split()[2]: line.split()[3] for line in text.splitlines() if line.startswith("# TYPE")}
    return {name: series for name, series in parsed.items()
            if kinds.get(name) == "counter" or (name.endswith("_count") and kinds.get(name[:-6]) == "histogram")}


@pytest.fixture(scope="module", params=list(CASES))
def traced(request, models, tmp_path_factory):
    knobs, reqs = CASES[request.param]
    jm, jp, pm, pp = models
    tmp = tmp_path_factory.mktemp(request.param)
    tenants = "tenants" in request.param
    want = _serve_traced(
        lambda: JaxServingEngine(jm, jp, eod_token_id=-1, tenants=JaxTenants.from_config(TENANTS) if tenants else None,
                                 **knobs),
        JaxTelemetry(output_folder_path=tmp / "jax", watchdog_deadline_s=0.0, use_jax_annotations=False),
        jax_set_active, reqs)
    got = _serve_traced(
        lambda: ServingEngine(pm, pp, device="cpu", eod_token_id=-1,
                              tenants=TenantRegistry.from_config(TENANTS) if tenants else None, **knobs),
        Telemetry(output_folder_path=tmp / "port", watchdog_deadline_s=0.0), set_active_telemetry, reqs)
    return request.param, want, got, tmp


def test_serve_request_records_equal_jax_but_the_clock(traced):
    case, (want, _), (got, _), _ = traced
    assert len(got) == len(want) == len(CASES[case][1])
    by_rid = {r["rid"]: r for r in want}
    for record in got:
        assert _shape(record) == _shape(by_rid[record["rid"]])
        assert set(record) == set(by_rid[record["rid"]])
    names = {e["name"] for r in got for e in r["events"]}
    if case == "ring_tenants":
        assert {"prefill_chunk", "first_token", "finish"} <= names and {r.get("tenant") for r in got} == {"gold", "bulk"}
        assert [r["finish_reason"] for r in sorted(got, key=lambda r: r["rid"])][3] == "capacity"
        assert any(r["truncated"] for r in got)
    else:
        assert {"prefix_hit", "preempt", "requeue"} <= names
        assert sum(r["spec_proposed"] for r in got) > 0 and sum(r["preemptions"] for r in got) > 0


def test_the_active_registries_count_what_jax_counts(traced):
    _, (_, want), (_, got), _ = traced
    assert _counts(got) == _counts(want)
    assert _counts(got)["serve_ttft_seconds_count"][()] > 0


def test_summaries_of_the_same_sinks_equal_jax(traced):
    """analyze_serve's summary of each sink: the port's function and the
    JAX one agree on both sinks; the two sinks agree but for the clock."""
    _, _, _, tmp = traced
    for folder in ("jax", "port"):
        records = jax_analyze.load_serve_records(tmp / folder)
        assert analyze.summarize_serve(analyze.load_serve_records(tmp / folder)) == jax_analyze.summarize_serve(
            records)
        assert analyze.stitch_fleet_traces(analyze.load_fleet_records([tmp / folder])) == \
            jax_analyze.stitch_fleet_traces(jax_analyze.load_fleet_records([tmp / folder]))
    port, jax = (analyze.summarize_serve(analyze.load_serve_records(tmp / f)) for f in ("port", "jax"))
    for key in ("requests", "finish_reasons", "prompt_tokens", "generated_tokens", "preemptions",
                "truncated_requests", "prefix_hit_tokens", "spec_proposed", "spec_accepted"):
        assert port[key] == jax[key]


def test_the_data_commands_equal_the_jax_clis_exit_codes_and_json(traced, tmp_path, capsys):
    _, _, _, tmp = traced
    slo = tmp_path / "slo.yaml"
    slo.write_text("objectives:\n  - {name: ttft, expr: 'serve_ttft_seconds p99 < 1e-9'}\n"
                   "  - {name: errors, expr: 'serve_request_errors_total / serve_requests_total < 0.5'}\n"
                   "  - {name: missing, expr: 'never_recorded < 1'}\n")
    sink = str(tmp / "port")
    runner = CliRunner()
    for argv in (["analyze_serve", "--sink_path", sink, "--as_json"],
                 ["analyze_fleet", "--sink_path", sink, "--sink_path", str(tmp / "jax"), "--as_json"],
                 ["check_slo", "--slo_path", str(slo), "--sink_path", sink, "--as_json"],
                 ["check_slo", "--slo_path", str(slo), "--sink_path", sink],
                 ["analyze_serve", "--sink_path", sink],
                 ["check_slo", "--slo_path", str(tmp_path / "absent.yaml")]):
        want = runner.invoke(jax_cli, ["data", *argv])
        capsys.readouterr()
        try:
            got_rc = port_cli(["data", *argv])
        except SystemExit as exc:  # a usage error: argparse exits 2, as click does
            got_rc = exc.code
        got = capsys.readouterr().out
        assert got_rc == want.exit_code
        if "--as_json" in argv:
            assert json.loads(got.strip().splitlines()[-1]) == json.loads(want.output.strip().splitlines()[-1])
        elif want.exit_code in (0, 1):
            assert got == want.output
    assert [want.exit_code, got_rc] == [2, 2]


# ------------------------------------------------------------ the tiers


@pytest.fixture(scope="module")
def tier_records(models, tmp_path_factory):
    """Each package's prefill tier exports, its decode tier imports, under
    one active telemetry: (jax records, port records)."""
    jm, jp, pm, pp = models
    kw = dict(max_batch_slots=2, paged_max_len=64, kv_cache="paged", paged_block_size=8, eod_token_id=-1)
    reqs = [([3, 17, 42, 9, 77, 5, 23, 8, 1], 6), (list(range(1, 18)), 4), ([5, 6], 1)]
    tmp = tmp_path_factory.mktemp("tiers")
    out = []
    for make, telemetry, set_active in (
            (lambda role: JaxServingEngine(jm, jp, role=role, **kw),
             JaxTelemetry(output_folder_path=tmp / "jax", watchdog_deadline_s=0.0, use_jax_annotations=False),
             jax_set_active),
            (lambda role: ServingEngine(pm, pp, device="cpu", role=role, **kw),
             Telemetry(output_folder_path=tmp / "port", watchdog_deadline_s=0.0), set_active_telemetry)):
        prior = set_active(telemetry)
        try:
            prefill, decode = make("prefill"), make("decode")
            rids = [prefill.submit(p, b, temperature=0.0, seed=i, trace_id=f"t{i}") for i, (p, b) in enumerate(reqs)]
            results = prefill.run()
            for rid in rids:
                if results[rid].handoff is not None:
                    decode.import_handoff(results[rid].handoff, trace_hop=1)
            decode.run()
        finally:
            telemetry.close()
            set_active(prior)
        out.append(_records(telemetry.sink_path))
    return out


def test_tier_records_carry_their_role_as_jax(tier_records):
    want, got = tier_records
    key = lambda r: (r.get("role", ""), r["trace_id"])  # noqa: E731
    assert [_shape(r) for r in sorted(got, key=key)] == [_shape(r) for r in sorted(want, key=key)]
    assert {r.get("role") for r in got} == {"prefill", "decode"}
    names = {e["name"] for r in got for e in r["events"]}
    assert {"handoff_export", "import_enqueue", "import_seeded"} <= names


# ------------------------------------------------- degraded, and the router's records


def test_a_burning_worker_reads_degraded_and_the_router_records_each_request(models, tmp_path):
    """A port worker (tiny GPT2, paged) behind the port router, its SLO
    engine on a scripted clock: /healthz "ok", then "degraded" with the
    breaching objective once a sample burns, the router's health round
    marks it degraded; two requests through the router leave two
    `fleet/request` records stitched to the worker's records."""
    _, _, pm, pp = models
    telemetry = Telemetry(output_folder_path=tmp_path, watchdog_deadline_s=0.0)
    prior = set_active_telemetry(telemetry)
    server = router = None
    try:
        engine = ServingEngine(pm, pp, device="cpu", max_batch_slots=2, kv_cache="paged", paged_block_size=8,
                               eod_token_id=-1, metrics=MetricsRegistry())
        server = ServingHTTPServer(engine, encode=lambda s: [int(t) for t in s.split()],
                                   decode=lambda ids: " ".join(map(str, ids)))
        clock = {"t": 0.0}
        objectives, _ = load_slo_spec({"objectives": [{"name": "ttft_p99", "expr": "serve_ttft_seconds p99 < 1e-6"}]})
        slo = SLOEngine(objectives, engine.metrics, time_fn=lambda: clock["t"])
        server.slo_status_fn = slo.breaching
        server.start()
        router = port_router.FleetRouter([port_router.WorkerHandle("w0", "127.0.0.1", server.port)],
                                         metrics=MetricsRegistry(), health_loop=False).start()
        router.health_round()
        health = _get(server.port, "/healthz")
        assert (health["status"], health["slo_breaching"]) == ("ok", [])
        for prompt in ("1 2 3", "4 5"):
            events = _post(router.port, {"prompt": prompt, "max_new_tokens": 3})
            assert events[-1]["finish_reason"] == "budget"
        clock["t"] += 1.0
        slo.sample_once()
        health = _get(server.port, "/healthz")
        assert (health["status"], health["slo_breaching"]) == ("degraded", ["ttft_p99"])
        router.health_round()
        assert [w.degraded for w in router.workers] == [True]
    finally:
        if router is not None:
            router.close()
        if server is not None:
            server.stop()
            server.serve_forever()
        telemetry.close()
        set_active_telemetry(prior)
    traces = analyze.stitch_fleet_traces(analyze.load_fleet_records([tmp_path]))
    assert len(traces) == 2 and all(t["router"]["outcome"] == "done" and len(t["worker_legs"]) == 1
                                    for t in traces)
    assert traces == jax_analyze.stitch_fleet_traces(jax_analyze.load_fleet_records([tmp_path]))


def _get(port, path):
    import http.client

    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=60)
    try:
        conn.request("GET", path)
        return json.loads(conn.getresponse().read())
    finally:
        conn.close()


def _post(port, body):
    import http.client

    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=120)
    try:
        conn.request("POST", "/generate", body=json.dumps(body), headers={"Content-Type": "application/json"})
        raw = conn.getresponse().read()
        return [json.loads(c[6:]) for c in raw.split(b"\n\n") if c.startswith(b"data: ")]
    finally:
        conn.close()

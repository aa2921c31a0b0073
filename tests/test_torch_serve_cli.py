"""The port's `serve` entry end to end on the CPU: the shipped
configs/config_serve.yaml (its tokenizer path rewritten, its `slo` block as
shipped) drives YAML ->
the port's component graph -> ServingEngine -> JSONL rows, through
`python -m modalities_tpu_torch serve ... --device cpu` in process, as the
file stands (the ring cache) and with `kv_cache: paged`, `spec_decode: {k: 4}`
and `quant: {weights: int8, kv: int8}`. The rows' tokens must equal what the
port's engine gives for the same prompts and the same fresh-init weights.

The admission-control knobs (`tenants`, `deadline_default_ms`,
`brownout_queue_high`, `max_queue_depth`) and switches (_QUEUE_LIMIT,
_DEADLINE_DEFAULT_MS, _TENANT_DEFAULT) are applied: JSONL rows with
`deadline_ms` and `tenant` equal the JAX serving component's rows on the same
weights (f32, each engine on a stepped clock). `http_port` and
`--http_port` serve HTTP through the CLI. `serve --fleet` serves copies of
configs/config_fleet.yaml and configs/config_disagg.yaml (their `slo` blocks
as shipped) on an ephemeral router port: two workers, or a prefill and a
decode tier, whose answer equals the port's paged engine on the same
fresh-init weights, each worker with its SLO engine. With
MODALITIES_TPU_SERVE_TELEMETRY_DIR set, a replay leaves one `serve_request`
record a request, which `data analyze_serve` and `data check_slo` read. The
knobs the port lacks are refused, naming their ROADMAP.md item.

Every SLO engine serve() arms here is built and wired as serve() does it, but
its sampler thread is not started (`no_sampler_threads`): a test that judges
calls `sample_once()` itself, so no verdict races the wall clock."""

import json
from pathlib import Path

import pytest
import torch
import yaml

from modalities_tpu_torch.__main__ import main
from modalities_tpu_torch.config.yaml_interp import load_app_config_dict
from modalities_tpu_torch.serving.engine import ServingEngine
from modalities_tpu_torch.serving.serve import build_serving_components
from modalities_tpu_torch.telemetry.slo import SLOEngine

CFG = "configs/config_serve.yaml"
REQUESTS = [
    {"prompt": "t5 t6 t7", "max_new_tokens": 6},
    {"prompt": "t9 t10", "max_new_tokens": 4, "temperature": 0.8, "seed": 3},
    {"prompt": "t1", "max_new_tokens": 3},
]


PAGED_KNOBS = {"kv_cache": "paged", "spec_decode": {"k": 4}, "quant": {"weights": "int8", "kv": "int8"}}
ARMED: list = []  # the SLO engines serve() armed, in order


@pytest.fixture(autouse=True, scope="module")
def no_sampler_threads():
    """SLOEngine.start() records the engine and starts no thread."""
    start = SLOEngine.start
    SLOEngine.start = lambda self: (ARMED.append(self), self)[1]
    yield
    SLOEngine.start = start


def _serve_config(tmp_path_factory, name: str, knobs: dict):
    """(config path, rows) of one `serve` run over REQUESTS: the shipped
    config with its tokenizer path rewritten and `knobs`."""
    from tests.conftest import make_word_level_tokenizer

    workdir = tmp_path_factory.mktemp(name)
    vocab = {f"t{i}": i for i in range(255)}
    vocab["<eod>"] = 255
    make_word_level_tokenizer(vocab, workdir / "tokenizer", unk_token="t0", pad_token="t0", eos_token="<eod>")
    cfg = yaml.safe_load(Path(CFG).read_text())
    cfg["serving_component"]["config"]["tokenizer"]["config"]["pretrained_model_name_or_path"] = str(
        workdir / "tokenizer"
    )
    cfg["serving_component"]["config"].update(knobs)
    cfg_path = workdir / "config_serve.yaml"
    cfg_path.write_text(yaml.safe_dump(cfg))
    req_path = workdir / "requests.jsonl"
    req_path.write_text("\n".join(json.dumps(r) for r in REQUESTS) + "\n")
    out_path = workdir / "results.jsonl"
    assert main(["serve", "--config_file_path", str(cfg_path), "--requests_file_path", str(req_path),
                 "--output_file_path", str(out_path), "--device", "cpu"]) == 0
    rows = [json.loads(line) for line in out_path.read_text().splitlines() if line.strip()]
    return cfg_path, rows


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    return _serve_config(tmp_path_factory, "torch_serve_cli", {})


@pytest.fixture(scope="module")
def served_paged(tmp_path_factory):
    return _serve_config(tmp_path_factory, "torch_serve_cli_paged", PAGED_KNOBS)


def _engine_rows(cfg_path, **engine_kwargs) -> list[list[int]]:
    """The port's engine in process on serve()'s fresh-init weights: REQUESTS' tokens."""
    components = build_serving_components(load_app_config_dict(cfg_path))
    comp = components.serving_component
    params = comp.model.init_params(torch.Generator().manual_seed(0))  # serve()'s fresh init
    engine = ServingEngine(comp.model, params, device="cpu", max_batch_slots=comp.max_batch_slots,
                           eod_token_id=comp._eod_id(), **engine_kwargs)
    rids = [
        engine.submit(comp.tokenizer.tokenize(r["prompt"]), r["max_new_tokens"],
                      temperature=r.get("temperature"), seed=r.get("seed", 0))
        for r in REQUESTS
    ]
    results = engine.run()
    return [results[rid].tokens for rid in rids]


def test_rows_carry_the_jax_serve_keys(served):
    _, rows = served
    assert [row["rid"] for row in rows] == [0, 1, 2]
    for row, req in zip(rows, REQUESTS):
        assert set(row) == {"rid", "prompt", "completion", "tokens", "finish_reason", "truncated", "ttft_s", "latency_s"}
        assert row["prompt"] == req["prompt"]
        assert row["finish_reason"] in ("eod", "budget")
        assert len(row["tokens"]) <= req["max_new_tokens"]
        assert row["latency_s"] >= row["ttft_s"] >= 0.0


def test_rows_equal_the_port_engine_on_the_same_weights(served):
    cfg_path, rows = served
    want = _engine_rows(cfg_path)
    assert [row["tokens"] for row in rows] == want
    comp = build_serving_components(load_app_config_dict(cfg_path)).serving_component
    assert rows[0]["completion"] == comp.tokenizer.decode(want[0])


def test_paged_spec_int8_config_serves_the_engines_rows(served_paged):
    """The config with the paged cache, n-gram speculation at k = 4 and int8
    weights and KV: the rows equal the port's engine in process with the same
    knobs, and every request finishes."""
    cfg_path, rows = served_paged
    assert [row["finish_reason"] in ("eod", "budget") for row in rows] == [True] * len(REQUESTS)
    want = _engine_rows(cfg_path, kv_cache="paged", spec_decode={"k": 4}, quant_weights="int8", quant_kv="int8")
    assert [row["tokens"] for row in rows] == want


@pytest.mark.parametrize("knob,value,stat,want", [
    ("kv_cache", "paged", "kv_cache", "paged"),
    ("spec_decode", {"k": 4}, "spec_k", 4),
    ("quant", {"weights": "none", "kv": "int8"}, "quant_kv", "int8"),
])
def test_paged_knobs_are_applied(served_paged, knob, value, stat, want):
    cfg_path, _ = served_paged
    cfg = load_app_config_dict(cfg_path)
    node = cfg["serving_component"]["config"]
    node.update(kv_cache="paged", spec_decode=None, quant=None)
    node[knob] = value
    comp = build_serving_components(cfg).serving_component
    comp.device = torch.device("cpu")
    comp.params = comp.model.init_params(torch.Generator().manual_seed(0))
    assert comp.build_engine().stats()[stat] == want


REFUSED_KNOBS = [  # (knob, a value the JAX engine would act on, the ROADMAP Queue 1 item that ports it)
    ("device_mesh", {"data_parallel_degree": 1}, 3),
]


def test_unported_engine_features_are_refused_not_ignored(served):
    cfg_path, _ = served
    # the JAX engine would shard over a mesh
    for knob, value, item in REFUSED_KNOBS:
        cfg = load_app_config_dict(cfg_path)
        cfg["serving_component"]["config"][knob] = value
        with pytest.raises(NotImplementedError, match=rf"{knob}.*Queue 1 item {item}"):
            build_serving_components(cfg)


def test_the_shipped_slo_block_is_armed_and_the_replay_traced(served, monkeypatch, tmp_path, capsys):
    """The shipped config with MODALITIES_TPU_SERVE_TELEMETRY_DIR: serve()
    arms one SLO engine with the file's objectives over the registry the
    engine writes, the sink holds one serve_request record a row (its
    tokens and finish reason), and `data analyze_serve` / `data check_slo`
    read it. Sampled once, the file's `error_rate` objective is unjudgeable
    on the live registry: its denominator `serve_requests_total` is a series
    only `check_slo`'s replay rebuilds (as in the JAX package)."""
    cfg_path, rows = served
    req_path = tmp_path / "requests.jsonl"
    req_path.write_text("\n".join(json.dumps(r) for r in REQUESTS) + "\n")
    monkeypatch.setenv("MODALITIES_TPU_SERVE_TELEMETRY_DIR", str(tmp_path / "telemetry"))
    ARMED.clear()
    assert main(["serve", "--config_file_path", str(cfg_path), "--requests_file_path", str(req_path),
                 "--output_file_path", str(tmp_path / "out.jsonl"), "--device", "cpu"]) == 0
    (slo,) = ARMED
    assert [(o.name, o.expr) for o in slo.objectives] == [
        ("ttft_p99", "serve_ttft_seconds p99 < 0.5"),
        ("error_rate", "serve_request_errors_total / serve_requests_total < 0.01")]
    verdicts = slo.sample_once()
    assert verdicts["error_rate"] is None and isinstance(verdicts["ttft_p99"], bool)
    assert slo.registry.get("serve_requests_submitted_total").value() >= len(REQUESTS)
    sink = tmp_path / "telemetry" / "telemetry_rank_0.jsonl"
    records = sorted((json.loads(line) for line in sink.read_text().splitlines()
                      if '"serve_request"' in line), key=lambda r: r["rid"])
    assert [(r["tokens"], r["finish_reason"]) for r in records] == [(len(row["tokens"]), row["finish_reason"])
                                                                   for row in rows]
    capsys.readouterr()
    assert main(["data", "analyze_serve", "--sink_path", str(sink.parent), "--as_json"]) == 0
    summary = json.loads(capsys.readouterr().out)
    assert summary["requests"] == len(REQUESTS) and summary["generated_tokens"] == sum(len(r["tokens"]) for r in rows)
    spec = tmp_path / "slo.yaml"
    spec.write_text(yaml.safe_dump(yaml.safe_load(Path(CFG).read_text())["serving_component"]["config"]["slo"]))
    rc = main(["data", "check_slo", "--slo_path", str(spec), "--sink_path", str(sink.parent), "--as_json"])
    report = json.loads(capsys.readouterr().out)
    assert report["ok"][-1:] == ["error_rate"] and rc == (1 if report["breaching"] else 0)


# ------------------------------------------------------ admission control


ADMISSION_ROWS = [  # four 4-token prompts, one with its own deadline, tenants mixed
    {"prompt": "t5 t6 t7 t8", "max_new_tokens": 6, "tenant": "gold"},
    {"prompt": "t9 t10 t11", "max_new_tokens": 4, "deadline_ms": 0.5},
    {"prompt": "t1 t2", "max_new_tokens": 5, "tenant": "bronze", "deadline_ms": 1e9},
    {"prompt": "t3 t4 t12 t13", "max_new_tokens": 3, "tenant": "gold"},
    {"prompt": "t20 t21", "max_new_tokens": 4, "tenant": " "},
]


def tick_clock():
    state = {"t": 0.0}

    def clock():
        state["t"] += 0.01
        return state["t"]

    return clock


def both_components(cfg_path, knobs: dict):
    """(JAX component, port component) over the served config with `knobs`,
    on the same fresh-init weights in f32 (the JAX init carried across)."""
    import jax
    import numpy as np
    from flax.core import meta

    from modalities_tpu.config.yaml_interp import load_app_config_dict as jax_load_config
    from modalities_tpu.serving.serve import build_serving_components as jax_build
    from modalities_tpu_torch.conversion.from_jax import params_from_jax

    comps = []
    for load, build in ((jax_load_config, jax_build), (load_app_config_dict, build_serving_components)):
        cfg = load(cfg_path)
        cfg["serving_component"]["config"].update(knobs)
        comp = build(cfg).serving_component
        comp.model.with_spec_updates(compute_dtype="float32")
        comps.append(comp)
    jax_comp, port = comps
    jax_comp.params = meta.unbox(jax_comp.model.init_params(jax.random.PRNGKey(0)))
    port.device = torch.device("cpu")
    port.params = params_from_jax(jax.tree.map(np.asarray, jax_comp.params), port.model)
    return jax_comp, port


def replay_both(cfg_path, knobs: dict, rows: list[dict]):
    """run_requests on both components, each engine on a stepped clock:
    (JAX rows, port rows, JAX engine, port engine) with the timing keys
    dropped from the rows."""
    out = []
    for comp in both_components(cfg_path, knobs):
        engine = comp.build_engine()
        engine._now = tick_clock()
        got = [{k: v for k, v in row.items() if k not in ("ttft_s", "latency_s")} for row in comp.run_requests(rows)]
        out.append((got, engine))
    (want, jax_engine), (got, port) = out
    assert got == want
    return want, got, jax_engine, port


APPLIED_KNOBS = [  # (knob, value, what shows it applied on both engines)
    ("tenants", {"gold": {"weight": 3}, "bronze": {"class": "bulk", "max_slots": 1}}, "tenants"),
    ("deadline_default_ms", 0.5, "deadline"),
    ("brownout_queue_high", 2, "shed"),
    ("max_queue_depth", 2, "queue_full"),
]


@pytest.mark.parametrize("knob,value,shows", APPLIED_KNOBS, ids=[k[0] for k in APPLIED_KNOBS])
def test_admission_knobs_are_applied_as_in_jax(served, monkeypatch, knob, value, shows):
    """Each knob once set: the port's rows equal the JAX component's on the
    same weights, and the knob shows where it acts."""
    cfg_path, _ = served
    # deadline_default_ms seeds the switch when it is unset (env before config, as in JAX): unset it so
    # that monkeypatch removes what the seed writes
    monkeypatch.setenv("MODALITIES_TPU_SERVE_DEADLINE_DEFAULT_MS", "0")
    monkeypatch.delenv("MODALITIES_TPU_SERVE_DEADLINE_DEFAULT_MS")
    knobs = {knob: value, "max_batch_slots": 1 if shows == "shed" else 8}
    want, got, jax_engine, port = replay_both(cfg_path, knobs, ADMISSION_ROWS)
    reasons = [row["finish_reason"] for row in got]
    assert reasons[1] == "deadline"  # the row's own deadline, at the queue sweep
    if shows == "tenants":
        rows = port.stats()["tenants"]
        assert set(rows) == {"gold", "bronze", "default"} and rows["gold"]["submitted"] == 2
        assert {t: (r["finished"], r["tokens"]) for t, r in rows.items()} == {
            t: (r["finished"], r["tokens"]) for t, r in jax_engine.stats()["tenants"].items()}
    elif shows == "deadline":
        assert reasons == ["deadline", "deadline", "budget", "deadline", "deadline"]  # only the 1e9 row outlives it
    elif shows == "shed":
        assert "shed" in reasons and port.stats()["shed_requests"] == jax_engine.stats()["shed_requests"] > 0
    else:
        assert port.max_queue_depth == jax_engine.max_queue_depth == 2
        for engine in (jax_engine, port):
            for _ in range(2):
                engine.submit([5, 6], 1)
        assert port.overload_reason() == jax_engine.overload_reason() == "queue_full"
        assert port.retry_after_s("queue_full") == jax_engine.retry_after_s("queue_full")


APPLIED_ADMISSION_ENV = [  # (switch, value, knobs beside it)
    ("MODALITIES_TPU_SERVE_QUEUE_LIMIT", "3", {}),
    ("MODALITIES_TPU_SERVE_DEADLINE_DEFAULT_MS", "0.5", {}),
    ("MODALITIES_TPU_SERVE_TENANT_DEFAULT", "acme", {"tenants": {"acme": {"weight": 2}}}),
]


@pytest.mark.parametrize("name,value,knobs", APPLIED_ADMISSION_ENV,
                         ids=[e[0].removeprefix("MODALITIES_TPU_SERVE_") for e in APPLIED_ADMISSION_ENV])
def test_admission_env_switches_are_applied_as_in_jax(served, monkeypatch, name, value, knobs):
    cfg_path, _ = served
    monkeypatch.setenv(name, value)
    want, got, jax_engine, port = replay_both(cfg_path, knobs, ADMISSION_ROWS)
    if name.endswith("QUEUE_LIMIT"):
        assert port.max_queue_depth == jax_engine.max_queue_depth == 3
    elif name.endswith("DEADLINE_DEFAULT_MS"):
        assert [row["finish_reason"] for row in got].count("deadline") == 4
    else:  # blank and missing tenant ids land on the env default tenant
        rows = port.stats()["tenants"]
        assert rows["acme"]["submitted"] == 2 and "default" not in rows
        assert rows == jax_engine.stats()["tenants"]


@pytest.mark.parametrize("how", ["config", "flag"])
def test_http_port_serves_through_the_cli(served, monkeypatch, how):
    """`http_port: 0` in the config, or `serve --http_port 0`: the CLI serves
    SSE on an ephemeral port, with the tokens the JSONL replay gives, until
    the server drains."""
    import http.client
    import threading

    from modalities_tpu_torch.serving import server as server_module

    cfg_path, rows = served
    if how == "config":
        cfg = yaml.safe_load(Path(cfg_path).read_text())
        cfg["serving_component"]["config"]["http_port"] = 0
        cfg_path = Path(cfg_path).with_name("config_serve_http.yaml")
        cfg_path.write_text(yaml.safe_dump(cfg))
    started = []
    start = server_module.ServingHTTPServer.start
    monkeypatch.setattr(server_module.ServingHTTPServer, "start", lambda self: (start(self), started.append(self))[0])
    argv = ["serve", "--config_file_path", str(cfg_path), "--device", "cpu"]
    if how == "flag":
        argv += ["--http_port", "0"]
    result = []
    thread = threading.Thread(target=lambda: result.append(main(argv)), daemon=True)
    thread.start()
    for _ in range(600):  # the server is up within 60 s
        if started:
            break
        thread.join(0.1)
    server = started[0]
    try:
        conn = http.client.HTTPConnection("127.0.0.1", server.port, timeout=60)
        conn.request("POST", "/generate", body=json.dumps(REQUESTS[0]))
        raw = conn.getresponse().read()
    finally:
        server.stop()
        thread.join(60)
    events = [json.loads(c[len(b"data: "):]) for c in raw.split(b"\n\n") if c.startswith(b"data: ")]
    assert events[-1]["token_ids"] == rows[0]["tokens"] and events[-1]["finish_reason"] == rows[0]["finish_reason"]
    assert result == [0]


def test_sigterm_drains_through_the_preemption_handler():
    """The handler `serve` installs: SIGTERM sets the drain flag (the
    engine's stop_fn) instead of killing the process, and uninstalling
    restores the previous handler."""
    import os
    import signal

    from modalities_tpu_torch.resilience.preemption import PreemptionHandler

    previous = signal.getsignal(signal.SIGTERM)
    with PreemptionHandler() as handler:
        assert not handler.should_stop()
        os.kill(os.getpid(), signal.SIGTERM)
        assert handler.should_stop() and handler.received_signal == "SIGTERM"
        handler.reset()
        handler.request_stop()
        assert handler.should_stop() and handler.received_signal is None
    assert signal.getsignal(signal.SIGTERM) is previous


def test_sigint_ends_the_interactive_loop(served):
    """With neither a requests file nor an HTTP port, `serve` reads prompts
    from stdin and keeps Ctrl-C: SIGINT at the prompt ends the loop and the
    process exits 0 (the drain handler is for HTTP and replays only)."""
    import os
    import signal
    import subprocess
    import sys

    cfg_path, rows = served
    proc = subprocess.Popen([sys.executable, "-m", "modalities_tpu_torch", "serve", "--config_file_path",
                             str(cfg_path), "--device", "cpu"], cwd=Path(__file__).resolve().parents[1],
                            stdin=subprocess.PIPE, stdout=subprocess.PIPE, stderr=subprocess.PIPE)
    try:
        proc.stdin.write((REQUESTS[0]["prompt"] + "\n").encode())
        proc.stdin.flush()
        out = b""
        while out.count(b"serve> ") < 2:  # the completion printed, the next prompt waiting
            chunk = os.read(proc.stdout.fileno(), 4096)
            assert chunk, proc.stderr.read().decode()[-2000:]
            out += chunk
        proc.send_signal(signal.SIGINT)
        rest, err = proc.communicate(timeout=60)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    assert proc.returncode == 0, err.decode()[-2000:]
    # the config's budget: the replay's 6 tokens, then more
    assert out.split(b"serve> ")[1].decode().strip().startswith(rows[0]["completion"] + " ")


APPLIED_ENV = [  # (switches, the stat that shows them applied, its value)
    ({"MODALITIES_TPU_SERVE_KV_CACHE": "paged"}, "kv_cache", "paged"),
    ({"MODALITIES_TPU_SERVE_PREFILL_CHUNKS": "32,8,1"}, "prefill_chunks", 2),  # 9 tokens: 8 + 1 (4 + 4 + 1 before)
    ({"MODALITIES_TPU_SERVE_SPEC_K": "2", "MODALITIES_TPU_SERVE_KV_CACHE": "paged"}, "spec_k", 2),
]


@pytest.mark.parametrize("switches,stat,want", APPLIED_ENV, ids=["KV_CACHE", "PREFILL_CHUNKS", "SPEC_K"])
def test_serving_env_switches_are_applied(served, monkeypatch, tmp_path, switches, stat, want):
    """The JAX serving switches the port has: set, they change what the
    engine runs, as in the JAX CLI; the tokens stay the engine's."""
    from modalities_tpu_torch.serving.serve import serve

    cfg_path, _ = served
    req = {"prompt": " ".join(f"t{i}" for i in range(1, 10)), "max_new_tokens": 4}
    req_path = tmp_path / "requests.jsonl"
    req_path.write_text(json.dumps(req) + "\n")
    for name, value in switches.items():
        monkeypatch.setenv(name, value)
    stats = serve(cfg_path, req_path, tmp_path / "out.jsonl", device="cpu")
    assert stats[stat] == want
    for name in switches:
        monkeypatch.delenv(name)
    ring = serve(cfg_path, req_path, tmp_path / "ring.jsonl", device="cpu")
    assert ring["kv_cache"] == "ring" and ring["prefill_chunks"] == 3
    assert json.loads((tmp_path / "out.jsonl").read_text())["tokens"] == json.loads(
        (tmp_path / "ring.jsonl").read_text())["tokens"]


def test_quant_kv_env_on_the_ring_raises_as_in_jax(served, monkeypatch, tmp_path):
    """MODALITIES_TPU_QUANT_KV=int8 with the ring cache: the JAX engine's
    ValueError (the port used to serve bf16 KV without a word)."""
    cfg_path, _ = served
    req_path = tmp_path / "requests.jsonl"
    req_path.write_text(json.dumps(REQUESTS[0]) + "\n")
    monkeypatch.setenv("MODALITIES_TPU_QUANT_KV", "int8")
    with pytest.raises(ValueError, match="requires kv_cache='paged'"):
        main(["serve", "--config_file_path", str(cfg_path), "--requests_file_path", str(req_path),
              "--output_file_path", str(tmp_path / "out.jsonl"), "--device", "cpu"])


@pytest.mark.parametrize("name", ["config_fleet", "config_disagg"])
def test_serve_fleet_serves_the_fleet_configs(tmp_path, monkeypatch, name):
    """`serve --fleet --http_port 0` on a copy of the shipped file (its tokenizer
    path rewritten, its `slo` block as shipped): POST /generate on the router
    answers with the tokens the port's paged engine gives on the same
    fresh-init weights, each worker has an SLO engine with its share of the
    objectives (a tier its tier's) behind its /healthz, the stop flag drains
    every worker, and the CLI returns 0."""
    import http.client
    import threading

    from modalities_tpu_torch.resilience import preemption
    from modalities_tpu_torch.serving.fleet import router as router_module
    from tests.conftest import make_word_level_tokenizer

    vocab = {f"t{i}": i for i in range(255)}
    vocab["<eod>"] = 255
    make_word_level_tokenizer(vocab, tmp_path / "tokenizer", unk_token="t0", pad_token="t0", eos_token="<eod>")
    cfg = yaml.safe_load((Path("configs") / f"{name}.yaml").read_text())
    cfg["serving_component"]["config"]["tokenizer"]["config"]["pretrained_model_name_or_path"] = str(
        tmp_path / "tokenizer")
    cfg_path = tmp_path / f"{name}.yaml"
    cfg_path.write_text(yaml.safe_dump(cfg))
    routers, handlers = [], []
    start, install = router_module.FleetRouter.start, preemption.PreemptionHandler.install
    monkeypatch.setattr(router_module.FleetRouter, "start", lambda self: (start(self), routers.append(self))[0])
    monkeypatch.setattr(preemption.PreemptionHandler, "install", lambda self: (handlers.append(self), install(self))[1])
    result = []
    ARMED.clear()
    thread = threading.Thread(target=lambda: result.append(main(
        ["serve", "--fleet", "--config_file_path", str(cfg_path), "--device", "cpu", "--http_port", "0"])), daemon=True)
    thread.start()
    for _ in range(600):  # the router is up within 60 s
        if routers:
            break
        thread.join(0.1)
    router = routers[0]
    try:
        conn = http.client.HTTPConnection("127.0.0.1", router.port, timeout=60)
        conn.request("POST", "/generate", body=json.dumps(REQUESTS[0]))
        raw = conn.getresponse().read()
        conn.close()
        assert len(router.workers) == 2 and {w.tier for w in router.workers} == (
            {"serve"} if name == "config_fleet" else {"prefill", "decode"})
        armed = {e.scope: [o.name for o in e.objectives] for e in ARMED}
        assert armed == ({"worker0": ["ttft_p99", "error_rate"], "worker1": ["ttft_p99", "error_rate"]}
                         if name == "config_fleet" else
                         {"prefill0": ["ttft_p99", "error_rate"], "decode0": ["tpot_p99", "error_rate"]})
        for w in router.workers:
            conn = http.client.HTTPConnection("127.0.0.1", w.port, timeout=60)
            conn.request("GET", "/healthz")
            health = json.loads(conn.getresponse().read())
            conn.close()
            assert (health["status"], health["slo_breaching"]) == ("ok", [])
    finally:
        handlers[0].request_stop()
        thread.join(60)
    events = [json.loads(c[len(b"data: "):]) for c in raw.split(b"\n\n") if c.startswith(b"data: ")]
    assert events[-1]["done"] and events[-1]["finish_reason"] == "budget"
    assert events[-1]["token_ids"] == _engine_rows(cfg_path, kv_cache="paged")[0]
    assert result == [0]


def test_serve_fleet_refuses_a_config_of_another_variant(served):
    cfg_path, _ = served
    with pytest.raises(ValueError, match="--fleet needs the fleet serving component"):
        main(["serve", "--fleet", "--config_file_path", str(cfg_path), "--device", "cpu"])

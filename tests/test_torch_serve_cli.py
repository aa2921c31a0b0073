"""The port's `serve` entry end to end on the CPU: the shipped
configs/config_serve.yaml (its tokenizer path rewritten and its `slo` block,
which the port refuses, set to null) drives YAML ->
the port's component graph -> ServingEngine -> JSONL rows, through
`python -m modalities_tpu_torch serve ... --device cpu` in process, as the
file stands (the ring cache) and with `kv_cache: paged`, `spec_decode: {k: 4}`
and `quant: {weights: int8, kv: int8}`. The rows' tokens must equal what the
port's engine gives for the same prompts and the same fresh-init weights.
The engine knobs and environment switches the port has are applied; the
others are refused, naming their ROADMAP.md item."""

import json
from pathlib import Path

import pytest
import torch
import yaml

from modalities_tpu_torch.__main__ import main
from modalities_tpu_torch.config.yaml_interp import load_app_config_dict
from modalities_tpu_torch.serving.engine import ServingEngine
from modalities_tpu_torch.serving.serve import build_serving_components

CFG = "configs/config_serve.yaml"
REQUESTS = [
    {"prompt": "t5 t6 t7", "max_new_tokens": 6},
    {"prompt": "t9 t10", "max_new_tokens": 4, "temperature": 0.8, "seed": 3},
    {"prompt": "t1", "max_new_tokens": 3},
]


PAGED_KNOBS = {"kv_cache": "paged", "spec_decode": {"k": 4}, "quant": {"weights": "int8", "kv": "int8"}}


def _serve_config(tmp_path_factory, name: str, knobs: dict):
    """(config path, rows) of one `serve` run over REQUESTS: the shipped
    config with its tokenizer path rewritten, `slo: null` and `knobs`."""
    from tests.conftest import make_word_level_tokenizer

    workdir = tmp_path_factory.mktemp(name)
    vocab = {f"t{i}": i for i in range(255)}
    vocab["<eod>"] = 255
    make_word_level_tokenizer(vocab, workdir / "tokenizer", unk_token="t0", pad_token="t0", eos_token="<eod>")
    cfg = yaml.safe_load(Path(CFG).read_text())
    cfg["serving_component"]["config"]["tokenizer"]["config"]["pretrained_model_name_or_path"] = str(
        workdir / "tokenizer"
    )
    cfg["serving_component"]["config"]["slo"] = None  # brownout shedding: not ported, refused
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
    ("slo", {"objectives": []}, 6),
    ("max_queue_depth", 4, 3),
    ("deadline_default_ms", 250.0, 3),
    ("brownout_queue_high", 8, 3),
    ("tenants", {"acme": {"weight": 1}}, 3),
    ("http_port", 0, 3),
    ("device_mesh", {"data_parallel_degree": 1}, 3),
]


def test_unported_engine_features_are_refused_not_ignored(served):
    cfg_path, _ = served
    # the JAX engine would shed requests on an SLO breach, bound its queue, run deadlines, brownout and tenants,
    # serve HTTP and shard over a mesh
    for knob, value, item in REFUSED_KNOBS:
        cfg = load_app_config_dict(cfg_path)
        cfg["serving_component"]["config"][knob] = value
        with pytest.raises(NotImplementedError, match=rf"{knob}.*Queue 1 item {item}"):
            build_serving_components(cfg)


UNPORTED_ENV = [  # (switch, a value the JAX CLI would act on, the ROADMAP Queue 1 item that ports it)
    ("MODALITIES_TPU_SERVE_QUEUE_LIMIT", "16", 3),
    ("MODALITIES_TPU_SERVE_DEADLINE_DEFAULT_MS", "250", 3),
    ("MODALITIES_TPU_SERVE_TENANT_DEFAULT", "acme", 3),
    ("MODALITIES_TPU_SERVE_TELEMETRY_DIR", "telemetry", 6),
    ("MODALITIES_TPU_SERVE_WATCHDOG_S", "30", 6),
]
DEFAULT_ENV = {  # values that leave the JAX CLI's result as the port's: these still serve
    "MODALITIES_TPU_SERVE_KV_CACHE": "ring",
    "MODALITIES_TPU_SERVE_PREFILL_CHUNKS": "64,16,4,1",
    "MODALITIES_TPU_SERVE_QUEUE_LIMIT": "0",
    "MODALITIES_TPU_SERVE_SPEC_K": "0",
    "MODALITIES_TPU_SERVE_DEADLINE_DEFAULT_MS": "0",
    "MODALITIES_TPU_SERVE_TENANT_DEFAULT": "",
    "MODALITIES_TPU_SERVE_TELEMETRY_DIR": "",
    "MODALITIES_TPU_SERVE_WATCHDOG_S": "300",
    "MODALITIES_TPU_SERVE_PREFIX_SHARING": "0",  # ignored on the ring cache, as in the JAX engine
}


@pytest.mark.parametrize("name,value,item", UNPORTED_ENV, ids=[e[0].removeprefix("MODALITIES_TPU_SERVE_") for e in UNPORTED_ENV])
def test_unported_env_switches_are_refused_not_ignored(served, monkeypatch, tmp_path, name, value, item):
    cfg_path, rows = served
    req_path = tmp_path / "requests.jsonl"
    req_path.write_text(json.dumps(REQUESTS[0]) + "\n")
    argv = ["serve", "--config_file_path", str(cfg_path), "--requests_file_path", str(req_path),
            "--output_file_path", str(tmp_path / "out.jsonl"), "--device", "cpu"]
    monkeypatch.setenv(name, value)
    with pytest.raises(NotImplementedError, match=rf"{name}.*Queue 1 item {item}"):
        main(argv)
    for default_name, default in DEFAULT_ENV.items():
        monkeypatch.setenv(default_name, default)
    assert main(argv) == 0
    assert json.loads((tmp_path / "out.jsonl").read_text())["tokens"] == rows[0]["tokens"]


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

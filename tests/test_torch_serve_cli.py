"""The port's `serve` entry end to end on the CPU: the shipped
configs/config_serve.yaml (its tokenizer path rewritten and its `slo` block,
which the port refuses, set to null) drives YAML ->
the port's component graph -> ServingEngine -> JSONL rows, through
`python -m modalities_tpu_torch serve ... --device cpu` in process. The rows'
tokens must equal what the port's engine gives for the same prompts and the
same fresh-init weights."""

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


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    from tests.conftest import make_word_level_tokenizer

    workdir = tmp_path_factory.mktemp("torch_serve_cli")
    vocab = {f"t{i}": i for i in range(255)}
    vocab["<eod>"] = 255
    make_word_level_tokenizer(vocab, workdir / "tokenizer", unk_token="t0", pad_token="t0", eos_token="<eod>")
    cfg = yaml.safe_load(Path(CFG).read_text())
    cfg["serving_component"]["config"]["tokenizer"]["config"]["pretrained_model_name_or_path"] = str(
        workdir / "tokenizer"
    )
    cfg["serving_component"]["config"]["slo"] = None  # brownout shedding: not ported, refused
    cfg_path = workdir / "config_serve.yaml"
    cfg_path.write_text(yaml.safe_dump(cfg))
    req_path = workdir / "requests.jsonl"
    req_path.write_text("\n".join(json.dumps(r) for r in REQUESTS) + "\n")
    out_path = workdir / "results.jsonl"
    assert main(["serve", "--config_file_path", str(cfg_path), "--requests_file_path", str(req_path),
                 "--output_file_path", str(out_path), "--device", "cpu"]) == 0
    rows = [json.loads(line) for line in out_path.read_text().splitlines() if line.strip()]
    return cfg_path, rows


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
    components = build_serving_components(load_app_config_dict(cfg_path))
    comp = components.serving_component
    params = comp.model.init_params(torch.Generator().manual_seed(0))  # serve()'s fresh init
    engine = ServingEngine(comp.model, params, device="cpu", max_batch_slots=comp.max_batch_slots,
                           eod_token_id=comp._eod_id())
    rids = [
        engine.submit(comp.tokenizer.tokenize(r["prompt"]), r["max_new_tokens"],
                      temperature=r.get("temperature"), seed=r.get("seed", 0))
        for r in REQUESTS
    ]
    results = engine.run()
    assert [row["tokens"] for row in rows] == [results[rid].tokens for rid in rids]
    assert rows[0]["completion"] == comp.tokenizer.decode(results[rids[0]].tokens)


def test_unported_engine_features_are_refused_not_ignored(served):
    cfg_path, _ = served
    # the JAX engine would run a paged cache, shed requests on an SLO breach, bound its queue
    for knob, value in (("kv_cache", "paged"), ("slo", {"objectives": []}), ("max_queue_depth", 4)):
        cfg = load_app_config_dict(cfg_path)
        cfg["serving_component"]["config"][knob] = value
        with pytest.raises(NotImplementedError, match=rf"{knob}.*Queue 1 item 3"):
            build_serving_components(cfg)


UNPORTED_ENV = [  # (switch, a value the JAX CLI would act on, the ROADMAP Queue 1 item that ports it)
    ("MODALITIES_TPU_SERVE_KV_CACHE", "paged", 3),
    ("MODALITIES_TPU_SERVE_PREFILL_CHUNKS", "32,8,1", 3),
    ("MODALITIES_TPU_SERVE_QUEUE_LIMIT", "16", 3),
    ("MODALITIES_TPU_SERVE_SPEC_K", "2", 3),
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

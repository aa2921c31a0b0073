"""The port's `serve` entry end to end on the CPU: the shipped
configs/config_serve.yaml (only its tokenizer path rewritten) drives YAML ->
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
    cfg = load_app_config_dict(cfg_path)
    cfg["serving_component"]["config"]["kv_cache"] = "paged"
    with pytest.raises(NotImplementedError, match="kv_cache"):
        build_serving_components(cfg)

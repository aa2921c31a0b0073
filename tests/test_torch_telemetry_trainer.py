"""The trainer's telemetry in the port: the step loop under a fake train step
(the JAX package's tests/telemetry/test_trainer_telemetry.py, held to the same
bars), then a tiny GPT2 (configs/config_2p7b_dp.yaml cut to 2 x 128) through
`Main` on the CPU: the default telemetry writes its sink under the experiment
folder, the interval carries JAX's keys, the capture windows write their
files and change no bit of any step, and `oom@2` through the CLI function
leaves an OOM dump and exits 75."""

import json
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from modalities_tpu.telemetry.goodput import BUCKETS as JAX_BUCKETS
from modalities_tpu_torch.__main__ import main as cli_main
from modalities_tpu_torch.dataloader.dataloader import DatasetBatch
from modalities_tpu_torch.main import Main
from modalities_tpu_torch.resilience import AnomalyTracker, faults
from modalities_tpu_torch.resilience.errors import RESUMABLE_EXIT_CODE
from modalities_tpu_torch.telemetry import Telemetry, set_active_telemetry
from modalities_tpu_torch.telemetry.goodput import BUCKETS
from modalities_tpu_torch.trainer import Trainer
from modalities_tpu_torch.training.training_progress import TrainingProgress
from tests.test_torch_run_cli import tiny_config

# the interval keys of the JAX trainer (modalities_tpu/trainer.py:585-623) a CPU run carries; the card adds
# "peak memory [MB]" and "HBM headroom [MB]"
JAX_KEYS = {"train steps/s", "tokens/s", "tokens/s (wall)", "tokens/s (device)", "host stall [s]",
            "boundary stall [s]", "MFU", "MFU (wall)", "MFU (device)", "goodput [%]",
            *(f"goodput/{bucket} [s]" for bucket in JAX_BUCKETS)}
CAPTURE = ("MODALITIES_TPU_PROFILE_AT_STEP", "MODALITIES_TPU_PROFILE_DIR", "MODALITIES_TPU_MEMSCOPE_AT_STEP",
           "MODALITIES_TPU_MEMSCOPE_DIR", "MODALITIES_TPU_MEMSCOPE_FITS_CHECK")


# ------------------------------------------------------- the loop, a fake step


class _Loader(list):
    dataloader_tag = "train"


class _Results:
    def __init__(self):
        self.rows = []

    def consume(self, message) -> None:
        self.rows.append(message)


class _Progress:
    def consume(self, step) -> None:
        pass


class _Mfu:
    def compute(self, tokens_per_s: float) -> float:
        return 0.3


def _fake_step(sleep_s: float = 0.0):
    def step(batch):
        if sleep_s:
            time.sleep(sleep_s)
        return {"loss": torch.tensor(1.0), "grad_norm": torch.tensor(0.5), "lr": torch.tensor(1e-3)}

    return step


def _run_trainer(telemetry, n_steps=4, interval=2, step_sleep_s=0.0, eval_sleep_s=0.01, step=None,
                 anomaly_tracker=None):
    results = _Results()
    trainer = Trainer(_Progress(), results, torch.device("cpu"), gradient_acc_steps=1,
                      global_num_tokens_per_train_step=128, training_log_interval_in_steps=interval,
                      mfu_calculator=_Mfu(), telemetry=telemetry, anomaly_tracker=anomaly_tracker)
    batches = _Loader(DatasetBatch({"input_ids": np.zeros((1, 4), np.int64)}, {"target_ids": np.zeros((1, 4), np.int64)})
                      for _ in range(n_steps))
    trainer.train(step or _fake_step(step_sleep_s), batches, TrainingProgress(0, 0, n_steps, 128 * n_steps),
                  evaluation_callback=lambda s: time.sleep(eval_sleep_s), checkpointing_callback=lambda p: None)
    return results.rows


def test_the_interval_carries_jaxs_keys_and_cumulative_goodput(tmp_path):
    telemetry = Telemetry(output_folder_path=tmp_path, watchdog_deadline_s=0)
    t0 = time.perf_counter()
    rows = _run_trainer(telemetry, step_sleep_s=0.02)
    wall = time.perf_counter() - t0
    telemetry.close()
    assert len(rows) == 2 and BUCKETS == JAX_BUCKETS
    for row in rows:
        assert JAX_KEYS <= set(row["throughput_metrics"]), JAX_KEYS - set(row["throughput_metrics"])
        assert 0.0 <= row["throughput_metrics"]["goodput [%]"] <= 100.0
    first, last = rows[0]["throughput_metrics"], rows[-1]["throughput_metrics"]
    assert last["goodput/train_step [s]"] >= first["goodput/train_step [s]"]
    assert 0.95 * 3 * 0.02 <= last["goodput/train_step [s]"] <= wall  # the 3 steps after the first
    # the window minus the stalls: the boundary's 10 ms evaluation sleeps are out of the device figure
    assert first["boundary stall [s]"] >= 0.01 and first["tokens/s (device)"] > first["tokens/s (wall)"]


def test_the_sink_buckets_tile_the_wall_time_within_5_percent(tmp_path):
    telemetry = Telemetry(output_folder_path=tmp_path, watchdog_deadline_s=0)
    telemetry.ledger.start()
    _run_trainer(telemetry, n_steps=6, step_sleep_s=0.03, eval_sleep_s=0.02)
    summary = telemetry.goodput_summary()
    telemetry.close()
    assert sum(summary["buckets"].values()) == pytest.approx(summary["wall_s"], rel=0.05)
    assert summary["wall_s"] - summary["buckets"]["other"] >= 0.5 * summary["wall_s"], summary
    assert summary["buckets"]["compile_first_step"] >= 0.028  # the first step
    names = {e["name"] for e in map(json.loads, telemetry.sink_path.read_text().splitlines()) if e["event"] == "span"}
    assert {"first_step", "train_step", "data_wait", "metrics_fetch", "publish"} <= names, names


def test_an_slo_block_is_sampled_at_the_publish_and_a_breach_counts_against_the_budget(tmp_path):
    slo = {"objectives": [{"name": "goodput_floor", "expr": "training_goodput_ratio >= 0.0"}]}
    telemetry = Telemetry(output_folder_path=tmp_path, watchdog_deadline_s=0, slo=slo)
    _run_trainer(telemetry, step_sleep_s=0.01)
    engine = telemetry.slo_engine
    assert engine._thread is None and engine.breaching() == []
    assert engine.status()["goodput_floor"]["last_value"] == telemetry.metrics.get("training_goodput_ratio").value()
    telemetry.close()
    waterfalls = [json.loads(line) for line in telemetry.sink_path.read_text().splitlines() if "mfu_waterfall" in line]
    assert len(waterfalls) == 2 and all(sum(w["deductions"].values()) == w["gap"] for w in waterfalls)

    # an objective no run meets: each interval in breach is one anomalous step against a budget of 1
    never = {"objectives": [{"name": "impossible", "expr": "training_goodput_ratio > 2.0"}]}
    tracker = AnomalyTracker(policy="skip_step", skip_budget=1, window_steps=100)
    telemetry = Telemetry(output_folder_path=tmp_path / "breach", watchdog_deadline_s=0, slo=never)
    previous = set_active_telemetry(telemetry)  # the tracker's events go to the active sink
    try:
        with pytest.raises(RuntimeError, match="anomaly skip budget exhausted: 2 anomalous steps.*impossible"):
            _run_trainer(telemetry, n_steps=6, interval=1, anomaly_tracker=tracker)
    finally:
        set_active_telemetry(previous)
        telemetry.close()
    names = [e.get("name") for e in map(json.loads, telemetry.sink_path.read_text().splitlines())]
    assert names.count("anomaly/slo_breach") == 2 and "anomaly/budget_exhausted" in names


def test_a_wedged_step_leaves_a_watchdog_artifact_and_a_clean_run_none(tmp_path):
    telemetry = Telemetry(output_folder_path=tmp_path / "wedged", watchdog_deadline_s=0.15,
                          watchdog_first_step_factor=1.0)
    _run_trainer(telemetry, n_steps=2, step_sleep_s=0.5)
    telemetry.close()
    assert telemetry.watchdog_artifacts, "a 0.5 s step never tripped the 0.15 s deadline"
    artifact = json.loads(telemetry.watchdog_artifacts[0].read_text())
    assert any("MainThread" in key for key in artifact["thread_stacks"])

    telemetry = Telemetry(output_folder_path=tmp_path / "clean", watchdog_deadline_s=5.0)
    _run_trainer(telemetry, step_sleep_s=0.005)
    telemetry.close()
    assert telemetry.watchdog_artifacts == [] and not list((tmp_path / "clean").glob("watchdog_dump_*.json"))
    assert not telemetry._watchdog.is_alive


def test_a_failing_step_stops_the_watchdog_and_the_sink_is_sealed(tmp_path):
    telemetry = Telemetry(output_folder_path=tmp_path, watchdog_deadline_s=5.0)

    def exploding(batch):
        raise RuntimeError("kaboom mid-step")

    with pytest.raises(RuntimeError, match="kaboom"):
        try:
            _run_trainer(telemetry, step=exploding)
        finally:
            telemetry.close()
    assert not telemetry._watchdog.is_alive
    assert json.loads(telemetry.sink_path.read_text().splitlines()[-1])["event"] == "run_summary"


# ------------------------------------------------ a tiny GPT2 through Main


STEPS = 5


def _config(tmp_path: Path, **edits) -> Path:
    return tiny_config(tmp_path, **{"settings.training_target.num_target_steps": STEPS,
                                    "settings.training_target.num_target_tokens": STEPS * 32 * 2 * 2,
                                    "settings.intervals.evaluation_interval_in_steps": STEPS, **edits})


def _snapshot(main: Main, results: list[dict]) -> tuple:
    steps = [(r["losses"]["train loss last"], r["metrics"]["grad norm last"], r["metrics"]["lr mean"])
             for r in results]
    return steps, {k: v.to("cpu", copy=True) for k, v in main.train_step.state_dict().items()}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The same config twice: with the default telemetry (no `telemetry`
    node) and both capture windows armed, and with `telemetry: {enabled:
    false}`."""
    mp = pytest.MonkeyPatch()
    for name in CAPTURE:
        mp.delenv(name, raising=False)
    out = {}
    try:
        for arm in ("on", "off"):
            tmp = tmp_path_factory.mktemp(arm)
            if arm == "on":
                mp.setenv("MODALITIES_TPU_PROFILE_AT_STEP", "2")
                mp.setenv("MODALITIES_TPU_MEMSCOPE_AT_STEP", "3")
                cfg = _config(tmp)
            else:
                mp.delenv("MODALITIES_TPU_PROFILE_AT_STEP")
                mp.delenv("MODALITIES_TPU_MEMSCOPE_AT_STEP")
                cfg = _config(tmp, telemetry={"component_key": "telemetry", "variant_key": "default",
                                              "config": {"enabled": False}})
            main = Main(cfg, device="cpu")
            results = main.run()
            out[arm] = (tmp, main, results, *_snapshot(main, results))
    finally:
        mp.undo()
    return out


def test_a_run_with_no_telemetry_node_writes_the_sink_and_jaxs_interval_keys(runs):
    tmp, main, results, _, _ = runs["on"]
    folder = tmp / "experiments" / main.experiment_id / "telemetry"
    assert (folder / "telemetry_rank_0.jsonl").is_file() and (folder / "goodput_summary.json").is_file()
    assert len(results) == STEPS
    for result in results:
        assert JAX_KEYS <= set(result["throughput_metrics"]), JAX_KEYS - set(result["throughput_metrics"])
    rows = [json.loads(line) for line in (folder.parent / "evaluation_results.jsonl").read_text().splitlines()]
    assert [r["throughput_metrics"].keys() >= JAX_KEYS for r in rows] == [True] * STEPS
    events = [json.loads(line) for line in (folder / "telemetry_rank_0.jsonl").read_text().splitlines()]
    spans = [e["name"] for e in events if e["event"] == "span"]
    assert spans.count("first_step") == 1 and spans.count("train_step") == STEPS - 1 and "init" in spans
    assert {"data_wait", "metrics_fetch", "publish", "checkpoint_drain"} <= set(spans)
    summary = events[-1]
    assert summary["event"] == "run_summary" and summary["buckets"]["compile_first_step"] > 0
    assert sum(summary["buckets"].values()) == pytest.approx(summary["wall_s"], rel=0.05)
    waterfall = [e for e in events if e["event"] == "mfu_waterfall"]
    assert len(waterfall) == STEPS and sum(waterfall[-1]["deductions"].values()) == waterfall[-1]["gap"]
    assert main.telemetry.watchdog_artifacts == [] and not list(folder.glob("watchdog_dump_*.json"))


def test_the_capture_windows_write_their_files(runs):
    tmp, main, *_ = runs["on"]
    folder = tmp / "experiments" / main.experiment_id / "telemetry"
    trace = json.loads((folder / "profile_rank_0_steps_2-2.json").read_text())
    names = {e.get("name") for e in trace["traceEvents"]}
    assert "train_step#2" in names and "train_step" in names and not {"train_step#1", "train_step#3"} & names
    snapshot = json.loads((folder / "memscope_live_arrays_step_3.json").read_text())
    assert snapshot["step"] == 3 and {"total_bytes", "count", "arrays"} <= set(snapshot)
    assert main.trainer.memscope_report is None  # the CPU has no budget: the fits check is inert


def test_telemetry_and_the_capture_windows_change_no_bit(runs):
    on, off = runs["on"], runs["off"]
    assert on[3] == off[3] and len(on[3]) == STEPS
    assert on[4].keys() == off[4].keys()
    assert all(torch.equal(on[4][k], off[4][k]) for k in on[4])
    tmp, main = off[0], off[1]
    assert not (tmp / "experiments" / main.experiment_id / "telemetry").exists()
    assert not {"goodput [%]", "goodput/train_step [s]"} & set(off[2][0]["throughput_metrics"])


def test_oom_at_step_2_leaves_the_dump_and_exits_75_through_the_cli(tmp_path, monkeypatch):
    """Through `run`: a `telemetry` node with an SLO block and a 0.3 s
    watchdog (the first step's deadline stretched past the CPU's build),
    `peer_hang@1:1.5` wedges the loop after step 1 (the watchdog dumps, the
    SLO engine's sample at step 1's publish in the dump's metrics), then
    `oom@2` fails step 2's dispatch: the OOM dump names the levers, the error
    record is resumable and the CLI exits 75."""
    for name in CAPTURE:
        monkeypatch.delenv(name, raising=False)
    monkeypatch.setenv(faults.ENV_VAR, "peer_hang@1:1.5,oom@2")
    monkeypatch.setenv("MODALITIES_TPU_ERROR_LOG_DIR", str(tmp_path / "errors"))
    slo = {"objectives": [{"name": "goodput_floor", "expr": "training_goodput_ratio >= 0.0"}]}
    cfg = _config(tmp_path, telemetry={"component_key": "telemetry", "variant_key": "default", "config": {
        "watchdog_deadline_s": 0.3, "watchdog_first_step_factor": 1000.0, "slo": slo}})
    faults.clear_faults()
    try:
        with pytest.raises(SystemExit) as exit_info:
            cli_main(["run", "--config_file_path", str(cfg), "--device", "cpu"])
    finally:
        faults.clear_faults()
    assert exit_info.value.code == RESUMABLE_EXIT_CODE == 75
    [dump] = list((tmp_path / "experiments").rglob("oom_dump_rank_0_step_2.json"))
    artifact = json.loads(dump.read_text())
    assert artifact["event"] == "oom" and artifact["step"] == 2 and "injected fault: oom at step 2" in artifact["error"]
    assert [lever["lever"] for lever in artifact["suggested_levers"]] == ["zero_stage", "remat",
                                                                         "gradient_accumulation_steps",
                                                                         "paged_num_blocks", "quant_kv"]
    record = json.loads((tmp_path / "errors" / "error_rank_0.json").read_text())
    assert record["resumable"] and "OutOfMemory" in record["error"] and str(dump) in record["error"]
    sink = [json.loads(line) for line in (dump.parent / "telemetry_rank_0.jsonl").read_text().splitlines()]
    assert any(e.get("name") == "fault/oom" and e["step"] == 2 for e in sink) and sink[-1]["event"] == "run_summary"
    rows = [json.loads(line) for line in (dump.parent.parent / "evaluation_results.jsonl").read_text().splitlines()]
    assert len(rows) == 1 and JAX_KEYS <= set(rows[0]["throughput_metrics"])  # step 1 published before step 2 died
    [wedged] = list(dump.parent.glob("watchdog_dump_*.json"))
    metrics = json.loads(wedged.read_text())["metrics"]
    assert any(key.startswith("slo_status") for key in json.dumps(metrics).split('"')), sorted(metrics)[:20]

"""The trainer telemetry's pure parts against the JAX package, on the same
seeded inputs in one process: the MFU waterfall (telemetry/waterfall.py),
the step-time detector and the profiler window's parsing
(telemetry/perfscope.py), memscope's carving, levers, fits check, windows,
OOM test and dump (telemetry/memscope.py), the activation estimate
(utils/recipe_validation.py), the sink readers and tables of `data
analyze_telemetry` in both directions of writer and reader, and the names of
the metrics and sink events the `Telemetry` publish paths write."""

import json
import math
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from modalities_tpu.telemetry import Telemetry as JaxTelemetry
from modalities_tpu.telemetry import goodput as jax_goodput
from modalities_tpu.telemetry import memscope as jax_memscope
from modalities_tpu.telemetry import perfscope as jax_perfscope
from modalities_tpu.telemetry import waterfall as jax_waterfall
from modalities_tpu.training.activation_checkpointing import ActivationCheckpointing as JaxActivationCheckpointing
from modalities_tpu.utils.recipe_validation import _estimate_activation_bytes as jax_estimate
from modalities_tpu_torch.models.gpt2.gpt2_model import GPT2LLM
from modalities_tpu_torch.telemetry import Telemetry
from modalities_tpu_torch.telemetry import goodput, memscope, perfscope, waterfall
from modalities_tpu_torch.training.activation_checkpointing import apply_activation_checkpointing
from modalities_tpu_torch.utils.recipe_validation import _estimate_activation_bytes
from tests.models.test_gpt2_model import tiny_gpt2
from tests.test_torch_gpt2 import port_config

BUCKET_NAMES = ("init", "compile_first_step", "train_step", "data_stall", "eval", "checkpoint", "publish", "other")


# ----------------------------------------------------------------- waterfall


def _waterfall_cases(n=200, seed=20):
    rng = np.random.default_rng(seed)
    for _ in range(n):
        wall = float(rng.uniform(0.0, 500.0)) if rng.random() > 0.05 else 0.0
        buckets = {name: float(rng.uniform(0.0, max(wall, 1.0) / 3)) for name in BUCKET_NAMES}
        collective = None if rng.random() < 0.3 else float(rng.uniform(-0.2, 1.2))
        dcn = None if rng.random() < 0.5 else float(rng.uniform(-0.2, 1.2))
        peak = 1.0 if rng.random() < 0.5 else float(rng.uniform(0.0, 1.5))
        yield float(rng.uniform(-0.1, 1.3)), wall, buckets, peak, collective, dcn


def test_the_waterfall_is_bitwise_jaxs_and_closes_exactly():
    for mfu, wall, buckets, peak, collective, dcn in _waterfall_cases():
        ours = waterfall.mfu_waterfall(mfu, wall, buckets, peak_mfu=peak, collective_frac=collective,
                                       dcn_collective_frac=dcn)
        theirs = jax_waterfall.mfu_waterfall(mfu, wall, buckets, peak_mfu=peak, collective_frac=collective,
                                             dcn_collective_frac=dcn)
        assert ours == theirs
        assert tuple(ours["deductions"]) == waterfall.DEDUCTIONS == jax_waterfall.DEDUCTIONS
        assert sum(ours["deductions"].values()) == ours["gap"] == ours["peak"] - ours["achieved"]
        assert all(v >= 0.0 for v in ours["deductions"].values())
        assert waterfall.format_waterfall_table(ours) == jax_waterfall.format_waterfall_table(theirs)


@pytest.mark.parametrize("report", [
    {"executables": {"train_step": {"buckets": {"matmul": {"est_time_s": 3.0}, "collective:dp": {"est_time_s": 1.0},
                                                "collective:dcn": {"est_time_s": 0.5}}}}},
    {"executables": {"train_step": {"buckets": {"matmul": {"est_time_s": 0.0}}}}},
    {"executables": {}}, {},
], ids=["dcn", "empty-time", "no-step", "no-executables"])
def test_the_collective_fractions_are_jaxs(report):
    assert waterfall.collective_fractions(report) == jax_waterfall.collective_fractions(report)
    assert waterfall.collective_fraction(report) == jax_waterfall.collective_fraction(report)


# --------------------------------------------------------------- perfscope


def _verdicts(module, series, **kwargs):
    detector = module.AnomalyDetector(**kwargs)
    return [tuple(vars(detector.observe(v)).values()) for v in series] + [detector.anomalies]


@pytest.mark.parametrize("seed", range(6))
def test_the_step_time_detector_decides_as_jaxs(seed):
    rng = np.random.default_rng(seed)
    series = rng.lognormal(-2.0, 0.05, size=120)
    series[rng.integers(10, 120, size=6)] *= rng.uniform(2.0, 20.0, size=6)  # slow steps
    if seed % 2:
        series[:30] = 0.125  # a constant window: any deviation scores inf
    kwargs = [{}, {"window": 16, "zscore_threshold": 3.0}, {"min_history": 2, "ewma_alpha": 0.5}][seed % 3]
    ours, theirs = _verdicts(perfscope, series, **kwargs), _verdicts(jax_perfscope, series, **kwargs)
    assert ours == theirs and ours[-1] > 0


def test_the_detector_refuses_a_window_under_two():
    for module in (perfscope, jax_perfscope):
        with pytest.raises(ValueError, match="anomaly window must be >= 2"):
            module.AnomalyDetector(window=1)


def _window(module_cls, monkeypatch, env: dict, fallback):
    for name in ("MODALITIES_TPU_PROFILE_AT_STEP", "MODALITIES_TPU_PROFILE_DIR", "MODALITIES_TPU_MEMSCOPE_AT_STEP",
                 "MODALITIES_TPU_MEMSCOPE_DIR"):
        monkeypatch.delenv(name, raising=False)
    for name, value in env.items():
        monkeypatch.setenv(name, value)
    try:
        window = module_cls.from_env(fallback_dir=fallback)
    except ValueError as e:
        return ("ValueError", str(e))
    return None if window is None else (window.start_step, window.num_steps, window.out_dir)


WINDOW_ENVS = [{}, {"AT_STEP": "3"}, {"AT_STEP": " 2:4 "}, {"AT_STEP": "2:4", "DIR": "/tmp/x"}, {"AT_STEP": "x"},
               {"AT_STEP": "2:"}, {"AT_STEP": "1:2:3"}, {"AT_STEP": "2:0"}]


@pytest.mark.parametrize("env", WINDOW_ENVS, ids=lambda e: repr(e))
@pytest.mark.parametrize("kind", ["PROFILE", "MEMSCOPE"])
def test_the_capture_windows_parse_their_switches_as_jaxs(monkeypatch, tmp_path, env, kind):
    env = {f"MODALITIES_TPU_{kind}_{k}": v for k, v in env.items()}
    ours_cls, theirs_cls = ((perfscope.ProfileWindow, jax_perfscope.ProfileWindow) if kind == "PROFILE"
                            else (memscope.MemscopeWindow, jax_memscope.MemscopeWindow))
    try:
        theirs = _window(theirs_cls, monkeypatch, env, tmp_path)
    except ValueError as e:  # the constructor's rule, num_steps >= 1
        theirs = ("ValueError", str(e))
    try:
        ours = _window(ours_cls, monkeypatch, env, tmp_path)
    except ValueError as e:
        ours = ("ValueError", str(e))
    assert ours == theirs


def test_a_profile_window_on_the_cpu_writes_a_chrome_trace_of_its_steps(tmp_path):
    window = perfscope.ProfileWindow(2, 2, tmp_path)
    x = torch.ones(8, 8)
    for step in range(1, 5):
        window.maybe_start(step)
        with torch.profiler.record_function(f"step{step}"):
            x = x @ x / 8
        window.maybe_stop(step)
    assert window.completed and not window.active and window.trace_path == tmp_path / "profile_rank_0_steps_2-3.json"
    names = {e.get("name") for e in json.loads(window.trace_path.read_text())["traceEvents"]}
    assert {"step2", "step3"} <= names and not {"step1", "step4"} & names


# ----------------------------------------------------------------- memscope


def _categories(rng):
    return {k: int(rng.integers(0, 2**34)) for k in ("argument_bytes", "output_bytes", "temp_bytes", "alias_bytes")}


def _known(rng):
    return {k: int(rng.integers(0, 2**33)) for k in ("params", "optimizer_moments", "gradients_accumulators",
                                                      "kv_pool") if rng.random() < 0.8}


CONTEXTS = [{}, {"kind": "train", "zero_stage": 0, "dp_replicate": 4, "remat_variant": None},
            {"kind": "train", "zero_stage": 1, "dp_replicate": 4, "remat_variant": "full"},
            {"kind": "train", "remat_variant": "selective_layer"},
            {"kind": "serving", "kv_cache": "paged", "paged_num_blocks": 512, "quant_kv": None},
            {"kind": "serving", "kv_cache": "ring", "quant_kv": "int8"}]


@pytest.mark.parametrize("seed", range(8))
def test_carving_and_levers_are_jaxs_and_close(seed):
    rng = np.random.default_rng(seed)
    categories, known = _categories(rng), _known(rng)
    ours = memscope.classify_memory(categories, known)
    assert ours == jax_memscope.classify_memory(categories, known)
    assert sum(ours.values()) == sum(categories.values())
    report = memscope.memscope_from_categories(categories, known, CONTEXTS[seed % len(CONTEXTS)])
    assert sum(report["buckets"].values()) == report["predicted_peak_bytes"] == sum(categories.values())
    for context in CONTEXTS:
        report = {"buckets": ours, "context": context}
        assert memscope.rank_levers(report) == jax_memscope.rank_levers(report)
        assert memscope._format_levers(memscope.rank_levers(report)) == jax_memscope._format_levers(
            jax_memscope.rank_levers(report))


@pytest.mark.parametrize("mode", [None, "fail", " WARN ", "off", "bogus"])
@pytest.mark.parametrize("over", [True, False])
def test_the_fits_check_decides_as_jaxs(mode, over):
    report = {"predicted_peak_bytes": 81 * 2**30, "buckets": {"activations_workspace": 60 * 2**30},
              "context": {"kind": "train", "remat_variant": None}}
    env = {} if mode is None else {memscope.FITS_CHECK_ENV: mode}
    limit = 80 * 2**30 if over else 82 * 2**30
    results = []
    for module in (memscope, jax_memscope):
        try:
            results.append(module.preflight_fits_check(report, bytes_limit=limit, env=env))
        except module.FitsCheckFailure as e:
            # the same levers in the same words; the port names "device" where JAX names "XLA" allocation
            results.append(("FitsCheckFailure", str(e).replace("in XLA allocation", "in device allocation")))
    assert results[0] == results[1]
    if over and mode in (None, "fail", "bogus"):
        assert results[0][0] == "FitsCheckFailure" and "- remat:" in results[0][1]
    # no budget (the CPU): inert in every mode
    assert memscope.preflight_fits_check(report, env=env) == jax_memscope.preflight_fits_check(report, env=env)
    assert memscope.preflight_fits_check(report, env=env)["checked"] is False


@pytest.mark.parametrize("exc", [RuntimeError("RESOURCE_EXHAUSTED: out of HBM"), ValueError("Out of memory"),
                                 RuntimeError("CUDA out of memory. Tried to allocate 2 GiB"), RuntimeError("boom"),
                                 KeyError("memory")], ids=lambda e: type(e).__name__ + ":" + str(e)[:12])
def test_the_oom_test_is_jaxs_and_knows_torchs_error(exc):
    assert memscope.is_oom_error(exc) == jax_memscope.is_oom_error(exc)
    assert memscope.is_oom_error(torch.OutOfMemoryError("allocator"))


@pytest.mark.parametrize("static", [True, False])
def test_the_oom_dump_names_jaxs_levers(tmp_path, static):
    report = ({"buckets": {"activations_workspace": 8 * 2**30, "optimizer_moments": 2**30},
               "context": {"kind": "train", "dp_replicate": 2}} if static else None)
    dumps = {}
    for name, module in (("port", memscope), ("jax", jax_memscope)):
        path = module.write_oom_dump(tmp_path / name, 0, 3, RuntimeError("RESOURCE_EXHAUSTED"), static_report=report)
        dumps[name] = json.loads(path.read_text())
        assert path.name == "oom_dump_rank_0_step_3.json"
    assert dumps["port"]["suggested_levers"] == dumps["jax"]["suggested_levers"]
    assert set(dumps["port"]) == set(dumps["jax"])
    assert dumps["port"]["live_arrays"] == {"total_bytes": 0, "count": 0, "arrays": []}  # the CPU: no allocator


# -------------------------------------------------------- activation estimate


@pytest.mark.parametrize("remat", [None, "full_activation_checkpointing", "selective_layer_activation_checkpointing"])
@pytest.mark.parametrize("chunk", [None, 8])
@pytest.mark.parametrize("degrees,loss_parallel", [({}, False), ({"tp": 2, "cp": 2, "pp": 2}, True),
                                                   ({"tp": 2}, False)], ids=["one", "tp-cp-pp-lp", "tp"])
def test_the_activation_estimate_is_jaxs(remat, chunk, degrees, loss_parallel):
    jax_model = tiny_gpt2("manual", lm_head_chunk_size=chunk)
    model = GPT2LLM(**port_config(lm_head_chunk_size=chunk))
    if remat is not None:
        JaxActivationCheckpointing.apply(jax_model, remat)
        apply_activation_checkpointing(model, remat)
    mesh = SimpleNamespace(degrees=degrees, enable_loss_parallel=loss_parallel)
    profile = SimpleNamespace(local_train_micro_batch_size=3, sequence_length=32)
    ours = _estimate_activation_bytes(model, mesh, profile)
    assert ours == jax_estimate(jax_model, mesh, profile) and ours["total"] > 0


def test_the_estimate_reports_another_family_unavailable():
    other = SimpleNamespace(config_spec=SimpleNamespace(n_embd=8))
    mesh = SimpleNamespace(degrees={}, enable_loss_parallel=False)
    profile = SimpleNamespace(local_train_micro_batch_size=1, sequence_length=8)
    ours, theirs = _estimate_activation_bytes(other, mesh, profile), jax_estimate(other, mesh, profile)
    assert ours == theirs and ours["total"] == 0 and "unavailable" in ours


# ------------------------------------------------------- the sink and tables


def _write_sink(telemetry_cls, folder: Path, ranks=(0, 1, 2)):
    """Each rank's spans (fixed exclusive times, written through the ledger
    path) and one waterfall, as the trainer writes them."""
    rng = np.random.default_rng(5)
    for rank in ranks:
        telemetry = telemetry_cls(output_folder_path=folder, watchdog_deadline_s=0, global_rank=rank)
        telemetry.set_timeline_thread()
        for name in ("init", "first_step", "train_step", "data_wait", "eval/val", "checkpoint_save", "publish",
                     "ckpt_retry/save", "mystery"):
            with telemetry.span(name):
                pass
        # the recorded seconds are the clock's; the tables below read only what the sink holds
        telemetry.ledger.add_seconds("data_stall", float(rng.uniform(0, 2)) * (3 if rank == 2 else 1))
        telemetry.publish_mfu_waterfall(0.25 + 0.1 * rank)
        telemetry.close()
    return folder


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_the_tables_read_alike_in_both_directions(tmp_path, writer):
    folder = _write_sink(Telemetry if writer == "port" else JaxTelemetry, tmp_path / "telemetry")
    ours, theirs = goodput.summarize_sink(folder), jax_goodput.summarize_sink(folder)
    assert ours == theirs and set(ours["ranks"]) == {0, 1, 2}
    assert goodput.straggler_summary(ours) == jax_goodput.straggler_summary(theirs)
    assert goodput.format_goodput_table(ours) == jax_goodput.format_goodput_table(theirs)
    assert (goodput.format_straggler_table(goodput.straggler_summary(ours))
            == jax_goodput.format_straggler_table(jax_goodput.straggler_summary(theirs)))
    one = folder / "telemetry_rank_1.jsonl"
    assert goodput.summarize_sink(one) == jax_goodput.summarize_sink(one)
    assert goodput.straggler_summary(goodput.summarize_sink(one)) == {}
    ours_w, theirs_w = waterfall.last_waterfall_from_sink(folder), jax_waterfall.last_waterfall_from_sink(folder)
    assert ours_w == theirs_w and sum(ours_w["deductions"].values()) == ours_w["gap"]
    assert waterfall.format_waterfall_table(ours_w) == jax_waterfall.format_waterfall_table(theirs_w)


def test_empty_and_torn_sinks_read_as_jaxs(tmp_path):
    (tmp_path / "empty").mkdir()
    assert goodput.summarize_sink(tmp_path / "empty") == jax_goodput.summarize_sink(tmp_path / "empty")
    assert goodput.format_goodput_table(goodput.summarize_sink(tmp_path / "empty")) == "no telemetry span records found"
    assert waterfall.last_waterfall_from_sink(tmp_path / "empty") is None
    torn = tmp_path / "telemetry_rank_0.jsonl"
    torn.write_text('{"event": "span", "name": "train_step", "ts": 1.0, "dur_s": 2.0, "self_s": 2.0, '
                    '"thread": "t", "timeline": true, "rank": 0}\n{"event": "mfu_waterfall", "peak": 1.0, "achieved": '
                    '0.5, "gap": 0.5, "deductions": {"collective_exposure": 0.5}}\n{"event": "sp')
    assert goodput.summarize_sink(torn) == jax_goodput.summarize_sink(torn)
    assert waterfall.last_waterfall_from_sink(torn) == jax_waterfall.last_waterfall_from_sink(torn)


# ------------------------------------------------- the publish paths' names


def _publish_all(telemetry):
    telemetry.publish_resource_gauges(hbm_headroom_mb=1024.0, peak_memory_mb=2048.0)
    telemetry.throughput_metrics()
    for seconds in [0.1] * 12 + [5.0]:
        telemetry.observe_step_time(seconds, step_id=7)
    telemetry.publish_mfu_waterfall(0.4)
    telemetry.publish_memory_timeline({"step": 3, "executable": "train_step", "bytes_in_use": 5,
                                       "headroom_bytes": {"cuda:0": 10}})
    telemetry.publish_memscope_report({"buckets": {"params": 1, "other": 2}})
    telemetry.throughput_metrics()


def test_the_publish_paths_write_jaxs_metrics_and_events(tmp_path):
    names, events = {}, {}
    for name, cls in (("port", Telemetry), ("jax", JaxTelemetry)):
        telemetry = cls(output_folder_path=tmp_path / name, watchdog_deadline_s=0)
        _publish_all(telemetry)
        names[name] = set(telemetry.metrics.snapshot())
        telemetry.close()
        rows = [json.loads(line) for line in (tmp_path / name / "telemetry_rank_0.jsonl").read_text().splitlines()]
        events[name] = [(r["event"], r.get("name"), sorted(r)) for r in rows if r["event"] != "span"]
    assert names["port"] == names["jax"] and "training_step_time_anomaly_total" in names["port"]
    assert events["port"] == events["jax"]
    assert ("resilience", "anomaly/step_time", ["event", "ewma_s", "name", "rank", "seconds", "step_id",
                                               "zscore"]) in events["port"]
    disabled = Telemetry(enabled=False)
    _publish_all(disabled)
    assert disabled.throughput_metrics() == {} and disabled.publish_mfu_waterfall(0.5) is None


def test_the_slo_engine_is_built_unstarted_and_judges_the_ledger_gauge(tmp_path):
    slo = {"objectives": [{"name": "goodput_floor", "expr": "training_goodput_ratio >= 0.0"}]}
    telemetry = Telemetry(output_folder_path=tmp_path, watchdog_deadline_s=0, slo=slo)
    engine = telemetry.slo_engine
    assert engine is not None and engine._thread is None
    telemetry.throughput_metrics()
    engine.sample_once()
    assert engine.status()["goodput_floor"]["last_value"] == telemetry.metrics.get("training_goodput_ratio").value()
    assert engine.breaching() == [] and not math.isnan(engine.status()["goodput_floor"]["last_value"])
    telemetry.close()


# ------------------------------------------------- the train step's report


@pytest.mark.parametrize("remat", [None, "full_activation_checkpointing"])
def test_the_train_steps_static_report_reads_the_live_tensors_and_closes(remat):
    """`TrainStep.memscope_report` before the first update counts the
    moments the update will make, and after it reads the same bytes off the
    optimizer's state; the activation bucket is the JAX estimate at the
    batch's microbatch and the model's remat variant; the buckets sum to the
    predicted peak."""
    from tests.test_torch_train_step import _batches, _port_chunked

    model, step = _port_chunked(None, "off", None, remat=remat)
    batch = {"samples": {"input_ids": torch.zeros((2, 3, 32), dtype=torch.int64)},
             "targets": {"target_ids": torch.zeros((2, 3, 32), dtype=torch.int64)}}
    before = step.memscope_report(batch)
    params = sum(p.numel() * p.element_size() for p in step.params)
    count = sum(p.numel() for p in step.params)
    assert before["known_bytes"] == {"params": params, "optimizer_moments": 2 * params + 4 * len(step.params),
                                     "gradients_accumulators": 4 * count + params}
    estimate = _estimate_activation_bytes(model, SimpleNamespace(degrees={}, enable_loss_parallel=False),
                                          SimpleNamespace(local_train_micro_batch_size=3, sequence_length=32))
    assert before["activation_estimate"] == estimate
    assert before["buckets"]["activations_workspace"] == estimate["total"] > 0
    assert sum(before["buckets"].values()) == before["predicted_peak_bytes"]
    assert before["context"] == {"kind": "train", "zero_stage": 0, "gradient_accumulation_steps": step.acc_steps,
                                 "dp_replicate": 1, "remat_variant": None if remat is None else "full"}
    assert [lever["lever"] for lever in before["levers"]][:1] == (["remat"] if remat is None
                                                                  else ["gradient_accumulation_steps"])
    first = next(iter(_batches()))
    step({part: {k: torch.from_numpy(v.astype(np.int64)) for k, v in first[part].items()} for part in first})
    assert step.memscope_report(batch)["known_bytes"] == before["known_bytes"]


# --------------------------------------- checkpoint-IO retries and resume fallbacks


def test_retries_and_resume_fallbacks_record_jaxs_spans_and_events(tmp_path):
    """Under an active telemetry each package's `retry_io` runs every retry in
    a `ckpt_retry/<what>` span (bucket recovery), and `resolve_resume_folder`
    records each fallback step as the same event: the sinks hold the same
    names, folders and reasons."""
    from modalities_tpu.resilience import manifest as jax_manifest
    from modalities_tpu.resilience.retry import retry_io as jax_retry_io
    from modalities_tpu.telemetry import set_active_telemetry as jax_set_active
    from modalities_tpu_torch.resilience import manifest
    from modalities_tpu_torch.resilience.retry import retry_io
    from modalities_tpu_torch.telemetry import set_active_telemetry
    from tests.test_torch_checkpointing import _fake_checkpoint, _pointer

    ring = tmp_path / "ring"
    folders = [_fake_checkpoint(ring, f"eid_a-seen_steps_{s}-x") for s in (4, 8, 12, 16)]
    for folder in folders:
        manifest.write_manifest(folder)
    (folders[3] / ".metadata").write_text("{ corrupted")
    (folders[2] / "state" / "arrays.bin").unlink()
    info = _pointer(ring, folders[3])
    sinks = {}
    for name, telemetry_cls, activate, resolve, retry in (
            ("port", Telemetry, set_active_telemetry, manifest.resolve_resume_folder, retry_io),
            ("jax", JaxTelemetry, jax_set_active, jax_manifest.resolve_resume_folder, jax_retry_io)):
        telemetry = telemetry_cls(output_folder_path=tmp_path / name, watchdog_deadline_s=0)
        telemetry.set_timeline_thread()
        previous = activate(telemetry)
        try:
            assert resolve(info) == folders[1]
            assert resolve(info, exclude_steps={16, 8}) == folders[0]
            calls = []

            def flaky():
                calls.append(1)
                if len(calls) < 3:
                    raise OSError("transient")
                return "ok"

            assert retry(flaky, "save", attempts=4, base_delay_s=0.0) == "ok"
        finally:
            activate(previous)
            telemetry.close()
        rows = [json.loads(line) for line in (tmp_path / name / "telemetry_rank_0.jsonl").read_text().splitlines()]
        sinks[name] = [(r["event"], r.get("name"), r.get("folder"), r.get("reason"), r.get("attempt"))
                       for r in rows if r["event"] in ("span", "resilience")]
        assert json.loads(telemetry.sink_path.read_text().splitlines()[-1])["buckets"]["recovery"] >= 0.0
    assert sinks["port"] == sinks["jax"]
    names = [row[1] for row in sinks["port"]]
    assert names.count("ckpt_retry/save") == 2 and names.count("ckpt_retry/attempt") == 2
    assert {"rollback/pointer_target_corrupt", "rollback/pointer_target_burned", "rollback/fallback_folder",
            "rollback/candidate_corrupt"} <= set(names)

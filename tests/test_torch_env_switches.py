"""The JAX package's environment switches that the port used to neither
apply nor refuse (ROADMAP.md Queue 3 item 17), each at a non-default value:

- MODALITIES_TPU_FUSED_CE is applied with the JAX precedence (env before the
  config's `lm_head_fused_ce`, case-folded, off = the chunked-scan head):
  under `=off` a tiny train step whose config asks for the fused-CE head
  equals the JAX builder's chunked-scan step at 1e-5;
- MODALITIES_TPU_FUSED_RMSNORM, _QUANT_MATMUL and _RING_IMPL: a value naming
  what the port runs is accepted, one that would run the plain version on
  the card is refused naming Queue 3 item 17, a malformed one raises;
- MODALITIES_TPU_PROFILE_AT_STEP, _PROFILE_DIR, _MEMSCOPE_AT_STEP,
  _MEMSCOPE_DIR and _MEMSCOPE_FITS_CHECK, refused at `run` until the
  trainer's telemetry was ported, are applied by the trainer: the profile
  window's trace and the allocator snapshots land at their steps and in
  their folders, and `warn` lets an over-budget step run where the default
  fails it;
- MODALITIES_TPU_LOG_LEVEL sets the port's logger level, as the JAX one's;
- the fleet's MODALITIES_TPU_FLEET_RETRY_BUDGET_RATIO, _PROBE_BACKOFF_MAX_S,
  _HEALTH_DEADLINE_S, _PROBATION_S, _POLL_S and
  MODALITIES_TPU_DISAGG_HANDOFF_TIMEOUT_S are applied where the JAX package
  applies them: the object built with its knob left None takes the env value,
  as the JAX object does;
- MODALITIES_TPU_SERVE_TELEMETRY_DIR and _WATCHDOG_S arm serve()'s
  telemetry (the sink's folder, the watchdog's deadline, 0 = off) as the JAX
  serve() arms it, and MODALITIES_TPU_SLO_SAMPLE_S sets an SLO engine's
  interval where its spec sets none, in both packages."""

import json
import logging

import jax
import numpy as np
import pytest
import torch

from modalities_tpu_torch.__main__ import main
from modalities_tpu_torch.conversion.from_jax import params_from_jax
from modalities_tpu_torch.models.gpt2.gpt2_model import GPT2LLM
from modalities_tpu_torch.ops.tiers import check_ring_impl, fused_ce_enabled
from modalities_tpu_torch.parallel.ring_attention import ring_attention
from tests.test_torch_gpt2 import port_config
from tests.test_torch_train_step import TOL, _batches, _jax_chunked, _port_chunked


@pytest.mark.parametrize("value", ["off", "OFF", " 0 ", "false"])
def test_fused_ce_off_takes_the_chunked_scan_as_jax(monkeypatch, value):
    """The config says `on`; MODALITIES_TPU_FUSED_CE says off: the port's step
    takes the chunked scan and equals the JAX chunked-scan step."""
    monkeypatch.setenv("MODALITIES_TPU_FUSED_CE", value)
    fns = _jax_chunked(8)
    state = fns.app_state_handle.state
    params0 = jax.tree.map(np.array, state.params)
    _, step = _port_chunked(8, "on", params_from_jax(params0, GPT2LLM(**port_config(use_weight_tying=True))))
    assert step.fused_ce is False
    batch = next(_batches())
    state, jm = fns.train_step(state, fns.put_batch(batch))
    pm = step({k: {kk: torch.from_numpy(v) for kk, v in d.items()} for k, d in batch.items()})
    for key in ("loss", "grad_norm", "lr"):
        np.testing.assert_allclose(float(pm[key]), float(jm[key]), err_msg=key, **TOL)


@pytest.mark.parametrize("env,config,want", [
    (None, "auto", True), (None, "off", False), ("on", "off", True), ("Auto", "off", True), ("force", "off", True),
    ("no", "auto", False), (None, None, True),
])
def test_fused_ce_precedence_is_env_then_config(monkeypatch, env, config, want):
    from modalities_tpu.ops.cross_entropy import fused_ce_tier

    if env is None:
        monkeypatch.delenv("MODALITIES_TPU_FUSED_CE", raising=False)
    else:
        monkeypatch.setenv("MODALITIES_TPU_FUSED_CE", env)
    assert fused_ce_enabled(config) is want
    if (env if env is not None else config or "auto").strip().lower() != "auto":
        # the JAX tier agrees; its `auto` is the kernel on a TPU only, the port's the kernel route
        assert fused_ce_tier(config).enabled is want


@pytest.mark.parametrize("value", ["maybe", ""])
def test_malformed_fused_ce_raises_as_jax(monkeypatch, value):
    from modalities_tpu.ops.cross_entropy import fused_ce_tier

    monkeypatch.setenv("MODALITIES_TPU_FUSED_CE", value)
    with pytest.raises(ValueError, match="expected one of auto/on/off"):
        fused_ce_tier("auto")
    with pytest.raises(ValueError, match="MODALITIES_TPU_FUSED_CE.*expected one of auto/on/off"):
        _port_chunked(8, "auto", GPT2LLM(**port_config(use_weight_tying=True)).init_train_params(
            torch.Generator().manual_seed(0)))


KERNEL_SWITCHES = ["MODALITIES_TPU_FUSED_RMSNORM", "MODALITIES_TPU_QUANT_MATMUL"]


@pytest.mark.parametrize("name", KERNEL_SWITCHES, ids=["FUSED_RMSNORM", "QUANT_MATMUL"])
def test_kernel_switches_accept_the_kernel_refuse_the_plain_version(monkeypatch, name):
    model = GPT2LLM(**port_config())
    for value in ("on", "auto", "1", "force", "AUTO"):
        monkeypatch.setenv(name, value)
        model.init_params(torch.Generator().manual_seed(0))  # builds the module: accepted
    for value in ("off", "0", "no", "False"):
        monkeypatch.setenv(name, value)
        with pytest.raises(NotImplementedError, match=rf"{name}.*Queue 3 item 17"):
            model.init_params(torch.Generator().manual_seed(0))
    monkeypatch.setenv(name, "sometimes")
    with pytest.raises(ValueError, match=rf"{name}.*expected one of auto/on/off"):
        model.init_params(torch.Generator().manual_seed(0))


def test_ring_impl_accepts_flash_refuses_dense_and_the_interpreter(monkeypatch):
    q = k = v = torch.zeros(1, 4, 2, 8)
    monkeypatch.setenv("MODALITIES_TPU_RING_IMPL", "flash")
    check_ring_impl()
    for value in ("dense", "flash_interpret"):
        monkeypatch.setenv("MODALITIES_TPU_RING_IMPL", value)
        with pytest.raises(NotImplementedError, match="MODALITIES_TPU_RING_IMPL.*Queue 3 item 17"):
            ring_attention(q, k, v, None)
    monkeypatch.setenv("MODALITIES_TPU_RING_IMPL", "Flash")  # JAX does not case-fold this one
    with pytest.raises(ValueError, match="expected dense | flash | flash_interpret"):
        ring_attention(q, k, v, None)


CAPTURE = ["MODALITIES_TPU_PROFILE_AT_STEP", "MODALITIES_TPU_PROFILE_DIR", "MODALITIES_TPU_MEMSCOPE_AT_STEP",
           "MODALITIES_TPU_MEMSCOPE_DIR", "MODALITIES_TPU_MEMSCOPE_FITS_CHECK"]


class _OverBudgetStep:
    """A fake train step whose static report exceeds the budget the test
    gives the trainer."""

    def __call__(self, batch):
        return {"loss": torch.tensor(1.0), "grad_norm": torch.tensor(0.5), "lr": torch.tensor(1e-3)}

    def memscope_report(self, batch):
        from modalities_tpu_torch.telemetry.memscope import memscope_from_categories

        return memscope_from_categories({"argument_bytes": 2**30, "temp_bytes": 2**31}, {"params": 2**30},
                                        {"kind": "train"})


def _trainer_run(tmp_path, monkeypatch, budget=None):
    """4 steps of a fake step through the port's Trainer with a telemetry
    sink in tmp_path/telemetry; `budget` stands in for the card's memory."""
    from modalities_tpu_torch import trainer as trainer_module
    from modalities_tpu_torch.dataloader.dataloader import DatasetBatch
    from modalities_tpu_torch.telemetry import Telemetry
    from modalities_tpu_torch.training.training_progress import TrainingProgress

    if budget is not None:
        monkeypatch.setattr(trainer_module, "min_bytes_limit", lambda devices=None: budget)

    class Loader(list):
        dataloader_tag = "train"

    class Sink:
        def consume(self, message):
            pass

    telemetry = Telemetry(output_folder_path=tmp_path / "telemetry", watchdog_deadline_s=0)
    trainer = trainer_module.Trainer(Sink(), Sink(), torch.device("cpu"), global_num_tokens_per_train_step=4,
                                     telemetry=telemetry)
    batch = DatasetBatch({"input_ids": np.zeros((1, 4), np.int64)}, {"target_ids": np.zeros((1, 4), np.int64)})
    try:
        trainer.train(_OverBudgetStep(), Loader([batch] * 4), TrainingProgress(0, 0, 4, 16), lambda s: None,
                      lambda p: None)
    finally:
        telemetry.close()
    return trainer


@pytest.mark.parametrize("name,value", list(zip(CAPTURE, ["3", "profiles", "2:2", "snapshots", "warn"])),
                         ids=[c.removeprefix("MODALITIES_TPU_") for c in CAPTURE])
def test_capture_switches_are_refused_at_run(monkeypatch, tmp_path, name, value):
    """(The name is the refusal's, kept; since the trainer's telemetry was
    ported each switch is applied.) `run` no longer refuses the switch, and
    the trainer does what the JAX trainer does with it."""
    for other in CAPTURE:
        monkeypatch.delenv(other, raising=False)
    monkeypatch.setenv(name, value)
    monkeypatch.setenv("MODALITIES_TPU_ERROR_LOG_DIR", str(tmp_path / "errors"))
    with pytest.raises(FileNotFoundError):  # past the switches, to the missing config
        main(["run", "--config_file_path", str(tmp_path / "never_read.yaml"), "--device", "cpu"])
    monkeypatch.chdir(tmp_path)  # a relative folder switch lands here
    if name.endswith("_DIR"):  # a folder switch needs its window armed
        monkeypatch.setenv(name.replace("_DIR", "_AT_STEP"), "1")
    telemetry = tmp_path / "telemetry"
    if name == "MODALITIES_TPU_MEMSCOPE_FITS_CHECK":
        from modalities_tpu_torch.telemetry.memscope import FitsCheckFailure

        assert _trainer_run(tmp_path, monkeypatch, budget=2**31).memscope_report["predicted_peak_bytes"] == 3 * 2**30
        monkeypatch.delenv(name)
        with pytest.raises(FitsCheckFailure, match="predicted per-device peak 3.00 GiB exceeds"):
            _trainer_run(tmp_path, monkeypatch, budget=2**31)
        return
    trainer = _trainer_run(tmp_path, monkeypatch)
    if name == "MODALITIES_TPU_PROFILE_AT_STEP":
        assert trainer.profile_window.trace_path == telemetry / "profile_rank_0_steps_3-3.json"
    elif name == "MODALITIES_TPU_PROFILE_DIR":
        assert trainer.profile_window.trace_path.resolve() == tmp_path / "profiles" / "profile_rank_0_steps_1-1.json"
    elif name == "MODALITIES_TPU_MEMSCOPE_AT_STEP":
        assert sorted(p.name for p in telemetry.glob("memscope_*.json")) == [
            "memscope_live_arrays_step_2.json", "memscope_live_arrays_step_3.json"]
    else:
        [snapshot] = list((tmp_path / "snapshots").iterdir())
        assert snapshot.name == "memscope_live_arrays_step_1.json" and json.loads(snapshot.read_text())["step"] == 1


def test_log_level_switch_sets_the_ports_logger(monkeypatch, tmp_path):
    """MODALITIES_TPU_LOG_LEVEL=warning (case-folded, as in JAX) silences the
    package's INFO records; a level logging does not know raises."""
    package = logging.getLogger("modalities_tpu_torch")
    before = package.level
    monkeypatch.setenv("MODALITIES_TPU_ERROR_LOG_DIR", str(tmp_path / "errors"))
    try:
        monkeypatch.setenv("MODALITIES_TPU_LOG_LEVEL", "warning")
        with pytest.raises(FileNotFoundError):  # `run` stops right after the CLI's setup: no config
            main(["run", "--config_file_path", str(tmp_path / "x.yaml"), "--device", "cpu"])
        assert package.level == logging.WARNING
        assert not logging.getLogger("modalities_tpu_torch.serving.serve").isEnabledFor(logging.INFO)
        monkeypatch.setenv("MODALITIES_TPU_LOG_LEVEL", "chatty")
        with pytest.raises(ValueError, match="Unknown level"):
            main(["run", "--config_file_path", str(tmp_path / "x.yaml"), "--device", "cpu"])
    finally:
        package.setLevel(before)


class _Engine:
    weights_generation = 0


def _fleet_objects(pkg, tmp_path):
    """The knob each switch sets, read off the object built with it left None."""
    if pkg == "jax":
        from modalities_tpu.serving import resilience
        from modalities_tpu.serving.disagg.router import DisaggRouter
        from modalities_tpu.serving.fleet import controller, router, watcher
    else:
        from modalities_tpu_torch.serving import resilience
        from modalities_tpu_torch.serving.disagg.router import DisaggRouter
        from modalities_tpu_torch.serving.fleet import controller, router, watcher
    handle = lambda name: router.WorkerHandle(name, "127.0.0.1", 1)  # noqa: E731
    return {
        "MODALITIES_TPU_FLEET_RETRY_BUDGET_RATIO": resilience.RetryBudget().ratio,
        "MODALITIES_TPU_FLEET_PROBE_BACKOFF_MAX_S": resilience.ProbeBackoff().max_s,
        "MODALITIES_TPU_FLEET_HEALTH_DEADLINE_S": router.FleetRouter([handle("w")]).heartbeat_deadline_s,
        "MODALITIES_TPU_FLEET_PROBATION_S": controller.RolloutController(
            [controller.EngineWorker("w", _Engine())]).probation_s,
        "MODALITIES_TPU_FLEET_POLL_S": watcher.CheckpointWatcher(tmp_path, lambda *a: None,
                                                                 load_fn=lambda *a, **k: None).poll_interval_s,
        "MODALITIES_TPU_DISAGG_HANDOFF_TIMEOUT_S": DisaggRouter([handle("p")], [handle("d")]).handoff_timeout_s,
    }


FLEET_SWITCHES = {"MODALITIES_TPU_FLEET_RETRY_BUDGET_RATIO": "0.35", "MODALITIES_TPU_FLEET_PROBE_BACKOFF_MAX_S": "3.5",
                  "MODALITIES_TPU_FLEET_HEALTH_DEADLINE_S": "1.25", "MODALITIES_TPU_FLEET_PROBATION_S": "7",
                  "MODALITIES_TPU_FLEET_POLL_S": "0.5", "MODALITIES_TPU_DISAGG_HANDOFF_TIMEOUT_S": "12.5"}


@pytest.mark.parametrize("name", sorted(FLEET_SWITCHES), ids=lambda n: n.removeprefix("MODALITIES_TPU_"))
def test_fleet_switches_are_applied_as_jax(monkeypatch, tmp_path, name):
    defaults = _fleet_objects("port", tmp_path)[name], _fleet_objects("jax", tmp_path)[name]
    monkeypatch.setenv(name, FLEET_SWITCHES[name])
    assert _fleet_objects("port", tmp_path)[name] == _fleet_objects("jax", tmp_path)[name] == float(FLEET_SWITCHES[name])
    assert defaults[0] == defaults[1] != float(FLEET_SWITCHES[name])


class _StopAfterTelemetry(Exception):
    """Raised where serve() loads its config: the run stops once its telemetry is armed."""


def _serve_telemetry(pkg: str, monkeypatch, tmp_path):
    """What serve() arms from the environment before it reads its config, in
    each package: (watchdog deadline, watchdog on, sink file name relative
    to the folder), or None without telemetry. The run stops at the config
    load. The JAX serve() reads its config before its try block, so its
    telemetry stays active after that exception: the previous one is
    restored here, and the armed one closed."""
    import importlib

    telemetry_mod = importlib.import_module("modalities_tpu.telemetry" if pkg == "jax" else
                                            "modalities_tpu_torch.telemetry")
    serve_mod = importlib.import_module("modalities_tpu.serving.serve" if pkg == "jax" else
                                        "modalities_tpu_torch.serving.serve")
    armed = []
    real = telemetry_mod.set_active_telemetry

    def record(telemetry):
        if telemetry is not None and telemetry is not telemetry_mod.NOOP_TELEMETRY:
            armed.append(telemetry)
        return real(telemetry)

    def stop(*args, **kwargs):
        raise _StopAfterTelemetry

    prior = telemetry_mod.get_active_telemetry()
    try:
        with monkeypatch.context() as patch:
            patch.setattr(telemetry_mod, "set_active_telemetry", record)
            patch.setattr(serve_mod, "load_app_config_dict", stop)
            with pytest.raises(_StopAfterTelemetry):
                serve_mod.serve(tmp_path / "never_read.yaml")
    finally:
        real(prior)
        for telemetry in armed:
            telemetry.close()
    if not armed:
        return None
    (telemetry,) = armed
    return (telemetry.watchdog_deadline_s, telemetry.enabled and telemetry.watchdog_deadline_s > 0,
            telemetry.sink_path.relative_to(tmp_path / pkg).as_posix())


@pytest.mark.parametrize("watchdog_s", [None, "45", "0"], ids=["TELEMETRY_DIR", "WATCHDOG_S", "WATCHDOG_S_off"])
def test_serve_telemetry_switches_are_applied_as_jax(monkeypatch, tmp_path, watchdog_s):
    """MODALITIES_TPU_SERVE_TELEMETRY_DIR arms process telemetry with its
    sink in the folder (`telemetry_rank_0.jsonl`), and
    MODALITIES_TPU_SERVE_WATCHDOG_S sets the watchdog's deadline (300 s
    unset; 0 turns the watchdog off), in both packages; unset, serve() arms
    no telemetry."""
    monkeypatch.delenv("MODALITIES_TPU_SERVE_TELEMETRY_DIR", raising=False)
    assert _serve_telemetry("port", monkeypatch, tmp_path) is _serve_telemetry("jax", monkeypatch, tmp_path) is None
    if watchdog_s is not None:
        monkeypatch.setenv("MODALITIES_TPU_SERVE_WATCHDOG_S", watchdog_s)
    got = {}
    for pkg in ("port", "jax"):
        monkeypatch.setenv("MODALITIES_TPU_SERVE_TELEMETRY_DIR", str(tmp_path / pkg))
        got[pkg] = _serve_telemetry(pkg, monkeypatch, tmp_path)
    assert got["port"] == got["jax"] == (float(watchdog_s or 300), watchdog_s != "0", "telemetry_rank_0.jsonl")


def test_slo_sample_switch_is_applied_as_jax(monkeypatch):
    """MODALITIES_TPU_SLO_SAMPLE_S sets an SLO engine's sampling interval
    when its spec has none (5 s unset); a spec's `sample_interval_s` wins."""
    from modalities_tpu.telemetry import metrics as jax_metrics
    from modalities_tpu.telemetry import slo as jax_slo
    from modalities_tpu_torch.telemetry import metrics as port_metrics
    from modalities_tpu_torch.telemetry import slo as port_slo

    def intervals(spec):
        out = []
        for slo, metrics in ((port_slo, port_metrics), (jax_slo, jax_metrics)):
            objectives, options = slo.load_slo_spec(spec)
            out.append(slo.SLOEngine(objectives, metrics.MetricsRegistry(), **options).sample_interval_s)
        return out

    bare, pinned = {"objectives": [{"name": "a", "expr": "m < 1"}]}, {"sample_interval_s": 2.5,
                                                                      "objectives": [{"name": "a", "expr": "m < 1"}]}
    monkeypatch.delenv("MODALITIES_TPU_SLO_SAMPLE_S", raising=False)
    assert intervals(bare) == [5.0, 5.0]
    monkeypatch.setenv("MODALITIES_TPU_SLO_SAMPLE_S", "0.75")
    assert intervals(bare) == [0.75, 0.75] and intervals(pinned) == [2.5, 2.5]

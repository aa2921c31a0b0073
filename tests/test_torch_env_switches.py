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
  _MEMSCOPE_DIR and _MEMSCOPE_FITS_CHECK are refused at `run`, naming
  Queue 1 item 6;
- MODALITIES_TPU_LOG_LEVEL sets the port's logger level, as the JAX one's;
- the fleet's MODALITIES_TPU_FLEET_RETRY_BUDGET_RATIO, _PROBE_BACKOFF_MAX_S,
  _HEALTH_DEADLINE_S, _PROBATION_S, _POLL_S and
  MODALITIES_TPU_DISAGG_HANDOFF_TIMEOUT_S are applied where the JAX package
  applies them: the object built with its knob left None takes the env value,
  as the JAX object does."""

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


@pytest.mark.parametrize("name,value", list(zip(CAPTURE, ["3", "profiles", "2:2", "snapshots", "warn"])),
                         ids=[c.removeprefix("MODALITIES_TPU_") for c in CAPTURE])
def test_capture_switches_are_refused_at_run(monkeypatch, tmp_path, name, value):
    monkeypatch.setenv(name, value)
    with pytest.raises(NotImplementedError, match=rf"{name}.*Queue 1 item 6"):
        main(["run", "--config_file_path", str(tmp_path / "never_read.yaml"), "--device", "cpu"])


def test_log_level_switch_sets_the_ports_logger(monkeypatch, tmp_path):
    """MODALITIES_TPU_LOG_LEVEL=warning (case-folded, as in JAX) silences the
    package's INFO records; a level logging does not know raises."""
    package = logging.getLogger("modalities_tpu_torch")
    before = package.level
    try:
        monkeypatch.setenv("MODALITIES_TPU_LOG_LEVEL", "warning")
        monkeypatch.setenv("MODALITIES_TPU_PROFILE_AT_STEP", "1")  # stops `run` right after the CLI's setup
        with pytest.raises(NotImplementedError):
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

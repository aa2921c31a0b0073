"""The port's training resilience modules (modalities_tpu_torch/resilience/)
against the JAX package's on the same scripted inputs, pure Python:

- `AnomalyTracker`: the same metric sequences through raise / skip_step /
  rollback, non-finite flags, loss spikes, budgets and windows give the same
  outcome (the exception and its message, or none) and the same events;
- the fault grammar: the same spec strings parse to the same faults, and the
  same malformed specs raise the same errors; the 16 names are JAX's; the
  points without a fire site in the port refuse to arm, naming their item;
  every other point has its fire site; `checkpoint_io_error:2` costs two
  retries inside `retry_io`;
- the single-host supervisor: the same child exit codes through JAX's fake
  runner give the same return code, the same child commands (cold or
  warmstart, the pointer each resumes from) and the same backoff naps,
  including checkpoint progress resetting the budget and the degradation
  ladder burning a step;
- the heartbeat: two monitors on JAX's in-process transport with a stepped
  clock give the same fatal verdicts and cluster tables as JAX's; two ranks'
  monitors on the c10d store of a world-1 group in one process;
- the CLI's error record: JAX's fields, and exit code 75 for a resumable
  error; the communication test on a world-1 gloo group; the preemption
  handler's signal flag.
"""

import json
import os
import signal
from pathlib import Path

import numpy as np
import pytest
import torch

import modalities_tpu.__main__ as jax_cli
import modalities_tpu.resilience.anomaly as jax_anomaly
import modalities_tpu.resilience.faults as jax_faults
import modalities_tpu.resilience.heartbeat as jax_heartbeat
import modalities_tpu.resilience.supervisor as jax_supervisor
from modalities_tpu.resilience import PreemptionShutdown as JaxPreemption
from modalities_tpu.resilience.manifest import atomic_write_json as jax_atomic_write, write_manifest as jax_write_manifest
import modalities_tpu_torch.__main__ as cli
from modalities_tpu_torch.resilience import (
    RESUMABLE_EXIT_CODE,
    PreemptionHandler,
    PreemptionShutdown,
    anomaly,
    events,
    faults,
    heartbeat,
    supervisor,
)
from modalities_tpu_torch.resilience.manifest import atomic_write_json, write_manifest

ROOT = Path(__file__).resolve().parents[1]


# ------------------------------------------------------------------ tracker


def _run_tracker(module, monkeypatch, kwargs: dict, intervals: list[list[dict]]) -> list:
    recorded = []
    monkeypatch.setattr(module, "record_event", lambda name, **payload: recorded.append((name, payload)))
    tracker = module.AnomalyTracker(**kwargs)
    outcome, step = [], 0
    for interval in intervals:
        step += len(interval)
        try:
            if tracker.should_observe(interval[0]):
                tracker.observe_interval(interval, step)
            outcome.append(None)
        except Exception as e:  # noqa: BLE001 — the outcome is what is compared
            outcome.append((type(e).__name__, str(e)))
            break
    return [outcome, recorded]


def _intervals(flags: list[int], losses: list[float], key: str = "skipped_step", size: int = 2) -> list[list[dict]]:
    rows = [{"loss": loss, key: flag, "grad_norm": 1.0} for flag, loss in zip(flags, losses)]
    return [rows[i:i + size] for i in range(0, len(rows), size)]


CALM = [2.0 + 0.01 * np.sin(i) for i in range(24)]
TRACKER_CASES = {
    "raise-nonfinite": ({"policy": "raise"}, _intervals([0, 0, 1, 0], CALM[:4], "nonfinite_grads")),
    "skip-within-budget": ({"policy": "skip_step", "skip_budget": 2}, _intervals([0, 1, 0, 0, 1, 0], CALM[:6])),
    "skip-budget-spent": ({"policy": "skip_step", "skip_budget": 1}, _intervals([1, 0, 0, 1, 1, 0], CALM[:6])),
    "rollback-budget-spent": ({"policy": "rollback", "skip_budget": 1}, _intervals([0, 1, 1, 0], CALM[:4])),
    "window-forgets": ({"policy": "rollback", "skip_budget": 1, "window_steps": 3},
                       _intervals([1, 0, 0, 0, 1, 0, 0, 0, 1, 0], CALM[:10])),
    "loss-spike-skip": ({"policy": "skip_step", "loss_spike_zscore": 4.0, "loss_spike_min_history": 8},
                        _intervals([0] * 14, CALM[:10] + [50.0] + CALM[11:14])),
    "loss-spike-raise": ({"policy": "raise", "loss_spike_zscore": 4.0, "loss_spike_min_history": 4},
                         _intervals([0] * 8, CALM[:6] + [40.0, 2.0], "nonfinite_grads")),
    "nonfinite-loss-watched": ({"policy": "rollback", "skip_budget": 0, "loss_spike_zscore": 3.0},
                               [[{"loss": 2.0, "grad_norm": 1.0}, {"loss": float("nan"), "grad_norm": 1.0}]]),
    "unarmed-nothing-to-observe": ({"policy": "raise"}, [[{"loss": float("nan"), "grad_norm": float("nan")}]]),
}


@pytest.mark.parametrize("case", TRACKER_CASES)
def test_the_tracker_decides_as_the_jax_tracker(monkeypatch, case):
    kwargs, intervals = TRACKER_CASES[case]
    ours = _run_tracker(anomaly, monkeypatch, kwargs, intervals)
    theirs = _run_tracker(jax_anomaly, monkeypatch, kwargs, intervals)
    assert ours == theirs
    assert ours[0] and (case != "skip-within-budget" or ours[0][-1] is None)


def test_the_tracker_refuses_an_unknown_policy():
    with pytest.raises(ValueError, match="anomaly policy must be one of"):
        anomaly.AnomalyTracker(policy="ignore")


# ------------------------------------------------------------------- faults


SPECS = ["", "nan_grads@3", "loss_spike@2", "loss_spike@2:50", "checkpoint_io_error:3", "checkpoint_io_error",
         "sigterm_at_step@7, peer_hang@2:0.5 ,peer_death@9", "sigterm_one_rank@4:1", "oom@5,host_loss@3:1",
         "serve_slow_decode:250,queue_storm@2:8,tenant_flood@1", "nan_grads@1,nan_grads@4"]
BAD_SPECS = ["bogus@1", "nan_grads@x", "loss_spike@2:abc", "nan_grads@1,unknown"]


def _parsed(module, spec):
    try:
        return {k: (v.name, v.step, v.arg, v.remaining) for k, v in module.parse_faults(spec).items()}
    except Exception as e:  # noqa: BLE001 — the error is what is compared
        return (type(e).__name__, str(e))


@pytest.mark.parametrize("spec", SPECS + BAD_SPECS)
def test_the_grammar_parses_as_the_jax_grammar(spec):
    assert _parsed(faults, spec) == _parsed(jax_faults, spec)


def test_the_fault_points_are_jaxs_and_each_is_wired_or_refused():
    assert faults.FAULT_POINTS == jax_faults.FAULT_POINTS and len(faults.FAULT_POINTS) == 16
    sources = "".join(p.read_text() for p in (ROOT / "modalities_tpu_torch").rglob("*.py")
                      if p.name != "faults.py")
    fire_sites = {"checkpoint_io_error": "fire_io_error_if_armed", "nan_grads": 'get_fault("nan_grads")',
                  "loss_spike": 'get_fault("loss_spike")', "sigterm_at_step": "fire_sigterm_if_armed",
                  "sigterm_one_rank": "fire_sigterm_one_rank_if_armed", "peer_hang": "peer_hang_if_armed",
                  "peer_death": "peer_death_if_armed", "oom": "fire_oom_if_armed"}
    assert set(fire_sites) | set(faults.UNPORTED) == set(faults.FAULT_POINTS)
    assert not set(fire_sites) & set(faults.UNPORTED)
    for name, site in fire_sites.items():
        assert site in sources, name
    for name, where in faults.UNPORTED.items():
        faults.clear_faults()
        with pytest.raises(NotImplementedError, match=rf"{name}.*ROADMAP\.md, Queue 1 item [67]"):
            faults.arm_faults(f"nan_grads@1,{name}@2")
        assert faults.get_fault("nan_grads") is None  # nothing armed when one point is refused
    faults.clear_faults()


def test_the_oom_point_fires_as_the_jax_point():
    """`oom@2` raises at the dispatch of step 2 only, once, an allocation
    failure both packages' memscope recognizes (the port's a
    torch.OutOfMemoryError carrying the JAX message)."""
    import torch

    from modalities_tpu.telemetry.memscope import is_oom_error as jax_is_oom
    from modalities_tpu_torch.telemetry.memscope import is_oom_error

    raised = {}
    for name, module in (("port", faults), ("jax", jax_faults)):
        module.clear_faults()
        module.arm_faults("oom@2")
        assert module.fire_oom_if_armed(1) is False
        with pytest.raises(RuntimeError) as info:
            module.fire_oom_if_armed(2)
        assert module.fire_oom_if_armed(2) is False  # one shot
        module.clear_faults()
        raised[name] = info.value
    assert isinstance(raised["port"], torch.OutOfMemoryError)
    assert str(raised["port"]).split(" (")[0] == str(raised["jax"]).split(" (")[0] == (
        "RESOURCE_EXHAUSTED: injected fault: oom at step 2")
    assert all(is_oom_error(e) and jax_is_oom(e) for e in raised.values())


def test_env_faults_arm_once_and_shots_are_consumed(monkeypatch):
    monkeypatch.setenv(faults.ENV_VAR, "sigterm_at_step@3,checkpoint_io_error:2")
    faults.clear_faults()
    faults.load_faults_from_env()
    monkeypatch.setenv(faults.ENV_VAR, "nan_grads@1")
    faults.load_faults_from_env()  # once per process
    assert faults.get_fault("nan_grads") is None and faults.get_fault("sigterm_at_step").step == 3
    with pytest.raises(ValueError, match="unknown fault point"):
        faults.get_fault("bogus")
    from modalities_tpu_torch.resilience.retry import retry_io

    before = events.snapshot_counts()
    assert retry_io(lambda: "done", what="probe", base_delay_s=0.0) == "done"  # two injected failures, then done
    assert events.counts_since(before) == {"fault": 2, "ckpt_retry": 2}
    assert faults.get_fault("checkpoint_io_error").remaining == 0
    faults.clear_faults()


# --------------------------------------------------------------- supervisor


class FakeRunner:
    """JAX's (tests/resilience/test_supervisor.py): scripted exit codes; `seal`
    maps an attempt index to the seen-steps folder it seals before exiting."""

    def __init__(self, exit_codes, seal=None, root=None, write=None):
        self.exit_codes = list(exit_codes)
        self.commands = []
        self.seal, self.root, self.write = seal or {}, root, write

    def __call__(self, cmd, env=None):
        self.commands.append(cmd)
        if len(self.commands) - 1 in self.seal:
            _seal(self.root, self.seal[len(self.commands) - 1], *self.write)
        return self.exit_codes.pop(0)


def _seal(root: Path, step: int, write_manifest_fn, atomic_write_fn) -> Path:
    folder = root / f"eid_x-seen_steps_{step}-seen_tokens_{4 * step}-target_steps_99-target_tokens_396"
    folder.mkdir()
    (folder / "blob.bin").write_bytes(b"\x00" * 16)
    write_manifest_fn(folder)
    atomic_write_fn(root / "last_checkpoint_info.json", {"checkpoint_folder_path": str(folder)})
    return folder


SUPERVISOR_CASES = {
    "clean": dict(codes=[0]),
    "resumable-backoff": dict(codes=[75, 75, 0], pre=[4], kwargs={"backoff_base_s": 0.5}),
    "cold-until-pointer": dict(codes=[75, 0], seal={0: 4}),
    "non-resumable": dict(codes=[1]),
    "restart-on-crash": dict(codes=[1, 0], kwargs={"restart_on_crash": True}),
    "crash-loop": dict(codes=[75] * 4, pre=[4]),
    "unverifiable-pointer": dict(codes=[0], pre=[4], corrupt=True),
    "progress-resets-budget": dict(codes=[75] * 5 + [0], pre=[4], seal={0: 8, 1: 12, 2: 16, 3: 20},
                                   kwargs={"max_restarts": 1}),
    "ladder-burns-a-step": dict(codes=[75, 75, 75, 0], pre=[4, 8], kwargs={"ladder_after": 2}),
    "warmstart-config": dict(codes=[75, 0], pre=[4], kwargs={"warmstart_config_file_path": "warm.yaml"}),
}


def _supervise(package, root: Path, case: dict):
    module, write = ((supervisor, (write_manifest, atomic_write_json)) if package == "port"
                     else (jax_supervisor, (jax_write_manifest, jax_atomic_write)))
    root.mkdir()
    for step in case.get("pre", []):
        folder = _seal(root, step, *write)
    if case.get("corrupt"):
        (folder / "blob.bin").unlink()
    runner = FakeRunner(case["codes"], case.get("seal"), root, write)
    naps = []
    kwargs = dict(case.get("kwargs", {}))
    if "warmstart_config_file_path" in kwargs:
        kwargs["warmstart_config_file_path"] = root / kwargs["warmstart_config_file_path"]
    code = module.run_resilient(config_file_path=root / "config.yaml",
                                last_checkpoint_info_file_path=root / "last_checkpoint_info.json",
                                runner=runner, sleep_fn=naps.append, **kwargs)
    pkg = "modalities_tpu_torch" if package == "port" else "modalities_tpu"
    commands = [[a.replace(str(root), "<root>") for a in cmd[3:]] for cmd in runner.commands
                if cmd[1:3] == ["-m", pkg]]
    assert len(commands) == len(runner.commands)
    pointers = [json.loads(Path(cmd[cmd.index("--last_checkpoint_info_file_path") + 1]).read_text())
                ["checkpoint_folder_path"].replace(str(root), "<root>")
                for cmd in runner.commands if "warmstart" in cmd]
    return code, commands, naps, pointers


@pytest.mark.parametrize("case", SUPERVISOR_CASES)
def test_the_supervisor_decides_as_the_jax_supervisor(tmp_path, monkeypatch, case):
    monkeypatch.setattr(jax_supervisor.os, "environ", dict(os.environ))  # it exports its host id and pid
    ours = _supervise("port", tmp_path / "port", SUPERVISOR_CASES[case])
    theirs = _supervise("jax", tmp_path / "jax", SUPERVISOR_CASES[case])
    assert ours == theirs
    if case == "ladder-burns-a-step":  # two failed resumes from step 8 burn it: the ring walks back to step 4
        assert [int(p.split("seen_steps_")[1].split("-")[0]) for p in ours[3]] == [8, 8, 4, 4]
    assert all("--resilient" not in cmd for cmd in ours[1])


def test_a_child_command_is_run_or_warmstart_with_the_ports_extra_args(tmp_path):
    cold = supervisor.build_child_command(tmp_path / "c.yaml", tmp_path / "i.json", extra_args=("--device", "cpu"))
    warm = supervisor.build_child_command(tmp_path / "c.yaml", tmp_path / "i.json", resume=True,
                                          warmstart_config_file_path=tmp_path / "w.yaml")
    assert cold[3:] == ["run", "--config_file_path", str(tmp_path / "c.yaml"), "--device", "cpu"]
    assert warm[3:] == ["warmstart", "--config_file_path", str(tmp_path / "w.yaml"),
                        "--last_checkpoint_info_file_path", str(tmp_path / "i.json")]


# ---------------------------------------------------------------- heartbeat


class FakeClock:
    def __init__(self):
        self.now = 1000.0

    def __call__(self):
        return self.now


def _heartbeat_script(module) -> list:
    """Three monitors on one in-process transport: rank 2 leaves cleanly,
    rank 1 goes silent; then a rendezvous phase overruns on a fresh pair."""
    clock, fatals, out = FakeClock(), [], []
    transport = module.InProcessTransport()

    def monitor(rank, world, transport):
        m = module.HeartbeatMonitor(rank=rank, world=world, transport=transport, interval_s=1.0, peer_deadline_s=10.0,
                                    rendezvous_deadline_s=30.0, clock=clock,
                                    on_fatal=lambda reason, path: fatals.append((rank, reason)))
        m._started_at = clock()
        return m

    ms = [monitor(r, 3, transport) for r in range(3)]
    for t in range(25):
        clock.now += 1.0
        if t == 3:
            ms[2]._state = module.STATE_LEAVING
        for r, m in enumerate(ms):
            if r == 0 or (r == 1 and t < 5) or (r == 2 and t < 4):
                m.tick()
        out.append((len(fatals), {k: v["state"] for k, v in ms[0].cluster_state()["peer_heartbeats"].items()}))
    transport2 = module.InProcessTransport()
    pair = [monitor(r, 2, transport2) for r in range(2)]
    pair[0].set_phase("checkpoint_save")
    pair[0].set_phase("checkpoint_drain")
    for _ in range(40):
        clock.now += 1.0
        for m in pair:
            m.tick()
    out.append(pair[0].cluster_state()["coordination_phase_stack"])
    return [out, fatals]


def test_the_heartbeat_decides_as_the_jax_heartbeat():
    ours, theirs = _heartbeat_script(heartbeat), _heartbeat_script(jax_heartbeat)
    assert ours == theirs
    assert ours[1] == [(0, "peer_dead"), (0, "rendezvous_timeout")]


def test_the_store_transport_carries_beats_between_two_monitors_of_one_process(tmp_path):
    from modalities_tpu_torch.running_env import env

    fatals = []
    with env.process_group(torch.device("cpu")):
        assert heartbeat.resolve_transport("auto", 0, 1) is None  # one process: nothing to watch
        clock = FakeClock()
        ms = [heartbeat.HeartbeatMonitor(rank=r, world=2, transport=heartbeat.resolve_transport("kv", r, 2),
                                         interval_s=1.0, peer_deadline_s=5.0, clock=clock, artifact_dir=tmp_path,
                                         on_fatal=lambda reason, path: fatals.append((reason, path)))
              for r in range(2)]
        for m in ms:
            m._started_at = clock()
        for t in range(12):
            clock.now += 1.0
            ms[0].tick()
            if t < 3:
                ms[1].tick()
        table = ms[0].cluster_state()["peer_heartbeats"]["1"]
    assert table["seq"] == 3 and table["state"] == "alive"
    assert [reason for reason, _ in fatals] == ["peer_dead"]
    artifact = json.loads(fatals[0][1].read_text())
    assert artifact["reason"] == "peer_dead" and artifact["detail"]["dead_ranks"] == [1]
    assert heartbeat.get_active_monitor() is None


# ---------------------------------------------------------------------- CLI


def _record(wrap, error, tmp_path, monkeypatch, name):
    folder = tmp_path / name
    monkeypatch.setenv("MODALITIES_TPU_ERROR_LOG_DIR", str(folder))
    monkeypatch.setenv("RANK", "3")

    @wrap
    def failing():
        raise error

    with pytest.raises(BaseException) as info:
        failing()
    return info.value, json.loads((folder / "error_rank_3.json").read_text())


@pytest.mark.parametrize("resumable", [True, False], ids=["resumable", "crash"])
def test_the_error_record_has_the_jax_fields_and_a_resumable_error_exits_75(tmp_path, monkeypatch, resumable):
    ours, record = _record(cli._exception_handling, PreemptionShutdown("at step 3") if resumable else
                           RuntimeError("boom"), tmp_path, monkeypatch, "port")
    theirs, jax_record = _record(jax_cli._exception_handling, JaxPreemption("at step 3") if resumable else RuntimeError("boom"), tmp_path,
                                 monkeypatch, "jax")
    assert set(record) == set(jax_record) == {"rank", "hostname", "timestamp", "error", "resumable", "stacktrace"}
    assert (record["rank"], record["resumable"], record["hostname"]) == (jax_record["rank"], jax_record["resumable"],
                                                                        jax_record["hostname"])
    assert record["rank"] == 3 and record["resumable"] is resumable
    if resumable:
        assert isinstance(ours, SystemExit) and ours.code == RESUMABLE_EXIT_CODE == theirs.code == 75
        assert record["error"] == "PreemptionShutdown('at step 3')" and "PreemptionShutdown" in record["stacktrace"]
    else:
        assert isinstance(ours, RuntimeError) and record["error"] == jax_record["error"] == "RuntimeError('boom')"


def test_the_cluster_flags_are_refused_naming_their_item(tmp_path):
    with pytest.raises(NotImplementedError, match=r"--host_count, --min_hosts: .* Queue 1 item 7"):
        cli.main(["run", "--config_file_path", str(tmp_path / "x.yaml"), "--host_count", "2", "--min_hosts", "1",
                  "--device", "cpu"])


def test_the_communication_test_gathers_every_ranks_stamp(capsys):
    from modalities_tpu_torch.running_env import env
    from modalities_tpu_torch.utils.communication_test import run_communication_test

    with env.process_group(torch.device("cpu")):
        run_communication_test("cpu")
    assert "Communication test passed over 1 rank(s) on cpu (gloo)." in capsys.readouterr().out


def test_the_preemption_handler_turns_a_signal_into_a_flag():
    previous = signal.getsignal(signal.SIGTERM)
    handler = PreemptionHandler().install()
    try:
        assert not handler.should_stop()
        os.kill(os.getpid(), signal.SIGTERM)
        for _ in range(100):  # the handler runs at a bytecode boundary
            if handler.should_stop():
                break
        assert handler.should_stop() and handler.received_signal == "SIGTERM"
        handler.reset()
        assert not handler.should_stop() and handler.received_signal is None
    finally:
        handler.uninstall()
    assert signal.getsignal(signal.SIGTERM) is previous

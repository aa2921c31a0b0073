"""The training loop: the port of modalities_tpu/trainer.py:Trainer (the
train steps, the interval publish, its resilience hooks and its telemetry).

Each step takes `gradient_accumulation_steps` microbatches from the loader,
moves them to the device as [acc, mb, S] tensors and runs the train step. The
step's metrics stay on the device until a logging interval ends; then they
are fetched once, and one line with loss, grad_norm, lr, tokens/s and MFU is
printed and published to the results subscriber. The loss is the global one
(every rank's step sums it over the ranks); tokens are the global tokens of a
step, and tokens/s per card divides them by the world. Only rank 0 prints and
publishes. On the card the run ends with the peak device memory and the
process's kernel launches (ops.launch_counts).

Resilience (JAX trainer.py:251-259, :339-346, :402-426, :504-512, :564-567):
- the anomaly tracker (resilience/anomaly.py) reads each interval's flags
  at the interval boundary, before the checkpoint callback;
- a preemption (SIGTERM / SIGINT, or the `sigterm_at_step` fault) lets the
  in-flight step finish, forces an out-of-schedule checkpoint at that step
  and raises `PreemptionShutdown`;
- with the stop consensus on, each step carries this rank's vote
  (resilience/coordination.py) and the loop acts on the previous step's
  reduced ballot, so every rank stops (with the forced save) or rolls back
  at the same boundary;
- each event goes through resilience/events.py under the JAX names.

Telemetry (JAX trainer.py:170-457, :555-648), observational only: no step's
result changes and no host sync is added (the interval boundary's fetch stays
the only one):
- the step loop is the goodput timeline: `data_wait` around the loader,
  `first_step` / `train_step` around the dispatch, `metrics_fetch` and
  `publish` at the boundary, `eval/<tag>`, `checkpoint_save`,
  `checkpoint_drain` and `preempt/forced_checkpoint` from the callbacks;
- the watchdog is armed before the first step (its deadline stretched),
  beaten after each step and disarmed on the way out;
- `observe_step_time` gets the dispatch's `perf_counter` time from the
  second step on;
- MODALITIES_TPU_PROFILE_AT_STEP arms a `torch.profiler` window
  (telemetry/perfscope.py), MODALITIES_TPU_MEMSCOPE_AT_STEP allocator
  snapshots; a memory timeline sample is taken after every step; the
  config's `profiler` is entered before the loop, stepped after each step's
  callbacks and exited however the loop ends (JAX trainer.py:228-230,
  :382-383, :463-464);
- before the first dispatch memscope's static report is held against the
  card's memory (`FitsCheckFailure` names the levers); an allocation failure
  at the dispatch leaves an OOM dump and raises the resumable `OutOfMemory`;
- the interval carries JAX's throughput keys: wall and device tokens/s and
  MFU (device: the window minus the host stall, the seconds spent waiting on
  the loader, and the boundary stall, the seconds in the evaluation and
  checkpoint callbacks), peak memory and HBM headroom, goodput % and the
  seconds of each bucket; the MFU waterfall is published with it, and the
  telemetry's SLO engine is sampled (a breach counts against the anomaly
  tracker's budget).
"""

from __future__ import annotations

import json
import logging
import math
import os
import time
from pathlib import Path
from typing import Callable, Iterator, Optional

import numpy as np
import torch

from modalities_tpu_torch.dataloader.dataloader import device_tensor
from modalities_tpu_torch.resilience.coordination import (
    BALLOT_KEY,
    VOTE_CONTINUE,
    VOTE_ROLLBACK,
    VOTE_STOP,
    make_ballot,
)
from modalities_tpu_torch.resilience.errors import AnomalyRollback, PreemptionShutdown
from modalities_tpu_torch.resilience.events import record_event
from modalities_tpu_torch.resilience.faults import (
    fire_oom_if_armed,
    fire_sigterm_if_armed,
    fire_sigterm_one_rank_if_armed,
    peer_death_if_armed,
    peer_hang_if_armed,
)
from modalities_tpu_torch.telemetry import Telemetry, get_active_telemetry
from modalities_tpu_torch.telemetry.device_memory import hbm_headroom_mb, min_bytes_limit, peak_memory_mb
from modalities_tpu_torch.telemetry.memscope import (
    FITS_CHECK_ENV,
    MemoryTimeline,
    MemscopeWindow,
    is_oom_error,
    oom_forensics,
    preflight_fits_check,
)
from modalities_tpu_torch.telemetry.perfscope import ProfileWindow
from modalities_tpu_torch.training.training_progress import TrainingProgress

logger = logging.getLogger(__name__)


def stack_microbatches(batches: list, device: torch.device) -> dict:
    """[acc] DatasetBatches of [mb, ...] numpy arrays -> {"samples": {k: [acc, mb, ...]},
    "targets": {...}} tensors on `device` (token ids int64, floats float32:
    `device_tensor`)."""

    def stack(attr):
        keys = getattr(batches[0], attr).keys()
        return {k: device_tensor(np.stack([np.asarray(getattr(b, attr)[k]) for b in batches]), device) for k in keys}

    return {"samples": stack("samples"), "targets": stack("targets")}


class Trainer:
    def __init__(self, progress_subscriber, evaluation_subscriber, device: torch.device, gradient_acc_steps: int = 1,
                 global_num_tokens_per_train_step: int = 0, num_seen_train_steps: int = 0,
                 training_log_interval_in_steps: int = 1, mfu_calculator=None, error_if_nonfinite: bool = False,
                 global_rank: int = 0, world_size: int = 1, anomaly_tracker=None, preemption=None,
                 stop_consensus: bool = False, telemetry: Optional[Telemetry] = None, profiler=None):
        self.progress_subscriber = progress_subscriber
        self.evaluation_subscriber = evaluation_subscriber
        self.device = device
        self.gradient_acc_steps = gradient_acc_steps
        self.tokens_per_step = global_num_tokens_per_train_step
        self.num_seen_train_steps = num_seen_train_steps
        self.log_interval = training_log_interval_in_steps
        self.mfu_calculator = mfu_calculator
        self.error_if_nonfinite = error_if_nonfinite
        self.global_rank = global_rank
        self.world_size = world_size
        self.anomaly_tracker = anomaly_tracker
        self.preemption = preemption
        self.stop_consensus = stop_consensus
        # None: the process-global telemetry at train() time (the no-op unless Main activated one)
        self.telemetry = telemetry
        self.profiler = profiler  # a steppable profiler (utils/profilers/profilers.py) or None
        self.memscope_report: Optional[dict] = None  # the static report the fits check held (None on the CPU)
        self.profile_window: Optional[ProfileWindow] = None  # the capture window of the last train()
        self._host_stall_s = 0.0
        self._boundary_stall_s = 0.0

    def _telemetry(self) -> Telemetry:
        return self.telemetry if self.telemetry is not None else get_active_telemetry()

    def _preflight_memscope(self, train_step, batch: dict) -> Optional[dict]:
        """The static report and the fits check before the first dispatch,
        where they can act: a device with a budget (the card) and a check mode
        other than off. A FitsCheckFailure propagates."""
        limit = min_bytes_limit([self.device])
        if (os.environ.get(FITS_CHECK_ENV) or "fail").strip().lower() == "off" or limit is None:
            return None
        report = train_step.memscope_report(batch)
        preflight_fits_check(report, bytes_limit=limit)
        return report

    def _feed(self, loader) -> Iterator[dict]:
        group: list = []
        for batch in loader:
            group.append(batch)
            if len(group) == self.gradient_acc_steps:
                yield stack_microbatches(group, self.device)
                group = []
        if group:
            logger.warning("dropping %d trailing microbatches (< gradient_accumulation_steps=%d)",
                           len(group), self.gradient_acc_steps)

    def train(self, train_step, train_loader, training_progress: TrainingProgress,
              evaluation_callback: Callable[[int], None],
              checkpointing_callback: Callable[..., None]) -> list[dict]:
        """Runs until the target step count or the end of the loader; returns
        the published interval results. `checkpointing_callback(progress,
        force=False)` saves when due, or regardless with `force`."""
        telemetry = self._telemetry()
        telemetry.set_timeline_thread()  # this thread's spans are the run's wall-clock timeline
        step_id = self.num_seen_train_steps
        target_steps = training_progress.num_target_steps
        evaluation_callback(step_id)
        pending: list[dict] = []
        results: list[dict] = []
        interval_start = time.perf_counter()
        self._host_stall_s = self._boundary_stall_s = 0.0
        consensus = self.stop_consensus
        local_vote = VOTE_CONTINUE
        prev_ballot: Optional[torch.Tensor] = None
        pending_rollback: Optional[AnomalyRollback] = None
        artifact_dir = telemetry.sink_path.parent if telemetry.sink_path is not None else None
        first_step_id = step_id
        telemetry.arm_watchdog(step_id + 1, first_step=True)  # the first step builds kernels: its deadline stretched
        self.profile_window = profile_window = ProfileWindow.from_env(fallback_dir=artifact_dir,
                                                                      global_rank=self.global_rank)
        mem_timeline = MemoryTimeline(telemetry=telemetry, executable="train_step")
        memscope_window = MemscopeWindow.from_env(fallback_dir=artifact_dir)
        fits_checked = False
        feed = self._feed(train_loader)
        if self.profiler is not None:
            self.profiler.__enter__()
        try:
            while True:
                with telemetry.span("data_wait"):
                    wait_t0 = time.perf_counter()
                    batch = next(feed, None)
                    self._host_stall_s += time.perf_counter() - wait_t0
                if batch is None:
                    break
                if consensus:
                    # this rank's vote rides the step now, not a prefetched batch
                    if (self.preemption is not None and self.preemption.should_stop()
                            and local_vote < VOTE_STOP):
                        local_vote = VOTE_STOP
                        record_event("consensus/stop_vote_cast", step=step_id,
                                     signal=self.preemption.received_signal or "request_stop")
                    batch[BALLOT_KEY] = make_ballot(local_vote, self.device)
                if profile_window is not None:
                    profile_window.maybe_start(step_id + 1)
                if not fits_checked:
                    fits_checked = True
                    self.memscope_report = self._preflight_memscope(train_step, batch)
                    if self.memscope_report is not None:
                        telemetry.publish_memscope_report(self.memscope_report, executable="train_step")
                step_t0 = time.perf_counter()
                try:
                    fire_oom_if_armed(step_id + 1)
                    with telemetry.step_annotation(step_id + 1):
                        with telemetry.span("first_step" if step_id == first_step_id else "train_step"):
                            metrics = train_step(batch)
                except Exception as e:
                    if is_oom_error(e):
                        # the dump first (static report, timeline tail, blocks, levers), then exit resumable
                        raise oom_forensics(
                            artifact_dir if artifact_dir is not None else Path("."), rank=telemetry.global_rank,
                            step=step_id + 1, exc=e, static_report=self.memscope_report, timeline=mem_timeline,
                            window=memscope_window, metrics_snapshot=telemetry.metrics.snapshot()) from e
                    raise
                if step_id != first_step_id:  # the dispatch's host time; the first step's build left out
                    telemetry.observe_step_time(time.perf_counter() - step_t0, step_id=step_id + 1)
                decided = VOTE_CONTINUE
                if consensus:
                    # the previous step's reduced ballot: complete by now, the same on every rank
                    if prev_ballot is not None:
                        decided = int(prev_ballot.max())
                    prev_ballot = metrics.pop(BALLOT_KEY)
                pending.append(metrics)
                step_id += 1
                training_progress.num_seen_steps_current_run += 1
                training_progress.num_seen_tokens_current_run += self.tokens_per_step
                self.progress_subscriber.consume(step_id)
                if step_id % self.log_interval == 0:
                    # the anomaly policy reads the interval before the boundary's checkpoint can save it
                    try:
                        self._observe_anomalies(pending, step_id)
                    except AnomalyRollback as rollback:
                        if not consensus:
                            raise
                        # under consensus a rollback is a vote: hold it until every rank agrees
                        pending_rollback = rollback
                        if local_vote < VOTE_ROLLBACK:
                            local_vote = VOTE_ROLLBACK
                            record_event("consensus/rollback_vote_cast", step=step_id)
                    result, interval_start = self._publish(pending, step_id, train_loader.dataloader_tag,
                                                           interval_start, training_progress)
                    results.append(result)
                    pending = []
                boundary_t0 = time.perf_counter()
                evaluation_callback(step_id)
                checkpointing_callback(training_progress)
                self._boundary_stall_s += time.perf_counter() - boundary_t0
                if self.profiler is not None:
                    self.profiler.step()
                if profile_window is not None:
                    profile_window.maybe_stop(step_id)
                mem_timeline.sample(step_id)
                if memscope_window is not None:
                    memscope_window.maybe_snapshot(step_id)
                telemetry.beat_watchdog(step_id)  # the step completed, callbacks included
                # the distributed chaos fire sites: a wedged peer, an abrupt peer death, a SIGTERM
                peer_hang_if_armed(step_id)
                peer_death_if_armed(step_id)
                if self.preemption is not None:
                    fired = fire_sigterm_if_armed(step_id)
                    fired = fire_sigterm_one_rank_if_armed(step_id) or fired
                    if fired:  # the handler runs at a later bytecode boundary: stop at this step regardless
                        self.preemption.request_stop()
                    if not consensus and self.preemption.should_stop() and step_id < target_steps:
                        self._preempted(step_id, self.preemption.received_signal or "request_stop",
                                        training_progress, checkpointing_callback, telemetry)
                if consensus and decided != VOTE_CONTINUE and step_id < target_steps:
                    self._coordinated_stop(decided, step_id, pending_rollback, training_progress,
                                           checkpointing_callback, telemetry)
                if step_id >= target_steps:
                    break
        finally:
            telemetry.disarm_watchdog()  # the drain after the loop is not a hang
            if profile_window is not None and profile_window.active:
                # the loop left mid-window (a crash, a preemption, the loader's end): close the trace readable
                profile_window.maybe_stop(profile_window.start_step + profile_window.num_steps)
            if self.profiler is not None:
                self.profiler.__exit__(None, None, None)
        if pending:  # a trailing partial interval is published, not observed (as in JAX)
            results.append(self._publish(pending, step_id, train_loader.dataloader_tag, interval_start,
                                         training_progress)[0])
        if self.device.type == "cuda" and self.global_rank == 0:
            from modalities_tpu_torch.ops import launch_counts

            print(f"[train] peak device memory {torch.cuda.max_memory_allocated(self.device) / 1e9:.2f} GB "
                  f"(torch.cuda.max_memory_allocated, {torch.cuda.get_device_name(self.device)})", flush=True)
            print(f"[train] kernel launches in this process: {json.dumps(launch_counts())}", flush=True)
        return results

    def _observe_anomalies(self, pending: list[dict], step_id: int) -> None:
        """The tracker's policy over an interval (one host sync, at the
        boundary). The clipper's non-finite guard rides it as the JAX step's
        `nonfinite_grads` flag."""
        if self.anomaly_tracker is None:
            return
        keys = set(pending[0])
        if self.error_if_nonfinite:
            keys.add("nonfinite_grads")
        if not self.anomaly_tracker.should_observe(keys):
            return
        host = []
        for m in pending:
            row = {k: float(v) for k, v in m.items()}
            if self.error_if_nonfinite:
                row["nonfinite_grads"] = int(not math.isfinite(row["grad_norm"]))
            host.append(row)
        self.anomaly_tracker.observe_interval(host, step_id)

    def _preempted(self, step_id: int, signal_name: str, training_progress: TrainingProgress,
                   checkpointing_callback, telemetry: Telemetry) -> None:
        """The in-flight step completed: save out of schedule at this step,
        then exit resumable."""
        record_event("preempt/shutdown_requested", step=step_id, signal=signal_name)
        logger.warning("preemption signal (%s) received — saving out-of-schedule checkpoint at step %d and "
                       "exiting resumable", signal_name, step_id)
        with telemetry.span("preempt/forced_checkpoint"):
            checkpointing_callback(training_progress, force=True)
        record_event("preempt/checkpoint_saved", step=step_id)
        raise PreemptionShutdown(f"preempted by {signal_name} at step {step_id}; checkpoint saved — warmstart to "
                                 "resume")

    def _coordinated_stop(self, decided: int, step_id: int, pending_rollback: Optional[AnomalyRollback],
                          training_progress: TrainingProgress, checkpointing_callback, telemetry: Telemetry) -> None:
        """The ballot came back nonzero: every rank sees it at the same
        boundary, so the forced save below is a well-formed collective."""
        if decided >= VOTE_ROLLBACK:
            record_event("consensus/rollback_agreed", step=step_id)
            logger.warning("stop ballot agreed on anomaly rollback at step %d — exiting resumable (no forced "
                           "checkpoint: the newest verified one wins)", step_id)
            raise pending_rollback or AnomalyRollback(f"peer-escalated anomaly rollback at step {step_id} "
                                                      "(stop ballot)")
        signal_name = None
        if self.preemption is not None and self.preemption.should_stop():
            signal_name = self.preemption.received_signal or "request_stop"
        signal_name = signal_name or "peer_vote"
        record_event("consensus/shutdown_agreed", step=step_id, signal=signal_name)
        record_event("preempt/shutdown_requested", step=step_id, signal=signal_name)
        logger.warning("stop ballot agreed (%s) — saving out-of-schedule checkpoint at step %d on all ranks and "
                       "exiting resumable", signal_name, step_id)
        with telemetry.span("preempt/forced_checkpoint"):
            checkpointing_callback(training_progress, force=True)
        record_event("preempt/checkpoint_saved", step=step_id)
        raise PreemptionShutdown(f"coordinated stop agreed ({signal_name}) at step {step_id}; checkpoint saved — "
                                 "warmstart to resume")

    def _publish(self, pending: list[dict], step_id: int, tag: str, interval_start: float,
                 progress: TrainingProgress) -> tuple[dict, float]:
        """The one host sync of an interval: fetch its metrics, print a line,
        publish the result. Returns the result and the instant the fetch
        returned, the next interval's start (the windows tile the wall time);
        the stall accumulators are drained here, so each stalled second lands
        in one window."""
        telemetry = self._telemetry()
        with telemetry.span("metrics_fetch"):  # waits for the interval's device work: the train_step bucket
            values = {k: torch.stack([m[k].detach().float().cpu() for m in pending]).numpy().astype(np.float64)
                      for k in ("loss", "grad_norm", "lr")}
        fetch_done = time.perf_counter()
        wall = max(fetch_done - interval_start, 1e-9)
        if self.error_if_nonfinite and self.anomaly_tracker is None and not np.isfinite(values["grad_norm"]).all():
            raise RuntimeError(f"non-finite gradient norm in the interval ending at step {step_id}")
        host_stall_s, self._host_stall_s = self._host_stall_s, 0.0
        boundary_stall_s, self._boundary_stall_s = self._boundary_stall_s, 0.0
        device = max(wall - host_stall_s - boundary_stall_s, 1e-9)
        tokens = len(pending) * self.tokens_per_step
        tokens_per_s = tokens / wall
        throughput = {"train steps/s": len(pending) / wall, "tokens/s": tokens_per_s,
                      "tokens/s (wall)": tokens_per_s, "tokens/s (device)": tokens / device,
                      "tokens/s per card": tokens_per_s / self.world_size,
                      "host stall [s]": host_stall_s, "boundary stall [s]": boundary_stall_s}
        if self.mfu_calculator is not None:
            throughput["MFU"] = throughput["MFU (wall)"] = self.mfu_calculator.compute(tokens_per_s)
            throughput["MFU (device)"] = self.mfu_calculator.compute(tokens / device)
        peak_mb = peak_memory_mb([self.device])
        if peak_mb is not None:
            throughput["peak memory [MB]"] = peak_mb
        headroom_mb = hbm_headroom_mb([self.device])
        if headroom_mb is not None:
            throughput["HBM headroom [MB]"] = headroom_mb
        telemetry.publish_resource_gauges(hbm_headroom_mb=headroom_mb, peak_memory_mb=peak_mb)
        goodput = telemetry.throughput_metrics()
        if goodput:  # cumulative since the run began: goodput % and each bucket's wall seconds
            throughput.update(goodput)
            wall_s = telemetry.ledger.wall_s()
            if self.mfu_calculator is not None and wall_s > 0:
                # the run's wall-clock MFU, decomposed into named deductions against the same ledger
                telemetry.publish_mfu_waterfall(self.mfu_calculator.compute(progress.num_seen_tokens_total / wall_s))
        if telemetry.slo_engine is not None:
            telemetry.slo_engine.sample_once()
            if self.anomaly_tracker is not None:
                self.anomaly_tracker.observe_slo(telemetry.slo_engine.breaching(), step_id)
        result = {
            "dataloader_tag": tag,
            "num_train_steps_done": step_id,
            "losses": {"train loss avg": float(values["loss"].mean()), "train loss last": float(values["loss"][-1])},
            "metrics": {
                "grad norm avg": float(values["grad_norm"].mean()),
                "grad norm last": float(values["grad_norm"][-1]),
                "lr mean": float(values["lr"].mean()),
                "consumed tokens": progress.num_seen_tokens_total,
            },
            "throughput_metrics": throughput,
            "device": str(self.device),
        }
        if self.global_rank == 0:
            mfu = throughput.get("MFU", math.nan)
            print(f"[{tag}] step {step_id}: loss {values['loss'][-1]:.5f} grad_norm {values['grad_norm'][-1]:.5f} "
                  f"lr {values['lr'][-1]:.4e} tokens/s {tokens_per_s:.1f} "
                  f"({throughput['tokens/s per card']:.1f} per card of {self.world_size}) MFU {mfu:.4f} "
                  f"({self.device})", flush=True)
            with telemetry.span("publish"):
                self.evaluation_subscriber.consume(result)
        return result, fetch_done

"""The training loop: the port of modalities_tpu/trainer.py:Trainer (the
train-steps / interval-publishing core and its resilience hooks; the JAX
loop's telemetry and watchdog are ROADMAP.md Queue 1 item 6).

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
"""

from __future__ import annotations

import json
import logging
import math
import time
from typing import Callable, Iterator, Optional

import numpy as np
import torch

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
    fire_sigterm_if_armed,
    fire_sigterm_one_rank_if_armed,
    peer_death_if_armed,
    peer_hang_if_armed,
)
from modalities_tpu_torch.training.training_progress import TrainingProgress

logger = logging.getLogger(__name__)


def stack_microbatches(batches: list, device: torch.device) -> dict:
    """[acc] DatasetBatches of [mb, S] numpy arrays -> {"samples": {k: [acc, mb, S]},
    "targets": {...}} int64 tensors on `device`."""

    def stack(attr):
        keys = getattr(batches[0], attr).keys()
        return {
            k: torch.from_numpy(np.stack([np.asarray(getattr(b, attr)[k]) for b in batches]).astype(np.int64))
            .to(device, non_blocking=True)
            for k in keys
        }

    return {"samples": stack("samples"), "targets": stack("targets")}


class Trainer:
    def __init__(self, progress_subscriber, evaluation_subscriber, device: torch.device, gradient_acc_steps: int = 1,
                 global_num_tokens_per_train_step: int = 0, num_seen_train_steps: int = 0,
                 training_log_interval_in_steps: int = 1, mfu_calculator=None, error_if_nonfinite: bool = False,
                 global_rank: int = 0, world_size: int = 1, anomaly_tracker=None, preemption=None,
                 stop_consensus: bool = False):
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
        step_id = self.num_seen_train_steps
        target_steps = training_progress.num_target_steps
        evaluation_callback(step_id)
        pending: list[dict] = []
        results: list[dict] = []
        interval_start = time.perf_counter()
        consensus = self.stop_consensus
        local_vote = VOTE_CONTINUE
        prev_ballot: Optional[torch.Tensor] = None
        pending_rollback: Optional[AnomalyRollback] = None
        for batch in self._feed(train_loader):
            if consensus:
                # this rank's vote rides the step now, not a prefetched batch
                if self.preemption is not None and self.preemption.should_stop() and local_vote < VOTE_STOP:
                    local_vote = VOTE_STOP
                    record_event("consensus/stop_vote_cast", step=step_id,
                                 signal=self.preemption.received_signal or "request_stop")
                batch[BALLOT_KEY] = make_ballot(local_vote, self.device)
            metrics = train_step(batch)
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
                results.append(self._publish(pending, step_id, train_loader.dataloader_tag, interval_start,
                                             training_progress))
                pending = []
                interval_start = time.perf_counter()
            evaluation_callback(step_id)
            checkpointing_callback(training_progress)
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
                                    training_progress, checkpointing_callback)
            if consensus and decided != VOTE_CONTINUE and step_id < target_steps:
                self._coordinated_stop(decided, step_id, pending_rollback, training_progress,
                                       checkpointing_callback)
            if step_id >= target_steps:
                break
        if pending:  # a trailing partial interval is published, not observed (as in JAX)
            results.append(self._publish(pending, step_id, train_loader.dataloader_tag, interval_start,
                                         training_progress))
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
                   checkpointing_callback) -> None:
        """The in-flight step completed: save out of schedule at this step,
        then exit resumable."""
        record_event("preempt/shutdown_requested", step=step_id, signal=signal_name)
        logger.warning("preemption signal (%s) received — saving out-of-schedule checkpoint at step %d and "
                       "exiting resumable", signal_name, step_id)
        checkpointing_callback(training_progress, force=True)
        record_event("preempt/checkpoint_saved", step=step_id)
        raise PreemptionShutdown(f"preempted by {signal_name} at step {step_id}; checkpoint saved — warmstart to "
                                 "resume")

    def _coordinated_stop(self, decided: int, step_id: int, pending_rollback: Optional[AnomalyRollback],
                          training_progress: TrainingProgress, checkpointing_callback) -> None:
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
        checkpointing_callback(training_progress, force=True)
        record_event("preempt/checkpoint_saved", step=step_id)
        raise PreemptionShutdown(f"coordinated stop agreed ({signal_name}) at step {step_id}; checkpoint saved — "
                                 "warmstart to resume")

    def _publish(self, pending: list[dict], step_id: int, tag: str, interval_start: float,
                 progress: TrainingProgress) -> dict:
        """The one host sync of an interval: fetch its metrics, print a line,
        publish the result."""
        values = {k: torch.stack([m[k].detach().float().cpu() for m in pending]).numpy().astype(np.float64)
                  for k in ("loss", "grad_norm", "lr")}
        wall = max(time.perf_counter() - interval_start, 1e-9)
        if self.error_if_nonfinite and self.anomaly_tracker is None and not np.isfinite(values["grad_norm"]).all():
            raise RuntimeError(f"non-finite gradient norm in the interval ending at step {step_id}")
        tokens_per_s = len(pending) * self.tokens_per_step / wall
        throughput = {"train steps/s": len(pending) / wall, "tokens/s": tokens_per_s,
                      "tokens/s per card": tokens_per_s / self.world_size}
        if self.mfu_calculator is not None:
            throughput["MFU"] = self.mfu_calculator.compute(tokens_per_s)
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
            self.evaluation_subscriber.consume(result)
        return result

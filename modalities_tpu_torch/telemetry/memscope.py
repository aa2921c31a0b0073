"""memscope: device-memory attribution, the preflight fits check and OOM
forensics. The port of modalities_tpu/telemetry/memscope.py:56-570.

1. **Static report.** A train step's bytes in JAX's four categories
   (argument / output / temp / alias), carved into semantic buckets (params,
   optimizer moments, gradients/accumulators, activations+workspace, KV pool,
   other). Every category byte lands in exactly one bucket, so
   ``sum(buckets) == predicted_peak_bytes`` by construction. torch has no
   compiled executable to read `memory_analysis()` off: the port's
   `TrainStep.memscope_report` fills the categories from what is known before
   the first dispatch (`memscope_from_categories`): argument bytes are this
   rank's parameter and optimizer-state bytes read off the live tensors
   (`train_step_known_bytes`), temp bytes the gradients (the fp32
   accumulators and the parameter-dtype gradients) plus the activation
   estimate of utils/recipe_validation.py, output and alias bytes 0.
2. **Preflight fits check.** Before the first dispatch the predicted peak is
   held against the card's memory (`torch.cuda.mem_get_info`'s total). An
   over-budget run fails fast with the levers named in order of modeled
   savings, instead of dying inside the allocator.
   ``MODALITIES_TPU_MEMSCOPE_FITS_CHECK=warn|off`` downgrades the verdict; the
   CPU reports no budget, so there the check is inert.
3. **Runtime timeline and OOM forensics.** `MemoryTimeline` samples
   `torch.cuda.memory_stats` each step into gauges and sink events (host
   calls: no device sync); ``MODALITIES_TPU_MEMSCOPE_AT_STEP=N[:K]`` writes
   the top blocks of `torch.cuda.memory_snapshot()` by size
   (`MemscopeWindow`); an allocation failure at the trainer's dispatch writes
   ``oom_dump_rank_*_step_*.json`` (static report, timeline tail, top blocks,
   metrics, levers) and is re-raised as the resumable `OutOfMemory`. The
   ``oom@step`` fault point drives the whole path on the CPU.
"""

from __future__ import annotations

import json
import logging
import os
import time
from collections import deque
from pathlib import Path
from typing import Optional

from modalities_tpu_torch.telemetry.device_memory import device_memory_stats, min_bytes_limit
from modalities_tpu_torch.telemetry.perfscope import parse_window, write_report

logger = logging.getLogger(__name__)

FITS_CHECK_ENV = "MODALITIES_TPU_MEMSCOPE_FITS_CHECK"
SNAPSHOT_ENV = "MODALITIES_TPU_MEMSCOPE_AT_STEP"
SNAPSHOT_DIR_ENV = "MODALITIES_TPU_MEMSCOPE_DIR"

# The bucket taxonomy. Order matters: carving precedence for argument bytes is
# params -> optimizer_moments -> kv_pool (an argument byte claimed by an earlier
# bucket is gone), temp bytes split gradients_accumulators -> activations.
BUCKETS = (
    "params",
    "optimizer_moments",
    "gradients_accumulators",
    "activations_workspace",
    "kv_pool",
    "other",
)

# What the OOM dump suggests when no static report is on hand. With a static
# report the levers are ranked by modeled savings instead.
DEFAULT_LEVERS = (
    "zero_stage",
    "remat",
    "gradient_accumulation_steps",
    "paged_num_blocks",
    "quant_kv",
)

# Substrings that mark a device allocation failure (the JAX package's, which
# also match torch's "CUDA out of memory").
OOM_MARKERS = ("RESOURCE_EXHAUSTED", "Out of memory", "out of memory")


class FitsCheckFailure(RuntimeError):
    """Predicted per-device peak exceeds the device allocation budget.

    Deliberately NOT a ResumableError: warmstarting the same over-budget config
    would fail the same way. This is a config problem — the message names the
    levers; the operator picks one."""


def is_oom_error(exc: BaseException) -> bool:
    """True for `torch.OutOfMemoryError`, or an exception that stringifies to
    a device allocation failure."""
    import torch

    if isinstance(exc, torch.OutOfMemoryError):
        return True
    text = str(exc)
    return any(marker in text for marker in OOM_MARKERS)


# ---------------------------------------------------------- static attribution


def classify_memory(categories: dict, known_bytes: Optional[dict] = None) -> dict:
    """Carve the four memory_analysis categories into the semantic buckets.

    Closure by construction: params/optimizer_moments/kv_pool are carved out of
    argument bytes in that order (each takes ``min(known, remaining)``),
    gradients/accumulators out of temp bytes, the rest of temp is
    activations+workspace, and whatever argument bytes remain plus all output
    and alias bytes land in ``other``. Every category byte is assigned exactly
    once, so ``sum(buckets) == sum(categories)`` is an identity."""
    known = known_bytes or {}
    buckets = {name: 0 for name in BUCKETS}

    arg_left = int(categories.get("argument_bytes", 0))
    for bucket in ("params", "optimizer_moments", "kv_pool"):
        take = min(int(known.get(bucket, 0)), arg_left)
        if take > 0:
            buckets[bucket] = take
            arg_left -= take

    temp_left = int(categories.get("temp_bytes", 0))
    grads = min(int(known.get("gradients_accumulators", 0)), temp_left)
    if grads > 0:
        buckets["gradients_accumulators"] = grads
        temp_left -= grads
    buckets["activations_workspace"] = temp_left

    buckets["other"] = (
        arg_left
        + int(categories.get("output_bytes", 0))
        + int(categories.get("alias_bytes", 0))
    )
    return buckets


def memscope_from_categories(categories: dict, known_bytes: Optional[dict] = None,
                             context: Optional[dict] = None) -> dict:
    """One step's memory report (JAX `memscope_from_compiled` over given
    categories): raw categories, closed buckets, the predicted per-device peak
    (the category total) and the savings-ranked lever list."""
    categories = {key: int(categories.get(key, 0))
                  for key in ("argument_bytes", "output_bytes", "temp_bytes", "alias_bytes")}
    total = sum(categories.values())
    report = {
        "memory_analysis": {**categories, "total_bytes": total},
        "buckets": classify_memory(categories, known_bytes),
        "predicted_peak_bytes": total,
        "known_bytes": dict(known_bytes or {}),
        "context": dict(context or {}),
    }
    report["levers"] = rank_levers(report)
    return report


def _nbytes(t) -> int:
    from torch.distributed.tensor import DTensor

    local = t.to_local() if isinstance(t, DTensor) else t
    return local.numel() * local.element_size()


def train_step_known_bytes(train_step) -> dict:
    """This rank's bytes of the train step's parameters, optimizer state and
    gradients, read off the live tensors (their local shards under FSDP2 /
    ZeRO-1). A parameter the optimizer holds no state for yet (before the
    first update: torch makes the moments lazily) counts the state the update
    will make: AdamW's two moments of its shape and dtype and its one-element
    float32 step. The gradients are the step's float32 accumulators (JAX: the
    float32 gradients) and the parameter-dtype gradient of each parameter,
    which autograd writes before it is accumulated and the update reads."""
    params = sum(_nbytes(p) for p in train_step.params)
    count = sum(_nbytes(p) // p.element_size() for p in train_step.params)
    optimizer = 0
    for group in train_step.optimizer.param_groups:
        for p in group["params"]:
            state = train_step.optimizer.state.get(p)
            if state:
                optimizer += sum(_nbytes(v) for v in state.values() if hasattr(v, "element_size"))
            else:
                optimizer += 2 * _nbytes(p) + 4
    return {
        "params": int(params),
        "optimizer_moments": int(optimizer),
        "gradients_accumulators": int(count) * 4 + int(params),
    }


# ------------------------------------------------------------------ the levers


def rank_levers(report: dict) -> list:
    """The actual knobs this stack exposes that shed bytes, ranked by modeled
    savings against THIS report's buckets — so the fits-check/OOM message names
    the biggest lever first instead of reciting a generic list. Never empty:
    remat-harder is always applicable as a fallback."""
    buckets = report.get("buckets") or {}
    ctx = report.get("context") or {}
    opt = int(buckets.get("optimizer_moments", 0))
    act = int(buckets.get("activations_workspace", 0))
    kv = int(buckets.get("kv_pool", 0))
    levers = []

    dp = int(ctx.get("dp_replicate", 1) or 1)
    if int(ctx.get("zero_stage", 0) or 0) == 0 and dp > 1 and opt > 0:
        levers.append(
            {
                "lever": "zero_stage",
                "suggestion": f"set zero_stage=1 to shard optimizer moments over dp_replicate={dp}",
                "modeled_savings_bytes": opt * (dp - 1) // dp,
            }
        )
    remat = str(ctx.get("remat_variant") or "")
    if ctx.get("kind") != "serving" and "full" not in remat:
        levers.append(
            {
                "lever": "remat",
                "suggestion": f"switch remat_variant to full (currently {remat or 'none'}) to recompute activations in backward",
                "modeled_savings_bytes": act // 2,
            }
        )
    if ctx.get("kind") != "serving":
        levers.append(
            {
                "lever": "gradient_accumulation_steps",
                "suggestion": "double gradient_accumulation_steps to halve the live microbatch",
                "modeled_savings_bytes": act // 2,
            }
        )
    if kv > 0 and ctx.get("kv_cache") == "paged":
        levers.append(
            {
                "lever": "paged_num_blocks",
                "suggestion": f"halve paged_num_blocks (currently {ctx.get('paged_num_blocks')}) to shrink the KV pool",
                "modeled_savings_bytes": kv // 2,
            }
        )
    if kv > 0 and ctx.get("quant_kv") != "int8":
        levers.append(
            {
                "lever": "quant_kv",
                "suggestion": "set quant_kv=int8 to halve KV pool bytes (bf16 -> int8 paged blocks)",
                "modeled_savings_bytes": kv // 2,
            }
        )
    levers.sort(key=lambda entry: -(entry["modeled_savings_bytes"] or 0))
    if not levers:
        levers.append(
            {
                "lever": "remat",
                "suggestion": "increase rematerialization / reduce batch geometry to shed workspace bytes",
                "modeled_savings_bytes": None,
            }
        )
    return levers


def _format_levers(levers: list) -> str:
    lines = []
    for entry in levers:
        saved = entry.get("modeled_savings_bytes")
        saved_s = f"~{saved / (1024 ** 2):.0f} MiB" if saved else "unmodeled"
        lines.append(f"  - {entry['lever']}: {entry['suggestion']} ({saved_s})")
    return "\n".join(lines)


# ------------------------------------------------------------ preflight checks


def preflight_fits_check(
    report: dict, bytes_limit: Optional[int] = None, env: Optional[dict] = None
) -> dict:
    """Compare the report's predicted per-device peak against the device
    allocation budget, before the first dispatch.

    Returns a verdict dict; raises :class:`FitsCheckFailure` when over budget
    and the mode is ``fail`` (the default). ``MODALITIES_TPU_MEMSCOPE_FITS_CHECK``
    = ``warn`` logs instead, ``off`` skips entirely. Without a budget (the
    CPU) the check is inert."""
    env = os.environ if env is None else env
    mode = (env.get(FITS_CHECK_ENV) or "fail").strip().lower()
    verdict = {
        "checked": False,
        "fits": None,
        "predicted_peak_bytes": int(report.get("predicted_peak_bytes", 0)),
        "bytes_limit": None,
        "mode": mode,
    }
    if mode == "off":
        return verdict
    limit = bytes_limit if bytes_limit is not None else min_bytes_limit()
    if not limit:
        return verdict  # CPU / no-budget backend: inert
    verdict["bytes_limit"] = int(limit)
    verdict["checked"] = True
    verdict["fits"] = verdict["predicted_peak_bytes"] <= int(limit)
    if verdict["fits"]:
        return verdict
    levers = report.get("levers") or rank_levers(report)
    message = (
        f"memscope fits-check: predicted per-device peak "
        f"{verdict['predicted_peak_bytes'] / (1024 ** 3):.2f} GiB exceeds the device "
        f"budget {int(limit) / (1024 ** 3):.2f} GiB — this run would die in device "
        "allocation. Levers, biggest modeled savings first:\n"
        f"{_format_levers(levers)}\n"
        f"Set {FITS_CHECK_ENV}=warn to proceed anyway."
    )
    if mode == "warn":
        logger.warning(message)
        return verdict
    raise FitsCheckFailure(message)


# ------------------------------------------------------------ runtime timeline


class MemoryTimeline:
    """Per-step per-device memory stats into registry gauges and sink events,
    keeping a short tail in memory for the OOM dump. A device with no numeric
    stats (the CPU) makes the sample None and publishes nothing."""

    def __init__(self, telemetry=None, executable: str = "train_step", keep: int = 32):
        self.telemetry = telemetry
        self.executable = executable
        self.recent: deque = deque(maxlen=int(keep))

    def sample(self, step_id: int) -> Optional[dict]:
        devices = device_memory_stats()
        numeric = {
            name: stats for name, stats in devices.items() if "error" not in stats and stats
        }
        if not numeric:
            return None
        in_use = max(
            s.get("bytes_in_use", s.get("peak_bytes_in_use", 0)) for s in numeric.values()
        )
        headroom = {
            name: s["bytes_limit"] - s.get("bytes_in_use", s.get("peak_bytes_in_use", 0))
            for name, s in numeric.items()
            if s.get("bytes_limit")
        }
        sample = {
            "step": int(step_id),
            "executable": self.executable,
            "bytes_in_use": int(in_use),
            "devices": numeric,
            "headroom_bytes": headroom,
        }
        self.recent.append(sample)
        telemetry = self.telemetry
        if telemetry is None:
            from modalities_tpu_torch.telemetry import get_active_telemetry

            telemetry = get_active_telemetry()
        telemetry.publish_memory_timeline(sample)
        return sample


def live_blocks_snapshot(top_k: int = 32) -> dict:
    """The top-K allocated blocks of the caching allocator by size (JAX's
    `live_arrays_snapshot` under its key names: `arrays` holds one entry a
    block, `nbytes` its size; a block has no shape or dtype). The CPU has no
    allocator snapshot: its answer is empty."""
    import torch

    blocks = []
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        for segment in torch.cuda.memory_snapshot():
            for block in segment.get("blocks", []):
                if block.get("state") == "active_allocated":
                    blocks.append({"nbytes": int(block["size"]), "shape": None, "dtype": None,
                                   "device": int(segment.get("device", 0)),
                                   "segment_type": segment.get("segment_type")})
    blocks.sort(key=lambda b: -b["nbytes"])
    return {"total_bytes": sum(b["nbytes"] for b in blocks), "count": len(blocks), "arrays": blocks[: int(top_k)]}


class MemscopeWindow:
    """Allocator snapshots armed by env var, the memory sibling of
    perfscope's ProfileWindow: ``MODALITIES_TPU_MEMSCOPE_AT_STEP=N`` (one
    step) or ``N:K`` (K steps starting at N), written as
    ``memscope_live_arrays_step_<s>.json`` into ``MODALITIES_TPU_MEMSCOPE_DIR``
    or the folder the trainer passes."""

    TOP_K = 32

    def __init__(self, start_step: int, num_steps: int = 1, out_dir: Optional[Path] = None):
        if num_steps < 1:
            raise ValueError(f"memscope window needs num_steps >= 1, got {num_steps}")
        self.start_step = int(start_step)
        self.num_steps = int(num_steps)
        self.out_dir = Path(out_dir) if out_dir is not None else None
        self.last_snapshot: Optional[dict] = None

    @classmethod
    def from_env(cls, fallback_dir: Optional[Path] = None) -> Optional["MemscopeWindow"]:
        raw = os.environ.get(SNAPSHOT_ENV, "").strip()
        if not raw:
            return None
        start, num = parse_window(raw, SNAPSHOT_ENV, "snapshot")
        out = os.environ.get(SNAPSHOT_DIR_ENV)
        return cls(start, num, Path(out) if out else fallback_dir)

    def maybe_snapshot(self, step_id: int) -> Optional[dict]:
        """Call after `step_id` completed; snapshots inside [N, N+K)."""
        if not (self.start_step <= step_id < self.start_step + self.num_steps):
            return None
        snapshot = live_blocks_snapshot(top_k=self.TOP_K)
        snapshot["step"] = int(step_id)
        self.last_snapshot = snapshot
        out_dir = self.out_dir or Path(os.getcwd())
        write_report(snapshot, out_dir / f"memscope_live_arrays_step_{step_id}.json")
        logger.info("memscope: allocator snapshot at step %d (%d blocks, %.1f MiB)", step_id, snapshot["count"],
                    snapshot["total_bytes"] / (1024 ** 2))
        return snapshot


# --------------------------------------------------------------- OOM forensics


def write_oom_dump(
    artifact_dir,
    rank: int,
    step: int,
    exc: BaseException,
    static_report: Optional[dict] = None,
    timeline: Optional[MemoryTimeline] = None,
    window: Optional[MemscopeWindow] = None,
    metrics_snapshot: Optional[dict] = None,
) -> Optional[Path]:
    """Forensic artifact for a device allocation failure: what the static scope
    predicted, what the timeline saw last, which blocks were held, and which
    levers to pull. Atomic write; never raises — the OOM itself still
    propagates, the dump is best-effort context."""
    try:
        levers = (
            rank_levers(static_report)
            if static_report
            else [
                {"lever": name, "suggestion": f"reduce memory via {name}", "modeled_savings_bytes": None}
                for name in DEFAULT_LEVERS
            ]
        )
        live = window.last_snapshot if window is not None else None
        if live is None:
            live = live_blocks_snapshot()
        artifact = {
            "event": "oom",
            "rank": int(rank),
            "step": int(step),
            "error": str(exc)[:2000],
            "wall_time": time.time(),
            "device_memory": device_memory_stats(),
            "static_report": static_report,
            "timeline_tail": list(timeline.recent) if timeline is not None else [],
            "live_arrays": live,
            "metrics": metrics_snapshot,
            "suggested_levers": levers,
        }
        artifact_dir = Path(artifact_dir)
        artifact_dir.mkdir(parents=True, exist_ok=True)
        path = artifact_dir / f"oom_dump_rank_{rank}_step_{step}.json"
        tmp = path.with_suffix(".json.tmp")
        with open(tmp, "w") as f:
            json.dump(artifact, f, indent=1, default=str)
            f.flush()
        tmp.rename(path)
        logger.error("memscope: OOM forensics dump written -> %s", path)
        return path
    except Exception:
        logger.exception("memscope: OOM dump failed (the OOM still propagates)")
        return None


def oom_forensics(
    artifact_dir,
    rank: int,
    step: int,
    exc: BaseException,
    static_report: Optional[dict] = None,
    timeline: Optional[MemoryTimeline] = None,
    window: Optional[MemscopeWindow] = None,
    metrics_snapshot: Optional[dict] = None,
):
    """Write the dump and build the resumable :class:`OutOfMemory` to raise in
    its place (``raise oom_forensics(...) from e``): the CLI exits 75, so a
    supervisor warmstarts the run instead of burying the allocation failure
    in a generic crash."""
    from modalities_tpu_torch.resilience.errors import OutOfMemory

    path = write_oom_dump(
        artifact_dir, rank, step, exc,
        static_report=static_report, timeline=timeline, window=window,
        metrics_snapshot=metrics_snapshot,
    )
    where = str(path) if path is not None else "(dump failed; see log)"
    return OutOfMemory(
        f"device allocation failed at step {step}: {str(exc)[:500]} — "
        f"forensics dump: {where}; exiting resumable so the supervisor can "
        "warmstart (possibly degraded: see suggested_levers) to resume"
    )

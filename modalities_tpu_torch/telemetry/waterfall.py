"""MFU waterfall, the port of modalities_tpu/telemetry/waterfall.py:
decompose theoretical peak → achieved MFU into named deductions that sum to the gap BY CONSTRUCTION (the perfscope closure
discipline applied to the ROADMAP item-1 MFU gap).

The decomposition charges wall-clock buckets first (time the device provably
did not spend in train math, valued at peak), then splits the residual
in-step gap between collective exposure and kernel roofline inefficiency
using perfscope's cost-model fractions; whatever the named causes cannot
explain lands in ``other`` as an exact residual:

    peak − achieved == data_stall + compile + checkpoint_eval
                       + collective_exposure_ici + collective_exposure_dcn
                       + kernel_inefficiency + other

Each named deduction is clamped to the gap still unexplained (allocation
order above), so every term is non-negative and the closure is exact — not
approximately, but as an identity over floats by construction.

Collective exposure is split by fabric: ``collective_exposure_ici`` is the
within-slice share (fast interconnect), ``collective_exposure_dcn`` the
cross-slice share (the slow fabric the hierarchical reduction pushes to one
all-reduce per step) — perfscope's ``collective:dcn`` bucket vs the other
``collective:*`` buckets, via ``collective_fractions``.
"""

from __future__ import annotations

from typing import Mapping, Optional

# Allocation order is semantic: host-side wall losses are charged before the
# in-step device losses, so "other" absorbs only what no named cause explains.
DEDUCTIONS = (
    "data_stall",
    "compile",
    "checkpoint_eval",
    "collective_exposure_ici",
    "collective_exposure_dcn",
    "kernel_inefficiency",
    "other",
)


def mfu_waterfall(
    mfu_achieved: float,
    wall_s: float,
    buckets: Mapping[str, float],
    peak_mfu: float = 1.0,
    collective_frac: Optional[float] = None,
    dcn_collective_frac: Optional[float] = None,
) -> dict:
    """Build the waterfall from a goodput bucket summary.

    Args:
        mfu_achieved: wall-clock MFU actually achieved over the interval.
        wall_s: wall seconds the buckets cover.
        buckets: goodput bucket seconds (``GoodputLedger.summary()`` /
            ``Telemetry.goodput_summary()`` shape).
        peak_mfu: the theoretical ceiling to decompose against (1.0 = the
            hardware peak the MFU is already normalized to).
        collective_frac: fraction of in-step device time the cost model
            attributes to exposed collectives (``collective_fractions`` over a
            perfscope report); None = unknown → the whole in-step gap is
            charged to kernel inefficiency.
        dcn_collective_frac: the cross-slice (``collective:dcn``) share of
            in-step device time — a subset of ``collective_frac``, clamped to
            it; None or 0 on single-slice meshes → the whole collective
            exposure is ICI.

    Returns dict with peak/achieved/gap and a ``deductions`` mapping whose
    values sum exactly to gap.
    """
    # Every published term is snapped to a dyadic grid (multiples of 2^-40,
    # ~9e-13 — far below any meaningful MFU resolution): sums and differences
    # of grid values are EXACT in float64, so the closure below is an identity
    # under plain `sum()`, not an up-to-rounding approximation.
    scale = 2.0 ** 40

    def snap(x: float) -> float:
        return round(x * scale) / scale

    peak = snap(max(float(peak_mfu), 0.0))
    achieved = min(snap(min(max(float(mfu_achieved), 0.0), peak)), peak)
    gap = peak - achieved

    wall = max(float(wall_s), 0.0)

    def frac(*names: str) -> float:
        if wall <= 0.0:
            return 0.0
        return min(sum(max(float(buckets.get(n, 0.0)), 0.0) for n in names) / wall, 1.0)

    # Wall-time causes, valued at peak: a second not spent in train_step costs
    # (1/wall) * peak of achievable MFU.
    proposed = {
        "data_stall": frac("data_stall") * peak,
        "compile": frac("init", "compile_first_step") * peak,
        "checkpoint_eval": frac("checkpoint", "eval") * peak,
    }

    # In-step device gap: even if every non-train second were free, train_step
    # time alone caps MFU at train_frac * peak; what's below that is lost
    # inside the step — split by the cost model's collective share.
    train_frac = frac("train_step")
    device_gap = max(train_frac * peak - achieved, 0.0)
    c = min(max(float(collective_frac), 0.0), 1.0) if collective_frac is not None else 0.0
    d = min(max(float(dcn_collective_frac), 0.0), c) if dcn_collective_frac is not None else 0.0
    proposed["collective_exposure_ici"] = device_gap * (c - d)
    proposed["collective_exposure_dcn"] = device_gap * d
    proposed["kernel_inefficiency"] = device_gap * (1.0 - c)

    # Exact closure: allocate each named cause only up to the gap still
    # unexplained; the remainder IS "other". All values live on the dyadic
    # grid, so the chain subtractions and the verifying sum are exact.
    deductions: dict[str, float] = {}
    remaining = gap
    for name in DEDUCTIONS[:-1]:
        take = min(snap(proposed[name]), remaining)
        deductions[name] = take
        remaining -= take
    deductions["other"] = remaining

    return {
        "peak": peak,
        "achieved": achieved,
        "gap": gap,
        "deductions": deductions,
    }


def collective_fractions(report: Mapping) -> Optional[tuple[float, float]]:
    """(total, dcn) collective fractions of the train_step cost-model time in
    a perfscope report (``perfscope_for_config`` shape): total spans every
    ``collective:*`` bucket, dcn only the cross-slice ``collective:dcn`` one
    (always <= total; 0 on single-slice meshes). None when the report has no
    usable train_step bucket breakdown."""
    try:
        step = report["executables"]["train_step"]
        bucket_rows = step["buckets"]
    except (KeyError, TypeError):
        return None
    total = sum(float(row.get("est_time_s", 0.0)) for row in bucket_rows.values())
    if total <= 0.0:
        return None
    exposed = dcn = 0.0
    for name, row in bucket_rows.items():
        if not name.startswith("collective:"):
            continue
        t = float(row.get("est_time_s", 0.0))
        exposed += t
        if name == "collective:dcn":
            dcn += t
    return min(exposed / total, 1.0), min(dcn / total, 1.0)


def collective_fraction(report: Mapping) -> Optional[float]:
    """Total collective fraction only (legacy shape of ``collective_fractions``)."""
    fractions = collective_fractions(report)
    return None if fractions is None else fractions[0]


def last_waterfall_from_sink(sink_path) -> Optional[dict]:
    """The newest ``mfu_waterfall`` record in a telemetry sink (file or folder
    of ``telemetry_rank_*.jsonl``) — the trainer publishes one per interval,
    cumulative, so the last one describes the whole run. None when the run
    never published a waterfall (serving-only sinks, MFU calculator off)."""
    from pathlib import Path

    from modalities_tpu_torch.telemetry.goodput import _iter_sink_events

    sink_path = Path(sink_path)
    files = (
        sorted(sink_path.glob("telemetry_rank_*.jsonl"))
        if sink_path.is_dir()
        else [sink_path]
    )
    last = None
    for file in files:
        if not file.exists():
            continue
        for event in _iter_sink_events(file):
            if event.get("event") == "mfu_waterfall":
                last = event
    if last is None:
        return None
    deductions = dict(last.get("deductions") or {})
    if "collective_exposure" in deductions and "collective_exposure_ici" not in deductions:
        # pre-split sink records: the undifferentiated exposure was ICI-only
        # (single-slice meshes were the only meshes then)
        deductions["collective_exposure_ici"] = deductions.pop("collective_exposure")
    return {
        "peak": float(last.get("peak", 1.0)),
        "achieved": float(last.get("achieved", 0.0)),
        "gap": float(last.get("gap", 0.0)),
        "deductions": deductions,
    }


def format_waterfall_table(waterfall: Mapping) -> str:
    """Render one waterfall as the aligned table `data analyze_telemetry`
    prints (peak at the top, each deduction subtracted, achieved at the
    bottom — the running level column makes the closure visible)."""
    rows = [("peak MFU", waterfall["peak"], waterfall["peak"])]
    level = waterfall["peak"]
    for name in DEDUCTIONS:
        value = waterfall["deductions"].get(name, 0.0)
        level -= value
        rows.append((f"- {name}", value, level))
    rows.append(("= achieved MFU", waterfall["achieved"], waterfall["achieved"]))
    width = max(len(label) for label, _, _ in rows)
    lines = [f"{'cause':<{width}}  {'delta':>8}  {'level':>8}"]
    for label, value, running in rows:
        lines.append(f"{label:<{width}}  {value:8.4f}  {running:8.4f}")
    return "\n".join(lines)

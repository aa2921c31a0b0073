"""Pipeline schedules as static tick tables: the port's own copy of
modalities_tpu/parallel/pipeline_schedules.py (plain Python and numpy; the
port imports nothing of the JAX package). Its tables are held equal to the
JAX package's, array for array (tests/test_torch_pipeline_schedules.py).

A schedule is three integer tables indexed [tick, device] (f/b) and [tick] (h):

- ``f``: which (virtual_chunk, microbatch) this device runs a stage FORWARD for,
  encoded as ``chunk * M + microbatch`` (-1 = none)
- ``b``: same encoding for the stage BACKWARD slot
- ``h``: which microbatch the head + loss runs for at this tick (on the device
  of the last global stage)

Executor slot order within a tick (parallel/pipeline_scheduled.py): F slots ->
H slot -> B slots -> hops. Hence F(g,m), H(m), and B on the SAME device may
share a tick, while anything crossing devices needs a strictly earlier tick.

Interleaved 1F1B: `num_virtual` > 1 virtual chunks per device. Global stage
``g = chunk * P + device`` owns the layer block ``[g*L/(V*P), (g+1)*L/(V*P))``;
activations hop device -> device+1 each tick (wrapping device P-1 -> 0 advances
the chunk). ZBV / DualPipeV: two chunks in a V shape (global stage g on device
g for g < P, else 2P-1-g) and a split backward (``deferred_w``).

Also here: the schedule names the config accepts (`canonical_schedule_name`,
the JAX model factory's aliases) and the JAX executor's buffer-slot plan
(`slot_assignment`).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np


@dataclass(frozen=True)
class ScheduleTables:
    """Static schedule: arrays [T, P] (f/b; values chunk*M+mb or -1) and [T] (h).

    ``placement`` maps global stage g to its device:
    - "loop": device = g % P, chunk = g // P; activations always hop s -> s+1
      (the wrap P-1 -> 0 advances the chunk). GPipe/1F1B/interleaved.
    - "v": V=2 chunks in a V shape — device = g for g < P else 2P-1-g. Chunk-0
      activations hop down (s -> s+1), chunk-1 activations hop up (s -> s-1), and
      the chunk transition at device P-1 is a local buffer write. ZBV.

    ``deferred_w`` marks the split-backward (zero-bubble) execution mode: the B slot
    runs only the input-cotangent chain (params closed over), and ALL weight
    gradients are produced after the tick scan in one batched per-device pass over
    the stored (chunk input, chunk output-cotangent) pairs — weight-grad work has no
    cross-device dependencies, so it never occupies pipeline ticks at all.
    """

    f: np.ndarray
    b: np.ndarray
    h: np.ndarray
    num_stages: int
    num_microbatches: int
    num_virtual: int = 1
    placement: str = "loop"
    deferred_w: bool = False

    def device_of(self, g: int) -> int:
        if self.placement == "v":
            return g if g < self.num_stages else 2 * self.num_stages - 1 - g
        return g % self.num_stages

    def global_stage(self, chunk: int, device: int) -> int:
        """The global stage that virtual chunk `chunk` of `device` runs."""
        if self.placement == "v":
            return device if chunk == 0 else 2 * self.num_stages - 1 - device
        return chunk * self.num_stages + device

    def chunk_of(self, g: int) -> int:
        """The virtual chunk of global stage g on its device."""
        if self.placement == "v":
            return 0 if g < self.num_stages else 1
        return g // self.num_stages

    @property
    def num_stages_global(self) -> int:
        return self.num_virtual * self.num_stages

    @property
    def num_ticks(self) -> int:
        return self.f.shape[0]

    @property
    def max_inflight(self) -> int:
        """Max (chunk, microbatch) residuals any device holds between F and B."""
        worst = 0
        for s in range(self.num_stages):
            inflight = best = 0
            for t in range(self.num_ticks):
                if self.f[t, s] >= 0:
                    inflight += 1
                best = max(best, inflight)
                if self.b[t, s] >= 0:
                    inflight -= 1
            worst = max(worst, best)
        return worst

    @property
    def bubble_fraction(self) -> float:
        """Unfilled F/B slots (each tick has BOTH slots on every device)."""
        total_slots = 2 * self.num_ticks * self.num_stages
        useful = int((self.f >= 0).sum() + (self.b >= 0).sum())
        return 1.0 - useful / total_slots


SUPPORTED_SCHEDULES = ("gpipe", "1f1b", "interleaved_1f1b", "zbv", "dualpipev")


def build_schedule_tables(
    schedule: str, num_stages: int, num_microbatches: int, num_virtual: int = 1
) -> ScheduleTables:
    """Simulate the schedule tick by tick. Dependency rules (g = chunk*P + device):

    - F(g, m) needs F(g-1, m) at a strictly earlier tick (activation hop at tick end)
    - H(m) needs F(last_g, m) at the same tick or earlier (broadcast precedes H slot)
    - B(last_g, m) needs H(m) at the same tick or earlier (H slot precedes B slot)
    - B(g, m) needs B(g+1, m) strictly earlier (cotangent hop) and F(g, m) same tick
      or earlier (the F slot runs first and saves the residual)
    - one F slot and one B slot per device per tick; one H per tick

    Policies: "gpipe" = all forwards first (B slots idle during fill — the classic
    memory-hungry baseline); "1f1b" = backward-eager with a per-device in-flight cap
    (PipeDream-flush); "interleaved_1f1b" = 1f1b over num_virtual chunks per device.
    """
    if schedule not in SUPPORTED_SCHEDULES:
        raise NotImplementedError(
            f"pipeline schedule {schedule!r} not supported (have {SUPPORTED_SCHEDULES})"
        )
    if schedule in ("zbv", "dualpipev"):
        if num_virtual not in (1, 2):
            raise ValueError(f"{schedule} uses exactly 2 virtual chunks (the V shape)")
        if schedule == "dualpipev":
            return _build_dualpipev_tables(num_stages, num_microbatches)
        return _build_zbv_tables(num_stages, num_microbatches)
    if schedule != "interleaved_1f1b" and num_virtual != 1:
        raise ValueError(f"{schedule} requires num_virtual=1 (got {num_virtual})")
    if schedule == "interleaved_1f1b" and num_virtual < 2:
        raise ValueError("interleaved_1f1b requires num_virtual >= 2")
    if schedule == "interleaved_1f1b" and num_microbatches % num_stages == 0:
        # the canonical ordered schedule is tight; the greedy below remains the
        # fallback for microbatch counts that don't fill whole groups of P
        return _build_interleaved_ordered(num_stages, num_microbatches, num_virtual)

    P, M, V = num_stages, num_microbatches, num_virtual
    G = V * P  # global stages; g's device is g % P, chunk is g // P
    f_done = -np.ones((G, M), dtype=np.int64)
    b_done = -np.ones((G, M), dtype=np.int64)
    h_done = -np.ones((M,), dtype=np.int64)
    last_g = G - 1

    def f_candidate(s: int, t: int):
        """Ready forward for device s, DEEPEST chunk first (advancing a microbatch
        toward the last global stage beats starting fresh early-chunk work — the
        m-major order deadlocks interleaved schedules: every device fills its
        in-flight cap with chunk-0 microbatches before anything reaches the last
        stage, so no backward can ever start). Within a chunk, microbatches in order."""
        for c in range(V - 1, -1, -1):
            g = c * P + s
            for m in range(M):
                if f_done[g, m] >= 0:
                    continue
                if g > 0 and not (0 <= f_done[g - 1, m] < t):
                    continue
                return g, m
        return None

    def b_candidate(s: int, t: int):
        """Lowest-(m, later-chunk-first) ready backward, using only previous-tick
        state (the simulator picks B slots first so freed residual slots are visible
        to this tick's F cap; the executor still runs F before B within the tick —
        all B dependencies here are strictly earlier, so that order is consistent)."""
        for m in range(M):
            for c in range(V - 1, -1, -1):  # drain later chunks first (deps point up)
                g = c * P + s
                if b_done[g, m] >= 0:
                    continue
                if not (0 <= f_done[g, m] < t):
                    continue
                if g == last_g:
                    if not (0 <= h_done[m] < t):
                        continue
                elif not (0 <= b_done[g + 1, m] < t):
                    continue
                return g, m
        return None

    f_rows, b_rows, h_rows = [], [], []
    t = 0
    max_ticks = 16 * (V * M + P) + 32
    while (b_done < 0).any() or (h_done < 0).any():
        if t >= max_ticks:
            raise RuntimeError(f"schedule {schedule} did not converge (P={P}, M={M}, V={V})")
        f_row = -np.ones(P, dtype=np.int64)
        b_row = -np.ones(P, dtype=np.int64)

        # B slots first in the SIMULATION (their deps are all strictly-earlier), so
        # the freed residual slots are visible to this tick's F in-flight cap
        for s in range(P):
            if schedule == "gpipe" and (f_done < 0).any():
                break
            cand = b_candidate(s, t)
            if cand is None:
                continue
            g, m = cand
            b_row[s] = g // P * M + m
            b_done[g, m] = t

        # F slots
        for s in range(P):
            cand = f_candidate(s, t)
            if cand is None:
                continue
            g, m = cand
            if schedule in ("1f1b", "interleaved_1f1b") and g < P:
                # Warmup cap on STARTING new microbatches (chunk-0 forwards only):
                # throttling deeper-chunk forwards deadlocks interleaving — every
                # device fills up before any microbatch reaches the last stage and no
                # backward can ever run. Advancing started work is always allowed, so
                # residuals are bounded at ~V * cap per device. The +1 headroom covers
                # the cotangent hop landing a tick after the upstream backward.
                # steady state needs ~V*P microbatches in flight to keep all V*P
                # global stages busy (interleaving trades memory for bubble)
                started = int((f_done[s] >= 0).sum())
                drained = int((b_done[s] >= 0).sum())
                if started - drained >= max(1, V * (P - s)) + 1:
                    continue
            f_row[s] = g // P * M + m
            f_done[g, m] = t

        # H slot: sees this tick's last-stage forward (broadcast precedes it)
        hm = next((m for m in range(M) if h_done[m] < 0 and 0 <= f_done[last_g, m] <= t), -1)
        if hm >= 0:
            h_done[hm] = t

        f_rows.append(f_row)
        b_rows.append(b_row)
        h_rows.append(hm)
        t += 1

    tables = ScheduleTables(
        f=np.stack(f_rows),
        b=np.stack(b_rows),
        h=np.asarray(h_rows, dtype=np.int64),
        num_stages=P,
        num_microbatches=M,
        num_virtual=V,
    )
    _validate(tables)
    return tables


def _build_interleaved_ordered(num_stages: int, num_microbatches: int, num_virtual: int) -> ScheduleTables:
    """Canonical interleaved-1F1B op ordering (the Megatron-LM / torch
    Interleaved1F1B pattern, reference pipeline_parallelism.py:13-20), simulated
    onto tick tables. Each device works through its (chunk, microbatch) ops in the
    fixed order "groups of P microbatches, cycling chunks" —
    F: (c0, m0..m_{P-1}), (c1, m0..m_{P-1}), (c0, m_P..), ... and B the same with
    chunks reversed — with a warmup of 2*(P-s-1) + (V-1)*P forwards, then strict
    1F-1B alternation. Requires M % P == 0 (whole groups); the greedy builder
    handles other M. Tighter than the greedy at every (P, M) tested: e.g. P=8 M=16
    V=2 drops from 117 ticks to 55."""
    P, M, V = num_stages, num_microbatches, num_virtual

    def op_order(reverse_chunks: bool):
        order = []
        for j in range((M // P) * V):
            c = j % V
            if reverse_chunks:
                c = V - 1 - c
            base = (j // V) * P
            order.extend((c, base + i) for i in range(P))
        return order

    f_order = op_order(False)
    b_order = op_order(True)
    G = V * P
    last_g = G - 1
    f_done = -np.ones((G, M), dtype=np.int64)
    b_done = -np.ones((G, M), dtype=np.int64)
    h_done = -np.ones((M,), dtype=np.int64)
    f_ptr = [0] * P
    b_ptr = [0] * P
    warmup = [min(len(f_order), 2 * (P - s - 1) + (V - 1) * P) for s in range(P)]

    f_rows, b_rows, h_rows = [], [], []
    t = 0
    max_ticks = 16 * (V * M + P) + 32
    while (b_done < 0).any() or (h_done < 0).any():
        if t >= max_ticks:
            raise RuntimeError(f"ordered interleaved schedule did not converge (P={P}, M={M}, V={V})")
        f_row = -np.ones(P, dtype=np.int64)
        b_row = -np.ones(P, dtype=np.int64)

        # B slots (deps strictly earlier; H from earlier ticks only — the executor's
        # same-tick H->B ordering makes this conservative, never wrong)
        for s in range(P):
            if b_ptr[s] >= len(b_order):
                continue
            c, m = b_order[b_ptr[s]]
            g = c * P + s
            if not (0 <= f_done[g, m] < t):
                continue
            if g == last_g:
                if not (0 <= h_done[m] < t):
                    continue
            elif not (0 <= b_done[g + 1, m] < t):
                continue
            b_row[s] = c * M + m
            b_done[g, m] = t
            b_ptr[s] += 1

        # F slots: warmup forwards freely, then strict 1F-1B pacing — at most one
        # forward beyond warmup per completed backward (Megatron's steady-state
        # "forward_step; backward_step" iteration expressed as a count bound)
        for s in range(P):
            if f_ptr[s] >= len(f_order):
                continue
            if f_ptr[s] >= warmup[s] + b_ptr[s] + 1:
                continue
            c, m = f_order[f_ptr[s]]
            g = c * P + s
            if g > 0 and not (0 <= f_done[g - 1, m] < t):
                continue
            f_row[s] = c * M + m
            f_done[g, m] = t
            f_ptr[s] += 1

        hm = next((m for m in range(M) if h_done[m] < 0 and 0 <= f_done[last_g, m] <= t), -1)
        if hm >= 0:
            h_done[hm] = t

        f_rows.append(f_row)
        b_rows.append(b_row)
        h_rows.append(hm)
        t += 1

    tables = ScheduleTables(
        f=np.stack(f_rows),
        b=np.stack(b_rows),
        h=np.asarray(h_rows, dtype=np.int64),
        num_stages=P,
        num_microbatches=M,
        num_virtual=V,
    )
    _validate(tables)
    return tables


def _build_zbv_tables(num_stages: int, num_microbatches: int) -> ScheduleTables:
    """ZBVZeroBubble (reference pipeline_parallelism.py:13-20 ships torch's
    ScheduleZBVZeroBubble; schedule family from "Zero Bubble Pipeline Parallelism",
    Qi et al. 2023 — re-derived for the SPMD tick executor).

    ZB-V's signature op placement — W (weight-grad) slots filled into bubble
    ticks — is dominated here by deferring ALL weight grads to one bubble-free
    post-scan pass per device (``deferred_w``); there is no W work left to
    schedule into ticks, and a dependency-greedy fill of the F/B slots is then
    near-optimal. `dualpipev` shares this V placement and split backward but
    enforces its own dual-direction F+B pairing — see _build_dualpipev_tables for
    the distinct tables and the TPU cost note.

    V placement: global stage g lives on device g (g < P) or 2P-1-g (g >= P), so
    each device holds two ADJACENT stages of the V and the first/last stage share
    device 0 — the loss is computed where microbatches enter. The backward is split:
    B(g, m) runs the input-cotangent chain (storing per-layer (x, dy) pairs), W(g, m)
    later turns the stored pairs into parameter gradients. W slots fill ticks where
    the device would otherwise sit in a warmup/drain bubble.

    Honest cost model (this executor remats): F=1 chunk-forward unit, B=2 (dx-only
    vjp: residual forward + input-cotangent chain, params closed over). Weight
    gradients are NOT tick-scheduled at all (``deferred_w``): after the tick scan,
    each device turns its stored (chunk input, output cotangent) pairs into weight
    grads in one batched local pass (cost ~3 units x V x M, bubble-free by
    construction — it has no cross-device dependencies). Total work is ~6 units per
    microbatch per device vs fused 1F1B's 4, but the pipeline's serial backward
    chain costs 2 per stage hop instead of 3 and the fill/drain bubbles carry no
    weight-grad work — ZBV wins in the bubble-dominated regime (M <~ P, deep
    pipelines); prefer 1f1b when M >> P, where total FLOPs dominate. Pair-storage
    memory is constant in M: V x ([B,S,E] input + [B,S,E] cotangent) per device.

    Dependencies (executor in-tick slot order F -> broadcast -> H -> B -> hops):
    - F(g, m) needs F(g-1, m) strictly earlier (hop — or the device-P-1 local
      chunk-0 -> chunk-1 write, which also lands at tick end)
    - H(m) needs F(2P-1, m) same tick or earlier; B(2P-1, m) needs H(m) same tick
      or earlier; other B(g, m) need B(g+1, m) strictly earlier + F(g, m) <= tick
    - one F and one B slot per device per tick; one H per tick
    """
    return _build_v_tables(num_stages, num_microbatches, dual_overlap=False)


def _build_dualpipev_tables(num_stages: int, num_microbatches: int) -> ScheduleTables:
    """DualPipeV (reference pipeline_parallelism.py:13-20 ships torch's
    ScheduleDualPipeV; schedule from DeepSeek-V3's DualPipe, halved to its "V"
    form): the same V placement and split backward as ZB-V, plus the schedule's
    signature property — in the overlap zone each device pairs a FORWARD of one
    direction (chunk) with a BACKWARD of the other direction in the same unit.

    These are DISTINCT tables from `zbv` whenever the schedule has an overlap zone
    — i.e. num_microbatches > num_stages (asserted by test): the greedy zbv fill
    pairs same-chunk F+B exclusively; this builder swaps each same-chunk pairing to
    the opposite chunk whenever a ready forward exists there. For M <= P no
    same-chunk F+B overlap zone exists, the swap pass never fires, and the two
    schedules emit byte-identical tables — a zbv-vs-dualpipev benchmark at small M
    compares the same program with itself, not two schedules.

    Honest TPU cost note: dual-direction pairing exists to hide cross-device
    communication under compute in an eager multi-stream runtime (each direction's
    send/recv overlaps the other's kernels). In this single-program SPMD executor
    the hops are XLA collectives already overlapped with the next tick's compute,
    so the pairing buys nothing here and typically COSTS ~2 ticks over zbv's
    greedy fill (the swap perturbs the optimal admission order). Ship `dualpipev`
    for parity and comparison; prefer `zbv` on TPU — and know that a zbv-vs-
    dualpipev benchmark in this framework measures exactly this op-order delta.
    """
    return _build_v_tables(num_stages, num_microbatches, dual_overlap=True)


def _build_v_tables(num_stages: int, num_microbatches: int, dual_overlap: bool) -> ScheduleTables:
    P, M = num_stages, num_microbatches
    G = 2 * P
    last_g = G - 1

    def dev(g: int) -> int:
        return g if g < P else 2 * P - 1 - g

    stages_of = [[] for _ in range(P)]
    for g in range(G):
        stages_of[dev(g)].append(g)

    f_done = -np.ones((G, M), dtype=np.int64)
    b_done = -np.ones((G, M), dtype=np.int64)
    h_done = -np.ones((M,), dtype=np.int64)

    def f_ready(g: int, t: int):
        """First microbatch with a ready forward at global stage g, else None."""
        for m in range(M):
            if f_done[g, m] >= 0:
                continue
            if g > 0 and not (0 <= f_done[g - 1, m] < t):
                continue
            return m
        return None

    def f_candidate(s: int, t: int):
        """Ready forward, deepest global stage first (advance work toward the head
        before admitting fresh microbatches). No start cap: zbv's executor buffers
        span the full keyspace (memory is O(V x [B,S,E]), independent of in-flight
        count), so throttling admissions only lengthens the schedule."""
        for g in sorted(stages_of[s], reverse=True):
            m = f_ready(g, t)
            if m is not None:
                return g, m
        return None

    def b_candidate(s: int, t: int):
        """Lowest-microbatch ready backward, deeper global stage first."""
        for m in range(M):
            for g in sorted(stages_of[s], reverse=True):
                if b_done[g, m] >= 0:
                    continue
                if not (0 <= f_done[g, m] <= t):
                    continue
                if g == last_g:
                    if not (0 <= h_done[m] <= t):
                        continue
                elif not (0 <= b_done[g + 1, m] < t):
                    continue
                return g, m
        return None

    f_rows, b_rows, h_rows = [], [], []
    t = 0
    max_ticks = 24 * (2 * M + P) + 64
    while (b_done < 0).any() or (h_done < 0).any():
        if t >= max_ticks:
            raise RuntimeError(f"V schedule did not converge (P={P}, M={M})")
        f_row = -np.ones(P, dtype=np.int64)
        b_row = -np.ones(P, dtype=np.int64)
        f_slot: dict[int, tuple[int, int]] = {}
        b_slot: dict[int, tuple[int, int]] = {}

        for s in range(P):
            cand = f_candidate(s, t)
            if cand is not None:
                g, m = cand
                f_slot[s] = (g, m)
                f_done[g, m] = t

        # H slot sees this tick's last-stage forward (broadcast precedes it)
        hm = next((m for m in range(M) if h_done[m] < 0 and 0 <= f_done[last_g, m] <= t), -1)
        if hm >= 0:
            h_done[hm] = t

        for s in range(P):
            cand = b_candidate(s, t)
            if cand is not None:
                g, m = cand
                b_slot[s] = (g, m)
                b_done[g, m] = t

        if dual_overlap:
            # DualPipeV pairing pass: where a device filled BOTH slots from the
            # SAME chunk, re-point the F slot at the opposite chunk if a ready
            # forward exists there. Guards keep the swap sound: never steal an F
            # this tick's H or B already consumed (their same-tick deps).
            for s in range(P):
                if s not in f_slot or s not in b_slot:
                    continue
                (gf, mf), (gb, mb) = f_slot[s], b_slot[s]
                if (gf >= P) != (gb >= P):
                    continue  # already opposite directions
                if (gf, mf) == (gb, mb):
                    continue  # this B consumed this F (loss-stage same-tick chain)
                if gf == last_g and hm == mf:
                    continue  # this H consumed this F
                # (f_ready never reads (gf, mf): g_alt is the other chunk's stage,
                # and the one aliasing case — device P-1, g_alt-1 == gf — fails the
                # strict `< t` dep check whether the entry reads t or -1)
                g_alt = (2 * P - 1 - s) if gf < P else s
                m_alt = f_ready(g_alt, t)
                if m_alt is None:
                    continue  # nothing ready opposite: keep the original pairing
                f_done[gf, mf] = -1
                f_slot[s] = (g_alt, m_alt)
                f_done[g_alt, m_alt] = t

        for s, (g, m) in f_slot.items():
            f_row[s] = (g // P) * M + m
        for s, (g, m) in b_slot.items():
            b_row[s] = (g // P) * M + m
        f_rows.append(f_row)
        b_rows.append(b_row)
        h_rows.append(hm)
        t += 1

    tables = ScheduleTables(
        f=np.stack(f_rows),
        b=np.stack(b_rows),
        h=np.asarray(h_rows, dtype=np.int64),
        num_stages=P,
        num_microbatches=M,
        num_virtual=2,
        placement="v",
        deferred_w=True,
    )
    _validate(tables)
    return tables


def _validate(tb: ScheduleTables) -> None:
    """Structural correctness: every op exactly once, dependencies ordered per the
    executor's in-tick slot order (F -> broadcast -> H -> B -> W -> hops)."""
    P, M, V = tb.num_stages, tb.num_microbatches, tb.num_virtual
    G = V * P

    def g_of(c: int, s: int) -> int:
        if tb.placement == "v":
            return s if c == 0 else 2 * P - 1 - s
        return c * P + s

    f_at = -np.ones((G, M), dtype=np.int64)
    b_at = -np.ones((G, M), dtype=np.int64)
    h_at = -np.ones((M,), dtype=np.int64)
    for t in range(tb.num_ticks):
        for s in range(P):
            if tb.f[t, s] >= 0:
                c, m = divmod(int(tb.f[t, s]), M)
                g = g_of(c, s)
                assert f_at[g, m] < 0, "duplicate forward"
                f_at[g, m] = t
            if tb.b[t, s] >= 0:
                c, m = divmod(int(tb.b[t, s]), M)
                g = g_of(c, s)
                assert b_at[g, m] < 0, "duplicate backward"
                b_at[g, m] = t
        if tb.h[t] >= 0:
            assert h_at[tb.h[t]] < 0, "duplicate head op"
            h_at[tb.h[t]] = t
    assert (f_at >= 0).all() and (b_at >= 0).all() and (h_at >= 0).all(), "missing ops"
    for m in range(M):
        for g in range(1, G):
            assert f_at[g - 1, m] < f_at[g, m], "forward dependency violated"
        assert f_at[G - 1, m] <= h_at[m], "head before last forward"
        assert h_at[m] <= b_at[G - 1, m], "last-stage backward before head"
        for g in range(G - 1):
            assert b_at[g + 1, m] < b_at[g, m], "backward dependency violated"
        for g in range(G):
            assert f_at[g, m] <= b_at[g, m], "backward before forward"


SCHEDULE_ALIASES = {
    "zbvzerobubble": "zbv", "zb_v": "zbv", "zbv_zero_bubble": "zbv",  # the reference's class name
    "dualpipe_v": "dualpipev", "dual_pipe_v": "dualpipev", "scheduledualpipev": "dualpipev",
}


def canonical_schedule_name(name: str) -> str:
    """The schedule a config name selects (JAX model_factory.py:130-134): lower
    case, the reference's class names mapped onto `zbv` / `dualpipev`. An
    unknown name passes through (the caller refuses it)."""
    name = str(name).strip().lower()
    return SCHEDULE_ALIASES.get(name, name)


def slot_assignment(tables: ScheduleTables):
    """The JAX executor's static buffer-slot plan
    (modalities_tpu/parallel/pipeline_scheduled.py:_slot_assignment): greedy
    interval coloring of each (chunk, microbatch) key's lifetime across ALL
    devices (write of the earliest hop/F -> last backward), so two live keys
    never share a slot. Returns (slot_of [V*M], num_slots, y_slot_of [M],
    num_y_slots). As in the JAX plan, chunk c of device s is keyed at
    c * P + s whatever the placement (the V schedules keep every key instead).
    The port's executor keeps each in-flight (chunk, microbatch) autograd
    graph instead of slots; the plan tells how many it holds at most."""
    V, P, M = tables.num_virtual, tables.num_stages, tables.num_microbatches
    G = V * P
    f_at = -np.ones((G, M), dtype=np.int64)
    b_at = -np.ones((G, M), dtype=np.int64)
    h_at = -np.ones((M,), dtype=np.int64)
    for t in range(tables.num_ticks):
        for s in range(P):
            if tables.f[t, s] >= 0:
                c, m = divmod(int(tables.f[t, s]), M)
                f_at[c * P + s, m] = t
            if tables.b[t, s] >= 0:
                c, m = divmod(int(tables.b[t, s]), M)
                b_at[c * P + s, m] = t
        if tables.h[t] >= 0:
            h_at[tables.h[t]] = t

    def color(intervals):
        slots_end: list[int] = []  # last occupied tick per slot
        assign = {}
        for start, end, key in sorted(intervals):
            for i, busy_until in enumerate(slots_end):
                if busy_until < start:
                    slots_end[i] = end
                    assign[key] = i
                    break
            else:
                assign[key] = len(slots_end)
                slots_end.append(end)
        return assign, max(1, len(slots_end))

    main_intervals = []
    for c in range(V):
        for m in range(M):
            start = min(int(f_at[max(c * P + s - 1, 0), m]) for s in range(P))
            end = max(int(b_at[c * P + s, m]) for s in range(P))
            main_intervals.append((start, end, c * M + m))
    main_assign, num_slots = color(main_intervals)
    slot_of = np.asarray([main_assign[k] for k in range(V * M)], dtype=np.int64)
    y_assign, num_y_slots = color([(int(f_at[G - 1, m]), int(h_at[m]), m) for m in range(M)])
    y_slot_of = np.asarray([y_assign[m] for m in range(M)], dtype=np.int64)
    return slot_of, num_slots, y_slot_of, num_y_slots

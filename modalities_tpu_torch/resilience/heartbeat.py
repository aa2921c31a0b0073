"""Peer-health watchdog: out-of-band heartbeats and deadline-bounded
rendezvous, the port of modalities_tpu/resilience/heartbeat.py.

A peer that dies without a signal (an OOM kill, a lost host) leaves every
other rank blocked inside a collective forever. This module turns that hang
into a diagnosed, resumable exit:

- Every process runs a `HeartbeatMonitor` daemon thread that publishes a beat
  (rank, a rising seq, state) every `interval_s` through a transport and keeps
  a last-seen table of its peers. A peer silent for longer than
  `peer_deadline_s`, and not cleanly "leaving", is declared dead: the monitor
  writes an artifact (peer table, coordination phase, every thread's stack)
  and exits `RESUMABLE_EXIT_CODE`, so the supervisor warmstarts.
- Host-side rendezvous points run under `rendezvous("phase")`: a phase still
  open after `rendezvous_deadline_s` takes the same exit. This catches the
  wedged but alive peer, whose heartbeat thread keeps beating.

Transports: the `torch.distributed` c10d store of the default process group
(`StoreTransport`; the JAX package's production transport is the
jax.distributed KV store), a localhost UDP fallback, and an in-process table
for unit tests. `os._exit` is deliberate: the main thread is typically stuck
in a C++ collective that no Python exception can unwind.
"""

from __future__ import annotations

import json
import logging
import os
import socket
import threading
import time
from contextlib import contextmanager
from pathlib import Path
from typing import Callable, Optional

from modalities_tpu_torch.resilience.errors import RESUMABLE_EXIT_CODE
from modalities_tpu_torch.resilience.events import record_event
from modalities_tpu_torch.telemetry.watchdog import collect_thread_stacks

logger = logging.getLogger(__name__)

UDP_PORT_ENV = "MODALITIES_TPU_HB_PORT"

STATE_ALIVE = "alive"
STATE_LEAVING = "leaving"  # clean shutdown in progress: silence is expected


# ------------------------------------------------------------------ transports


class InProcessTransport:
    """Shared-dict transport for unit tests: several monitors in one process."""

    def __init__(self):
        self._lock = threading.Lock()
        self._table: dict[int, dict] = {}

    def publish(self, rank: int, payload: dict) -> None:
        with self._lock:
            self._table[rank] = dict(payload)

    def read_all(self) -> dict[int, dict]:
        with self._lock:
            return {rank: dict(p) for rank, p in self._table.items()}

    def close(self) -> None:
        pass


class StoreTransport:
    """Beats through the c10d store of the default `torch.distributed` process
    group: no extra sockets, and it exists wherever the run's group does (the
    launcher's TCP store, or the world-1 group's in-process store). One `set`
    of this rank's key and one `check` + `get` per peer an interval."""

    def __init__(self, world: int, prefix: str = "mtpu_hb"):
        import torch.distributed as dist

        if not dist.is_initialized():
            raise RuntimeError("no torch.distributed process group: the store heartbeat transport needs its "
                               "c10d store (use the UDP transport otherwise)")
        self._store = dist.distributed_c10d._get_default_store()
        self._world = world
        self._prefix = prefix

    def publish(self, rank: int, payload: dict) -> None:
        self._store.set(f"{self._prefix}/{rank}", json.dumps(payload))

    def read_all(self) -> dict[int, dict]:
        table: dict[int, dict] = {}
        for rank in range(self._world):
            key = f"{self._prefix}/{rank}"
            try:
                if not self._store.check([key]):
                    continue
                table[rank] = json.loads(self._store.get(key))
            except (ValueError, json.JSONDecodeError, RuntimeError):
                continue  # a torn or foreign key must not kill the monitor
        return table

    def close(self) -> None:
        pass


class UDPTransport:
    """Localhost UDP fallback (port base+rank per process) for CPU multi-process
    tests and runs without a process group."""

    def __init__(self, rank: int, world: int, base_port: int, host: str = "127.0.0.1"):
        self._rank = rank
        self._world = world
        self._base_port = base_port
        self._host = host
        self._sock = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
        self._sock.bind((host, base_port + rank))
        self._sock.setblocking(False)
        self._lock = threading.Lock()
        self._table: dict[int, dict] = {}

    def publish(self, rank: int, payload: dict) -> None:
        data = json.dumps(payload).encode()
        with self._lock:
            self._table[rank] = dict(payload)  # own beat is always visible
        for peer in range(self._world):
            if peer == rank:
                continue
            try:
                self._sock.sendto(data, (self._host, self._base_port + peer))
            except OSError:
                pass  # a dead peer's closed port is exactly the expected case

    def read_all(self) -> dict[int, dict]:
        while True:
            try:
                data, _ = self._sock.recvfrom(65536)
            except (BlockingIOError, OSError):
                break
            try:
                payload = json.loads(data.decode())
                rank = int(payload["rank"])
            except (ValueError, KeyError, json.JSONDecodeError):
                continue
            with self._lock:
                seen = self._table.get(rank)
                if seen is None or seen.get("seq", -1) <= payload.get("seq", 0):
                    self._table[rank] = payload
        with self._lock:
            return {rank: dict(p) for rank, p in self._table.items()}

    def close(self) -> None:
        try:
            self._sock.close()
        except OSError:
            pass


def resolve_transport(mode: str, rank: int, world: int):
    """`kv` / `udp` / `off` / `auto`. Auto picks the c10d store when a process
    group is up, the UDP fallback when $MODALITIES_TPU_HB_PORT is set, and turns
    the monitor off for a single process (nothing to watch). `kv` is the JAX
    name of the production transport: here the c10d store."""
    if mode == "off":
        return None
    if mode == "kv":
        return StoreTransport(world)
    port = os.environ.get(UDP_PORT_ENV)
    if mode == "udp":
        if not port:
            raise ValueError(f"heartbeat=udp requires ${UDP_PORT_ENV} (base port)")
        return UDPTransport(rank, world, int(port))
    if mode != "auto":
        raise ValueError(f"unknown heartbeat transport mode {mode!r}")
    if world > 1:
        try:
            return StoreTransport(world)
        except RuntimeError:
            pass
    if port:
        return UDPTransport(rank, world, int(port))
    if world > 1:
        logger.warning("heartbeat=auto: %d processes but neither a process group nor $%s available — "
                       "peer-health monitoring DISABLED", world, UDP_PORT_ENV)
    return None


# --------------------------------------------------------------------- monitor


class HeartbeatMonitor:
    """Per-process beat publisher + peer last-seen table + rendezvous guard.

    `on_fatal(reason, artifact_path)` is injectable for tests; production leaves
    it None and the monitor exits `RESUMABLE_EXIT_CODE` via os._exit (the main
    thread may be unrecoverably stuck inside a collective)."""

    def __init__(
        self,
        rank: int,
        world: int,
        transport,
        interval_s: float = 5.0,
        peer_deadline_s: float = 30.0,
        rendezvous_deadline_s: float = 300.0,
        artifact_dir: Optional[Path] = None,
        on_fatal: Optional[Callable[[str, Optional[Path]], None]] = None,
        clock: Callable[[], float] = time.monotonic,
    ):
        self.rank = rank
        self.world = world
        self.transport = transport
        self.interval_s = float(interval_s)
        self.peer_deadline_s = float(peer_deadline_s)
        self.rendezvous_deadline_s = float(rendezvous_deadline_s)
        self.artifact_dir = Path(artifact_dir) if artifact_dir is not None else None
        self._on_fatal = on_fatal
        self._clock = clock
        self._lock = threading.Lock()
        self._stop_event = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._seq = 0
        self._state = STATE_ALIVE
        self._started_at: Optional[float] = None
        self._last_seen: dict[int, float] = {}
        self._last_payload: dict[int, dict] = {}
        # rendezvous phases nest (gym drain -> checkpoint drain): a stack of
        # (name, entered_at); the OLDEST open phase owns the deadline
        self._phases: list[tuple[str, float]] = []
        self._fired = False

    # ------------------------------------------------------------- lifecycle

    def start(self) -> None:
        if self._thread is not None:
            return
        self._started_at = self._clock()
        self._publish()
        record_event(
            "heartbeat/started", rank=self.rank, world=self.world,
            interval_s=self.interval_s, peer_deadline_s=self.peer_deadline_s,
        )
        self._thread = threading.Thread(
            target=self._run, name="resilience-heartbeat", daemon=True
        )
        self._thread.start()

    def stop(self, state: str = STATE_LEAVING) -> None:
        """Publish a final `leaving` beat so peers do not mistake this process's
        clean shutdown for a death, then stop the thread."""
        with self._lock:
            self._state = state
        self._stop_event.set()
        thread, self._thread = self._thread, None
        if thread is not None:
            thread.join(timeout=10.0)
        try:
            self._publish()
        except Exception:
            logger.warning("final heartbeat publish failed during shutdown", exc_info=True)
        self.transport.close()

    def _run(self) -> None:
        while not self._stop_event.wait(self.interval_s):
            try:
                self.tick()
            except Exception:
                logger.exception("heartbeat tick failed")

    # -------------------------------------------------------------- protocol

    def _publish(self) -> None:
        with self._lock:
            self._seq += 1
            payload = {
                "rank": self.rank,
                "seq": self._seq,
                "state": self._state,
                "wall_time": time.time(),
            }
        self.transport.publish(self.rank, payload)

    def tick(self) -> None:
        """One beat+check cycle (the thread's body; callable directly in tests)."""
        self._publish()
        now = self._clock()
        table = self.transport.read_all()
        with self._lock:
            for rank, payload in table.items():
                seen = self._last_payload.get(rank)
                if seen is None or seen.get("seq", -1) < payload.get("seq", 0):
                    self._last_seen[rank] = now
                self._last_payload[rank] = payload
        self._check_deadlines(now)

    def _check_deadlines(self, now: float) -> None:
        if self._fired:
            return
        baseline = self._started_at if self._started_at is not None else now
        dead: list[int] = []
        with self._lock:
            for peer in range(self.world):
                if peer == self.rank:
                    continue
                if self._last_payload.get(peer, {}).get("state") == STATE_LEAVING:
                    continue
                last = self._last_seen.get(peer, baseline)
                if now - last > self.peer_deadline_s:
                    dead.append(peer)
            overdue_phase = None
            if self.rendezvous_deadline_s > 0 and self._phases:
                name, entered_at = self._phases[0]
                if now - entered_at > self.rendezvous_deadline_s:
                    overdue_phase = (name, now - entered_at)
        if dead:
            self._fatal(
                "peer_dead",
                {"dead_ranks": dead, "peer_deadline_s": self.peer_deadline_s},
            )
        elif overdue_phase is not None:
            self._fatal(
                "rendezvous_timeout",
                {
                    "phase": overdue_phase[0],
                    "stuck_s": round(overdue_phase[1], 3),
                    "rendezvous_deadline_s": self.rendezvous_deadline_s,
                },
            )

    # ------------------------------------------------------------ rendezvous

    def set_phase(self, name: str) -> None:
        with self._lock:
            self._phases.append((name, self._clock()))

    def clear_phase(self) -> None:
        with self._lock:
            if self._phases:
                self._phases.pop()

    @contextmanager
    def rendezvous_guard(self, name: str):
        self.set_phase(name)
        try:
            yield
        finally:
            self.clear_phase()

    # ----------------------------------------------------------------- state

    def cluster_state(self) -> dict:
        """JSON-safe cluster context — the watchdog-artifact state provider and
        the `peer table` section of this monitor's own dump."""
        now = self._clock()
        with self._lock:
            phases = [name for name, _ in self._phases]
            peers = {
                str(peer): {
                    "age_s": round(now - self._last_seen[peer], 3)
                    if peer in self._last_seen
                    else None,
                    "state": self._last_payload.get(peer, {}).get("state"),
                    "seq": self._last_payload.get(peer, {}).get("seq"),
                }
                for peer in range(self.world)
                if peer != self.rank
            }
        return {
            "process_index": self.rank,
            "process_count": self.world,
            "coordination_phase": phases[-1] if phases else None,
            "coordination_phase_stack": phases,
            "peer_heartbeats": peers,
        }

    # ----------------------------------------------------------------- fatal

    def _fatal(self, reason: str, detail: dict) -> None:
        self._fired = True
        record_event(f"heartbeat/{reason}", rank=self.rank, **detail)
        artifact_path = None
        try:
            artifact_path = self._dump(reason, detail)
        except Exception:
            logger.exception("peer-failure artifact dump failed")
        logger.error(
            "HEARTBEAT: %s on rank %d (%s) — exiting resumable (%d)",
            reason, self.rank, detail, RESUMABLE_EXIT_CODE,
        )
        if self._on_fatal is not None:
            self._on_fatal(reason, artifact_path)
            return
        # os._exit: the main thread is likely stuck in a C++ collective that no
        # Python-level exception can unwind; the supervisor sees EX_TEMPFAIL and
        # warmstarts from the last sealed checkpoint
        os._exit(RESUMABLE_EXIT_CODE)

    def _dump(self, reason: str, detail: dict) -> Optional[Path]:
        if self.artifact_dir is None:
            return None
        artifact = {
            "event": "peer_failure",
            "reason": reason,
            "detail": detail,
            "rank": self.rank,
            "wall_time": time.time(),
            "thread_stacks": collect_thread_stacks(),
            "state": self.cluster_state(),
        }
        self.artifact_dir.mkdir(parents=True, exist_ok=True)
        path = self.artifact_dir / f"watchdog_dump_rank_{self.rank}_peer_{reason}.json"
        tmp = path.with_suffix(".json.tmp")
        with open(tmp, "w") as f:
            json.dump(artifact, f, indent=1)
            f.flush()
        tmp.rename(path)
        return path


# -------------------------------------------------- process-global rendezvous

_active_monitor: Optional[HeartbeatMonitor] = None


def set_active_monitor(monitor: Optional[HeartbeatMonitor]) -> Optional[HeartbeatMonitor]:
    """Install the process-global monitor (Main does this for the training
    window). Returns the previous one for finally-restore."""
    global _active_monitor
    previous = _active_monitor
    _active_monitor = monitor
    return previous


def get_active_monitor() -> Optional[HeartbeatMonitor]:
    return _active_monitor


@contextmanager
def rendezvous(name: str):
    """Deadline-guard a host-side rendezvous (collective checkpoint save/restore,
    async-commit drain) against a dead or wedged peer. No-op without an active
    monitor, so library code never guards its calls."""
    monitor = _active_monitor
    if monitor is None:
        yield
        return
    with monitor.rendezvous_guard(name):
        yield


def cluster_context() -> dict:
    """Watchdog state provider: full peer table when a monitor is active, bare
    process identity otherwise (the dump always carries cluster coordinates)."""
    monitor = _active_monitor
    if monitor is not None:
        return monitor.cluster_state()
    from modalities_tpu_torch.running_env import env

    return {"process_index": env.rank(), "process_count": env.world_size()}

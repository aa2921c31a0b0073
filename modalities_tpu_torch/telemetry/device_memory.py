"""Shared device-memory stat walk: the port of
modalities_tpu/telemetry/device_memory.py, on `torch.cuda.memory_stats` and
`torch.cuda.mem_get_info`.

A card reports the JAX key names, so watchdog artifacts read alike:
`bytes_in_use` and `peak_bytes_in_use` (the caching allocator's allocated
bytes, now and at peak), `bytes_limit` (the card's total memory),
`bytes_reserved` and `peak_bytes_reserved` (what the allocator has taken
from the card), `num_allocs` and `bytes_free` (the card's free memory). The
CPU reports no stats, as a JAX CPU device does (`memory_stats()` is None):
its entry is `{}` and the derived figures are None. Every reader tolerates a
raising device: memory telemetry must never be what kills the run it
observes.
"""

from __future__ import annotations

from typing import Optional

import torch

# cached across calls: the device set is fixed for the life of the process.
# None = not yet resolved.
_cached_devices: Optional[list] = None


def local_devices() -> list:
    """The process's devices, resolved once: every CUDA card, else the CPU."""
    global _cached_devices
    if _cached_devices is None:
        if torch.cuda.is_available():
            _cached_devices = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
        else:
            _cached_devices = [torch.device("cpu")]
    return _cached_devices


def reset_device_cache() -> None:
    """Test hook: forget the cached device list."""
    global _cached_devices
    _cached_devices = None


def memory_stats(device) -> Optional[dict]:
    """One device's stats under the JAX key names; None for the CPU."""
    device = torch.device(device)
    if device.type != "cuda":
        return None
    stats = torch.cuda.memory_stats(device)
    free, total = torch.cuda.mem_get_info(device)
    return {
        "bytes_in_use": stats.get("allocated_bytes.all.current", 0),
        "peak_bytes_in_use": stats.get("allocated_bytes.all.peak", 0),
        "bytes_limit": total,
        "bytes_reserved": stats.get("reserved_bytes.all.current", 0),
        "peak_bytes_reserved": stats.get("reserved_bytes.all.peak", 0),
        "num_allocs": stats.get("allocation.all.allocated", 0),
        "bytes_free": free,
    }


def device_memory_stats(devices=None) -> dict:
    """Per-device numeric memory stats, keyed by ``str(device)``. A device
    whose stats raise contributes ``{"error": repr(e)}``: a half-dead device
    is itself a finding in a forensic dump."""
    out = {}
    for device in local_devices() if devices is None else devices:
        try:
            stats = memory_stats(device) or {}
            out[str(device)] = {k: int(v) for k, v in stats.items() if isinstance(v, (int, float))}
        except Exception as e:
            out[str(device)] = {"error": repr(e)}
    return out


def _stat_dicts(devices=None):
    """Yield the numeric stat dict of each device that produced one."""
    for device in local_devices() if devices is None else devices:
        try:
            stats = memory_stats(device) or {}
        except Exception:
            continue
        yield {k: int(v) for k, v in stats.items() if isinstance(v, (int, float))}


def peak_memory_mb(devices=None) -> Optional[float]:
    """Max ``peak_bytes_in_use`` across devices, in MiB; None when no device
    reports one (the CPU)."""
    peak = 0
    for stats in _stat_dicts(devices):
        peak = max(peak, stats.get("peak_bytes_in_use", 0))
    return peak / (1024 * 1024) if peak else None


def hbm_headroom_mb(devices=None) -> Optional[float]:
    """Min of (bytes_limit - peak_bytes_in_use) across devices that report a
    limit, in MiB: the worst device's headroom, the one that runs out first.
    None when no device reports a limit."""
    headroom = None
    for stats in _stat_dicts(devices):
        limit = stats.get("bytes_limit", 0)
        if not limit:
            continue
        room = (limit - stats.get("peak_bytes_in_use", 0)) / (1024 * 1024)
        headroom = room if headroom is None else min(headroom, room)
    return headroom


def min_bytes_limit(devices=None) -> Optional[int]:
    """The smallest per-device budget; None when no device reports one."""
    limits = [s["bytes_limit"] for s in _stat_dicts(devices) if s.get("bytes_limit")]
    return min(limits) if limits else None


def worst_case_memory_stats(devices=None) -> dict:
    """Key-wise max across all devices: one flat dict in the shape one
    device's stats have."""
    worst: dict = {}
    for stats in _stat_dicts(devices):
        for k, v in stats.items():
            worst[k] = max(worst.get(k, 0), v)
    return worst

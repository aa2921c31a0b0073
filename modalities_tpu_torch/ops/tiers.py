"""The JAX package's kernel-tier switches, read as the port reads them.

The JAX package picks a tier per kernel from an environment switch before the
config (modalities_tpu/ops/tiers.py: "auto" | "on" | "off", case-folded, with
the aliases below; a malformed value raises). The port has no tier switch on
the card: a wrapper runs its kernel on a CUDA tensor and its plain PyTorch
version on a CPU tensor, and nothing else (ROADMAP.md, Queue 3 item 17). So:

- `MODALITIES_TPU_FUSED_CE` picks the training head's route, env before
  config, as in JAX: off takes the chunked scan, on/auto the fused-CE
  kernels (`fused_ce_enabled`).
- `MODALITIES_TPU_FUSED_RMSNORM`, `_QUANT_MATMUL` (on/auto) and `_RING_IMPL`
  (flash) are accepted where they name what the port runs; a value that
  would run the plain version on the card (off, dense; flash_interpret, the
  TPU interpreter) is refused; a malformed one raises as in JAX
  (`check_kernel_switches`, `check_ring_impl`).
"""

from __future__ import annotations

import os
from typing import Optional

_ON = ("1", "on", "true", "yes", "force")
_OFF = ("0", "off", "false", "no")
_RING_IMPLS = ("dense", "flash", "flash_interpret")


def _tier(env_name: str, spec_setting: Optional[str] = None) -> str:
    """"on" | "off" | "auto" from the switch, else the config, else "auto"."""
    env = os.environ.get(env_name)
    raw = (env if env is not None else (spec_setting or "auto")).strip().lower()
    if raw in _OFF:
        return "off"
    if raw in _ON:
        return "on"
    if raw == "auto":
        return "auto"
    source = env_name if env is not None else "config"
    raise ValueError(
        f"{source}={raw!r}: expected one of auto/on/off (a malformed tier setting "
        "must raise, never silently demote the kernel to a fallback tier)"
    )


def fused_ce_enabled(spec_setting: Optional[str] = None) -> bool:
    """Whether a chunked head takes the fused-CE route: MODALITIES_TPU_FUSED_CE
    before the config's `lm_head_fused_ce`."""
    return _tier("MODALITIES_TPU_FUSED_CE", spec_setting) != "off"


def _refuse(name: str, raw: str, runs: str) -> NotImplementedError:
    return NotImplementedError(
        f"{name}={raw!r} would run {runs} on the card: the port has no tier switch there, its wrappers run "
        "the kernel on a CUDA tensor and the plain version on a CPU tensor only (ROADMAP.md, Queue 3 item 17); "
        "unset it"
    )


def check_kernel_switches() -> None:
    """MODALITIES_TPU_FUSED_RMSNORM and _QUANT_MATMUL: on/auto name what the
    port runs; off is refused; a malformed value raises."""
    for name in ("MODALITIES_TPU_FUSED_RMSNORM", "MODALITIES_TPU_QUANT_MATMUL"):
        raw = os.environ.get(name)
        if raw is not None and _tier(name) == "off":
            raise _refuse(name, raw, "the plain PyTorch version")


def check_ring_impl() -> None:
    """MODALITIES_TPU_RING_IMPL: flash names what the port runs; dense and
    flash_interpret are refused; anything else raises, as in JAX."""
    raw = os.environ.get("MODALITIES_TPU_RING_IMPL", "").strip()
    if not raw or raw == "flash":
        return
    if raw not in _RING_IMPLS:
        raise ValueError(
            f"MODALITIES_TPU_RING_IMPL={raw!r}: expected dense | flash | flash_interpret — refusing to "
            "silently fall back to a default tier"
        )
    raise _refuse("MODALITIES_TPU_RING_IMPL", raw,
                  "the plain dense hops" if raw == "dense" else "an interpreter instead of the flash kernels")

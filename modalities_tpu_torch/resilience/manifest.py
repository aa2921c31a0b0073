"""Checkpoint integrity: the port of modalities_tpu/resilience/manifest.py,
in the same JSON format, so a folder sealed by either package verifies in the
other.

Every committed checkpoint folder gains a ``manifest.json`` with each file's
relative path, size and sha256 (and the step parsed from the folder name).
It is written only after the save has committed, so its presence certifies a
complete folder; a crash mid-save leaves a folder without one.

`resolve_resume_folder` is the warmstart side: read the resume pointer,
verify the folder it names, and if that fails walk the sibling ring back to
the newest folder that verifies. It runs before the config is built, because
the folder's name is the metadata store (seen steps and tokens, and from them
the sampler's skip, are parsed from it).

Digests read every byte of a checkpoint; ``MODALITIES_TPU_VERIFY_DIGESTS=0``
limits verification to sizes and existence. Each fallback step is logged at
warning level and recorded as the JAX event (`rollback/pointer_target_corrupt`,
`rollback/pointer_target_burned`, `rollback/fallback_folder`,
`rollback/candidate_corrupt`) on the active telemetry sink.
"""

from __future__ import annotations

import hashlib
import json
import logging
import os
import re
from dataclasses import dataclass
from pathlib import Path
from typing import AbstractSet

from modalities_tpu_torch.resilience.retry import retry_io

logger = logging.getLogger(__name__)

MANIFEST_FILE_NAME = "manifest.json"
_SEEN_STEPS_RE = re.compile(r"seen_steps_(\d+)")


def atomic_write_json(path: Path, obj: dict) -> None:
    """Write to a temp file, fsync, then os.replace in the same directory: a
    crash mid-write can leave a stale ``*.tmp`` but never a torn target."""
    path = Path(path)
    tmp_path = path.with_name(path.name + ".tmp")
    with open(tmp_path, "w", encoding="utf-8") as f:
        json.dump(obj, f)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp_path, path)


def _sha256(path: Path) -> str:
    digest = hashlib.sha256()
    with open(path, "rb") as f:
        for chunk in iter(lambda: f.read(1 << 20), b""):
            digest.update(chunk)
    return digest.hexdigest()


def _verify_digests() -> bool:
    return os.environ.get("MODALITIES_TPU_VERIFY_DIGESTS", "1") != "0"


def write_manifest(folder: Path) -> Path:
    """Walk the committed folder and write its manifest (atomically, with IO
    retry). Runs only after the save has committed."""
    folder = Path(folder)
    files = []
    for path in sorted(p for p in folder.rglob("*") if p.is_file()):
        if path.name in (MANIFEST_FILE_NAME, MANIFEST_FILE_NAME + ".tmp"):
            continue
        files.append({"path": str(path.relative_to(folder)), "size": path.stat().st_size, "sha256": _sha256(path)})
    step_match = _SEEN_STEPS_RE.search(folder.name)
    manifest = {
        "version": 1,
        "step": int(step_match.group(1)) if step_match else None,
        "config_hash": None,
        "files": files,
    }
    manifest_path = folder / MANIFEST_FILE_NAME
    retry_io(lambda: atomic_write_json(manifest_path, manifest), what="manifest_write")
    return manifest_path


@dataclass
class ManifestVerification:
    ok: bool
    reason: str


def verify_manifest(folder: Path) -> ManifestVerification:
    """Check the folder against its manifest. A folder without a manifest is
    accepted with a warning (checkpoints written before manifests existed)."""
    folder = Path(folder)
    if not folder.is_dir():
        return ManifestVerification(False, f"checkpoint folder {folder} does not exist")
    manifest_path = folder / MANIFEST_FILE_NAME
    if not manifest_path.is_file():
        logger.warning("checkpoint %s has no %s (pre-manifest checkpoint?): accepting unverified",
                       folder, MANIFEST_FILE_NAME)
        return ManifestVerification(True, "no manifest (legacy checkpoint, unverified)")
    try:
        manifest = json.loads(manifest_path.read_text())
    except (OSError, json.JSONDecodeError) as e:
        return ManifestVerification(False, f"unreadable manifest in {folder}: {e!r}")
    check_digests = _verify_digests()
    for entry in manifest.get("files", []):
        path = folder / entry["path"]
        if not path.is_file():
            return ManifestVerification(False, f"missing file {entry['path']} in {folder}")
        size = path.stat().st_size
        if size != entry["size"]:
            return ManifestVerification(
                False, f"size mismatch for {entry['path']} in {folder}: manifest {entry['size']}, on disk {size}"
            )
        if check_digests and _sha256(path) != entry["sha256"]:
            return ManifestVerification(False, f"digest mismatch for {entry['path']} in {folder}")
    return ManifestVerification(True, "manifest verified")


def _seen_steps_of(folder: Path) -> int:
    match = _SEEN_STEPS_RE.search(folder.name)
    return int(match.group(1)) if match else -1


def resolve_resume_folder(last_checkpoint_info_path: Path, exclude_steps: AbstractSet[int] = frozenset()) -> Path:
    """The verified warmstart target: the folder the resume pointer names if
    it verifies, else the newest sibling (by the seen-steps count in its name)
    that does. `exclude_steps` are steps the supervisor's degradation ladder
    burned: a folder of such a step is never chosen. Raises FileNotFoundError
    when nothing verifies; a stale ``*.tmp`` pointer is refused."""
    info_path = Path(last_checkpoint_info_path)
    if info_path.suffix == ".tmp":
        raise ValueError(
            f"{info_path} is a stale temp file from an interrupted pointer write; "
            "pass the committed last_checkpoint_info.json instead"
        )
    from modalities_tpu_torch.resilience.events import record_event

    pointed = Path(json.loads(info_path.read_text())["checkpoint_folder_path"])

    if _seen_steps_of(pointed) not in exclude_steps:
        verification = verify_manifest(pointed)
        if verification.ok:
            return pointed
        logger.warning("resume pointer names an unverifiable checkpoint (%s): walking the ring for the newest "
                       "verifiable folder", verification.reason)
        record_event("rollback/pointer_target_corrupt", folder=str(pointed), reason=verification.reason)
    else:
        verification = ManifestVerification(False, "step burned by the degradation ladder")
        logger.warning("resume pointer target %s is burned by the degradation ladder: walking the ring for the "
                       "newest usable folder", pointed.name)
        record_event("rollback/pointer_target_burned", folder=str(pointed))

    ring_parent = pointed.parent if pointed.parent.is_dir() else info_path.parent
    candidates = sorted(
        (p for p in ring_parent.glob("eid_*-seen_steps_*")
         if p.is_dir() and p != pointed and _seen_steps_of(p) not in exclude_steps),
        key=_seen_steps_of,
        reverse=True,
    )
    for candidate in candidates:
        candidate_check = verify_manifest(candidate)
        if candidate_check.ok:
            logger.warning("falling back to verified checkpoint %s", candidate)
            record_event("rollback/fallback_folder", folder=str(candidate))
            return candidate
        logger.warning("skipping unverifiable checkpoint %s: %s", candidate, candidate_check.reason)
        record_event("rollback/candidate_corrupt", folder=str(candidate), reason=candidate_check.reason)
    raise FileNotFoundError(
        f"no verifiable checkpoint found: pointer target {pointed} failed "
        f"({verification.reason}) and no sibling under {ring_parent} verified"
    )

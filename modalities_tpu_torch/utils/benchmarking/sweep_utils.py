"""Benchmark sweep generation: the port's copy of
modalities_tpu/utils/benchmarking/sweep_utils.py.

A config with a ``sweep:`` block of lists is expanded cartesian-style into per-world-
size config directories; everything outside ``sweep:`` is copied verbatim, and
``${sweep.<key>}`` placeholders inside the template resolve per combination.
"""

from __future__ import annotations

import itertools
from pathlib import Path


class SweepGenerator:
    @staticmethod
    def generate_sweep_configs(sweep_config_path: Path, output_dir: Path) -> list[Path]:
        import yaml

        with open(sweep_config_path) as f:
            sweep_config = yaml.safe_load(f)
        if "sweep" not in sweep_config:
            raise ValueError("Sweep config must contain a top-level 'sweep:' block of lists.")
        sweep_block: dict = sweep_config.pop("sweep")
        keys = sorted(sweep_block)
        value_lists = [sweep_block[k] if isinstance(sweep_block[k], list) else [sweep_block[k]] for k in keys]

        written = []
        output_dir = Path(output_dir)
        for combo in itertools.product(*value_lists):
            assignment = dict(zip(keys, combo))
            resolved = _substitute(sweep_config, assignment)
            world_size = assignment.get("world_size", resolved.get("settings", {}).get("world_size", 0))
            combo_name = "__".join(f"{k}_{v}" for k, v in assignment.items())
            combo_dir = output_dir / f"world_size_{world_size}" / combo_name
            combo_dir.mkdir(parents=True, exist_ok=True)
            out_path = combo_dir / "config.yaml"
            with open(out_path, "w") as f:
                yaml.safe_dump(resolved, f, sort_keys=False)
            written.append(out_path)
        return written


def _substitute(node, assignment: dict):
    if isinstance(node, dict):
        return {k: _substitute(v, assignment) for k, v in node.items()}
    if isinstance(node, list):
        return [_substitute(v, assignment) for v in node]
    if isinstance(node, str):
        for key, value in assignment.items():
            placeholder = "${sweep." + key + "}"
            if node == placeholder:
                return value
            if placeholder in node:
                node = node.replace(placeholder, str(value))
        return node
    return node

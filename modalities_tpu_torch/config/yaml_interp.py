"""YAML loading with `${...}` interpolation: the port's copy of
modalities_tpu/config/yaml_interp.py (a self-contained omegaconf replacement).

The reference framework (src/modalities/config/config.py:528-582) loads configs with
omegaconf and relies on two interpolation forms:

* resolver calls:   ``${cuda_env:RANK}``, ``${modalities_env:experiment_id}``,
  ``${node_env:num_cpus}``, plus injectable resolvers (e.g. ``${warmstart_env:...}``)
* node references:  ``${settings.training.sequence_length}`` — absolute dot-paths into
  the same document.

This module implements the same surface natively: a tokenizer for ``${...}`` expressions (with nesting), a document resolver
with cycle detection, and a resolver registry passed per-call (no global mutable
registry — resolution is purely functional).
"""

from __future__ import annotations

import os
from pathlib import Path
from typing import Any, Callable, Optional


class ConfigError(Exception):
    """A config that cannot be resolved."""


Resolver = Callable[..., Any]

_MISSING = object()


def _find_interpolation(s: str) -> Optional[tuple[int, int]]:
    """Return (start, end) of the first top-level ``${...}`` span (handles nesting)."""
    start = s.find("${")
    if start == -1:
        return None
    depth = 0
    i = start
    while i < len(s):
        if s.startswith("${", i):
            depth += 1
            i += 2
            continue
        if s[i] == "}":
            depth -= 1
            if depth == 0:
                return start, i + 1
        i += 1
    raise ConfigError(f"Unterminated interpolation in: {s!r}")


def _split_top_level(s: str, sep: str) -> list[str]:
    """Split on `sep` ignoring separators inside nested ``${...}``."""
    parts: list[str] = []
    depth = 0
    current: list[str] = []
    i = 0
    while i < len(s):
        if s.startswith("${", i):
            depth += 1
            current.append(s[i : i + 2])
            i += 2
            continue
        ch = s[i]
        if ch == "}" and depth > 0:
            depth -= 1
        if ch == sep and depth == 0:
            parts.append("".join(current))
            current = []
        else:
            current.append(ch)
        i += 1
    parts.append("".join(current))
    return parts


def _parse_scalar(s: str) -> Any:
    """Interpret a resolver argument the way YAML would interpret a scalar."""
    import yaml

    try:
        return yaml.safe_load(s)
    except yaml.YAMLError:
        return s


class _DocumentResolver:
    def __init__(self, root: Any, resolvers: dict[str, Resolver]):
        self._root = root
        self._resolvers = resolvers
        self._in_progress: set[str] = set()  # cycle detection
        # memo: each absolute dot-path resolves exactly once, so multiple references to
        # the same node see one value even if a resolver is impure
        self._memo: dict[str, Any] = {}
        self.references: set[str] = set()  # every dot-path a node reference read

    def resolve(self) -> Any:
        return self._resolve_node(self._root, path="")

    def _resolve_node(self, node: Any, path: str) -> Any:
        if isinstance(node, dict):
            return {k: self._resolve_node(v, f"{path}.{k}" if path else str(k)) for k, v in node.items()}
        if isinstance(node, list):
            return [self._resolve_node(v, f"{path}[{i}]") for i, v in enumerate(node)]
        if isinstance(node, str):
            return self._resolve_string(node, path)
        return node

    def _resolve_string(self, s: str, path: str) -> Any:
        span = _find_interpolation(s)
        if span is None:
            return s
        start, end = span
        expr = s[start + 2 : end - 1]
        value = self._eval_expr(expr, path)
        if start == 0 and end == len(s):
            # whole-string interpolation keeps the native type
            return value
        rest = self._resolve_string(s[end:], path)
        rest_str = "" if rest is None else str(rest)
        return s[:start] + ("" if value is None else str(value)) + rest_str

    def _eval_expr(self, expr: str, path: str) -> Any:
        expr = expr.strip()
        head, *tail = _split_top_level(expr, ":")
        if tail:  # resolver call  name:arg1,arg2
            name = head.strip()
            if name not in self._resolvers:
                raise ConfigError(
                    f"Unknown resolver {name!r} in interpolation '${{{expr}}}' at {path or '<root>'}. "
                    f"Registered resolvers: {sorted(self._resolvers)}"
                )
            raw_args = ":".join(tail)
            args = [self._maybe_resolve_arg(a.strip(), path) for a in _split_top_level(raw_args, ",")] if raw_args else []
            return self._resolvers[name](*args)
        # node reference: absolute dot-path
        return self._lookup(head, path)

    def _maybe_resolve_arg(self, arg: str, path: str) -> Any:
        if "${" in arg:
            return self._resolve_string(arg, path)
        return _parse_scalar(arg)

    def _lookup(self, dot_path: str, from_path: str) -> Any:
        self.references.add(dot_path)
        if dot_path in self._memo:
            return self._memo[dot_path]
        if dot_path in self._in_progress:
            raise ConfigError(f"Circular interpolation detected at '{dot_path}' (referenced from {from_path})")
        # mark the full path in progress BEFORE walking: intermediate-node
        # resolution below can re-enter _lookup, and a cycle routed through an
        # intermediate interpolation (a: ${b.x}, b: ${a.x}) must surface as the
        # clean ConfigError, not a RecursionError
        self._in_progress.add(dot_path)
        try:
            node = self._walk(dot_path, from_path)
            value = self._resolve_node(node, dot_path)
        finally:
            self._in_progress.discard(dot_path)
        self._memo[dot_path] = value
        return value

    def _walk(self, dot_path: str, from_path: str) -> Any:
        node: Any = self._root
        walked: list[str] = []
        for key in dot_path.split("."):
            if isinstance(node, str) and _find_interpolation(node) is not None:
                # an intermediate node is itself an interpolation (e.g. warmstart's
                # `paths: ${warmstart_env:checkpoint_paths}` resolving to a dict) —
                # resolve it before indexing further (omegaconf does this natively)
                partial = ".".join(walked)
                if partial in self._in_progress:
                    raise ConfigError(
                        f"Circular interpolation detected at '{partial}' (referenced from {from_path})"
                    )
                self._in_progress.add(partial)
                try:
                    node = self._resolve_node(node, partial)
                finally:
                    self._in_progress.discard(partial)
            if isinstance(node, list):
                try:
                    node = node[int(key)]
                except (ValueError, IndexError):
                    raise ConfigError(f"Cannot resolve '${{{dot_path}}}' (bad list index {key!r}) at {from_path}")
            elif isinstance(node, dict):
                if key not in node:
                    raise ConfigError(f"Cannot resolve '${{{dot_path}}}': key {key!r} not found (from {from_path})")
                node = node[key]
            else:
                raise ConfigError(f"Cannot resolve '${{{dot_path}}}': {key!r} is not indexable (from {from_path})")
            walked.append(key)
        return node


def resolve_config_dict(config: Any, resolvers: Optional[dict[str, Resolver]] = None,
                        references: Optional[set[str]] = None) -> Any:
    """Resolve every ``${...}`` interpolation in a config structure. The
    dot-paths that node references read are added to `references` if given."""
    resolver = _DocumentResolver(config, resolvers or {})
    resolved = resolver.resolve()
    if references is not None:
        references.update(resolver.references)
    return resolved


def default_resolvers(
    config_file_path: Optional[Path] = None,
    experiments_root_path: Optional[Path] = None,
    experiment_id: Optional[str] = None,
) -> dict[str, Resolver]:
    """The built-in resolver set (reference: config.py:547-573).

    ``cuda_env`` and its alias ``dist_env`` read the launcher's environment; unset
    RANK/WORLD_SIZE/LOCAL_RANK mean a single process (0, 1, 0).
    """

    def dist_env(var_name: str) -> Any:
        if var_name in os.environ:
            int_vars = {"LOCAL_RANK", "WORLD_SIZE", "RANK"}
            return int(os.environ[var_name]) if var_name in int_vars else os.environ[var_name]
        if var_name in ("LOCAL_RANK", "RANK"):
            return 0
        if var_name == "WORLD_SIZE":
            return 1
        return os.getenv(var_name)

    env_kwargs: dict[str, Any] = {}
    if config_file_path is not None:
        env_kwargs["config_file_path"] = config_file_path
        env_kwargs["config_folder_path"] = config_file_path.parent
    if experiments_root_path is not None:
        env_kwargs["experiments_root_path"] = experiments_root_path
    if experiment_id is not None:
        env_kwargs["experiment_id"] = experiment_id

    def modalities_env(var_name: str) -> Any:
        if var_name in env_kwargs:
            return env_kwargs[var_name]
        raise ConfigError(f"Unknown modalities_env variable: {var_name}.")

    def node_env(var_name: str) -> Any:
        if var_name == "num_cpus":
            return os.cpu_count()
        return None

    return {
        "dist_env": dist_env,
        "cuda_env": dist_env,  # reference-config compatibility
        "modalities_env": modalities_env,
        "node_env": node_env,
    }


def load_app_config_dict(
    config_file_path: Path | str,
    experiments_root_path: Optional[Path] = None,
    experiment_id: Optional[str] = None,
    additional_resolver_funs: Optional[dict[str, Resolver]] = None,
    references: Optional[set[str]] = None,
) -> dict:
    """Load a YAML config file and resolve all interpolations.

    Mirrors the reference entry point (config.py:528) including injectable resolvers
    (warmstart injects ``${warmstart_env:...}``, __main__.py:152-163).
    """
    import yaml

    config_file_path = Path(config_file_path)
    with open(config_file_path) as f:
        raw = yaml.safe_load(f)
    resolvers = default_resolvers(
        config_file_path=config_file_path,
        experiments_root_path=experiments_root_path,
        experiment_id=experiment_id,
    )
    if additional_resolver_funs:
        resolvers.update(additional_resolver_funs)
    return resolve_config_dict(raw, resolvers, references)

"""Config schemas as dataclasses with explicit checks.

The JAX package validates its YAML component configs with pydantic models
(modalities_tpu/config/config.py). The port keeps the same rules — unknown keys
are refused, required keys must be present, values are type-checked — without
pydantic, which the GPU machines need not have. `validate_config` is what the
component factory calls for every component node.
"""

from __future__ import annotations

import dataclasses
from enum import Enum
from typing import Any, Optional


def validate_config(config_type, data: Any):
    """Instantiate the dataclass `config_type` from a config dict, refusing
    unknown and missing keys; field checks run in the class's __post_init__."""
    if not isinstance(data, dict):
        raise TypeError(f"{config_type.__name__}: expected a mapping, got {type(data).__name__}")
    fields = {f.name: f for f in dataclasses.fields(config_type)}
    unknown = sorted(k for k in data if k not in fields)
    if unknown:
        raise ValueError(
            f"Invalid keys {unknown} for config {config_type.__name__}; valid keys: {sorted(fields)}"
        )
    missing = [
        name
        for name, f in fields.items()
        if f.default is dataclasses.MISSING and f.default_factory is dataclasses.MISSING and name not in data
    ]
    if missing:
        raise ValueError(f"Missing required keys {missing} for config {config_type.__name__}")
    return config_type(**data)


def check_int(name: str, value, *, ge: Optional[int] = None, le: Optional[int] = None,
              optional: bool = False) -> Optional[int]:
    """Strict int (a bool or a float is refused), optionally bounded."""
    if value is None and optional:
        return None
    if isinstance(value, bool) or not isinstance(value, int):
        raise ValueError(f"{name}: expected an int, got {value!r}")
    if ge is not None and value < ge:
        raise ValueError(f"{name}: must be >= {ge}, got {value}")
    if le is not None and value > le:
        raise ValueError(f"{name}: must be <= {le}, got {value}")
    return value


def check_float(
    name: str, value, *, gt: Optional[float] = None, ge: Optional[float] = None, optional: bool = False
) -> Optional[float]:
    """A number; numeric strings are accepted because YAML 1.1 reads `1e-5`
    (no dot) as a string."""
    if value is None and optional:
        return None
    if isinstance(value, bool):
        raise ValueError(f"{name}: expected a number, got {value!r}")
    try:
        out = float(value)
    except (TypeError, ValueError):
        raise ValueError(f"{name}: expected a number, got {value!r}") from None
    if gt is not None and not out > gt:
        raise ValueError(f"{name}: must be > {gt}, got {out}")
    if ge is not None and not out >= ge:
        raise ValueError(f"{name}: must be >= {ge}, got {out}")
    return out


def check_bool(name: str, value, *, optional: bool = False) -> Optional[bool]:
    if value is None and optional:
        return None
    if not isinstance(value, bool):
        raise ValueError(f"{name}: expected a bool, got {value!r}")
    return value


def check_str(name: str, value, *, optional: bool = False) -> Optional[str]:
    if value is None and optional:
        return None
    if not isinstance(value, str):
        raise ValueError(f"{name}: expected a string, got {value!r}")
    return value


def check_choice(name: str, value, enum_type: type[Enum]) -> str:
    """The string value of an Enum member, given the member or its value."""
    if isinstance(value, enum_type):
        return value.value
    allowed = [m.value for m in enum_type]
    if value not in allowed:
        raise ValueError(f"{name}: expected one of {allowed}, got {value!r}")
    return value


def check_dict(name: str, value, *, optional: bool = False) -> Optional[dict]:
    if value is None and optional:
        return None
    if not isinstance(value, dict):
        raise ValueError(f"{name}: expected a mapping, got {value!r}")
    return value


@dataclasses.dataclass
class PreTrainedHFTokenizerConfig:
    pretrained_model_name_or_path: str
    truncation: Optional[bool] = False
    padding: Optional[bool | str] = False
    max_length: Optional[int] = None
    special_tokens: Optional[dict] = None

    def __post_init__(self):
        check_str("pretrained_model_name_or_path", self.pretrained_model_name_or_path)
        check_bool("truncation", self.truncation, optional=True)
        if not isinstance(self.padding, str):
            check_bool("padding", self.padding, optional=True)
        check_int("max_length", self.max_length, optional=True)
        check_dict("special_tokens", self.special_tokens, optional=True)

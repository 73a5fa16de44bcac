"""Experiment configs: dataclass ↔ YAML round trip and ``key=value``
overrides (port of ``sigsvgd_tpu/utils/config.py``). PyYAML is imported
inside the functions that need it (the card's machine may lack it)."""
from __future__ import annotations

import dataclasses
from pathlib import Path
from typing import Any, Dict, Type, TypeVar

T = TypeVar("T")


def to_dict(config: Any) -> Dict[str, Any]:
    return dataclasses.asdict(config)


def from_dict(cls: Type[T], data: Dict[str, Any]) -> T:
    field_names = {f.name for f in dataclasses.fields(cls)}
    unknown = set(data) - field_names
    if unknown:
        raise ValueError(f"Unknown config keys for {cls.__name__}: {sorted(unknown)}")
    return cls(**data)


def save_config(config: Any, path: str | Path) -> None:
    import yaml

    Path(path).parent.mkdir(parents=True, exist_ok=True)
    Path(path).write_text(yaml.safe_dump(to_dict(config)))


def load_config(cls: Type[T], path: str | Path) -> T:
    import yaml

    return from_dict(cls, yaml.safe_load(Path(path).read_text()) or {})


def apply_overrides(config: T, overrides: Dict[str, Any] | list) -> T:
    """Merge overrides into a dataclass config: a dict, or ``"key=value"``
    strings whose values parse as YAML scalars."""
    if isinstance(overrides, list):
        import yaml

        parsed = {}
        for item in overrides:
            key, _, val = item.partition("=")
            parsed[key.strip()] = yaml.safe_load(val)
        overrides = parsed
    return dataclasses.replace(config, **overrides)

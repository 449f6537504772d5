"""Configuration: a two-level attribute dict with ``section__key`` overrides.

The port's own copy of the JAX package's ``config.py`` (reference
`src/utils/config.py`). The bundled configs are JSON files under
``configs/`` carrying the values of the JAX package's YAML files, so no
YAML parser is needed to read them. ``dump_config`` writes JSON, or YAML
through PyYAML where it is installed.
"""

from __future__ import annotations

import copy
import json
import os
from typing import Any, Dict


class ConfigDict(dict):
    """A dict with attribute access, recursively applied."""

    def __getattr__(self, name: str) -> Any:
        try:
            return self[name]
        except KeyError as e:
            raise AttributeError(name) from e

    def __setattr__(self, name: str, value: Any) -> None:
        self[name] = value

    def __delattr__(self, name: str) -> None:
        try:
            del self[name]
        except KeyError as e:
            raise AttributeError(name) from e

    def __deepcopy__(self, memo):
        return ConfigDict({k: copy.deepcopy(v, memo) for k, v in self.items()})

    @classmethod
    def from_nested(cls, data: Dict[str, Any]) -> "ConfigDict":
        out = cls()
        for k, v in data.items():
            out[k] = cls.from_nested(v) if isinstance(v, dict) else v
        return out

    def to_dict(self) -> Dict[str, Any]:
        return {k: v.to_dict() if isinstance(v, ConfigDict) else v
                for k, v in self.items()}


def _cast_like(value: Any, reference: Any, strict: bool) -> Any:
    """Cast ``value`` to the type of ``reference`` (overrides take the
    configured value's type)."""
    if reference is None or value is None:
        return value
    ref_type = type(reference)
    if isinstance(value, ref_type) and not isinstance(value, bool):
        return value
    try:
        if ref_type is bool:
            if isinstance(value, str):
                return value.lower() in ("1", "true", "yes", "on")
            return bool(value)
        return ref_type(value)
    except (TypeError, ValueError):
        if strict:
            raise TypeError(f"cannot cast override {value!r} to {ref_type} "
                            f"(existing value {reference!r})")
        return value


def parse_config(path_or_dict, strict_cast: bool = True,
                 **overrides: Any) -> ConfigDict:
    """Load a JSON config (or take a dict) and apply overrides of the form
    ``section__key=value``, e.g. ``optimizer__learning_rate=1e-4``."""
    if isinstance(path_or_dict, dict):
        raw = copy.deepcopy(path_or_dict)
    else:
        with open(path_or_dict) as f:
            raw = json.load(f)
    config = ConfigDict.from_nested(raw or {})
    for flat_key, value in overrides.items():
        if "__" not in flat_key:
            raise ValueError(f"override key {flat_key!r} must be of the form "
                             "section__key")
        section, key = flat_key.split("__", 1)
        if section not in config:
            config[section] = ConfigDict()
        config[section][key] = _cast_like(value, config[section].get(key),
                                          strict_cast)
    return config


def dump_config(config: ConfigDict, path: str) -> None:
    """Serialize a config to .yaml or .json by extension. YAML goes through
    PyYAML's ``safe_dump``, imported here: it raises ``ImportError`` where
    PyYAML is absent."""
    data = config.to_dict()
    ext = os.path.splitext(path)[1]
    if ext not in (".yaml", ".yml", ".json"):
        raise ValueError(f"unsupported config extension: {ext}")
    with open(path, "w") as f:
        if ext == ".json":
            json.dump(data, f, indent=2, default=str)
        else:
            import yaml

            yaml.safe_dump(data, f)


def default_config_path(name: str) -> str:
    """Path of a bundled config, e.g. ``coco.json``."""
    return os.path.join(os.path.dirname(__file__), "configs", name)

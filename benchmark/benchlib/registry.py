"""Find every piece of a cell by name, as files under the benchmark's folder:

  workloads/<cell>.json     the cell: config, phase, chips, traffic, why,
                            per-layer metrics and the limits of its check
  configs/<config>.json     a configuration's sizes and port flags
  configs/<config>_flops.py its model operations a sample
  phases/<phase>.py         one round phase the cell drives
  metrics/<metric>.py       one reader per per-layer metric

A later cell, configuration, phase or metric is a new file; nothing here
changes. ``root`` is the benchmark's folder (a test points it at a copy).
"""

from __future__ import annotations

import importlib.util
import json
import os
import re
from types import ModuleType
from typing import Any, Dict

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


def _checked(name: str) -> str:
    if not _NAME.match(name) or ".." in name:
        raise ValueError(f"not a benchmark name: {name!r}")
    return name


def _path(root: str, kind: str, name: str, ext: str) -> str:
    path = os.path.join(root, kind, _checked(name) + ext)
    if not os.path.isfile(path):
        raise FileNotFoundError(f"no {kind[:-1]} named {name!r} ({path})")
    return path


def load_json(kind: str, name: str, root: str = ROOT) -> Dict[str, Any]:
    with open(_path(root, kind, name, ".json")) as f:
        return json.load(f)


def load_module(kind: str, name: str, root: str = ROOT) -> ModuleType:
    """``<root>/<kind>/<name>.py`` as a module of its own name
    (``bench_<kind>_<name>``), so that two folders' files never share one."""
    path = _path(root, kind, name, ".py")
    mod_name = f"bench_{kind}_{name}".replace(".", "_").replace("-", "_")
    spec = importlib.util.spec_from_file_location(mod_name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def merge(base: Dict, over: Dict) -> Dict:
    """``base`` with ``over``'s keys, nested groups merged key by key."""
    out = dict(base)
    for k, v in over.items():
        out[k] = (merge(out[k], v) if isinstance(v, dict)
                  and isinstance(out.get(k), dict) else v)
    return out


class Cell:
    """One cell and everything it names, loaded from ``root``. ``smoke``
    (the CPU tests) takes the limits set for the configuration's ``smoke``
    sizes (``smoke_limits``)."""

    def __init__(self, name: str, root: str = ROOT, smoke: bool = False):
        self.root = root
        self.name = name
        self.spec = load_json("workloads", name, root)
        self.config = load_json("configs", self.spec["config"], root)
        self.flops = load_module("configs", self.spec["config"] + "_flops",
                                 root)
        self.phase = load_module("phases", self.spec["phase"], root)
        self.metrics = {m: load_module("metrics", m, root)
                        for m in self.spec.get("metrics", [])}
        self.chips = int(self.spec.get("chips", 1))
        self.limits = dict(self.spec.get("limits", {}))
        if smoke:
            self.limits = dict(self.spec.get("smoke_limits", self.limits))

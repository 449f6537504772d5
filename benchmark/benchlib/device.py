"""The card a run measures: its presence, its name and its power limit."""

from __future__ import annotations

import subprocess
from typing import Any, Dict

import torch


class NoCard(RuntimeError):
    """The run asks for more cards than the machine shows."""


def require_cards(n: int) -> None:
    if not torch.cuda.is_available():
        raise NoCard("no CUDA device: this benchmark measures the card only")
    if torch.cuda.device_count() < n:
        raise NoCard(f"the cell needs {n} cards, the machine shows "
                     f"{torch.cuda.device_count()}")


def _smi(fields: str) -> str:
    """One ``nvidia-smi --query-gpu`` line for card 0; '' where the tool is
    missing or fails. The process is waited for."""
    try:
        out = subprocess.run(
            ["nvidia-smi", f"--query-gpu={fields}",
             "--format=csv,noheader,nounits", "-i", "0"],
            capture_output=True, text=True, timeout=20, check=False)
    except (OSError, subprocess.TimeoutExpired):
        return ""
    return out.stdout.strip().splitlines()[0] if out.stdout.strip() else ""


def describe(device: torch.device, count: int) -> Dict[str, Any]:
    """The result's ``device`` block, less the memory peak."""
    if device.type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": 1}
    info: Dict[str, Any] = {
        "platform": "gpu", "kind": torch.cuda.get_device_name(device),
        "count": count}
    parts = [p.strip() for p in _smi("power.limit,driver_version").split(",")]
    if len(parts) == 2:
        try:
            info["power_limit_w"] = float(parts[0])
        except ValueError:
            pass
        info["driver_version"] = parts[1]
    return info

"""Logging utilities.

The port's own copy of the JAX package's ``utils/logging.py``. Provides
the reference's logger surface (`src/utils/logger.py:87-139`):
``PythonLogger`` with ``.log()``, ``.report()`` and ``.log_dict()`` that emit
step-prefixed metric lines, optionally teeing to a file. In a process
group only rank 0 prints and writes its file; the other ranks' loggers are
silent.
"""

from __future__ import annotations

import logging
import sys
from typing import Any, Dict, Optional


def _build_logger(name: str, output_file: Optional[str]) -> logging.Logger:
    logger = logging.getLogger(name)
    logger.setLevel(logging.INFO)
    logger.propagate = False
    # Re-entrant construction (tests, notebooks): reset handlers.
    logger.handlers.clear()
    from creamfl_tpu_torch.parallel.mesh import is_main

    if not is_main():
        logger.addHandler(logging.NullHandler())
        return logger
    fmt = logging.Formatter("[%(asctime)s] %(message)s", datefmt="%H:%M:%S")
    sh = logging.StreamHandler(sys.stdout)
    sh.setFormatter(fmt)
    logger.addHandler(sh)
    if output_file:
        fh = logging.FileHandler(output_file)
        fh.setFormatter(fmt)
        logger.addHandler(fh)
    return logger


class PythonLogger:
    """Step-aware metric logger (reference `logger.py:87-139`)."""

    def __init__(self, name: str = "creamfl_tpu_torch",
                 output_file: Optional[str] = None):
        self._logger = _build_logger(name, output_file)

    def log(self, msg: str, level: int = logging.INFO) -> None:
        self._logger.log(level, msg)

    def report(self, step: int, metrics: Dict[str, Any],
               prefix: str = "") -> None:
        """One 'step N | k=v k=v ...' line per call."""
        parts = []
        for key, val in sorted(metrics.items()):
            if isinstance(val, float):
                parts.append(f"{prefix}{key}={val:.4f}")
            else:
                parts.append(f"{prefix}{key}={val}")
        self.log(f"step {step} | " + " ".join(parts))

    def log_dict(self, d: Dict[str, Any], prefix: str = "") -> None:
        for key, val in sorted(d.items()):
            self.log(f"{prefix}{key}: {val}")


class NoOpTracker:
    """wandb-compatible no-op tracker (used when wandb is off or absent).

    Mirrors the call surface used by the reference's MMFL
    (`MMFL.py:269-273`): ``.log(dict, step=...)``; also ``init``/``finish``.
    """

    def __init__(self):
        self.history = []

    def log(self, data: Dict[str, Any], step: Optional[int] = None) -> None:
        self.history.append((step, dict(data)))

    def init(self, **kwargs) -> "NoOpTracker":
        return self

    def finish(self) -> None:
        pass


def get_tracker(name: str = "creamfl_tpu_torch", enabled: bool = True):
    """Return a wandb run if wandb is importable & enabled, else NoOpTracker."""
    if enabled:
        try:
            import wandb  # type: ignore

            return wandb.init(project="CreamFL-TPU", name=name, config={})
        except Exception:
            pass
    return NoOpTracker()

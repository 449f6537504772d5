"""Round checkpoints and ``--resume``.

Port of the JAX package's ``utils/checkpoint.py`` (``RoundCheckpointer``):
the same layout, ``<directory>/round_{n:05d}/``, the last ``keep`` rounds
kept, and ``restore`` of the latest round (None when there is none). The
payload (``MMFL.save_round``) is the server's and every client's
``EngineState.state_dict`` and a ``meta`` dict; it goes through
``torch.save`` with every tensor on the host (no Orbax), and ``restore``
loads it onto ``map_location``. A round is written into a temporary
directory and renamed into place, so a run killed while saving leaves the
previous rounds whole. In a process group only rank 0 writes (the JAX
package's ``process_index() == 0``); every rank restores from the same
files.
"""

from __future__ import annotations

import os
import shutil
from typing import Any, Dict, List, Optional

import torch

from creamfl_tpu_torch.parallel.mesh import is_main
from creamfl_tpu_torch.utils.serialize import to_host

_STATE = "state.pt"


class RoundCheckpointer:
    """Per-round federated checkpoints with keep-last-k retention."""

    def __init__(self, directory: str, keep: int = 3, map_location=None):
        self.directory = os.path.abspath(directory)
        os.makedirs(self.directory, exist_ok=True)
        self.keep = keep
        self.map_location = map_location

    def _path(self, round_n: int) -> str:
        return os.path.join(self.directory, f"round_{round_n:05d}")

    def save(self, round_n: int, payload: Dict[str, Any]) -> str:
        """payload: {'server': ..., 'clients': [...], 'meta': {...}} of
        state dicts and plain values. Writes nothing on a rank other than
        0; returns the round's path on every rank."""
        path = self._path(round_n)
        if not is_main():
            return path
        tmp = os.path.join(self.directory, f".round_{round_n:05d}.tmp")
        shutil.rmtree(tmp, ignore_errors=True)
        os.makedirs(tmp)
        torch.save(to_host(payload), os.path.join(tmp, _STATE))
        shutil.rmtree(path, ignore_errors=True)
        os.replace(tmp, path)
        rounds = self.list_rounds()
        for r in rounds[:max(0, len(rounds) - self.keep)]:
            shutil.rmtree(self._path(r), ignore_errors=True)
        return path

    def list_rounds(self) -> List[int]:
        out = []
        for name in os.listdir(self.directory):
            if name.startswith("round_"):
                try:
                    out.append(int(name.split("_")[1]))
                except ValueError:
                    pass
        return sorted(out)

    def latest_round(self) -> Optional[int]:
        rounds = self.list_rounds()
        return rounds[-1] if rounds else None

    def restore(self, round_n: Optional[int] = None
                ) -> Optional[Dict[str, Any]]:
        """Round ``round_n``'s payload (default: the latest), its tensors
        on ``map_location``, with ``meta['round']`` set; None when no
        round is saved."""
        if round_n is None:
            round_n = self.latest_round()
            if round_n is None:
                return None
        restored = torch.load(os.path.join(self._path(round_n), _STATE),
                              map_location=self.map_location,
                              weights_only=True)
        restored.setdefault("meta", {})["round"] = round_n
        return restored

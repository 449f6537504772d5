"""Captured CUDA graphs of the server's chunked steps.

A server step on the card is mostly host time: some thousand small
launches of the forward and the backward. ``GraphCache``
captures a chunk of k steps once per (step kind, k, input shapes and
dtypes, static flags) and replays it: one launch from the host for k
steps. The JAX package reaches the same end with ``lax.scan`` under
``jit`` (``engine/server.py`` ``*_chunk``).

How a chunk is captured (``GraphCache.run`` on a new key), as PyTorch's
documentation prescribes for whole-network capture:

1. static input buffers on the device, shaped like the chunk's inputs;
2. a warm-up run of the body on a side stream, so that lazy state (cuBLAS
   and cuDNN handles and workspaces, the kernels' one-time attributes)
   exists before capture; the optimizer's state is made first
   (``AdamP.init_state``), and every tensor the body changes (parameters,
   buffers, optimizer state) and the card's generator state are saved
   before the warm-up and put back after it, so the warm-up leaves no
   trace;
3. capture under ``torch.cuda.graph`` into the graph's own memory pool.
   Gradients, the zero gradients of unused parameters and every
   temporary are allocated from that pool. The kernels' tensor maps
   (K5/K6 on the fused trunk) hold addresses in it, which stay valid as
   long as the graph lives.

Each call copies the inputs into the static buffers, replays, and returns
copies of the outputs. A graph holds the addresses of the state's tensors:
where they changed (a state dict loaded into the optimizer, a new
optimizer), the chunk is captured again. Dropout draws from the card's
generator: a replay advances its offset as the k eager steps would, so a
replay after ``torch.manual_seed(s)`` draws what the eager steps draw
after it.

Launch counts: a kernel wrapper counts a launch when its Python code runs,
which is once, at capture. The cache takes the counts of the capture off
(and those of the warm-up), and adds them again at every replay: a
captured launch counts once per replay.

A capture is a ``creamfl.graph.capture`` span and counts in the recorder's
``graph.captures``, a replay in ``graph.replays`` (``utils/profiling.py``).

``clear`` drops the graphs and their pools (``ServerEngine.release_graphs``
at the end of a round).
"""

from __future__ import annotations

import copy
import dataclasses
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import torch

from creamfl_tpu_torch.ops import launch_wrappers
from creamfl_tpu_torch.utils import profiling

# Attributes of the kernel wrappers that count launches.
_COUNTERS = ("launches", "launches_by_route", "launches_by_rows")


def _read_counts() -> Dict[Tuple[Any, str], Any]:
    """Every launch counter of the kernel wrappers (copies)."""
    return {(fn, attr): copy.copy(getattr(fn, attr))
            for fn in launch_wrappers() for attr in _COUNTERS
            if hasattr(fn, attr)}


def _delta(after, before):
    if isinstance(after, dict):
        return {k: v - before.get(k, 0) for k, v in after.items()
                if v != before.get(k, 0)}
    return after - before


def _add(fn, attr: str, delta) -> None:
    if isinstance(delta, dict):
        counts = getattr(fn, attr)
        for k, v in delta.items():
            counts[k] = counts.get(k, 0) + v
    else:
        setattr(fn, attr, getattr(fn, attr) + delta)


def _state_tensors(state) -> List[torch.Tensor]:
    """The tensors a train, distill or extract step changes in place, and
    the optimizer's tensor hyperparameters (AdamP's lr) it reads."""
    mods = [state.model] + ([state.criterion] if state.criterion is not None
                            else [])
    out = [t for m in mods for t in (*m.parameters(), *m.buffers())]
    for st in state.optimizer.state.values():
        out += [v for v in st.values() if isinstance(v, torch.Tensor)]
    out += [g["lr"] for g in state.optimizer.param_groups
            if isinstance(g["lr"], torch.Tensor)]
    return out


@dataclasses.dataclass
class _Entry:
    graph: torch.cuda.CUDAGraph
    inputs: List[Optional[torch.Tensor]]
    outputs: Tuple[torch.Tensor, ...]
    counts: Dict[Tuple[Any, str], Any]
    # Addresses of the state's tensors at capture: a graph reads and
    # writes them there.
    addresses: Tuple[int, ...]


class GraphCache:
    """Captured graphs of one engine's chunks on ``device``."""

    def __init__(self, device: torch.device):
        self.device = device
        self._entries: Dict[Any, _Entry] = {}
        self.captures = 0
        self.replays = 0

    def clear(self) -> None:
        self._entries.clear()

    def run(self, key, state, inputs: Sequence[Optional[torch.Tensor]],
            body: Callable[..., Tuple[torch.Tensor, ...]]
            ) -> Tuple[torch.Tensor, ...]:
        """``body(*static inputs)`` (device tensors in, a tuple of tensors
        out) by one replay of its graph for ``key``, captured on the first
        call; ``state`` is the engine state the body changes. Returns
        copies of the outputs."""
        entry = self._entries.get(key)
        if entry is not None and entry.addresses != _addresses(state):
            # The state's tensors were replaced (a state dict loaded, a new
            # optimizer): the graph would read freed memory.
            entry = None
        if entry is None:
            with profiling.span("creamfl.graph.capture"):
                entry = self._entries[key] = self._capture(state, inputs,
                                                           body)
            profiling.count("graph.captures")
        for buf, x in zip(entry.inputs, inputs):
            if buf is not None:
                buf.copy_(x, non_blocking=True)
        entry.graph.replay()
        self.replays += 1
        profiling.count("graph.replays")
        for (fn, attr), delta in entry.counts.items():
            _add(fn, attr, delta)
        return tuple(o.clone() for o in entry.outputs)

    def _capture(self, state, inputs, body) -> _Entry:
        dev = self.device
        static = [None if x is None else torch.empty(
            x.shape, dtype=x.dtype, device=dev) for x in inputs]
        for buf, x in zip(static, inputs):
            if buf is not None:
                buf.copy_(x)
        if hasattr(state.optimizer, "init_state"):
            state.optimizer.init_state()
        counts0 = _read_counts()
        tensors = _state_tensors(state)
        saved = [t.detach().clone() for t in tensors]
        rng = torch.cuda.get_rng_state(dev)
        main = torch.cuda.current_stream(dev)
        side = torch.cuda.Stream(dev)
        side.wait_stream(main)
        with torch.cuda.stream(side):
            body(*static)
        main.wait_stream(side)
        with torch.no_grad():
            for t, s in zip(tensors, saved):
                t.copy_(s)
        del saved
        torch.cuda.set_rng_state(rng, dev)
        graph = torch.cuda.CUDAGraph()
        before = _read_counts()
        with torch.cuda.graph(graph, capture_error_mode="thread_local"):
            outputs = body(*static)
        after = _read_counts()
        counts = {k: _delta(after[k], before[k]) for k in after}
        for (fn, attr), value in counts0.items():
            if isinstance(value, dict):  # in place: callers hold the dict
                getattr(fn, attr).clear()
                getattr(fn, attr).update(value)
            else:
                setattr(fn, attr, value)
        self.captures += 1
        return _Entry(graph, static, outputs,
                      {k: v for k, v in counts.items() if v},
                      _addresses(state))


def _addresses(state) -> Tuple[int, ...]:
    return tuple(t.data_ptr() for t in _state_tensors(state))

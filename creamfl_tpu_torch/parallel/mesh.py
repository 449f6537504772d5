"""The mesh of ranks: one process per card on ``torch.distributed``.

Port of the JAX package's ``parallel/mesh.py``. The JAX mesh is one
process driving several devices; PyTorch's idiom is one process per card,
so here every rank runs the same host program (the same seeds, loaders
and sampled clients) and the collectives below stand where XLA inserted
its own. What a JAX layout means, rank by rank:

* server training, distillation and eval (``shard_batch(mesh, "all")``):
  each rank runs a contiguous block of a batch's rows (``shard_rows``);
  the outputs are gathered in rank order (``all_gather_rows``), so that a
  loss sees the whole batch and every rank computes the same one; the
  model's gradients are summed (``all_reduce_grads``) and BatchNorm takes
  its statistics over the whole batch (``models/resnet.py:BatchNorm``).
  Each step is the step on the whole batch, as XLA partitions it, not
  DDP's per-rank mean. A batch whose rows do not divide runs whole on
  every rank (the JAX round replicates it);
* client local training (``P("client")`` on a family's stacked axis):
  members go to ranks in contiguous blocks (``client_slots``); a rank
  trains its own, and afterwards every member's state is broadcast from
  its owner (``broadcast_state``), so every rank holds every client as
  the JAX package's global arrays do;
* con_w: per-client diagonals where the client's uploads live, then a
  sum over ranks of the weighted uploads (``federation/aggregation.py``).

The backend is whatever process group is initialized: NCCL between cards,
gloo on the CPU (and for ranks sharing one card). A collective that gloo
does not run on CUDA tensors (all but ``all_reduce`` and ``broadcast``)
goes through the host, and only then; NCCL never gives way to gloo.
"""

from __future__ import annotations

import contextlib
import dataclasses
import os
from typing import Dict, Iterable, List, Optional, Sequence

import torch
import torch.distributed as dist

# Collectives that gloo runs on CUDA tensors itself.
_GLOO_CUDA = frozenset({"all_reduce", "broadcast"})
# (rows of the whole batch, this rank's slice of them) while a rank runs its
# rows of a batch (``batch_rows``); None otherwise.
_BATCH_ROWS: Optional[tuple] = None


@dataclasses.dataclass(eq=False)
class Mesh:
    """This process's place in the mesh: ``world`` ranks, this one
    ``rank``, its ``device``, and the process group (None: the default
    group)."""

    world: int
    rank: int
    device: torch.device
    group: Optional[dist.ProcessGroup] = None

    @property
    def backend(self) -> str:
        return str(dist.get_backend(self.group)) if _live(self) else ""


def init_distributed(init_method: Optional[str] = None,
                     world: Optional[int] = None,
                     rank: Optional[int] = None,
                     device=None, backend: Optional[str] = None) -> Mesh:
    """Join a process group and return this rank's ``Mesh``.

    Pass all of (init_method, world, rank), as the JAX function takes
    (coordinator, num_processes, process_id); or none of them, and the
    group already initialized is joined, else one from torchrun's
    environment (``RANK``, ``WORLD_SIZE``, ``MASTER_ADDR``), else none
    (world 1). ``device``: the rank's device; a CUDA device without an
    index takes the card ``LOCAL_RANK`` names. ``backend``: NCCL for CUDA
    and gloo for the CPU unless given (gloo lets ranks share one card)."""
    explicit = (init_method, world, rank)
    if any(a is not None for a in explicit) and any(a is None
                                                    for a in explicit):
        raise ValueError("init_distributed needs init_method, world AND "
                         f"rank together; got {explicit!r}")
    device = torch.device(device if device is not None else "cpu")
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0)))
    if device.type == "cuda":
        torch.cuda.set_device(device)
    if not dist.is_initialized():
        backend = backend or ("nccl" if device.type == "cuda" else "gloo")
        if init_method is not None:
            dist.init_process_group(backend, init_method=init_method,
                                    world_size=world, rank=rank)
        elif "RANK" in os.environ and "WORLD_SIZE" in os.environ:
            dist.init_process_group(backend, init_method="env://")
    return make_mesh(device)


def make_mesh(device, group: Optional[dist.ProcessGroup] = None) -> Mesh:
    """The ``Mesh`` of the initialized process group (world 1 without
    one)."""
    device = torch.device(device)
    if not dist.is_initialized():
        return Mesh(1, 0, device, None)
    return Mesh(dist.get_world_size(group), dist.get_rank(group), device,
                group)


def is_main() -> bool:
    """True on rank 0, and in a process outside any group: the rank that
    writes logs, checkpoints and saved models."""
    return not dist.is_initialized() or dist.get_rank() == 0


def active(mesh: Optional[Mesh]) -> bool:
    """Whether ``mesh`` spans more than this rank."""
    return mesh is not None and mesh.world > 1


def _live(mesh: Optional[Mesh]) -> bool:
    """Whether the collectives run: a mesh in an initialized group, world 1
    included (where each is its identity)."""
    return mesh is not None and dist.is_initialized()


def sharded(mesh: Optional[Mesh], n: int) -> bool:
    """Whether a batch of ``n`` rows splits over the mesh."""
    return active(mesh) and n % mesh.world == 0


def shard_rows(mesh: Optional[Mesh], n: int) -> slice:
    """This rank's contiguous rows of a batch of ``n``: the whole batch when
    ``n`` does not divide by the world (the JAX round replicates such a
    batch, ``_to_mesh_dp``)."""
    if not sharded(mesh, n):
        return slice(0, n)
    per = n // mesh.world
    return slice(mesh.rank * per, (mesh.rank + 1) * per)


@contextlib.contextmanager
def batch_rows(n: int, rows: slice):
    """While it is open, this rank runs ``rows`` of a batch of ``n``: a
    draw that covers the batch (``row_dropout``) is made for all ``n`` rows
    and cut to this rank's, as XLA draws one key's numbers for a sharded
    array."""
    global _BATCH_ROWS
    outer, _BATCH_ROWS = _BATCH_ROWS, (n, rows)
    try:
        yield
    finally:
        _BATCH_ROWS = outer


def row_dropout(x: torch.Tensor, p: float) -> torch.Tensor:
    """Inverted dropout of ``x`` ([rows, ...]) at rate ``p`` whose keep mask
    is drawn for the whole batch (``batch_rows``) and cut to this rank's
    rows: every rank draws the same numbers from the same generator state,
    so a rank's rows get the masks they get at world 1."""
    n, rows = _BATCH_ROWS or (x.shape[0], slice(0, x.shape[0]))
    keep = torch.rand((n,) + tuple(x.shape[1:]), device=x.device)[rows]
    return x * ((keep >= p).to(x.dtype) / (1.0 - p))


def client_slots(mesh: Optional[Mesh], n_members: int) -> List[int]:
    """The rank that owns each of a family's members: contiguous blocks of
    ceil(n / world), as ``P("client")`` lays out a stacked axis padded to a
    multiple of the world (a rank past the members owns none)."""
    world = mesh.world if active(mesh) else 1
    per = -(-n_members // world)
    return [i // per for i in range(n_members)]


# ---------------------------------------------------------------------------
# collectives
# ---------------------------------------------------------------------------

def _via_host(mesh: Mesh, op: str, t: torch.Tensor) -> bool:
    return t.is_cuda and mesh.backend == "gloo" and op not in _GLOO_CUDA


def _in_place(mesh: Mesh, op: str, t: torch.Tensor, run) -> torch.Tensor:
    """``run(t)`` for an in-place collective, through a host copy where
    gloo does not take ``t`` as it is; returns ``t``."""
    if _via_host(mesh, op, t):
        host = t.cpu()
        run(host)
        t.copy_(host)
    else:
        run(t)
    return t


def all_reduce_sum(mesh: Mesh, t: torch.Tensor) -> torch.Tensor:
    """Sum ``t`` over the ranks, in place; returns it."""
    if _live(mesh):
        _in_place(mesh, "all_reduce", t,
                  lambda x: dist.all_reduce(x, group=mesh.group))
    return t


def broadcast(mesh: Mesh, t: torch.Tensor, src: int) -> torch.Tensor:
    """``t`` of rank ``src`` on every rank, in place; returns it."""
    if _live(mesh):
        _in_place(mesh, "broadcast", t,
                  lambda x: dist.broadcast(x, src=src, group=mesh.group))
    return t


def _gather_cat(mesh: Mesh, x: torch.Tensor) -> torch.Tensor:
    """Every rank's ``x`` (one shape on all) concatenated in rank order."""
    src = x.detach().contiguous()
    host = _via_host(mesh, "all_gather", src)
    if host:
        src = src.cpu()
    parts = [torch.empty_like(src) for _ in range(mesh.world)]
    dist.all_gather(parts, src, group=mesh.group)
    out = torch.cat(parts)
    return out.to(x.device) if host else out


class _GatherRows(torch.autograd.Function):
    """Forward: the ranks' rows concatenated in rank order. Backward: this
    rank's slice of the incoming gradient. Every rank computes the same
    loss from the gathered rows, so that slice is the gradient of this
    rank's rows: no sum and no division."""

    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh, ctx.rows = mesh, x.shape[0]
        return _gather_cat(mesh, x)

    @staticmethod
    def backward(ctx, grad):
        r, n = ctx.mesh.rank, ctx.rows
        return grad[r * n:(r + 1) * n], None


def all_gather_rows(mesh: Optional[Mesh], x: torch.Tensor) -> torch.Tensor:
    """[n, ...] on each rank -> [world * n, ...], rank 0's rows first;
    differentiable (``_GatherRows``). The identity at world 1."""
    if not _live(mesh):
        return x
    return _GatherRows.apply(x, mesh)


def gather_ragged(mesh: Optional[Mesh], x: torch.Tensor) -> torch.Tensor:
    """Rows of unequal counts (one dim on all ranks) concatenated in rank
    order; no gradient."""
    if not _live(mesh):
        return x
    n = torch.tensor([x.shape[0]], device=x.device)
    counts = _gather_cat(mesh, n).tolist()
    top = max(counts)
    padded = x.new_zeros((top,) + tuple(x.shape[1:]))
    padded[:x.shape[0]] = x
    full = _gather_cat(mesh, padded)
    return torch.cat([full[r * top:r * top + c]
                      for r, c in enumerate(counts)])


def _flat(mesh: Mesh, tensors: Sequence[torch.Tensor], apply) -> None:
    """``apply`` on one flat buffer per dtype, on the rank's device, holding
    ``tensors``; the results copied back into them."""
    by_dtype: Dict[torch.dtype, List[torch.Tensor]] = {}
    for t in tensors:
        by_dtype.setdefault(t.dtype, []).append(t)
    for group in by_dtype.values():
        flat = torch.cat([t.reshape(-1).to(mesh.device) for t in group])
        apply(flat)
        offset = 0
        for t in group:
            n = t.numel()
            t.copy_(flat[offset:offset + n].view_as(t))
            offset += n


def all_reduce_grads(mesh: Optional[Mesh],
                     params: Iterable[torch.nn.Parameter]) -> None:
    """Sum the parameters' gradients over the ranks: one flat buffer per
    call (per dtype), not one collective per parameter. Every parameter
    must have a gradient."""
    if _live(mesh):
        _flat(mesh, [p.grad for p in params],
              lambda flat: all_reduce_sum(mesh, flat))


def broadcast_tensors(mesh: Optional[Mesh], tensors: Sequence[torch.Tensor],
                      src: int) -> None:
    """Rank ``src``'s values of ``tensors`` on every rank, in place, one
    flat buffer per dtype."""
    if _live(mesh) and tensors:
        _flat(mesh, list(tensors), lambda flat: broadcast(mesh, flat, src))


def broadcast_object(mesh: Optional[Mesh], obj, src: int):
    """A picklable object of rank ``src`` on every rank."""
    if not _live(mesh):
        return obj
    box = [obj]
    dist.broadcast_object_list(
        box, src=src, group=mesh.group,
        device=mesh.device if mesh.backend == "nccl" else None)
    return box[0]


@dataclasses.dataclass(frozen=True)
class _Slot:
    """A tensor's place in a broadcast structure: its index in the tensor
    list, shape, dtype and whether it lives on the card."""

    index: int
    shape: tuple
    dtype: torch.dtype
    cuda: bool


def _split_tensors(tree, out: List[torch.Tensor]):
    """``tree`` with each tensor replaced by its ``_Slot`` in ``out``."""
    if isinstance(tree, torch.Tensor):
        out.append(tree)
        return _Slot(len(out) - 1, tuple(tree.shape), tree.dtype,
                     tree.is_cuda)
    if isinstance(tree, dict):
        return {k: _split_tensors(v, out) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_split_tensors(v, out) for v in tree)
    return tree


def _join_tensors(tree, tensors: List[torch.Tensor]):
    if isinstance(tree, _Slot):
        return tensors[tree.index]
    if isinstance(tree, dict):
        return {k: _join_tensors(v, tensors) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_join_tensors(v, tensors) for v in tree)
    return tree


def _slots(tree) -> List[_Slot]:
    if isinstance(tree, _Slot):
        return [tree]
    if isinstance(tree, dict):
        tree = list(tree.values())
    if isinstance(tree, (list, tuple)):
        return [s for v in tree for s in _slots(v)]
    return []


def broadcast_state(mesh: Optional[Mesh], obj, src: int) -> None:
    """Rank ``src``'s state of ``obj`` on every rank, in place: a module's
    parameters and buffers; an optimizer's state (its structure first, as
    an object, since a rank that never stepped holds none); an
    ``EngineState``'s model, criterion, optimizer and step."""
    if not _live(mesh):
        return
    if isinstance(obj, torch.nn.Module):
        broadcast_tensors(mesh, [t.data for t in obj.state_dict().values()],
                          src)
        return
    if isinstance(obj, torch.optim.Optimizer):
        tensors: List[torch.Tensor] = []
        skeleton = (_split_tensors(obj.state_dict(), tensors)
                    if mesh.rank == src else None)
        skeleton = broadcast_object(mesh, skeleton, src)
        if mesh.rank != src:
            slots = sorted(_slots(skeleton), key=lambda x: x.index)
            tensors = [torch.empty(x.shape, dtype=x.dtype,
                                   device=mesh.device if x.cuda else "cpu")
                       for x in slots]
        broadcast_tensors(mesh, tensors, src)
        if mesh.rank != src:
            obj.load_state_dict(_join_tensors(skeleton, tensors))
        return
    broadcast_state(mesh, obj.model, src)
    if obj.criterion is not None:
        broadcast_state(mesh, obj.criterion, src)
    broadcast_state(mesh, obj.optimizer, src)
    obj.step = broadcast_object(mesh, obj.step, src)


def barrier(mesh: Optional[Mesh]) -> None:
    if _live(mesh):
        dist.barrier(group=mesh.group)

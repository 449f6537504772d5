"""A client family's local epochs and uploads, its members side by side.

Port of the JAX package's ``federation/stacked.py``: the lowering the JAX
package picks without a mesh ("scan", ``_lowering_for``), where each
member's step stays a plain per-client program, is a Python loop over the
members here. On a mesh (its "vmap" lowering over the ``client`` axis) the
round gives each rank its own members (``parallel/mesh.py:client_slots``)
and calls these functions with those alone; a rank with none still
advances the shared public loader as one pass would (``skip_epoch``), so
that its later families see the batches the other ranks see. Clients of one
family share an architecture and see the same public batches, so:

- ``contrast_epoch`` walks the shared public loader once for the whole
  family: per batch, every member's forward (and its frozen pre-round
  model's), then each of the family's gallery CEs as ONE segmented K3
  launch over all members' feature rows (the JAX package's K3 under
  ``jax.vmap`` over the client axis), each member's loss, one backward of
  their sum and each member's optimizer step. A member's loss depends on
  its own parameters only, so each gets the gradient it gets alone.
- ``uni_reps`` / ``mm_reps`` walk the public eval loader once for the
  family, every member's features per batch.

Both render each public batch once per family, not once per member.

``task_epoch`` runs each member's epoch on its own loader, one member after
the other. The JAX package advances them in lock-step and keeps exhausted
members frozen with a masked select (``_select_state``) on pad slots;
nothing here needs either, so there are no pad slots: ``--stack_bucket``
(``stack_pad``) only bounds XLA recompiles in the JAX package, and the
port reports its pad count and runs none. ``SCAN_CHUNK`` and
``_stack_chunk`` amortise XLA dispatch and have no counterpart for the
clients; their math is the per-batch math here. ``_chunks`` and
``_uniform_batches`` cut the server's sweeps into chunks
(``federation/rounds.py``, ``engine/evaluator.py``). Nor has
``parallel/client_parallel.py``: each
client keeps its own ``EngineState``, and ``stack_states`` /
``unstack_states`` existed to build one stacked pytree for a jitted
program.

A family of one is the sequential branch (``--no_client_parallel``): its
gallery CE has one segment, which is the unsegmented K3 call.
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

from creamfl_tpu_torch.data.loaders import suffix_valid
from creamfl_tpu_torch.losses.contrast import inter_modal_loss


def _uniform_batches(group) -> bool:
    """True iff every batch in the group has the same leading dim: the
    bare ragged last batch of a public loader takes the per-batch step
    even inside a full chunk."""
    def rows(b):
        for v in b.values():
            if hasattr(v, "shape") and getattr(v, "ndim", 0) >= 1:
                return v.shape[0]
        return None

    first = rows(group[0])
    return all(rows(b) == first for b in group[1:])


def _chunks(iterable, k: int):
    """Lists of k consecutive items (the last one shorter)."""
    buf = []
    for x in iterable:
        buf.append(x)
        if len(buf) == k:
            yield buf
            buf = []
    if buf:
        yield buf


def stack_pad(n_members: int, policy: str) -> int:
    """Pad slots the JAX package adds to a family of ``n_members`` on one
    device under ``--stack_bucket`` (its ``MMFL._group_sharding``):
    ``even`` rounds a family of two or more up to an even size, ``pow2``
    up to a power of two, ``none`` adds none."""
    if policy == "even" and n_members > 1:
        return (-n_members) % 2
    if policy == "pow2":
        return (1 << max(0, (n_members - 1).bit_length())) - n_members
    return 0


def task_epoch(engine, members: Sequence, mm: bool) -> None:
    """One local task epoch of each member on its own loader (reference
    ClientTrainer.py:322-367, MMClientTrainer.py:112-142)."""
    step = engine.local_step if mm else engine.task_step
    for client in members:
        for batch in client.train_loader:
            step(client.state, batch)


def contrast_batch(engine, states: Sequence, old_models: Sequence, batch,
                   globals_: Dict[str, torch.Tensor], do_inter: bool,
                   do_intra: bool) -> List[torch.Tensor]:
    """One public batch's contrast step of every member (ClientTrainer.py:
    369-510): the engine's ``contrast_terms`` per member, each gallery CE
    as one K3 call with a segment per member, ``contrast_loss`` per member,
    one backward of their sum and ``contrast_update`` per member.
    ``globals_`` holds the global feature matrices ``contrast_terms``
    reads and ``index``, the batch's rows in them. Returns each member's
    loss, detached. The engines' ``contrast_step`` is this with one
    member."""
    n = len(states)
    terms = [engine.contrast_terms(s, old, batch, globals_, do_inter,
                                   do_intra)
             for s, old in zip(states, old_models)]
    inter: List[List[torch.Tensor]] = [[] for _ in states]
    for k, (_, gallery) in enumerate(terms[0].inter):
        losses = inter_modal_loss(
            torch.cat([t.inter[k][0] for t in terms]), gallery,
            terms[0].index.repeat(n), engine.tau, segments=n).reshape(n)
        for i in range(n):
            inter[i].append(losses[i])
    member_losses = [engine.contrast_loss(t, member_inter)
                     for t, member_inter in zip(terms, inter)]
    total = member_losses[0]
    for loss in member_losses[1:]:
        total = total + loss
    total.backward()
    for s in states:
        engine.contrast_update(s)
    return [loss.detach() for loss in member_losses]


def contrast_epoch(engine, members: Sequence, old_models: Sequence,
                   pub_loader, globals_: Dict[str, torch.Tensor],
                   batch_rows, do_inter: bool, do_intra: bool) -> None:
    """One public-set contrast epoch of the family: ``contrast_batch`` per
    batch of the shared loader; ``batch_rows(batch)`` gives a batch's rows
    in the global features."""
    if not members:
        pub_loader.skip_epoch()
        return
    states = [c.state for c in members]
    for batch in pub_loader:
        contrast_batch(engine, states, old_models, batch,
                       dict(globals_, index=batch_rows(batch)), do_inter,
                       do_intra)


def uni_reps(engine, members: Sequence, pub_loader
             ) -> Tuple[List[torch.Tensor], np.ndarray]:
    """Each member's [N, d] train-mode features over the public eval
    loader (its BN running-stat updates persist, ClientTrainer.py:552),
    and the dataset index of each of the N rows (None without members)."""
    if not members:
        pub_loader.skip_epoch()
        return [], None
    parts: List[List[torch.Tensor]] = [[] for _ in members]
    idx_parts = []
    for batch in pub_loader:
        valid = np.asarray(batch["valid"])
        n_valid = suffix_valid(valid)
        for client, part in zip(members, parts):
            feats, _ = engine.features_step(client.state, batch)
            part.append(feats[:n_valid])
        idx_parts.append(np.asarray(batch["index"])[valid])
    return [torch.cat(p) for p in parts], np.concatenate(idx_parts)


def mm_reps(engine, members: Sequence, pub_loader
            ) -> Tuple[List[torch.Tensor], List[torch.Tensor]]:
    """Each member's eval-mode [N, d] image and caption features over the
    public eval loader."""
    if not members:
        pub_loader.skip_epoch()
        return [], []
    img_parts: List[List[torch.Tensor]] = [[] for _ in members]
    txt_parts: List[List[torch.Tensor]] = [[] for _ in members]
    for batch in pub_loader:
        n_valid = suffix_valid(np.asarray(batch["valid"]))
        for client, img, txt in zip(members, img_parts, txt_parts):
            fi, ft = engine.features_step(client.state, batch)
            img.append(fi[:n_valid])
            txt.append(ft[:n_valid])
    return ([torch.cat(p) for p in img_parts],
            [torch.cat(p) for p in txt_parts])

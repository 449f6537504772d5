"""Unimodal client engine, image modality (CIFAR image clients).

Reference: `src/algorithms/ClientTrainer.py:136-674`. Per federated round
a selected client runs:
  1. task epochs: margin-softmax CE + 0.5 x weight-orthogonality loss,
     SGD(momentum 0.9, wd 5e-5), with the head-weight ReLU clamp
     persisted each step;
  2. public-set contrast epochs: inter-modal CE against the frozen
     other-modality global features + MOON intra contrast against the
     frozen pre-round model;
  3. the representation upload: a feature pass over the public set.

BatchNorm follows the reference's modes: task, contrast and feature
steps run train-mode BN whose running-stat updates persist; the MOON old
model and the local test run eval-mode BN. Steps update the state's
model and optimizer in place and return the state.

Text clients (GRU) come with a later slice.
"""

from __future__ import annotations

import copy
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from creamfl_tpu_torch.engine.state import EngineState
from creamfl_tpu_torch.losses.classification import (margin_softmax_loss,
                                                     weight_orthogonality_loss)
from creamfl_tpu_torch.losses.contrast import (combine_inter_intra,
                                               inter_modal_loss,
                                               intra_modal_moon_loss)
from creamfl_tpu_torch.models.clients import (ImageClientNet,
                                              clamp_head_weights)
from creamfl_tpu_torch.models.resnet import init_parameters
from creamfl_tpu_torch.optim.factory import (make_client_sgd,
                                             set_learning_rate,
                                             two_step_decay_schedule)
from creamfl_tpu_torch.utils.device import resolve_device

Batch = Dict[str, torch.Tensor]


class UniClientEngine:
    """One engine per client family; clients differ only in their
    EngineState."""

    def __init__(self, modality: str, num_class: int, args,
                 device="cuda"):
        if modality != "img":
            raise NotImplementedError(
                f"{modality!r} clients are not ported yet; only 'img'")
        self.modality = modality
        self.args = args
        self.device = resolve_device(device)
        # The reference builds resnet18_client whatever --img_model_local
        # says (ClientTrainer.py:278); the smaller trunks are test scale.
        self.cnn_type = (args.img_model_local
                         if args.img_model_local in ("resnet6", "resnet10",
                                                     "resnet18")
                         else "resnet18")
        self.num_class = num_class
        self.init_lr = 1e-4
        self.lr_schedule = two_step_decay_schedule(self.init_lr,
                                                   total_rounds=30)
        self.margin = 4.0  # inter_distance (MMFL.py:135)
        self.tau = 0.5

    def _tensor(self, x, dtype=None) -> torch.Tensor:
        return torch.as_tensor(x, dtype=dtype, device=self.device)

    def init_state(self, seed: int = 0,
                   state_dict: Optional[Dict[str, torch.Tensor]] = None
                   ) -> EngineState:
        """A fresh client: weights drawn from ``seed`` (or loaded from
        ``state_dict``), and SGD at the first round's learning rate."""
        model = ImageClientNet(self.cnn_type, num_class=self.num_class,
                               embed_dim=self.args.feature_dim, scale=128.0,
                               mlp_local=self.args.mlp_local)
        init_parameters(model, torch.Generator().manual_seed(seed))
        if state_dict is not None:
            model.load_state_dict(state_dict)
        model = model.to(self.device)
        if self.device.type == "cuda":
            model = model.to(memory_format=torch.channels_last)
        return EngineState(model=model, step=0, optimizer=make_client_sgd(
            model.parameters(), self.init_lr))

    def set_round_lr(self, state: EngineState, round_n: int) -> EngineState:
        set_learning_rate(state.optimizer, self.lr_schedule(round_n))
        return state

    @staticmethod
    def snapshot(state: EngineState) -> torch.nn.Module:
        """The frozen pre-round copy for MOON (the reference deep-copies
        the model at round start, ClientTrainer.py:195); eval mode."""
        old = copy.deepcopy(state.model).eval()
        old.requires_grad_(False)
        return old

    # -- steps ---------------------------------------------------------
    def task_step(self, state: EngineState, batch: Batch
                  ) -> Tuple[EngineState, Dict[str, torch.Tensor]]:
        """Margin CE + 0.5 * orthogonality, with the persistent head clamp
        applied before the forward."""
        model, opt = state.model, state.optimizer
        images = self._tensor(batch["images"], torch.float32)
        labels = self._tensor(batch["labels"], torch.long)
        valid = batch.get("valid")
        valid = None if valid is None else self._tensor(valid)
        model.train()
        clamp_head_weights(model)
        opt.zero_grad(set_to_none=True)
        x1, _x2, w1, _w2 = model(images, phase="train")
        task = margin_softmax_loss(x1, labels, self.margin, valid=valid)
        # The center loss flows through relu(W) (ClientTrainer.py:350), so
        # its gradient is masked where the clamped weight is 0.
        center = weight_orthogonality_loss(F.relu(w1))
        loss = task + 0.5 * center
        loss.backward()
        opt.step()
        state.step += 1
        with torch.no_grad():
            # top-1/top-5 on the margin-adjusted logits
            # (ClientTrainer.py:352-358).
            adj = x1 - self.margin * F.one_hot(labels, x1.shape[-1])
            top5 = adj.topk(min(5, adj.shape[-1]), dim=-1).indices
            w = (torch.ones_like(labels, dtype=torch.float32)
                 if valid is None else valid.float())
            denom = torch.clamp(w.sum(), min=1.0)
            c1 = ((top5[:, 0] == labels).float() * w).sum() / denom
            c5 = ((top5 == labels[:, None]).any(dim=1).float()
                  * w).sum() / denom
        return state, {"loss": loss.detach(), "top1": c1 * 100,
                       "top5": c5 * 100}

    def contrast_step(self, state: EngineState, old_model: torch.nn.Module,
                      batch: Batch, globals_: Dict[str, torch.Tensor],
                      do_inter: bool, do_intra: bool
                      ) -> Tuple[EngineState, torch.Tensor]:
        """Public-set regularisation (ClientTrainer.py:369-510).

        globals_: {'same': [N, d] same-modality global features,
                   'other': [N, d] other-modality global features,
                   'index': [B] rows of this batch in the public set}.
        The heads are not in the features-phase graph, so their grads
        stay None and SGD leaves them and their momentum untouched.
        """
        if not (do_inter or do_intra):
            raise ValueError("contrast_step needs do_inter or do_intra")
        model, opt = state.model, state.optimizer
        images = self._tensor(batch["images"], torch.float32)
        d_idx = self._tensor(globals_["index"], torch.long)
        model.train()
        opt.zero_grad(set_to_none=True)
        feats = model(images, phase="features")
        losses = {}
        if do_inter:
            losses["inter"] = inter_modal_loss(feats, globals_["other"],
                                               d_idx, self.tau)
        if do_intra:
            target = globals_["same"].index_select(0, d_idx)
            with torch.no_grad():
                old_feats = old_model(images, phase="features")
            losses["intra"] = intra_modal_moon_loss(feats, target,
                                                    old_feats, self.tau)
        if do_inter and do_intra:
            loss = combine_inter_intra(losses["intra"], losses["inter"],
                                       self.args.interintra_weight,
                                       self.args.loss_scale)
        else:
            loss = sum(losses.values())
        loss.backward()
        opt.step()
        state.step += 1
        return state, loss.detach()

    @torch.no_grad()
    def features_step(self, state: EngineState, batch: Batch
                      ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """Representation upload pass -> (features, BN running stats).

        The reference leaves the model in train() mode here
        (ClientTrainer.py:552), so BN normalises with batch statistics
        and the running-stat update persists; it lands in the state's
        model in place, and the returned dict holds those buffers."""
        model = state.model
        model.train()
        feats = model(self._tensor(batch["images"], torch.float32),
                      phase="features")
        return feats, {k: v for k, v in model.named_buffers()
                       if "running_" in k}

    @torch.no_grad()
    def test_step(self, state: EngineState, batch: Batch
                  ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """Eval-mode top-1/top-k counts on the local test set
        (ClientTrainer.py:512-552), on ReLU-clamped heads that do not
        persist: (correct1, correctk, count)."""
        model = state.model
        model.eval()
        clamped = {f"{h}.weight": F.relu(getattr(model, h).weight)
                   for h in ("class_fc", "class_fc_2")}
        images = self._tensor(batch["images"], torch.float32)
        x1 = torch.func.functional_call(model, clamped, (images,),
                                        {"phase": "train"})[0]
        labels = self._tensor(batch["labels"], torch.long)
        topk = x1.topk(min(5, x1.shape[-1]), dim=-1).indices
        valid = batch.get("valid")
        valid = (torch.ones_like(labels, dtype=torch.float32)
                 if valid is None else self._tensor(valid).float())
        correct1 = (topk[:, 0] == labels).float()
        correctk = (topk == labels[:, None]).any(dim=1).float()
        return ((correct1 * valid).sum(), (correctk * valid).sum(),
                valid.sum())

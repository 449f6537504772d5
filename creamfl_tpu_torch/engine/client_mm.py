"""Multimodal (Flickr30k) client engine.

Port of the JAX package's ``engine/client_mm.py`` (reference
`src/algorithms/MMClientTrainer.py:89-359`, `src/algorithms/base.py:62-230`):
PCME with a ResNet-18 trunk and the GRU text branch (``configs/f30k.json``;
bf16 trunk compute under ``use_bf16``), the MCSoft criterion, AdamP with
the model's gradients clipped to global norm 2 and a cosine schedule that
the reference never steps.

Per round: ``local_step`` (MCSoft over the client's shard, pairs touching a
repeat-padded row masked by ``valid``), then public-set ``contrast_step``:
the intra term is one 2-way CE over the image rows stacked on the caption
rows (MMClientTrainer.py:184-191) against the frozen pre-round model in
eval mode, the inter term two gallery CEs on the fused gallery kernel.
The criterion's scalars are not in the contrast graph: their gradients
stay None and AdamP skips them, as torch's optimizers skip such
parameters (the JAX engine restores them, ``restore_frozen``). Then the
eval-mode ``features_step`` uploads both modalities.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from creamfl_tpu_torch.engine.state import EngineState, frozen_copy
from creamfl_tpu_torch.federation.stacked import contrast_batch
from creamfl_tpu_torch.losses.classification import cross_entropy
from creamfl_tpu_torch.losses.contrast import ContrastTerms, contrast_loss
from creamfl_tpu_torch.losses.mcsoft import (MCSoftContrastiveConfig,
                                             MCSoftCriterion)
from creamfl_tpu_torch.models.pcme import PCME, init_pcme
from creamfl_tpu_torch.optim.factory import (clip_grad_global_norm,
                                             make_server_optimizer)
from creamfl_tpu_torch.utils.device import resolve_device

Batch = Dict[str, torch.Tensor]


class MMClientEngine:
    def __init__(self, config, vocab_size: int, args,
                 mlp_local: bool = False, device="cuda"):
        model_cfg = config.model
        self.args = args
        self.device = resolve_device(device)
        self.vocab_size = vocab_size
        self.mlp_local = mlp_local
        self.embed_dim = model_cfg.embed_dim
        self.cnn_type = model_cfg.get("cnn_type", "resnet18")
        self.word_dim = model_cfg.get("word_dim", 300)
        self.dtype = (torch.bfloat16 if config.train.get("use_bf16", False)
                      else torch.float32)
        self.criterion_config = MCSoftContrastiveConfig(
            init_shift=float(config.criterion.get("init_shift", 15)),
            init_negative_scale=float(
                config.criterion.get("init_negative_scale", 15)))
        self.learning_rate = float(config.optimizer.learning_rate)
        self.weight_decay = float(config.optimizer.get("weight_decay", 0.0))
        self.t_max = int(config.lr_scheduler.get("T_max", 30))
        self.grad_clip = float(config.train.get("grad_clip", 2.0))
        self.tau = 0.5

    def init_state(self, seed: int = 0,
                   state_dict: Optional[Dict[str, torch.Tensor]] = None
                   ) -> EngineState:
        """PCME r18 + GRU with weights drawn from ``seed`` (or loaded from
        ``state_dict``, keys ``model.*`` and ``criterion.*``), the
        criterion, and AdamP at the configured learning rate."""
        model = PCME(embed_dim=self.embed_dim, cnn_type=self.cnn_type,
                     vocab_size=self.vocab_size, word_dim=self.word_dim,
                     not_bert=True, mlp_local=self.mlp_local,
                     dtype=self.dtype)
        init_pcme(model, torch.Generator().manual_seed(seed))
        criterion = MCSoftCriterion(self.criterion_config)
        if state_dict is not None:
            for prefix, module in (("model.", model),
                                   ("criterion.", criterion)):
                module.load_state_dict({k[len(prefix):]: v
                                        for k, v in state_dict.items()
                                        if k.startswith(prefix)})
        model.to(self.device)
        criterion.to(self.device)
        if self.device.type == "cuda":
            model.img_enc.cnn.to(memory_format=torch.channels_last)
        optimizer, _ = make_server_optimizer(
            model.parameters(), criterion.parameters(), self.learning_rate,
            self.t_max, self.weight_decay)
        return EngineState(model=model, optimizer=optimizer,
                           criterion=criterion)

    def set_round_lr(self, state: EngineState, round_n: int) -> EngineState:
        """A no-op, kept for the round's uniform client interface. Parity
        quirk: the reference builds a cosine scheduler for mm clients but
        never steps it (MMClientTrainer has no lr_scheduler.step), so the
        learning rate stays at its initial value in every round."""
        return state

    @staticmethod
    def snapshot(state: EngineState) -> torch.nn.Module:
        """The frozen pre-round model for the intra term, in eval mode."""
        return frozen_copy(state.model)

    def _forward(self, model: torch.nn.Module, batch: Batch
                 ) -> Dict[str, torch.Tensor]:
        dev = self.device
        return model(torch.as_tensor(batch["images"], dtype=torch.float32,
                                     device=dev),
                     torch.as_tensor(batch["captions"], dtype=torch.long,
                                     device=dev),
                     torch.as_tensor(batch["lengths"]))

    def _update(self, state: EngineState) -> None:
        clip_grad_global_norm(state.model.parameters(), self.grad_clip)
        state.optimizer.step()
        state.step += 1

    # -- steps ---------------------------------------------------------
    def local_step(self, state: EngineState, batch: Batch
                   ) -> Tuple[EngineState, Dict[str, torch.Tensor]]:
        """One MCSoft step on the client's shard."""
        valid = batch.get("valid")
        valid = (None if valid is None
                 else torch.as_tensor(valid, device=self.device))
        state.model.train()
        state.optimizer.zero_grad(set_to_none=True)
        out = self._forward(state.model, batch)
        loss, ldict = state.criterion(out["image_features"],
                                      out["caption_features"], valid=valid)
        loss.backward()
        self._update(state)
        return state, {k: v.detach() for k, v in ldict.items()}

    def contrast_step(self, state: EngineState, old_model: torch.nn.Module,
                      batch: Batch, globals_: Dict[str, torch.Tensor],
                      do_inter: bool, do_intra: bool
                      ) -> Tuple[EngineState, torch.Tensor]:
        """globals_: {'img': [N, d], 'txt': [N, d] global features,
        'index': [B] rows of this batch in the public set}.
        ``federation.stacked.contrast_batch`` of one member, as
        ``UniClientEngine.contrast_step``."""
        (loss,) = contrast_batch(self, [state], [old_model], batch, globals_,
                                 do_inter, do_intra)
        return state, loss

    def contrast_terms(self, state: EngineState, old_model: torch.nn.Module,
                       batch: Batch, globals_: Dict[str, torch.Tensor],
                       do_inter: bool, do_intra: bool) -> ContrastTerms:
        """The contrast step's forward with the gradients cleared: two
        gallery CEs (image rows against the text gallery, caption rows
        against the image gallery) and the intra term."""
        if not (do_inter or do_intra):
            raise ValueError("contrast_step needs do_inter or do_intra")
        d_idx = torch.as_tensor(globals_["index"], dtype=torch.long,
                                device=self.device)
        state.model.train()
        state.optimizer.zero_grad(set_to_none=True)
        out = self._forward(state.model, batch)
        f_img = out["image_features"].float()
        f_txt = out["caption_features"].float()
        terms = ContrastTerms(
            inter=([(f_img, globals_["txt"]), (f_txt, globals_["img"])]
                   if do_inter else []), index=d_idx)
        if do_intra:
            with torch.no_grad():
                old = self._forward(old_model, batch)
            tgt_img = globals_["img"].index_select(0, d_idx)
            tgt_txt = globals_["txt"].index_select(0, d_idx)
            pos = torch.cat([(f_img * tgt_img).sum(-1),
                             (f_txt * tgt_txt).sum(-1)])
            neg = torch.cat([(f_img * old["image_features"].float()).sum(-1),
                             (f_txt * old["caption_features"].float()
                              ).sum(-1)])
            logits = torch.stack([pos, neg], dim=1) / self.tau
            terms.intra = cross_entropy(logits, torch.zeros(
                logits.shape[0], dtype=torch.long, device=self.device))
        return terms

    def contrast_loss(self, terms: ContrastTerms, inter_losses
                      ) -> torch.Tensor:
        return contrast_loss(inter_losses, terms.intra,
                             self.args.interintra_weight,
                             self.args.loss_scale)

    def contrast_update(self, state: EngineState) -> None:
        """The clipped AdamP step after the contrast loss's backward."""
        self._update(state)

    @torch.no_grad()
    def features_step(self, state: EngineState, batch: Batch
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Eval-mode representation upload (MMClientTrainer.generate_logits
        calls .eval(), unlike the unimodal path): (img, txt) features."""
        state.model.eval()
        out = self._forward(state.model, batch)
        return out["image_features"], out["caption_features"]

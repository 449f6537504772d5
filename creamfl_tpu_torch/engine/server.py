"""Server engine: global PCME training, feature extraction, distillation.

Port of the JAX package's ``engine/server.py`` (reference
`src/algorithms/retrieval_trainer.py:37-238` and the distill pass of
`MMFL.distill`, `MMFL.py:343-391`):

* ``train_step``: PCME forward, MCSoft criterion, the model's gradients
  clipped to global norm 2 (the criterion's scalars excluded), AdamP;
* ``extract_step``: a feature pass in TRAIN mode under ``no_grad`` -- the
  reference leaves the model in train() mode there, so BatchNorm uses the
  batch stats and its running-stat updates persist, and dropout is on
  (`MMFL.py:194-221`);
* ``distill_step``: ``kd_weight`` * MSE against the con_w aggregate rows
  ``rows``; the mm-client term counts both modalities a second time, as
  the reference does (`MMFL.py:371-378`);
* ``eval_step``: eval-mode forward;
* ``extract_chunk``, ``eval_chunk``, ``train_chunk``, ``distill_chunk``:
  k stacked batches as k steps, on the card one CUDA graph replay
  (``chunk_route``);
* ``load_pretrained``: torchvision ResNet, HF BERT and GloVe weights from
  local files; ``save_models`` / ``load_models``: the engine bundle that
  ``engine.pretrain.RawTrainer`` writes.

On a mesh of ranks (``mesh``; ``parallel/mesh.py``) each step is the step
on the whole batch, as XLA partitions the JAX package's: each rank runs its
rows (``shard_rows``) with BatchNorm's statistics over all of them, the
features are gathered in rank order, so that the MCSoft loss pairs every
image with every caption of the batch and the distill MSE is the mean over
the whole batch, and the model's gradients are summed over the ranks
before ``clip_grad_global_norm`` (the criterion's are whole on every rank
already). A batch whose rows do not divide by the ranks runs whole on
every rank, BatchNorm on its own rows, and its gradients are rank 0's
(broadcast, so that no rank's update differs by a nondeterministic
kernel). The chunks run eagerly there, per batch.

Each step is traced in the recorder's ``creamfl.engine.*`` spans
(``utils/profiling.py``): ``stage``, ``forward``, ``loss``, ``backward`` and
``update`` (the zero gradients, the mesh's reduction, the clip and AdamP);
the updates count in ``engine.steps`` and their rows in ``engine.rows``.

The text tower is BERT, the GRU branch (``not_bert``), or, where
``bert_config`` is a decoder tower's config (``models/towers.py``:
DeepSeek-V2-Lite, Granite-4.0-H-Small), that tower: its balance loss is
added to the loss of every step that back-propagates through it (train
and distill), the tokens and token-expert pairs its MoE layers routed
count in ``moe.tokens`` and ``moe.pairs``, and the tokens through its
Mamba mixers in ``mamba.tokens``. It runs off a mesh only.

bf16 as in the JAX package: trunk and BERT compute in bf16 (autocast inside
the encoders), params, heads and the criterion in fp32. The fused trunk is
reached through the model's own field: replace ``self.model`` by
``PCME(..., fused_bn=True)`` before ``init_state``. Every parameter the
optimizer holds is updated each step, a zero gradient standing in for an
unused one, as in the JAX package's optax update.
"""

from __future__ import annotations

import contextlib
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from creamfl_tpu_torch.engine.graphs import GraphCache
from creamfl_tpu_torch.engine.state import EngineState
from creamfl_tpu_torch.losses.mcsoft import (MCSoftContrastiveConfig,
                                             MCSoftCriterion)
from creamfl_tpu_torch.models import convert
from creamfl_tpu_torch.models.bert import BertConfig
from creamfl_tpu_torch.models.pcme import PCME, init_pcme
from creamfl_tpu_torch.models.resnet import set_batchnorm_mesh
from creamfl_tpu_torch.models.towers import name_of, tower_of
from creamfl_tpu_torch.optim.factory import (clip_grad_global_norm,
                                             cosine_annealing_schedule,
                                             make_server_optimizer,
                                             set_learning_rate)
from creamfl_tpu_torch.parallel import mesh as M
from creamfl_tpu_torch.utils import profiling
from creamfl_tpu_torch.utils.device import resolve_device
from creamfl_tpu_torch.utils.helper import save_checkpoint
from creamfl_tpu_torch.utils.serialize import flatten_dict

StateDict = Dict[str, torch.Tensor]


class ServerEngine:
    def __init__(self, config, vocab_size: int, mlp_local: bool = False,
                 bert_config: Optional[BertConfig] = None,
                 use_bf16: Optional[bool] = None, device="cuda",
                 mesh: Optional[M.Mesh] = None):
        """``mesh``: the ranks that share each batch (None or world 1: this
        process alone). ``bert_config``: the text tower's config, a
        ``BertConfig`` or a decoder tower's (``models/towers.py``; unused
        on the GRU branch)."""
        model_cfg = config.model
        if use_bf16 is None:
            use_bf16 = bool(config.train.get("use_bf16", False))
        self.config = config
        self.device = resolve_device(device)
        self.model = PCME(
            embed_dim=model_cfg.embed_dim,
            cnn_type=model_cfg.cnn_type,
            vocab_size=vocab_size,
            word_dim=model_cfg.get("word_dim", 300),
            not_bert=bool(model_cfg.get("not_bert", True)),
            mlp_local=mlp_local,
            bert_config=bert_config or BertConfig(),
            dtype=torch.bfloat16 if use_bf16 else torch.float32,
        )
        crit_cfg = config.criterion
        self.criterion_config = MCSoftContrastiveConfig(
            init_shift=float(crit_cfg.get("init_shift", 15)),
            init_negative_scale=float(crit_cfg.get("init_negative_scale",
                                                   15)),
            uniform_lambda=float(crit_cfg.get("uniform_lambda", 0)),
            vib_beta=float(crit_cfg.get("vib_beta", 0)),
        )
        opt_cfg = config.optimizer
        self.learning_rate = float(opt_cfg.learning_rate)
        self.weight_decay = float(opt_cfg.get("weight_decay", 0.0))
        self.t_max = int(config.lr_scheduler.get("T_max", 30))
        self.grad_clip = float(config.train.get("grad_clip", 2.0))
        self.lr_schedule = cosine_annealing_schedule(self.learning_rate,
                                                     self.t_max)
        self.kd_weight = 0.3  # overridden by federation from CLI args
        self.graphs = GraphCache(self.device)
        self.mesh = mesh if M.active(mesh) else None
        # The text tower (``models/towers.py``): a decoder's (MoE layers,
        # experts per token) and Mamba mixers.
        text = self.model.bert_config
        tower = None if self.model.not_bert else tower_of(text)
        self.decoder = tower is not None and tower.decoder
        self.moe = tower.moe(text) if tower else None
        self.mixers = tower.mixers(text) if tower else 0
        if self.decoder and self.mesh is not None:
            raise ValueError(f"the {name_of(text)} text tower runs on one "
                             f"device: start the run with --no_mesh")

    # -- state ---------------------------------------------------------
    def init_state(self, seed: int = 0,
                   state_dict: Optional[StateDict] = None) -> EngineState:
        """``self.model`` with weights drawn from ``seed`` (or loaded from
        ``state_dict``, keys ``model.*`` and ``criterion.*`` as
        ``state_dict_of`` writes them), the criterion, and AdamP."""
        model = self.model
        init_pcme(model, torch.Generator().manual_seed(seed))
        criterion = MCSoftCriterion(self.criterion_config)
        if state_dict is not None:
            for prefix, module in (("model.", model),
                                   ("criterion.", criterion)):
                module.load_state_dict({k[len(prefix):]: v
                                        for k, v in state_dict.items()
                                        if k.startswith(prefix)})
        set_batchnorm_mesh(model, self.mesh)
        model.to(self.device)
        criterion.to(self.device)
        if self.device.type == "cuda":
            model.img_enc.cnn.to(memory_format=torch.channels_last)
        optimizer, _ = make_server_optimizer(
            model.parameters(), criterion.parameters(), self.learning_rate,
            self.t_max, self.weight_decay)
        return EngineState(model=model, optimizer=optimizer,
                           criterion=criterion)

    @staticmethod
    def state_dict_of(state: EngineState) -> StateDict:
        """Copies of the model's and the criterion's tensors, keyed
        ``model.*`` and ``criterion.*`` (``init_state`` takes them)."""
        out = {f"model.{k}": v.detach().clone()
               for k, v in state.model.state_dict().items()}
        out.update({f"criterion.{k}": v.detach().clone()
                    for k, v in state.criterion.state_dict().items()})
        return out

    def set_round_lr(self, state: EngineState, round_n: int) -> EngineState:
        set_learning_rate(state.optimizer, self.lr_schedule(round_n))
        return state

    @torch.no_grad()
    def load_pretrained(self, state: EngineState,
                        resnet_path: Optional[str] = None,
                        bert_path: Optional[str] = None,
                        glove_path: Optional[str] = None,
                        vocab=None) -> EngineState:
        """Copy pretrained weights into the state's model, in place: a
        torchvision ResNet state dict into the image trunk (its ``fc.*``
        dropped), an HF BERT state dict (with or without its ``bert.``
        prefix) into the BERT text encoder, a GloVe text file into the GRU
        branch's word embedding (misses keep their initial rows). The
        reference downloads all three; here they are local files."""
        model = state.model
        if resnet_path:
            model.img_enc.cnn.load_state_dict(
                convert.load_torchvision_trunk(resnet_path))
        if bert_path and not model.not_bert:
            if self.decoder:
                raise ValueError(
                    f"--bert_ckpt loads BERT weights; the text tower is "
                    f"{name_of(model.bert_config)}")
            model.txt_enc.bert.load_hf_state_dict(
                convert.load_state_dict(bert_path))
        if glove_path and model.not_bert and vocab is not None:
            embed = model.txt_enc.embed.weight
            mat, _ = convert.load_glove_embeddings(
                glove_path, vocab, embed.shape[1],
                init=embed.detach().cpu().numpy())
            embed.copy_(torch.from_numpy(mat))
        return state

    def save_models(self, path: str, state: EngineState,
                    metadata: Optional[Dict] = None) -> str:
        """The engine bundle (reference retrieval_trainer.py:137-149):
        model, criterion, optimizer and step, with ``metadata``."""
        return save_checkpoint(path, dict(state.state_dict(),
                                          metadata=metadata or {}))

    def load_models(self, path: str, state: EngineState) -> EngineState:
        """Restore a ``save_models`` bundle into ``state`` in place, the
        optimizer's moments included."""
        state.load_state_dict(torch.load(path, map_location=self.device,
                                         weights_only=True))
        return state

    def text_inputs(self, batch: Dict[str, Any]):
        """(captions, lengths, bert_mask) of a loader batch: the GRU
        branch reads the caption ids (mask None), the BERT branch the
        WordPiece ids and their mask."""
        if self.model.not_bert:
            return batch["captions"], batch["lengths"], None
        mask = np.asarray(batch["bert_mask"])
        return batch["bert_ids"], mask.sum(-1, dtype=np.int32), mask

    def report_scores(self, step: int, scores: Dict, metadata=None,
                      prefix: str = "", logger=None) -> Dict:
        """Flattened metric report (reference retrieval_trainer.py:216-237
        key format: ``{split}__{section}_{metric}``)."""
        report = {}
        for data_key, sub in scores.items():
            if isinstance(sub, dict):
                report.update({f"{prefix}{data_key}__{k}": v
                               for k, v in flatten_dict(sub).items()})
            else:
                report[f"{prefix}{data_key}"] = sub
        if metadata:
            report.update({f"{prefix}meta_{k}": v
                           for k, v in metadata.items()})
        if logger is not None:
            logger.report(step, report)
        return report

    # -- steps ---------------------------------------------------------
    # Each step is host staging (``stage``: loader arrays onto the device)
    # and a compute on device tensors alone (``_train``, ``_distill``,
    # ``_features``), which a CUDA graph can hold (``engine/graphs.py``).
    def stage(self, images, captions, lengths, bert_mask=None):
        """(images, captions, lengths, bert_mask) of a batch, or of a chunk
        of k stacked batches, as the compute takes them: float32 images,
        int64 ids and the mask on the engine's device; ``lengths`` stay on
        the host (the GRU branch packs with host lengths, the BERT branch
        reads the mask)."""
        dev = self.device
        with profiling.span("creamfl.engine.stage"):
            return (torch.as_tensor(images, dtype=torch.float32, device=dev),
                    torch.as_tensor(captions, dtype=torch.long, device=dev),
                    torch.as_tensor(lengths),
                    None if bert_mask is None
                    else torch.as_tensor(bert_mask, device=dev))

    def _update(self, state: EngineState, n_rows: int) -> None:
        """Clip the model's gradients, then AdamP over model and
        criterion; an unused parameter gets a zero gradient. On a mesh the
        model's gradients of a batch of ``n_rows`` split over the ranks are
        summed over them first; those of a batch run whole on every rank
        are rank 0's."""
        with profiling.span("creamfl.engine.update"):
            for group in state.optimizer.param_groups:
                for p in group["params"]:
                    if p.grad is None:
                        p.grad = torch.zeros_like(p)
            if M.sharded(self.mesh, n_rows):
                M.all_reduce_grads(self.mesh, state.model.parameters())
            elif self.mesh is not None:
                M.broadcast_tensors(self.mesh, [
                    p.grad for g in state.optimizer.param_groups
                    for p in g["params"]], src=0)
            clip_grad_global_norm(state.model.parameters(), self.grad_clip)
            state.optimizer.step()

    def _forward(self, state: EngineState, images, captions, lengths,
                 bert_mask) -> Tuple[torch.Tensor, torch.Tensor,
                                     Optional[torch.Tensor]]:
        """(image features, caption features, the text tower's balance loss
        or None) of the whole batch: on a mesh this rank's rows through the
        model, then every rank's gathered in rank order (a batch that does
        not split runs whole, BatchNorm on this rank's rows alone)."""
        n = images.shape[0]
        with profiling.span("creamfl.engine.forward"):
            if not M.sharded(self.mesh, n):
                with self._local_batchnorm():
                    out = state.model(images, captions, lengths, bert_mask)
                return (out["image_features"], out["caption_features"],
                        out.get("aux_loss"))
            rows = M.shard_rows(self.mesh, n)
            with M.batch_rows(n, rows):
                out = state.model(
                    images[rows], captions[rows], lengths[rows],
                    None if bert_mask is None else bert_mask[rows])
            return (M.all_gather_rows(self.mesh, out["image_features"]),
                    M.all_gather_rows(self.mesh, out["caption_features"]),
                    None)

    @contextlib.contextmanager
    def _local_batchnorm(self):
        """BatchNorm on this rank's rows alone while open (a batch run whole
        on every rank)."""
        set_batchnorm_mesh(self.model, None)
        try:
            yield
        finally:
            set_batchnorm_mesh(self.model, self.mesh)

    def _train(self, state: EngineState, images, captions, lengths,
               bert_mask) -> Dict[str, torch.Tensor]:
        """One train step on staged inputs; the loss dict is taken before
        the update (``shift`` and ``negative_scale`` are the values the
        loss used, as in the JAX package)."""
        state.model.train()
        state.optimizer.zero_grad(set_to_none=True)
        img_f, txt_f, aux = self._forward(state, images, captions, lengths,
                                          bert_mask)
        with profiling.span("creamfl.engine.loss"):
            loss, ldict = state.criterion(img_f, txt_f)
            if aux is not None:
                loss = loss + aux
        with profiling.span("creamfl.engine.backward"):
            loss.backward()
        ldict = {k: v.detach().clone() for k, v in ldict.items()}
        self._update(state, images.shape[0])
        return ldict

    @torch.no_grad()
    def _features(self, state: EngineState, train: bool, images, captions,
                  lengths, bert_mask) -> Tuple[torch.Tensor, torch.Tensor]:
        state.model.train(train)
        return self._forward(state, images, captions, lengths,
                             bert_mask)[:2]

    def _distill(self, state: EngineState, images, captions, lengths,
                 bert_mask, aggregated: Dict[str, torch.Tensor],
                 rows: torch.Tensor, use_img: bool, use_txt: bool,
                 use_mm: bool, kd_weight: float) -> torch.Tensor:
        state.model.train()
        state.optimizer.zero_grad(set_to_none=True)
        img_f, txt_f, aux = self._forward(state, images, captions, lengths,
                                          bert_mask)
        with profiling.span("creamfl.engine.loss"):
            img_f, txt_f = img_f.float(), txt_f.float()
            t_img = (aggregated["img"].index_select(0, rows)
                     if use_img or use_mm else None)
            t_txt = (aggregated["txt"].index_select(0, rows)
                     if use_txt or use_mm else None)
            terms = []
            if use_img:
                terms.append((img_f, t_img))
            if use_txt:
                terms.append((txt_f, t_txt))
            if use_mm:
                terms += [(img_f, t_img), (txt_f, t_txt)]
            loss = torch.zeros((), device=self.device)
            for pred, target in terms:
                loss = loss + kd_weight * torch.mean(
                    torch.square(pred - target))
            if terms and aux is not None:
                loss = loss + aux
        if terms:
            with profiling.span("creamfl.engine.backward"):
                loss.backward()
        self._update(state, images.shape[0])
        return loss.detach()

    def train_step(self, state: EngineState, images, captions, lengths,
                   bert_mask=None
                   ) -> Tuple[EngineState, Dict[str, torch.Tensor]]:
        ldict = self._train(state, *self.stage(images, captions, lengths,
                                               bert_mask))
        state.step += 1
        self._count_steps(1, len(images), captions)
        return state, ldict

    def extract_step(self, state: EngineState, images, captions, lengths,
                     bert_mask=None) -> Tuple[torch.Tensor, torch.Tensor]:
        """Train-mode feature pass; the BatchNorm running stats it moves
        stay in ``state.model``. Returns (img_feats, txt_feats)."""
        return self._features(state, True, *self.stage(
            images, captions, lengths, bert_mask))

    def eval_step(self, state: EngineState, images, captions, lengths,
                  bert_mask=None) -> Tuple[torch.Tensor, torch.Tensor]:
        """Eval-mode forward for retrieval evaluation."""
        return self._features(state, False, *self.stage(
            images, captions, lengths, bert_mask))

    def distill_step(self, state: EngineState, images, captions, lengths,
                     bert_mask, aggregated: Dict[str, torch.Tensor],
                     rows, use_img: bool, use_txt: bool, use_mm: bool,
                     kd_weight: float) -> Tuple[EngineState, torch.Tensor]:
        """``aggregated``: {'img': [N, d], 'txt': [N, d]} con_w ensembles
        (a modality no term reads may be None); ``rows`` [B] indexes this
        batch's targets."""
        rows = torch.as_tensor(rows, dtype=torch.long, device=self.device)
        loss = self._distill(state, *self.stage(images, captions, lengths,
                                                bert_mask), aggregated,
                             rows, use_img, use_txt, use_mm, kd_weight)
        state.step += 1
        self._count_steps(1, len(images), captions)
        return state, loss

    # -- chunked sweeps -------------------------------------------------
    # Each ``*_chunk`` runs k stacked batches ([k, B, ...]) as k steps in
    # order, with the JAX package's signatures and results. On the card,
    # on the BERT branch, the k steps are one replay of one CUDA graph
    # (``chunk_route`` "graph"): the host work of a step (some thousand
    # launches) is paid once, at capture. On the CPU
    # and on the GRU branch (whose packing reads host lengths, which a
    # graph cannot) they run eagerly ("eager").
    @property
    def chunk_route(self) -> str:
        """"graph" on the card with the BERT text branch off a mesh, else
        "eager": fixed by the configuration, never by a failed capture."""
        if (self.device.type == "cuda" and not self.model.not_bert
                and self.mesh is None):
            return "graph"
        return "eager"

    def release_graphs(self) -> None:
        """Drop the captured graphs and their memory pools (the round does
        so at its end)."""
        self.graphs.clear()

    def _chunk(self, kind: str, state: EngineState, inputs, step,
               flags=()):
        """Run ``step(*staged inputs of batch i)`` for i < k and stack its
        outputs. ``inputs``: (images, captions, lengths, bert_mask, *more)
        stacked over the chunk, ``more`` device tensors or arrays;
        ``flags``: the static arguments, part of a graph's key."""
        images, captions, lengths, bert_mask, *more = inputs
        staged = list(self.stage(images, captions, lengths, bert_mask))
        more = [torch.as_tensor(x, device=self.device) for x in more]
        k = staged[0].shape[0]

        def body(*xs):
            outs = [step(*(None if x is None else x[i] for x in xs))
                    for i in range(k)]
            return tuple(torch.stack(o) for o in zip(*outs))

        if self.chunk_route == "eager":
            return body(*staged, *more)
        staged[2] = None  # host lengths: unused on the BERT branch
        key = (kind, flags) + tuple(
            None if x is None else (tuple(x.shape), x.dtype)
            for x in staged + more)
        return self.graphs.run(key, state, staged + more, body)

    def extract_chunk(self, state: EngineState, images, captions, lengths,
                      bert_mask=None) -> Tuple[torch.Tensor, torch.Tensor]:
        """``extract_step`` over k stacked batches; the BatchNorm running
        stats move from step to step as the per-batch loop moves them.
        Returns ([k, B, E] img, [k, B, E] txt)."""
        return self._chunk(
            "extract", state, (images, captions, lengths, bert_mask),
            lambda *x: self._features(state, True, *x))

    def eval_chunk(self, state: EngineState, images, captions, lengths,
                   bert_mask=None) -> Tuple[torch.Tensor, torch.Tensor]:
        """``eval_step`` over k stacked batches: ([k, B, E], [k, B, E])."""
        return self._chunk(
            "eval", state, (images, captions, lengths, bert_mask),
            lambda *x: self._features(state, False, *x))

    def train_chunk(self, state: EngineState, images, captions, lengths,
                    bert_mask=None) -> Tuple[EngineState, torch.Tensor]:
        """``train_step`` over k stacked batches: step t + 1 sees the state
        step t left (params, AdamP moments and steps, BatchNorm stats).
        Returns (state, [k] losses)."""
        (losses,) = self._chunk(
            "train", state, (images, captions, lengths, bert_mask),
            lambda *x: (self._train(state, *x)["loss"],))
        state.step += len(losses)
        self._count_steps(len(losses), len(losses) * images.shape[1],
                          captions)
        return state, losses

    def distill_chunk(self, state: EngineState, images, captions, lengths,
                      bert_mask, aggregated: Dict[str, torch.Tensor],
                      rows, use_img: bool, use_txt: bool, use_mm: bool,
                      kd_weight: float) -> Tuple[EngineState, torch.Tensor]:
        """``distill_step`` over k stacked batches; ``rows`` is [k, B].
        Returns (state, [k] losses). A captured graph reads ``aggregated``
        at its addresses, which are part of its key."""
        flags = (use_img, use_txt, use_mm, kd_weight) + tuple(
            None if aggregated.get(m) is None else aggregated[m].data_ptr()
            for m in ("img", "txt"))
        (losses,) = self._chunk(
            "distill", state,
            (images, captions, lengths, bert_mask,
             torch.as_tensor(rows, dtype=torch.long)),
            lambda *x: (self._distill(state, *x[:4], aggregated, x[4],
                                      use_img, use_txt, use_mm,
                                      kd_weight),),
            flags)
        state.step += len(losses)
        self._count_steps(len(losses), len(losses) * images.shape[1],
                          captions)
        return state, losses


    def _count_steps(self, steps: int, rows: int, captions) -> None:
        """The recorder's ``engine.steps`` and ``engine.rows``: the updates
        and the rows they took, counted where a step or a chunk returns, so
        that a graph replay counts its k steps; with a decoder tower,
        ``moe.tokens`` and ``moe.pairs`` (its MoE layers' tokens of
        ``captions.shape[-1]`` positions and their top-k pairs) and
        ``mamba.tokens`` (its Mamba mixers' tokens, counted alike)."""
        profiling.count("engine.steps", steps)
        profiling.count("engine.rows", rows)
        if self.moe is not None:
            layers, top_k = self.moe
            tokens = rows * captions.shape[-1] * layers
            profiling.count("moe.tokens", tokens)
            profiling.count("moe.pairs", tokens * top_k)
        if self.mixers:
            profiling.count("mamba.tokens",
                            rows * captions.shape[-1] * self.mixers)

"""Federated orchestration: the CreamFL round loop, sequential clients.

Port of the JAX package's ``federation/rounds.py`` (``MMFL``; reference
`src/algorithms/MMFL.py`), its sequential client branch
(``--no_client_parallel``). Per round (``MMFL.train``):

  1. the server trains one epoch on the public set;
  2. global image/text features are extracted over the public eval loader
     (train-mode, as the reference does);
  3. ``client_num_per_round`` clients are sampled; each runs
     ``local_epochs`` of task training plus public-set inter/intra contrast
     (the fused gallery CE kernel), a local test (img/txt), and uploads its
     public-set representations;
  4. con_w weighs the uploads (the con_w diagonal kernel);
  5. the server distils (MSE) against the aggregates;
  6. retrieval eval, the best and last server models saved.

Features, uploads and aggregates stay on the device between phases.
Randomness per round is a function of (seed, round): client sampling and
loader order as in the JAX package (``_seed_round``), dropout from torch's
generators re-seeded there. Weights are drawn from ``args.seed``;
``load_state_dicts`` replaces them (e.g. by a JAX ``MMFL``'s, converted).

Not ported yet, and refused rather than ignored: the stacked client branch
(``client_parallel``), a multi-GPU mesh, round checkpoints and
``--resume`` (``ckpt_dir``), ``--save_client``, ``--client_bf16`` and the
pretrained-weight loaders (ROADMAP queue 1 items 2-3).
"""

from __future__ import annotations

import os
import random
from typing import Dict, List, Optional

import numpy as np
import torch

from creamfl_tpu_torch.data.loaders import ProjectedLoader, suffix_valid
from creamfl_tpu_torch.engine.client_mm import MMClientEngine
from creamfl_tpu_torch.engine.client_uni import UniClientEngine
from creamfl_tpu_torch.engine.evaluator import RetrievalEvaluator
from creamfl_tpu_torch.engine.server import ServerEngine
from creamfl_tpu_torch.federation.aggregation import aggregate_modalities
from creamfl_tpu_torch.utils.device import resolve_device
from creamfl_tpu_torch.utils.helper import save_checkpoint
from creamfl_tpu_torch.utils.logging import NoOpTracker, PythonLogger
from creamfl_tpu_torch.utils.profiling import StepTimer

# Options of the JAX MMFL that the port does not have yet, with the
# ROADMAP item that brings each.
_UNPORTED = (
    ("client_parallel", "the stacked client branch (client_parallel; pass "
     "--no_client_parallel)", "queue 1 item 2"),
    ("ckpt_dir", "round checkpoints (--ckpt_dir)", "queue 1 item 2"),
    ("resume", "--resume", "queue 1 item 2"),
    ("save_client", "--save_client", "queue 1 item 2"),
    ("client_bf16", "--client_bf16", "queue 1 item 3"),
    ("resnet_ckpt", "--resnet_ckpt", "queue 1 item 3 (load_pretrained)"),
    ("bert_ckpt", "--bert_ckpt", "queue 1 item 3 (load_pretrained)"),
    ("glove_path", "--glove_path", "queue 1 item 3 (load_pretrained)"),
    ("client_resnet_ckpt", "--client_resnet_ckpt",
     "queue 1 item 3 (load_pretrained)"),
)


class ClientHandle:
    """One federated client: family engine + its own state + data."""

    def __init__(self, kind: str, engine, state, train_loader,
                 client_id: int):
        self.kind = kind  # 'img' | 'txt' | 'mm'
        self.engine = engine
        self.state = state
        self.train_loader = train_loader
        self.client_id = client_id
        self.client_idx = -1  # global index, assigned by MMFL


class MMFL:
    def __init__(self, args, datasets: Dict, server_config, mm_config=None,
                 tracker=None, logger=None, bert_config=None,
                 device="cuda"):
        """datasets: the bundle of ``data.pipelines.build_synthetic_datasets``
        (pub_train / pub_eval / test loaders, per-family client loader
        lists, img/txt test loaders, vocab, class counts, crossfolds).
        ``device``: where everything runs; CUDA unless the caller asks for
        the CPU."""
        for flag, what, item in _UNPORTED:
            if getattr(args, flag, None):
                raise NotImplementedError(
                    f"{what} is not ported yet (ROADMAP {item})")
        self.device = resolve_device(device)
        n_dev = (torch.cuda.device_count() if self.device.type == "cuda"
                 else 1)
        n_mesh = min(n_dev, getattr(args, "mesh_devices", 0) or n_dev)
        if n_mesh > 1 and getattr(args, "use_mesh", True):
            raise NotImplementedError(
                f"a mesh of {n_mesh} devices is not ported yet (ROADMAP "
                "queue 1 item 2); pass --no_mesh or --mesh_devices 1")
        self.args = args
        self.datasets = datasets
        self.logger = logger or PythonLogger()
        self.tracker = tracker or NoOpTracker()

        vocab_size = len(datasets["vocab"])
        self.server = ServerEngine(server_config, vocab_size,
                                   mlp_local=args.mlp_local,
                                   bert_config=bert_config,
                                   device=self.device)
        self.server.kd_weight = args.kd_weight
        self.evaluator = RetrievalEvaluator(
            n_crossfolds=datasets.get("n_crossfolds", 5),
            n_images_per_crossfold=datasets.get("n_images_per_crossfold",
                                                1000),
            n_captions_per_crossfold=datasets.get(
                "n_captions_per_crossfold", 5000),
            logger=self.logger)

        self.clients: List[ClientHandle] = []
        self._build_clients(mm_config, vocab_size)
        self.server_state = self.server.init_state(self._init_seed(0))

        self.best_score = 0.0
        self.best_scores = None
        self.best_metadata = None
        self.global_img_feature = None
        self.global_txt_feature = None
        self.distill_index = None
        self.img_reps = self.txt_reps = None
        self.img_vec = self.txt_vec = None
        self.sampled: List[int] = []  # client_idx of the round's clients
        self._pub_views: Dict = {}
        self.timer = StepTimer(device=self.device)
        self.last_timing: Dict[str, float] = {}
        self.last_scores: Optional[Dict] = None

    def _init_seed(self, k: int) -> int:
        """Weight seed of the server (k = 0) and of client k (its global
        index), a function of ``args.seed``."""
        return self.args.seed * 1_000_003 + 7_919 * k

    def _build_clients(self, mm_config, vocab_size: int) -> None:
        args, ds, dev = self.args, self.datasets, self.device
        families = []
        if args.num_img_clients > 0 and ds.get("img_clients"):
            families.append(("img", UniClientEngine(
                "img", ds["img_num_class"], args, device=dev),
                ds["img_clients"]))
        if args.num_txt_clients > 0 and ds.get("txt_clients"):
            families.append(("txt", UniClientEngine(
                "txt", ds["txt_num_class"], args, vocab_size=vocab_size,
                device=dev), ds["txt_clients"]))
        if args.num_mm_clients > 0 and ds.get("mm_clients"):
            families.append(("mm", MMClientEngine(
                mm_config, vocab_size, args, mlp_local=args.mlp_local,
                device=dev), ds["mm_clients"]))
        for kind, engine, loaders in families:
            for i, loader in enumerate(loaders):
                idx = len(self.clients) + 1
                client = ClientHandle(kind, engine,
                                      engine.init_state(self._init_seed(idx)),
                                      loader, i)
                client.client_idx = idx
                self.clients.append(client)

    def load_state_dicts(self, server: Optional[Dict] = None,
                         clients: Optional[List[Optional[Dict]]] = None
                         ) -> None:
        """Start from given weights: ``server`` as ``ServerEngine.init_state``
        takes it (``model.*`` / ``criterion.*``), ``clients[i]`` as client
        i's engine takes it (None keeps a client's own). Optimizer state
        starts afresh, as it does at init."""
        if server is not None:
            self.server_state = self.server.init_state(state_dict=server)
        for client, sd in zip(self.clients, clients or ()):
            if sd is not None:
                client.state = client.engine.init_state(state_dict=sd)

    # ------------------------------------------------------------------
    def _server_inputs(self, batch):
        return (batch["images"],) + tuple(self.server.text_inputs(batch))

    def _server_train_epoch(self) -> None:
        losses = [self.server.train_step(self.server_state,
                                         *self._server_inputs(batch))[1]
                  ["loss"] for batch in self.datasets["pub_train"]]
        if losses:
            self.logger.log(f"server epoch loss "
                            f"{float(torch.stack(losses).mean()):.2f}")

    def _extract_global_features(self) -> None:
        """Train-mode feature pass over the public eval loader (the
        reference extracts in train() mode, MMFL.py:189-218). The loader
        keeps a ragged last batch and pads nothing, so the valid rows are
        a prefix of the concatenation."""
        img_parts, txt_parts, index_parts = [], [], []
        n_valid = 0
        for batch in self.datasets["pub_eval"]:
            img_f, txt_f = self.server.extract_step(
                self.server_state, *self._server_inputs(batch))
            valid = np.asarray(batch["valid"])
            n_valid += suffix_valid(valid)
            img_parts.append(img_f)
            txt_parts.append(txt_f)
            index_parts.append(np.asarray(batch["index"])[valid])
        self.global_img_feature = torch.cat(img_parts)[:n_valid]
        self.global_txt_feature = torch.cat(txt_parts)[:n_valid]
        self.distill_index = np.concatenate(index_parts).astype(np.int64)
        # Dense index -> row table (the reference keeps a dict, MMFL.py:343).
        table = np.full(int(self.distill_index.max()) + 1, -1, np.int64)
        table[self.distill_index] = np.arange(len(self.distill_index))
        self._distill_pos = table

    def _batch_rows(self, batch) -> np.ndarray:
        """Rows of a public batch in the global feature matrices (reference
        distill_dict, MMFL.py:343), on the host."""
        rows = self._distill_pos[np.asarray(batch["index"])]
        assert (rows >= 0).all(), "public batch index outside distill set"
        return rows

    # Public-set fields each client family reads.
    _PUB_FIELDS = {
        "img": ("images", "index", "valid"),
        "txt": ("captions", "lengths", "index", "valid"),
        "mm": ("images", "captions", "lengths", "index", "valid"),
    }

    def _pub(self, split: str, kind: str) -> ProjectedLoader:
        """Projected view of datasets[split] for one client family."""
        key = (split, kind)
        if key not in self._pub_views:
            self._pub_views[key] = ProjectedLoader(self.datasets[split],
                                                   self._PUB_FIELDS[kind])
        return self._pub_views[key]

    # -- client execution ---------------------------------------------
    def _run_uni_client(self, client: ClientHandle, round_n: int) -> None:
        engine: UniClientEngine = client.engine
        args = self.args
        old_model = engine.snapshot(client.state)
        engine.set_round_lr(client.state, round_n)
        do_inter = args.contrast_local_inter
        do_intra = args.contrast_local_intra
        same = (self.global_img_feature if client.kind == "img"
                else self.global_txt_feature)
        other = (self.global_txt_feature if client.kind == "img"
                 else self.global_img_feature)
        for _ in range(args.local_epochs):
            for batch in client.train_loader:
                engine.task_step(client.state, batch)
            if do_inter or do_intra:
                for batch in self._pub("pub_train", client.kind):
                    globals_ = {"same": same, "other": other,
                                "index": self._batch_rows(batch)}
                    engine.contrast_step(client.state, old_model, batch,
                                         globals_, do_inter, do_intra)
        # Local test (top-1/top-k): counts stay on the device, one fetch
        # per client.
        test_loader = self.datasets.get(f"{client.kind}_test")
        if test_loader is not None:
            counts = torch.stack([
                torch.stack(engine.test_step(client.state, batch))
                for batch in test_loader]).sum(0).tolist()
            c1, ck, n = counts
            if n:
                self.logger.log(
                    f"client {client.client_idx} ({client.kind}) "
                    f"top1 {100*c1/n:.2f} topk {100*ck/n:.2f}")

    def _uni_client_reps(self, client: ClientHandle) -> Dict:
        """Train-mode feature pass over the public eval loader; the BN
        running-stat update persists (the reference leaves the model in
        train() mode here, ClientTrainer.py:552)."""
        parts, idx_parts = [], []
        for batch in self._pub("pub_eval", client.kind):
            feats, _ = client.engine.features_step(client.state, batch)
            valid = np.asarray(batch["valid"])
            parts.append(feats[:suffix_valid(valid)])
            idx_parts.append(np.asarray(batch["index"])[valid])
        order = np.concatenate(idx_parts)
        assert np.array_equal(order, self.distill_index), \
            "public-set iteration order changed between phases"
        vec = torch.cat(parts)
        if client.kind == "img":
            return {"img": vec, "txt": None}
        return {"img": None, "txt": vec}

    def _run_mm_client(self, client: ClientHandle, round_n: int) -> None:
        engine: MMClientEngine = client.engine
        args = self.args
        old_model = engine.snapshot(client.state)
        engine.set_round_lr(client.state, round_n)
        do_inter = args.contrast_local_inter
        do_intra = args.contrast_local_intra
        for _ in range(args.local_epochs):
            for batch in client.train_loader:
                engine.local_step(client.state, batch)
            if do_inter or do_intra:
                for batch in self._pub("pub_train", "mm"):
                    globals_ = {"img": self.global_img_feature,
                                "txt": self.global_txt_feature,
                                "index": self._batch_rows(batch)}
                    engine.contrast_step(client.state, old_model, batch,
                                         globals_, do_inter, do_intra)

    def _mm_client_reps(self, client: ClientHandle) -> Dict:
        img_parts, txt_parts = [], []
        for batch in self._pub("pub_eval", "mm"):
            fi, ft = client.engine.features_step(client.state, batch)
            n = suffix_valid(np.asarray(batch["valid"]))
            img_parts.append(fi[:n])
            txt_parts.append(ft[:n])
        return {"img": torch.cat(img_parts), "txt": torch.cat(txt_parts)}

    # -- distillation ---------------------------------------------------
    def _distill(self, img_vecs: List[torch.Tensor],
                 txt_vecs: List[torch.Tensor]) -> None:
        args = self.args
        self.img_reps = torch.stack(img_vecs) if img_vecs else None
        self.txt_reps = torch.stack(txt_vecs) if txt_vecs else None
        img_agg, txt_agg = aggregate_modalities(
            self.img_reps, self.txt_reps, self.global_img_feature,
            self.global_txt_feature)
        self.img_vec, self.txt_vec = img_agg, txt_agg
        use_img = args.num_img_clients > 0 and img_agg is not None
        use_txt = args.num_txt_clients > 0 and txt_agg is not None
        use_mm = (args.num_mm_clients > 0 and img_agg is not None
                  and txt_agg is not None)
        if not (use_img or use_txt or use_mm):
            return
        aggregated = {"img": img_agg, "txt": txt_agg}
        for batch in self.datasets["pub_train"]:
            self.server.distill_step(
                self.server_state, *self._server_inputs(batch), aggregated,
                self._batch_rows(batch), use_img, use_txt, use_mm,
                args.kd_weight)

    # -- evaluation -----------------------------------------------------
    def _extract_eval(self, batch):
        return self.server.eval_step(self.server_state,
                                     *self._server_inputs(batch))

    def evaluate(self) -> Dict:
        return self.evaluator.evaluate(self.datasets["test"],
                                       self._extract_eval)

    def _seed_round(self, round_n: int) -> random.Random:
        """Re-seed every per-round randomness source as a function of
        (seed, round): torch's generators (dropout), each loader's epoch
        order (``set_round``), and the client sampler returned."""
        torch.manual_seed(self.args.seed * 1_000_003 + round_n)
        seen = set()
        for v in self.datasets.values():
            for loader in (v if isinstance(v, list) else [v]):
                if id(loader) in seen:
                    continue
                seen.add(id(loader))
                set_round = getattr(loader, "set_round", None)
                if set_round is not None:
                    set_round(round_n)
        # int mix, not a tuple: random.Random rejects tuple seeds.
        return random.Random(self.args.seed * 2_147_483_659 + round_n)

    # ------------------------------------------------------------------
    def train(self, round_n: int) -> Dict:
        """One round. ``last_scores`` then holds its scores and
        ``last_timing`` the StepTimer phases (server_train,
        global_features, aggregate_distill, eval) and ``round``, the whole
        round up to its scores (saving excluded)."""
        with self.timer.phase("round"):
            scores = self.last_scores = self._round(round_n)
        self.last_timing = self.timer.report()
        self.logger.log(f"round {round_n + 1} timing | " + " ".join(
            f"{k}={v}" for k, v in sorted(self.last_timing.items())))
        rsum = self._report(round_n, scores)
        if rsum > self.best_score:
            self.best_score = rsum
            self.best_scores = scores
            self.best_metadata = {"best_epoch": round_n + 1,
                                  "best_score": rsum}
            self._save(f"{self.args.name}-best_model.ckpt")
        if round_n == self.args.comm_rounds - 1:
            self._save(f"{self.args.name}-last_model.ckpt")
        return scores

    def _round(self, round_n: int) -> Dict:
        args = self.args
        self.logger.log(f"Round {round_n + 1}!")
        round_rng = self._seed_round(round_n)
        self.server.set_round_lr(self.server_state, round_n)
        with self.timer.phase("server_train"):
            self._server_train_epoch()

        cur = self.clients
        if len(self.clients) > args.client_num_per_round:
            cur = round_rng.sample(self.clients, args.client_num_per_round)
        self.sampled = [c.client_idx for c in cur]

        if (args.agg_method == "con_w" or args.contrast_local_inter
                or args.contrast_local_intra):
            with self.timer.phase("global_features"):
                self._extract_global_features()

        img_vecs, txt_vecs = [], []
        for client in cur:
            self.logger.log(f"Training Client {client.client_idx} "
                            f"({client.kind})!")
            if client.kind == "mm":
                self._run_mm_client(client, round_n)
                reps = self._mm_client_reps(client)
            else:
                self._run_uni_client(client, round_n)
                reps = self._uni_client_reps(client)
            if reps["img"] is not None:
                img_vecs.append(reps["img"])
            if reps["txt"] is not None:
                txt_vecs.append(reps["txt"])

        if not args.disable_distill and (img_vecs or txt_vecs):
            if args.agg_method != "con_w":
                raise NotImplementedError(args.agg_method)
            self.logger.log("start distilling")
            with self.timer.phase("aggregate_distill"):
                self._distill(img_vecs, txt_vecs)

        with self.timer.phase("eval"):
            return self.evaluate()

    def _report(self, round_n: int, scores: Dict) -> float:
        n_fold = scores.get("n_fold", {"i2t": {"recall_1": 0.0},
                                       "t2i": {"recall_1": 0.0}})
        rsum = (n_fold["i2t"]["recall_1"] + n_fold["t2i"]["recall_1"]
                + scores["i2t"]["recall_1"] + scores["t2i"]["recall_1"])
        self.tracker.log({"Server rsum_r1": rsum,
                          "Server i2t_r1": scores["i2t"]["recall_1"],
                          "Server t2i_r1": scores["t2i"]["recall_1"]},
                         step=round_n)
        # Reference-format flattened score line
        # (retrieval_trainer.py:216-237 key scheme).
        self.server.report_scores(round_n + 1, {"test": scores},
                                  metadata={"cur_epoch": round_n + 1},
                                  prefix="eval__", logger=self.logger)
        self.logger.report(round_n + 1, {
            "rsum_r1": rsum,
            "i2t_r1": scores["i2t"]["recall_1"],
            "t2i_r1": scores["t2i"]["recall_1"],
        })
        return rsum

    def _save(self, name: str) -> str:
        state = self.server_state
        return save_checkpoint(
            os.path.join(getattr(self.args, "exp_dir", "."), name),
            {"model": state.model.state_dict(),
             "criterion": state.criterion.state_dict(),
             "step": state.step})

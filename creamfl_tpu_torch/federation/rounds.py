"""Federated orchestration: the CreamFL round loop.

Port of the JAX package's ``federation/rounds.py`` (``MMFL``; reference
`src/algorithms/MMFL.py`), on one card or on a mesh of ranks. Per round
(``MMFL.train``):

  1. the server trains one epoch on the public set;
  2. global image/text features are extracted over the public eval loader
     (train-mode, as the reference does);
  3. ``client_num_per_round`` clients are sampled; each runs
     ``local_epochs`` of task training plus public-set inter/intra contrast
     (the fused gallery CE kernel), a local test (img/txt), and uploads its
     public-set representations;
  4. con_w weighs the uploads (the con_w diagonal kernel);
  5. the server distils (MSE) against the aggregates;
  6. retrieval eval, the best and last server models saved, and with
     ``--ckpt_dir`` a round checkpoint (``save_round``; ``resume`` restores
     the latest).

Step 3 takes the stacked branch by default (``client_parallel``, as in the
JAX package): the sampled clients go by family, and each family walks the
public set once per contrast epoch and once for its uploads, its gallery
CEs one segmented kernel launch per batch (``federation/stacked.py``).
``--no_client_parallel`` runs the clients one by one, each a family of
one.

Features, uploads and aggregates stay on the device between phases.
Randomness per round is a function of (seed, round) (``_seed_round``), so
a resumed run continues a straight one. Weights are drawn from
``args.seed``; ``load_state_dicts`` replaces them (e.g. by a JAX
``MMFL``'s, converted).

``--client_bf16`` runs the image clients' trunks in bf16 on both client
branches. ``--resnet_ckpt``, ``--bert_ckpt`` and ``--glove_path`` load the
server's pretrained weights from local files, ``--client_resnet_ckpt`` and
``--glove_path`` the clients' (a client trunk whose shapes differ from the
file's is logged and skipped, as in the JAX package).

On a mesh (``parallel/mesh.py``: one process per card, every rank running
this program with the same seeds, loaders and sampled clients; the JAX
package's ``use_mesh``, engaged whenever the process group has more than
one rank and ``--no_mesh`` is off): the server's phases are data-parallel,
each batch's rows split over the ranks (``engine/server.py``), per batch
(no chunk graphs, as the JAX round keeps per-batch programs on its mesh);
global features and eval features are gathered per batch, so every rank
holds them whole; each family's members are split over the ranks
(``client_slots``; on the sequential branch client k of the sampled list
goes to rank k mod world), a rank trains its own and every member's state
is then broadcast from its owner; the uploads stay where they were made
and con_w runs over the client axis (``federation/aggregation.py``); the
ranking shards its queries (``engine/evaluator.py``). Only rank 0 logs
and writes files; every rank restores from the same checkpoint.
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
from creamfl_tpu_torch.federation import stacked
from creamfl_tpu_torch.federation.aggregation import aggregate_modalities
from creamfl_tpu_torch.parallel import mesh as M
from creamfl_tpu_torch.utils.checkpoint import RoundCheckpointer
from creamfl_tpu_torch.utils.device import resolve_device
from creamfl_tpu_torch.utils.helper import save_checkpoint
from creamfl_tpu_torch.utils.logging import NoOpTracker, PythonLogger
from creamfl_tpu_torch.utils.profiling import StepTimer

# Batches per chunk in the server's forward-only sweeps (global features,
# eval): one CUDA graph replay each on the card (the JAX package's
# ``SERVER_SCAN_CHUNK``, one dispatch each).
SERVER_SCAN_CHUNK = 8

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
                 device="cuda", mesh: Optional[M.Mesh] = None):
        """datasets: the bundle of ``data.pipelines.build_synthetic_datasets``
        or ``build_real_datasets`` (pub_train / pub_eval / test loaders,
        per-family client loader lists, img/txt test loaders, vocab, class
        counts, crossfolds); a loader's ``images`` may already be on the
        device (``DeviceImages``, ``DeviceImageBatches``) and are used
        there.
        ``device``: where everything runs; CUDA unless the caller asks for
        the CPU. ``mesh``: the ranks this run spans; by default the
        initialized process group's (``parallel/mesh.py:make_mesh``)
        unless ``--no_mesh``. A mesh of one rank is no mesh."""
        self.device = resolve_device(device)
        if mesh is None and getattr(args, "use_mesh", True):
            mesh = M.make_mesh(self.device)
        self.mesh = mesh if M.active(mesh) else None
        self.args = args
        self.datasets = datasets
        self.logger = logger or PythonLogger()
        self.tracker = tracker or NoOpTracker()
        if self.mesh is not None:
            self.logger.log(f"mesh: {self.mesh.world} ranks "
                            f"({self.mesh.backend})")
        elif (self.device.type == "cuda" and torch.cuda.device_count() > 1
                and getattr(args, "use_mesh", True)):
            self.logger.log(f"{torch.cuda.device_count()} cards visible; "
                            f"this process runs on {self.device} alone "
                            "(main.run starts one process per card)")

        if self.mesh is not None:
            self._check_same_data()

        vocab_size = len(datasets["vocab"])
        self.server = ServerEngine(server_config, vocab_size,
                                   mlp_local=args.mlp_local,
                                   bert_config=bert_config,
                                   device=self.device, mesh=self.mesh)
        self.server.kd_weight = args.kd_weight
        self.evaluator = RetrievalEvaluator(
            n_crossfolds=datasets.get("n_crossfolds", 5),
            n_images_per_crossfold=datasets.get("n_images_per_crossfold",
                                                1000),
            n_captions_per_crossfold=datasets.get(
                "n_captions_per_crossfold", 5000),
            mesh=self.mesh, logger=self.logger)

        self.clients: List[ClientHandle] = []
        self._build_clients(mm_config, vocab_size)
        self.server_state = self.server.init_state(self._init_seed(0))
        files = {"resnet_path": getattr(args, "resnet_ckpt", None),
                 "bert_path": getattr(args, "bert_ckpt", None),
                 "glove_path": getattr(args, "glove_path", None)}
        if any(files.values()):
            self.server.load_pretrained(self.server_state,
                                        vocab=datasets["vocab"], **files)
            self.logger.log("loaded pretrained weights into server")

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
        ckpt_dir = getattr(args, "ckpt_dir", None)
        self.checkpointer = (RoundCheckpointer(ckpt_dir,
                                               map_location=self.device)
                             if ckpt_dir else None)

    def _check_same_data(self) -> None:
        """The ranks must read the same data: rank 0's digest of the first
        public batch's text fields against this rank's. (The synthetic BERT
        ids hash words with ``hash()``: the ranks need one
        ``PYTHONHASHSEED``.)"""
        import hashlib

        fields = ("captions", "bert_ids", "index")
        batch = next(iter(ProjectedLoader(self.datasets["pub_train"],
                                          fields)))
        digest = hashlib.sha256(b"".join(
            np.ascontiguousarray(np.asarray(batch[k])).tobytes()
            for k in fields if k in batch)).hexdigest()
        if M.broadcast_object(self.mesh, digest, 0) != digest:
            raise ValueError(
                f"rank {self.mesh.rank} reads other public batches than "
                "rank 0 (another PYTHONHASHSEED or other data roots?)")

    def _init_seed(self, k: int) -> int:
        """Weight seed of the server (k = 0) and of client k (its global
        index), a function of ``args.seed``."""
        return self.args.seed * 1_000_003 + 7_919 * k

    def _build_clients(self, mm_config, vocab_size: int) -> None:
        args, ds, dev = self.args, self.datasets, self.device
        families = []
        if args.num_img_clients > 0 and ds.get("img_clients"):
            families.append(("img", UniClientEngine(
                "img", ds["img_num_class"], args,
                use_bf16=bool(getattr(args, "client_bf16", False)),
                device=dev), ds["img_clients"]))
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
        if getattr(args, "glove_path", None):
            self._load_client_glove(args.glove_path)
        if getattr(args, "client_resnet_ckpt", None):
            self._load_client_resnet(args.client_resnet_ckpt)

    @torch.no_grad()
    def _load_client_resnet(self, path: str) -> None:
        """A torchvision ResNet file into every image client's trunk
        (reference resnet18_client(pretrained=True),
        resnet_client.py:227-231); when the trunk's shapes differ from the
        file's, log it and load nothing."""
        from creamfl_tpu_torch.models.convert import load_torchvision_trunk

        trunk = load_torchvision_trunk(path)
        got = {k: tuple(v.shape) for k, v in trunk.items()}
        for c in self.clients:
            if c.kind != "img":
                continue
            backbone = c.state.model.backbone
            if got != {k: tuple(v.shape)
                       for k, v in backbone.state_dict().items()}:
                self.logger.log("client trunk/ckpt architecture mismatch; "
                                "skipping pretrained load")
                return
            backbone.load_state_dict(trunk)

    @torch.no_grad()
    def _load_client_glove(self, glove_path: str) -> None:
        """GloVe rows into the text and mm clients' word embeddings
        (reference caption_encoder.py:60-85, language_model.py:66-91). As
        in the JAX package, one matrix is built per embedding shape, its
        misses from the first such client's rows, and every client of that
        shape takes it."""
        from creamfl_tpu_torch.models.convert import load_glove_embeddings

        vocab = self.datasets["vocab"]
        mat = None
        for c in self.clients:
            if c.kind == "txt":
                embed = c.state.model.embed.weight
            elif c.kind == "mm":
                embed = c.state.model.txt_enc.embed.weight
            else:
                continue
            if mat is None or mat.shape != tuple(embed.shape):
                mat, missing = load_glove_embeddings(
                    glove_path, vocab, embed.shape[1],
                    init=embed.detach().cpu().numpy())
                self.logger.log(
                    f"glove: {len(vocab) - missing}/{len(vocab)} hit")
            embed.copy_(torch.from_numpy(mat))

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

    def _stack_server_chunk(self, group):
        """k batches -> the server's stacked [k, B, ...] inputs: images
        stacked where they lie (on the device when the loader made them
        there), the text fields on the host."""
        imgs = [b["images"] for b in group]
        images = (torch.stack(imgs) if isinstance(imgs[0], torch.Tensor)
                  else np.stack(imgs))
        caps, lens, masks = zip(*(self.server.text_inputs(b)
                                  for b in group))
        bert_mask = np.stack(masks) if masks[0] is not None else None
        return images, np.stack(caps), np.stack(lens), bert_mask

    def _extract_global_features(self) -> None:
        """Train-mode feature pass over the public eval loader (the
        reference extracts in train() mode, MMFL.py:189-218), in chunks of
        ``SERVER_SCAN_CHUNK`` batches (``ServerEngine.extract_chunk``, a
        CUDA graph replay on the card); a ragged last batch takes the
        per-batch step, and so does every batch on a mesh (each rank its
        rows, the features gathered). The loader keeps that batch and pads
        nothing, so the valid rows are a prefix of the concatenation."""
        img_parts, txt_parts, index_parts = [], [], []
        n_valid = 0
        chunk = 1 if self.mesh is not None else SERVER_SCAN_CHUNK
        for group in stacked._chunks(iter(self.datasets["pub_eval"]),
                                     chunk):
            if len(group) == 1 or not stacked._uniform_batches(group):
                feats = [self.server.extract_step(
                    self.server_state, *self._server_inputs(batch))
                    for batch in group]
            else:
                img_f, txt_f = self.server.extract_chunk(
                    self.server_state, *self._stack_server_chunk(group))
                feats = list(zip(img_f, txt_f))
            for batch, (img_f, txt_f) in zip(group, feats):
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
    def _run_group(self, kind: str, members: List[ClientHandle],
                   round_n: int, img_vecs: List, txt_vecs: List,
                   owners: Optional[List[int]] = None) -> None:
        """One family's local training and uploads (the JAX package's
        ``_run_group``): per local epoch each member's task epoch, then one
        contrast epoch of the whole family; the local test (img/txt) before
        the reps sweep, which advances BN running stats that the test must
        not see; reps appended in member order.

        On a mesh, ``owners`` (default ``client_slots``) gives each
        member's rank: a rank runs its own members, then every member's
        state is broadcast from its owner; a member's reps stay on its
        owner (None in the others' lists)."""
        args = self.args
        engine = members[0].engine
        owners = owners or M.client_slots(self.mesh, len(members))
        rank = self.mesh.rank if self.mesh is not None else 0
        mine = [c for c, o in zip(members, owners) if o == rank]
        policy = getattr(args, "stack_bucket", "even")
        pad = stacked.stack_pad(len(members), policy)
        if self.mesh is not None:
            pad = (-len(members)) % self.mesh.world
            self.logger.log(
                f"{kind} family: client axis {len(members)}+{pad} pad slots "
                f"over {self.mesh.world} ranks, owners {owners}")
        elif pad:
            self.logger.log(
                f"{kind} family: client axis {len(members)}+{pad} pad slots "
                f"(stack bucket {policy}); the port runs no pad slot")
        old_models = [engine.snapshot(c.state) for c in mine]
        for c in members:
            engine.set_round_lr(c.state, round_n)
        do_inter = args.contrast_local_inter
        do_intra = args.contrast_local_intra
        img, txt = self.global_img_feature, self.global_txt_feature
        globals_ = {"img": {"same": img, "other": txt},
                    "txt": {"same": txt, "other": img},
                    "mm": {"img": img, "txt": txt}}[kind]
        for _ in range(args.local_epochs):
            stacked.task_epoch(engine, mine, mm=kind == "mm")
            if do_inter or do_intra:
                stacked.contrast_epoch(
                    engine, mine, old_models, self._pub("pub_train", kind),
                    globals_, self._batch_rows, do_inter, do_intra)
        if kind == "mm":
            img, txt = stacked.mm_reps(engine, mine,
                                       self._pub("pub_eval", "mm"))
            self._share_members(members, owners)
            img_vecs.extend(self._slots(owners, img))
            txt_vecs.extend(self._slots(owners, txt))
            return
        self._local_test(kind, members, owners)
        reps, order = stacked.uni_reps(engine, mine,
                                       self._pub("pub_eval", kind))
        assert order is None or np.array_equal(order, self.distill_index), \
            "public-set iteration order changed between phases"
        self._share_members(members, owners)
        (img_vecs if kind == "img" else txt_vecs).extend(
            self._slots(owners, reps))

    def _slots(self, owners: List[int], own_values) -> List:
        """Per member, this rank's value for it (``own_values`` in member
        order over this rank's members), or None where another rank owns
        it."""
        rank = self.mesh.rank if self.mesh is not None else 0
        values = iter(own_values)
        return [next(values) if o == rank else None for o in owners]

    def _share_members(self, members: List[ClientHandle],
                       owners: List[int]) -> None:
        """Every member's state (model, optimizer, step) from its owner to
        every rank."""
        if self.mesh is None:
            return
        for client, owner in zip(members, owners):
            M.broadcast_state(self.mesh, client.state, owner)

    def _local_test(self, kind: str, members: List[ClientHandle],
                    owners: List[int]) -> None:
        """Top-1/top-k on the family's local test set: counts stay on the
        device, one fetch for the family. On a mesh each member's owner
        tests it (another rank advances the test loader as that pass
        would), and the counts are summed over the ranks for rank 0's
        log."""
        test_loader = self.datasets.get(f"{kind}_test")
        if test_loader is None:
            return
        rank = self.mesh.rank if self.mesh is not None else 0
        counts = torch.zeros((len(members), 3), dtype=torch.float64,
                             device=self.device)
        for i, (client, owner) in enumerate(zip(members, owners)):
            if owner != rank:
                test_loader.skip_epoch()
                continue
            parts = [torch.stack(client.engine.test_step(client.state,
                                                         batch))
                     for batch in test_loader]
            if parts:
                counts[i] = torch.stack(parts).sum(0).double()
        M.all_reduce_sum(self.mesh, counts)
        for client, (c1, ck, n) in zip(members, counts.tolist()):
            if n:
                self.logger.log(
                    f"client {client.client_idx} ({kind}) "
                    f"top1 {100*c1/n:.2f} topk {100*ck/n:.2f}")

    # -- distillation ---------------------------------------------------
    def _distill(self, img_vecs: List[torch.Tensor],
                 txt_vecs: List[torch.Tensor]) -> None:
        """con_w, then one distillation epoch. Off a mesh ``img_reps`` and
        ``txt_reps`` hold the uploads stacked; on one, the lists of this
        rank's uploads with None in the others' slots."""
        args = self.args

        def gather(vecs):
            if not vecs:
                return None
            return vecs if self.mesh is not None else torch.stack(vecs)

        self.img_reps, self.txt_reps = gather(img_vecs), gather(txt_vecs)
        img_agg, txt_agg = aggregate_modalities(
            self.img_reps, self.txt_reps, self.global_img_feature,
            self.global_txt_feature, mesh=self.mesh)
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

    def _extract_eval_chunk(self, group):
        """k uniform batches -> flat [k * B, E] eval features
        (``ServerEngine.eval_chunk``)."""
        fi, ft = self.server.eval_chunk(self.server_state,
                                        *self._stack_server_chunk(group))
        return fi.flatten(0, 1), ft.flatten(0, 1)

    def evaluate(self) -> Dict:
        """Retrieval eval over the test loader; in chunks off a mesh, per
        batch on one (each rank its rows, the features gathered)."""
        chunk_fn = self._extract_eval_chunk if self.mesh is None else None
        return self.evaluator.evaluate(
            self.datasets["test"], self._extract_eval,
            extract_chunk_fn=chunk_fn)

    def _seed_round(self, round_n: int) -> random.Random:
        """Re-seed every per-round randomness source as a function of
        (seed, round): torch's generators (dropout), each loader's epoch
        order (``set_round``), and the client sampler returned. A straight
        run and one that ``resume``s at round R then draw the same streams
        from R on.

        The clients draw no device randomness (PIE's dropout rate is 0,
        the GRU has none, caption drop is host-side per sample and epoch),
        so the stacked and sequential branches, which run the clients'
        steps in different orders, need no counterpart of the JAX
        package's per-(round, client, epoch, step) keys
        (``_client_epoch_keys``): only the server's BERT dropout draws from
        torch's generator, in the same order in both branches. The two
        branches walk the shuffled public loader a different number of
        times a round (once per family or once per client), so their
        public-batch orders differ, in the JAX package as here."""
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
        global_features, clients_<kind> per family, aggregate_distill,
        eval) and ``round``, the whole round up to its scores (saving
        excluded)."""
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
        self.save_round(round_n)
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
        if getattr(args, "client_parallel", True):
            groups: Dict[str, List[ClientHandle]] = {}
            for client in cur:
                groups.setdefault(client.kind, []).append(client)
            runs = [(kind, members, f"Training {kind} clients "
                     f"{[c.client_idx for c in members]} "
                     f"(stacked x{len(members)})")
                    for kind, members in groups.items()]
            runs = [(kind, members, message, None)
                    for kind, members, message in runs]
        else:
            world = self.mesh.world if self.mesh is not None else 1
            runs = [(c.kind, [c], f"Training Client {c.client_idx} "
                     f"({c.kind})!", [k % world]) for k, c in enumerate(cur)]
        for kind, members, message, owners in runs:
            self.logger.log(message)
            with self.timer.phase(f"clients_{kind}"):
                self._run_group(kind, members, round_n, img_vecs, txt_vecs,
                                owners)
        if getattr(args, "save_client", False):
            self._save_clients(cur, round_n)

        if not args.disable_distill and (img_vecs or txt_vecs):
            if args.agg_method != "con_w":
                raise NotImplementedError(args.agg_method)
            self.logger.log("start distilling")
            with self.timer.phase("aggregate_distill"):
                self._distill(img_vecs, txt_vecs)

        with self.timer.phase("eval"):
            scores = self.evaluate()
        self.server.release_graphs()
        return scores

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

    def _save_clients(self, cur: List[ClientHandle], round_n: int) -> None:
        """--save_client: each trained client's model after the round's
        local training, named like the reference's
        ``saved_clients/<dset>/Client{k}-model_{local_epoch}.pth``
        (ClientTrainer.py:207-208, MMClientTrainer.py:106-107; its
        ``local_epoch`` counter accumulates ``local_epochs`` per round)."""
        local_epoch = (round_n + 1) * self.args.local_epochs
        root = os.path.join(getattr(self.args, "exp_dir", "."),
                            "saved_clients")
        for c in cur:
            save_checkpoint(
                os.path.join(root, c.kind,
                             f"Client{c.client_id}-model_{local_epoch}.ckpt"),
                {"model": c.state.model.state_dict(), "round": round_n + 1,
                 "kind": c.kind, "client_id": c.client_id})
        self.logger.log(f"saved {len(cur)} client snapshots under {root}")

    # -- round checkpoints ------------------------------------------------
    def save_round(self, round_n: int) -> Optional[str]:
        """With ``--ckpt_dir``: the server's and every client's model,
        criterion, optimizer and step, and the best score, as round
        ``round_n``'s checkpoint."""
        if self.checkpointer is None:
            return None
        path = self.checkpointer.save(round_n, {
            "server": self.server_state.state_dict(),
            "clients": [c.state.state_dict() for c in self.clients],
            "meta": {"best_score": self.best_score, "round": round_n}})
        M.barrier(self.mesh)  # rank 0 has written it
        return path

    def resume(self) -> int:
        """Restore the latest round checkpoint; returns the next round to
        run (0 when there is none)."""
        restored = (self.checkpointer.restore()
                    if self.checkpointer is not None else None)
        if restored is None:
            return 0
        if len(restored["clients"]) != len(self.clients):
            raise ValueError(
                f"checkpoint holds {len(restored['clients'])} clients, this "
                f"run has {len(self.clients)}")
        self.server_state.load_state_dict(restored["server"])
        for client, state in zip(self.clients, restored["clients"]):
            client.state.load_state_dict(state)
        self.best_score = float(restored["meta"].get("best_score", 0.0))
        next_round = int(restored["meta"]["round"]) + 1
        self.logger.log(f"resumed from round {next_round - 1}")
        return next_round

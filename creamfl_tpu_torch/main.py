"""CLI entry of the PyTorch/CUDA port (reference `src/main.py`).

Port of the JAX package's ``main.py``: the same flag surface
(``add_args``), ``build_configs``, ``build_datasets`` and ``run``. Runs on
the card (``--device N`` picks it) unless ``--no-cuda`` asks for the CPU;
without a card and without ``--no-cuda`` it raises.

Several cards make a mesh, as the JAX CLI takes every device
(``--no_mesh`` and ``--mesh_devices N`` keep their meaning): with more than
one card visible, ``run`` starts one process per card (NCCL) and each runs
the round as a rank of the mesh (``parallel/mesh.py``); under torchrun
(``torchrun --nproc_per_node N -m creamfl_tpu_torch.main ...``) each
process joins the group and runs on the card ``LOCAL_RANK`` names; inside
a process group already initialized, ``run`` is that group's rank. On the
CPU, ``--no-cuda --mesh_devices N`` starts N gloo processes (the JAX
tests' virtual CPU devices); without it the CPU runs one. Every rank takes
rank 0's ``--seed``; the synthetic BERT ids hash words with ``hash()``,
so the ranks need one ``PYTHONHASHSEED`` (``run`` sets it for the
processes it starts; under torchrun export it).

Without ``--synthetic`` it reads MS-COCO, CIFAR-100,
AG_NEWS and Flickr30k (``--coco_root``, ``--cifar_root``,
``--agnews_root``, ``--f30k_root``; defaults under ``$HOME/data``) with the
packaged frozen artifacts, and decodes and transforms their images on the
run's device; when a root is missing it falls back to ``--synthetic``.

Two rounds on the card, the paper's flags, stacked client families (the
default; ``--no_client_parallel`` runs the clients one by one), a round
checkpoint after each round:
  python -m creamfl_tpu_torch.main --synthetic --comm_rounds 2 \
      --local_epochs 1 --num_img_clients 2 --num_txt_clients 2 \
      --num_mm_clients 2 --client_num_per_round 6 \
      --img_model_local resnet18 --agg_method con_w \
      --contrast_local_inter --contrast_local_intra --ckpt_dir ck
The same command with ``--resume`` continues after the latest checkpoint.
On the repository's miniature real-format datasets, on the CPU:
  python -m creamfl_tpu_torch.main --no-cuda --smoke \
      --coco_root tests/fixtures/coco --cifar_root tests/fixtures/cifar \
      --agnews_root tests/fixtures/agnews --f30k_root tests/fixtures/f30k \
      --coco_subset_idx tests/fixtures/coco_subset_idx --pub_data_num 8 \
      --comm_rounds 1 --local_epochs 1 --num_img_clients 2 \
      --num_txt_clients 2 --num_mm_clients 2 --client_num_per_round 6 \
      --batch_size 8 --feature_dim 16 --not_bert --agg_method con_w \
      --contrast_local_inter --contrast_local_intra --partition_dir parts
where ``parts/`` holds a copy of
``tests/fixtures/partitions/client_noniid_flicker30k.pkl`` (the packaged
partitions index the full datasets; the CIFAR and AG_NEWS ones are
regenerated there). ``--smoke`` lets the miniature annotation files miss
frozen ids.
The same on the CPU at small shapes: add ``--no-cuda --smoke``. At the
paper's geometry (a 50 000-row public set at 224², its images synthesized
on the card): add ``--paper_scale``; ``--client_bf16`` runs the image
clients' trunks in bf16, and ``--resnet_ckpt``, ``--bert_ckpt``,
``--glove_path`` and ``--client_resnet_ckpt`` load weights from local
files. ``--text_encoder deepseek_v2_lite`` or ``granite_4_0_h_small``
(with ``--synthetic``) puts the DeepSeek-V2-Lite or Granite-4.0-H-Small
tower in BERT's place in the server (``--smoke``: a tiny one;
``models/towers.py``). ``--trace_dir DIR`` records the program's spans
and counters (``utils/profiling.py``) and writes each round's as a Chrome
trace-event file there, on ``torch.profiler``'s clock.
"""

from __future__ import annotations

import argparse
import os
import random


def add_args(parser: argparse.ArgumentParser) -> None:
    from creamfl_tpu_torch.models.towers import TOWERS

    # -- reference flag surface (src/main.py:38-106) -------------------
    parser.add_argument('--name', type=str, default='Test',
                        help='The name for different experimental runs.')
    parser.add_argument('--exp_dir', type=str, default='./experiments/',
                        help='Locations to save different experimental runs.')
    parser.add_argument('--local_epochs', type=int, default=5)
    parser.add_argument('--comm_rounds', type=int, default=30)
    parser.add_argument('--model', type=str, default='resnet34',
                        help='Target model name')
    parser.add_argument('--img_model_local', type=str, default='resnet10')
    parser.add_argument('--pretrained', type=int, default=0)
    parser.add_argument('--no-cuda', action='store_true', default=False,
                        help='run on the CPU instead of the card')
    parser.add_argument('--seed', type=int,
                        default=random.randint(0, 100000))
    parser.add_argument('--device', type=int, default=0,
                        help='CUDA ordinal of the card to run on')
    parser.add_argument('--num_img_clients', type=int, default=10)
    parser.add_argument('--num_txt_clients', type=int, default=10)
    parser.add_argument('--num_mm_clients', type=int, default=15)
    parser.add_argument('--client_num_per_round', type=int, default=10)
    parser.add_argument('--dataset', type=str, default='cifar100',
                        choices=['svhn', 'cifar10', 'cifar100'])
    parser.add_argument('--data_root', type=str,
                        default=os.environ.get('HOME', '.') + "/data/")
    parser.add_argument('--batch_size', type=int, default=64)
    parser.add_argument('--alpha', type=float, default=0.5)
    parser.add_argument('--server_lr', type=float, default=0.0002)
    parser.add_argument('--lr', type=float, default=0.1)
    parser.add_argument('--loss', type=str, default='l1',
                        choices=['l1', 'kl', 'l1softmax'])
    parser.add_argument('--scheduler', type=str, default='multistep',
                        choices=['multistep', 'cosine', 'exponential',
                                 'none'])
    parser.add_argument('--steps', nargs='+',
                        default=[0.05, 0.15, 0.3, 0.5, 0.75], type=float)
    parser.add_argument('--scale', type=float, default=0.1)
    parser.add_argument('--weight_decay', type=float, default=5e-4)
    parser.add_argument('--momentum', type=float, default=0.9)
    parser.add_argument('--log_interval', type=int, default=10)
    parser.add_argument('--save_interval', type=int, default=10)
    parser.add_argument('--disable_distill', action="store_true",
                        default=False)
    parser.add_argument('--agg_method', type=str, default='con_w')
    parser.add_argument('--contrast_local_intra', action="store_true",
                        default=False)
    parser.add_argument('--contrast_local_inter', action="store_true",
                        default=False)
    parser.add_argument('--mlp_local', action="store_true", default=False)
    parser.add_argument('--kd_weight', type=float, default=0.3)
    parser.add_argument('--interintra_weight', type=float, default=0.5)
    parser.add_argument('--loss_scale', action='store_true', default=False)
    parser.add_argument('--save_client', action='store_true',
                        default=False)
    parser.add_argument('--data_local', action='store_true', default=False)
    parser.add_argument('--pub_data_num', type=int, default=50000)
    parser.add_argument('--feature_dim', type=int, default=256)
    parser.add_argument('--not_bert', action='store_true', default=False)
    parser.add_argument('--text_encoder', type=str, default='bert',
                        choices=list(TOWERS),
                        help="the server's text tower: BERT-base, "
                             "DeepSeek-V2-Lite (14 of its 27 layers, "
                             "experts 0-7 of each layer's 64) or "
                             "Granite-4.0-H-Small (10 of its 40 layers, "
                             "experts 0-8 of each layer's 72); the "
                             "decoders with --synthetic only and random "
                             "weights; --not_bert takes the GRU branch "
                             "instead")

    # -- the JAX package's extensions (same names and defaults) -------
    parser.add_argument('--synthetic', action='store_true', default=False,
                        help='use synthetic datasets (no real data needed)')
    parser.add_argument('--smoke', action='store_true', default=False,
                        help='tiny shapes: small models/images/public set')
    parser.add_argument('--paper_scale', action='store_true',
                        default=False,
                        help='full paper geometry on synthetic data: '
                             '50k public set @224px, R101+BERT, 25k-'
                             'caption retrieval eval (images '
                             'synthesized on the device)')
    parser.add_argument('--coco_root', type=str, default=None)
    parser.add_argument('--cifar_root', type=str, default=None)
    parser.add_argument('--agnews_root', type=str, default=None)
    parser.add_argument('--f30k_root', type=str, default=None)
    parser.add_argument('--vocab_path', type=str, default=None)
    parser.add_argument('--bert_vocab', type=str, default=None)
    parser.add_argument('--wandb', action='store_true', default=False)
    parser.add_argument('--ckpt_dir', type=str, default=None,
                        help='round-checkpoint directory (enables resume)')
    parser.add_argument('--trace_dir', type=str, default=None,
                        help='write each round\'s spans and counters as a '
                             'Chrome trace-event file '
                             '(round<N>[.rank<k>].spans.json) into this '
                             'directory')
    parser.add_argument('--no_client_parallel', dest='client_parallel',
                        action='store_false', default=True,
                        help='disable stacked client-parallel execution')
    parser.add_argument('--no_mesh', dest='use_mesh',
                        action='store_false', default=True,
                        help='disable the multi-device mesh (single-'
                             'device execution even on a slice)')
    parser.add_argument('--mesh_devices', type=int, default=0,
                        help='cap the mesh to the first N devices '
                             '(0 = all)')
    parser.add_argument('--stack_bucket', type=str, default='even',
                        choices=['none', 'even', 'pow2'],
                        help='single-device family-stack padding policy:'
                             ' bucket sampled family sizes to stable '
                             'shapes so rounds reuse compiled programs '
                             '(pad slots are masked)')
    parser.add_argument('--coco_subset_idx', type=str, default=None,
                        help='frozen public-subset index file (default: '
                             'the packaged reference artifact)')
    parser.add_argument('--partition_dir', type=str, default=None,
                        help='client partition pickles of the real data '
                             '(default: the packaged frozen partitions); '
                             'partitions missing there are regenerated '
                             'and written there')
    parser.add_argument('--resnet_ckpt', type=str, default=None,
                        help='torchvision ResNet state_dict (.pth) for the '
                             'server image trunk')
    parser.add_argument('--bert_ckpt', type=str, default=None,
                        help='HF bert-base-uncased state_dict (.pth/.bin)')
    parser.add_argument('--glove_path', type=str, default=None,
                        help='GloVe text vectors for GRU text encoders')
    parser.add_argument('--client_resnet_ckpt', type=str, default=None,
                        help='torchvision resnet state_dict for image '
                             'client trunks')
    parser.add_argument('--data_backend', type=str, default='array',
                        choices=['array', 'grain'],
                        help='host input pipeline backend')
    parser.add_argument('--num_workers', type=int, default=0,
                        help='grain worker processes for the input '
                             'pipeline')
    parser.add_argument('--client_bf16', action='store_true',
                        default=False,
                        help='bf16 conv compute for image client trunks')
    parser.add_argument('--coco_client', type=int, default=-1,
                        help='per-client COCO shard index '
                             '(load_datasets.py client>-1 path)')
    parser.add_argument('--resume', action='store_true', default=False,
                        help='resume from the latest round checkpoint')
    parser.add_argument('--cosine_t_max', type=int, default=0,
                        help='override the cosine schedule T_max '
                             '(0 = yaml value, 30, like the reference)')


def text_config(args):
    """The server's text tower config (``models/towers.py``) under
    ``--text_encoder``: ``BertConfig`` by default, a decoder tower's
    config otherwise; tiny under ``--smoke``."""
    from creamfl_tpu_torch.models.towers import TOWERS

    name = getattr(args, "text_encoder", "bert")
    tower = TOWERS[name]
    if tower.decoder and args.not_bert:
        raise ValueError(f"--not_bert takes the GRU text branch; it does "
                         f"not go with --text_encoder {name}")
    return tower.config.tiny() if args.smoke else tower.config()


def build_configs(args):
    """Server and mm-client configs with the reference's runtime overrides
    (MMFL.py:81-88,157-163), and the server's text tower config
    (``text_config``)."""
    from creamfl_tpu_torch.config import default_config_path, parse_config

    server = parse_config(default_config_path("coco.json"),
                          strict_cast=False)
    server.model.embed_dim = args.feature_dim
    server.model.not_bert = bool(args.not_bert)
    server.model.cnn_type = ('resnet50' if args.not_bert else 'resnet101')
    server.optimizer.learning_rate = args.server_lr
    # Reference parity: the config's T_max (30) is kept whatever
    # --comm_rounds says; --cosine_t_max overrides it.
    if getattr(args, 'cosine_t_max', 0):
        server.lr_scheduler.T_max = args.cosine_t_max

    mm = parse_config(default_config_path("f30k.json"), strict_cast=False)
    mm.model.embed_dim = args.feature_dim
    mm.model.not_bert = True
    if getattr(args, 'cosine_t_max', 0):
        mm.lr_scheduler.T_max = args.cosine_t_max

    if args.smoke:
        server.model.cnn_type = 'resnet10'
        mm.model.cnn_type = 'resnet10'
        server.model.word_dim = 32
        mm.model.word_dim = 32
    return server, mm, text_config(args)


def build_datasets(args, device=None):
    """The real bundle from the data roots, or, with ``--synthetic`` or when
    a root is missing, the synthetic bundle at ``--smoke``,
    ``--paper_scale`` or the default scale (the JAX package's
    `creamfl_tpu/main.py:186-230`). Real images and ``--paper_scale``'s
    synthesized ones are made on ``device`` (default: the run's,
    ``--no-cuda`` / ``--device``)."""
    from creamfl_tpu_torch.data import pipelines
    from creamfl_tpu_torch.data.tokenize import (BertWordPieceTokenizer,
                                                 SyntheticLMTokenizer)
    from creamfl_tpu_torch.models.towers import TOWERS

    name = getattr(args, "text_encoder", "bert")
    decoder = TOWERS[name].decoder
    if decoder and not args.synthetic:
        raise ValueError(f"--text_encoder {name} reads captions through "
                         f"the model's own tokenizer, whose tokenizer.json "
                         f"is not in the repository: add --synthetic")
    if not args.synthetic:
        try:
            home = os.environ.get('HOME', '.')
            return pipelines.build_real_datasets(
                args,
                vocab_path=args.vocab_path,  # None: packaged frozen vocab
                coco_root=args.coco_root or f"{home}/data/mmdata/MSCOCO/2014",
                cifar_root=args.cifar_root or f"{home}/data/cifar100",
                agnews_root=args.agnews_root or f"{home}/data",
                f30k_root=args.f30k_root or f"{home}/data/f30k",
                bert_vocab=args.bert_vocab,
                partition_dir=getattr(args, "partition_dir", None),
                device=device or _run_device(args))
        except FileNotFoundError as e:
            print(f"real datasets unavailable ({e}); "
                  f"falling back to --synthetic")
    if args.not_bert:
        bert_tok = None
    elif decoder:
        cfg = text_config(args)
        bert_tok = SyntheticLMTokenizer(cfg.bos_token_id, cfg.eos_token_id)
    else:
        bert_tok = BertWordPieceTokenizer.synthetic()
    if args.smoke:
        scale = dict(pub_size=128, image_size=64, max_len=12,
                     client_data_size=64, test_size=32,
                     retrieval_test_size=60)
    elif getattr(args, "paper_scale", False):
        # The paper's geometry: the public set at 224² (--pub_data_num
        # rows), CIFAR-resolution image clients, 2 000-caption mm clients,
        # a COCO-5K-sized retrieval test. Caption sets are pre-rendered
        # into host arrays and prefetched on a thread; their images are
        # synthesized on the device (data/device_synth.py).
        scale = dict(pub_size=args.pub_data_num, image_size=224,
                     max_len=32, client_data_size=5000,
                     mm_client_data_size=2000, test_size=1024,
                     retrieval_test_size=25000, cache=True,
                     client_image_size=32, prefetch=2,
                     device_images=True, pub_batch_size=128,
                     pub_eval_batch_size=256,
                     device=device or _run_device(args))
    else:
        scale = dict(pub_size=min(args.pub_data_num, 2048),
                     image_size=224, max_len=32, client_data_size=512,
                     test_size=256, retrieval_test_size=500,
                     pub_batch_size=128, pub_eval_batch_size=256)
    return pipelines.build_synthetic_datasets(args,
                                              bert_tokenizer=bert_tok,
                                              **scale)


def _run_device(args):
    """The run's device: the card ``--device`` names, or the CPU under
    ``--no-cuda``; raises when the card is asked for and there is none."""
    from creamfl_tpu_torch.utils.device import resolve_device

    return resolve_device("cpu" if args.no_cuda else f"cuda:{args.device}")


def _spawn_world(args) -> int:
    """Processes ``run`` starts itself: one per visible card (at most
    ``--mesh_devices``), or ``--mesh_devices`` on the CPU; 0 inside a
    process group, under torchrun, with ``--no_mesh`` or for one."""
    import torch
    import torch.distributed as dist

    if (not getattr(args, "use_mesh", True) or dist.is_initialized()
            or "WORLD_SIZE" in os.environ):
        return 0
    cap = getattr(args, "mesh_devices", 0) or 0
    if args.no_cuda:
        world = cap
    else:
        n = torch.cuda.device_count()
        world = min(n, cap or n)
    return world if world > 1 else 0


def _free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _rank_main(rank: int, args, world: int, init_method: str) -> None:
    """A process ``run`` started: rank ``rank`` of ``world``, on card
    ``rank`` (NCCL) or the CPU (gloo)."""
    import torch.distributed as dist

    from creamfl_tpu_torch.parallel.mesh import init_distributed

    init_distributed(init_method, world, rank,
                     device="cpu" if args.no_cuda else f"cuda:{rank}")
    try:
        run(args)
    finally:
        dist.destroy_process_group()


def _mesh(args):
    """This process's mesh: the initialized group's, or torchrun's (joined
    here); None outside both."""
    import torch
    import torch.distributed as dist

    from creamfl_tpu_torch.parallel.mesh import init_distributed, make_mesh

    if "WORLD_SIZE" in os.environ and not dist.is_initialized():
        if int(os.environ["WORLD_SIZE"]) > 1 and not getattr(
                args, "use_mesh", True):
            raise ValueError("--no_mesh runs one process; start it without "
                             "torchrun")
        init_distributed(device="cpu" if args.no_cuda else "cuda")
    if not dist.is_initialized():
        return None
    device = ("cpu" if args.no_cuda
              else f"cuda:{torch.cuda.current_device()}")
    mesh = make_mesh(device)
    return mesh if mesh.world > 1 else None


def _traced_round(algo, round_n: int, trace_dir: str, mesh) -> str:
    """Round ``round_n`` with the recorder on; its spans and counters go
    to ``<trace_dir>/round<N>[.rank<k>].spans.json`` (N counted from 1, as
    the log's rounds are)."""
    import json

    from creamfl_tpu_torch.utils import profiling

    with profiling.recording() as snap:
        algo.train(round_n)
    rank = f".rank{mesh.rank}" if mesh is not None else ""
    os.makedirs(trace_dir, exist_ok=True)
    path = os.path.join(trace_dir, f"round{round_n + 1}{rank}.spans.json")
    with open(path, "w") as f:
        json.dump(snap.chrome_trace(), f)
    return path


def run(args):
    """One federated run; returns the ``MMFL`` it drove, or None where it
    started one process per card (or per CPU rank) and waited for them."""
    import torch.multiprocessing as mp

    from creamfl_tpu_torch.federation.rounds import MMFL
    from creamfl_tpu_torch.parallel.mesh import broadcast_object
    from creamfl_tpu_torch.utils.helper import set_seed
    from creamfl_tpu_torch.utils.logging import PythonLogger, get_tracker

    world = _spawn_world(args)
    if world:
        # The children inherit it: one hash() of a word on every rank.
        os.environ.setdefault("PYTHONHASHSEED", str(args.seed))
        mp.spawn(_rank_main, args=(args, world,
                                   f"tcp://localhost:{_free_port()}"),
                 nprocs=world, join=True)
        return None
    mesh = _mesh(args) if getattr(args, "use_mesh", True) else None
    device = mesh.device if mesh is not None else _run_device(args)
    if mesh is not None:
        args.seed = broadcast_object(mesh, args.seed, 0)
    # Seed the global python/numpy/torch generators like the reference
    # (main.py:122 -> helper.set_seed).
    set_seed(args.seed)
    os.makedirs(args.exp_dir, exist_ok=True)
    logger = PythonLogger(output_file=os.path.join(args.exp_dir,
                                                   f"{args.name}.log"))
    tracker = get_tracker(args.name, enabled=args.wandb)
    server_cfg, mm_cfg, bert_cfg = build_configs(args)
    datasets = build_datasets(args, device)

    algo = MMFL(args, datasets, server_cfg, mm_cfg, tracker=tracker,
                logger=logger, bert_config=bert_cfg, device=device,
                mesh=mesh)
    start_round = algo.resume() if args.resume else 0
    for round_n in range(start_round, args.comm_rounds):
        if args.trace_dir:
            _traced_round(algo, round_n, args.trace_dir, mesh)
        else:
            algo.train(round_n)
    logger.log("Best:")
    if algo.best_scores is not None:
        logger.log_dict({
            "best_epoch": algo.best_metadata["best_epoch"],
            "best_rsum_r1": algo.best_metadata["best_score"],
        })
    return algo


def parse_args(argv=None) -> argparse.Namespace:
    parser = argparse.ArgumentParser(description='Federated Learning')
    add_args(parser)
    return parser.parse_args(argv)


def cli() -> None:
    run(parse_args())


if __name__ == "__main__":
    cli()

"""The port imports neither JAX nor the JAX package.

A fresh interpreter imports every module of ``creamfl_tpu_torch`` (and
``chip_smoke``) and lists what got loaded. ``creamfl_tpu_torch`` itself
starts with ``creamfl_tpu``, so the check matches the JAX package by its
exact name or its ``creamfl_tpu.`` prefix, not by a plain prefix. PyYAML,
``transformers`` and ``grain`` are not loaded either: the GPU machine
lacks them. Nor is PIL: the port decodes JPEG files with nvJPEG on the
card and imports PIL only to decode on the CPU, at the first such call.
The walk finds new modules by itself.

The port's entry points run on the card unless the caller asks for the
CPU: without a card, ``MMFL``, the text and mm client engines and the
CLI's ``run`` raise unless given ``device="cpu"`` / ``--no-cuda``.
"""

import json
import os
import subprocess
import sys

import pytest
import torch
from torch_cpu_share import torch_cpu_share  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_PROBE = r"""
import importlib, json, pkgutil, sys
import creamfl_tpu_torch
names = ["creamfl_tpu_torch", "chip_smoke"] + [
    m.name for m in pkgutil.walk_packages(creamfl_tpu_torch.__path__,
                                          "creamfl_tpu_torch.")]
for name in names:
    importlib.import_module(name)
print(json.dumps({"imported": names, "loaded": sorted(sys.modules)}))
"""


def _is_forbidden(name: str) -> bool:
    root = name.split(".")[0]
    return (root in ("jax", "jaxlib", "flax", "optax", "chex", "yaml",
                     "transformers", "grain", "PIL")
            or root.startswith("jax_") or root == "creamfl_tpu")


def test_port_imports_no_jax_and_no_jax_package():
    env = dict(os.environ, PYTHONPATH=REPO)
    out = subprocess.run([sys.executable, "-c", _PROBE], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=300,
                         check=True).stdout
    result = json.loads(out.strip().splitlines()[-1])
    assert len(result["imported"]) >= 50, result["imported"]
    for name in ("creamfl_tpu_torch.main", "creamfl_tpu_torch.data.pipelines",
                 "creamfl_tpu_torch.federation.rounds",
                 "creamfl_tpu_torch.federation.stacked",
                 "creamfl_tpu_torch.utils.checkpoint",
                 "creamfl_tpu_torch.utils.serialize",
                 "creamfl_tpu_torch.engine.evaluator",
                 "creamfl_tpu_torch.engine.graphs",
                 "creamfl_tpu_torch.data.native",
                 "creamfl_tpu_torch.data.png_gif",
                 "creamfl_tpu_torch.parallel.mesh",
                 "creamfl_tpu_torch.data.grain_loaders",
                 "creamfl_tpu_torch.data.cub",
                 "creamfl_tpu_torch.data.make_vocab",
                 "creamfl_tpu_torch.models.uncertainty",
                 "creamfl_tpu_torch.losses.factory"):
        assert name in result["imported"], name
    bad = [m for m in result["loaded"] if _is_forbidden(m)]
    assert not bad, bad


def test_port_reads_nothing_under_native():
    """The native tokenizer is the port's own: its source is under
    ``creamfl_tpu_torch/csrc/`` and its library under the package's
    ``_build/``; no file of the port or ``chip_smoke.py`` names the JAX
    package's ``native/`` directory or its library."""
    from pathlib import Path

    from creamfl_tpu_torch.data import native
    from creamfl_tpu_torch.ops import build

    pkg = Path(REPO, "creamfl_tpu_torch")
    assert native.SOURCE.parent == pkg / "csrc" == build.CSRC
    assert build.BUILD_ROOT.parent == pkg
    files = [Path(REPO, "chip_smoke.py")] + [
        f for ext in ("*.py", "*.cpp", "*.cu", "*.cuh")
        for f in pkg.rglob(ext)]
    for path in files:
        text = path.read_text()
        for needle in ("native/", '"native"', "'native'",
                       "libcreamfl_native", "creamfl_native.cpp"):
            assert needle not in text, (path, needle)


def test_forbidden_name_check():
    assert _is_forbidden("creamfl_tpu")
    assert _is_forbidden("creamfl_tpu.ops.gallery")
    assert _is_forbidden("jax.numpy") and _is_forbidden("flax.linen")
    assert _is_forbidden("yaml") and _is_forbidden("transformers.models")
    assert _is_forbidden("grain.python") and _is_forbidden("PIL.Image")
    assert not _is_forbidden("creamfl_tpu_torch")
    assert not _is_forbidden("creamfl_tpu_torch.ops.gallery")


# Port test modules left at torch's default threads: their tests pass
# there and fail under the pin (test_features_match: the port's features
# against the JAX package's, both fp32, summed in another order; at one
# thread its worst element is 3.9e-7 past its bound).
CPU_SHARE_EXEMPT = ("test_torch_client_uni.py",)


def test_port_test_modules_take_their_cpu_share():
    """Every ``tests/test_torch_*.py`` imports ``torch_cpu_share`` (its
    tests then run on the worker's share of the cores), except the modules
    in ``CPU_SHARE_EXEMPT``, which do not."""
    from pathlib import Path

    line = "from torch_cpu_share import torch_cpu_share  # noqa: F401\n"
    files = sorted(Path(REPO, "tests").glob("test_torch_*.py"))
    assert len(files) >= 40
    for path in files:
        pinned = line in path.read_text()
        assert pinned == (path.name not in CPU_SHARE_EXEMPT), path.name
    assert all(Path(REPO, "tests", name).exists()
               for name in CPU_SHARE_EXEMPT)


def _no_card_args():
    import types

    return types.SimpleNamespace(
        feature_dim=8, mlp_local=False, img_model_local="resnet6",
        interintra_weight=0.5, loss_scale=False, client_parallel=False,
        kd_weight=0.3, num_img_clients=0, num_txt_clients=0,
        num_mm_clients=0, seed=0)


def test_round_entry_points_need_a_card_or_the_cpu_asked_for():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the entry points run on it")
    from creamfl_tpu_torch import main
    from creamfl_tpu_torch.config import default_config_path, parse_config
    from creamfl_tpu_torch.engine.client_mm import MMClientEngine
    from creamfl_tpu_torch.engine.client_uni import UniClientEngine
    from creamfl_tpu_torch.federation.rounds import MMFL
    from creamfl_tpu_torch.models.bert import BertConfig

    args = _no_card_args()
    f30k = parse_config(default_config_path("f30k.json"),
                        model__embed_dim=8, model__cnn_type="resnet6")
    coco = parse_config(default_config_path("coco.json"),
                        model__embed_dim=8, model__cnn_type="resnet6",
                        model__not_bert=True)
    datasets = {"vocab": list(range(20))}
    with pytest.raises(RuntimeError, match="device='cpu'"):
        UniClientEngine("txt", 4, args, vocab_size=20)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        MMClientEngine(f30k, 20, args)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        MMFL(args, datasets, coco, f30k, bert_config=BertConfig.tiny())
    cli = main.parse_args(["--synthetic", "--smoke", "--no_client_parallel",
                           "--exp_dir", "unused"])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        main.run(cli)
    # Asked for the CPU, they build.
    assert UniClientEngine("txt", 4, args, vocab_size=20,
                           device="cpu").device.type == "cpu"
    assert MMClientEngine(f30k, 20, args, device="cpu").device.type == "cpu"
    algo = MMFL(args, datasets, coco, f30k, bert_config=BertConfig.tiny(),
                device="cpu")
    assert algo.device.type == "cpu" and algo.clients == []
    assert not os.path.exists(os.path.join(REPO, "unused"))


def test_cli_without_synthetic_raises(tmp_path, capsys):
    """Without --synthetic the CLI reads the real datasets (the readers
    are ported; the refusal this test held is gone): on the
    fixture roots it builds the real bundle on the device asked for, and
    without a card and without --no-cuda it raises; missing roots fall back
    to the synthetic bundle with the JAX package's message."""
    import shutil

    from creamfl_tpu_torch import main
    from creamfl_tpu_torch.data import pipelines

    fix = os.path.join(REPO, "tests", "fixtures")
    parts = tmp_path / "parts"
    parts.mkdir()
    shutil.copy(os.path.join(fix, "partitions",
                             "client_noniid_flicker30k.pkl"), parts)
    real = ["--smoke", "--coco_root", os.path.join(fix, "coco"),
            "--cifar_root", os.path.join(fix, "cifar"), "--agnews_root",
            os.path.join(fix, "agnews"), "--f30k_root",
            os.path.join(fix, "f30k"), "--coco_subset_idx",
            os.path.join(fix, "coco_subset_idx"), "--partition_dir",
            str(parts), "--pub_data_num", "8", "--num_img_clients", "1",
            "--num_txt_clients", "1", "--num_mm_clients", "1"]
    ds = main.build_datasets(main.parse_args(["--no-cuda"] + real))
    assert ds["synthetic"] is False
    batch = next(iter(ds["pub_train"]))
    assert batch["images"].device.type == "cpu"
    assert tuple(batch["images"].shape[1:]) == (224, 224, 3)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            main.build_datasets(main.parse_args(real))
    missing = str(tmp_path / "absent")
    ds = main.build_datasets(main.parse_args(
        ["--no-cuda", "--smoke", "--coco_root", missing]))
    assert ds["synthetic"] is True
    out = capsys.readouterr().out
    assert "real datasets unavailable" in out and missing in out
    assert "falling back to --synthetic" in out
    # --paper_scale: the fallback (and --synthetic) synthesize the bundle's
    # images on the device asked for.
    for flags in (["--coco_root", missing], ["--synthetic"]):
        seen = {}
        mp = pytest.MonkeyPatch()
        mp.setattr(pipelines, "build_synthetic_datasets",
                   lambda args, **kw: seen.update(kw))
        try:
            main.build_datasets(main.parse_args(
                ["--no-cuda", "--paper_scale"] + flags))
        finally:
            mp.undo()
        assert seen["device_images"] and seen["device"] == torch.device("cpu")

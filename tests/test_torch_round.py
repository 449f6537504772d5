"""The port's federated round (``MMFL.train``, sequential clients) vs the
JAX package's, from the same weights, and the port's CLI.

One round at ``test_federation_e2e.py``'s sizes: resnet10 trunks,
word_dim 8, ``--not_bert`` server, feature_dim 16, a 16-row public set at
32², one client of each kind, the paper's flags (con_w, inter + intra
contrast). fp32 on both sides (``use_bf16`` off), no dropout anywhere
(the GRU server branch has none, PIE's rate is 0). The JAX ``MMFL`` runs
with ``client_parallel=False``; its initial server and client states are
carried into the port's ``MMFL`` by ``models.convert`` and
``MMFL.load_state_dicts``. Both build their datasets from the same seed:
the batches are bit-equal (``test_torch_data.py``).

Tolerances. Sampled clients, their order and the distill index: exact.
The server's parameters after the round (2 train and 2 distill AdamP
steps at lr 1e-4, which move no entry by more than ~1e-3) are held
through their update, as ``test_torch_server.py`` holds them: per tensor,
the port's p - p0 lies within 0.1 (relative Frobenius norm) of the JAX
package's, so a round that trained or distilled nothing, or against the
wrong rows, fails. Global features, each client's uploaded reps, both
con_w aggregates, the server's BN stats and the eval features: rtol and
atol 2e-3 of the largest entry (the server test's bound on features and
BN stats after an AdamP update: AdamP moves every entry by about +-lr, so
an entry whose gradient is zero up to rounding may step the other way in
one framework), or twice the port's own spread, whichever is larger: the
port's round is run a second time from start weights perturbed by 1e-7
(relative), and where rounding alone moves a quantity further than 2e-3
(the mm client's image reps, ~5.6e-3 at these sizes: first AdamP steps
on a batch-8 BatchNorm trunk) the bound is twice that spread. R@k within
one rank step (100 / number of queries).
"""

import os
import re
import subprocess
import sys
import types

import jax
import numpy as np
import pytest
import torch

from creamfl_tpu.data.pipelines import build_synthetic_datasets as j_build
from creamfl_tpu.federation.rounds import MMFL as JMMFL
from creamfl_tpu.main import build_configs as j_build_configs
from creamfl_tpu_torch.data.pipelines import build_synthetic_datasets
from creamfl_tpu_torch.federation.rounds import MMFL
from creamfl_tpu_torch.main import build_configs
from creamfl_tpu_torch.models.convert import (flax_image_client_to_torch,
                                              flax_server_state_to_torch,
                                              flax_text_client_to_torch)
from torch_cpu_share import torch_cpu_share  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
AFTER_UPDATE = 2e-3
UPDATE_DIST = 0.1
SIZES = dict(pub_size=16, image_size=32, max_len=8, client_data_size=8,
             test_size=8, retrieval_test_size=20, batch_size=8)


def _args(tmp_path, **kw):
    ns = types.SimpleNamespace(
        name="t", exp_dir=str(tmp_path), local_epochs=1, comm_rounds=1,
        img_model_local="resnet10", seed=3, num_img_clients=1,
        num_txt_clients=1, num_mm_clients=1, client_num_per_round=3,
        batch_size=8, alpha=0.5, server_lr=1e-4, disable_distill=False,
        agg_method="con_w", contrast_local_intra=True,
        contrast_local_inter=True, mlp_local=False, kd_weight=0.3,
        interintra_weight=0.5, loss_scale=False, save_client=False,
        pub_data_num=32, feature_dim=16, not_bert=True, smoke=True,
        synthetic=True, client_parallel=False, use_mesh=False,
        ckpt_dir=None, wandb=False)
    for k, v in kw.items():
        setattr(ns, k, v)
    return ns


def _configs(build, args):
    server, mm, bert = build(args)
    for cfg in (server, mm):
        cfg.model.cnn_type = "resnet10"
        cfg.model.word_dim = 8
        cfg.train.use_bf16 = False
    return server, mm, bert


class _Log:
    """A logger that keeps its lines."""

    def __init__(self):
        self.lines = []

    def log(self, msg, level=None):
        self.lines.append(msg)

    def report(self, step, metrics, prefix=""):
        self.lines.append((step, dict(metrics)))

    def log_dict(self, d, prefix=""):
        self.lines.append(dict(d))


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _client_state_dicts(jalgo):
    out = []
    for c in jalgo.clients:
        params, stats = _np(c.state.params), _np(c.state.batch_stats)
        if c.kind == "img":
            out.append(flax_image_client_to_torch(params, stats))
        elif c.kind == "txt":
            out.append(flax_text_client_to_torch(params, stats))
        else:
            out.append(flax_server_state_to_torch(params, stats))
    return out


def _perturbed(sd, gen):
    return {k: (v * (1 + 1e-7 * torch.randn(v.shape, generator=gen))
                if v.is_floating_point() and "running_" not in k else v)
            for k, v in sd.items()}


def _port_round(tmp, server_sd, client_sds):
    args = _args(tmp)
    server, mm, bert = _configs(build_configs, args)
    log = _Log()
    algo = MMFL(args, build_synthetic_datasets(args, **SIZES), server, mm,
                bert_config=bert, logger=log, device="cpu")
    algo.load_state_dicts(server=server_sd, clients=client_sds)
    evals = []
    _record(algo.evaluator, "extract_features", evals)
    scores = algo.train(0)
    return algo, log, evals, scores


def _record(obj, name, store):
    """Wrap obj.name so that its call's arguments and result are kept."""
    fn = getattr(obj, name)

    def wrapped(*a, **kw):
        out = fn(*a, **kw)
        store.append((a, out))
        return out

    setattr(obj, name, wrapped)


@pytest.fixture(scope="module")
def rounds(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("round")
    # ---- JAX ------------------------------------------------------------
    jargs = _args(tmp / "jax")
    jserver, jmm, jbert = _configs(j_build_configs, jargs)
    jlog = _Log()
    jalgo = JMMFL(jargs, j_build(jargs, **SIZES), jserver, jmm,
                  bert_config=jbert, logger=jlog)
    server_sd = flax_server_state_to_torch(_np(jalgo.server_state.params),
                                           _np(jalgo.server_state.batch_stats))
    client_sds = _client_state_dicts(jalgo)
    j_distill, j_eval = [], []
    _record(jalgo, "_distill", j_distill)
    _record(jalgo.evaluator, "extract_features", j_eval)
    jscores = jalgo.train(0)
    # ---- port, and the port from perturbed weights ------------------------
    talgo, tlog, t_eval, tscores = _port_round(tmp / "port", server_sd,
                                               client_sds)
    gen = torch.Generator().manual_seed(1)
    palgo, _, p_eval, _ = _port_round(
        tmp / "perturbed", _perturbed(server_sd, gen),
        [_perturbed(sd, gen) for sd in client_sds])
    return dict(jalgo=jalgo, talgo=talgo, palgo=palgo, jscores=jscores,
                tscores=tscores, jlog=jlog, tlog=tlog, server_sd=server_sd,
                j_distill=j_distill,
                j_eval=j_eval, t_eval=t_eval, p_eval=p_eval, tmp=tmp)


def _host(x):
    return (x.detach().cpu().numpy() if isinstance(x, torch.Tensor)
            else np.asarray(x, np.float32))


def _after(got, want, name, perturbed):
    """|got - want| within 2e-3 (rtol and atol of the largest entry), or
    within twice the port's own spread |got - perturbed|."""
    got, want, perturbed = _host(got), _host(want), _host(perturbed)
    spread = float(np.abs(got - perturbed).max())
    bound = AFTER_UPDATE * (np.abs(want) + max(1.0, float(
        np.abs(want).max())))
    err = np.abs(got - want)
    assert (err <= np.maximum(bound, 2 * spread)).all(), (
        f"{name}: max error {err.max():.3e} beyond 2e-3 and twice the "
        f"port's spread {spread:.3e}")


def test_round_samples_same_clients(rounds):
    def trained(log):
        return [m for m in log.lines
                if isinstance(m, str) and m.startswith("Training Client")]

    assert trained(rounds["tlog"]) == trained(rounds["jlog"])
    assert len(trained(rounds["tlog"])) == 3
    np.testing.assert_array_equal(rounds["talgo"].distill_index,
                                  rounds["jalgo"].distill_index)


def test_round_global_features_match(rounds):
    j, t, p = rounds["jalgo"], rounds["talgo"], rounds["palgo"]
    _after(t.global_img_feature, j.global_img_feature, "global img",
           p.global_img_feature)
    _after(t.global_txt_feature, j.global_txt_feature, "global txt",
           p.global_txt_feature)
    assert t.global_img_feature.shape == (16, 16)


def test_round_client_reps_and_con_w_match(rounds):
    img_vecs, txt_vecs = rounds["j_distill"][0][0]
    t, p = rounds["talgo"], rounds["palgo"]
    assert t.img_reps.shape == (len(img_vecs), 16, 16) == (2, 16, 16)
    assert t.txt_reps.shape == (len(txt_vecs), 16, 16) == (2, 16, 16)
    for k, want in enumerate(img_vecs):
        _after(t.img_reps[k], want, f"img reps {k}", p.img_reps[k])
    for k, want in enumerate(txt_vecs):
        _after(t.txt_reps[k], want, f"txt reps {k}", p.txt_reps[k])
    _after(t.img_vec, rounds["jalgo"].img_vec, "con_w img aggregate",
           p.img_vec)
    _after(t.txt_vec, rounds["jalgo"].txt_vec, "con_w txt aggregate",
           p.txt_vec)


def test_round_server_after_distill_matches(rounds):
    j, t, p = rounds["jalgo"], rounds["talgo"], rounds["palgo"]
    want = flax_server_state_to_torch(_np(j.server_state.params),
                                      _np(j.server_state.batch_stats))

    def state(algo):
        sd = {f"model.{k}": v for k, v in
              algo.server_state.model.state_dict().items()}
        sd.update({f"criterion.{k}": v for k, v in
                   algo.server_state.criterion.state_dict().items()})
        return sd

    params = {f"model.{k}" for k, _ in
              t.server_state.model.named_parameters()}
    params |= {f"criterion.{k}" for k, _ in
               t.server_state.criterion.named_parameters()}
    got, other = state(t), state(p)
    for key, val in want.items():
        if key.endswith("num_batches_tracked"):
            continue
        if key in params:
            start = rounds["server_sd"][key].numpy()
            dt, dj = _host(got[key]) - start, val.numpy() - start
            dist = np.linalg.norm(dt - dj) / max(np.linalg.norm(dj), 1e-12)
            assert dist <= UPDATE_DIST, (
                f"{key}: update distance {dist:.3g} (|jax update| "
                f"{np.linalg.norm(dj):.3g}, |port update| "
                f"{np.linalg.norm(dt):.3g})")
        else:
            _after(got[key], val.numpy(), key, other[key])
    assert len(params) == sum(k in params for k in want)
    # 2 train steps + 2 distill steps.
    assert t.server_state.step == int(j.server_state.step) == 4


def test_round_eval_matches(rounds):
    (_, jfeats), (_, tfeats) = rounds["j_eval"][0], rounds["t_eval"][0]
    pfeats = rounds["p_eval"][0][1]
    for key in ("image_features", "caption_features"):
        _after(tfeats[key], jfeats[key], key, pfeats[key])
    for key in ("image_classes", "caption_classes", "caption_ids"):
        np.testing.assert_array_equal(tfeats[key], jfeats[key])
    js, ts = rounds["jscores"], rounds["tscores"]
    n_q = {"i2t": len(jfeats["image_features"]),
           "t2i": len(jfeats["caption_features"])}
    for task in ("i2t", "t2i"):
        for k in ("recall_1", "recall_5", "recall_10"):
            assert abs(ts[task][k] - js[task][k]) <= 100.0 / n_q[task] + 1e-9
    assert set(ts) == set(js)


def test_round_saves_best_and_last(rounds):
    exp = rounds["talgo"].args.exp_dir
    for name in ("t-best_model.ckpt", "t-last_model.ckpt"):
        sd = torch.load(os.path.join(exp, name))
        assert sd["step"] == 4 and "criterion" in sd
        assert set(sd["model"]) == set(
            rounds["talgo"].server_state.model.state_dict())


def test_seed_round_matches_jax(tmp_path):
    """Client sampling and every loader's order per round, over three
    rounds and more clients than a round takes (no training)."""
    args = _args(tmp_path, num_img_clients=3, num_txt_clients=2,
                 num_mm_clients=2)
    jds, tds = j_build(args, **SIZES), build_synthetic_datasets(args, **SIZES)
    jself = types.SimpleNamespace(args=args, datasets=jds)
    tself = types.SimpleNamespace(args=args, datasets=tds)
    for round_n in range(3):
        jr = JMMFL._seed_round(jself, round_n)
        tr = MMFL._seed_round(tself, round_n)
        assert tr.sample(range(7), 4) == jr.sample(range(7), 4)
        for key in ("pub_train", "img_clients", "mm_clients"):
            jl = jds[key][0] if isinstance(jds[key], list) else jds[key]
            tl = tds[key][0] if isinstance(tds[key], list) else tds[key]
            for jb, tb in zip(jl, tl):
                np.testing.assert_array_equal(tb["index"] if "index" in tb
                                              else tb["labels"],
                                              jb["index"] if "index" in jb
                                              else jb["labels"])


def test_unported_options_raise(tmp_path):
    """The options the port once refused are ported: --client_bf16 (the
    image clients' trunks in bf16) and the pretrained-weight files
    (--resnet_ckpt, --bert_ckpt, --glove_path, --client_resnet_ckpt), as
    are the stacked branch, round checkpoints, --resume and --save_client
    (test_torch_stacked.py, test_torch_resume.py), and the mesh
    (test_torch_mesh.py)."""
    from creamfl_tpu_torch.models.resnet import ResNetBackbone

    trunk = ResNetBackbone("resnet10").state_dict()
    torch.save(dict(trunk, **{"fc.weight": torch.zeros(1000, 512),
                              "fc.bias": torch.zeros(1000)}),
               tmp_path / "r.pth")
    torch.save({}, tmp_path / "b.pth")  # not read: the server is GRU
    (tmp_path / "g.txt").write_text("nosuchword 0.5 0.5\n")
    files = dict(resnet_ckpt=str(tmp_path / "r.pth"),
                 bert_ckpt=str(tmp_path / "b.pth"),
                 glove_path=str(tmp_path / "g.txt"),
                 client_resnet_ckpt=str(tmp_path / "r.pth"))
    args = _args(tmp_path, client_bf16=True, **files)
    server, mm, bert = _configs(build_configs, args)
    log = _Log()
    algo = MMFL(args, build_synthetic_datasets(args, **SIZES), server, mm,
                bert_config=bert, logger=log, device="cpu")
    img = [c for c in algo.clients if c.kind == "img"]
    assert img and all(c.engine.dtype == torch.bfloat16 for c in img)
    for module in [algo.server_state.model.img_enc.cnn] + [
            c.state.model.backbone for c in img]:
        for key, val in module.state_dict().items():
            assert torch.equal(val, trunk[key]), key
    assert "loaded pretrained weights into server" in log.lines
    assert any(line.startswith("glove: 0/") for line in log.lines
               if isinstance(line, str))


SCORE_LINE = re.compile(r"step 1 \| i2t_r1=[0-9.]+ rsum_r1=[0-9.]+ "
                        r"t2i_r1=[0-9.]+$")


def test_cli_smoke_round_on_cpu(tmp_path):
    """The CLI with --no-cuda --smoke runs one round and logs the
    reference-format score lines."""
    cmd = [sys.executable, "-m", "creamfl_tpu_torch.main", "--no-cuda",
           "--synthetic", "--smoke", "--comm_rounds", "1", "--local_epochs",
           "1", "--num_img_clients", "1", "--num_txt_clients", "1",
           "--num_mm_clients", "1", "--client_num_per_round", "3",
           "--no_client_parallel", "--agg_method", "con_w",
           "--contrast_local_inter", "--contrast_local_intra", "--seed", "0",
           "--exp_dir", str(tmp_path), "--name", "smoke"]
    # One torch thread: the suite's parallel workers share the host.
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    out = subprocess.run(cmd, cwd=REPO, env=env, capture_output=True,
                         text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    lines = [ln.split("] ", 1)[-1] for ln in out.stdout.splitlines()]
    assert any(SCORE_LINE.match(ln) for ln in lines), out.stdout[-3000:]
    assert any(ln.startswith("step 1 | eval__meta_cur_epoch=1 ")
               and "eval__test__i2t_recall_1=" in ln for ln in lines)
    assert "round 1 timing | " in out.stdout
    assert os.path.isfile(tmp_path / "smoke-last_model.ckpt")


@pytest.mark.parametrize("smoke", [True, False])
@pytest.mark.parametrize("not_bert", [True, False])
def test_build_configs_match_jax(tmp_path, smoke, not_bert):
    """The CLI's server and mm-client configs and the BERT config equal
    the JAX package's (configs/f30k.json is f30k.yaml's twin)."""
    import dataclasses

    args = _args(tmp_path, smoke=smoke, not_bert=not_bert, server_lr=3e-4,
                 cosine_t_max=7)
    (js, jm, jb), (ts, tm, tb) = j_build_configs(args), build_configs(args)
    assert ts.to_dict() == js.to_dict()
    assert tm.to_dict() == jm.to_dict()
    assert dataclasses.asdict(tb) == dataclasses.asdict(jb)


def test_utils_match_jax(tmp_path, monkeypatch):
    """The logger's report line, the tracker without wandb, the save
    directories and set_seed's python/numpy streams, as the JAX package's
    helpers give them."""
    import logging
    import random

    from creamfl_tpu.utils import helper as jhelper
    from creamfl_tpu.utils import logging as jlogging
    from creamfl_tpu_torch.utils import helper, logging as tlogging

    lines = []

    class Keep(logging.Handler):
        def emit(self, record):
            lines.append(record.getMessage())

    metrics = {"rsum_r1": 41.5, "i2t_r1": 8.25, "n": 3}
    for mod in (jlogging, tlogging):
        logger = mod.PythonLogger()
        logger._logger.addHandler(Keep())
        logger.report(1, metrics, prefix="eval__")
    assert lines[0] == lines[1] and lines[1].startswith("step 1 | eval__")
    monkeypatch.setitem(sys.modules, "wandb", None)  # not importable
    assert isinstance(tlogging.get_tracker("t", enabled=True),
                      tlogging.NoOpTracker)
    assert (type(jlogging.get_tracker("t", enabled=True)).__name__
            == "NoOpTracker")
    dirs = [{k: os.path.relpath(v, root) for k, v in fn(root, "x").items()}
            for fn, root in ((helper.get_save_dirs, str(tmp_path / "t")),
                             (jhelper.get_save_dirs, str(tmp_path / "j")))]
    assert dirs[0] == dirs[1] and all(
        os.path.isdir(tmp_path / "t" / d) for d in dirs[0].values())
    draws = []
    for set_seed in (jhelper.set_seed, helper.set_seed):
        set_seed(11)
        draws.append((random.random(), np.random.rand()))
    assert draws[0] == draws[1]
    helper.set_seed(11)
    a = torch.rand(3)
    helper.set_seed(11)
    assert torch.equal(a, torch.rand(3))

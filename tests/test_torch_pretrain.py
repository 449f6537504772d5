"""The port's ``RawTrainer`` (server pretraining loop) vs the JAX package's.

Mirrors ``tests/test_pretrain.py`` at its sizes (resnet10, GRU text
branch, word_dim 8, embed 16, 16 captions at 32², batch 8, fp32), both
trainers from the same weights (the JAX state carried over by
``models.convert.flax_server_state_to_torch``) over bit-equal batches.
Two epochs with validation after each. Tolerances, as in
``test_torch_server.py`` and ``test_torch_round.py``: every loss term of
the first train step (before any update) rtol 1e-4; the total loss, shift
and negative_scale of every later step, and of each epoch's report, rtol
and atol 2e-3, the bound on what follows an AdamP update (AdamP moves
every entry by about +-lr, so an entry whose gradient is zero up to
rounding may step the other way in one framework; here the total loss
after one update read 2.2e-4 apart); the parameters after training held
through their update, per tensor within 0.1 in relative Frobenius norm of
the JAX package's. The GRU branch has no dropout. The validation recalls within one rank step (100 / number of
queries).

The positive/negative split of the loss after an update is held under SGD
(``test_loss_split_under_sgd``): with AdamP the split at step 2 read 1.1 %
apart, against the port's own 4e-4 under a 1e-7 perturbation of its
start; with SGD in both packages (lr 0.05, the same model-only clip) every
term of every step agrees within 4e-4 (read: at most 1.2e-4). So the gap
under AdamP comes from AdamP's +-lr sign steps on entries whose gradient
is zero up to rounding, not from MCSoft's forward or backward. The same
test holds ``shift`` and ``negative_scale`` in the loss dict: the values
the loss used, taken before the update, as the JAX package reports them
(SGD moves them by O(1), where AdamP's 2e-4 hid a dict that read them
after the update). Then the checkpoints: both written, restorable into a fresh
state, step counts equal. Last, the port's trainer over a public loader
whose images are synthesized on the device (``DeviceImageBatches``).
"""

import os

import jax
import numpy as np
import optax
import pytest
import torch

from creamfl_tpu.config import default_config_path as j_config_path
from creamfl_tpu.config import parse_config as j_parse_config
from creamfl_tpu.data.loaders import ArrayLoader as JArrayLoader
from creamfl_tpu.data.synthetic import SyntheticCaptionDataset as JDataset
from creamfl_tpu.engine.evaluator import RetrievalEvaluator as JEvaluator
from creamfl_tpu.engine.pretrain import RawTrainer as JRawTrainer
from creamfl_tpu.engine.server import ServerEngine as JServer
from creamfl_tpu_torch.config import default_config_path, parse_config
from creamfl_tpu_torch.data.device_synth import (DeviceImageBatches,
                                                 DeviceImageSynth)
from creamfl_tpu_torch.data.loaders import ArrayLoader
from creamfl_tpu_torch.data.synthetic import SyntheticCaptionDataset
from creamfl_tpu_torch.engine.evaluator import RetrievalEvaluator
from creamfl_tpu_torch.engine.pretrain import RawTrainer
from creamfl_tpu_torch.engine.server import ServerEngine
from creamfl_tpu_torch.models.convert import flax_server_state_to_torch
from test_torch_round import _Log
from torch_cpu_share import torch_cpu_share  # noqa: F401

OVERRIDES = dict(model__embed_dim=16, model__cnn_type="resnet10",
                 model__not_bert=True, model__word_dim=8,
                 train__use_bf16=False)
RTOL, AFTER_UPDATE, UPDATE_DIST = 1e-4, 2e-3, 0.1
TIGHT = ("loss", "shift", "negative_scale")


def _jax_side():
    ds = JDataset(n_captions=16, image_size=32, max_len=8)
    engine = JServer(j_parse_config(j_config_path("coco.yaml"),
                                    strict_cast=False, **OVERRIDES),
                     vocab_size=len(ds.vocab))
    state = engine.init_state(jax.random.PRNGKey(0), next(iter(
        JArrayLoader(ds, batch_size=8))))
    loader = JArrayLoader(ds, batch_size=8, drop_last=True, shuffle=True)
    return engine, state, ds, loader


def _start_weights(jstate):
    """The JAX state's weights as the port's state dict (read before the
    JAX trainer runs: its steps donate the state's buffers)."""
    return flax_server_state_to_torch(
        jax.tree.map(np.asarray, jstate.params),
        jax.tree.map(np.asarray, jstate.batch_stats))


def _port_engine(start, vocab_size):
    engine = ServerEngine(parse_config(default_config_path("coco.json"),
                                       strict_cast=False, **OVERRIDES),
                          vocab_size=vocab_size, device="cpu")
    return engine, engine.init_state(state_dict=start)


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("pretrain")
    jengine, jstate, jds, jloader = _jax_side()
    start = _start_weights(jstate)
    jlog = _Log()
    jsteps = []
    _record_losses(jengine, jsteps)
    jtrainer = JRawTrainer(jengine, jstate, logger=jlog,
                           evaluator=JEvaluator(n_crossfolds=0))
    jout = jtrainer.train(
        jloader, n_epochs=2,
        val_loaders={"val": JArrayLoader(jds, batch_size=8, pad_last=True)},
        model_save_to=str(tmp / "jlast.pth"),
        best_model_save_to=str(tmp / "jbest.pth"))

    ds = SyntheticCaptionDataset(n_captions=16, image_size=32, max_len=8)
    engine, state = _port_engine(start, len(ds.vocab))
    steps = []
    _record_losses(engine, steps)
    log = _Log()
    trainer = RawTrainer(engine, state, logger=log,
                         evaluator=RetrievalEvaluator(n_crossfolds=0))
    out = trainer.train(
        ArrayLoader(ds, batch_size=8, drop_last=True, shuffle=True),
        n_epochs=2,
        val_loaders={"val": ArrayLoader(ds, batch_size=8, pad_last=True)},
        model_save_to=str(tmp / "last.pth"),
        best_model_save_to=str(tmp / "best.pth"))
    return dict(jout=jout, jlog=jlog, jtrainer=jtrainer, out=out, log=log,
                steps=steps, jsteps=jsteps,
                trainer=trainer, engine=engine, tmp=tmp, start=start,
                n_val=len(ds))


def _record_losses(engine, store):
    """Keep each ``train_step``'s loss dict, as floats."""
    step = engine.train_step

    def wrapped(*a, **kw):
        state, ldict = step(*a, **kw)
        store.append({k: float(v) for k, v in ldict.items()})
        return state, ldict

    engine.train_step = wrapped


def _train_reports(log):
    return [m for _, m in (x for x in log.lines if isinstance(x, tuple))
            if any(k.startswith("train__") for k in m)]


def test_raw_trainer_losses_match_jax(trained):
    got, want = trained["steps"], trained["jsteps"]
    assert len(got) == len(want) == 4
    for i, (g, w) in enumerate(zip(got, want)):
        assert set(g) == set(w)
        for key in (w if i == 0 else TIGHT):
            np.testing.assert_allclose(
                g[key], w[key], rtol=RTOL if i == 0 else AFTER_UPDATE,
                atol=0 if i == 0 else AFTER_UPDATE, err_msg=f"step {i} {key}")
    got, want = (_train_reports(trained["log"]),
                 _train_reports(trained["jlog"]))
    assert len(got) == len(want) == 2
    for g, w in zip(got, want):
        assert set(g) == set(w) and g["step"] == w["step"]
        for key in TIGHT:
            np.testing.assert_allclose(g[f"train__{key}"], w[f"train__{key}"],
                                       rtol=AFTER_UPDATE, atol=AFTER_UPDATE,
                                       err_msg=key)


def test_raw_trainer_update_matches_jax(trained):
    jstate = trained["jtrainer"].state
    want = flax_server_state_to_torch(
        jax.tree.map(np.asarray, jstate.params),
        jax.tree.map(np.asarray, jstate.batch_stats))
    state = trained["trainer"].state
    got = {f"model.{k}": v for k, v in state.model.named_parameters()}
    got.update({f"criterion.{k}": v
                for k, v in state.criterion.named_parameters()})
    assert set(got) <= set(want)
    for key, val in got.items():
        start = trained["start"][key].numpy()
        dt = val.detach().numpy() - start
        dj = want[key].numpy() - start
        dist = np.linalg.norm(dt - dj) / max(np.linalg.norm(dj), 1e-12)
        assert dist <= UPDATE_DIST, f"{key}: update distance {dist:.3g}"


def test_raw_trainer_validation_matches_jax(trained):
    got, want = trained["out"], trained["jout"]
    n_q = {"i2t": trained["n_val"] // 5, "t2i": trained["n_val"]}
    for task in ("i2t", "t2i"):
        for k in ("recall_1", "recall_5", "recall_10"):
            assert abs(got["scores"]["val"][task][k]
                       - want["scores"]["val"][task][k]) <= (
                100.0 / n_q[task] + 1e-9), (task, k)
    assert got["best_score"] > 0 and want["best_score"] > 0


def test_raw_trainer_checkpoints_restore(trained):
    tmp, engine, trainer = trained["tmp"], trained["engine"], \
        trained["trainer"]
    for name in ("last.pth", "best.pth"):
        assert os.path.exists(tmp / name)
    # 2 epochs of 2 batches, as in the JAX trainer.
    assert trainer.state.step == int(trained["jtrainer"].state.step) == 4
    _, fresh = _port_engine(trained["start"],
                            engine.model.txt_enc.embed.num_embeddings)
    restored = engine.load_models(str(tmp / "last.pth"), fresh)
    assert restored.step == trainer.state.step
    for k, v in trainer.state.model.state_dict().items():
        torch.testing.assert_close(restored.model.state_dict()[k], v,
                                   rtol=0, atol=0)
    meta = torch.load(tmp / "best.pth", weights_only=True)["metadata"]
    assert meta["best_epoch"] in (1, 2) and meta["best_score"] > 0


SGD_LR, SPREAD = 0.05, 4e-4
SPLIT = ("loss", "i2t_pos_loss", "i2t_neg_loss", "t2i_pos_loss",
         "t2i_neg_loss", "shift", "negative_scale")


def test_loss_split_under_sgd():
    """Three train steps of both engines with SGD in place of AdamP (the
    model-only clip kept): every loss term within the port's own spread."""
    jengine, jstate, jds, _ = _jax_side()
    start = _start_weights(jstate)

    def model_only(params):
        return {k: jax.tree.map(lambda _: k == "model", v)
                for k, v in params.items()}

    jengine.tx = optax.chain(
        optax.masked(optax.clip_by_global_norm(2.0), model_only),
        optax.sgd(SGD_LR))
    jstate = jstate.replace(opt_state=jengine.tx.init(jstate.params))
    ds = SyntheticCaptionDataset(n_captions=16, image_size=32, max_len=8)
    engine, state = _port_engine(start, len(ds.vocab))
    state.optimizer = torch.optim.SGD(
        [*state.model.parameters(), *state.criterion.parameters()],
        lr=SGD_LR)
    jbatches = list(JArrayLoader(jds, batch_size=8, drop_last=True,
                                 shuffle=True))
    batches = list(ArrayLoader(ds, batch_size=8, drop_last=True,
                               shuffle=True))
    for i in range(3):
        jb, b = jbatches[i % 2], batches[i % 2]
        jstate, want = jengine.train_step(
            jstate, jb["images"], jb["captions"], jb["lengths"], None,
            jax.random.PRNGKey(0))
        state, got = engine.train_step(state, b["images"], b["captions"],
                                       b["lengths"])
        for key in SPLIT:
            np.testing.assert_allclose(float(got[key]), float(want[key]),
                                       rtol=SPREAD, err_msg=f"step {i} {key}")


def test_raw_trainer_requires_val_key(trained):
    trainer = trained["trainer"]
    with pytest.raises(KeyError):
        trainer.train([], 1, val_loaders={"test": []})


def test_raw_trainer_on_device_images(trained, tmp_path):
    """The paper-scale public loader: caption fields from the host, images
    synthesized by ``DeviceImageSynth`` (here on the CPU); a finite loss
    and a validation pass."""
    ds = SyntheticCaptionDataset(n_captions=16, image_size=32, max_len=8,
                                 with_images=False)

    def loader(**kw):
        return DeviceImageBatches(
            ArrayLoader(ds, batch_size=8, **kw),
            DeviceImageSynth(32, seed=ds.seed, n_concepts=ds.n_concepts,
                             signal=ds.signal, device="cpu"), ds._concept)

    engine, state = _port_engine(trained["start"], len(ds.vocab))
    log = _Log()
    out = RawTrainer(engine, state, logger=log,
                     evaluator=RetrievalEvaluator(n_crossfolds=0)).train(
        loader(drop_last=True, shuffle=True), n_epochs=1,
        val_loaders={"val": loader(pad_last=True)},
        model_save_to=str(tmp_path / "last.pth"),
        best_model_save_to=str(tmp_path / "best.pth"))
    (report,) = _train_reports(log)
    assert np.isfinite(report["train__loss"])
    assert 0.0 <= out["scores"]["val"]["i2t"]["recall_1"] <= 100.0

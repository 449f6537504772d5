"""Port ServerEngine vs the JAX package's, step for step.

Both engines start from the same weights: the JAX engine's ``init_state``
carried over by ``models.convert.flax_server_state_to_torch``. They run
three ``train_step``s, then ``extract_step`` (train-mode BatchNorm whose
running stats persist), ``distill_step`` (all three KD terms, targets
gathered by ``rows``) and ``eval_step``, on the same numpy batches, with
the standard and with the fused trunk (the JAX fused trunk on its jnp
reference path). The trunk is a two-stage Bottleneck trunk registered in
both packages' ``RESNET_CONFIGS`` for this module only (see
``test_torch_pcme.py``); BERT is tiny with dropout 0; fp32.

Tolerances. AdamP's first steps move every entry by about +-lr
(m / sqrt(v) is the gradient's sign), so an entry whose gradient is zero up
to rounding may step the other way in one framework: one step at lr 2e-4
left 39 of 720 786 entries up to 2 lr apart, and later steps carry those
differences on. So:
* the total loss, shift and negative_scale: rtol 1e-4 at every step; the
  positive/negative split after the first update, features and BN stats
  after it: rtol and atol (of the largest entry) 2e-3;
* parameters: the update each tensor took over the run (p - p0) agrees in
  relative Frobenius norm within 0.1 (a wrong projection, clip or decay is
  off by O(1); three steps read at most 0.054, on the stem's bn1 bias).
  BERT's attention key biases have a gradient that is zero in exact
  arithmetic (softmax ignores a per-query constant), so both frameworks
  move them by rounding noise alone: only the bound 2 lr per step applies.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from creamfl_tpu.config import default_config_path as j_config_path
from creamfl_tpu.config import parse_config as j_parse_config
from creamfl_tpu.engine.server import ServerEngine as JServer
from creamfl_tpu.models import resnet as jresnet
from creamfl_tpu.models.bert import BertConfig as JBertConfig
from creamfl_tpu.models.pcme import PCME as JPCME
from creamfl_tpu_torch.config import default_config_path, parse_config
from creamfl_tpu_torch.engine.server import ServerEngine
from creamfl_tpu_torch.models import resnet as tresnet
from creamfl_tpu_torch.models.bert import BertConfig
from creamfl_tpu_torch.models.convert import flax_server_state_to_torch
from creamfl_tpu_torch.models.pcme import PCME
from torch_cpu_share import torch_cpu_share  # noqa: F401

RTOL, ATOL = 1e-4, 1e-5
AFTER_UPDATE = 2e-3
B, IMG, L, E, N_PUB = 4, 64, 10, 16, 20
TRUNK = "resnet_b2"
OVERRIDES = dict(model__embed_dim=E, model__cnn_type=TRUNK,
                 train__use_bf16=False)


@pytest.fixture(scope="module", autouse=True)
def small_bottleneck_trunk():
    with pytest.MonkeyPatch.context() as mp:
        mp.setitem(jresnet.RESNET_CONFIGS, TRUNK,
                   (jresnet.Bottleneck, (1, 1), 512))
        mp.setitem(tresnet.RESNET_CONFIGS, TRUNK,
                   (tresnet.Bottleneck, (1, 1), 512))
        yield


def _close(got, want, name="", rtol=RTOL, atol=ATOL):
    want = np.asarray(want)
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    np.testing.assert_allclose(
        got, want, rtol=rtol, atol=atol * max(1.0, float(np.abs(want).max())),
        err_msg=name)


def _after(got, want, name):
    _close(got, want, name, rtol=AFTER_UPDATE, atol=AFTER_UPDATE)


def _check_updates(start, now, steps, lr, what):
    """Per tensor, the update over the run agrees within 10 % (Frobenius);
    noise-driven tensors only stay within 2 lr per step."""
    for key, (t0, j0) in start.items():
        t1, j1 = now[key]
        dt, dj = t1 - t0, j1 - j0
        if key.endswith("attention.self.key.bias"):
            assert np.abs(dt).max() <= 2 * lr * steps + ATOL, key
            continue
        dist = np.linalg.norm(dt - dj) / max(np.linalg.norm(dj), 1e-12)
        assert dist <= 0.1, f"{what} {key}: update distance {dist:.3g}"


def _batches():
    rng = np.random.default_rng(31)
    out = []
    for _ in range(4):
        lengths = rng.integers(3, L + 1, size=B)
        mask = (np.arange(L)[None, :] < lengths[:, None]).astype(np.int32)
        ids = rng.integers(1, 512, size=(B, L)).astype(np.int32) * mask
        out.append((rng.normal(size=(B, IMG, IMG, 3)).astype(np.float32),
                    ids, mask.sum(-1).astype(np.int32), mask))
    return out


def test_port_config_equals_jax_config():
    ours = parse_config(default_config_path("coco.json"))
    theirs = j_parse_config(j_config_path("coco.yaml"))
    assert ours.to_dict() == theirs.to_dict()
    ours = parse_config(default_config_path("coco.json"), **OVERRIDES)
    theirs = j_parse_config(j_config_path("coco.yaml"), **OVERRIDES)
    assert ours.to_dict() == theirs.to_dict()
    with pytest.raises(ValueError):
        parse_config(default_config_path("coco.json"), embed_dim=3)


def _engines(fused):
    bert = dataclasses.replace(JBertConfig.tiny(), dropout_rate=0.0)
    jeng = JServer(j_parse_config(j_config_path("coco.yaml"), **OVERRIDES),
                   vocab_size=512, bert_config=bert)
    jeng.model = JPCME(embed_dim=E, cnn_type=TRUNK, not_bert=False,
                       bert_config=bert, fused_bn=fused)
    images, ids, _, mask = _batches()[0]
    jstate = jeng.init_state(jax.random.PRNGKey(0), {
        "images": images, "bert_ids": ids, "bert_mask": mask})
    teng = ServerEngine(
        parse_config(default_config_path("coco.json"), **OVERRIDES),
        vocab_size=512, device="cpu",
        bert_config=dataclasses.replace(BertConfig.tiny(), dropout_rate=0.0))
    teng.model = PCME(embed_dim=E, cnn_type=TRUNK, not_bert=False,
                      bert_config=teng.model.bert_config, fused_bn=fused)
    tstate = teng.init_state(state_dict=flax_server_state_to_torch(
        jax.tree.map(np.asarray, jstate.params),
        jax.tree.map(np.asarray, jstate.batch_stats)))
    return jeng, jstate, teng, tstate


def _state(jstate, tstate):
    """{key: (port tensor, JAX tensor)} as numpy, both in torch names."""
    want = flax_server_state_to_torch(
        jax.tree.map(np.asarray, jstate.params),
        jax.tree.map(np.asarray, jstate.batch_stats))
    got = {f"model.{k}": v for k, v in tstate.model.state_dict().items()}
    got.update({f"criterion.{k}": v
                for k, v in tstate.criterion.state_dict().items()})
    return {k: (got[k].detach().numpy().copy(), v.numpy())
            for k, v in want.items() if "num_batches_tracked" not in k}


def _params(state):
    return {k: v for k, v in state.items() if "running_" not in k}


def _check_stats(state, what):
    for key, (got, want) in state.items():
        if "running_" in key:
            _after(got, want, f"{what} {key}")


@pytest.mark.parametrize("fused", [False, True])
def test_server_steps_match_jax(fused):
    jeng, jstate, teng, tstate = _engines(fused)
    batches = _batches()
    lr = float(jeng.lr_schedule(0))
    jstate = jeng.set_round_lr(jstate, 0)
    teng.set_round_lr(tstate, 0)
    assert tstate.optimizer.param_groups[0]["lr"] == pytest.approx(lr)
    key = jax.random.PRNGKey(1)
    start = _params(_state(jstate, tstate))

    for step in range(3):
        images, ids, lengths, mask = batches[step]
        jstate, jd = jeng.train_step(jstate, jnp.asarray(images),
                                     jnp.asarray(ids), jnp.asarray(lengths),
                                     jnp.asarray(mask), key)
        tstate, td = teng.train_step(tstate, images, ids, lengths, mask)
        for name in ("loss", "shift", "negative_scale"):
            _close(td[name], jd[name], f"step {step} {name}")
        for name in ("i2t_pos_loss", "i2t_neg_loss"):
            (_close if step == 0 else _after)(td[name], jd[name],
                                              f"step {step} {name}")
    assert tstate.step == 3
    state = _state(jstate, tstate)
    _check_updates(start, _params(state), 3, lr, "after 3 train steps")
    _check_stats(state, "after 3 train steps")

    images, ids, lengths, mask = batches[3]
    args = tuple(map(jnp.asarray, (images, ids, lengths, mask)))
    ji, jt, jbs = jeng.extract_step(jstate, *args, key)
    jstate = jstate.replace(batch_stats=jbs)
    ti, tt = teng.extract_step(tstate, images, ids, lengths, mask)
    _after(ti, ji, "extract image")
    _after(tt, jt, "extract text")
    _check_stats(_state(jstate, tstate), "after extract")

    rng = np.random.default_rng(2)
    agg = {k: rng.normal(size=(N_PUB, E)).astype(np.float32)
           for k in ("img", "txt")}
    rows = np.array([3, 17, 0, 9], np.int32)
    jstate, jloss = jeng.distill_step(
        jstate, *map(jnp.asarray, batches[0]),
        jax.tree.map(jnp.asarray, agg), jnp.asarray(rows), True, True,
        True, 0.3, key)
    tstate, tloss = teng.distill_step(
        tstate, *batches[0], {k: torch.tensor(v) for k, v in agg.items()},
        rows, True, True, True, 0.3)
    _after(tloss, jloss, "distill loss")
    _check_updates(start, _params(_state(jstate, tstate)), 4, lr,
                   "after distill")

    ji, jt = jeng.eval_step(jstate, *args)
    ti, tt = teng.eval_step(tstate, images, ids, lengths, mask)
    _after(ti, ji, "eval image")
    _after(tt, jt, "eval text")

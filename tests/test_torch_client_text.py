"""Port text-client and mm-client engines vs the JAX engines, step by step.

Text client (``UniClientEngine("txt")`` on ``TextClientNet``): two task
steps, two contrast steps (inter + intra against the eval-mode pre-round
model), a local test on a padded batch and a feature sweep, with and
without ``--mlp_local``. As in ``test_torch_client_uni.py`` the start is
the JAX init with the class_fc kernel scaled by 0.01 (the x128 feature
scale otherwise gives logits in the hundreds); tolerance rtol 1e-4, atol
1e-5, fp32.

MM client (``MMClientEngine``: PCME resnet6 + GRU, MCSoft, AdamP): two
local steps (the second batch repeat-padded, its pairs masked by
``valid``), two contrast steps and an eval-mode feature step, fp32. The
losses of the first step and the criterion scalars: rtol 1e-4. After
AdamP updates (every entry moves by about +-lr, so an entry whose gradient
is zero up to rounding may step the other way in one framework), losses,
features and BN stats: rtol and atol 2e-3 of the largest entry, and each
parameter's update over the run within 0.1 in relative Frobenius norm, as
``test_torch_server.py``. The criterion scalars do not move in the
contrast steps in either engine.
"""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from creamfl_tpu.config import default_config_path as j_config_path
from creamfl_tpu.config import parse_config as j_parse_config
from creamfl_tpu.engine.client_mm import MMClientEngine as JMM
from creamfl_tpu.engine.client_uni import UniClientEngine as JUni
from creamfl_tpu_torch.config import default_config_path, parse_config
from creamfl_tpu_torch.engine.client_mm import MMClientEngine
from creamfl_tpu_torch.engine.client_uni import UniClientEngine
from creamfl_tpu_torch.models.convert import (flax_server_state_to_torch,
                                              flax_text_client_to_torch)
from torch_cpu_share import torch_cpu_share  # noqa: F401

B, L, V, E, C, N_PUB = 4, 8, 30, 16, 4, 12
TOL = dict(rtol=1e-4, atol=1e-5)
AFTER_UPDATE = 2e-3


def _args(mlp_local=False):
    return types.SimpleNamespace(img_model_local="resnet10", feature_dim=E,
                                 mlp_local=mlp_local, interintra_weight=0.5,
                                 loss_scale=False)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _unit(rng, *shape):
    x = rng.normal(size=shape).astype(np.float32)
    return x / np.linalg.norm(x, axis=-1, keepdims=True)


def _captions(rng, n):
    lengths = rng.integers(2, L + 1, size=n).astype(np.int32)
    ids = rng.integers(4, V, size=(n, L)).astype(np.int32)
    return ids * (np.arange(L)[None, :] < lengths[:, None]), lengths


def _close(got, want, name, rtol, atol):
    want = np.asarray(want, np.float32)
    got = got.detach().numpy() if isinstance(got, torch.Tensor) \
        else np.asarray(got)
    np.testing.assert_allclose(
        got, want, rtol=rtol, atol=atol * max(1.0, float(np.abs(want).max())),
        err_msg=name)


# ---------------------------------------------------------------------------
# text client
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module", params=[False, True], ids=["plain", "mlp"])
def txt_run(request):
    mlp = request.param
    rng = np.random.default_rng(17)
    caps, lens = _captions(rng, B)
    labels = (np.arange(B) % C).astype(np.int32)
    pub_caps, pub_lens = _captions(rng, N_PUB)
    width = 512 if mlp else E
    g_img, g_txt = _unit(rng, N_PUB, width), _unit(rng, N_PUB, width)
    t_caps, t_lens = _captions(rng, B)
    test = {"captions": t_caps, "lengths": t_lens, "labels": labels[::-1].copy(),
            "valid": np.array([1, 1, 1, 0], bool)}

    jeng = JUni("txt", num_class=C, args=_args(mlp), vocab_size=V)
    js = jeng.init_state(jax.random.PRNGKey(5),
                         {"captions": caps, "lengths": lens})
    params = _np(js.params)
    params["class_fc"]["kernel"] = params["class_fc"]["kernel"] * 0.01
    js = jeng.set_round_lr(js.replace(params=jax.tree.map(jnp.asarray,
                                                          params)), 0)
    start = flax_text_client_to_torch(params, _np(js.batch_stats))
    old_p, old_bs = js.params, js.batch_stats
    j = {"task": [], "contrast": []}
    for _ in range(2):
        js, m = jeng.task_step(js, {"captions": jnp.asarray(caps),
                                    "lengths": jnp.asarray(lens),
                                    "labels": jnp.asarray(labels)})
        j["task"].append(float(m["loss"]))
    for step in range(2):
        idx = np.arange(step * B, (step + 1) * B, dtype=np.int32)
        js, loss = jeng.contrast_step(
            js, old_p, old_bs, {"captions": jnp.asarray(pub_caps[idx]),
                                "lengths": jnp.asarray(pub_lens[idx])},
            {"same": jnp.asarray(g_txt), "other": jnp.asarray(g_img),
             "index": jnp.asarray(idx)}, True, True)
        j["contrast"].append(float(loss))
    j["test"] = [float(x) for x in jeng.test_step(
        js, {k: jnp.asarray(v) for k, v in test.items()})]
    feats = []
    for s in range(0, N_PUB, B):
        f, bs = jeng.features_step(js, {"captions": jnp.asarray(
            pub_caps[s:s + B]), "lengths": jnp.asarray(pub_lens[s:s + B])})
        js = js.replace(batch_stats=bs)
        feats.append(np.asarray(f))
    j["feats"] = np.concatenate(feats)
    j["final"] = flax_text_client_to_torch(_np(js.params),
                                           _np(js.batch_stats))

    teng = UniClientEngine("txt", num_class=C, args=_args(mlp),
                           vocab_size=V, device="cpu")
    ts = teng.set_round_lr(teng.init_state(state_dict=start), 0)
    old = teng.snapshot(ts)
    t = {"task": [], "contrast": []}
    for _ in range(2):
        ts, m = teng.task_step(ts, {"captions": caps, "lengths": lens,
                                    "labels": labels})
        t["task"].append(float(m["loss"]))
    for step in range(2):
        idx = np.arange(step * B, (step + 1) * B)
        ts, loss = teng.contrast_step(
            ts, old, {"captions": pub_caps[idx], "lengths": pub_lens[idx]},
            {"same": torch.tensor(g_txt), "other": torch.tensor(g_img),
             "index": torch.tensor(idx)}, True, True)
        t["contrast"].append(float(loss))
    t["test"] = [float(x) for x in teng.test_step(ts, test)]
    t["feats"] = np.concatenate([teng.features_step(ts, {
        "captions": pub_caps[s:s + B], "lengths": pub_lens[s:s + B]})[0]
        .numpy() for s in range(0, N_PUB, B)])
    t["final"] = ts.model.state_dict()
    t["steps"] = ts.step
    return dict(start=start, j=j, t=t, mlp=mlp)


def test_text_client_losses_match(txt_run):
    j, t = txt_run["j"], txt_run["t"]
    task = np.asarray(j["task"])
    np.testing.assert_allclose(t["task"], task, rtol=TOL["rtol"],
                               atol=TOL["atol"] * np.abs(task).max())
    np.testing.assert_allclose(t["contrast"], j["contrast"], **TOL)
    assert t["test"] == j["test"]
    assert t["steps"] == 4


def test_text_client_params_and_features_match(txt_run):
    j, t, start = txt_run["j"], txt_run["t"], txt_run["start"]
    moved = 0
    for key, want in j["final"].items():
        if key.endswith("num_batches_tracked"):
            continue
        _close(t["final"][key], want.numpy(), key, **TOL)
        moved += not np.allclose(want.numpy(), start[key].numpy(), **TOL)
    assert moved > 0.5 * len(j["final"]) - 4
    _close(t["feats"], j["feats"], "features", **TOL)
    assert t["feats"].shape == (N_PUB, 512 if txt_run["mlp"] else E)


# ---------------------------------------------------------------------------
# mm client
# ---------------------------------------------------------------------------

OVERRIDES = dict(model__embed_dim=E, model__cnn_type="resnet6",
                 model__word_dim=12, train__use_bf16=False)
IMG = 32


def _mm_batches(rng):
    out = []
    for n in (B, B - 1):  # the second batch repeat-pads its last row
        caps, lens = _captions(rng, n)
        imgs = rng.normal(size=(n, IMG, IMG, 3)).astype(np.float32)
        valid = np.ones(B, bool)
        if n < B:
            caps, lens = np.concatenate([caps, caps[:1]]), np.concatenate(
                [lens, lens[:1]])
            imgs = np.concatenate([imgs, imgs[:1]])
            valid[n:] = False
        out.append({"images": imgs, "captions": caps, "lengths": lens,
                    "valid": valid})
    return out


def _mm_state(jstate):
    return flax_server_state_to_torch(_np(jstate.params),
                                      _np(jstate.batch_stats))


@pytest.fixture(scope="module")
def mm_run():
    rng = np.random.default_rng(23)
    batches = _mm_batches(rng)
    pub = _mm_batches(rng)
    g_img, g_txt = _unit(rng, N_PUB, E), _unit(rng, N_PUB, E)
    jcfg = j_parse_config(j_config_path("f30k.yaml"), **OVERRIDES)
    tcfg = parse_config(default_config_path("f30k.json"), **OVERRIDES)
    assert tcfg.to_dict() == jcfg.to_dict()

    jeng = JMM(jcfg, vocab_size=V, args=_args())
    js = jeng.set_round_lr(jeng.init_state(jax.random.PRNGKey(7),
                                           batches[0]), 0)
    start = _mm_state(js)
    old_p, old_bs = js.params, js.batch_stats
    j = {"local": [], "contrast": []}
    for b in batches:
        js, ld = jeng.local_step(js, jax.tree.map(jnp.asarray, b),
                                 jax.random.PRNGKey(0))
        j["local"].append({k: float(v) for k, v in ld.items()})
    j["after_local"] = _mm_state(js)
    for step, b in enumerate(pub):
        idx = np.arange(step * B, (step + 1) * B, dtype=np.int32)
        js, loss = jeng.contrast_step(
            js, old_p, old_bs, jax.tree.map(jnp.asarray, b),
            {"img": jnp.asarray(g_img), "txt": jnp.asarray(g_txt),
             "index": jnp.asarray(idx)}, True, True)
        j["contrast"].append(float(loss))
    j["feats"] = [np.asarray(f) for f in jeng.features_step(
        js, jax.tree.map(jnp.asarray, pub[0]))]
    j["final"] = _mm_state(js)

    teng = MMClientEngine(tcfg, vocab_size=V, args=_args(), device="cpu")
    ts = teng.set_round_lr(teng.init_state(state_dict=start), 0)
    lr = ts.optimizer.param_groups[0]["lr"]
    old = teng.snapshot(ts)
    t = {"local": [], "contrast": []}
    for b in batches:
        ts, ld = teng.local_step(ts, b)
        t["local"].append({k: float(v) for k, v in ld.items()})
    t["after_local"] = {f"criterion.{k}": v.clone() for k, v in
                        ts.criterion.state_dict().items()}
    for step, b in enumerate(pub):
        idx = np.arange(step * B, (step + 1) * B)
        ts, loss = teng.contrast_step(
            ts, old, b, {"img": torch.tensor(g_img),
                         "txt": torch.tensor(g_txt),
                         "index": torch.tensor(idx)}, True, True)
        t["contrast"].append(float(loss))
    t["feats"] = teng.features_step(ts, pub[0])
    t["final"] = {f"model.{k}": v for k, v in ts.model.state_dict().items()}
    t["final"].update({f"criterion.{k}": v
                       for k, v in ts.criterion.state_dict().items()})
    t["steps"] = ts.step
    return dict(start=start, j=j, t=t, lr=lr)


def test_mm_local_steps_match(mm_run):
    j, t = mm_run["j"], mm_run["t"]
    for key in ("loss", "shift", "negative_scale"):
        _close(t["local"][0][key], j["local"][0][key], f"step 0 {key}",
               **TOL)
        _close(t["local"][1][key], j["local"][1][key], f"step 1 {key}",
               AFTER_UPDATE, AFTER_UPDATE)
    assert mm_run["lr"] == pytest.approx(2e-4)


def test_mm_contrast_leaves_criterion(mm_run):
    """AdamP skips the criterion's scalars in the contrast steps (their
    grads stay None), as the JAX engine's restore_frozen keeps them."""
    j, t = mm_run["j"], mm_run["t"]
    for key, val in t["after_local"].items():
        assert torch.equal(t["final"][key], val), key
        np.testing.assert_array_equal(j["final"][key].numpy(),
                                      j["after_local"][key].numpy())
        _close(val, j["after_local"][key].numpy(), key, **TOL)
    np.testing.assert_allclose(t["contrast"], j["contrast"],
                               rtol=AFTER_UPDATE)
    assert t["steps"] == 4


def test_mm_params_features_match(mm_run):
    j, t, start, lr = mm_run["j"], mm_run["t"], mm_run["start"], mm_run["lr"]
    for key, want in j["final"].items():
        if key.endswith("num_batches_tracked"):
            continue
        got, want, p0 = (t["final"][key].numpy(), want.numpy(),
                         start[key].numpy())
        if "running_" in key:
            _close(got, want, key, AFTER_UPDATE, AFTER_UPDATE)
            continue
        du, dj = got - p0, want - p0
        dist = np.linalg.norm(du - dj) / max(np.linalg.norm(dj), 1e-12)
        assert dist <= 0.1 or np.abs(du - dj).max() <= 2 * lr * 4, \
            f"{key}: update distance {dist:.3g}"
    for got, want, name in zip(t["feats"], j["feats"], ("img", "txt")):
        _close(got, want, f"{name} features", AFTER_UPDATE, AFTER_UPDATE)

"""``--client_bf16``: the image client's trunk in bf16, against the JAX
package's ``use_bf16=True`` client from the same weights.

Both packages run the client at fp32 and at bf16 from one start (flax's
init with the linear and class_fc kernels scaled as in
``test_torch_client_uni.py``): features of a public batch, then one task
step and one contrast step (inter + intra). Tolerances:

* fp32: the port's path is unchanged and agrees with JAX's at
  ``test_torch_client_uni.py``'s rtol 1e-4, atol 1e-5;
* bf16: the two packages round at the same places (convolutions and
  BatchNorm outputs in bf16, the grid cast to fp32 before pooling) but sum
  in other orders, so each bf16 quantity (features, losses, each tensor's
  update over the two steps) must lie within twice the bf16 rounding of
  either package, read as its distance from its own fp32 run, and the
  features' row cosine must be >= 0.999 (0.9991 read at these sizes).

Parameters, BatchNorm statistics, optimizer state and the state dict stay
fp32. Last, a round on the stacked client branch with ``client_bf16``
runs every image-client trunk forward in bf16.
"""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from creamfl_tpu.engine.client_uni import UniClientEngine as JEngine
from creamfl_tpu_torch.data.pipelines import build_synthetic_datasets
from creamfl_tpu_torch.engine.client_uni import UniClientEngine
from creamfl_tpu_torch.federation.rounds import MMFL
from creamfl_tpu_torch.main import build_configs
from creamfl_tpu_torch.models.clients import ImageClientNet
from creamfl_tpu_torch.models.convert import flax_image_client_to_torch
from test_torch_round import SIZES, _args, _configs, _Log
from torch_cpu_share import torch_cpu_share  # noqa: F401

B, IMG, E, C, N_PUB = 8, 32, 16, 10, 16
TOL = dict(rtol=1e-4, atol=1e-5)
COSINE = 0.999
ARGS = types.SimpleNamespace(img_model_local="resnet10", feature_dim=E,
                             mlp_local=False, interintra_weight=0.5,
                             loss_scale=False)


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _data():
    rng = np.random.default_rng(7)

    def unit(*shape):
        x = rng.normal(size=shape).astype(np.float32)
        return x / np.linalg.norm(x, axis=-1, keepdims=True)

    return dict(images=rng.normal(size=(B, IMG, IMG, 3)).astype(np.float32),
                labels=(np.arange(B) % C).astype(np.int32),
                pub=rng.normal(size=(B, IMG, IMG, 3)).astype(np.float32),
                g_img=unit(N_PUB, E), g_txt=unit(N_PUB, E),
                idx=np.arange(B, dtype=np.int32))


def _jax_run(d, use_bf16):
    eng = JEngine("img", num_class=C, args=ARGS, use_bf16=use_bf16)
    js = eng.init_state(jax.random.PRNGKey(0),
                        {"images": d["images"], "labels": d["labels"]})
    params = _np_tree(js.params)
    params["linear"]["kernel"] = params["linear"]["kernel"] * 0.1
    params["class_fc"]["kernel"] = params["class_fc"]["kernel"] * 0.01
    js = eng.set_round_lr(js.replace(params=jax.tree.map(jnp.asarray,
                                                         params)), 0)
    start = flax_image_client_to_torch(params, _np_tree(js.batch_stats))
    feats, _ = eng.features_step(js, {"images": jnp.asarray(d["pub"])})
    old_p, old_bs = js.params, js.batch_stats
    js, m = eng.task_step(js, {"images": jnp.asarray(d["images"]),
                               "labels": jnp.asarray(d["labels"])})
    js, loss = eng.contrast_step(
        js, old_p, old_bs, {"images": jnp.asarray(d["pub"])},
        {"same": jnp.asarray(d["g_img"]), "other": jnp.asarray(d["g_txt"]),
         "index": jnp.asarray(d["idx"])}, True, True)
    return start, dict(
        feats=np.asarray(feats), task=float(m["loss"]), contrast=float(loss),
        final={k: v.numpy() for k, v in flax_image_client_to_torch(
            _np_tree(js.params), _np_tree(js.batch_stats)).items()})


def _port_run(d, start, use_bf16):
    eng = UniClientEngine("img", num_class=C, args=ARGS, use_bf16=use_bf16,
                          device="cpu")
    # Features from the start weights, on a state of their own (the
    # features pass moves BN running stats).
    feats = eng.features_step(eng.init_state(state_dict=start),
                              {"images": d["pub"]})[0]
    ts = eng.set_round_lr(eng.init_state(state_dict=start), 0)
    old = eng.snapshot(ts)
    ts, m = eng.task_step(ts, {"images": d["images"],
                               "labels": d["labels"]})
    ts, loss = eng.contrast_step(
        ts, old, {"images": d["pub"]},
        {"same": torch.tensor(d["g_img"]), "other": torch.tensor(d["g_txt"]),
         "index": torch.tensor(d["idx"])}, True, True)
    return dict(feats=feats.numpy(), task=float(m["loss"]),
                contrast=float(loss),
                final={k: v.numpy() for k, v in
                       ts.model.state_dict().items()},
                state=ts)


@pytest.fixture(scope="module")
def runs():
    d = _data()
    start, j32 = _jax_run(d, False)
    _, j16 = _jax_run(d, True)
    return dict(start={k: v.numpy() for k, v in start.items()}, j32=j32,
                j16=j16, t32=_port_run(d, start, False),
                t16=_port_run(d, start, True))


def test_fp32_path_unchanged(runs):
    t, j = runs["t32"], runs["j32"]
    np.testing.assert_allclose(t["feats"], j["feats"], **TOL)
    np.testing.assert_allclose(t["task"], j["task"], **TOL)
    np.testing.assert_allclose(t["contrast"], j["contrast"], **TOL)
    for key, want in j["final"].items():
        if not key.endswith("num_batches_tracked"):
            np.testing.assert_allclose(t["final"][key], want, err_msg=key,
                                       **TOL)


def _cosines(a, b):
    return (a * b).sum(1) / (np.linalg.norm(a, axis=1)
                             * np.linalg.norm(b, axis=1))


def test_bf16_features_and_losses_match_jax(runs):
    t16, j16, t32, j32 = runs["t16"], runs["j16"], runs["t32"], runs["j32"]
    # bf16 really rounds: each package's bf16 run leaves its fp32 run.
    assert np.abs(t16["feats"] - t32["feats"]).max() > 1e-4
    bound = 2 * max(np.abs(t16["feats"] - t32["feats"]).max(),
                    np.abs(j16["feats"] - j32["feats"]).max())
    assert np.abs(t16["feats"] - j16["feats"]).max() <= bound
    assert _cosines(t16["feats"], j16["feats"]).min() >= COSINE
    for name in ("task", "contrast"):
        bound = 2 * max(abs(t16[name] - t32[name]),
                        abs(j16[name] - j32[name]))
        assert abs(t16[name] - j16[name]) <= bound + TOL["atol"], name


def test_bf16_step_updates_match_jax(runs):
    start, t16, j16, t32, j32 = (runs[k] for k in ("start", "t16", "j16",
                                                   "t32", "j32"))

    def dist(a, b, s):
        return (np.linalg.norm((a - s) - (b - s))
                / max(np.linalg.norm(b - s), 1e-12))

    for key, s in start.items():
        if key.endswith("num_batches_tracked") or "running_" in key:
            continue
        if not np.abs(j32["final"][key] - s).max():
            continue  # a tensor neither step moves (class_fc_2)
        got = dist(t16["final"][key], j16["final"][key], s)
        bound = 2 * max(dist(t16["final"][key], t32["final"][key], s),
                        dist(j16["final"][key], j32["final"][key], s))
        assert got <= bound + 1e-6, f"{key}: {got:.3g} > {bound:.3g}"


def test_bf16_state_stays_fp32(runs):
    state = runs["t16"]["state"]
    assert state.model.dtype == torch.bfloat16
    for key, val in state.model.state_dict().items():
        if val.is_floating_point():
            assert val.dtype == torch.float32, key
    for group in state.optimizer.param_groups:
        for p in group["params"]:
            assert p.dtype == torch.float32
            buf = state.optimizer.state[p].get("momentum_buffer")
            assert buf is None or buf.dtype == torch.float32
    # An fp32 client enters no autocast: its features are the plain
    # forward's, bit for bit.
    net = ImageClientNet("resnet10", num_class=C, embed_dim=E)
    x = torch.randn(2, IMG, IMG, 3, generator=torch.Generator().manual_seed(0))
    net.eval()
    grid = net.backbone(x)
    assert grid.dtype == torch.float32
    plain = net.linear(grid.mean(dim=(1, 2)) * net.scale)
    assert torch.equal(net.embed(x), plain)


def test_stacked_round_runs_image_trunks_in_bf16(tmp_path):
    args = _args(tmp_path, client_bf16=True, client_parallel=True,
                 num_img_clients=2, num_txt_clients=0, num_mm_clients=0,
                 client_num_per_round=2)
    server, mm, bert = _configs(build_configs, args)
    algo = MMFL(args, build_synthetic_datasets(args, **SIZES), server, mm,
                bert_config=bert, logger=_Log(), device="cpu")
    dtypes = []
    for c in algo.clients:
        assert c.engine.dtype == torch.bfloat16
        c.state.model.backbone.register_forward_hook(
            lambda m, i, out: dtypes.append(out.dtype))
    algo.train(0)
    # Task, contrast (with the frozen pre-round copy, whose hooks were
    # copied with it), test and reps forwards, all in bf16.
    assert dtypes and set(dtypes) == {torch.bfloat16}
    assert algo.img_reps.dtype == torch.float32
    assert bool(torch.isfinite(algo.img_reps).all())

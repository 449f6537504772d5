"""Port image-client engine vs the JAX engine: the same trajectory.

Both engines start from the same weights (JAX init carried over by the
port's ``models.convert``) and run two task steps, two contrast steps
(inter + intra against the eval-mode pre-round model), a local test and
a feature sweep. Losses, params, momentum-carrying updates and BN running
stats must agree.

Tolerance: rtol 1e-4 atol 1e-5 (fp32; convolutions and reductions sum in
another order). The start weights are flax's init with the linear and
class_fc kernels scaled by 0.1 and 0.01: at the plain init the x128
feature scale gives logits in the hundreds, and that trajectory
amplifies fp32 rounding far past the tolerance. From the scaled start a
1e-7 relative perturbation of the weights stays inside it
(``test_scaled_start_is_well_conditioned``).
"""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from creamfl_tpu.engine.client_uni import UniClientEngine as JEngine
from creamfl_tpu_torch.engine.client_uni import UniClientEngine
from creamfl_tpu_torch.models.convert import flax_image_client_to_torch

B, IMG, E, C, N_PUB = 4, 16, 16, 10, 12
TOL = dict(rtol=1e-4, atol=1e-5)
ARGS = types.SimpleNamespace(img_model_local="resnet10", feature_dim=E,
                             mlp_local=False, interintra_weight=0.5,
                             loss_scale=False)


def _unit(rng, *shape):
    x = rng.normal(size=shape).astype(np.float32)
    return x / np.linalg.norm(x, axis=-1, keepdims=True)


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _port_features(sd, images, labels, pub, g_img, g_txt):
    """The port's trajectory (2 task, 2 contrast steps) -> public-set
    features."""
    teng = UniClientEngine("img", num_class=C, args=ARGS, device="cpu")
    ts = teng.set_round_lr(teng.init_state(state_dict=sd), 0)
    old = teng.snapshot(ts)
    for _ in range(2):
        ts, _ = teng.task_step(ts, {"images": images, "labels": labels})
    for step in range(2):
        idx = np.arange(step * B, (step + 1) * B)
        globals_ = {"same": torch.tensor(g_img), "other": torch.tensor(g_txt),
                    "index": torch.tensor(idx)}
        ts, _ = teng.contrast_step(ts, old, {"images": pub[idx]}, globals_,
                                   True, True)
    return np.concatenate([
        teng.features_step(ts, {"images": pub[s:s + B]})[0].numpy()
        for s in range(0, N_PUB, B)])


@pytest.fixture(scope="module")
def trajectories():
    rng = np.random.default_rng(7)
    images = rng.normal(size=(B, IMG, IMG, 3)).astype(np.float32)
    labels = (np.arange(B) % C).astype(np.int32)
    pub = rng.normal(size=(N_PUB, IMG, IMG, 3)).astype(np.float32)
    g_img, g_txt = _unit(rng, N_PUB, E), _unit(rng, N_PUB, E)
    test = {"images": images[::-1].copy(), "labels": labels[::-1].copy(),
            "valid": np.array([1, 1, 1, 0], bool)}

    # ---- JAX engine ----------------------------------------------------
    jeng = JEngine("img", num_class=C, args=ARGS)
    js = jeng.init_state(jax.random.PRNGKey(0),
                         {"images": images, "labels": labels})
    params = _np_tree(js.params)
    params["linear"]["kernel"] = params["linear"]["kernel"] * 0.1
    params["class_fc"]["kernel"] = params["class_fc"]["kernel"] * 0.01
    js = jeng.set_round_lr(js.replace(params=jax.tree.map(jnp.asarray,
                                                          params)), 0)
    init = (params, _np_tree(js.batch_stats))
    old_p, old_bs = js.params, js.batch_stats
    j = {"task": [], "contrast": []}
    batch = {"images": jnp.asarray(images), "labels": jnp.asarray(labels)}
    for _ in range(2):
        js, m = jeng.task_step(js, batch)
        j["task"].append(float(m["loss"]))
    for step in range(2):
        idx = np.arange(step * B, (step + 1) * B, dtype=np.int32)
        globals_ = {"same": jnp.asarray(g_img), "other": jnp.asarray(g_txt),
                    "index": jnp.asarray(idx)}
        js, loss = jeng.contrast_step(js, old_p, old_bs,
                                      {"images": jnp.asarray(pub[idx])},
                                      globals_, True, True)
        j["contrast"].append(float(loss))
    j["test"] = [float(x) for x in jeng.test_step(
        js, {k: jnp.asarray(v) for k, v in test.items()})]
    feats = []
    for s in range(0, N_PUB, B):
        f, bs = jeng.features_step(js, {"images": jnp.asarray(pub[s:s + B])})
        js = js.replace(batch_stats=bs)
        feats.append(np.asarray(f))
    j["feats"] = np.concatenate(feats)
    j["final"] = flax_image_client_to_torch(_np_tree(js.params),
                                            _np_tree(js.batch_stats))

    # ---- port ----------------------------------------------------------
    teng = UniClientEngine("img", num_class=C, args=ARGS, device="cpu")
    ts = teng.set_round_lr(
        teng.init_state(state_dict=flax_image_client_to_torch(*init)), 0)
    assert ts.optimizer.param_groups[0]["lr"] == pytest.approx(1e-4)
    old = teng.snapshot(ts)
    t = {"task": [], "contrast": []}
    for _ in range(2):
        ts, m = teng.task_step(ts, {"images": images, "labels": labels})
        t["task"].append(float(m["loss"]))
    for step in range(2):
        idx = np.arange(step * B, (step + 1) * B)
        globals_ = {"same": torch.tensor(g_img), "other": torch.tensor(g_txt),
                    "index": torch.tensor(idx)}
        ts, loss = teng.contrast_step(ts, old, {"images": pub[idx]},
                                      globals_, True, True)
        t["contrast"].append(float(loss))
    t["test"] = [float(x) for x in teng.test_step(ts, test)]
    t["feats"] = np.concatenate([
        teng.features_step(ts, {"images": pub[s:s + B]})[0].numpy()
        for s in range(0, N_PUB, B)])
    t["final"] = ts.model.state_dict()
    t["old_unchanged"] = all(
        torch.equal(v, flax_image_client_to_torch(*init)[k])
        for k, v in old.state_dict().items())
    t["steps"] = ts.step
    # The same trajectory from start weights perturbed by 1e-7 (relative):
    # how far rounding alone moves the features.
    gen = torch.Generator().manual_seed(1)
    sd = {k: (v * (1 + 1e-7 * torch.randn(v.shape, generator=gen))
              if v.is_floating_point() and "running_" not in k else v)
          for k, v in flax_image_client_to_torch(*init).items()}
    t["feats_perturbed"] = _port_features(sd, images, labels, pub, g_img,
                                          g_txt)
    return init, j, t


def test_losses_match(trajectories):
    _, j, t = trajectories
    task = np.asarray(j["task"])
    np.testing.assert_allclose(t["task"], task, rtol=TOL["rtol"],
                               atol=TOL["atol"] * np.abs(task).max())
    np.testing.assert_allclose(t["contrast"], j["contrast"], **TOL)
    assert t["test"] == j["test"]


def test_params_and_bn_stats_match(trajectories):
    init, j, t = trajectories
    start = flax_image_client_to_torch(*init)
    moved = 0
    for key, want in j["final"].items():
        got = t["final"][key].numpy()
        want = want.numpy()
        if key.endswith("num_batches_tracked"):
            continue
        np.testing.assert_allclose(got, want, err_msg=key, **TOL)
        if not np.allclose(want, start[key].numpy(), **TOL):
            moved += 1
    # The comparison is not vacuous: most tensors left their start.
    assert moved > 0.5 * sum(not k.endswith("num_batches_tracked")
                             for k in j["final"])


def test_features_match(trajectories):
    _, j, t = trajectories
    np.testing.assert_allclose(t["feats"], j["feats"], **TOL)


def test_scaled_start_is_well_conditioned(trajectories):
    _, _, t = trajectories
    np.testing.assert_allclose(t["feats_perturbed"], t["feats"], **TOL)


def test_old_model_frozen_and_steps_counted(trajectories):
    _, _, t = trajectories
    assert t["old_unchanged"]
    assert t["steps"] == 4


def test_default_device_is_cuda():
    if torch.cuda.is_available():
        eng = UniClientEngine("img", num_class=C, args=ARGS)
        assert eng.device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            UniClientEngine("img", num_class=C, args=ARGS)
    # Text clients are ported (tests/test_torch_client_text.py); a modality
    # the JAX engine does not have is refused.
    assert UniClientEngine("txt", num_class=C, args=ARGS, vocab_size=20,
                           device="cpu").modality == "txt"
    with pytest.raises(ValueError):
        UniClientEngine("audio", num_class=C, args=ARGS, device="cpu")


def test_round_schedule_matches_jax():
    from creamfl_tpu.optim.factory import two_step_decay_schedule as j_sched
    from creamfl_tpu_torch.optim.factory import two_step_decay_schedule

    t_sched, js = two_step_decay_schedule(1e-4, 30), j_sched(1e-4, 30)
    for r in range(31):
        assert t_sched(r) == pytest.approx(float(js(r)), rel=1e-6), r


MLP_ARGS = types.SimpleNamespace(img_model_local="resnet10", feature_dim=E,
                                 mlp_local=True, interintra_weight=0.5,
                                 loss_scale=False)
MLP_WIDTH = 512  # MLPHead's width: the features and globals with mlp_local


@pytest.fixture(scope="module")
def mlp_trajectories():
    """--mlp_local: one task step (head_proj untouched) and one contrast
    step (through head_proj, 512-wide features against 512-wide globals)
    on both engines from the same scaled start."""
    rng = np.random.default_rng(11)
    images = rng.normal(size=(B, IMG, IMG, 3)).astype(np.float32)
    labels = (np.arange(B) % C).astype(np.int32)
    pub = rng.normal(size=(B, IMG, IMG, 3)).astype(np.float32)
    g_img = _unit(rng, N_PUB, MLP_WIDTH)
    g_txt = _unit(rng, N_PUB, MLP_WIDTH)
    idx = np.arange(B, dtype=np.int32)

    jeng = JEngine("img", num_class=C, args=MLP_ARGS)
    js = jeng.init_state(jax.random.PRNGKey(3),
                         {"images": images, "labels": labels})
    params = _np_tree(js.params)
    params["linear"]["kernel"] = params["linear"]["kernel"] * 0.1
    params["class_fc"]["kernel"] = params["class_fc"]["kernel"] * 0.01
    js = jeng.set_round_lr(js.replace(params=jax.tree.map(jnp.asarray,
                                                          params)), 0)
    start = flax_image_client_to_torch(params, _np_tree(js.batch_stats))
    old_p, old_bs = js.params, js.batch_stats
    js, _ = jeng.task_step(js, {"images": jnp.asarray(images),
                                "labels": jnp.asarray(labels)})
    after_task = flax_image_client_to_torch(_np_tree(js.params),
                                            _np_tree(js.batch_stats))
    js, jloss = jeng.contrast_step(
        js, old_p, old_bs, {"images": jnp.asarray(pub)},
        {"same": jnp.asarray(g_img), "other": jnp.asarray(g_txt),
         "index": jnp.asarray(idx)}, True, True)
    jfinal = flax_image_client_to_torch(_np_tree(js.params),
                                        _np_tree(js.batch_stats))

    teng = UniClientEngine("img", num_class=C, args=MLP_ARGS, device="cpu")
    ts = teng.set_round_lr(teng.init_state(state_dict=start), 0)
    old = teng.snapshot(ts)
    ts, _ = teng.task_step(ts, {"images": images, "labels": labels})
    t_after_task = {k: v.clone() for k, v in ts.model.state_dict().items()}
    ts, tloss = teng.contrast_step(
        ts, old, {"images": pub},
        {"same": torch.tensor(g_img), "other": torch.tensor(g_txt),
         "index": torch.tensor(idx)}, True, True)
    tfinal = {k: v.clone() for k, v in ts.model.state_dict().items()}
    feats = teng.features_step(ts, {"images": pub})[0]
    return dict(start=start, after_task=after_task, jfinal=jfinal,
                jloss=float(jloss), t_after_task=t_after_task,
                tfinal=tfinal, tloss=float(tloss), feats=feats)


def test_mlp_local_contrast_step_matches_jax(mlp_trajectories):
    t = mlp_trajectories
    np.testing.assert_allclose(t["tloss"], t["jloss"], **TOL)
    assert t["feats"].shape == (B, MLP_WIDTH)
    moved = 0
    for key, want in t["jfinal"].items():
        if key.endswith("num_batches_tracked"):
            continue
        np.testing.assert_allclose(t["tfinal"][key].numpy(), want.numpy(),
                                   err_msg=key, **TOL)
        moved += not np.allclose(want.numpy(), t["start"][key].numpy())
    assert moved > 0


def test_mlp_local_task_step_leaves_head_proj(mlp_trajectories):
    """The task step's graph has no head_proj: its params stay as they
    started in both engines, and the contrast step then moves them."""
    t = mlp_trajectories
    head = [k for k in t["start"] if k.startswith("head_proj.")
            and "running_" not in k and "num_batches" not in k]
    assert len(head) == 6
    for key in head:
        assert torch.equal(t["after_task"][key], t["start"][key]), key
        assert torch.equal(t["t_after_task"][key], t["start"][key]), key
        assert not torch.equal(t["tfinal"][key], t["start"][key]), key

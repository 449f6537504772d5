"""The port's image-client slice end to end vs the JAX package.

Three image clients each run what ``MMFL._run_uni_client`` and
``_uni_client_reps`` do (rounds.py:553-610): a task step, an inter+intra
contrast step, a local test and a feature sweep over the public set with
the BN stats threaded on; then con_w aggregates their representations
(``_distill``'s ``aggregate_modalities``; the JAX package's pads the
three to a bucket of 4, the port sums over the three).

Tolerance: rtol 1e-4 atol 1e-5 (fp32, another summation order). As in
test_torch_client_uni, the start weights scale the linear and class_fc
kernels of flax's init by 0.1 and 0.01, which keeps the x128 feature
scale from amplifying rounding beyond that tolerance.
"""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from creamfl_tpu.engine.client_uni import UniClientEngine as JEngine
from creamfl_tpu.federation.aggregation import aggregate_modalities as j_agg
from creamfl_tpu_torch.engine.client_uni import UniClientEngine
from creamfl_tpu_torch.federation.aggregation import aggregate_modalities
from creamfl_tpu_torch.models.convert import flax_image_client_to_torch
from torch_cpu_share import torch_cpu_share  # noqa: F401

B, IMG, E, C, N_PUB, K = 4, 16, 16, 10, 12, 3
TOL = dict(rtol=1e-4, atol=1e-5)
ARGS = types.SimpleNamespace(img_model_local="resnet6", feature_dim=E,
                             mlp_local=False, interintra_weight=0.5,
                             loss_scale=True)


def _unit(rng, *shape):
    x = rng.normal(size=shape).astype(np.float32)
    return x / np.linalg.norm(x, axis=-1, keepdims=True)


@pytest.fixture(scope="module")
def slice_run():
    rng = np.random.default_rng(11)
    pub = rng.normal(size=(N_PUB, IMG, IMG, 3)).astype(np.float32)
    g_img, g_txt = _unit(rng, N_PUB, E), _unit(rng, N_PUB, E)
    jeng = JEngine("img", num_class=C, args=ARGS)
    teng = UniClientEngine("img", num_class=C, args=ARGS, device="cpu")
    j_reps, t_reps, j_loss, t_loss = [], [], [], []
    for k in range(K):
        images = rng.normal(size=(B, IMG, IMG, 3)).astype(np.float32)
        labels = rng.integers(0, C, size=B).astype(np.int32)
        test = {"images": images[::-1].copy(),
                "labels": labels[::-1].copy()}
        idx = rng.permutation(N_PUB)[:B].astype(np.int32)

        js = jeng.init_state(jax.random.PRNGKey(k),
                             {"images": images, "labels": labels})
        params = jax.tree.map(np.asarray, js.params)
        params["linear"]["kernel"] = params["linear"]["kernel"] * 0.1
        params["class_fc"]["kernel"] = params["class_fc"]["kernel"] * 0.01
        js = jeng.set_round_lr(
            js.replace(params=jax.tree.map(jnp.asarray, params)), 0)
        sd = flax_image_client_to_torch(
            params, jax.tree.map(np.asarray, js.batch_stats))

        old_p, old_bs = js.params, js.batch_stats
        js, m = jeng.task_step(js, {"images": jnp.asarray(images),
                                    "labels": jnp.asarray(labels)})
        globals_ = {"same": jnp.asarray(g_img), "other": jnp.asarray(g_txt),
                    "index": jnp.asarray(idx)}
        js, loss = jeng.contrast_step(js, old_p, old_bs,
                                      {"images": jnp.asarray(pub[idx])},
                                      globals_, True, True)
        jt = jeng.test_step(js, {k_: jnp.asarray(v) for k_, v in
                                 test.items()})
        parts = []
        for s in range(0, N_PUB, B):
            f, bs = jeng.features_step(js, {"images": jnp.asarray(
                pub[s:s + B])})
            js = js.replace(batch_stats=bs)
            parts.append(np.asarray(f))
        j_reps.append(np.concatenate(parts))
        j_loss.append([float(m["loss"]), float(loss)]
                      + [float(x) for x in jt])

        ts = teng.set_round_lr(teng.init_state(state_dict=sd), 0)
        old = teng.snapshot(ts)
        ts, m = teng.task_step(ts, {"images": images, "labels": labels})
        globals_ = {"same": torch.tensor(g_img), "other": torch.tensor(g_txt),
                    "index": torch.tensor(idx)}
        ts, loss = teng.contrast_step(ts, old, {"images": pub[idx]},
                                      globals_, True, True)
        tt = teng.test_step(ts, test)
        t_reps.append(torch.cat([
            teng.features_step(ts, {"images": pub[s:s + B]})[0]
            for s in range(0, N_PUB, B)]))
        t_loss.append([float(m["loss"]), float(loss)]
                      + [float(x) for x in tt])

    j_img, _ = j_agg(jnp.asarray(np.stack(j_reps)), None,
                     jnp.asarray(g_img), jnp.asarray(g_txt))
    t_img, t_txt = aggregate_modalities(torch.stack(t_reps), None,
                                        torch.tensor(g_img),
                                        torch.tensor(g_txt))
    return dict(j_reps=j_reps, t_reps=[r.numpy() for r in t_reps],
                j_loss=j_loss, t_loss=t_loss, j_img=np.asarray(j_img),
                t_img=t_img.numpy(), t_txt=t_txt)


def test_client_losses_and_test_counts(slice_run):
    for jl, tl in zip(slice_run["j_loss"], slice_run["t_loss"]):
        np.testing.assert_allclose(tl[:2], jl[:2], **TOL)
        assert tl[2:] == jl[2:]


def test_client_representations(slice_run):
    for jr, tr in zip(slice_run["j_reps"], slice_run["t_reps"]):
        assert tr.shape == (N_PUB, E)
        np.testing.assert_allclose(tr, jr, **TOL)


def test_con_w_aggregate(slice_run):
    assert slice_run["t_txt"] is None
    np.testing.assert_allclose(slice_run["t_img"], slice_run["j_img"],
                               **TOL)
    # The aggregate is not one client's reps: the weights mix them.
    assert not any(np.allclose(slice_run["t_img"], r)
                   for r in slice_run["t_reps"])


def test_step_timer_counts_phases():
    from creamfl_tpu_torch.utils.profiling import StepTimer

    timer = StepTimer(device="cpu")
    for _ in range(3):
        with timer.phase("a"):
            pass
    with timer.phase("b"):
        pass
    report = timer.report()
    assert report["a_n"] == 3 and report["b_n"] == 1
    assert report["a_s"] >= 0.0 and timer.report() == {}


def test_step_timer_defaults_to_the_card():
    from creamfl_tpu_torch.utils.profiling import StepTimer

    if torch.cuda.is_available():
        assert StepTimer().device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            StepTimer()

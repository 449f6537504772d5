"""Port AdamP and the server optimizer vs the JAX package's optax versions.

AdamP trajectories over several steps on a conv weight, a linear weight,
an embedding table and a bias, with decoupled weight decay, under losses
that drive each branch: a per-row scale-invariant loss on the conv (its
gradient is orthogonal to every output channel: the channel-view
projection), a whole-tensor scale-invariant loss on the linear weight (the
layer-view projection), and a plain loss on the embedding (no projection).
The port keeps torch's layouts ([out, in, kh, kw], [out, in], [vocab, d]),
the JAX side Flax's; the losses are the same functions of the torch-layout
tensor. Then the server optimizer: the model's gradients clipped to global
norm 2 (the criterion's scalars excluded), AdamP over both; and the cosine
round schedule.

Tolerance: rtol 1e-5, atol 1e-6 on parameters of order 1: fp32 elementwise
updates rounded in another order; each step moves a parameter by about
lr = 1e-2, so atol is 1e-4 of a step.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from creamfl_tpu.optim.adamp import adamp as j_adamp
from creamfl_tpu.optim.factory import (cosine_annealing_schedule as
                                       j_cosine)
from creamfl_tpu.optim.factory import make_server_optimizer as j_server_opt
from creamfl_tpu_torch.optim.adamp import AdamP
from creamfl_tpu_torch.optim.factory import (clip_grad_global_norm,
                                             cosine_annealing_schedule,
                                             make_server_optimizer,
                                             set_learning_rate)
from torch_cpu_share import torch_cpu_share  # noqa: F401

TOL = dict(rtol=1e-5, atol=1e-6)
STEPS = 5


def _start(seed):
    rng = np.random.default_rng(seed)
    f = np.float32
    return {
        "conv": rng.normal(size=(8, 4, 3, 3)).astype(f),
        "linear": rng.normal(size=(6, 10)).astype(f),
        "embedding": rng.normal(size=(12, 5)).astype(f),
        "bias": rng.normal(size=(6,)).astype(f),
    }, {
        "c_conv": rng.normal(size=(8, 36)).astype(f),
        "c_lin": rng.normal(size=(6, 10)).astype(f),
        "target": rng.normal(size=(12, 5)).astype(f),
    }


def _loss(t, c, xp):
    """The same loss in numpy-like ``xp`` (jnp or torch) on torch-layout
    tensors ``t``."""
    conv = t["conv"].reshape(8, -1)
    rows = conv / xp.sqrt(xp.sum(conv * conv, 1, keepdims=True))
    lin = t["linear"] / xp.sqrt(xp.sum(t["linear"] * t["linear"]))
    return (xp.sum(c["c_conv"] * rows) + xp.sum(c["c_lin"] * lin)
            + xp.sum((t["embedding"] - c["target"]) ** 2)
            + xp.sum(xp.sin(t["bias"])))


# Flax layout <-> torch layout.
def _to_flax(t):
    return {"conv": {"kernel": t["conv"].transpose(2, 3, 1, 0)},
            "dense": {"kernel": t["linear"].T},
            "embed": {"embedding": t["embedding"]},
            "head": {"bias": t["bias"]}}


def _from_flax(p):
    return {"conv": p["conv"]["kernel"].transpose(3, 2, 0, 1),
            "linear": p["dense"]["kernel"].T,
            "embedding": p["embed"]["embedding"],
            "bias": p["head"]["bias"]}


def _torch_grads(params, c):
    loss = _loss(params, {k: torch.tensor(v) for k, v in c.items()}, torch)
    for p in params.values():
        p.grad = None
    loss.backward()


def _check(tparams, jparams, step):
    want = _from_flax(jax.tree.map(np.asarray, jparams))
    for key, p in tparams.items():
        np.testing.assert_allclose(p.detach().numpy(), want[key],
                                   err_msg=f"{key} step {step}", **TOL)


def test_adamp_trajectory_all_branches():
    start, c = _start(0)
    jc = jax.tree.map(jnp.asarray, c)
    tx = j_adamp(1e-2, weight_decay=1e-2)
    jparams = jax.tree.map(jnp.asarray, _to_flax(start))
    jstate = tx.init(jparams)
    jgrad = jax.grad(lambda p: _loss(_from_flax(p), jc, jnp))
    tparams = {k: torch.tensor(v, requires_grad=True)
               for k, v in start.items()}
    opt = AdamP(tparams.values(), lr=1e-2, weight_decay=1e-2)
    for step in range(STEPS):
        updates, jstate = tx.update(jgrad(jparams), jstate, jparams)
        jparams = optax.apply_updates(jparams, updates)
        _torch_grads(tparams, c)
        opt.step()
        _check(tparams, jparams, step)
    for p in tparams.values():
        assert opt.state[p]["step"] == STEPS


def test_adamp_projection_branches_taken():
    """The losses above do drive the three branches on the first step."""
    from creamfl_tpu_torch.ops.adamp import _project

    start, c = _start(0)
    tparams = {k: torch.tensor(v, requires_grad=True)
               for k, v in start.items()}
    _torch_grads(tparams, c)
    wds, modes = {}, {}
    for key in ("conv", "linear", "embedding"):
        p = tparams[key].detach()
        g = tparams[key].grad
        _, wd, mode = _project(p, g, g.clone(), 0.1, 0.1, 1e-8)
        wds[key] = round(float(wd), 6)
        modes[key] = int(mode)
    assert wds == {"conv": 0.1, "linear": 0.1, "embedding": 1.0}
    assert modes == {"conv": 1, "linear": 2, "embedding": 0}


@pytest.mark.parametrize("weight_decay", [0.0, 1e-2])
def test_adamp_channels_last_equals_contiguous(weight_decay):
    """The plain version steps a channels_last conv weight exactly as its
    contiguous copy: AdamP reads a conv weight by output channel, whatever
    its memory layout, and a channels_last weight keeps each output channel
    contiguous in memory (the rows the CUDA kernel reduces in place)."""
    start, c = _start(0)
    tparams = {k: torch.tensor(v, requires_grad=True)
               for k, v in start.items()}
    conv = torch.tensor(start["conv"]).to(memory_format=torch.channels_last)
    assert not conv.is_contiguous()
    assert conv.stride(0) == conv.numel() // conv.shape[0]
    cl = torch.nn.Parameter(conv)
    opt = AdamP(tparams.values(), lr=1e-2, weight_decay=weight_decay)
    opt_cl = AdamP([cl], lr=1e-2, weight_decay=weight_decay)
    for _ in range(3):
        _torch_grads(tparams, c)
        cl.grad = tparams["conv"].grad.clone().to(
            memory_format=torch.channels_last)
        opt.step()
        opt_cl.step()
        assert cl.is_contiguous(memory_format=torch.channels_last)
        assert torch.equal(cl.detach(), tparams["conv"].detach())
        for key in ("exp_avg", "exp_avg_sq"):
            assert torch.equal(opt_cl.state[cl][key],
                               opt.state[tparams["conv"]][key])


def test_server_optimizer_clips_the_model_only():
    start, c = _start(1)
    crit0 = {"shift": np.array([15.0], np.float32),
             "negative_scale": np.array([15.0], np.float32)}
    jc = jax.tree.map(jnp.asarray, c)

    def j_loss(p):
        # x50: the model's gradient norm is far above the clip of 2; the
        # criterion's gradients (also large) must pass unclipped.
        return (50.0 * _loss(_from_flax(p["model"]), jc, jnp)
                + 40.0 * jnp.sum(p["criterion"]["shift"])
                - 30.0 * jnp.sum(p["criterion"]["negative_scale"] ** 2))

    tx, _ = j_server_opt(learning_rate=1e-2, grad_clip=2.0,
                         weight_decay=1e-3)
    jparams = {"model": jax.tree.map(jnp.asarray, _to_flax(start)),
               "criterion": jax.tree.map(jnp.asarray, crit0)}
    jstate = tx.init(jparams)
    model = {k: torch.tensor(v, requires_grad=True)
             for k, v in start.items()}
    crit = {k: torch.tensor(v, requires_grad=True) for k, v in crit0.items()}
    opt, _ = make_server_optimizer(model.values(), crit.values(), 1e-2,
                                   weight_decay=1e-3)
    tc = {k: torch.tensor(v) for k, v in c.items()}
    for step in range(3):
        updates, jstate = tx.update(jax.grad(j_loss)(jparams), jstate,
                                    jparams)
        jparams = optax.apply_updates(jparams, updates)
        for p in list(model.values()) + list(crit.values()):
            p.grad = None
        (50.0 * _loss(model, tc, torch) + 40.0 * crit["shift"].sum()
         - 30.0 * (crit["negative_scale"] ** 2).sum()).backward()
        crit_grads = [crit[k].grad.clone() for k in crit]
        norm = clip_grad_global_norm(model.values(), 2.0)
        assert float(norm) > 2.0
        clipped = torch.sqrt(sum((p.grad ** 2).sum() for p in model.values()))
        np.testing.assert_allclose(float(clipped), 2.0, rtol=1e-5)
        for k, g in zip(crit, crit_grads):
            assert torch.equal(crit[k].grad, g)
        opt.step()
        _check(model, jparams["model"], step)
        for k in crit:
            np.testing.assert_allclose(
                crit[k].detach().numpy(),
                np.asarray(jparams["criterion"][k]), err_msg=k, **TOL)


def test_clip_below_the_bound_is_identity():
    p = torch.nn.Parameter(torch.ones(3))
    p.grad = torch.tensor([0.1, 0.2, 0.3])
    clip_grad_global_norm([p], 2.0)
    assert torch.equal(p.grad, torch.tensor([0.1, 0.2, 0.3]))


@pytest.mark.parametrize("base_lr,t_max", [(2e-4, 30), (1e-3, 7)])
def test_cosine_round_schedule(base_lr, t_max):
    ours, theirs = cosine_annealing_schedule(base_lr, t_max), j_cosine(
        base_lr, t_max)
    opt = AdamP([torch.nn.Parameter(torch.zeros(1))], lr=base_lr)
    for r in range(t_max + 2):
        np.testing.assert_allclose(ours(r), float(theirs(r)), rtol=1e-6,
                                   atol=1e-12)
        set_learning_rate(opt, ours(r))
        assert opt.param_groups[0]["lr"] == ours(r)

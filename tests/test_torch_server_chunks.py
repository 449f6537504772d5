"""The port's chunked server sweeps (``ServerEngine.*_chunk``) and AdamP's
device-side step, on the CPU.

At ``tests/test_server_chunks.py``'s parity configuration (resnet10, embed
8, the GRU text branch with word_dim 8, PIE's dropout 0, fp32;
k = 4 chunks of 4 captions at 32²):

(a) ``chunk(k)`` equals k chained per-batch steps of the port bit for bit
    (features, losses, parameters, BatchNorm stats, AdamP's moments and
    steps), for all four kinds: on the CPU a chunk IS the k eager steps, in
    order (tolerance: none).
(b) The port's chunks against the JAX package's from the same weights
    (``models.convert``), at the server's lr 2e-4: features and losses
    before any update at rtol 1e-4 (atol 1e-5 of the largest entry);
    losses after an update at rtol and atol 2e-3; each parameter's update
    p - p0 after the k steps within 0.1 relative Frobenius norm of JAX's:
    ``tests/test_torch_server.py``'s bounds (AdamP moves every entry by
    about +-lr, so an entry whose gradient is zero up to rounding may step
    the other way in one framework).
(c) AdamP with its step and lr on the device equals the host-float AdamP of
    the parent format (kept below as ``_FloatStepAdamP``) bit for bit over
    3 steps, with weight decay and a parameter skipped at one step; a state
    dict of the float format (int steps, float lr) loads and steps on bit
    for bit; ``set_learning_rate`` fills the lr tensor in place.
"""

import io
import math

import jax
import numpy as np
import pytest
import torch

from creamfl_tpu.config import default_config_path as j_config_path
from creamfl_tpu.config import parse_config as j_parse_config
from creamfl_tpu.engine.server import ServerEngine as JServer
from creamfl_tpu_torch.config import default_config_path, parse_config
from creamfl_tpu_torch.engine.server import ServerEngine
from creamfl_tpu_torch.models.convert import flax_server_state_to_torch
from creamfl_tpu_torch.ops.adamp import _project
from creamfl_tpu_torch.optim.adamp import AdamP
from creamfl_tpu_torch.optim.factory import set_learning_rate
from torch_cpu_share import torch_cpu_share  # noqa: F401

K, B, IMG, L, VOCAB, E, N_PUB = 4, 4, 32, 6, 23, 8, 16
OVERRIDES = dict(model__embed_dim=E, model__cnn_type="resnet10",
                 model__not_bert=True, model__word_dim=8,
                 train__use_bf16=False)
RTOL, ATOL, AFTER_UPDATE, UPDATE_DIST = 1e-4, 1e-5, 2e-3, 0.1
FLAGS = (True, True, False, 0.3)  # use_img, use_txt, use_mm, kd_weight


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(3)
    images = rng.normal(size=(K, B, IMG, IMG, 3)).astype(np.float32)
    captions = rng.integers(1, VOCAB, size=(K, B, L)).astype(np.int32)
    lengths = rng.integers(2, L + 1, size=(K, B)).astype(np.int32)
    captions *= np.arange(L)[None, None] < lengths[..., None]
    targets = {m: rng.normal(size=(N_PUB, E)).astype(np.float32)
               for m in ("img", "txt")}
    rows = rng.integers(0, N_PUB, size=(K, B)).astype(np.int64)
    return images, captions, lengths, targets, rows


@pytest.fixture(scope="module")
def jax_side(data):
    images, captions, lengths, _, _ = data
    engine = JServer(j_parse_config(j_config_path("coco.yaml"),
                                    strict_cast=False, **OVERRIDES),
                     vocab_size=VOCAB)
    state = engine.init_state(jax.random.PRNGKey(0), {
        "images": images[0], "captions": captions[0],
        "lengths": lengths[0]})
    return engine, state


def _to_torch(jstate):
    return flax_server_state_to_torch(
        jax.tree.map(np.asarray, jstate.params),
        jax.tree.map(np.asarray, jstate.batch_stats))


@pytest.fixture(scope="module")
def start(jax_side):
    return _to_torch(jax_side[1])


def _port(start):
    engine = ServerEngine(parse_config(default_config_path("coco.json"),
                                       strict_cast=False, **OVERRIDES),
                          vocab_size=VOCAB, device="cpu")
    return engine, engine.init_state(state_dict=start)


def _everything(state):
    """Every tensor of the state: model and criterion, AdamP's state."""
    out = {f"model.{k}": v for k, v in state.model.state_dict().items()}
    out.update({f"criterion.{k}": v
                for k, v in state.criterion.state_dict().items()})
    for i, st in enumerate(state.optimizer.state.values()):
        out.update({f"opt.{i}.{k}": v for k, v in st.items()})
    return out


def _assert_bitwise(a, b):
    ta, tb = _everything(a), _everything(b)
    assert ta.keys() == tb.keys() and ta
    for key in ta:
        assert torch.equal(ta[key], tb[key]), key


def _aggregated(targets):
    return {m: torch.from_numpy(v) for m, v in targets.items()}


# -- (a) a chunk is k chained steps, bit for bit ----------------------------
@pytest.mark.parametrize("kind", ["train", "distill", "extract", "eval"])
def test_chunk_is_k_chained_steps(start, data, kind):
    images, captions, lengths, targets, rows = data
    agg = _aggregated(targets)
    eng_a, st_a = _port(start)
    eng_b, st_b = _port(start)
    assert eng_a.chunk_route == "eager"
    if kind == "train":
        st_a, got = eng_a.train_chunk(st_a, images, captions, lengths)
        want = torch.stack([eng_b.train_step(
            st_b, images[i], captions[i], lengths[i])[1]["loss"]
            for i in range(K)])
        assert st_a.step == st_b.step == K
    elif kind == "distill":
        st_a, got = eng_a.distill_chunk(st_a, images, captions, lengths,
                                        None, agg, rows, *FLAGS)
        want = torch.stack([eng_b.distill_step(
            st_b, images[i], captions[i], lengths[i], None, agg, rows[i],
            *FLAGS)[1] for i in range(K)])
        assert st_a.step == st_b.step == K
    else:
        chunk = getattr(eng_a, f"{kind}_chunk")
        step = getattr(eng_b, f"{kind}_step")
        got = torch.cat(chunk(st_a, images, captions, lengths))
        want = torch.cat([torch.stack(o) for o in zip(*(
            step(st_b, images[i], captions[i], lengths[i])
            for i in range(K)))])
    assert got.shape[:1] == want.shape[:1] and torch.equal(got, want)
    _assert_bitwise(st_a, st_b)


# -- (b) the port's chunks against the JAX package's -------------------------
def _close(got, want, name, rtol, atol=0.0):
    want = np.asarray(want)
    np.testing.assert_allclose(
        np.asarray(got), want, rtol=rtol,
        atol=atol * max(1.0, float(np.abs(want).max())), err_msg=name)


def _check_updates(start, got_state, jstate):
    want = _to_torch(jstate)
    got = {f"model.{k}": v for k, v in got_state.model.named_parameters()}
    got.update({f"criterion.{k}": v
                for k, v in got_state.criterion.named_parameters()})
    assert set(got) <= set(want)
    for key, val in got.items():
        s = start[key].numpy()
        dt, dj = val.detach().numpy() - s, want[key].numpy() - s
        dist = np.linalg.norm(dt - dj) / max(np.linalg.norm(dj), 1e-12)
        assert dist <= UPDATE_DIST, f"{key}: update distance {dist:.3g}"


def _check_losses(got, want):
    _close(got[:1], np.asarray(want)[:1], "loss 0", RTOL)
    _close(got[1:], np.asarray(want)[1:], "losses after an update",
           AFTER_UPDATE, AFTER_UPDATE)


def test_train_chunk_matches_jax(start, data, jax_side):
    images, captions, lengths, _, _ = data
    jengine, jstate = jax_side
    jstate, jlosses = jengine.train_chunk(
        jax.tree.map(jax.numpy.array, jstate), images, captions, lengths,
        None, jax.random.PRNGKey(11))
    engine, state = _port(start)
    state, losses = engine.train_chunk(state, images, captions, lengths)
    _check_losses(losses.numpy(), jlosses)
    _check_updates(start, state, jstate)


def test_distill_chunk_matches_jax(start, data, jax_side):
    images, captions, lengths, targets, rows = data
    jengine, jstate = jax_side
    jagg = {m: jax.numpy.asarray(v) for m, v in targets.items()}
    jstate, jlosses = jengine.distill_chunk(
        jax.tree.map(jax.numpy.array, jstate), images, captions, lengths,
        None, jagg, rows.astype(np.int32), *FLAGS, jax.random.PRNGKey(13))
    engine, state = _port(start)
    state, losses = engine.distill_chunk(state, images, captions, lengths,
                                         None, _aggregated(targets), rows,
                                         *FLAGS)
    _check_losses(losses.numpy(), jlosses)
    _check_updates(start, state, jstate)


def test_forward_chunks_match_jax(start, data, jax_side):
    images, captions, lengths, _, _ = data
    jengine, jstate = jax_side
    engine, state = _port(start)
    for kind in ("eval", "extract"):
        if kind == "eval":
            want = jengine.eval_chunk(jstate, images, captions, lengths,
                                      None)
        else:
            *want, bs = jengine.extract_chunk(jstate, images, captions,
                                              lengths, None,
                                              jax.random.PRNGKey(17))
        got = getattr(engine, f"{kind}_chunk")(state, images, captions,
                                               lengths)
        for g, w, what in zip(got, want, ("img", "txt")):
            assert g.shape == (K, B, E)
            _close(g.numpy(), w, f"{kind} {what}", RTOL, ATOL)
    # The running stats the k extraction steps moved.
    want = flax_server_state_to_torch(
        jax.tree.map(np.asarray, jstate.params),
        jax.tree.map(np.asarray, bs))
    for key, val in state.model.state_dict().items():
        if key.endswith(("running_mean", "running_var")):
            _close(val.numpy(), want[f"model.{key}"].numpy(), key, RTOL,
                   ATOL)


# -- (c) AdamP: step and lr on the device -------------------------------------
class _FloatStepAdamP(AdamP):
    """AdamP as it was before its step and lr moved onto the device: host
    int steps, a host float lr and host-float bias corrections (the
    reference this test holds the device version to)."""

    def _update(self, group, params) -> None:
        b1, b2 = group["betas"]
        lr, eps = group["lr"], group["eps"]
        grads = [p.grad for p in params]
        states = [self.state[p] for p in params]
        for p, state in zip(params, states):
            if not state:
                state["step"] = 0
                state["exp_avg"] = torch.zeros_like(p)
                state["exp_avg_sq"] = torch.zeros_like(p)
            state["step"] += 1
        ms = [st["exp_avg"] for st in states]
        vs = [st["exp_avg_sq"] for st in states]
        torch._foreach_mul_(ms, b1)
        torch._foreach_add_(ms, grads, alpha=1 - b1)
        torch._foreach_mul_(vs, b2)
        torch._foreach_addcmul_(vs, grads, grads, value=1 - b2)
        denom = torch._foreach_div(vs, [1.0 - b2 ** st["step"]
                                        for st in states])
        torch._foreach_sqrt_(denom)
        torch._foreach_add_(denom, eps)
        perturb = list(torch._foreach_div(ms, denom))
        for i, (p, g) in enumerate(zip(params, grads)):
            wd = 1.0
            if p.dim() > 1:
                perturb[i], wd, _ = _project(p, g, perturb[i],
                                             group["delta"],
                                             group["wd_ratio"], eps)
            if group["weight_decay"] > 0:
                p.mul_(1.0 - lr * group["weight_decay"] * wd)
        torch._foreach_mul_(perturb, [-lr / (1.0 - b1 ** st["step"])
                                      for st in states])
        torch._foreach_add_(params, perturb)


SHAPES = ((8, 3, 3, 3), (16, 8), (30, 4), (5,), (1,))


def _params():
    g = torch.Generator().manual_seed(1)
    return [torch.nn.Parameter(torch.randn(s, generator=g)) for s in SHAPES]


def _set_grads(params, step, seed=2):
    g = torch.Generator().manual_seed(seed + step)
    for p in params:
        grad = torch.randn(p.shape, generator=g)
        # A scale-invariant direction on one weight: its projection runs.
        if p.dim() == 2 and p.shape[0] == 16:
            grad = grad - p.detach() * (grad * p.detach()).sum() / (
                p.detach() * p.detach()).sum()
        p.grad = None if (step == 1 and p.dim() == 1) else grad


@pytest.mark.parametrize("weight_decay", [0.0, 1e-2])
def test_adamp_device_step_equals_float_step(weight_decay):
    ref, dev = _params(), _params()
    o_ref = _FloatStepAdamP(ref, lr=2e-3, weight_decay=weight_decay)
    o_dev = AdamP(dev, lr=2e-3, weight_decay=weight_decay)
    for step in range(3):
        _set_grads(ref, step)
        _set_grads(dev, step)
        o_ref.step()
        o_dev.step()
        for a, b in zip(ref, dev):
            assert torch.equal(a, b), (step, a.shape)
    for p, q in zip(dev, ref):
        st = o_dev.state[p]
        assert st["step"].dtype == torch.float64 and st["step"].dim() == 0
        assert float(st["step"]) == o_ref.state[q]["step"]
    lr = o_dev.param_groups[0]["lr"]
    assert isinstance(lr, torch.Tensor) and lr.dtype == torch.float64
    set_learning_rate(o_dev, 5e-4)
    assert o_dev.param_groups[0]["lr"] is lr and float(lr) == 5e-4


def test_adamp_loads_the_float_format():
    """A state dict written before the step moved onto the device (int
    steps, float lr), as a ``--resume`` checkpoint of that format holds,
    loads and steps on as the float-step optimizer does."""
    ref = _params()
    o_ref = _FloatStepAdamP(ref, lr=2e-3, weight_decay=1e-2)
    for step in range(2):
        _set_grads(ref, step)
        o_ref.step()
    buf = io.BytesIO()
    torch.save(o_ref.state_dict(), buf)
    buf.seek(0)
    saved = torch.load(buf, weights_only=True)
    assert isinstance(saved["state"][0]["step"], int)
    assert isinstance(saved["param_groups"][0]["lr"], float)
    dev = [torch.nn.Parameter(p.detach().clone()) for p in ref]
    o_dev = AdamP(dev, lr=1.0, weight_decay=1e-2)
    o_dev.load_state_dict(saved)
    for step in range(2, 4):
        _set_grads(ref, step)
        _set_grads(dev, step)
        o_ref.step()
        o_dev.step()
        for a, b in zip(ref, dev):
            assert torch.equal(a, b), (step, a.shape)
    assert float(o_dev.state[dev[0]]["step"]) == 4
    assert math.isclose(float(o_dev.param_groups[0]["lr"]), 2e-3)


def test_adamp_init_state_is_a_fresh_state():
    """``init_state`` (made before a graph capture) makes the state a first
    step would: zero moments, step 0; the step after it is unchanged."""
    a, b = _params(), _params()
    oa, ob = AdamP(a, lr=1e-3), AdamP(b, lr=1e-3)
    ob.init_state()
    assert all(float(ob.state[p]["step"]) == 0 for p in b)
    for step in range(2):
        _set_grads(a, step)
        _set_grads(b, step)
        oa.step()
        ob.step()
    for x, y in zip(a, b):
        assert torch.equal(x, y)

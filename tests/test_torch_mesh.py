"""The port's mesh (``parallel/mesh.py``) at world 2 and 4 against world 1
and against the JAX package's mesh functions, on the CPU over gloo.

Ranks are processes started with ``torch.multiprocessing.spawn`` and a file
store under ``tmp_path``; each runs ``_worker``'s tasks and saves what they
give, and the tests compare. Shapes are tiny: a ``resnet_b2`` trunk (a
two-stage Bottleneck trunk, registered for the ranks and this module), BERT
tiny without dropout, embed 16, 64² images; the round at
``test_torch_round.py``'s sizes.

* Synced ``BatchNorm`` at world 2, each rank on its half of the batch,
  against world 1 on the whole batch and against flax's ``BatchNorm``
  (the JAX package's) on the whole batch: outputs, input, weight and bias
  gradients and running stats, [B, C, H, W] and [B, C], atol 1e-6 scaled
  by the quantity's largest magnitude where that exceeds 1 (as
  ``test_torch_server.py``'s ``_close``: the weight gradient, a sum of 48
  terms near 12, is 1 ulp from another summation order at 1e-6).
* ``con_w_aggregate(mesh=)`` at world 2 and 4 with K = 3 uploads (at
  world 4 a rank holds none) against the JAX package's
  ``con_w_aggregate(..., mesh=make_mesh(4, 1))`` over its bucket of 4
  slots on 4 of the conftest's 8 virtual CPU devices, and the port at
  world 1, atol 1e-6.
* ``best_positive_ranks_sharded`` at world 2 on integer features (ties
  exact) and 13 queries (an uneven split): ranks exactly equal to JAX's
  sharded ranks and to the port's world-1 ranks.
* One server train step and one distill step at world 2 against world 1,
  each from the same weights, a ragged step (5 rows on 2 ranks, run whole
  on each) and a train step with BERT dropout 0.1 (each rank's rows get
  world 1's masks: the mask is drawn for the whole batch), with the JAX
  package's bounds (``tests/test_full_round_mesh.py``): loss rel 1e-5;
  the gradients the step applied and the parameters after it rtol 1e-4 /
  atol 5e-6. Two things outside the DP step bound those: AdamP's first
  step moves a parameter by lr * g / (|g| + 1e-8), which turns the
  summation-order noise of a gradient near 1e-8 into up to 2 lr (at
  gradients below 1e-6 the parameter is held to 2 lr instead); and some
  batches make the step ill conditioned (a relative 1e-7 nudge of the
  images moves world 1's conv gradients by ~0.3 %), where the gradients'
  gap and the count of parameters past the bound are held to 3 times
  world 1's own under that nudge (``_step_gap``).
* One stacked round at world 2 against world 1: a family of 3 image
  clients split 2 + 1 over the ranks, a text and an mm family of 1 that
  leave rank 1 without a member. ``distill_index`` equal; global features
  and aggregates at mean row cosine > 0.99 (the JAX bound); scores equal
  (``approx``); every server and client state bit-equal across the ranks;
  rank 0's round checkpoint, resumed at world 1, restores those states bit
  for bit.
"""

import dataclasses
import os
import types

import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from creamfl_tpu_torch.models import resnet as tresnet
from creamfl_tpu_torch.parallel import mesh as M
from torch_cpu_share import torch_cpu_share  # noqa: F401

TRUNK = "resnet_b2"
BN_ATOL = 1e-6
CONW_ATOL = 1e-6
LOSS_REL, PARAM_RTOL, PARAM_ATOL = 1e-5, 1e-4, 5e-6
# Gradients below this take AdamP's first step ill conditioned
# (``_step_gap``); the server step's distance from world 1 where it is ill
# conditioned, in units of world 1's own under a 1e-7 nudge.
ILL_GRAD, SPREAD = 1e-6, 3.0
COSINE = 0.99
ROUND_SIZES = dict(pub_size=16, image_size=32, max_len=8,
                   client_data_size=8, test_size=8, retrieval_test_size=20,
                   batch_size=8)


def _register_trunk():
    tresnet.RESNET_CONFIGS.setdefault(TRUNK, (tresnet.Bottleneck, (1, 1),
                                              512))


# ---------------------------------------------------------------------------
# the tasks, each run at world 1 (mesh None) here and at world 2 / 4 by the
# ranks
# ---------------------------------------------------------------------------

def _bn_inputs(shape):
    rng = np.random.default_rng(len(shape))
    x = torch.from_numpy(rng.normal(2.0, 3.0, shape)).float()
    g = torch.from_numpy(rng.normal(size=shape)).float()
    c = shape[1]
    weight = torch.from_numpy(rng.uniform(0.5, 1.5, c)).float()
    bias = torch.from_numpy(rng.normal(size=c)).float()
    run_mean = torch.from_numpy(rng.normal(1.5, 0.5, c)).float()
    run_var = torch.from_numpy(rng.uniform(0.5, 2.0, c)).float()
    return x, g, weight, bias, run_mean, run_var


def task_bn(mesh):
    """A train-mode BatchNorm step on each rank's rows of an 8-row batch,
    the loss sum(y * g) over the whole batch."""
    out = {}
    for shape in ((8, 5, 3, 2), (8, 6)):
        x, g, weight, bias, run_mean, run_var = _bn_inputs(shape)
        bn = tresnet.BatchNorm(shape[1])
        with torch.no_grad():
            bn.weight.copy_(weight)
            bn.bias.copy_(bias)
            bn.running_mean.copy_(run_mean)
            bn.running_var.copy_(run_var)
        tresnet.set_batchnorm_mesh(bn, mesh)
        rows = M.shard_rows(mesh, shape[0])
        xr = x[rows].clone().requires_grad_(True)
        y = bn(xr)
        (y * g[rows]).sum().backward()
        M.all_reduce_grads(mesh, bn.parameters())
        out[len(shape)] = dict(
            y=M.all_gather_rows(mesh, y.detach()),
            dx=M.all_gather_rows(mesh, xr.grad), dw=bn.weight.grad.clone(),
            db=bn.bias.grad.clone(), mean=bn.running_mean.clone(),
            var=bn.running_var.clone())
    return out


def _conw_inputs():
    rng = np.random.default_rng(7)
    reps = rng.normal(size=(3, 24, 8)).astype(np.float32)
    reps /= np.linalg.norm(reps, axis=-1, keepdims=True)
    other = rng.normal(size=(24, 8)).astype(np.float32)
    other /= np.linalg.norm(other, axis=-1, keepdims=True)
    return reps, other


def task_conw(mesh):
    """K = 3 uploads laid out over the ranks as ``P("client")`` lays out
    the JAX package's stack: contiguous blocks of ceil(K / world)."""
    from creamfl_tpu_torch.federation.aggregation import con_w_aggregate

    reps, other = _conw_inputs()
    reps = torch.from_numpy(reps)
    if mesh is None:
        return con_w_aggregate(reps, torch.from_numpy(other))
    per = -(-len(reps) // mesh.world)
    slots = [r if i // per == mesh.rank else None
             for i, r in enumerate(reps)]
    return con_w_aggregate(slots, torch.from_numpy(other), mesh=mesh)


def _rank_inputs():
    rng = np.random.default_rng(11)
    q = rng.integers(-2, 3, (13, 6)).astype(np.float32)
    g = rng.integers(-2, 3, (10, 6)).astype(np.float32)
    ql = rng.integers(0, 5, 13)
    gl = np.arange(10) % 5
    return q, g, ql, gl


def task_rank(mesh):
    from creamfl_tpu_torch.engine.evaluator import best_positive_ranks_sharded

    q, g, ql, gl = (torch.from_numpy(a) for a in _rank_inputs())
    return best_positive_ranks_sharded(q, g, ql, gl, mesh, block_size=4)


def _server_configs():
    from creamfl_tpu_torch.main import build_configs
    from creamfl_tpu_torch.models.bert import BertConfig

    args = types.SimpleNamespace(feature_dim=16, not_bert=False,
                                 server_lr=1e-4, smoke=True, cosine_t_max=0)
    server, _, _ = build_configs(args)
    server.model.cnn_type = TRUNK
    server.train.use_bf16 = False
    bert = dataclasses.replace(BertConfig.tiny(), dropout_rate=0.0)
    return server, bert


def _server_batch(n, seed, vocab, nudge=0.0):
    rng = np.random.default_rng(seed)
    images = rng.normal(size=(n, 64, 64, 3)).astype(np.float32)
    if nudge:
        images = images * (1 + nudge * np.random.default_rng(99).normal(
            size=images.shape)).astype(np.float32)
    ids = rng.integers(4, vocab, (n, 10)).astype(np.int64)
    mask = np.zeros((n, 10), np.int64)
    for i, length in enumerate(rng.integers(3, 11, n)):
        mask[i, :length] = 1
    return images, ids * mask, mask.sum(-1).astype(np.int32), mask


def task_server(mesh, nudge: float = 0.0):
    """From one seed's weights each time: a train step and a distill step
    (8 rows), a ragged train step (5 rows) and a train step with dropout,
    the images moved by a relative ``nudge`` (seeded). Keeps each step's
    loss, the parameters after it and the model's gradients it applied."""
    from creamfl_tpu_torch.engine.server import ServerEngine

    _register_trunk()
    server_cfg, bert = _server_configs()
    engine = None
    rng = np.random.default_rng(3)
    targets = torch.from_numpy(rng.normal(size=(20, 16)).astype(np.float32))
    rows = rng.permutation(20)[:8]
    steps = {
        "train": lambda st: engine.train_step(
            st, *_server_batch(8, 1, 60, nudge))[1]["loss"],
        "distill": lambda st: engine.distill_step(
            st, *_server_batch(8, 2, 60, nudge),
            {"img": targets, "txt": targets.flip(0)}, rows, True, True,
            True, 0.3)[1],
        "ragged": lambda st: engine.train_step(
            st, *_server_batch(5, 4, 60, nudge))[1]["loss"],
        "dropout": lambda st: engine.train_step(
            st, *_server_batch(8, 6, 60, nudge))[1]["loss"],
    }
    out = {}
    for name, step in steps.items():
        # A fresh engine each time: init_state re-draws the convs and
        # linears but keeps a model's BatchNorm weights and stats.
        engine = ServerEngine(
            server_cfg, 60, device="cpu", mesh=mesh,
            bert_config=(dataclasses.replace(bert, dropout_rate=0.1)
                         if name == "dropout" else bert))
        state = engine.init_state(seed=5)
        torch.manual_seed(11)
        loss = step(state)
        out[name] = dict(loss=loss.clone(),
                         params=engine.state_dict_of(state),
                         grads={f"model.{k}": p.grad.clone() for k, p in
                                state.model.named_parameters()})
    return out


def _round_args(tmp, mesh):
    return types.SimpleNamespace(
        name="mesh", exp_dir=str(tmp), local_epochs=1, comm_rounds=1,
        img_model_local="resnet10", seed=3, num_img_clients=3,
        num_txt_clients=1, num_mm_clients=1, client_num_per_round=5,
        batch_size=8, alpha=0.5, server_lr=1e-4, disable_distill=False,
        agg_method="con_w", contrast_local_intra=True,
        contrast_local_inter=True, mlp_local=False, kd_weight=0.3,
        interintra_weight=0.5, loss_scale=False, save_client=False,
        pub_data_num=32, feature_dim=16, not_bert=True, smoke=True,
        synthetic=True, client_parallel=True, use_mesh=mesh is not None,
        ckpt_dir=os.path.join(str(tmp), "ck"), wandb=False)


def _round_parts(args):
    from creamfl_tpu_torch.data.pipelines import build_synthetic_datasets
    from creamfl_tpu_torch.main import build_configs

    server, mm, bert = build_configs(args)
    for cfg in (server, mm):
        cfg.model.cnn_type = "resnet10"
        cfg.model.word_dim = 8
        cfg.train.use_bf16 = False
    return build_synthetic_datasets(args, **ROUND_SIZES), server, mm, bert


def task_round(mesh, tmp):
    from creamfl_tpu_torch.federation.rounds import MMFL

    args = _round_args(tmp, mesh)
    datasets, server, mm, bert = _round_parts(args)
    algo = MMFL(args, datasets, server, mm, bert_config=bert, device="cpu",
                mesh=mesh)
    scores = algo.train(0)
    return dict(scores=scores, distill_index=algo.distill_index,
                img=algo.global_img_feature, txt=algo.global_txt_feature,
                img_vec=algo.img_vec, txt_vec=algo.txt_vec,
                server=algo.server_state.state_dict(),
                clients=[c.state.state_dict() for c in algo.clients])


def _worker(rank, world, tmp, tasks):
    torch.set_num_threads(1)
    _register_trunk()
    mesh = M.init_distributed(f"file://{tmp}/store", world, rank,
                              device="cpu")
    try:
        out = {name: (task_round(mesh, tmp) if name == "round"
                      else globals()[f"task_{name}"](mesh))
               for name in tasks}
        torch.save(out, os.path.join(tmp, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


def _spawn(tmp, world, tasks):
    mp.spawn(_worker, args=(world, str(tmp), tasks), nprocs=world,
             join=True)
    return [torch.load(os.path.join(str(tmp), f"rank{r}.pt"),
                       weights_only=False) for r in range(world)]


@pytest.fixture(scope="module", autouse=True)
def _one_thread_and_trunk():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    had = TRUNK in tresnet.RESNET_CONFIGS
    _register_trunk()
    yield
    torch.set_num_threads(n)
    if not had:
        del tresnet.RESNET_CONFIGS[TRUNK]


@pytest.fixture(scope="module")
def world2_dir(tmp_path_factory):
    return tmp_path_factory.mktemp("world2")


@pytest.fixture(scope="module")
def world2(world2_dir):
    return _spawn(world2_dir, 2, ["bn", "conw", "rank", "server", "round"])


@pytest.fixture(scope="module")
def world4(tmp_path_factory):
    return _spawn(tmp_path_factory.mktemp("world4"), 4, ["conw"])


@pytest.fixture(scope="module")
def round1(tmp_path_factory):
    return task_round(None, tmp_path_factory.mktemp("world1"))


# ---------------------------------------------------------------------------
# the tests
# ---------------------------------------------------------------------------

def _np(t):
    return t.detach().numpy() if isinstance(t, torch.Tensor) else t


def _flax_bn(shape):
    """flax's BatchNorm (the JAX package's, momentum 0.9) on the whole
    batch: y, dx, dscale, dbias and the new running stats."""
    import jax
    import jax.numpy as jnp
    from flax import linen as nn

    x, g, weight, bias, run_mean, run_var = (a.numpy()
                                             for a in _bn_inputs(shape))
    perm = (0, 2, 3, 1) if len(shape) == 4 else (0, 1)
    xj, gj = jnp.asarray(x.transpose(perm)), jnp.asarray(g.transpose(perm))
    bn = nn.BatchNorm(use_running_average=False, momentum=0.9,
                      epsilon=1e-5)
    variables = {"params": {"scale": jnp.asarray(weight),
                            "bias": jnp.asarray(bias)},
                 "batch_stats": {"mean": jnp.asarray(run_mean),
                                 "var": jnp.asarray(run_var)}}

    def loss(params, xx):
        y, upd = bn.apply({"params": params,
                           "batch_stats": variables["batch_stats"]}, xx,
                          mutable=["batch_stats"])
        return (y * gj).sum(), (y, upd)

    (_, (y, upd)), (dp, dx) = jax.value_and_grad(
        loss, argnums=(0, 1), has_aux=True)(variables["params"], xj)
    inv = tuple(np.argsort(perm))
    return dict(y=np.asarray(y).transpose(inv),
                dx=np.asarray(dx).transpose(inv), dw=np.asarray(dp["scale"]),
                db=np.asarray(dp["bias"]),
                mean=np.asarray(upd["batch_stats"]["mean"]),
                var=np.asarray(upd["batch_stats"]["var"]))


@pytest.mark.parametrize("ndim", [4, 2])
def test_synced_batchnorm(world2, ndim):
    one = task_bn(None)[ndim]
    flax = _flax_bn((8, 5, 3, 2) if ndim == 4 else (8, 6))
    for rank_out in world2:
        got = rank_out["bn"][ndim]
        for k in ("y", "dx", "dw", "db", "mean", "var"):
            atol = BN_ATOL * max(1.0, float(np.abs(flax[k]).max()))
            np.testing.assert_allclose(_np(got[k]), _np(one[k]), rtol=0,
                                       atol=atol, err_msg=f"{k} world 1")
            np.testing.assert_allclose(_np(got[k]), flax[k], rtol=0,
                                       atol=atol, err_msg=f"{k} flax")
    # The running stats are identical on every rank.
    for k in ("mean", "var"):
        assert torch.equal(world2[0]["bn"][ndim][k], world2[1]["bn"][ndim][k])


def _jax_conw():
    import jax
    import jax.numpy as jnp

    from creamfl_tpu.federation.aggregation import (
        _bucketed as j_bucketed, con_w_aggregate as j_con_w)
    from creamfl_tpu.parallel.mesh import make_mesh

    reps, other = _conw_inputs()
    padded, mask = j_bucketed(jnp.asarray(reps), multiple_of=4)
    mesh = make_mesh(4, 1, devices=jax.devices()[:4])
    return np.asarray(j_con_w(padded, jnp.asarray(other), k_mask=mask,
                              mesh=mesh))


@pytest.mark.parametrize("world", [2, 4])
def test_conw_over_the_client_axis(world, world2, world4):
    ranks = world2 if world == 2 else world4
    want = _jax_conw()
    one = _np(task_conw(None))
    np.testing.assert_allclose(one, want, rtol=0, atol=CONW_ATOL)
    for out in ranks:
        np.testing.assert_allclose(_np(out["conw"]), want, rtol=0,
                                   atol=CONW_ATOL)
        np.testing.assert_allclose(_np(out["conw"]), one, rtol=0,
                                   atol=CONW_ATOL)
    assert all(torch.equal(out["conw"], ranks[0]["conw"]) for out in ranks)


def test_sharded_ranking_exact(world2):
    import jax
    import jax.numpy as jnp

    from creamfl_tpu.engine.evaluator import (
        best_positive_ranks_sharded as j_sharded)
    from creamfl_tpu.parallel.mesh import make_mesh

    q, g, ql, gl = _rank_inputs()
    want = np.asarray(j_sharded(jnp.asarray(q), jnp.asarray(g),
                                jnp.asarray(ql), jnp.asarray(gl),
                                make_mesh(4, 1, devices=jax.devices()[:4]),
                                block_size=4))
    one = task_rank(None).numpy()
    np.testing.assert_array_equal(one, want)
    for out in world2:
        np.testing.assert_array_equal(out["rank"].numpy(), want)


def _step_gap(got, want, lr):
    """(loss rel gap, the gradients' relative gap over all tensors, the
    parameters outside rtol PARAM_RTOL / atol PARAM_ATOL where AdamP's
    first step is well conditioned) of one step's result against a
    reference's. AdamP's first step moves a parameter by
    lr * g / (|g| + 1e-8): at gradients below ILL_GRAD the summation order
    of g moves it by up to 2 lr, so those parameters are held to that bound
    and not counted."""
    num = den = 0.0
    for k, g in want["grads"].items():
        num += float((got["grads"][k] - g).double().square().sum())
        den += float(g.double().square().sum())
    over = 0
    for k, w in want["params"].items():
        a, b = _np(got["params"][k]), _np(w)
        if not w.is_floating_point():
            over += int(not np.array_equal(a, b))
            continue
        assert np.all(np.abs(a - b) <= 2 * lr * 1.0001), k
        g = want["grads"].get(k)
        fine = (np.ones(b.shape, bool) if g is None
                else np.abs(_np(g)) >= ILL_GRAD)
        over += int((np.abs(a - b) > PARAM_ATOL + PARAM_RTOL * np.abs(b))
                    [fine].sum())
    loss_rel = abs(float(got["loss"]) - float(want["loss"])) / abs(
        float(want["loss"]))
    return loss_rel, (num / den) ** 0.5, over


def test_server_dp_steps(world2):
    """The loss at the JAX bound; the gradients and the parameters at the
    JAX bound, or within SPREAD times world 1's own distance under a
    relative 1e-7 nudge of the images where the step is ill conditioned;
    the ranks bit-equal."""
    one = task_server(None)
    nudged = task_server(None, nudge=1e-7)
    lr = _server_configs()[0].optimizer.learning_rate
    for out in world2:
        for stage, want in one.items():
            loss_rel, gap, over = _step_gap(out["server"][stage], want, lr)
            _, spread_gap, spread_over = _step_gap(nudged[stage], want, lr)
            assert loss_rel <= LOSS_REL, (stage, loss_rel)
            assert gap <= max(PARAM_RTOL, SPREAD * spread_gap), (
                stage, gap, spread_gap)
            assert over <= SPREAD * spread_over, (stage, over, spread_over)
    for stage in one:
        a = world2[0]["server"][stage]["params"]
        b = world2[1]["server"][stage]["params"]
        assert all(torch.equal(a[k], b[k]) for k in a), stage


def _mean_cos(a, b):
    a, b = _np(a).astype(np.float64), _np(b).astype(np.float64)
    num = (a * b).sum(-1)
    den = np.linalg.norm(a, axis=-1) * np.linalg.norm(b, axis=-1)
    return float((num / np.maximum(den, 1e-12)).mean())


def _equal_tree(a, b, name):
    if isinstance(a, torch.Tensor):
        assert torch.equal(a, b), name
    elif isinstance(a, dict):
        assert a.keys() == b.keys(), name
        for k in a:
            _equal_tree(a[k], b[k], f"{name}.{k}")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), name
        for i, (x, y) in enumerate(zip(a, b)):
            _equal_tree(x, y, f"{name}[{i}]")
    else:
        assert a == b, name


def test_round_at_world_2(world2, round1):
    r0, r1 = world2[0]["round"], world2[1]["round"]
    for r in (r0, r1):
        assert np.array_equal(r["distill_index"], round1["distill_index"])
        for k in ("img", "txt", "img_vec", "txt_vec"):
            assert _mean_cos(r[k], round1[k]) > COSINE, k
        for task in ("i2t", "t2i"):
            for metric in ("recall_1", "recall_5", "recall_10"):
                assert r["scores"][task][metric] == pytest.approx(
                    round1["scores"][task][metric]), (task, metric)
    _equal_tree(r0["server"], r1["server"], "server")
    _equal_tree(r0["clients"], r1["clients"], "clients")
    for k in ("img", "txt", "img_vec", "txt_vec"):
        assert torch.equal(r0[k], r1[k]), k


def test_world_2_checkpoint_resumes_at_world_1(world2, world2_dir):
    """Rank 0 wrote the round's checkpoint; a world-1 ``MMFL`` over it
    restores rank 0's states bit for bit."""
    from creamfl_tpu_torch.federation.rounds import MMFL

    r0 = world2[0]["round"]
    args = _round_args(world2_dir, None)
    datasets, server, mm, bert = _round_parts(args)
    algo = MMFL(args, datasets, server, mm, bert_config=bert, device="cpu")
    assert algo.resume() == 1
    _equal_tree(algo.server_state.state_dict(), r0["server"], "server")
    _equal_tree([c.state.state_dict() for c in algo.clients], r0["clients"],
                "clients")

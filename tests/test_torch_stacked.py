"""The port's stacked client branch (the default, ``client_parallel``)
against its sequential branch and against the JAX package's stacked round,
from the same weights.

One round at ``test_torch_round.py``'s sizes (resnet10, fp32, a 16-row
public set at 32², ``--not_bert`` server) on 2 img + 2 txt + 1 mm clients,
4 of them sampled, so that at least one family has two members and its
gallery CEs run as one segmented K3 call. The initial weights are the JAX
``MMFL``'s, converted (``_client_state_dicts``), with the image clients'
heads scaled as in ``test_torch_client_uni.py``: from the plain init the
x128 feature scale puts their logits in the hundreds, where the trajectory
amplifies fp32 rounding past every tolerance (the port on one CPU thread
against the port on eight moved an image client's reps by 0.14; from the
scaled start the round is within 2e-3 of JAX's on 1, 2, 4 and 8 threads).

- Against the JAX stacked round (``client_parallel=True, use_mesh=False``):
  ``test_torch_round.py``'s tolerances (``_after``: 2e-3, or twice the
  port's own spread from 1e-7-perturbed weights; the server's parameters
  by their update, ``UPDATE_DIST``).
- Against the port's sequential round: within 1e-5. The two branches walk
  the shuffled public loader a different number of times a round (once
  per family or once per client; in the JAX package as here), so this
  pair runs with the public loader unshuffled: then every client sees the
  same batches in both.
- ``--stack_bucket even | pow2 | none``: identical results on a family of
  three text clients, where the JAX package pads ``even`` and ``pow2`` by
  one slot and ``none`` by none (the port logs the count and runs no pad
  slot). A family of two, as in the rounds above, pads by none under
  every policy.
"""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from creamfl_tpu.data.pipelines import build_synthetic_datasets as j_build
from creamfl_tpu.federation.rounds import MMFL as JMMFL
from creamfl_tpu.main import build_configs as j_build_configs
from creamfl_tpu_torch.data.pipelines import build_synthetic_datasets
from creamfl_tpu_torch.federation import stacked
from creamfl_tpu_torch.federation.rounds import MMFL
from creamfl_tpu_torch.main import build_configs
from creamfl_tpu_torch.models.convert import flax_server_state_to_torch
from test_torch_round import (SIZES, UPDATE_DIST, _after, _args,
                              _client_state_dicts, _configs, _host, _Log, _np,
                              _perturbed, _record)
from torch_cpu_share import torch_cpu_share  # noqa: F401

CLIENTS = dict(num_img_clients=2, num_txt_clients=2, num_mm_clients=1,
               client_num_per_round=4)
SEQ_TOL = 1e-5


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One torch thread for this module's tiny rounds: the suite runs in
    parallel workers, and each worker's default of one thread per core
    oversubscribes the host."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _port_round(tmp, server_sd, client_sds, shuffle=True, **kw):
    args = _args(tmp, **{**CLIENTS, "client_parallel": True, **kw})
    server, mm, bert = _configs(build_configs, args)
    datasets = build_synthetic_datasets(args, **SIZES)
    datasets["pub_train"].shuffle = shuffle
    log = _Log()
    algo = MMFL(args, datasets, server, mm, bert_config=bert, logger=log,
                device="cpu")
    algo.load_state_dicts(server=server_sd, clients=client_sds)
    evals = []
    _record(algo.evaluator, "extract_features", evals)
    scores = algo.train(0)
    return dict(algo=algo, log=log, evals=evals, scores=scores)


@pytest.fixture(scope="module")
def rounds(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("stacked")
    jargs = _args(tmp / "jax", **dict(CLIENTS, client_parallel=True))
    jserver, jmm, jbert = _configs(j_build_configs, jargs)
    jlog = _Log()
    jalgo = JMMFL(jargs, j_build(jargs, **SIZES), jserver, jmm,
                  bert_config=jbert, logger=jlog)
    for c in jalgo.clients:
        if c.kind == "img":
            params = _np(c.state.params)
            params["linear"]["kernel"] = params["linear"]["kernel"] * 0.1
            params["class_fc"]["kernel"] = params["class_fc"]["kernel"] * 0.01
            c.state = c.state.replace(params=jax.tree.map(jnp.asarray,
                                                          params))
    server_sd = flax_server_state_to_torch(_np(jalgo.server_state.params),
                                           _np(jalgo.server_state.batch_stats))
    client_sds = _client_state_dicts(jalgo)
    j_distill, j_eval = [], []
    _record(jalgo, "_distill", j_distill)
    _record(jalgo.evaluator, "extract_features", j_eval)
    jscores = jalgo.train(0)
    gen = torch.Generator().manual_seed(1)
    out = dict(jalgo=jalgo, jlog=jlog, jscores=jscores, j_distill=j_distill,
               j_eval=j_eval, server_sd=server_sd)
    out["stacked"] = _port_round(tmp / "stacked", server_sd, client_sds)
    out["perturbed"] = _port_round(
        tmp / "perturbed", _perturbed(server_sd, gen),
        [_perturbed(sd, gen) for sd in client_sds])
    for name, parallel in (("seq_fixed", False), ("stacked_fixed", True)):
        out[name] = _port_round(tmp / name, server_sd, client_sds,
                                shuffle=False, client_parallel=parallel)
    return out


def _trained(log):
    return [m for m in log.lines
            if isinstance(m, str) and m.startswith("Training ")]


def _server_state(algo):
    sd = {f"model.{k}": v for k, v in
          algo.server_state.model.state_dict().items()}
    sd.update({f"criterion.{k}": v for k, v in
               algo.server_state.criterion.state_dict().items()})
    return sd


def _uploads(algo):
    """{(modality, client_idx): its uploaded reps}, from the upload order
    of its branch: by family in first-seen order (stacked) or in sampled
    order (sequential); mm clients upload both modalities."""
    kind = {c.client_idx: c.kind for c in algo.clients}
    order = algo.sampled
    if algo.args.client_parallel:
        families = list(dict.fromkeys(kind[i] for i in order))
        order = [i for f in families for i in order if kind[i] == f]
    out = {}
    for mod, reps in (("img", algo.img_reps), ("txt", algo.txt_reps)):
        owners = [i for i in order if kind[i] in (mod, "mm")]
        assert len(owners) == reps.shape[0]
        out.update({(mod, i): reps[k] for k, i in enumerate(owners)})
    return out


def test_stacked_samples_same_clients_as_jax(rounds):
    t = rounds["stacked"]
    assert _trained(t["log"]) == _trained(rounds["jlog"])
    assert any("(stacked x2)" in m for m in _trained(t["log"]))
    np.testing.assert_array_equal(t["algo"].distill_index,
                                  rounds["jalgo"].distill_index)


def test_stacked_reps_and_con_w_match_jax(rounds):
    img_vecs, txt_vecs = rounds["j_distill"][0][0]
    t, p = rounds["stacked"]["algo"], rounds["perturbed"]["algo"]
    assert t.img_reps.shape[0] == len(img_vecs)
    assert t.txt_reps.shape[0] == len(txt_vecs)
    for k, want in enumerate(img_vecs):
        _after(t.img_reps[k], want, f"img reps {k}", p.img_reps[k])
    for k, want in enumerate(txt_vecs):
        _after(t.txt_reps[k], want, f"txt reps {k}", p.txt_reps[k])
    _after(t.img_vec, rounds["jalgo"].img_vec, "con_w img", p.img_vec)
    _after(t.txt_vec, rounds["jalgo"].txt_vec, "con_w txt", p.txt_vec)


def test_stacked_server_after_distill_matches_jax(rounds):
    j, t = rounds["jalgo"], rounds["stacked"]["algo"]
    p = rounds["perturbed"]["algo"]
    want = flax_server_state_to_torch(_np(j.server_state.params),
                                      _np(j.server_state.batch_stats))
    params = {f"model.{k}" for k, _ in
              t.server_state.model.named_parameters()}
    params |= {f"criterion.{k}" for k, _ in
               t.server_state.criterion.named_parameters()}
    got, other = _server_state(t), _server_state(p)
    for key, val in want.items():
        if key.endswith("num_batches_tracked"):
            continue
        if key in params:
            start = rounds["server_sd"][key].numpy()
            dt, dj = _host(got[key]) - start, val.numpy() - start
            dist = np.linalg.norm(dt - dj) / max(np.linalg.norm(dj), 1e-12)
            assert dist <= UPDATE_DIST, f"{key}: update distance {dist:.3g}"
        else:
            _after(got[key], val.numpy(), key, other[key])
    js, ts = rounds["jscores"], rounds["stacked"]["scores"]
    n_q = {"i2t": len(rounds["j_eval"][0][1]["image_features"]),
           "t2i": len(rounds["j_eval"][0][1]["caption_features"])}
    for task in ("i2t", "t2i"):
        for k in ("recall_1", "recall_5", "recall_10"):
            assert abs(ts[task][k] - js[task][k]) <= 100.0 / n_q[task] + 1e-9


def test_stacked_equals_sequential(rounds):
    """Same sampled clients; each client's uploads, both con_w aggregates
    and the server's state after distillation within 1e-5."""
    s, q = rounds["stacked_fixed"]["algo"], rounds["seq_fixed"]["algo"]
    assert s.sampled == q.sampled
    assert sum(m.startswith("Training Client")
               for m in _trained(rounds["seq_fixed"]["log"])) == 4
    got, want = _uploads(s), _uploads(q)
    assert got.keys() == want.keys()
    for key in want:
        np.testing.assert_allclose(got[key], want[key], rtol=0, atol=SEQ_TOL,
                                   err_msg=str(key))
    for name in ("img_vec", "txt_vec", "global_img_feature"):
        np.testing.assert_allclose(getattr(s, name), getattr(q, name),
                                   rtol=0, atol=SEQ_TOL, err_msg=name)
    a, b = _server_state(s), _server_state(q)
    for key in b:
        np.testing.assert_allclose(a[key].double(), b[key].double(), rtol=0,
                                   atol=SEQ_TOL, err_msg=key)
    assert s.server_state.step == q.server_state.step == 4


def test_stack_bucket_policies_give_identical_rounds(tmp_path):
    """A round of three text clients under each policy: the same results
    bit for bit, and the pad count of the JAX package logged."""
    out = {}
    for policy in ("even", "pow2", "none"):
        args = _args(tmp_path / policy, num_img_clients=0, num_txt_clients=3,
                     num_mm_clients=0, client_num_per_round=3,
                     client_parallel=True, stack_bucket=policy)
        server, mm, bert = _configs(build_configs, args)
        log = _Log()
        algo = MMFL(args, build_synthetic_datasets(args, **SIZES), server, mm,
                    bert_config=bert, logger=log, device="cpu")
        out[policy] = (algo, algo.train(0), log)
    base, scores, _ = out["even"]
    assert any("(stacked x3)" in m for m in _trained(out["even"][2]))
    for policy, (algo, other_scores, log) in out.items():
        pads = [m for m in log.lines
                if isinstance(m, str) and "pad slots" in m]
        assert pads == ([] if policy == "none" else [
            f"txt family: client axis 3+1 pad slots (stack bucket "
            f"{policy}); the port runs no pad slot"]), policy
        assert algo.sampled == base.sampled
        assert other_scores == scores
        for attr in ("txt_reps", "txt_vec"):
            assert torch.equal(getattr(algo, attr),
                               getattr(base, attr)), (policy, attr)
        for key, val in _server_state(base).items():
            assert torch.equal(_server_state(algo)[key], val), key


@pytest.mark.parametrize("policy", ["even", "pow2", "none"])
def test_stack_pad_matches_jax(tmp_path, policy):
    """The pad count the port logs is the JAX package's single-device
    ``_group_sharding`` pad."""
    jself = types.SimpleNamespace(mesh=None, args=types.SimpleNamespace(
        stack_bucket=policy))
    for n in range(1, 10):
        assert JMMFL._group_sharding(jself, n) == (
            None, stacked.stack_pad(n, policy)), n

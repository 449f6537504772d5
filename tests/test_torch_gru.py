"""Port GRU text modules vs the JAX package, at ragged lengths.

``BiGRU`` (outputs and final state, and gradients), ``TextClientNet`` in
every phase with and without ``--mlp_local``, and ``PCME(not_bert=True)``
(the mm clients' PCME: ResNet trunk + GRU text branch), with the JAX
weights carried over by ``models.convert``. The JAX BiGRU is a masked
``lax.scan``; the port's is ``torch.nn.GRU`` over packed sequences, so the
gate order and the candidate's ``r * (W_hn h + b_hn)`` are checked here by
value, not assumed.

Tolerance: fp32 on both sides, rtol 1e-5 and atol 1e-6 of the largest
reference entry (another summation order). With ``--mlp_local`` the
TextClientNet and PCME checks take rtol 1e-4 and atol 1e-5 of the
largest entry, as ``test_torch_pcme.py``: head_proj's train-mode
BatchNorm over a batch of 5 amplifies rounding (8e-6 at 1e-5).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from creamfl_tpu.engine.client_uni import _deep_merge
from creamfl_tpu.models.clients import TextClientNet as JTextClient
from creamfl_tpu.models.gru import BiGRU as JBiGRU
from creamfl_tpu.models.pcme import PCME as JPCME
from creamfl_tpu_torch.models.clients import TextClientNet
from creamfl_tpu_torch.models.convert import (flax_bigru_to_torch,
                                              flax_pcme_to_torch,
                                              flax_text_client_to_torch)
from creamfl_tpu_torch.models.gru import BiGRU, gather_last_valid
from creamfl_tpu_torch.models.pcme import PCME
from torch_cpu_share import torch_cpu_share  # noqa: F401

B, L, V, WD = 5, 9, 40, 12
LENGTHS = np.array([9, 1, 6, 3, 9], np.int32)  # ragged, incl. 1 and L
GRU_TOL = dict(rtol=1e-5, atol=1e-6)
MLP_TOL = dict(rtol=1e-4, atol=1e-5)


def _close(got, want, tol, name=""):
    want = np.asarray(want)
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    np.testing.assert_allclose(
        got, want, rtol=tol["rtol"],
        atol=tol["atol"] * max(1.0, float(np.abs(want).max())), err_msg=name)


def _captions(rng):
    ids = rng.integers(4, V, size=(B, L)).astype(np.int32)
    return ids * (np.arange(L)[None, :] < LENGTHS[:, None])


@pytest.mark.parametrize("hidden", [4, 8])
def test_bigru_matches_jax(hidden):
    rng = np.random.default_rng(hidden)
    x = rng.normal(size=(B, L, 7)).astype(np.float32)
    jm = JBiGRU(hidden_size=hidden)
    params = jax.tree.map(np.asarray, jm.init(
        jax.random.PRNGKey(1), jnp.asarray(x), jnp.asarray(LENGTHS))["params"])
    # Biases away from the init's range, so that a swapped r/z gate or a
    # bias added outside r * (W_hn h + b_hn) shows.
    params = {k: (v + rng.normal(size=v.shape).astype(np.float32)
                  if "_b" in k else v) for k, v in params.items()}
    w = rng.normal(size=(B, L, 2 * hidden)).astype(np.float32)

    def j_loss(p, x):
        outs, final = jm.apply({"params": p}, x, jnp.asarray(LENGTHS))
        return jnp.sum(outs * w) + jnp.sum(final ** 2), (outs, final)

    (_, (j_outs, j_final)), (j_gp, j_gx) = jax.value_and_grad(
        j_loss, argnums=(0, 1), has_aux=True)(params, jnp.asarray(x))
    tm = BiGRU(7, hidden)
    tm.load_state_dict(flax_bigru_to_torch(params))
    tx = torch.tensor(x, requires_grad=True)
    outs, final = tm(tx, torch.tensor(LENGTHS))
    (torch.sum(outs * torch.tensor(w)) + torch.sum(final ** 2)).backward()
    _close(outs, j_outs, GRU_TOL, "outputs")
    _close(final, j_final, GRU_TOL, "final")
    # Zero outputs at pads, and final = outputs[len - 1].
    pad = np.arange(L)[None, :] >= LENGTHS[:, None]
    assert not outs.detach().numpy()[pad].any()
    assert torch.equal(final, gather_last_valid(outs, torch.tensor(LENGTHS)))
    _close(tx.grad, j_gx, GRU_TOL, "dx")
    want = flax_bigru_to_torch(jax.tree.map(np.asarray, j_gp))
    for key, p in tm.named_parameters():
        _close(p.grad, want[key].numpy(), GRU_TOL, "grad " + key)


def test_bigru_gate_order_is_torch_gru():
    """The port's module is torch.nn.GRU itself (r, z, n gates; candidate
    tanh(x_n + r * (W_hn h + b_hn))): one step by hand from its weights."""
    torch.manual_seed(0)
    tm = BiGRU(3, 2)
    x = torch.randn(1, 1, 3)
    outs, _ = tm(x, torch.tensor([1]))
    w_ih, w_hh = tm.weight_ih_l0, tm.weight_hh_l0
    b_ih, b_hh = tm.bias_ih_l0, tm.bias_hh_l0
    xi, hh = x[0, 0] @ w_ih.T + b_ih, b_hh  # h0 = 0
    r = torch.sigmoid(xi[:2] + hh[:2])
    z = torch.sigmoid(xi[2:4] + hh[2:4])
    n = torch.tanh(xi[4:] + r * hh[4:])
    torch.testing.assert_close(outs[0, 0, :2], (1 - z) * n)


@pytest.mark.parametrize("mlp_local", [False, True])
def test_text_client_phases_match_jax(mlp_local):
    """Train phase (logits and head weights) and features phase (with
    --mlp_local's head_proj in train-mode BatchNorm, its running stats
    included), eval-mode features."""
    rng = np.random.default_rng(3)
    tol = MLP_TOL if mlp_local else GRU_TOL
    caps = jnp.asarray(_captions(rng))
    lens = jnp.asarray(LENGTHS)
    jm = JTextClient(vocab_size=V, num_class=4, embed_dim=16, word_dim=WD,
                     mlp_local=mlp_local)
    variables = jm.init(jax.random.PRNGKey(2), caps, lens, False, "train")
    if mlp_local:
        variables = _deep_merge(variables, jm.init(
            jax.random.PRNGKey(2), caps, lens, False, "features"))
    params = jax.tree.map(np.asarray, variables["params"])
    stats = jax.tree.map(np.asarray, variables.get("batch_stats", {}))
    tm = TextClientNet(V, num_class=4, embed_dim=16, word_dim=WD,
                       mlp_local=mlp_local)
    tm.load_state_dict(flax_text_client_to_torch(params, stats))
    tcaps, tlens = torch.tensor(np.asarray(caps)).long(), torch.tensor(LENGTHS)
    variables = {"params": params, "batch_stats": stats}

    want = jm.apply(variables, caps, lens, True, "train",
                    mutable=["batch_stats"])[0]
    tm.train()
    got = tm(tcaps, tlens, phase="train")
    for g, w, name in zip(got, want, ("logits", "logits80", "w1", "w2")):
        _close(g, w, tol, name)

    want, upd = jm.apply(variables, caps, lens, True, "features",
                         mutable=["batch_stats"])
    _close(tm(tcaps, tlens, phase="features"), want, tol, "features")
    if mlp_local:
        new = flax_text_client_to_torch(params, jax.tree.map(
            np.asarray, upd["batch_stats"]))
        for key in ("head_proj.bn.running_mean", "head_proj.bn.running_var"):
            _close(tm.state_dict()[key], new[key].numpy(), tol, key)
    tm.eval()
    # Eval mode against the JAX module with the updated stats.
    variables["batch_stats"] = jax.tree.map(np.asarray,
                                            upd.get("batch_stats", {}))
    want = jm.apply(variables, caps, lens, False, "features")
    _close(tm(tcaps, tlens, phase="features"), want, tol, "eval feats")
    assert (tm.head_proj is not None) == mlp_local


@pytest.mark.parametrize("mlp_local", [False, True])
@pytest.mark.parametrize("train", [True, False])
def test_pcme_gru_branch_matches_jax(mlp_local, train):
    rng = np.random.default_rng(5)
    tol = MLP_TOL if mlp_local else GRU_TOL
    images = rng.normal(size=(B, 32, 32, 3)).astype(np.float32)
    caps = _captions(rng)
    args = tuple(map(jnp.asarray, (images, caps, LENGTHS)))
    jm = JPCME(embed_dim=16, cnn_type="resnet6", vocab_size=V, word_dim=WD,
               not_bert=True, mlp_local=mlp_local)
    variables = jax.tree.map(np.asarray,
                             jm.init(jax.random.PRNGKey(4), *args))
    if train:
        want, _ = jm.apply(variables, *args, train=True,
                           mutable=["batch_stats"])
    else:
        want = jm.apply(variables, *args)
    tm = PCME(embed_dim=16, cnn_type="resnet6", vocab_size=V, word_dim=WD,
              not_bert=True, mlp_local=mlp_local)
    tm.load_state_dict(flax_pcme_to_torch(variables["params"],
                                          variables["batch_stats"]))
    tm.train(train)
    got = tm(torch.tensor(images), torch.tensor(caps).long(),
             torch.tensor(LENGTHS))
    for key in ("image_features", "caption_features", "caption_attentions",
                "caption_residuals"):
        _close(got[key], want[key], tol, key)

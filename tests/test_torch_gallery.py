"""Port gallery ops vs the JAX package: K1 (row logsumexp), K2 (softmax
matvec), K3 (fused gallery CE) and K4 (con_w diagonal).

On the CPU the port's kernel wrappers run their plain PyTorch versions;
they are held against both the JAX package's XLA versions
(``ops.gallery``) and its Pallas kernels in interpret mode
(``ops.pallas_gallery``), on the same numpy inputs, in fp32.

Tolerances: gallery values rtol 1e-5; gradients rtol 2e-4 atol 1e-6, as
in the JAX package's own Pallas test (summation order differs).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from creamfl_tpu.ops import gallery as jgal
from creamfl_tpu.ops import pallas_gallery as jpl
from creamfl_tpu_torch.ops import dispatch
from creamfl_tpu_torch.ops import gallery as tgal
from creamfl_tpu_torch.ops import gallery_kernels as tk

VAL = dict(rtol=1e-5, atol=0.0)
GRAD = dict(rtol=2e-4, atol=1e-6)


@pytest.fixture
def interpret_mode():
    with pltpu.force_tpu_interpret_mode():
        yield


def _np(x):
    return np.asarray(x.detach() if isinstance(x, torch.Tensor) else x)


@pytest.mark.parametrize("tau", [0.5, 1.0])
def test_row_logsumexp_masked_tail(rng, interpret_mode, tau):
    # N = 300 is a multiple of neither the port's 128-column tile nor the
    # Pallas 128-column block, and M = 10 not of the row block.
    m, n, d = 10, 300, 48
    v = rng.normal(size=(m, d)).astype(np.float32)
    g = rng.normal(size=(n, d)).astype(np.float32)
    got = _np(tk.row_logsumexp(torch.tensor(v), torch.tensor(g), tau))
    want_pl = np.asarray(jpl.row_logsumexp(jnp.asarray(v), jnp.asarray(g),
                                           tau=tau, block_rows=8,
                                           block_cols=128))
    want_xla = np.asarray(jgal.streaming_logsumexp(
        jnp.asarray(v), jnp.asarray(g), tau=tau, col_block=128))
    np.testing.assert_allclose(got, want_pl, **VAL)
    np.testing.assert_allclose(got, want_xla, **VAL)
    # The port's own blocking is irrelevant to the value.
    got_blk = _np(tgal.streaming_logsumexp(torch.tensor(v), torch.tensor(g),
                                           tau, col_block=64))
    np.testing.assert_allclose(got_blk, want_xla, **VAL)


def test_conw_diag(rng, interpret_mode):
    n, d = 70, 16
    v = rng.normal(size=(n, d)).astype(np.float32)
    g = rng.normal(size=(n, d)).astype(np.float32)
    got = _np(tk.conw_diag(torch.tensor(v), torch.tensor(g)))
    got_disp = _np(dispatch.conw_diag_log_softmax(torch.tensor(v),
                                                  torch.tensor(g)))
    want_pl = np.asarray(jpl.conw_diag_pallas(jnp.asarray(v), jnp.asarray(g),
                                              block_rows=16, block_cols=64))
    want_xla = np.asarray(jgal.gallery_log_softmax_diag(
        jnp.asarray(v), jnp.asarray(g), row_block=16, col_block=32))
    # diag - lse cancels: the JAX package's own test uses atol 1e-5 here.
    for want in (want_pl, want_xla):
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(got_disp, want, rtol=1e-5, atol=1e-5)


def test_conw_diag_needs_square():
    with pytest.raises(ValueError):
        tgal.gallery_log_softmax_diag(torch.zeros(3, 4), torch.zeros(5, 4))


def test_softmax_matvec_plain(rng, interpret_mode):
    m, n, d = 6, 150, 24
    v = rng.normal(size=(m, d)).astype(np.float32)
    g = rng.normal(size=(n, d)).astype(np.float32)
    lse = np.asarray(jgal.streaming_logsumexp(jnp.asarray(v),
                                              jnp.asarray(g), tau=0.5))
    got = _np(tk.softmax_matvec(torch.tensor(v), torch.tensor(g),
                                torch.tensor(lse), 0.5))
    want_pl = np.asarray(jpl._softmax_matvec(
        jnp.asarray(v), jnp.asarray(g), jnp.asarray(lse), 0.5,
        block_rows=8, block_cols=128))
    np.testing.assert_allclose(got, want_pl, rtol=1e-5, atol=1e-6)
    logits = (v.astype(np.float64) @ g.T) / 0.5
    p = np.exp(logits - logits.max(1, keepdims=True))
    want = (p / p.sum(1, keepdims=True)) @ g
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


@pytest.fixture
def ce_inputs(rng):
    bs, n, d = 6, 150, 24
    f = rng.normal(size=(bs, d)).astype(np.float32)
    g = rng.normal(size=(n, d)).astype(np.float32)
    labels = rng.integers(0, n, size=(bs,)).astype(np.int32)
    return f, g, labels


def _torch_ce(fn, f, g, labels):
    tf = torch.tensor(f, requires_grad=True)
    tg = torch.tensor(g, requires_grad=True)
    loss = fn(tf, tg, torch.tensor(labels))
    loss.backward()
    return float(loss.detach()), _np(tf.grad), tg.grad


def test_fused_gallery_ce_value_grad(ce_inputs, interpret_mode):
    f, g, labels = ce_inputs
    jf, jg, jl = jnp.asarray(f), jnp.asarray(g), jnp.asarray(labels)
    val_pl, (d_pl, dg_pl) = jax.value_and_grad(
        lambda x, y: jpl.fused_gallery_ce(x, y, jl, 0.5),
        argnums=(0, 1))(jf, jg)
    val_xla, d_xla = jax.value_and_grad(
        lambda x: jgal.gallery_cross_entropy(x, jg, jl, tau=0.5))(jf)
    assert not np.asarray(dg_pl).any()

    # The autograd Function's forward and backward formulas (over the
    # plain K1/K2 on the CPU), and the wrapper (the plain CE on the CPU).
    # The wrapper detaches the gallery; the Function gets it detached.
    def fused(a, b, c):
        return tk.FusedGalleryCE.apply(a, b.detach(), c, 0.5)

    for fn in (fused, tk.fused_gallery_ce):
        loss, dfeats, dgal = _torch_ce(fn, f, g, labels)
        for want, dwant in ((val_pl, d_pl), (val_xla, d_xla)):
            np.testing.assert_allclose(loss, float(want), **VAL)
            np.testing.assert_allclose(dfeats, np.asarray(dwant), **GRAD)
        # No gradient reaches the gallery (a frozen constant).
        assert dgal is None


@pytest.mark.parametrize("blockwise", [False, True])
def test_gallery_cross_entropy_plain(ce_inputs, blockwise):
    f, g, labels = ce_inputs
    jf, jg, jl = jnp.asarray(f), jnp.asarray(g), jnp.asarray(labels)
    val, dwant = jax.value_and_grad(
        lambda x: jgal.gallery_cross_entropy(x, jg, jl, tau=0.5,
                                             blockwise=blockwise,
                                             col_block=64))(jf)
    loss, dfeats, dgal = _torch_ce(
        lambda a, b, c: tgal.gallery_cross_entropy(
            a, b, c, tau=0.5, blockwise=blockwise, col_block=64),
        f, g, labels)
    np.testing.assert_allclose(loss, float(val), **VAL)
    np.testing.assert_allclose(dfeats, np.asarray(dwant), **GRAD)
    assert dgal is None


def test_dispatch_gallery_ce_cpu_is_plain(ce_inputs):
    f, g, labels = ce_inputs
    a = dispatch.gallery_ce(torch.tensor(f), torch.tensor(g),
                            torch.tensor(labels), 0.5)
    b = tgal.gallery_cross_entropy(torch.tensor(f), torch.tensor(g),
                                   torch.tensor(labels), 0.5)
    assert float(a) == float(b)
    # The wrappers alone choose by device; dispatch only names them.
    assert dispatch.gallery_ce is tk.fused_gallery_ce
    assert dispatch.conw_diag_log_softmax is tk.conw_diag
    # CPU calls never count as kernel launches.
    assert tk.launch_counts()["fused_gallery_ce"] == 0


@pytest.mark.parametrize("m,n,rows,cols", [
    (128, 50_000, 128, 128), (50_000, 50_000, 128, 128),
    (128, 50_000, 32, 64), (80, 50_000, 32, 64), (77, 1001, 128, 128),
    (1, 1, 128, 128)])
def test_plan_splits_covers_every_tile(m, n, rows, cols):
    splits, per_split = tk.plan_splits(m, n, rows, cols, sm_count=132)
    n_tiles = -(-n // cols)
    assert splits >= 1 and per_split >= 1
    # Every tile belongs to exactly one split and no split is empty.
    assert (splits - 1) * per_split < n_tiles <= splits * per_split
    # Small M is split until at least one wave of blocks (half the two-wave
    # target, after rounding the tiles per split) fills 132 SMs.
    row_blocks = -(-m // rows)
    assert row_blocks * splits >= min(n_tiles * row_blocks, 2 * 2 * 132) // 2


def test_kernel_inputs_are_checked():
    with pytest.raises(TypeError):
        tk._check_inputs("k", torch.zeros(2, 2, dtype=torch.float64))
    with pytest.raises(ValueError):
        tk._check_inputs("k", torch.zeros(4, 4).T)

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
from creamfl_tpu_torch.ops import gallery as tgal
from creamfl_tpu_torch.ops import gallery_kernels as tk
from torch_cpu_share import torch_cpu_share  # noqa: F401

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
    want_pl = np.asarray(jpl.conw_diag_pallas(jnp.asarray(v), jnp.asarray(g),
                                              block_rows=16, block_cols=64))
    want_xla = np.asarray(jgal.gallery_log_softmax_diag(
        jnp.asarray(v), jnp.asarray(g), row_block=16, col_block=32))
    # diag - lse cancels: the JAX package's own test uses atol 1e-5 here.
    for want in (want_pl, want_xla):
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


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
    a = tk.fused_gallery_ce(torch.tensor(f), torch.tensor(g),
                            torch.tensor(labels), 0.5)
    b = tgal.gallery_cross_entropy(torch.tensor(f), torch.tensor(g),
                                   torch.tensor(labels), 0.5)
    assert float(a) == float(b)
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


# ---------------------------------------------------------------------------
# the kernels' plain steps, routes and plans
# ---------------------------------------------------------------------------

def _unit(rng, *shape):
    x = rng.normal(size=shape).astype(np.float32)
    return x / np.linalg.norm(x, axis=-1, keepdims=True)


def test_tf32_round_is_cvt_rna():
    """Round to the nearest TF32 value (10 mantissa bits), ties away from
    zero; inf and nan pass through."""
    ulp = 2.0 ** -10
    x = torch.tensor([1.0, 1 + ulp / 2, -(1 + ulp / 2), 1 + ulp / 2 - 2 ** -23,
                      1 + 0.75 * ulp, 3.0 * 2 ** 100, float("inf"),
                      float("-inf")])
    want = torch.tensor([1.0, 1 + ulp, -(1 + ulp), 1.0, 1 + ulp,
                         3.0 * 2 ** 100, float("inf"), float("-inf")])
    assert torch.equal(tgal.tf32_round(x), want)
    assert torch.isnan(tgal.tf32_round(torch.tensor([float("nan")]))).all()
    big, small = tgal.tf32_split(torch.tensor([1 + 2 ** -15 + 2 ** -20]))
    assert float(big) == 1.0 and float(small) == 2 ** -15 + 2 ** -20
    assert (tgal.tf32_round(x[:6]).view(torch.int32) & 0x1FFF == 0).all()


@pytest.mark.parametrize("d", [48, 256, 512])
def test_tf32x3_matmul_within_chip_tolerance(rng, d):
    """The tc route's arithmetic (3xTF32 products, fp32 sums) against fp32
    over the lse pass's split plan (wgmma's) and the matvec pass's (tc's),
    at the card's tolerances (``chip_smoke.TOL``); one TF32 product alone
    would not hold them."""
    from chip_smoke import TOL

    m, n, tau = 24, 700, 0.5
    v, g = torch.tensor(_unit(rng, m, d)), torch.tensor(_unit(rng, n, d))
    splits, per_split = tk.plan_for("lse", "wgmma", m, n, d, 132)
    lse3 = tgal.lse_merge(*tgal.lse_partials(
        v, g, tau, splits, per_split, tk.lse_cols("wgmma"),
        matmul=tgal.tf32x3_matmul))
    lse = tgal.streaming_logsumexp(v, g, tau)
    np.testing.assert_allclose(lse3, lse, **TOL["row_logsumexp"])
    splits, per_split = tk.plan_for("matvec", "tc", m, n, d, 132)
    mv3 = tgal.matvec_partials(v, g, lse, tau, splits, per_split,
                               tk.mv_tc_tile(d)[1],
                               matmul=tgal.tf32x3_matmul).sum(0)
    np.testing.assert_allclose(mv3, tgal.softmax_matvec(v, g, lse, tau),
                               **TOL["softmax_matvec"])
    prod = v.double() @ g.double().T
    err3 = (tgal.tf32x3_matmul(v, g.T).double() - prod).abs().max()
    err32 = ((v @ g.T).double() - prod).abs().max()
    err1 = ((tgal.tf32_round(v) @ tgal.tf32_round(g).T).double()
            - prod).abs().max()
    assert err3 < 4 * err32 + 1e-7 and err1 > 100 * err3


@pytest.mark.parametrize("route", ["wgmma", "simt"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ce_and_dfeats_merges_vs_jax(rng, interpret_mode, route, dtype):
    """K3's two kernel passes in plain steps, over the split plans of the
    lse pass's ``route`` and its matvec route at ragged M and N: the
    CE-mode merge against the JAX
    ``fused_gallery_ce`` value, the dfeats-mode merge against its
    ``jax.grad`` (Pallas in interpret mode), fp32 and bf16 features."""
    m, n, d, tau = 10, 300, 48, 0.5
    f = torch.tensor(rng.normal(size=(m, d)).astype(np.float32)).to(dtype)
    g = rng.normal(size=(n, d)).astype(np.float32)
    labels = rng.integers(0, n, size=(m,)).astype(np.int32)
    jdtype = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32
    jf = jnp.asarray(f.float().numpy()).astype(jdtype)
    jl = jnp.asarray(labels)
    val, dwant = jax.value_and_grad(
        lambda x: jpl.fused_gallery_ce(x, jnp.asarray(g), jl, tau))(jf)

    f32, g32 = f.float(), torch.tensor(g)
    tl = torch.tensor(labels).long()
    splits, per_split = tk.plan_for("lse", route, m, n, d, 132)
    assert splits > 1
    loss, lse = tgal.ce_merge(
        *tgal.lse_partials(f32, g32, tau, splits, per_split,
                           tk.lse_cols(route)), f32, g32, tl, tau)
    np.testing.assert_allclose(float(loss), float(val), **VAL)
    np.testing.assert_allclose(lse, tgal.streaming_logsumexp(f32, g32, tau),
                               **VAL)
    mv = tk.matvec_route(route)
    splits, per_split = tk.plan_for("matvec", mv, m, n, d, 132)
    cols = tk.mv_tc_tile(d)[1] if mv == "tc" else tk.MV_BLOCK_COLS
    gbar = torch.tensor(1.0)
    dfeats = tgal.dfeats_merge(
        tgal.matvec_partials(f32, g32, lse, tau, splits, per_split, cols),
        g32, tl, gbar, tau, dtype)
    assert dfeats.dtype == dtype
    np.testing.assert_allclose(dfeats.float(),
                               np.asarray(dwant.astype(jnp.float32)),
                               rtol=1e-4, atol=1e-6)


@pytest.mark.parametrize("route,d", [("wgmma", 48), ("simt", 12)])
def test_fused_gallery_ce_function_on_either_route(rng, route, d):
    """The autograd Function's CPU steps on the route its inputs take (D
    48: wgmma forward, tc backward; D 12: simt): loss and dfeats as the
    dense plain CE; gbar scales dfeats."""
    f = rng.normal(size=(6, d)).astype(np.float32)
    g = rng.normal(size=(150, d)).astype(np.float32)
    labels = rng.integers(0, 150, size=(6,)).astype(np.int32)
    assert tk.plan_gallery_route("lse", torch.tensor(f),
                                 torch.tensor(g)) == route
    tf = torch.tensor(f, requires_grad=True)
    loss = tk.FusedGalleryCE.apply(tf, torch.tensor(g), torch.tensor(labels),
                                   0.5)
    (3.0 * loss).backward()
    pf = torch.tensor(f, requires_grad=True)
    want = tgal.gallery_cross_entropy(pf, torch.tensor(g),
                                      torch.tensor(labels), 0.5)
    (3.0 * want).backward()
    np.testing.assert_allclose(float(loss), float(want), **VAL)
    np.testing.assert_allclose(tf.grad, pf.grad, **GRAD)


def test_plan_gallery_route():
    v, g = torch.zeros(8, 256), torch.zeros(40, 256)
    # The tensor-core routes' inputs: the matvec pass on tc, the lse pass
    # on wgmma.
    for kernel, tc in (("matvec", "tc"), ("lse", "wgmma")):
        assert tk.plan_gallery_route(kernel, v, g) == tc
        assert tk.plan_gallery_route(kernel, torch.zeros(3, 48),
                                     torch.zeros(5, 48)) == tc
        assert tk.plan_gallery_route(kernel, torch.zeros(3, 512),
                                     torch.zeros(5, 512)) == tc
        # D not a multiple of 8, D above 512, bf16, a strided view, a base
        # off 16 bytes: simt.
        assert tk.plan_gallery_route(kernel, torch.zeros(3, 12),
                                     torch.zeros(5, 12)) == "simt"
        assert tk.plan_gallery_route(kernel, torch.zeros(3, 520),
                                     torch.zeros(5, 520)) == "simt"
        assert tk.plan_gallery_route(kernel, v.bfloat16(), g) == "simt"
        assert tk.plan_gallery_route(kernel, torch.zeros(256, 8).T,
                                     g) == "simt"
        off = torch.zeros(8 * 256 + 1)[1:].view(8, 256)
        assert off.data_ptr() % 16 and tk.plan_gallery_route(
            kernel, off, g) == "simt"


@pytest.mark.parametrize("d,routes", [(48, ("wgmma", "tc")),
                                      (12, ("simt", "simt"))])
def test_fused_gallery_ce_cpu_steps_take_the_planned_split(rng, monkeypatch,
                                                         d, routes):
    """The autograd Function's CPU steps run their partials over the split
    plan and column tile of the routes ``plan_gallery_route`` picks (the
    forward's; the backward's by ``matvec_route``), and give the dense
    plain CE's loss and dfeats."""
    m, n = 10, 300
    f = torch.tensor(_unit(rng, m, d), requires_grad=True)
    g = torch.tensor(_unit(rng, n, d))
    labels = torch.tensor(rng.integers(0, n, size=(m,)))
    assert (tk.plan_gallery_route("lse", f, g),
            tk.plan_gallery_route("matvec", f, g)) == routes
    seen = {}
    for name in ("lse_partials", "matvec_partials"):
        def spy(*args, _fn=getattr(tgal, name), _name=name):
            seen[_name] = args[-3:]
            return _fn(*args)
        monkeypatch.setattr(tgal, name, spy)
    loss = tk.FusedGalleryCE.apply(f, g, labels, 0.5)
    loss.backward()
    lse_route, mv_route = routes
    assert seen["lse_partials"] == (
        *tk.plan_for("lse", lse_route, m, n, d, 132), tk.lse_cols(lse_route))
    mv_cols = tk.mv_tc_tile(d)[1] if mv_route == "tc" else tk.MV_BLOCK_COLS
    assert seen["matvec_partials"] == (
        *tk.plan_for("matvec", mv_route, m, n, d, 132), mv_cols)
    pf = f.detach().clone().requires_grad_(True)
    want = tgal.gallery_cross_entropy(pf, g, labels, 0.5)
    want.backward()
    np.testing.assert_allclose(float(loss), float(want), **VAL)
    np.testing.assert_allclose(f.grad, pf.grad, **GRAD)


@pytest.mark.parametrize("kernel", ["lse", "matvec"])
@pytest.mark.parametrize("m,n,d", [
    (128, 50_000, 256), (80, 50_000, 256), (128, 50_000, 512),
    (50_000, 50_000, 256), (77, 1001, 48), (1, 1, 8)])
def test_tc_split_plan_one_wave(kernel, m, n, d):
    """The tensor-core routes' plans (the lse pass on wgmma, the matvec
    pass on tc): every gallery tile in exactly one split, no split empty,
    and about one wave of resident blocks (one an SM on both): at most
    one, and at least half of one where the tiles allow, so each block
    walks many tiles."""
    if kernel == "lse":
        route, (rows, cols), per_sm = "wgmma", (tk.WGMMA_ROWS,
                                                tk.WGMMA_COLS), 1
    else:
        route, (rows, cols) = "tc", tk.mv_tc_tile(d)[:2]
        per_sm = tk.tc_blocks_per_sm(d)
    splits, per_split = tk.plan_for(kernel, route, m, n, d, 132)
    n_tiles, row_blocks = -(-n // cols), -(-m // rows)
    assert (splits - 1) * per_split < n_tiles <= splits * per_split
    wave = per_sm * 132
    if row_blocks >= wave:
        assert splits == 1
    else:
        assert row_blocks * splits <= wave
        assert row_blocks * splits >= min(n_tiles * row_blocks, wave) // 2
    if (m, n) == (128, 50_000):
        assert per_split >= 3


def test_tc_shared_memory_fits():
    for d in range(8, 513, 8):
        assert tk.tc_smem_bytes(d) <= tk._BLOCK_SHARED_MAX
        assert tk.tc_blocks_per_sm(d) >= 1
    # The matvec kernel holds 64 v rows up to D 256 and 32 beyond, so its
    # [rows, D] accumulators stay at 64 registers a thread.
    assert tk.tc_blocks_per_sm(256) == 1
    assert tk.mv_tc_tile(256) == (64, 64, 2)
    assert tk.mv_tc_tile(264) == (32, 32, 2)
    for d in (256, 512):
        assert tk.mv_tc_tile(d)[0] * tk.padded_dim(d) // 256 == 64


def test_launch_counts_by_route_reset():
    tk.reset_launch_counts()
    for fn in (tk.row_logsumexp, tk.softmax_matvec, tk.fused_gallery_ce,
               tk.conw_diag):
        assert fn.launches == 0
        assert fn.launches_by_route == {"wgmma": 0, "tc": 0, "simt": 0}


@pytest.mark.parametrize("unit", [True, False])
def test_matvec_tolerance_premise(rng, unit):
    """``chip_smoke.TOL`` for K2 assumes the main path's unit rows (logits
    of at most 1/tau): there the plain fp32 K2 holds it against float64;
    at randn scale (logits ~40 at D 48) fp32 itself does not, so the card
    checks every shape on unit rows."""
    from chip_smoke import TOL

    m, n, d, tau = 77, 1001, 48, 0.5
    v = _unit(rng, m, d) if unit else rng.normal(size=(m, d)).astype(
        np.float32)
    g = _unit(rng, n, d) if unit else rng.normal(size=(n, d)).astype(
        np.float32)
    logits = v.astype(np.float64) @ g.T.astype(np.float64) / tau
    p = np.exp(logits - logits.max(1, keepdims=True))
    want = (p / p.sum(1, keepdims=True)) @ g.astype(np.float64)
    tv, tg = torch.tensor(v), torch.tensor(g)
    got = tgal.softmax_matvec(tv, tg, tgal.streaming_logsumexp(tv, tg, tau),
                              tau).double().numpy()
    tol = TOL["softmax_matvec"]
    held = np.all(np.abs(got - want) <= tol["atol"] + tol["rtol"]
                  * np.abs(want))
    assert held == unit


# ---------------------------------------------------------------------------
# K3 over a stacked client family: segments
# ---------------------------------------------------------------------------

@pytest.fixture
def seg_inputs(rng, path):
    """S = 3 segments of 5 rows (three clients on one public batch: the
    same labels in each segment) against a 150 x D gallery: D 12 for the
    simt path, else 48 (the wgmma forward and tc backward)."""
    s, bs, n, d = 3, 5, 150, 12 if path == "simt" else 48
    f = rng.normal(size=(s, bs, d)).astype(np.float32)
    g = rng.normal(size=(n, d)).astype(np.float32)
    labels = rng.integers(0, n, size=(bs,)).astype(np.int32)
    if path != "wrapper":
        assert tk.plan_gallery_route("lse", torch.tensor(f[0]),
                                     torch.tensor(g)) == path
    return f, g, labels


def _segmented(fn, f, g, labels, weights):
    """fn on the [S * M, D] rows with segments S: its [S] losses and the
    dfeats of sum(weights * losses), [S, M, D]."""
    s, bs, d = f.shape
    tf = torch.tensor(f.reshape(s * bs, d), requires_grad=True)
    losses = fn(tf, torch.tensor(g), torch.tensor(np.tile(labels, s)), s)
    assert losses.shape == (s,)
    (torch.tensor(weights) * losses).sum().backward()
    return _np(losses), _np(tf.grad).reshape(f.shape)


def _seg_fns():
    """The wrapper (the plain CE on the CPU) and the autograd Function's
    kernel steps, on the route its inputs take (``seg_inputs``)."""
    def wrapper(a, b, c, s):
        return tk.fused_gallery_ce(a, b, c, 0.5, segments=s)

    def function(a, b, c, s):
        return tk.FusedGalleryCE.apply(a, b, c, 0.5, s)

    return {"wrapper": wrapper, "wgmma": function, "simt": function}


@pytest.mark.parametrize("path", ["wrapper", "wgmma", "simt"])
def test_segmented_ce_equals_separate_calls(seg_inputs, path):
    """One segmented call = S separate calls, loss and dfeats, each
    segment with its own gbar."""
    f, g, labels = seg_inputs
    weights = np.array([1.0, 0.5, 2.0], np.float32)
    fn = _seg_fns()[path]
    losses, dfeats = _segmented(fn, f, g, labels, weights)
    for i in range(f.shape[0]):
        tf = torch.tensor(f[i], requires_grad=True)
        one = fn(tf, torch.tensor(g), torch.tensor(labels), 1)
        assert one.shape == ()
        (float(weights[i]) * one).backward()
        np.testing.assert_allclose(losses[i], float(one), rtol=0, atol=1e-6)
        np.testing.assert_allclose(dfeats[i], _np(tf.grad), rtol=0,
                                   atol=1e-6)


@pytest.mark.parametrize("path", ["wrapper", "wgmma", "simt"])
def test_segmented_ce_equals_jax_vmap(seg_inputs, interpret_mode, path):
    """The segmented losses and dfeats equal ``jax.vmap`` of the JAX
    ``fused_gallery_ce`` (Pallas in interpret mode) over [S, M, D]
    features and its ``jax.grad``."""
    f, g, labels = seg_inputs
    weights = np.array([1.0, 0.5, 2.0], np.float32)
    jg, jl = jnp.asarray(g), jnp.asarray(labels)

    def per_client(x):
        return jax.vmap(lambda v: jpl.fused_gallery_ce(v, jg, jl, 0.5))(x)

    want = per_client(jnp.asarray(f))
    dwant = jax.grad(lambda x: jnp.sum(jnp.asarray(weights)
                                       * per_client(x)))(jnp.asarray(f))
    losses, dfeats = _segmented(_seg_fns()[path], f, g, labels, weights)
    np.testing.assert_allclose(losses, np.asarray(want), **VAL)
    np.testing.assert_allclose(dfeats, np.asarray(dwant), **GRAD)


def test_segments_one_is_the_unsegmented_call(ce_inputs):
    """segments=1 keeps the scalar loss and the arithmetic of the call
    without segments, bit for bit: the plain CE (the wrapper on the CPU)
    and both kernel merges (a mean of all rows, gbar / (tau M))."""
    f, g, labels = ce_inputs
    tg, tl = torch.tensor(g), torch.tensor(labels).long()
    for segments in ({}, {"segments": 1}):
        tf = torch.tensor(f, requires_grad=True)
        loss = tk.fused_gallery_ce(tf, tg, tl, 0.5, **segments)
        loss.backward()
        logits = (torch.tensor(f) @ tg.T) / 0.5
        want = torch.mean(torch.logsumexp(logits, dim=1)
                          - logits.gather(1, tl[:, None])[:, 0])
        assert loss.shape == () and torch.equal(loss.detach(), want)
        if segments:
            assert torch.equal(tf.grad, grad)
        grad = tf.grad
    f32 = torch.tensor(f)
    parts = tgal.lse_partials(f32, tg, 0.5, 2, 1, 128)
    loss, lse = tgal.ce_merge(*parts, f32, tg, tl, 0.5, segments=1)
    label_logit = torch.sum(f32 * tg.index_select(0, tl), dim=1) * 2.0
    assert torch.equal(loss, torch.mean(lse - label_logit).reshape(1))
    part = tgal.matvec_partials(f32, tg, lse, 0.5, 2, 1, 64)
    gbar = torch.tensor([0.75])
    want = (part.sum(dim=0) - tg.index_select(0, tl)) * (
        gbar.reshape(()) / (0.5 * f32.shape[0]))
    assert torch.equal(tgal.dfeats_merge(part, tg, tl, gbar, 0.5), want)


def test_segments_must_divide_rows(ce_inputs):
    f, g, labels = ce_inputs  # 6 rows
    with pytest.raises(ValueError, match="segments"):
        tk.fused_gallery_ce(torch.tensor(f), torch.tensor(g),
                            torch.tensor(labels), 0.5, segments=4)
    with pytest.raises(ValueError, match="segments"):
        tk.FusedGalleryCE.apply(torch.tensor(f), torch.tensor(g),
                                torch.tensor(labels), 0.5, 4)

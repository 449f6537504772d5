"""The gallery lse pass's "wgmma" route (K1, K3's forward, K4) on the CPU.

The kernel itself needs the card (``chip_smoke.py`` holds it against the
plain versions there). Here: a plain model of its arithmetic (operands
read as TF32 by truncation, small halves exact, three products per
32-deep chunk, the chunks summed in fp32) over its split plan, against
the JAX package's ``row_logsumexp`` and ``conw_diag_pallas`` in interpret
mode and against float64, within ``chip_smoke.TOL`` (lse: 1e-4
absolute); its planning (split plan, shared memory, the per-pass route,
the source of its small halves by rows) and the wrappers' counters.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from chip_smoke import TOL
from creamfl_tpu.ops import pallas_gallery as jpl
from creamfl_tpu_torch.ops import gallery as tgal
from creamfl_tpu_torch.ops import gallery_kernels as tk
from torch_cpu_share import torch_cpu_share  # noqa: F401

# Ragged M (not a multiple of the 128-row block) and N (of no 128-row
# tile), D in {8, 48, 256}; (128, 1000, 256) has every split full but the
# last.
SHAPES = [(77, 300, 8), (77, 300, 48), (10, 1001, 256), (128, 1000, 256),
          (130, 257, 48)]


@pytest.fixture
def interpret_mode():
    with pltpu.force_tpu_interpret_mode():
        yield


def _unit(rng, *shape):
    x = rng.normal(size=shape).astype(np.float32)
    return x / np.linalg.norm(x, axis=-1, keepdims=True)


def _model_lse(v, g, tau):
    """The wgmma route's partials over its own split plan, merged."""
    (m, d), n = v.shape, g.shape[0]
    splits, per_split = tk.plan_for("lse", "wgmma", m, n, d, 132)
    return tgal.lse_merge(*tgal.lse_partials(
        v, g, tau, splits, per_split, tk.WGMMA_COLS,
        matmul=tgal.wgmma_tf32x3_matmul))


def _lse64(v, g, tau):
    return torch.logsumexp(v.double() @ g.double().T / tau, dim=1)


@pytest.mark.parametrize("m,n,d", SHAPES)
@pytest.mark.parametrize("tau", [0.5, 1.0])
def test_wgmma_model_row_logsumexp(rng, interpret_mode, m, n, d, tau):
    v, g = _unit(rng, m, d), _unit(rng, n, d)
    got = _model_lse(torch.tensor(v), torch.tensor(g), tau)
    want_pl = np.asarray(jpl.row_logsumexp(jnp.asarray(v), jnp.asarray(g),
                                           tau=tau, block_rows=8,
                                           block_cols=128))
    np.testing.assert_allclose(got, want_pl, **TOL["row_logsumexp"])
    np.testing.assert_allclose(
        got, _lse64(torch.tensor(v), torch.tensor(g), tau),
        **TOL["row_logsumexp"])


@pytest.mark.parametrize("m,d", [(300, 8), (300, 48), (257, 256)])
def test_wgmma_model_conw_diag(rng, interpret_mode, m, d):
    v, g = _unit(rng, m, d), _unit(rng, m, d)
    tv, tg = torch.tensor(v), torch.tensor(g)
    # The DIAG merge: <v_i, g_i> - lse_i, the dot in fp32.
    got = (tv * tg).sum(dim=1) - _model_lse(tv, tg, 1.0)
    want_pl = np.asarray(jpl.conw_diag_pallas(jnp.asarray(v), jnp.asarray(g),
                                              block_rows=8, block_cols=128))
    np.testing.assert_allclose(got, want_pl, **TOL["conw_diag"])
    want64 = (tv.double() * tg.double()).sum(1) - _lse64(tv, tg, 1.0)
    np.testing.assert_allclose(got, want64, **TOL["conw_diag"])


@pytest.mark.parametrize("d", [8, 48, 256, 512])
def test_wgmma_product_error_bound(rng, d):
    """Truncated halves carry each operand to 2^-20 relative and the
    dropped small * small term is below 2^-20 of the product, so each
    logit is within 3 * 2^-20 * sum_k |a_k b_k| of float64, plus fp32
    summation (a few times fp32's own error); one truncated TF32 product
    alone is far outside that."""
    a, b = torch.tensor(_unit(rng, 64, d)), torch.tensor(_unit(rng, 700, d))
    exact = a.double() @ b.double().T
    err = (tgal.wgmma_tf32x3_matmul(a, b.T).double() - exact).abs()
    err32 = ((a @ b.T).double() - exact).abs().max()
    bound = 3 * 2.0 ** -20 * (a.double().abs() @ b.double().abs().T)
    assert (err <= bound + 4 * err32).all()
    one = (tgal.tf32_trunc(a) @ tgal.tf32_trunc(b).T).double() - exact
    assert one.abs().max() > 100 * err.max()


def test_tf32_split_trunc():
    """big is x with its 13 low bits cleared; small = x - big exactly,
    then truncated: 1 + 2^-15 + 2^-20 + 2^-40 keeps 2^-15 + 2^-20."""
    x = torch.tensor([1 + 2 ** -15 + 2 ** -20, -(1 + 2 ** -11), 3.0])
    big, small = tgal.tf32_split_trunc(x)
    assert big.tolist() == [1.0, -1.0, 3.0]
    assert small.tolist() == [2 ** -15 + 2 ** -20, -(2 ** -11), 0.0]
    assert (big.view(torch.int32) & 0x1FFF == 0).all()


@pytest.mark.parametrize("m,n,d", [
    (128, 50_000, 256), (50_000, 50_000, 256), (256, 50_000, 256),
    (384, 50_000, 256), (80, 50_000, 512), (77, 1001, 48), (1, 1, 8)])
def test_wgmma_split_plan(m, n, d):
    """Every 128-row gallery tile in exactly one split, no split empty,
    and about one wave of blocks (one an SM): con_w's 391 row blocks take
    one split; K1's one row block is split until it fills the card."""
    splits, per_split = tk.plan_for("lse", "wgmma", m, n, d, 132)
    n_tiles, row_blocks = -(-n // tk.WGMMA_COLS), -(-m // tk.WGMMA_ROWS)
    assert (splits - 1) * per_split < n_tiles <= splits * per_split
    if row_blocks >= 132:
        assert splits == 1
    else:
        assert row_blocks * splits <= 132
        assert row_blocks * splits >= min(n_tiles * row_blocks, 132) // 2
    if (m, n) == (128, 50_000):
        assert (splits, per_split) == (131, 3)


def test_wgmma_shared_memory_fits():
    """Three stages of four 16 KB boxes, the alignment slack and nine
    barriers fit one block's limit; two blocks would not fit an SM."""
    assert tk.WGMMA_SMEM_BYTES == 1024 + 3 * 65_536 + 72
    assert tk.WGMMA_SMEM_BYTES <= tk._BLOCK_SHARED_MAX
    assert 2 * (tk.WGMMA_SMEM_BYTES + tk._BLOCK_RESERVED_BYTES) \
        > tk._SM_SHARED_BYTES
    with pytest.raises(ValueError, match="lse pass"):
        tk.plan_for("matvec", "wgmma", 128, 1000, 256, 132)


def test_plan_gallery_route_per_pass():
    v, g = torch.zeros(8, 256), torch.zeros(40, 256)
    assert tk.plan_gallery_route("lse", v, g) == "wgmma"
    assert tk.plan_gallery_route("matvec", v, g) == "tc"
    for kernel in ("lse", "matvec"):
        assert tk.plan_gallery_route(kernel, torch.zeros(3, 12),
                                     torch.zeros(5, 12)) == "simt"
        assert tk.plan_gallery_route(kernel, v.bfloat16(), g) == "simt"
    assert tk.matvec_route("wgmma") == "tc"
    assert [tk.matvec_route(r) for r in ("tc", "simt")] == ["tc", "simt"]
    assert [tk.lse_cols(r) for r in ("wgmma", "simt")] == [128, 128]


def test_wgmma_route_taken_and_refused(rng):
    """The wgmma route's inputs take it for the lse pass's wrappers (CPU
    tensors: their plain versions) and tc for the matvec pass; float64
    operands the route refuses (the planner sends them to simt, the
    kernels raise)."""
    v, g = torch.tensor(_unit(rng, 6, 48)), torch.tensor(_unit(rng, 40, 48))
    assert tk.plan_gallery_route("lse", v, g) == "wgmma"
    assert tk.plan_gallery_route("matvec", v, g) == "tc"
    lse = tgal.streaming_logsumexp(v, g, 0.5)
    torch.testing.assert_close(tk.row_logsumexp(v, g, 0.5), lse)
    torch.testing.assert_close(tk.conw_diag(v, g[:6]),
                               tgal.gallery_log_softmax_diag(v, g[:6]))
    labels = torch.tensor([0, 3, 5, 39, 7, 1])
    torch.testing.assert_close(
        tk.fused_gallery_ce(v, g, labels, 0.5),
        tgal.gallery_cross_entropy(v, g, labels, 0.5))
    assert tk.plan_gallery_route("lse", v.double(), g) == "simt"
    with pytest.raises(TypeError, match="float32"):
        tk._check_inputs("row_logsumexp", v.double(), g)
    assert tk.launch_counts()["row_logsumexp"] == 0


@pytest.mark.parametrize("segments", [1, 2])
def test_fused_gallery_ce_function_wgmma(rng, segments):
    """The autograd Function's CPU steps on inputs that take the forward
    to "wgmma" (its split plan) and the backward to "tc": loss and dfeats
    as the dense plain CE, per segment."""
    m, n, d = 20, 300, 48
    f = _unit(rng, m, d)
    g = torch.tensor(_unit(rng, n, d))
    labels = torch.tensor(rng.integers(0, n, size=(m,)))
    tf = torch.tensor(f, requires_grad=True)
    loss = tk.FusedGalleryCE.apply(tf, g, labels, 0.5, segments)
    weights = torch.arange(1.0, segments + 1)
    (weights * loss).sum().backward()
    pf = torch.tensor(f, requires_grad=True)
    want = tgal.gallery_cross_entropy(pf, g, labels, 0.5, segments=segments)
    (weights * want).sum().backward()
    np.testing.assert_allclose(loss.detach(), want.detach(), rtol=1e-5)
    np.testing.assert_allclose(tf.grad, pf.grad, rtol=2e-4, atol=1e-6)


def test_reset_launch_counts_knows_wgmma():
    for fn in (tk.row_logsumexp, tk.softmax_matvec, tk.fused_gallery_ce,
               tk.conw_diag):
        fn.launches_by_route["wgmma"] += 2
        fn.launches += 2
    tk.reset_launch_counts()
    for fn in (tk.row_logsumexp, tk.softmax_matvec, tk.fused_gallery_ce,
               tk.conw_diag):
        assert fn.launches == 0
        assert fn.launches_by_route == {"wgmma": 0, "tc": 0, "simt": 0}


def test_wgmma_split_choice():
    """K1 and K3's row counts (a public batch, a stacked family of up to
    three) split in shared memory; con_w's uploads (the 4 096-row paper
    cut up to 50 000 rows) take the pre-pass."""
    assert set(tk.WGMMA_SPLITS) == set(tk._WGMMA_ROUTE_ID)
    for m in (1, 77, 128, 256, 384):
        assert tk.wgmma_split_for(m) == "smem"
    for m in (4096, 50_000):
        assert tk.wgmma_split_for(m) == "prepass"

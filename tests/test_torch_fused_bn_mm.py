"""Port of the fused conv+BN pair (K5 forward, K6 backward) vs the JAX
package's Pallas kernels in interpret mode and its jnp reference.

On the CPU the port's ``mm_bn_stats`` runs its autograd Function over the
plain versions (``ops.fused_bn_mm``), so these tests hold the forward and
the backward formula the CUDA kernels implement against the JAX package, on
the same numpy inputs. Shapes are ragged (M, K, N multiples of neither 32
nor 128). fp32 tolerances are those of the JAX package's own kernel test:
values rtol 1e-5 atol 1e-5, stats atol 1e-4 (sums of ~100 terms), grads
rtol 2e-4 atol 2e-4 (summation order differs).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from creamfl_tpu.ops.fused_bn_mm import (_bwd_pallas, _fwd_pallas,
                                         _mm_bn_stats_pallas,
                                         _mm_stats_pallas_id,
                                         mm_bn_stats_reference as j_reference)
from creamfl_tpu_torch.models.resnet import RESNET_CONFIGS
from creamfl_tpu_torch.ops import build as B
from creamfl_tpu_torch.ops import fused_bn_mm as P
from creamfl_tpu_torch.ops import fused_bn_mm_kernels as FK
from torch_cpu_share import torch_cpu_share  # noqa: F401

M, K, N = 101, 70, 45
VAL = dict(rtol=1e-5, atol=1e-5)
STAT = dict(rtol=1e-5, atol=1e-4)
GRAD = dict(rtol=2e-4, atol=2e-4)


def _data(seed, m=M, k=K, n=N):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(m, k)).astype(np.float32),
            (rng.normal(size=(k, n)) * 0.1).astype(np.float32),
            rng.uniform(0.5, 1.5, size=(k,)).astype(np.float32),
            (rng.normal(size=(k,)) * 0.2).astype(np.float32),
            rng.normal(size=(n,)).astype(np.float32),
            (rng.normal(size=(n,)) * 0.1).astype(np.float32))


def _jax_fused(x, w, inv, beta, relu, affine):
    """The Pallas kernels in interpret mode, 32-row blocks (4 blocks, the
    last ragged)."""
    if affine:
        return _mm_bn_stats_pallas(x, w, inv, beta, relu, 32, True)
    return _mm_stats_pallas_id(x, w, relu, 32, True)


def _port(x, w, inv, beta, relu, affine):
    if affine:
        return P.mm_bn_stats(x, w, inv, beta, relu=relu)
    return P.mm_bn_stats(x, w, relu=relu)


def _close(got, want, tol, name=""):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    np.testing.assert_allclose(got, np.asarray(want), err_msg=name, **tol)


@pytest.mark.parametrize("affine", [True, False])
@pytest.mark.parametrize("relu", [False, True])
def test_forward_matches_pallas_and_reference(affine, relu):
    x, w, inv, beta, _, _ = _data(0)
    jx, jw, ji, jb = map(jnp.asarray, (x, w, inv, beta))
    want = _jax_fused(jx, jw, ji, jb, relu, affine)
    if not affine:
        ji, jb = jnp.ones_like(ji), jnp.zeros_like(jb)
    ref = j_reference(jx, jw, ji, jb, relu)
    got = _port(*map(torch.tensor, (x, w, inv, beta)), relu, affine)
    for g, j, r, tol, name in zip(got, want, ref, (VAL, STAT, STAT),
                                  ("y", "ssum", "ssq")):
        _close(g, j, tol, name + " vs pallas")
        _close(g, r, tol, name + " vs reference")


@pytest.mark.parametrize("affine", [True, False])
@pytest.mark.parametrize("relu", [False, True])
def test_gradients_match_pallas(affine, relu):
    """A loss on y, ssum and ssq, so the stat cotangents (dssq's 2y
    coupling included) reach the backward."""
    x, w, inv, beta, cs, cq = _data(1)

    def j_loss(x, w, inv, beta):
        y, s, q = _jax_fused(x, w, inv, beta, relu, affine)
        return (jnp.sum(jnp.sin(y)) + jnp.dot(s, jnp.asarray(cs))
                + jnp.dot(q, jnp.asarray(cq)))

    argnums = (0, 1, 2, 3) if affine else (0, 1)
    want = jax.grad(j_loss, argnums=argnums)(
        *map(jnp.asarray, (x, w, inv, beta)))
    ts = [torch.tensor(a, requires_grad=True) for a in (x, w, inv, beta)]
    y, s, q = _port(*ts, relu, affine)
    (torch.sin(y).sum() + s @ torch.tensor(cs)
     + q @ torch.tensor(cq)).backward()
    for t, j, name in zip(ts, want, ("dx", "dw", "dinv", "dbeta")):
        _close(t.grad, j, GRAD, name)
    if not affine:
        assert ts[2].grad is None and ts[3].grad is None


@pytest.mark.parametrize("relu", [False, True])
def test_plain_backward_equals_autograd_of_plain_forward(relu):
    """K6's plain version against torch autograd through K5's plain
    version (fp32: the roundings to the compute dtype are exact)."""
    x, w, inv, beta, cs, cq = map(torch.tensor, _data(2, 64, 33, 17))
    ts = [a.clone().requires_grad_(True) for a in (x, w, inv, beta)]
    y, s, q = P.mm_bn_stats_reference(*ts, relu)
    dy = torch.cos(y.detach())
    (torch.sin(y).sum() + s @ cs + q @ cq).backward()
    got = P.mm_bn_stats_backward_reference(x, w, inv, beta, y.detach(), dy,
                                           cs, cq, relu)
    for g, t, name in zip(got, ts, ("dx", "dw", "dinv", "dbeta")):
        _close(g, t.grad.numpy(), dict(rtol=1e-5, atol=1e-5), name)


def test_bf16_stats_are_of_the_stored_values():
    """In bf16 the stats are fp32 sums of the ROUNDED y, and y matches the
    JAX reference up to one bf16 ulp (accumulation order)."""
    x, w, inv, beta, _, _ = _data(3)
    xb = torch.tensor(x).to(torch.bfloat16)
    wb = torch.tensor(w).to(torch.bfloat16)
    y, s, q = P.mm_bn_stats(xb, wb, torch.tensor(inv), torch.tensor(beta),
                            relu=True)
    assert y.dtype == torch.bfloat16
    yf = y.float()
    _close(s, yf.sum(0).numpy(), dict(rtol=1e-6, atol=1e-6))
    _close(q, (yf * yf).sum(0).numpy(), dict(rtol=1e-6, atol=1e-6))
    jy, js, _ = j_reference(jnp.asarray(x, jnp.bfloat16),
                            jnp.asarray(w, jnp.bfloat16), jnp.asarray(inv),
                            jnp.asarray(beta), True)
    _close(yf, np.asarray(jy.astype(jnp.float32)),
           dict(rtol=2.0 ** -7, atol=1e-6))
    _close(s, js, dict(rtol=1e-3, atol=1e-2))


def test_weight_gradient_flows_through_the_cast():
    """``mm_bn_stats`` casts w to x's dtype inside the graph, so an fp32
    weight used with bf16 x gets an fp32 gradient."""
    x, w, _, _, _, _ = _data(4, 40, 24, 16)
    wt = torch.tensor(w, requires_grad=True)
    y, s, q = P.mm_bn_stats(torch.tensor(x).to(torch.bfloat16), wt)
    (y.float().sum() + s.sum() + q.sum()).backward()
    assert wt.grad.dtype == torch.float32 and wt.grad.shape == wt.shape
    assert bool(torch.isfinite(wt.grad).all())


_SPLIT_CASES = [(401408, 64, 64), (401408, 256, 128), (6272, 512, 2048),
                (6272, 2048, 512), (1000, 48, 80), (7, 3, 5)]


@pytest.mark.parametrize("route,m,k,n", [
    pytest.param(route, *c, id="-".join(map(str, c)) if route == "tiled"
                 else "-".join(map(str, ("wgmma",) + c)))
    for route in FK.ROUTES for c in _SPLIT_CASES
    if route == "tiled" or (c[1] % 8 == 0 and c[2] % 8 == 0)])
def test_dw_split_plan(route, m, k, n):
    splits, rows = FK.plan_dw_splits(m, k, n, sm_count=132, route=route)
    t = FK.dw_tile(k, n, route)
    assert rows % t.depth == 0
    assert splits * rows >= m > (splits - 1) * rows
    assert splits * n * k * 4 <= 64 << 20
    assert {t.rows, t.cols} == {k, n}
    assert t.kn == (route == "wgmma" and k >= n)
    tiles = -(-t.rows // t.tile_rows) * -(-t.cols // t.tile_cols)
    # About four blocks per SM, unless the rows run out first (rounding
    # each split up to whole depth steps may drop a few splits).
    assert tiles * splits >= 0.9 * min(132 * 4,
                                       tiles * -(-m // t.depth))


_R101 = sorted({(k, n, affine, relu) for _, _, _, k, n, affine, relu in
                chip_smoke.trunk_geometry(128, 224,
                                          RESNET_CONFIGS["resnet101"][1])})


def _route_inputs(m, k, n, dtype, offset=0):
    """x [m, k] starting ``offset`` elements into its storage, w as the
    transposed view of an [n, k] weight (as the trunk passes it), y, dy."""
    x = torch.zeros(m * k + offset, dtype=dtype)[offset:].view(m, k)
    w = torch.zeros(n, k, dtype=dtype).t()
    y, dy = torch.zeros(m, n, dtype=dtype), torch.zeros(m, n, dtype=dtype)
    return x, w.contiguous(), y, dy


def test_r101_has_16_distinct_geometries():
    assert len(_R101) == 16


@pytest.mark.parametrize("k,n,affine,relu", _R101)
def test_r101_bf16_takes_the_wgmma_route(k, n, affine, relu):
    """Every distinct 1x1 geometry of ResNet-101 at batch 128 in bf16 (M
    does not enter the choice; 8 rows stand for it here)."""
    assert FK.plan_bwd_route(*_route_inputs(8, k, n, torch.bfloat16)) == \
        "wgmma"
    t = FK.dw_tile(k, n, "wgmma")
    assert t.tile_cols == FK.wgmma_cols(min(k, n)) and t.rows >= t.cols
    assert FK.wgmma_cols(k) == (64 if k == 64 else 128)


_TILED_CASES = [
    (8, 64, 256, torch.float32, 0),      # fp32
    (8, 45, 64, torch.bfloat16, 0),      # K % 8 != 0
    (8, 64, 77, torch.bfloat16, 0),      # N % 8 != 0
    (8, 64, 256, torch.bfloat16, 1),     # a view 2 bytes off alignment
]
_TILED_IDS = ["fp32", "k45", "n77", "unaligned"]


@pytest.mark.parametrize("m,k,n,dtype,offset", _TILED_CASES,
                         ids=_TILED_IDS)
def test_other_inputs_take_the_tiled_route(m, k, n, dtype, offset):
    x, w, y, dy = _route_inputs(m, k, n, dtype, offset)
    assert FK.plan_bwd_route(x, w, y, dy) == "tiled"


def test_launch_counts_by_route_reset():
    FK.mm_bn_stats_bwd.launches_by_route["wgmma"] += 3
    FK.mm_bn_stats_fwd.launches_by_route["tiled"] += 2
    FK.mm_bn_stats_fwd.launches += 2
    FK.reset_launch_counts()
    assert FK.mm_bn_stats_bwd.launches_by_route == {"wgmma": 0, "tiled": 0}
    assert FK.mm_bn_stats_fwd.launches_by_route == {"wgmma": 0, "tiled": 0}
    assert FK.launch_counts() == {"mm_bn_stats_fwd": 0, "mm_bn_stats_bwd": 0}


@pytest.mark.parametrize("k,n,affine,relu", _R101)
def test_r101_bf16_fwd_takes_the_wgmma_route(k, n, affine, relu):
    """K5's planner on every distinct 1x1 geometry of ResNet-101 (M does
    not enter the choice); its B tile is 64 wide only at N = 64."""
    x, w, y, _ = _route_inputs(8, k, n, torch.bfloat16)
    assert FK.plan_fwd_route(x, w.t().contiguous(), y) == "wgmma"
    assert FK.wgmma_cols(n) == (64 if n == 64 else 128)


@pytest.mark.parametrize("m,k,n,dtype,offset", _TILED_CASES,
                         ids=_TILED_IDS)
def test_other_fwd_inputs_take_the_tiled_route(m, k, n, dtype, offset):
    x, w, y, _ = _route_inputs(m, k, n, dtype, offset)
    assert FK.plan_fwd_route(x, w.t().contiguous(), y) == "tiled"


@pytest.mark.parametrize("wrapper", ["fwd", "bwd"])
@pytest.mark.parametrize("m,k,n,dtype,offset", _TILED_CASES,
                         ids=_TILED_IDS)
def test_asking_wgmma_where_the_planner_refuses_raises(wrapper, m, k, n,
                                                       dtype, offset):
    """A route asked for is checked before the device decides between
    kernel and plain version, so this shows on the CPU too."""
    x, w, y, dy = _route_inputs(m, k, n, dtype, offset)
    stats = torch.zeros(n), torch.zeros(n)

    def call(route):
        if wrapper == "fwd":
            return FK.mm_bn_stats_fwd(x, w, None, None, False, route=route)
        return FK.mm_bn_stats_bwd(x, w, None, None, y, dy, *stats, False,
                                  route=route)

    with pytest.raises(ValueError, match="does not take"):
        call("wgmma")
    with pytest.raises(ValueError, match="does not take"):
        call("wmma")
    call("tiled")  # takes every input


def test_asked_routes_on_inputs_the_planner_takes():
    x, w, y, dy = _route_inputs(8, 64, 128, torch.bfloat16)
    for route in (None, *FK.ROUTES):
        got = FK.mm_bn_stats_fwd(x, w, None, None, True, route=route)
        assert got[0].shape == (8, 128)
    assert FK.resolve_route("f", None, "tiled") == "tiled"
    assert FK.resolve_route("f", "tiled", "wgmma") == "tiled"


@pytest.mark.parametrize("m,n", [(1000, 128), (401408, 256), (128, 64),
                                 (7, 8)])
def test_stats_partials_plan(m, n):
    """[blocks, 2N]: one row per 128-row block of y, covering every row."""
    blocks, cols = FK.plan_stats_partials(m, n)
    assert cols == 2 * n
    assert blocks * FK.BLOCK_ROWS >= m > (blocks - 1) * FK.BLOCK_ROWS
    assert FK.BLOCK_ROWS == FK.WG_ROWS


@pytest.mark.parametrize("affine", [True, False])
@pytest.mark.parametrize("relu", [False, True])
def test_fwd_activation_and_product_match_pallas(affine, relu):
    """K5's wgmma route as plain steps (the activation, then the product
    with its stats) against the JAX ``_fwd_pallas`` in interpret mode
    (32-row blocks, the last ragged) at ragged M, K, N, fp32; together they
    are the plain forward."""
    x, w, inv, beta, _, _ = _data(7)
    ji, jb = ((inv, beta) if affine
              else (np.ones_like(inv), np.zeros_like(beta)))
    want = _fwd_pallas(*map(jnp.asarray, (x, w, ji, jb)), relu, 32, True,
                       identity=not affine)
    tx, tw, ti, tb = map(torch.tensor, (x, w, inv, beta))
    if not affine:
        ti = tb = None
    a = P.activation_reference(tx, ti, tb, relu, torch.float32)
    got = P.mm_stats_reference(a, tw, torch.float32)
    for g, j, name in zip(got, want, ("y", "ssum", "ssq")):
        _close(g, j, dict(rtol=1e-5, atol=1e-5), name)
    whole = P.mm_bn_stats_reference(tx, tw, ti, tb, relu)
    assert all(torch.equal(g, r) for g, r in zip(got, whole))


@pytest.mark.parametrize("affine", [True, False])
@pytest.mark.parametrize("relu", [False, True])
def test_bwd_prologue_and_products_match_pallas(affine, relu):
    """The wgmma route's three steps as plain versions (the prologue, then
    the dx and the dW product) against the JAX ``_bwd_pallas`` in interpret
    mode (32-row blocks, the last ragged) at ragged M, K, N, fp32."""
    x, w, inv, beta, cs, cq = _data(5)
    rng = np.random.default_rng(6)
    y = rng.normal(size=(M, N)).astype(np.float32)
    dy = (rng.normal(size=(M, N)) * 0.1).astype(np.float32)
    want = _bwd_pallas(*map(jnp.asarray, (x, w, inv, beta, y, dy, cs, cq)),
                       relu, 32, True, identity=not affine)
    tx, tw, ti, tb = map(torch.tensor, (x, w, inv, beta))
    if not affine:
        ti = tb = None
    dyt, a = P.bwd_prologue_reference(tx, ti, tb, torch.tensor(y),
                                      torch.tensor(dy), torch.tensor(cs),
                                      torch.tensor(cq), relu, torch.float32)
    dx, dinv, dbeta = P.bwd_dx_reference(tx, tw, ti, tb, dyt, relu)
    dw = P.bwd_dw_reference(a, dyt)
    tol = dict(rtol=1e-5, atol=1e-5)
    _close(dx, want[0], tol, "dx")
    _close(dw, want[1], tol, "dw")
    if affine:
        _close(dinv, want[2], tol, "dinv")
        _close(dbeta, want[3], tol, "dbeta")
    else:
        assert dinv is None and dbeta is None
    got = P.mm_bn_stats_backward_reference(tx, tw, ti, tb, torch.tensor(y),
                                           torch.tensor(dy), torch.tensor(cs),
                                           torch.tensor(cq), relu)
    for g, r in zip(got, (dx, dw, dinv, dbeta)):
        assert (g is None and r is None) or torch.equal(g, r)


@pytest.mark.parametrize("raw,short,owner", [
    ("void (anonymous namespace)::fwd_wgmma_kernel<128, 1>(CUtensorMap_st,"
     " CUtensorMap_st, int, int, int, __nv_bfloat16*, float*)",
     "fwd_wgmma_kernel", "K5"),
    ("void (anonymous namespace)::fwd_stats_merge_kernel(float const*, int,"
     " int, float*)", "fwd_stats_merge_kernel", "K5"),
    ("void (anonymous namespace)::bwd_prologue_kernel<true, true>(...)",
     "bwd_prologue_kernel", "K6"),
    ("void (anonymous namespace)::sum_rows_kernel(float const*, int, int, "
     "float*)", "sum_rows_kernel", "K6"),
    ("void pytorch_flash::flash_fwd_kernel<Flash_fwd_kernel_traits<64> >"
     "(Flash_fwd_params)", "flash_fwd_kernel", None),
    ("ampere_bf16_s16816gemm_bf16_128x64_ldg8_f2f_tn",
     "ampere_bf16_s16816gemm_bf16_128x64_ldg8_f2f_tn", None),
], ids=["k5-gemm", "k5-merge", "k6-pass", "k6-merge", "flash", "cublas"])
def test_profile_kernel_names(raw, short, owner):
    """The profile attributes a kernel to K5 or K6 by its exact short name,
    so a library kernel whose name contains 'fwd_kernel' is neither."""
    assert chip_smoke.short_kernel_name(raw) == short
    owners = [o for o, names in (("K5", chip_smoke.K5_KERNELS),
                                 ("K6", chip_smoke.K6_KERNELS))
              if short in names]
    assert owners == ([owner] if owner else [])


def test_library_path_hashes_the_headers(tmp_path):
    """An edited header beside a source gives a new library path, so the
    source that includes it is rebuilt."""
    src, header = tmp_path / "k.cu", tmp_path / "core.cuh"
    src.write_text('#include "core.cuh"\n')
    header.write_text("// v1\n")
    first = B.library_path(src)
    assert B.library_path(src) == first
    header.write_text("// v2\n")
    assert B.library_path(src) != first
    assert B.library_path(src).name == "libk.so"


def test_kernel_input_checks():
    x = torch.zeros(8, 4, dtype=torch.float16)
    with pytest.raises(TypeError):
        FK._check_inputs("fwd", x, torch.zeros(4, 3, dtype=torch.float16),
                         None, None)
    x = torch.zeros(8, 4)
    with pytest.raises(ValueError):
        FK._check_inputs("fwd", x, torch.zeros(5, 3), None, None)
    with pytest.raises(TypeError):
        FK._check_inputs("fwd", x, torch.zeros(4, 3), torch.ones(3),
                         torch.zeros(3))
    with pytest.raises(ValueError):
        P.mm_bn_stats(x, torch.zeros(4, 3), inv=torch.ones(4))

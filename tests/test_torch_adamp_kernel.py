"""AdamP's multi-tensor kernel (K7, ``ops/adamp.py`` + ``csrc/adamp.cu``).

On the CPU: the launch planner (every row of every leaf in exactly one
tile, each row on the warps its length asks for, the scratch rows in
order) and the checks that refuse what the kernel does not take.

On the card (marked ``card``; each skips itself without one): the kernel
against the plain version (``adamp_reference`` on CPU copies) over 3 steps,
on a leaf set shaped like the server's: a channels_last conv, a long table,
linear weights whose rows take 1, 2, 4 and 8 warps, rows of odd length and
rows at an unaligned address (the 4-byte path), a vector cut into rows,
1-D and 0-d leaves, and a leaf without a gradient; with weight decay 0 and
1e-2; gradients built to drive each branch (orthogonal to every row: the
channel view; orthogonal to the whole leaf only: the layer view; with a
radial part: none). Moments, parameters, steps and each leaf's mode are
checked. Then one step captured in a CUDA graph and replayed against the
eager step, the wrapper's refusals, the launch counter, and a list longer
than a launch takes.

This file imports no JAX, so it runs on the card:
``python -m pytest --noconftest -p no:cacheprovider tests/test_torch_adamp_kernel.py``.

Tolerance, kernel vs plain: rtol 1e-5, atol 1e-6 on parameters and moments
of order 1. Both compute in fp32; they differ in the order of the row sums
(one block's tree against PyTorch's reduction) and in contracted
multiply-adds, a few ulp of a sum, and the projection moves a parameter by
about lr = 1e-2 a step, so atol is 1e-4 of a step.
"""

import math

import numpy as np
import pytest
import torch

from creamfl_tpu_torch.ops import adamp as A
from creamfl_tpu_torch.optim.adamp import AdamP
from torch_cpu_share import torch_cpu_share  # noqa: F401

TOL = dict(rtol=1e-5, atol=1e-6)
HYPER = dict(beta1=0.9, beta2=0.999, eps=1e-8, delta=0.1, wd_ratio=0.1)
# The server's matrices' row lengths (PCME on ResNet-101 + BERT-base).
SERVER_ROWS = (64, 128, 147, 256, 512, 576, 768, 1024, 1152, 2048, 2304,
               3072, 4608)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the AdamP kernel runs only there")
    return torch.device("cuda")


# -- planning (CPU) -------------------------------------------------------------
@pytest.mark.parametrize("row_len", SERVER_ROWS + (1, 3, 9000))
def test_plan_covers_each_row_once(row_len):
    rows = 37 if row_len > 1000 else 1000
    plan = A.plan_leaf(rows * row_len, row_len)
    assert plan.matrix and plan.rows == rows and plan.row_len == row_len
    group = A.WARPS // plan.warps
    assert plan.rows_per_tile % group == 0
    # A lane takes at most LANE_ELEMS of a row unless all 8 warps do.
    assert (plan.warps == A.WARPS
            or row_len <= plan.warps * 32 * A.LANE_ELEMS)
    assert plan.warps == 1 or row_len > plan.warps // 2 * 32 * A.LANE_ELEMS
    # About TILE elements a tile, in whole rows, and every row in one tile.
    assert (plan.rows_per_tile * row_len <= A.TILE
            or plan.rows_per_tile == group)
    covered = [r for t in range(plan.tiles)
               for r in range(t * plan.rows_per_tile,
                              min((t + 1) * plan.rows_per_tile, rows))]
    assert covered == list(range(rows))


@pytest.mark.parametrize("numel", [1, 5, 3072, 8192, 8193, 20000])
def test_plan_vector_rows(numel):
    plan = A.plan_leaf(numel, 0)
    assert not plan.matrix and plan.warps == A.WARPS
    assert plan.row_len == min(numel, A.VECTOR_ROW)
    assert (plan.rows - 1) * plan.row_len < numel <= plan.rows * plan.row_len
    assert plan.tiles * plan.rows_per_tile >= plan.rows


def test_plan_step_prefix_sums():
    shapes = ((64, 3, 7, 7), (3,), (30522, 768), (), (2048, 512, 3, 3))
    meta, tiles, rows = A.plan_step(shapes)
    plans = [A.plan_leaf(math.prod(s), A.row_length(s)) for s in shapes]
    assert tiles.tolist() == [0, *np.cumsum([p.tiles for p in plans])]
    assert rows == 64 + 30522 + 2048
    assert meta[:, 3].tolist() == [0, 64, 64, 64 + 30522, 64 + 30522]
    for (numel, length, info, _), plan in zip(meta.tolist(), plans):
        assert numel == plan.numel and length == plan.row_len
        assert info & A.ROWS_MASK == plan.rows_per_tile
        assert 1 << ((info >> 24) & 3) == plan.warps
        assert bool(info & A.MATRIX_BIT) == plan.matrix
        assert not info & A.VECTOR_BIT  # set per call, from the addresses
    assert A.launches_per_step(521, 536) == 3
    assert A.launches_per_step(537, 536) == 6


def _leaf(shape, memory_format=torch.contiguous_format):
    p = torch.zeros(shape).to(memory_format=memory_format)
    return p, torch.zeros_like(p), torch.zeros_like(p), torch.zeros_like(p)


def test_check_leaf_takes_the_server_layouts():
    step = torch.zeros((), dtype=torch.float64)
    for shape, fmt in (((64, 3, 7, 7), torch.channels_last),
                       ((2048, 512, 1, 1), torch.channels_last),
                       ((30, 8), torch.contiguous_format),
                       ((7,), torch.contiguous_format),
                       ((), torch.contiguous_format)):
        A.check_leaf(*_leaf(shape, fmt), step)


def test_check_leaf_refusals():
    step = torch.zeros((), dtype=torch.float64)
    p, g, m, v = _leaf((8, 4, 3, 3), torch.channels_last)
    with pytest.raises(ValueError, match="laid out otherwise"):
        A.check_leaf(p, g.contiguous(), m, v, step)
    with pytest.raises(ValueError, match="laid out otherwise"):
        A.check_leaf(p, g, m, v[:4], step)
    with pytest.raises(TypeError, match="float32"):
        A.check_leaf(p.bfloat16(), g.bfloat16(), m, v, step)
    with pytest.raises(TypeError, match="float64"):
        A.check_leaf(p, g, m, v, step.float())
    t = torch.zeros(10, 6).t()
    with pytest.raises(ValueError, match="rows not contiguous"):
        A.check_leaf(t, t.clone(), t.clone(), t.clone(), step)
    with pytest.raises(ValueError, match="not dense"):
        s = torch.zeros(10, 12)[:, ::2]
        A.check_leaf(s, s, s, s, step)
    with pytest.raises(ValueError, match="0 elements"):
        e = torch.zeros(0, 3)
        A.check_leaf(e, e, e, e, step)
    # A size-1 dimension's stride does not count.
    q = torch.zeros(6, 1, 4)
    A.check_leaf(q, q.as_strided(q.shape, (4, 1, 1)), q, q, step)


# -- the kernel on the card ---------------------------------------------------
def _unaligned(rows, cols, gen):
    """A [rows, cols] view one float past a 16-byte boundary."""
    flat = torch.empty(rows * cols + 1)
    view = flat[1:].view(rows, cols)
    view.copy_(torch.randn(rows, cols, generator=gen))
    return view


# (shape, memory format, gradient kind)
LEAVES = (
    ((16, 8, 3, 3), torch.channels_last, "rows"),
    ((64, 3, 7, 7), torch.channels_last, "radial"),
    ((24, 16, 1, 1), torch.channels_last, "whole"),
    ((4096, 96), None, "rows"),   # a long table, 1 warp a row
    ((40, 1500), None, "whole"),  # 2 warps a row
    ((20, 3000), None, "radial"),  # 4 warps a row
    ((12, 4608), None, "rows"),   # 8 warps a row
    ((6, 9000), None, "whole"),   # 8 warps, over 32 elements a lane
    ((10, 147), None, "rows"),    # the 4-byte path
    ("unaligned", None, "whole"),
    ((20000,), None, "radial"),   # a vector of three rows, the last ragged
    ((300,), None, "radial"),
    ((3,), None, "radial"),
    ((), None, "radial"),
)
WANT_MODES = {"rows": 1, "whole": 2, "radial": 0}


def _start(gen):
    out = []
    for shape, fmt, _ in LEAVES:
        if shape == "unaligned":
            out.append(_unaligned(40, 64, gen))
            continue
        p = torch.randn(shape, generator=gen)
        out.append(p.to(memory_format=fmt) if fmt is not None else p)
    return out


def _grad(p, kind, gen):
    """A gradient that puts the leaf on the branch ``kind`` names."""
    r = torch.randn(p.shape, generator=gen)
    if kind == "radial" or p.dim() < 2:
        return r + 2 * p
    rows, q = p.reshape(p.shape[0], -1), r.reshape(p.shape[0], -1)
    if kind == "rows":
        q = q - rows * (q * rows).sum(1, keepdim=True) / (rows * rows).sum(
            1, keepdim=True)
    else:
        q = q - rows * (q * rows).sum() / (rows * rows).sum()
    # The parameter's layout (autograd gives a gradient its parameter's).
    return torch.empty_like(p).copy_(q.reshape(p.shape))


def _copy_to(ts, dev):
    """Copies on ``dev`` in the same layouts, an unaligned view unaligned."""
    out = []
    for t in ts:
        if t.data_ptr() % 16:
            c = torch.empty(t.numel() + 1, device=dev)[1:].view(t.shape)
        else:
            c = torch.empty_like(t, device=dev)
        out.append(c.copy_(t))
    return out


def _run(params, gens, weight_decay, dev, steps=3):
    """``steps`` steps of ``A.adamp`` from zero state; the modes of each."""
    ms = [torch.zeros_like(p) for p in params]
    vs = [torch.zeros_like(p) for p in params]
    ss = [torch.zeros((), dtype=torch.float64, device=dev) for _ in params]
    lr = torch.tensor(1e-2, dtype=torch.float64, device=dev)
    modes = []
    for step in range(steps):
        grads = [_grad(p.detach().cpu(), kind, gens[step]).to(dev)
                 for p, (_, _, kind) in zip(params, LEAVES)]
        grads = [torch.empty_like(p).copy_(g) for p, g in zip(params, grads)]
        modes.append(A.adamp(params, grads, ms, vs, ss, lr,
                             weight_decay=weight_decay, **HYPER).cpu())
    return params, ms, vs, ss, modes


def _close(got, want, what):
    np.testing.assert_allclose(got.detach().cpu().numpy(),
                               want.detach().numpy(), err_msg=what, **TOL)


@pytest.mark.card
@pytest.mark.parametrize("weight_decay", [0.0, 1e-2])
def test_kernel_matches_plain(cuda, weight_decay):
    gen = torch.Generator().manual_seed(0)
    start = _start(gen)
    cpu = _copy_to(start, torch.device("cpu"))
    dev = _copy_to(start, cuda)
    assert dev[1].is_contiguous(memory_format=torch.channels_last)
    assert dev[9].data_ptr() % 16 != 0
    before = A.adamp.launches
    got = _run(dev, [torch.Generator().manual_seed(s) for s in (1, 2, 3)],
               weight_decay, cuda)
    assert A.adamp.launches - before == 3 * A.launches_per_step(
        len(LEAVES), A.capacity())
    want = _run(cpu, [torch.Generator().manual_seed(s) for s in (1, 2, 3)],
                weight_decay, torch.device("cpu"))
    for step, (mg, mw) in enumerate(zip(got[4], want[4])):
        assert mg.tolist() == mw.tolist(), step
    assert want[4][0].tolist() == [
        0 if isinstance(s, tuple) and len(s) < 2 else WANT_MODES[k]
        for s, _, k in LEAVES]
    for name, g_list, w_list in zip(("param", "exp_avg", "exp_avg_sq"),
                                    got[:3], want[:3]):
        for i, (g, w) in enumerate(zip(g_list, w_list)):
            assert g.stride() == w.stride() or g.dim() < 2
            _close(g, w, f"{name} of leaf {i} {tuple(w.shape)}")
    assert [float(s) for s in got[3]] == [3.0] * len(LEAVES)


@pytest.mark.card
def test_optimizer_skips_a_leaf_without_gradient(cuda):
    gen = torch.Generator().manual_seed(4)
    a = torch.nn.Parameter(torch.randn(32, 16, generator=gen).to(cuda))
    b = torch.nn.Parameter(torch.randn(8, generator=gen).to(cuda))
    frozen = torch.nn.Parameter(torch.randn(4, 4, generator=gen).to(cuda))
    ref = [torch.nn.Parameter(t.detach().cpu()) for t in (a, b, frozen)]
    opt, opt_ref = AdamP([a, b, frozen], lr=1e-2), AdamP(ref, lr=1e-2)
    keep = frozen.detach().clone()
    for step in range(3):
        for p, q in zip((a, b), ref):
            g = torch.randn(p.shape, generator=gen)
            p.grad, q.grad = g.to(cuda), g.clone()
        opt.step()
        opt_ref.step()
    assert frozen not in opt.state and torch.equal(frozen.detach(), keep)
    for p, q in zip((a, b), ref[:2]):
        _close(p, q, str(tuple(p.shape)))
        assert float(opt.state[p]["step"]) == 3.0


@pytest.mark.card
def test_graph_replay_equals_eager(cuda):
    gen = torch.Generator().manual_seed(5)
    start = [t for t, (s, _, _) in zip(_start(gen), LEAVES)
             if s != "unaligned"]
    grads = [_grad(p, kind, gen) for p, (s, _, kind) in
             zip(start, [x for x in LEAVES if x[0] != "unaligned"])]

    def make():
        ps = [torch.nn.Parameter(t) for t in _copy_to(start, cuda)]
        for p, g in zip(ps, _copy_to(grads, cuda)):
            p.grad = torch.empty_like(p).copy_(g)
        opt = AdamP(ps, lr=1e-2, weight_decay=1e-2)
        opt.init_state()
        return ps, opt

    eager, opt_e = make()
    graphed, opt_g = make()
    A.capacity()  # build and load the library before the capture
    opt_g.step()  # the warm-up step a capture is taken after
    opt_e.step()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        opt_g.step()
    for _ in range(2):
        graph.replay()
        opt_e.step()
    torch.cuda.synchronize()
    for p, q in zip(graphed, eager):
        assert torch.equal(p, q), tuple(p.shape)
        for key in ("exp_avg", "exp_avg_sq", "step"):
            assert torch.equal(opt_g.state[p][key], opt_e.state[q][key])
    assert float(opt_g.state[graphed[0]]["step"]) == 3.0


@pytest.mark.card
def test_wrapper_refusals(cuda):
    lr = torch.tensor(1e-2, dtype=torch.float64, device=cuda)
    step = [torch.zeros((), dtype=torch.float64, device=cuda)]
    p = torch.randn(8, 4, 3, 3, device=cuda).to(
        memory_format=torch.channels_last)
    m, v = torch.zeros_like(p), torch.zeros_like(p)
    with pytest.raises(TypeError, match="float32"):
        pb = p.bfloat16()
        A.adamp([pb], [pb.clone()], [pb.clone()], [pb.clone()], step, lr,
                weight_decay=0.0, **HYPER)
    with pytest.raises(ValueError, match="laid out otherwise"):
        A.adamp([p], [torch.randn(8, 4, 3, 3, device=cuda)], [m], [v], step,
                lr, weight_decay=0.0, **HYPER)
    with pytest.raises(TypeError, match="lr"):
        A.adamp([p], [p.clone()], [m], [v], step, lr.float(),
                weight_decay=0.0, **HYPER)
    assert float(step[0]) == 0.0  # nothing ran


@pytest.mark.card
def test_more_leaves_than_a_launch_takes(cuda):
    """Two launches of the three passes each; the same step as the plain
    version."""
    gen = torch.Generator().manual_seed(6)
    n = A.capacity() + 7
    shapes = [(3, 5) if i % 3 else (7,) for i in range(n)]
    start = [torch.randn(s, generator=gen) for s in shapes]
    grads = [torch.randn(s, generator=gen) for s in shapes]

    def run(dev):
        ps = _copy_to(start, dev)
        ms = [torch.zeros_like(p) for p in ps]
        vs = [torch.zeros_like(p) for p in ps]
        ss = [torch.zeros((), dtype=torch.float64, device=dev) for _ in ps]
        lr = torch.tensor(1e-2, dtype=torch.float64, device=dev)
        modes = A.adamp(ps, _copy_to(grads, dev), ms, vs, ss, lr,
                        weight_decay=1e-2, **HYPER)
        return ps, ms, modes.cpu()

    before = A.adamp.launches_by_route["multi_tensor"]
    got = run(cuda)
    assert A.adamp.launches_by_route["multi_tensor"] - before == 6
    want = run(torch.device("cpu"))
    assert got[2].tolist() == want[2].tolist()
    for g_list, w_list in zip(got[:2], want[:2]):
        for g, w in zip(g_list, w_list):
            _close(g, w, str(tuple(w.shape)))

"""The Granite-4.0-H-Small text tower (``models/granite_h.py``) against the
plain reference (``benchmark/reference/granite_h.py``: float32, the state
token by token, the held experts found on the host), on the CPU at a tiny
size (weights at std 0.3): hidden 64, 8 SSM heads of 16, state 8, chunk 8,
4 query and 2 key-value heads, 12 experts of which 6 are held, top-3,
expert width 32, shared width 48, 3 layers (Mamba, attention, Mamba),
vocabulary 512.

- The port in float32 against the reference on the same seeded weights,
  right-padded captions of 32 tokens (four chunks of 8): the pooled
  embedding, the balance loss and every leaf's gradient, at rtol 1e-4.
  Both compute in float32 and differ in the order of their sums: the
  chunked scan's products over a chunk against one state update a token,
  the grouped products and the per-token sum of the k picks against the
  per-expert products and ``index_add``. That is a few ulp of sums of
  tens of terms, which 3 layers and the backward carry to about 1e-6
  relative; 1e-4 leaves room for it and for the small leaves (norms,
  ``A_log``, ``dt_bias``, ``D``, the router) whose gradients sum over
  every token.
- The chunked scan against the token-by-token recurrence, at chunk 4 over
  12 tokens (three chunks: the chunk recurrence), 5 (a ragged last chunk)
  and 16 (one chunk, the cell's case), forward and gradients, at rtol
  1e-5: one float32 order of sums against another, over 12 tokens.
- The shares: the layer's MoE run once for each disjoint share of the
  experts (held 0-5, then 6-11); the two routed parts, with the shared MLP
  counted once, add up to the uncut reference layer (rtol 1e-5).
- AdamP over the port's expert leaves equals AdamP over each expert's two
  published slices (``input_linear[e]``, ``output_linear[e]``).
- One ``--smoke --text_encoder granite_4_0_h_small`` round through
  ``main.run`` with a finite loss, and the recorder's spans and counters.

On the card (marked ``card``; each skips itself without one): the tower's
forward and backward under ``torch.cuda.set_sync_debug_mode("error")`` (no
host read in a step), and K7 over the server's leaves with this tower
against the plain AdamP. This file imports no JAX:
``python -m pytest --noconftest -p no:cacheprovider -m card
tests/test_torch_granite_h.py``.
"""

import dataclasses
import math
import os
import sys

import pytest
import torch

from creamfl_tpu_torch.models import granite_h as G
from creamfl_tpu_torch.models.pcme import TextEncoderLM
from creamfl_tpu_torch.optim.adamp import AdamP
from torch_cpu_share import torch_cpu_share  # noqa: F401

BENCH = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "benchmark")
if BENCH not in sys.path:
    sys.path.insert(0, BENCH)

from reference import granite_h as R  # noqa: E402
from reference.models import Quant  # noqa: E402
from reference.train import AdamP as RefAdamP  # noqa: E402

TINY = G.GraniteHConfig.tiny()
B, L, EMBED = 4, 32, 16


def ref_cfg(c: G.GraniteHConfig, held=None) -> dict:
    """The reference's config dict of a port config."""
    keys = ("vocab_size", "hidden_size", "intermediate_size",
            "shared_intermediate_size", "num_attention_heads",
            "num_key_value_heads", "attention_multiplier",
            "embedding_multiplier", "residual_multiplier", "mamba_n_heads",
            "mamba_d_head", "mamba_d_state", "mamba_n_groups",
            "mamba_d_conv", "mamba_conv_bias", "num_local_experts",
            "num_experts_per_tok", "rms_norm_eps", "router_aux_loss_coef",
            "initializer_range")
    out = {k: getattr(c, k) for k in keys}
    out.update(num_layers=c.num_hidden_layers,
               layer_types=list(c.layer_types),
               experts_held=list(c.experts_held if held is None else held))
    return out


def captions(vocab: int, seed: int = 0, batch: int = B, length: int = L):
    """(ids, mask): right-padded captions of 6 to ``length`` tokens."""
    g = torch.Generator().manual_seed(seed)
    ids = torch.randint(0, vocab, (batch, length), generator=g)
    n = torch.randint(6, length + 1, (batch,), generator=g)
    n[0] = length
    mask = (torch.arange(length)[None] < n[:, None]).to(torch.int32)
    return ids, mask


def towers(seed: int = 7, cfg: G.GraniteHConfig = TINY):
    port = TextEncoderLM(EMBED, cfg)
    G.init_granite_h(port, torch.Generator().manual_seed(seed))
    ref = R.TextEncoderGraniteH(EMBED, ref_cfg(cfg), Quant())
    R.init_granite_h(ref, torch.Generator().manual_seed(seed),
                     cfg.initializer_range)
    return port.train(), ref.train()


def test_same_weights_and_names_as_the_reference():
    port, ref = towers()
    mine, theirs = dict(port.named_parameters()), dict(ref.named_parameters())
    assert set(mine) == set(theirs)
    for k, p in mine.items():
        assert torch.equal(p, theirs[k]), k
    moe = "model.layers.0.block_sparse_moe."
    assert mine[moe + "experts.5.input_linear.weight"].shape == (64, 64)
    assert mine[moe + "experts.5.output_linear.weight"].shape == (64, 32)
    assert moe + "experts.6.input_linear.weight" not in mine
    assert mine[moe + "router.layer.weight"].shape == (12, 64)
    assert mine["model.layers.0.mamba.in_proj.weight"].shape == (
        128 + 128 + 16 + 8, 64)
    assert "model.layers.1.self_attn.k_proj.weight" in mine
    torch.testing.assert_close(mine["model.layers.2.mamba.A_log"],
                               torch.log(torch.arange(1.0, 9.0)))


@pytest.mark.parametrize("chunk", [8, 64])
def test_tower_equals_reference(chunk):
    """Chunk 8: four chunks of the 32 tokens; 64: one chunk, the cell's
    case (32 tokens under the published 256)."""
    cfg = dataclasses.replace(TINY, mamba_chunk_size=chunk)
    port, ref = towers(cfg=cfg)
    ids, mask = captions(cfg.vocab_size)
    probe = torch.randn(B, EMBED, generator=torch.Generator().manual_seed(1))
    out = port(ids, mask)
    emb, aux = out["embedding"], out["aux_loss"]
    ((emb * probe).sum() + 30 * aux).backward()
    r_emb, r_aux = ref(ids, mask)
    ((r_emb * probe).sum() + 30 * r_aux).backward()
    torch.testing.assert_close(emb, r_emb, rtol=1e-4, atol=1e-6)
    torch.testing.assert_close(aux, r_aux, rtol=1e-4, atol=0)
    theirs = dict(ref.named_parameters())
    for k, p in port.named_parameters():
        g, rg = p.grad, theirs[k].grad
        assert g is not None and rg is not None, k
        scale = float(rg.abs().max())
        torch.testing.assert_close(g, rg, rtol=1e-4, atol=1e-4 * scale,
                                   msg=k)
    assert float(aux.detach()) > 0


@pytest.mark.parametrize("chunk", [4, 5, 16])
def test_chunked_scan_equals_the_token_recurrence(chunk):
    g = torch.Generator().manual_seed(chunk)
    bsz, length, heads, p, n = 2, 12, 4, 8, 6
    x = torch.randn(bsz, length, heads, p, generator=g, requires_grad=True)
    dt = torch.nn.functional.softplus(torch.randn(
        bsz, length, heads, generator=g)).requires_grad_()
    a = -torch.exp(torch.log(torch.arange(1.0, heads + 1))).requires_grad_()
    b = torch.randn(bsz, length, 1, n, generator=g, requires_grad=True)
    c = torch.randn(bsz, length, 1, n, generator=g, requires_grad=True)
    probe = torch.randn(bsz, length, heads, p, generator=g)
    y = G.ssd(x, dt, a, b, c, chunk)
    grads = torch.autograd.grad((y * probe).sum(), (x, dt, a, b, c))
    r = R.ssm_tokens(x, dt, a, b.expand(-1, -1, heads, -1),
                     c.expand(-1, -1, heads, -1))
    r_grads = torch.autograd.grad((r * probe).sum(), (x, dt, a, b, c))
    torch.testing.assert_close(y, r, rtol=1e-5, atol=1e-6)
    for mine, theirs in zip(grads, r_grads):
        torch.testing.assert_close(mine, theirs, rtol=1e-5, atol=1e-5)


def _moe_pair(held, seed=3):
    """The reference's uncut MoE (every expert held) and the port's MoE
    holding ``held``, on the same weights."""
    full = R.MoE(ref_cfg(TINY), range(TINY.num_local_experts))
    R.init_granite_h(full, torch.Generator().manual_seed(seed),
                     TINY.initializer_range)
    port = G.MoE(dataclasses.replace(TINY, experts_held=tuple(held)))
    sd = {k: v for k, v in full.state_dict().items()
          if not k.startswith("experts.")
          or int(k.split(".")[1]) in set(held)}
    port.load_state_dict(sd, strict=True)
    return full.train(), port.train()


def test_shares_add_up_to_the_uncut_layer():
    h = torch.randn(B * L, TINY.hidden_size,
                    generator=torch.Generator().manual_seed(5))
    keep = torch.ones(B * L)
    shared = R.GatedMLP(TINY.hidden_size, TINY.shared_intermediate_size)
    R.init_granite_h(shared, torch.Generator().manual_seed(6),
                     TINY.initializer_range)
    full, low = _moe_pair(range(0, 6))
    _, high = _moe_pair(range(6, 12))
    with torch.no_grad():
        want = full(h, keep)[0] + shared(h)
        a = low(h, keep)[0] + shared(h)
        b = high(h, keep)[0] + shared(h)
        got = a + b - shared(h)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-6)
    # Each share alone is its part of the layer, not the whole.
    assert float((a - want).abs().max()) > 1e-3


def test_adamp_steps_each_expert_slice_as_its_own_leaf():
    """The published experts are two tensors a layer, [E, 2W, d] and
    [E, d, W]; the port's leaves are their slices, and one AdamP step over
    them equals the plain AdamP over each published slice alone."""
    _, port = _moe_pair(range(0, 6))
    h = torch.randn(B * L, TINY.hidden_size,
                    generator=torch.Generator().manual_seed(4))
    out, _ = port(h, torch.ones(B * L))
    out.square().sum().backward()
    experts = [port.experts[str(e)] for e in range(6)]
    published = [torch.stack([getattr(e, n).weight for e in experts])
                 for n in ("input_linear", "output_linear")]
    assert published[0].shape == (6, 2 * TINY.intermediate_size,
                                  TINY.hidden_size)
    slices = [w[e].detach().clone().requires_grad_() for w in published
              for e in range(6)]
    for s, (e, n) in zip(slices, [(e, n) for n in ("input_linear",
                                                   "output_linear")
                                  for e in range(6)]):
        s.grad = getattr(experts[e], n).weight.grad.clone()
    leaves = [getattr(e, n).weight for n in ("input_linear", "output_linear")
              for e in experts]
    hyper = dict(betas=(0.9, 0.999), eps=1e-8, weight_decay=1e-2,
                 delta=0.1, wd_ratio=0.1)
    AdamP(leaves, lr=1e-2, **hyper).step()
    r_opt = RefAdamP(slices, dict(hyper, betas=list(hyper["betas"])))
    r_opt.lr = 1e-2
    r_opt.step()
    for mine, theirs in zip(leaves, slices):
        torch.testing.assert_close(mine, theirs, rtol=1e-6, atol=1e-7)


def test_smoke_round_with_the_tower(tmp_path):
    from creamfl_tpu_torch import main

    args = main.parse_args([
        "--no-cuda", "--synthetic", "--smoke", "--no_mesh",
        "--text_encoder", "granite_4_0_h_small", "--comm_rounds", "1",
        "--local_epochs", "1", "--num_img_clients", "1",
        "--num_txt_clients", "0", "--num_mm_clients", "0",
        "--client_num_per_round", "1", "--seed", "3",
        "--exp_dir", str(tmp_path)])
    algo = main.run(args)
    assert isinstance(algo.server.model.txt_enc.model, G.GraniteHModel)
    assert algo.server.moe == (3, 3) and algo.server.mixers == 2
    loss = [line for line in open(tmp_path / "Test.log")
            if "server epoch loss" in line]
    assert loss and math.isfinite(float(loss[-1].split()[-1]))
    assert all(torch.isfinite(p).all()
               for p in algo.server_state.model.parameters())


def test_recorder_counts_the_mixers_and_the_routing():
    from creamfl_tpu_torch.utils import profiling

    port, _ = towers()
    ids, mask = captions(TINY.vocab_size)
    with profiling.recording() as snap:
        port(ids, mask)
    held = snap.counters["moe.held_pairs"]
    assert 0 < held <= 3 * B * L * TINY.num_experts_per_tok
    for name, n in (("creamfl.mamba.proj", 4), ("creamfl.mamba.conv", 2),
                    ("creamfl.mamba.scan", 2), ("creamfl.mamba.norm", 2),
                    ("creamfl.moe.route", 3), ("creamfl.moe.experts", 3),
                    ("creamfl.moe.combine", 6)):
        assert snap.counts[name] == n, name


def test_server_counts_mamba_tokens():
    from creamfl_tpu_torch.config import default_config_path, parse_config
    from creamfl_tpu_torch.engine.server import ServerEngine
    from creamfl_tpu_torch.utils import profiling

    cfg = parse_config(default_config_path("coco.json"), strict_cast=False,
                       model__embed_dim=16, model__cnn_type="resnet10",
                       model__not_bert=False)
    engine = ServerEngine(cfg, vocab_size=50, bert_config=TINY, device="cpu")
    with profiling.recording() as snap:
        engine._count_steps(2, 8, torch.zeros(8, 12))
    assert snap.counters["mamba.tokens"] == 8 * 12 * 2
    assert snap.counters["moe.pairs"] == 8 * 12 * 3 * 3


# -- on the card --------------------------------------------------------------
@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the grouped products in bf16 run "
                    "only there")
    return torch.device("cuda")


@pytest.mark.card
def test_no_host_read_in_the_towers_step(cuda):
    cfg = dataclasses.replace(G.GraniteHConfig(), num_hidden_layers=2,
                              layer_types=("mamba", "attention"))
    tower = TextEncoderLM(256, cfg, dtype=torch.bfloat16)
    G.init_granite_h(tower, torch.Generator().manual_seed(0))
    tower = tower.to(cuda).train()
    ids, mask = captions(cfg.vocab_size, batch=128)
    ids, mask = ids.to(cuda), mask.to(cuda)
    for mode in ("default", "error"):  # a first step makes lazy state
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode(mode)
        try:
            out = tower(ids, mask)
            (out["embedding"].square().sum() + out["aux_loss"]).backward()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    assert all(torch.isfinite(p.grad).all() for p in tower.parameters())


@pytest.mark.card
def test_adamp_kernel_at_the_towers_leaves(cuda):
    from creamfl_tpu_torch.models.pcme import PCME
    from creamfl_tpu_torch.ops import adamp as A

    model = PCME(embed_dim=256, cnn_type="resnet101", not_bert=False,
                 bert_config=G.GraniteHConfig())
    shapes = [tuple(p.shape) for p in model.parameters()] + [(1,), (1,)]
    del model
    n = len(shapes)
    assert n > A.capacity(), (n, A.capacity())
    # A small copy of each leaf's shape class: the launch plan and the
    # per-leaf arithmetic, not the 2.4 B elements.
    shapes = [tuple(min(d, 64) for d in s) for s in shapes]
    g = torch.Generator(device=cuda).manual_seed(0)

    def leaves():
        return [torch.randn(s, device=cuda, generator=g) * 0.02
                for s in shapes]

    params, grads = leaves(), leaves()
    m = [torch.zeros_like(p) for p in params]
    v = [torch.zeros_like(p) for p in params]
    steps = [torch.zeros((), dtype=torch.float64, device=cuda)
             for _ in shapes]
    plain = [[t.clone() for t in ts] for ts in (params, m, v, steps)]
    lr = torch.tensor(2e-4, dtype=torch.float64, device=cuda)
    hyper = dict(beta1=0.9, beta2=0.999, eps=1e-8, weight_decay=0.0,
                 delta=0.1, wd_ratio=0.1)
    before = A.adamp.launches
    modes = A.adamp(params, grads, m, v, steps, lr, **hyper)
    assert A.adamp.launches - before == A.launches_per_step(n, A.capacity())
    want = A.adamp_reference(plain[0], grads, plain[1], plain[2], plain[3],
                             lr, **hyper)
    assert torch.equal(modes.cpu(), want.cpu())
    for a, b in zip(params + m + v, plain[0] + plain[1] + plain[2]):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-6)

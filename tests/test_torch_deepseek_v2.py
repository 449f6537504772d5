"""The DeepSeek-V2-Lite text tower (``models/deepseek_v2.py``) against the
plain reference (``benchmark/reference/deepseek_v2.py``: float32, no
kernel, the held experts found on the host), on the CPU at a tiny size:
hidden 64, 4 heads, latent 32, rope 16, nope / v 32, 16 experts of which 8
are held, top-4, 2 shared, width 48, 1 dense + 2 MoE layers, vocabulary
512.

- The port in float32 against the reference on the same seeded weights:
  the pooled embedding, the balance loss and every leaf's gradient, at
  rtol 1e-4. Both compute in float32; they differ in the order of their
  sums (the port's grouped products and its per-token sum of the k picks
  against the reference's per-expert products and its ``index_add`` over
  the experts), a few ulp of sums of 64-128 terms, which the tower's 3
  layers and the backward carry to about 1e-6 relative; 1e-4 leaves
  room for that and for the small leaves (norms, the router) whose
  gradients are sums over every token.
- The shares: the layer run once for each disjoint share of the experts
  (held 0-7, then 8-15); the two routed parts, with the shared experts
  counted once, add up to the uncut reference layer (rtol 1e-5: one
  float32 product and sum against another).
- YaRN's anchors at the published config: low 10, high 23, the softmax
  scale 0.114721, ``inv_freq`` against its closed form.
- AdamP over the port's expert layout equals AdamP over per-expert leaves:
  each expert's three projections are leaves of their own, and one step of
  the port's optimizer equals the reference's per-leaf AdamP.
- One ``--smoke --text_encoder deepseek_v2_lite`` round through ``main.run``
  with a finite loss.

On the card (marked ``card``; each skips itself without one): the tower's
forward and backward under ``torch.cuda.set_sync_debug_mode("error")`` (no
host read in a step); the feature and distill chunks captured in CUDA
graphs and replayed against eager steps; K7 over the server's leaves with
this tower (about 790, more than one launch takes) against the plain
AdamP. This file imports no JAX:
``python -m pytest --noconftest -p no:cacheprovider -m card
tests/test_torch_deepseek_v2.py``.
"""

import copy
import dataclasses
import math
import os
import sys

import numpy as np
import pytest
import torch

from creamfl_tpu_torch.models import deepseek_v2 as D
from creamfl_tpu_torch.models.pcme import TextEncoderDeepseekV2
from creamfl_tpu_torch.optim.adamp import AdamP
from torch_cpu_share import torch_cpu_share  # noqa: F401

BENCH = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "benchmark")
if BENCH not in sys.path:
    sys.path.insert(0, BENCH)

from reference import deepseek_v2 as R  # noqa: E402
from reference.models import Quant  # noqa: E402
from reference.train import AdamP as RefAdamP  # noqa: E402

TINY = D.DeepseekV2Config.tiny()
B, L, EMBED = 4, 32, 16


def ref_cfg(c: D.DeepseekV2Config, held=None) -> dict:
    """The reference's config dict of a port config."""
    return dict(
        vocab_size=c.vocab_size, hidden_size=c.hidden_size,
        intermediate_size=c.intermediate_size,
        moe_intermediate_size=c.moe_intermediate_size,
        num_layers=c.num_hidden_layers,
        num_attention_heads=c.num_attention_heads,
        kv_lora_rank=c.kv_lora_rank, qk_rope_head_dim=c.qk_rope_head_dim,
        qk_nope_head_dim=c.qk_nope_head_dim, v_head_dim=c.v_head_dim,
        n_routed_experts=c.n_routed_experts,
        experts_held=list(c.experts_held if held is None else held),
        num_experts_per_tok=c.num_experts_per_tok,
        n_shared_experts=c.n_shared_experts,
        first_k_dense_replace=c.first_k_dense_replace,
        rms_norm_eps=c.rms_norm_eps, rope_theta=c.rope_theta,
        rope_scaling=dict(
            beta_fast=c.rope_beta_fast, beta_slow=c.rope_beta_slow,
            factor=c.rope_factor, mscale=c.rope_mscale,
            mscale_all_dim=c.rope_mscale_all_dim,
            original_max_position_embeddings=c.rope_original_max_position),
        aux_loss_alpha=c.aux_loss_alpha)


def captions(vocab: int, seed: int = 0, batch: int = B, length: int = L):
    """(ids, mask): right-padded captions of 6 to ``length`` tokens."""
    g = torch.Generator().manual_seed(seed)
    ids = torch.randint(0, vocab, (batch, length), generator=g)
    n = torch.randint(6, length + 1, (batch,), generator=g)
    n[0] = length
    mask = (torch.arange(length)[None] < n[:, None]).to(torch.int32)
    return ids, mask


def towers(seed: int = 7):
    port = TextEncoderDeepseekV2(EMBED, TINY)
    D.init_deepseek_v2(port, torch.Generator().manual_seed(seed))
    ref = R.TextEncoderDeepseekV2(EMBED, ref_cfg(TINY), Quant())
    R.init_deepseek_v2(ref, torch.Generator().manual_seed(seed))
    return port.train(), ref.train()


def test_same_weights_and_names_as_the_reference():
    port, ref = towers()
    mine, theirs = dict(port.named_parameters()), dict(ref.named_parameters())
    assert set(mine) == set(theirs)
    for k, p in mine.items():
        assert torch.equal(p, theirs[k]), k
    assert "model.layers.1.mlp.experts.7.gate_proj.weight" in mine
    assert "model.layers.1.mlp.experts.8.gate_proj.weight" not in mine
    assert mine["model.layers.2.mlp.gate.weight"].shape == (16, 64)


def test_tower_equals_reference():
    port, ref = towers()
    ids, mask = captions(TINY.vocab_size)
    probe = torch.randn(B, EMBED, generator=torch.Generator().manual_seed(1))
    out = port(ids, mask)
    emb, aux = out["embedding"], out["aux_loss"]
    ((emb * probe).sum() + aux).backward()
    r_emb, r_aux = ref(ids, mask)
    ((r_emb * probe).sum() + r_aux).backward()
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


def _moe_pair(held, seed=3):
    """The reference's uncut MoE layer (every expert held) and the port's
    layer holding ``held``, on the same weights."""
    full = R.MoE(ref_cfg(TINY), range(TINY.n_routed_experts))
    R.init_deepseek_v2(full, torch.Generator().manual_seed(seed))
    port = D.MoE(dataclasses.replace(TINY, experts_held=tuple(held)))
    sd = {k: v for k, v in full.state_dict().items()
          if not k.startswith("experts.")
          or int(k.split(".")[1]) in set(held)}
    port.load_state_dict(sd, strict=True)
    return full.train(), port.train()


def test_shares_add_up_to_the_uncut_layer():
    h = torch.randn(B, L, TINY.hidden_size,
                    generator=torch.Generator().manual_seed(5))
    full, low = _moe_pair(range(0, 8))
    _, high = _moe_pair(range(8, 16))
    with torch.no_grad():
        want, _ = full(h)
        a, _ = low(h)
        b, _ = high(h)
        shared = low.shared_experts(h.reshape(-1, TINY.hidden_size))
    got = a + b - shared.view_as(a)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-6)
    # Each share alone is its part of the layer, not the whole.
    assert float((a - want).abs().max()) > 1e-3


def test_a_share_equals_the_reference_share():
    held = range(4, 12)
    cfg = ref_cfg(TINY, held)
    ref = R.MoE(cfg, held)
    R.init_deepseek_v2(ref, torch.Generator().manual_seed(9))
    port = D.MoE(dataclasses.replace(TINY, experts_held=tuple(held)))
    port.load_state_dict(ref.state_dict(), strict=True)
    h = torch.randn(B, L, TINY.hidden_size, requires_grad=True,
                    generator=torch.Generator().manual_seed(2))
    out, aux = port.train()(h)
    (out.square().sum() + aux).backward()
    g_port = h.grad.clone()
    h.grad = None
    r_out, r_aux = ref.train()(h)
    (r_out.square().sum() + r_aux).backward()
    torch.testing.assert_close(out, r_out, rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(g_port, h.grad, rtol=1e-4, atol=1e-6)


def test_yarn_anchors():
    c = D.DeepseekV2Config()
    assert D.yarn_correction_range(c) == (10, 23)
    assert D.softmax_scale(c) == pytest.approx(0.114721, abs=5e-7)
    m = 0.1 * 0.707 * math.log(40) + 1
    assert m == pytest.approx(1.26080, abs=5e-6)
    i = np.arange(32)
    extra = 10000.0 ** (-2 * i / 64)
    ramp = np.clip((i - 10) / 13, 0, 1)
    want = extra / 40 * ramp + extra * (1 - ramp)
    np.testing.assert_allclose(D.yarn_inv_freq(c).numpy(), want, rtol=1e-6)
    ref = R.yarn_inv_freq(ref_cfg(c))
    assert torch.equal(D.yarn_inv_freq(c), ref)


def test_rope_pair_permutation():
    """RoPE rotates the published pairs: with the permutation, element
    pair (2i, 2i+1) of a head turns by position x inv_freq[i]."""
    cos, sin = D.rotary(torch.tensor([0.5, 0.25]), 3,
                        dataclasses.replace(TINY, rope_factor=1.0))
    x = torch.tensor([1.0, 2.0, 3.0, 4.0]).view(1, 1, 1, 4).expand(
        1, 3, 1, 4).contiguous()
    y = D.apply_rope(x, cos, sin)[0, 2, 0]
    # halves after the permutation: [1, 3 | 2, 4]; pair i = (x_i, x_{i+2})
    th = 2 * torch.tensor([0.5, 0.25])
    want = torch.cat([torch.tensor([1.0, 3.0]) * th.cos()
                      - torch.tensor([2.0, 4.0]) * th.sin(),
                      torch.tensor([2.0, 4.0]) * th.cos()
                      + torch.tensor([1.0, 3.0]) * th.sin()])
    torch.testing.assert_close(y, want)


def test_adamp_steps_each_expert_as_its_own_leaf():
    _, port = _moe_pair(range(0, 8))
    ref = copy.deepcopy(port)
    h = torch.randn(B, L, TINY.hidden_size,
                    generator=torch.Generator().manual_seed(4))
    for m in (port, ref):
        out, aux = m(h)
        (out.square().sum() + aux).backward()
    names = [k for k, _ in port.named_parameters()]
    shapes = {k: tuple(p.shape) for k, p in port.named_parameters()}
    assert shapes["experts.3.up_proj.weight"] == (TINY.moe_intermediate_size,
                                                  TINY.hidden_size)
    assert sum(".experts." in k or k.startswith("experts.")
               for k in names) == 8 * 3
    hyper = dict(betas=(0.9, 0.999), eps=1e-8, weight_decay=1e-2,
                 delta=0.1, wd_ratio=0.1)
    opt = AdamP(port.parameters(), lr=1e-2, **hyper)
    opt.step()
    r_opt = RefAdamP(list(ref.parameters()),
                     dict(hyper, betas=list(hyper["betas"])))
    r_opt.lr = 1e-2
    r_opt.step()
    theirs = dict(ref.named_parameters())
    for k, p in port.named_parameters():
        torch.testing.assert_close(p, theirs[k], rtol=1e-6, atol=1e-7,
                                   msg=k)


def test_smoke_round_with_the_tower(tmp_path):
    from creamfl_tpu_torch import main

    args = main.parse_args([
        "--no-cuda", "--synthetic", "--smoke", "--no_mesh",
        "--text_encoder", "deepseek_v2_lite", "--comm_rounds", "1",
        "--local_epochs", "1", "--num_img_clients", "1",
        "--num_txt_clients", "0", "--num_mm_clients", "0",
        "--client_num_per_round", "1", "--seed", "3",
        "--exp_dir", str(tmp_path)])
    algo = main.run(args)
    assert isinstance(algo.server.model.txt_enc, TextEncoderDeepseekV2)
    assert algo.server.moe == (2, 4)
    loss = [line for line in open(tmp_path / "Test.log")
            if "server epoch loss" in line]
    assert loss and math.isfinite(float(loss[-1].split()[-1]))
    assert all(torch.isfinite(p).all()
               for p in algo.server_state.model.parameters())


def test_text_encoder_flag_refuses_what_it_cannot_run():
    from creamfl_tpu_torch import main

    args = main.parse_args(["--no-cuda", "--smoke", "--not_bert",
                            "--text_encoder", "deepseek_v2_lite"])
    with pytest.raises(ValueError, match="not_bert"):
        main.build_configs(args)
    args = main.parse_args(["--no-cuda", "--smoke",
                            "--text_encoder", "deepseek_v2_lite"])
    with pytest.raises(ValueError, match="tokenizer.json"):
        main.build_datasets(args, torch.device("cpu"))


def test_synthetic_lm_ids():
    from creamfl_tpu_torch.data.tokenize import SyntheticLMTokenizer

    tok = SyntheticLMTokenizer(100000, 100001)
    ids, mask = tok.encode("17 4 99", 32)
    assert ids[0] == 100000 and ids[4] == 100001 and ids[-1] == 100001
    assert mask == [1] * 5 + [0] * 27
    assert all(0 <= i < 100000 for i in ids[1:4])
    assert ids == SyntheticLMTokenizer(100000, 100001).encode("17 4 99",
                                                               32)[0]


def test_recorder_counts_the_routing():
    from creamfl_tpu_torch.utils import profiling

    port, _ = towers()
    ids, mask = captions(TINY.vocab_size)
    with profiling.recording() as snap:
        port(ids, mask)
    held = snap.counters["moe.held_pairs"]
    assert 0 < held <= 2 * B * L * TINY.num_experts_per_tok
    for name in ("creamfl.moe.route", "creamfl.moe.experts",
                 "creamfl.moe.combine", "creamfl.mla.attend"):
        assert snap.counts[name] == (3 if name == "creamfl.mla.attend"
                                     else 2), name
    port(ids, mask)  # off: nothing recorded, nothing raised


# -- on the card --------------------------------------------------------------
@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the grouped products in bf16 and "
                    "the graphs run only there")
    return torch.device("cuda")


@pytest.mark.card
def test_no_host_read_in_the_towers_step(cuda):
    cfg = dataclasses.replace(D.DeepseekV2Config(), num_hidden_layers=3)
    tower = TextEncoderDeepseekV2(256, cfg, dtype=torch.bfloat16)
    D.init_deepseek_v2(tower, torch.Generator().manual_seed(0))
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


def _chunk_engine(cuda):
    from creamfl_tpu_torch.config import default_config_path, parse_config
    from creamfl_tpu_torch.engine.server import ServerEngine

    cfg = parse_config(default_config_path("coco.json"), strict_cast=False,
                       model__embed_dim=16, model__cnn_type="resnet10",
                       model__not_bert=False)
    engine = ServerEngine(cfg, vocab_size=50, bert_config=TINY, device=cuda)
    return engine, engine.init_state(seed=11)


@torch.no_grad()
def _reset(state, start):
    """``start`` copied into the state in place, AdamP's moments and steps
    zeroed in place (the addresses a captured graph holds stay)."""
    for prefix, module in (("model.", state.model),
                           ("criterion.", state.criterion)):
        for k, v in module.state_dict().items():
            v.copy_(start[prefix + k])
    for st in state.optimizer.state.values():
        for t in st.values():
            t.zero_()


@pytest.mark.card
@pytest.mark.parametrize("kind", ["extract", "distill"])
def test_chunks_replay_as_eager_steps(cuda, kind):
    engine, state = _chunk_engine(cuda)
    assert engine.chunk_route == "graph"
    k, b = 4, 8
    rng = np.random.default_rng(0)
    images = rng.normal(size=(k, b, 32, 32, 3)).astype(np.float32)
    ids = rng.integers(0, 500, size=(k, b, L)).astype(np.int64)
    n = rng.integers(6, L + 1, size=(k, b))
    mask = (np.arange(L)[None, None] < n[..., None]).astype(np.int32)
    lengths = mask.sum(-1).astype(np.int32)
    agg = {m: torch.randn(64, 16, device=cuda) for m in ("img", "txt")}
    rows = rng.integers(0, 64, size=(k, b))
    start = engine.state_dict_of(state)

    def eager():
        outs = []
        for i in range(k):
            if kind == "extract":
                outs.append(torch.cat(engine.extract_step(
                    state, images[i], ids[i], lengths[i], mask[i]), -1))
            else:
                outs.append(engine.distill_step(
                    state, images[i], ids[i], lengths[i], mask[i], agg,
                    rows[i], True, True, False, 0.3)[1].reshape(1))
        return torch.stack(outs)

    def chunked():
        if kind == "extract":
            return torch.cat(engine.extract_chunk(
                state, images, ids, lengths, mask), -1)
        return engine.distill_chunk(state, images, ids, lengths, mask, agg,
                                    rows, True, True, False, 0.3)[1]

    torch.manual_seed(5)
    want = eager()
    after = engine.state_dict_of(state)
    for _ in range(2):  # the capture, then a replay
        _reset(state, start)
        torch.manual_seed(5)
        got = chunked()
        torch.testing.assert_close(got.reshape(want.shape), want,
                                   rtol=1e-3, atol=1e-4)
        now = engine.state_dict_of(state)
        for key, v in after.items():
            torch.testing.assert_close(now[key], v, rtol=1e-3, atol=1e-4,
                                       msg=key)
    engine.release_graphs()


@pytest.mark.card
def test_adamp_kernel_at_the_towers_leaves(cuda):
    from creamfl_tpu_torch.models.pcme import PCME
    from creamfl_tpu_torch.ops import adamp as A

    model = PCME(embed_dim=256, cnn_type="resnet101", not_bert=False,
                 bert_config=D.DeepseekV2Config())
    shapes = [tuple(p.shape) for p in model.parameters()] + [(1,), (1,)]
    del model
    n = len(shapes)
    assert n > A.capacity(), (n, A.capacity())
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

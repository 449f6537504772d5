"""The cell ``server_train_dsv2lite`` (DeepSeek-V2-Lite as the server's text
tower) at its configuration's smoke sizes on the CPU: the harness runs it
correct; the reference against itself reads 0; the controls (the trunk's
and the tower's products in float8, and the tower's alone) and the two
faults (``no_routed``, ``held_topk``) each break a limit; the
configuration's tower is the port's; the operation count against a hand
sum, and the phase's count from the held pairs; the profiled call's range hooks
leave the step unchanged and open balanced ``bench.moe`` ranges; the three
MoE readers on hand-made records; and neither new reference file imports
the port or JAX."""

import json
import os
import subprocess
import sys
import types

import pytest
import torch

import run
from benchlib import registry

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CELL = "server_train_dsv2lite"
SEED = 2 ** 31 + 19


@pytest.fixture(scope="module")
def cell():
    return registry.Cell(CELL, smoke=True)


def test_the_harness_runs_the_cell(capsys):
    assert run.main(["--workload", CELL, "--seed", str(SEED), "--seconds",
                     "0.01", "--trace", "0"], smoke=True) == 0
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line["correct"] is True, line["checks"]
    assert set(line["checks"]) >= {"expert_grad_median_gap",
                                   "router_grad_median_gap",
                                   "text_embed_gap"}


def test_the_reference_against_itself_reads_zero(cell):
    from reference import server_dsv2

    ctx = run.Ctx(cell, SEED, torch.device("cpu"), smoke=True)
    a = server_dsv2.follow_train(ctx.ref_cfg, SEED, ctx.device)
    b = server_dsv2.follow_train(ctx.ref_cfg, SEED, ctx.device)
    a["steps"] = a["epoch_steps"]
    numbers = cell.phase.compare(a, b)
    for name in cell.limits:
        assert numbers[name] == 0.0, (name, numbers[name])


@pytest.mark.parametrize("kind", ["fp8", "fp8_tower", "no_routed",
                                  "held_topk"])
def test_control_and_faults_break_a_limit(cell, kind):
    ctx = run.Ctx(cell, SEED, torch.device("cpu"), smoke=True)
    numbers = cell.phase.control(ctx, (kind,))[kind]
    broken = {k: (numbers[k], lim) for k, lim in cell.limits.items()
              if not numbers[k] <= lim}
    assert broken, {k: (numbers[k], lim) for k, lim in cell.limits.items()}


def test_the_configuration_is_the_ports_tower(cell):
    import argparse

    from creamfl_tpu_torch import main

    for smoke, text in ((False, cell.config["model"]["text"]),
                        (True, registry.merge(cell.config, cell.config[
                            "smoke"])["model"]["text"])):
        p = argparse.ArgumentParser()
        main.add_args(p)
        args = p.parse_args(list(cell.config["port_flags"])
                            + (["--smoke"] if smoke else []))
        port = main.text_config(args)
        assert text["num_layers"] == port.num_hidden_layers
        assert tuple(text["experts_held"]) == port.experts_held
        for key in ("vocab_size", "hidden_size", "intermediate_size",
                    "moe_intermediate_size", "num_attention_heads",
                    "kv_lora_rank", "qk_rope_head_dim", "qk_nope_head_dim",
                    "v_head_dim", "n_routed_experts", "num_experts_per_tok",
                    "n_shared_experts", "first_k_dense_replace",
                    "rms_norm_eps", "aux_loss_alpha", "bos_token_id",
                    "eos_token_id"):
            assert text[key] == getattr(port, key), key
        rs = text["rope_scaling"]
        assert (rs["factor"], rs["mscale_all_dim"], rs["beta_fast"]) == (
            port.rope_factor, port.rope_mscale_all_dim, port.rope_beta_fast)
    top = cell.config
    assert top["num_hidden_layers"] == 14 and top["n_routed_experts"] == 64
    assert sorted(top["reduced"]) == ["experts_held", "num_hidden_layers",
                                      "num_layers", "pub_rows"]


def test_operations_by_hand():
    flops = registry.load_module("configs", "pcme_r101_dsv2lite_flops")
    text = registry.load_json("configs", "pcme_r101_dsv2lite")["model"][
        "text"]
    d, l = 2048, 32
    attn = 2 * (d * 16 * 192 + d * 576 + 512 * 16 * 256 + 16 * 128 * d) \
        + 2 * l * 16 * 192 + 2 * l * 16 * 128
    dense = 6 * d * 10944
    moe = 2 * d * 64 + 6 * d * 2816
    per_token = 14 * attn + dense + 13 * moe
    assert flops.tower_forward(text, 256) == pytest.approx(
        l * per_token + 2 * d * 256, rel=1e-12)
    assert flops.pair_forward(text) == 6 * d * 1408
    # With the held experts at even routing's 0.75 pair a token and layer.
    even = l * 13 * 0.75 * flops.pair_forward(text)
    assert flops.tower_forward(text, 256) + even == pytest.approx(
        36.68e9, rel=1e-3)


def test_the_phase_counts_the_held_pairs_it_tallied():
    """The cell's count: the configuration's a sample, plus a held
    expert's forward and backward for each pair the program tallied."""
    flops = registry.load_module("configs", "pcme_r101_dsv2lite_flops")
    model = registry.load_json("configs", "pcme_r101_dsv2lite")["model"]
    phase = cell_phase()
    st = types.SimpleNamespace(batch=128, held_pairs=912)
    st.per_sample = flops.per_sample(model)["train"]
    st.pair_flops = 3 * flops.pair_forward(model["text"])
    assert phase.flops(st, 32) == pytest.approx(
        32 * 128 * st.per_sample + 912 * 18 * 2048 * 1408, rel=1e-12)


def test_range_hooks_leave_the_step_unchanged():
    from torch.profiler import ProfilerActivity, profile

    from creamfl_tpu_torch.models import deepseek_v2 as D
    from creamfl_tpu_torch.models.pcme import TextEncoderDeepseekV2

    def step(tower):
        g = torch.Generator().manual_seed(1)
        ids = torch.randint(0, 500, (2, 32), generator=g)
        mask = torch.ones(2, 32, dtype=torch.int32)
        out = tower(ids, mask)
        (out["embedding"].square().sum() + out["aux_loss"]).backward()
        return {k: p.grad.clone() for k, p in tower.named_parameters()}

    tower = TextEncoderDeepseekV2(8, D.DeepseekV2Config.tiny())
    D.init_deepseek_v2(tower, torch.Generator().manual_seed(0))
    want = step(tower.train())
    tower.zero_grad(set_to_none=True)
    handles = cell_phase().range_hooks(tower)
    try:
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            got = step(tower)
    finally:
        for h in handles:
            h.remove()
    for k, g in want.items():
        assert torch.equal(got[k], g), k
    names = [e.name() for e in prof.profiler.kineto_results.events()]
    # forward: one bench.moe a MoE layer (2); backward: one a part (2 x 4)
    assert names.count("bench.moe") == 2 + 2 * 4
    assert names.count("bench.moe.experts") == 2 + 2


def cell_phase():
    return registry.load_module("phases", "server_train_dsv2")


def test_moe_readers_on_made_records():
    share = registry.load_module("metrics", "moe_device_share")
    roof = registry.load_module("metrics", "moe_experts_roofline")
    host = registry.load_module("metrics", "moe_host_share")
    trace = types.SimpleNamespace(
        busy_s=4.0, wall_s=8.0,
        range_s={"bench.moe": 1.0, "bench.moe.experts": 0.5})
    records = {"trace": trace, "expert_shape": (2048, 1408),
               "program": {"counters": {"moe.held_pairs": 1_000_000},
                           "seconds": {"creamfl.moe.route": 0.2,
                                       "creamfl.moe.experts": 0.1,
                                       "creamfl.moe.combine": 0.1,
                                       "creamfl.engine.forward": 3.0}}}
    assert share.read(records) == pytest.approx(25.0)
    want = 1e6 * 3 * 2 * 2048 * 1408 * 3 / 0.5 / 989e12 * 100
    assert roof.read(records) == pytest.approx(want)
    assert host.read(records) == pytest.approx(5.0)
    # A program without the tower: nothing to read, nothing raised.
    bare = {"trace": types.SimpleNamespace(busy_s=4.0, wall_s=8.0,
                                           range_s={})}
    assert share.read(bare) is None and roof.read(bare) is None
    assert host.read(bare) is None


def test_new_reference_files_import_nothing_of_the_port():
    code = ("import sys; sys.path[:0]=[sys.argv[1]]; "
            "import reference.deepseek_v2, reference.server_dsv2; "
            "print(sorted({m.split('.')[0] for m in sys.modules}))")
    out = subprocess.run([sys.executable, "-c", code, BENCH],
                         capture_output=True, text=True, timeout=300,
                         check=True)
    for name in ("creamfl_tpu_torch", "'creamfl_tpu'", "'jax'", "'flax'"):
        assert name not in out.stdout, name

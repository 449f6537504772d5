"""The cell ``server_train_granite4h`` (Granite-4.0-H-Small as the server's
text tower) at its configuration's smoke sizes on the CPU: the harness runs
it correct; the reference against itself reads 0; the controls (the
trunk's and the tower's products in float8, and the tower's alone) and the
two faults (``dt_unbiased``, ``norm_ungated``) each break a limit; the
configuration's tower is the port's, with the published widths and order;
the operation count against a hand sum; the profiled call's range hooks
leave the step unchanged and open ``bench.ssm`` ranges in turn; the two
SSM readers on hand-made records; and neither new reference file imports
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
CELL = "server_train_granite4h"
SEED = 2 ** 31 + 19


@pytest.fixture(scope="module")
def cell():
    return registry.Cell(CELL, smoke=True)


def cell_phase():
    return registry.load_module("phases", "server_train_granite4h")


def test_the_harness_runs_the_cell(capsys):
    assert run.main(["--workload", CELL, "--seed", str(SEED), "--seconds",
                     "0.01", "--trace", "0"], smoke=True) == 0
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line["correct"] is True, line["checks"]
    assert set(line["checks"]) >= {"expert_grad_median_gap",
                                   "router_grad_median_gap",
                                   "ssm_grad_median_gap", "text_embed_gap"}


def test_the_reference_against_itself_reads_zero(cell):
    from reference import server_granite

    ctx = run.Ctx(cell, SEED, torch.device("cpu"), smoke=True)
    a = server_granite.follow_train(ctx.ref_cfg, SEED, ctx.device)
    b = server_granite.follow_train(ctx.ref_cfg, SEED, ctx.device)
    a["steps"] = a["epoch_steps"]
    numbers = cell.phase.compare(a, b)
    for name in cell.limits:
        assert numbers[name] == 0.0, (name, numbers[name])


@pytest.mark.parametrize("kind", ["fp8", "fp8_tower", "dt_unbiased",
                                  "norm_ungated"])
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
        assert tuple(text["layer_types"]) == port.layer_types
        for key in ("vocab_size", "hidden_size", "intermediate_size",
                    "shared_intermediate_size", "num_attention_heads",
                    "num_key_value_heads", "attention_multiplier",
                    "embedding_multiplier", "residual_multiplier",
                    "mamba_n_heads", "mamba_d_head", "mamba_d_state",
                    "mamba_n_groups", "mamba_d_conv", "mamba_expand",
                    "mamba_chunk_size", "mamba_conv_bias",
                    "num_local_experts", "num_experts_per_tok",
                    "rms_norm_eps", "router_aux_loss_coef",
                    "initializer_range", "bos_token_id", "eos_token_id"):
            assert text[key] == getattr(port, key), key
    top = cell.config
    assert top["num_hidden_layers"] == 10 and top["num_local_experts"] == 9
    assert len(top["layer_types"]) == 40
    assert sorted(top["reduced"]) == ["num_hidden_layers",
                                      "num_local_experts", "pub_rows"]
    from creamfl_tpu_torch.models.granite_h import GraniteHConfig

    assert GraniteHConfig().kinds == ("mamba",) * 5 + ("attention",) + (
        "mamba",) * 4


def test_operations_by_hand():
    flops = registry.load_module("configs", "pcme_r101_granite4hsmall_flops")
    text = registry.load_json("configs", "pcme_r101_granite4hsmall")[
        "model"]["text"]
    d, l = 4096, 32
    mamba = (2 * d * (8192 + 8448 + 128) + 2 * 4 * 8448
             + 2 * 32 * 128 + 2 * 32 * 8192 + 2 * 8192 * d)
    attn = 2 * d * d * 2 + 2 * 2 * d * 1024 + 2 * 2 * l * 32 * 128
    moe = 2 * d * 72 + 3 * 2 * d * 1536
    per_token = 9 * mamba + attn + 10 * moe
    assert flops.tower_forward(text, 256) == pytest.approx(
        l * per_token + 2 * d * 256, rel=1e-12)
    assert flops.pair_forward(text) == 6 * d * 768
    # More than one chunk adds each token's state products.
    long = dict(text, max_len=512)
    assert flops.mamba_token(long) == pytest.approx(
        2 * d * (8192 + 8448 + 128) + 2 * 4 * 8448 + 2 * 256 * 128
        + 2 * 256 * 8192 + 2 * 2 * 8192 * 128 + 2 * 8192 * d, rel=1e-12)


def test_range_hooks_leave_the_step_unchanged():
    from torch.profiler import ProfilerActivity, profile

    from creamfl_tpu_torch.models import granite_h as G
    from creamfl_tpu_torch.models.pcme import TextEncoderLM

    def step(tower):
        g = torch.Generator().manual_seed(1)
        ids = torch.randint(0, 500, (2, 32), generator=g)
        mask = torch.ones(2, 32, dtype=torch.int32)
        out = tower(ids, mask)
        (out["embedding"].square().sum() + out["aux_loss"]).backward()
        return {k: p.grad.clone() for k, p in tower.named_parameters()}

    tower = TextEncoderLM(8, G.GraniteHConfig.tiny())
    G.init_granite_h(tower, torch.Generator().manual_seed(0))
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
    # forward: one a mixer (2); backward: the mixer's 5 parts and the 6
    # stretches around them, each its own range (2 x 11)
    assert names.count("bench.ssm") == 2 + 2 * 11


def test_ssm_readers_on_made_records():
    share = registry.load_module("metrics", "ssm_device_share")
    host = registry.load_module("metrics", "ssm_host_share")
    trace = types.SimpleNamespace(busy_s=4.0, wall_s=8.0,
                                  range_s={"bench.ssm": 2.0})
    records = {"trace": trace,
               "program": {"counters": {"mamba.tokens": 1_000_000},
                           "seconds": {"creamfl.mamba.proj": 0.2,
                                       "creamfl.mamba.conv": 0.1,
                                       "creamfl.mamba.scan": 0.3,
                                       "creamfl.mamba.norm": 0.2,
                                       "creamfl.moe.route": 3.0}}}
    assert share.read(records) == pytest.approx(50.0)
    assert host.read(records) == pytest.approx(10.0)
    # A program without the tower: nothing to read, nothing raised.
    bare = {"trace": types.SimpleNamespace(busy_s=4.0, wall_s=8.0,
                                           range_s={}),
            "program": {"counters": {}, "seconds": {}}}
    assert share.read(bare) is None and host.read(bare) is None


def test_new_reference_files_import_nothing_of_the_port():
    code = ("import sys; sys.path[:0]=[sys.argv[1]]; "
            "import reference.granite_h, reference.server_granite; "
            "print(sorted({m.split('.')[0] for m in sys.modules}))")
    out = subprocess.run([sys.executable, "-c", code, BENCH],
                         capture_output=True, text=True, timeout=300,
                         check=True)
    for name in ("creamfl_tpu_torch", "'creamfl_tpu'", "'jax'", "'flax'"):
        assert name not in out.stdout, name

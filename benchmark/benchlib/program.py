"""The system under test: a CreamFL round (``federation.rounds.MMFL``) built
through the port's own constructors, as ``creamfl_tpu_torch.main.run``
builds it: ``add_args`` with the configuration's and the cell's flags,
``build_configs``, ``build_datasets`` and ``MMFL``. A phase then calls the
round's own phase methods on it."""

from __future__ import annotations

import argparse
import sys
from typing import Dict, List, Sequence

import torch


class QuietLogger:
    """The round's logger, on standard error (standard output carries the
    result line alone). It keeps the lines the round reported (a phase
    reads its results there, such as the server epoch's loss)."""

    def __init__(self):
        self.lines: List[str] = []

    def log(self, msg: str, level: int = 20) -> None:
        self.lines.append(msg)
        print(msg, file=sys.stderr)

    def report(self, step: int, metrics: Dict, prefix: str = "") -> None:
        self.log(f"step {step} | " + " ".join(
            f"{prefix}{k}={v}" for k, v in sorted(metrics.items())))

    def log_dict(self, d: Dict, prefix: str = "") -> None:
        for k, v in sorted(d.items()):
            self.log(f"{prefix}{k}: {v}")


def port_argv(config: Dict, cell: Dict, seed: int, smoke: bool) -> List[str]:
    argv = list(config["port_flags"]) + list(cell.get("port_flags", ()))
    argv += ["--seed", str(seed), "--no_mesh"]
    if smoke:
        argv += ["--smoke", "--no-cuda"]
    return argv


def build_round(argv: Sequence[str], device):
    """(args, MMFL) for the port's command line ``argv``."""
    from creamfl_tpu_torch import main as port
    from creamfl_tpu_torch.federation.rounds import MMFL
    from creamfl_tpu_torch.utils.helper import set_seed

    parser = argparse.ArgumentParser()
    port.add_args(parser)
    args = parser.parse_args(list(argv))
    set_seed(args.seed)
    server_cfg, mm_cfg, bert_cfg = port.build_configs(args)
    datasets = port.build_datasets(args, device)
    algo = MMFL(args, datasets, server_cfg, mm_cfg, logger=QuietLogger(),
                bert_config=bert_cfg, device=device, mesh=None)
    return args, algo


def leaves(state) -> Dict[str, torch.Tensor]:
    """An engine state's parameters by the names the reference gives them:
    ``model.<name>`` and ``criterion.<name>``."""
    out = {f"model.{k}": p for k, p in state.model.named_parameters()}
    out.update({f"criterion.{k}": p
                for k, p in state.criterion.named_parameters()})
    return out


def norms(tensors: Dict[str, torch.Tensor]) -> Dict[str, float]:
    return {k: float(torch.linalg.vector_norm(t.detach().double()))
            for k, t in tensors.items()}


def first_grads(state) -> Dict[str, float]:
    """Each leaf's gradient as AdamP took it at its first step, by norm:
    its first moment over 1 - beta1. A leaf the optimizer kept no moment
    for took nothing (0)."""
    b1 = state.optimizer.param_groups[0]["betas"][0]
    opt = state.optimizer.state
    return {k: float(torch.linalg.vector_norm(opt[p]["exp_avg"].double()))
            / (1 - b1) if "exp_avg" in opt.get(p, {}) else 0.0
            for k, p in leaves(state).items()}


def optimizer_steps(state) -> int:
    """The most steps the optimizer has taken on any leaf (its own
    per-leaf step counts)."""
    steps = [torch.as_tensor(st["step"], dtype=torch.float64)
             for st in state.optimizer.state.values() if "step" in st]
    if not steps:
        return 0
    dev = steps[0].device
    return int(torch.stack([s.to(dev) for s in steps]).max())


def running_stats(state) -> Dict[str, torch.Tensor]:
    """Every BatchNorm's running mean and variance, by the reference's
    names (``model.<buffer>``), in float64 on the host."""
    return {f"model.{k}": b.detach().double().cpu()
            for k, b in state.model.named_buffers()
            if k.endswith(("running_mean", "running_var"))}

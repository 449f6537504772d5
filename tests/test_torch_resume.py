"""Kill-and-resume trajectory of the port's rounds, bit for bit on the CPU.

The port's counterpart of ``tests/test_resume_trajectory.py``: two
straight rounds must equal one round, then a fresh ``MMFL`` that
``resume``s from its round checkpoint, then one round: scores, sampled
clients, and the server's and every client's state (parameters, BN stats,
optimizer moments, steps). Every per-round random source is a function of
(seed, round) (``MMFL._seed_round``), and a checkpoint holds each
``EngineState`` whole, so the two agree exactly. Stacked client branch,
fewer slots than clients (sampling must be resume-stable), at
``test_torch_round.py``'s sizes with weights drawn from the seed.

Then the CLI: ``--ckpt_dir`` and ``--save_client`` on a first run, and
``--resume`` on a second that continues at round 2.
"""

import os
import subprocess
import sys

import pytest
import torch

from creamfl_tpu_torch.data.pipelines import build_synthetic_datasets
from creamfl_tpu_torch.federation.rounds import MMFL
from creamfl_tpu_torch.main import build_configs
from test_torch_round import REPO, SIZES, _args, _configs, _Log
from torch_cpu_share import torch_cpu_share  # noqa: F401


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One torch thread for this module's tiny rounds: the suite runs in
    parallel workers, and each worker's default of one thread per core
    oversubscribes the host."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _build(tmp, ckpt_dir):
    args = _args(tmp, comm_rounds=2, seed=11, num_img_clients=2,
                 num_txt_clients=1, num_mm_clients=1, client_num_per_round=3,
                 client_parallel=True, ckpt_dir=str(ckpt_dir))
    server, mm, bert = _configs(build_configs, args)
    return MMFL(args, build_synthetic_datasets(args, **SIZES), server, mm,
                bert_config=bert, logger=_Log(), device="cpu")


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("resume")
    straight = _build(tmp / "a", tmp / "a_ckpt")
    straight_scores, straight_sampled = [], []
    for r in range(2):
        straight_scores.append(straight.train(r))
        straight_sampled.append(list(straight.sampled))

    first = _build(tmp / "b", tmp / "b_ckpt")
    first.train(0)
    first_sampled = list(first.sampled)
    del first
    resumed = _build(tmp / "b2", tmp / "b_ckpt")
    next_round = resumed.resume()
    resumed_scores = resumed.train(next_round)
    return dict(straight=straight, straight_scores=straight_scores,
                straight_sampled=straight_sampled, resumed=resumed,
                resumed_scores=resumed_scores, next_round=next_round,
                first_sampled=first_sampled, tmp=tmp)


def _equal(a, b, name):
    """Nested state dicts (tensors, numbers, lists) equal bit for bit."""
    if isinstance(a, torch.Tensor):
        assert isinstance(b, torch.Tensor) and torch.equal(a, b), name
    elif isinstance(a, dict):
        assert a.keys() == b.keys(), name
        for k in a:
            _equal(a[k], b[k], f"{name}.{k}")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), name
        for i, (x, y) in enumerate(zip(a, b)):
            _equal(x, y, f"{name}[{i}]")
    else:
        assert a == b, (name, a, b)


def test_resume_continues_at_next_round(runs):
    assert runs["next_round"] == 1
    assert runs["first_sampled"] == runs["straight_sampled"][0]
    assert runs["resumed"].sampled == runs["straight_sampled"][1]
    assert len(runs["resumed"].sampled) == 3 < len(runs["resumed"].clients)
    ck = runs["resumed"].checkpointer
    assert ck.list_rounds() == [0, 1] and ck.latest_round() == 1


def test_resumed_scores_equal_straight(runs):
    assert runs["resumed_scores"] == runs["straight_scores"][1]
    assert runs["resumed"].best_score == runs["straight"].best_score > 0


def test_resumed_states_equal_straight(runs):
    straight, resumed = runs["straight"], runs["resumed"]
    _equal(resumed.server_state.state_dict(),
           straight.server_state.state_dict(), "server")
    for a, b in zip(straight.clients, resumed.clients):
        assert a.client_idx == b.client_idx
        _equal(b.state.state_dict(), a.state.state_dict(),
               f"client {a.client_idx}")


def test_cli_ckpt_dir_then_resume(tmp_path):
    """The CLI on the stacked branch (its default) writes a round
    checkpoint and the client snapshots; a second run with --resume
    continues at round 2."""
    cmd = [sys.executable, "-m", "creamfl_tpu_torch.main", "--no-cuda",
           "--synthetic", "--smoke", "--local_epochs", "1",
           "--num_img_clients", "2", "--num_txt_clients", "1",
           "--num_mm_clients", "1", "--client_num_per_round", "4",
           "--img_model_local", "resnet10", "--not_bert",
           "--agg_method", "con_w", "--contrast_local_inter",
           "--contrast_local_intra", "--seed", "0", "--exp_dir",
           str(tmp_path), "--name", "ck", "--ckpt_dir",
           str(tmp_path / "rounds")]
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")

    def run(*extra):
        out = subprocess.run(cmd + list(extra), cwd=REPO, env=env,
                             capture_output=True, text=True, timeout=600)
        assert out.returncode == 0, out.stderr[-3000:]
        return out.stdout

    first = run("--comm_rounds", "1", "--save_client")
    assert "Training img clients [1, 2] (stacked x2)" in first
    assert os.listdir(tmp_path / "rounds") == ["round_00000"]
    for kind, ids in (("img", (0, 1)), ("txt", (0,)), ("mm", (0,))):
        for i in ids:
            assert os.path.isfile(tmp_path / "saved_clients" / kind
                                  / f"Client{i}-model_1.ckpt")
    second = run("--comm_rounds", "2", "--resume")
    assert "resumed from round 0" in second
    assert "Round 2!" in second and "Round 1!" not in second
    assert "step 2 | i2t_r1=" in second
    assert sorted(os.listdir(tmp_path / "rounds")) == ["round_00000",
                                                       "round_00001"]

"""The port's round checkpoints (``utils/checkpoint.py``) against the JAX
package's ``RoundCheckpointer``: the cases of ``tests/test_checkpoint.py``
(round trip, keep-last-k retention, an empty directory), then an
``EngineState`` with optimizer moments through a checkpoint, bit for bit.
"""

import os

import numpy as np
import pytest
import torch

from creamfl_tpu.utils.checkpoint import RoundCheckpointer as JRoundCheckpointer
from creamfl_tpu_torch.engine.state import EngineState
from creamfl_tpu_torch.utils.checkpoint import RoundCheckpointer
from creamfl_tpu_torch.utils.serialize import flatten_dict, to_host
from torch_cpu_share import torch_cpu_share  # noqa: F401


def _state(v):
    return {"model": {"w": torch.full((3,), float(v))}, "step": v}


def test_save_restore_roundtrip(tmp_path):
    ck = RoundCheckpointer(str(tmp_path), keep=5)
    payload = {"server": _state(1), "clients": [_state(2), _state(3)],
               "meta": {"best_score": 12.5, "round": 4}}
    ck.save(4, payload)
    restored = ck.restore()
    assert restored["meta"]["round"] == 4
    np.testing.assert_allclose(restored["server"]["model"]["w"], 1.0)
    np.testing.assert_allclose(restored["clients"][1]["model"]["w"], 3.0)
    assert float(restored["meta"]["best_score"]) == 12.5
    assert os.listdir(tmp_path) == ["round_00004"]


@pytest.mark.parametrize("keep", [2, 3])
def test_latest_and_retention(tmp_path, keep):
    """Keep-last-k as the JAX package's checkpointer keeps them (same
    directory names), and restore takes the latest."""
    ck = RoundCheckpointer(str(tmp_path / "port"), keep=keep)
    jck = JRoundCheckpointer(str(tmp_path / "jax"), keep=keep,
                             use_orbax=False)
    for r in range(5):
        ck.save(r, {"server": _state(r), "clients": [],
                    "meta": {"round": r}})
        jck.save(r, {"server": {"w": np.full((3,), float(r))},
                     "clients": [], "meta": {"round": r}})
    assert ck.latest_round() == jck.latest_round() == 4
    assert ck.list_rounds() == jck.list_rounds() == list(range(5 - keep, 5))
    assert (sorted(os.listdir(tmp_path / "port"))
            == sorted(os.listdir(tmp_path / "jax")))
    restored = ck.restore()
    assert restored["meta"]["round"] == 4
    assert float(restored["server"]["model"]["w"][0]) == 4.0


def test_restore_empty_dir(tmp_path):
    ck = RoundCheckpointer(str(tmp_path))
    assert ck.restore() is None
    assert JRoundCheckpointer(str(tmp_path), use_orbax=False).restore() is None


def test_engine_state_through_a_checkpoint(tmp_path):
    """A model with BN stats and an SGD with momentum after two steps: a
    fresh state loaded from the checkpoint equals it bit for bit, and the
    next step of both is the same."""
    def fresh(seed):
        gen = torch.Generator().manual_seed(seed)
        model = torch.nn.Sequential(torch.nn.Linear(4, 3),
                                    torch.nn.BatchNorm1d(3))
        with torch.no_grad():
            for p in model.parameters():
                p.copy_(torch.randn(p.shape, generator=gen))
        opt = torch.optim.SGD(model.parameters(), lr=0.1, momentum=0.9)
        return EngineState(model=model, optimizer=opt)

    def step(state, x):
        state.optimizer.zero_grad()
        state.model(x).square().sum().backward()
        state.optimizer.step()
        state.step += 1

    x = torch.randn(8, 4, generator=torch.Generator().manual_seed(0))
    a = fresh(1)
    step(a, x)
    step(a, x)
    ck = RoundCheckpointer(str(tmp_path))
    ck.save(0, {"server": a.state_dict(), "clients": [], "meta": {}})
    b = fresh(2)
    b.load_state_dict(ck.restore()["server"])
    assert b.step == 2
    for key, val in a.model.state_dict().items():
        assert torch.equal(b.model.state_dict()[key], val), key
    step(a, x)
    step(b, x)
    for pa, pb in zip(a.model.parameters(), b.model.parameters()):
        assert torch.equal(pa, pb)


def test_serialize_helpers_match_jax():
    from creamfl_tpu.utils.serialize import flatten_dict as jflatten

    nested = {"i2t": {"recall_1": 1.0, "n": {"x": 2}}, "rsum": 3.0}
    assert flatten_dict(nested) == jflatten(nested)
    assert flatten_dict(nested, sep="/") == jflatten(nested, sep="/")
    t = torch.ones(2, requires_grad=True) * 2
    host = to_host({"a": [t, (t, 1)], "b": "s"})
    assert not host["a"][0].requires_grad and isinstance(host["a"][1], tuple)
    assert host["b"] == "s" and host["a"][1][1] == 1

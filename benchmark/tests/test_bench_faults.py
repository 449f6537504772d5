"""Each cell's check catches the faults its cell can have: the harness
runs on the CPU at the test sizes (without its look for a card), with the
port's timed path broken underneath, and ``correct`` comes out false:

- a train step that leaves the state unchanged;
- half of each batch left out (the loss then over the rest);
- a step of the epoch left out.
"""

import json

import pytest

import run

ARGS = ["--seed", "77", "--seconds", "0.01", "--trace", "0"]


def _correct(cell, capsys):
    assert run.main(["--workload", cell] + ARGS, smoke=True) == 0
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    return line["correct"], line["checks"]


def _unchanged(monkeypatch):
    from creamfl_tpu_torch.optim import adamp

    monkeypatch.setattr(adamp.AdamP, "step", lambda self, closure=None: None)


def _half_batch(monkeypatch):
    from creamfl_tpu_torch.engine.server import ServerEngine

    stage = ServerEngine.stage

    def half(self, images, captions, lengths, bert_mask=None):
        imgs, caps, lens, mask = stage(self, images, captions, lengths,
                                       bert_mask)
        k = imgs.shape[0] // 2
        return (imgs[:k], caps[:k], lens[:k],
                None if mask is None else mask[:k])

    monkeypatch.setattr(ServerEngine, "stage", half)


def _steps_dropped(monkeypatch):
    from creamfl_tpu_torch.federation.rounds import MMFL

    epoch = MMFL._server_train_epoch

    def short(self):
        loader = self.datasets["pub_train"]
        self.datasets["pub_train"] = list(loader)[:-1]
        try:
            epoch(self)
        finally:
            self.datasets["pub_train"] = loader

    monkeypatch.setattr(MMFL, "_server_train_epoch", short)


@pytest.mark.parametrize("cell,fault", [
    ("server_train", _unchanged), ("server_train", _half_batch),
    ("server_train", _steps_dropped)])
def test_fault_is_not_correct(cell, fault, monkeypatch, capsys):
    fault(monkeypatch)
    correct, checks = _correct(cell, capsys)
    assert correct is False, checks

"""The reference against the port at the test sizes (``--smoke``: ResNet-10,
a tiny BERT, 64² images, on the CPU). The reference never imports the
port; this test imports both.

With the port's bf16 autocast switched off, the port's train epoch equals
the reference's to float32 rounding (the reported loss to its two
decimals): the weights, the images, the ids, the loader order, the dropout
masks and the optimizer are worked out alike."""

import contextlib
import json

import pytest
import torch

import run

ARGS = ["--seed", str(2 ** 31 + 11), "--seconds", "0.01", "--trace", "0"]


def _line(capsys):
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


@pytest.fixture
def fp32_port(monkeypatch):
    import creamfl_tpu_torch.models.pcme as pcme

    monkeypatch.setattr(pcme, "compute_dtype",
                        lambda dtype, device: contextlib.nullcontext())


@pytest.mark.parametrize("trunk,stages,block", [
    ("resnet10", [1, 1, 1, 1], "basic"),
    ("resnet50", [3, 4, 6, 3], "bottleneck")])
def test_same_weights_from_the_seed(trunk, stages, block):
    from creamfl_tpu_torch.models.bert import BertConfig
    from creamfl_tpu_torch.models.pcme import PCME as PortPCME
    from creamfl_tpu_torch.models.pcme import init_pcme as port_init
    from reference.models import PCME, init_pcme

    seed = 123 * 1_000_003
    port = PortPCME(embed_dim=32, cnn_type=trunk, vocab_size=50,
                    not_bert=False, bert_config=BertConfig.tiny())
    port_init(port, torch.Generator().manual_seed(seed))
    t = BertConfig.tiny()
    ref = PCME({"embed_dim": 32,
                "image": {"block": block, "stage_sizes": stages},
                "text": {"vocab_size": t.vocab_size,
                         "hidden_size": t.hidden_size,
                         "num_layers": t.num_layers, "num_heads": t.num_heads,
                         "intermediate_size": t.intermediate_size,
                         "max_position": t.max_position,
                         "type_vocab_size": t.type_vocab_size,
                         "layer_norm_eps": t.layer_norm_eps,
                         "dropout_rate": t.dropout_rate}})
    init_pcme(ref, seed)
    mine = dict(ref.named_parameters())
    theirs = dict(port.named_parameters())
    assert set(mine) == set(theirs)
    for k, p in theirs.items():
        assert torch.equal(mine[k], p), k


# float32 rounding apart, except where Adam's first steps are read: they
# move a weight whose gradient is nearly zero by about the learning rate,
# in a direction a last-bit difference can flip (the worst leaf's change
# read 1.4e-6 to 2.2e-4 here from one run of the tests to the next).
@pytest.mark.parametrize("cell,limit", [("server_train", {"change_gap": 1e-3})])
def test_fp32_port_equals_reference(cell, limit, fp32_port, capsys):
    assert run.main(["--workload", cell] + ARGS, smoke=True) == 0
    line = _line(capsys)
    for name, c in line["checks"].items():
        assert c["value"] <= limit.get(name, 1e-5), (name, c)


@pytest.mark.parametrize("cell", ["server_train"])
def test_bf16_port_is_correct(cell, capsys):
    assert run.main(["--workload", cell] + ARGS, smoke=True) == 0
    assert _line(capsys)["correct"] is True

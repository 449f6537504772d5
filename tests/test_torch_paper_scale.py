"""The ``--paper_scale`` data path and round: the port against the JAX
package.

* The bundle with every paper-scale knob (``cache``, ``prefetch=2``, a
  small ``client_image_size``, ``mm_client_data_size``, ``device_images``)
  at tiny sizes: every loader's caption fields (``captions``, ``lengths``,
  ``index``, ``valid``, ``image_ids``, ``ann_ids``, BERT ids and masks)
  equal the JAX package's bit for bit, batch by batch, over a plain epoch
  and two rounds' orders; images have the same shapes (device-synthesized
  ones differ by stream: ``test_torch_device_synth.py`` holds them to
  their distribution); the host-rendered client images are bit-equal.
* The CLI's ``--paper_scale`` passes ``build_synthetic_datasets`` the JAX
  CLI's scale dict (``creamfl_tpu/main.py:209-225``), plus the run's
  device; without a card and without ``--no-cuda`` it raises.
* One ``MMFL.train(0)`` at ``test_torch_round.py``'s sizes with the
  paper-scale knobs, the port against the JAX sequential round from the
  same weights. Here only, the port's synth returns the JAX package's
  device images for the same ids, so both rounds see the same pixels.
  Tolerances are ``test_torch_round.py``'s: sampled clients and the
  distill index exact; global features, uploads, con_w aggregates and eval
  features within 2e-3 (rtol and atol of the largest entry) or twice the
  port's own spread (the round rerun from start weights perturbed by 1e-7,
  relative); the server's update within 0.1 (relative Frobenius); R@k
  within one rank step.
"""

import argparse
import types

import numpy as np
import pytest
import torch

from creamfl_tpu import main as j_main
from creamfl_tpu.data import pipelines as j_pipelines
from creamfl_tpu.data import tokenize as j_tokenize
from creamfl_tpu.data.device_synth import DeviceImageSynth as JSynth
from creamfl_tpu.federation.rounds import MMFL as JMMFL
from creamfl_tpu.main import build_configs as j_build_configs
from creamfl_tpu_torch import main
from creamfl_tpu_torch.data import pipelines, tokenize
from creamfl_tpu_torch.data.device_synth import DeviceImageBatches
from creamfl_tpu_torch.federation.rounds import MMFL
from creamfl_tpu_torch.main import build_configs
from creamfl_tpu_torch.models.convert import flax_server_state_to_torch
from test_torch_round import (SIZES, UPDATE_DIST, _after,
                              _args, _client_state_dicts, _configs, _host,
                              _Log, _np, _perturbed, _record)
from torch_cpu_share import torch_cpu_share  # noqa: F401

KNOBS = dict(cache=True, prefetch=2, client_image_size=16,
             mm_client_data_size=12, device_images=True)
BUNDLE = dict(pub_size=20, image_size=16, max_len=10, client_data_size=12,
              test_size=10, retrieval_test_size=14, batch_size=8,
              pub_batch_size=8, pub_eval_batch_size=12, **KNOBS)
CAPTION_SETS = ("pub_train", "pub_eval", "test", "mm_clients[0]",
                "mm_clients[1]")


def _bundle_args():
    return types.SimpleNamespace(seed=5, batch_size=8, alpha=0.5,
                                 num_img_clients=2, num_txt_clients=2,
                                 num_mm_clients=2)


def _loaders(ds):
    out = {}
    for key, val in ds.items():
        items = enumerate(val) if isinstance(val, list) else [(None, val)]
        for i, v in items:
            if hasattr(v, "__iter__") and hasattr(v, "__len__") and (
                    hasattr(v, "set_round")):
                out[key if i is None else f"{key}[{i}]"] = v
    return out


def _assert_batches_equal(jl, tl, tag, device_images):
    jb, tb = list(jl), list(tl)
    assert len(jb) == len(tb) == len(tl), tag
    for i, (j, t) in enumerate(zip(jb, tb)):
        assert sorted(j) == sorted(t), f"{tag} batch {i} fields"
        for k in j:
            a = np.asarray(j[k])
            b = t[k].numpy() if isinstance(t[k], torch.Tensor) else \
                np.asarray(t[k])
            assert a.dtype == b.dtype and a.shape == b.shape, (tag, i, k)
            if k == "images" and device_images:
                assert isinstance(t[k], torch.Tensor), (tag, i)
                continue
            np.testing.assert_array_equal(b, a, err_msg=f"{tag} {i} {k}")


@pytest.mark.parametrize("bert", [False, True], ids=["gru", "bert"])
def test_paper_scale_bundle_caption_fields_bit_equal(bert):
    args = _bundle_args()
    jtok = j_tokenize.BertWordPieceTokenizer.synthetic() if bert else None
    ttok = tokenize.BertWordPieceTokenizer.synthetic() if bert else None
    jds = j_pipelines.build_synthetic_datasets(args, bert_tokenizer=jtok,
                                               **BUNDLE)
    tds = pipelines.build_synthetic_datasets(args, bert_tokenizer=ttok,
                                             device="cpu", **BUNDLE)
    scalars = {k: v for k, v in jds.items()
               if isinstance(v, (bool, int, float))}
    assert scalars == {k: tds[k] for k in scalars}
    jl, tl = _loaders(jds), _loaders(tds)
    assert sorted(jl) == sorted(tl) and len(tl) == 11
    for name in CAPTION_SETS:
        assert isinstance(tl[name], DeviceImageBatches), name
        assert tl[name].synth.device.type == "cpu"
    for name in sorted(jl):
        images = name in CAPTION_SETS
        _assert_batches_equal(jl[name], tl[name], f"{name} plain", images)
        for round_n, epochs in ((0, 2), (3, 1)):
            jl[name].set_round(round_n)
            tl[name].set_round(round_n)
            for e in range(epochs):
                _assert_batches_equal(jl[name], tl[name],
                                      f"{name} round {round_n} epoch {e}",
                                      images)
    # The image clients train at their own resolution, host-rendered.
    assert next(iter(tl["img_clients[0]"]))["images"].shape[1:] == (16, 16, 3)


def _capture(monkeypatch, module):
    seen = {}

    def fake(args, **kw):
        seen.update(kw)
        return {}

    monkeypatch.setattr(module, "build_synthetic_datasets", fake)
    return seen


def test_cli_paper_scale_passes_the_jax_scale(monkeypatch):
    argv = ["--synthetic", "--paper_scale", "--pub_data_num", "4096",
            "--no-cuda"]
    jseen = _capture(monkeypatch, j_pipelines)
    j_main.build_datasets(_jax_cli_args(argv))
    tseen = _capture(monkeypatch, pipelines)
    main.build_datasets(main.parse_args(argv))
    jtok, ttok = jseen.pop("bert_tokenizer"), tseen.pop("bert_tokenizer")
    assert type(jtok).__name__ == type(ttok).__name__
    assert tseen.pop("device") == torch.device("cpu")
    assert tseen == jseen
    assert tseen["pub_size"] == 4096 and tseen["device_images"]
    # --smoke wins over --paper_scale, as in the JAX CLI.
    tseen.clear()
    main.build_datasets(main.parse_args(argv + ["--smoke"]))
    assert "device_images" not in tseen
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            main.build_datasets(main.parse_args(argv[:-1]))


def _jax_cli_args(argv):
    parser = argparse.ArgumentParser()
    j_main.add_args(parser)
    return parser.parse_args(argv)


# ---------------------------------------------------------------------------
# One round with the paper-scale knobs, port vs JAX
# ---------------------------------------------------------------------------

ROUND_SIZES = dict(SIZES, **KNOBS)


class _JaxImages:
    """Stands in for the port's ``DeviceImageSynth``: the JAX package's
    device images for the same ids, as torch tensors on the CPU."""

    def __init__(self, image_size, seed=0, n_concepts=10, signal=0.8,
                 device="cuda"):
        self.device = torch.device(device)
        self.synth = JSynth(image_size, seed=seed, n_concepts=n_concepts,
                            signal=signal)

    def __call__(self, image_ids, concepts):
        return torch.from_numpy(np.array(self.synth(image_ids, concepts)))


def _port_round(tmp, server_sd, client_sds):
    args = _args(tmp)
    server, mm, bert = _configs(build_configs, args)
    algo = MMFL(args, pipelines.build_synthetic_datasets(
        args, device="cpu", **ROUND_SIZES), server, mm, bert_config=bert,
        logger=_Log(), device="cpu")
    algo.load_state_dicts(server=server_sd, clients=client_sds)
    evals = []
    _record(algo.evaluator, "extract_features", evals)
    return algo, evals, algo.train(0)


@pytest.fixture(scope="module")
def rounds(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("paper_round")
    jargs = _args(tmp / "jax")
    jserver, jmm, jbert = _configs(j_build_configs, jargs)
    jalgo = JMMFL(jargs, j_pipelines.build_synthetic_datasets(
        jargs, **ROUND_SIZES), jserver, jmm, bert_config=jbert,
        logger=_Log())
    server_sd = flax_server_state_to_torch(_np(jalgo.server_state.params),
                                           _np(jalgo.server_state.batch_stats))
    client_sds = _client_state_dicts(jalgo)
    j_distill, j_eval = [], []
    _record(jalgo, "_distill", j_distill)
    _record(jalgo.evaluator, "extract_features", j_eval)
    jscores = jalgo.train(0)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(pipelines, "DeviceImageSynth", _JaxImages)
        talgo, t_eval, tscores = _port_round(tmp / "port", server_sd,
                                             client_sds)
        gen = torch.Generator().manual_seed(1)
        palgo, p_eval, _ = _port_round(
            tmp / "perturbed", _perturbed(server_sd, gen),
            [_perturbed(sd, gen) for sd in client_sds])
    return dict(jalgo=jalgo, talgo=talgo, palgo=palgo, jscores=jscores,
                tscores=tscores, server_sd=server_sd, j_distill=j_distill,
                j_eval=j_eval, t_eval=t_eval, p_eval=p_eval)


def test_paper_round_uses_the_paper_knobs(rounds):
    ds = rounds["talgo"].datasets
    for key in ("pub_train", "pub_eval", "test"):
        assert isinstance(ds[key], DeviceImageBatches), key
        assert isinstance(ds[key].synth, _JaxImages), key
    assert len(ds["mm_clients"][0].base) == 2  # 12 captions at batch 8
    assert next(iter(ds["img_clients"][0]))["images"].shape[1:] == (
        16, 16, 3)
    np.testing.assert_array_equal(rounds["talgo"].distill_index,
                                  rounds["jalgo"].distill_index)
    assert rounds["talgo"].sampled == [1, 2, 3]


def test_paper_round_features_uploads_and_con_w_match(rounds):
    j, t, p = rounds["jalgo"], rounds["talgo"], rounds["palgo"]
    _after(t.global_img_feature, j.global_img_feature, "global img",
           p.global_img_feature)
    _after(t.global_txt_feature, j.global_txt_feature, "global txt",
           p.global_txt_feature)
    img_vecs, txt_vecs = rounds["j_distill"][0][0]
    assert t.img_reps.shape == (len(img_vecs), 16, 16)
    assert t.txt_reps.shape == (len(txt_vecs), 16, 16)
    for k, want in enumerate(img_vecs):
        _after(t.img_reps[k], want, f"img reps {k}", p.img_reps[k])
    for k, want in enumerate(txt_vecs):
        _after(t.txt_reps[k], want, f"txt reps {k}", p.txt_reps[k])
    _after(t.img_vec, j.img_vec, "con_w img aggregate", p.img_vec)
    _after(t.txt_vec, j.txt_vec, "con_w txt aggregate", p.txt_vec)


def test_paper_round_server_and_eval_match(rounds):
    j, t = rounds["jalgo"], rounds["talgo"]
    want = flax_server_state_to_torch(_np(j.server_state.params),
                                      _np(j.server_state.batch_stats))
    params = {f"model.{k}": v
              for k, v in t.server_state.model.named_parameters()}
    params.update({f"criterion.{k}": v for k, v in
                   t.server_state.criterion.named_parameters()})
    for key, val in params.items():
        start = rounds["server_sd"][key].numpy()
        dt, dj = _host(val) - start, want[key].numpy() - start
        dist = np.linalg.norm(dt - dj) / max(np.linalg.norm(dj), 1e-12)
        assert dist <= UPDATE_DIST, f"{key}: update distance {dist:.3g}"
    assert t.server_state.step == int(j.server_state.step) == 4
    (_, jfeats), (_, tfeats) = rounds["j_eval"][0], rounds["t_eval"][0]
    pfeats = rounds["p_eval"][0][1]
    for key in ("image_features", "caption_features"):
        _after(tfeats[key], jfeats[key], key, pfeats[key])
    for key in ("image_classes", "caption_classes", "caption_ids"):
        np.testing.assert_array_equal(tfeats[key], jfeats[key])
    js, ts = rounds["jscores"], rounds["tscores"]
    n_q = {"i2t": len(jfeats["image_features"]),
           "t2i": len(jfeats["caption_features"])}
    for task in ("i2t", "t2i"):
        for k in ("recall_1", "recall_5", "recall_10"):
            assert abs(ts[task][k] - js[task][k]) <= 100.0 / n_q[task] + 1e-9

"""Weights from the JAX package's trees to the port's ``state_dict``.

The inverse of the JAX package's ``torchvision_resnet_to_flax``: Flax
params and batch_stats (nested dicts of numpy arrays) become torch
tensors under torchvision's key names. Conv kernels HWIO -> OIHW, Dense
kernels [in, out] -> Linear weights [out, in], BatchNorm
scale/bias/mean/var -> weight/bias/running_mean/running_var, LayerNorm
scale/bias -> weight/bias, Embed tables as they are. BERT takes
HuggingFace's names (the inverse of the JAX package's ``hf_bert_to_flax``),
the BiGRU ``torch.nn.GRU``'s (``weight_ih_l0``, ``*_l0_reverse``).

Pretrained weights from local files (the reference downloads torchvision
ResNets, HF ``bert-base-uncased`` and GloVe; nothing is fetched here):
``load_state_dict`` reads a torch checkpoint, whose torchvision or HF key
names the port's modules already use, and ``load_glove_embeddings`` builds
a word-embedding matrix from a GloVe text file (copies of the JAX
package's).
"""

from __future__ import annotations

import re
from typing import Dict, Mapping, Optional, Tuple

import numpy as np
import torch

_BLOCK = re.compile(r"^layer(\d+)_(\d+)$")


def _t(x) -> torch.Tensor:
    return torch.from_numpy(np.array(x, dtype=np.float32))


def _conv(p: Mapping) -> torch.Tensor:
    return _t(np.asarray(p["kernel"]).transpose(3, 2, 0, 1))


def _bn(out: Dict, key: str, p: Mapping, s: Mapping) -> None:
    out[f"{key}.weight"] = _t(p["scale"])
    out[f"{key}.bias"] = _t(p["bias"])
    out[f"{key}.running_mean"] = _t(s["mean"])
    out[f"{key}.running_var"] = _t(s["var"])
    out[f"{key}.num_batches_tracked"] = torch.tensor(0, dtype=torch.long)


def _linear(out: Dict, key: str, p: Mapping) -> None:
    out[f"{key}.weight"] = _t(np.asarray(p["kernel"]).T)
    out[f"{key}.bias"] = _t(p["bias"])


def flax_block_to_torch(params: Mapping, batch_stats: Mapping,
                        prefix: str = "") -> Dict[str, torch.Tensor]:
    """One BasicBlock / Bottleneck / FusedBottleneck (Flax; the last two
    share their trees) -> the port block's ``state_dict`` under
    ``prefix``."""
    sd: Dict[str, torch.Tensor] = {}
    for i in (1, 2, 3):
        if f"conv{i}" in params:
            sd[f"{prefix}conv{i}.weight"] = _conv(params[f"conv{i}"])
            _bn(sd, f"{prefix}bn{i}", params[f"bn{i}"],
                batch_stats[f"bn{i}"])
    if "downsample_conv" in params:
        sd[f"{prefix}downsample.0.weight"] = _conv(params["downsample_conv"])
        _bn(sd, f"{prefix}downsample.1", params["downsample_bn"],
            batch_stats["downsample_bn"])
    return sd


def flax_resnet_to_torch(params: Mapping, batch_stats: Mapping
                         ) -> Dict[str, torch.Tensor]:
    """ResNetBackbone (Flax) params + batch_stats -> torchvision-named
    ``state_dict`` of ``models.resnet.ResNetBackbone``."""
    sd: Dict[str, torch.Tensor] = {"conv1.weight": _conv(params["conv1"])}
    _bn(sd, "bn1", params["bn1"], batch_stats["bn1"])
    for name, p in params.items():
        m = _BLOCK.match(name)
        if m is not None:
            sd.update(flax_block_to_torch(
                p, batch_stats[name], f"layer{m.group(1)}.{m.group(2)}."))
    return sd


def flax_image_client_to_torch(params: Mapping, batch_stats: Mapping
                               ) -> Dict[str, torch.Tensor]:
    """ImageClientNet (Flax) -> ``state_dict`` of the port's
    ``models.clients.ImageClientNet``, with ``head_proj`` (--mlp_local)
    where the tree has it."""
    sd = {f"backbone.{k}": v for k, v in flax_resnet_to_torch(
        params["backbone"], batch_stats["backbone"]).items()}
    for head in ("linear", "class_fc", "class_fc_2"):
        if head in params:
            _linear(sd, head, params[head])
    if "head_proj" in params:
        _mlp_head(sd, "head_proj", params["head_proj"],
                  batch_stats["head_proj"])
    return sd


def _mlp_head(out: Dict, key: str, p: Mapping, s: Mapping) -> None:
    """MLPHead (Flax) -> ``models.pcme.MLPHead`` keys under ``key``."""
    _linear(out, f"{key}.fc1", p["fc1"])
    _bn(out, f"{key}.bn", p["bn"], s["bn"])
    _linear(out, f"{key}.fc2", p["fc2"])


def _layer_norm(out: Dict, key: str, p: Mapping) -> None:
    out[f"{key}.weight"] = _t(p["scale"])
    out[f"{key}.bias"] = _t(p["bias"])


def _no_bias_linear(out: Dict, key: str, p: Mapping) -> None:
    out[f"{key}.weight"] = _t(np.asarray(p["kernel"]).T)


def flax_pie_to_torch(params: Mapping, prefix: str) -> Dict[str, torch.Tensor]:
    """PIENet (Flax) -> ``models.pie.PIENet`` keys under ``prefix``."""
    sd: Dict[str, torch.Tensor] = {}
    for w in ("w_1", "w_2"):
        _no_bias_linear(sd, f"{prefix}attention.{w}", params["attention"][w])
    _linear(sd, f"{prefix}fc", params["fc"])
    _layer_norm(sd, f"{prefix}layer_norm", params["layer_norm"])
    return sd


def flax_uncertainty_to_torch(params: Mapping, prefix: str = ""
                              ) -> Dict[str, torch.Tensor]:
    """UncertaintyModule (Flax) -> ``models.uncertainty.UncertaintyModule``
    keys under ``prefix``."""
    sd: Dict[str, torch.Tensor] = {}
    for w in ("w_1", "w_2"):
        _no_bias_linear(sd, f"{prefix}attention.{w}", params["attention"][w])
    _linear(sd, f"{prefix}fc", params["fc"])
    _linear(sd, f"{prefix}embed", params["embed"])
    return sd


# Flax BertLayer submodule -> HF BertLayer key.
_BERT_LAYER = {
    "q": "attention.self.query",
    "k": "attention.self.key",
    "v": "attention.self.value",
    "attn_out": "attention.output.dense",
    "ffn_in": "intermediate.dense",
    "ffn_out": "output.dense",
}
_BERT_LAYER_NORMS = {"attn_ln": "attention.output.LayerNorm",
                     "ffn_ln": "output.LayerNorm"}


def flax_bert_to_torch(params: Mapping) -> Dict[str, torch.Tensor]:
    """BertEncoder (Flax) params -> HF-named ``state_dict`` of the port's
    ``models.bert.BertEncoder`` (the inverse of the JAX package's
    ``hf_bert_to_flax``)."""
    e = "embeddings."
    sd: Dict[str, torch.Tensor] = {}
    for name in ("word_embeddings", "position_embeddings",
                 "token_type_embeddings"):
        sd[f"{e}{name}.weight"] = _t(params[name]["embedding"])
    _layer_norm(sd, f"{e}LayerNorm", params["embeddings_ln"])
    for name, p in params.items():
        m = re.match(r"^layer_(\d+)$", name)
        if m is None:
            continue
        prefix = f"encoder.layer.{m.group(1)}."
        for flax_name, hf in _BERT_LAYER.items():
            _linear(sd, prefix + hf, p[flax_name])
        for flax_name, hf in _BERT_LAYER_NORMS.items():
            _layer_norm(sd, prefix + hf, p[flax_name])
    return sd


def flax_bigru_to_torch(params: Mapping, prefix: str = ""
                        ) -> Dict[str, torch.Tensor]:
    """BiGRU (Flax: ``{fwd,bwd}_{wi,bi,wh,bh}``, kernels [in, 3H]) ->
    ``models.gru.BiGRU`` (``torch.nn.GRU``) keys under ``prefix``. Both
    keep the gates in torch's (r, z, n) order."""
    sd: Dict[str, torch.Tensor] = {}
    for flax_dir, suffix in (("fwd", "l0"), ("bwd", "l0_reverse")):
        for flax_w, torch_w in (("wi", "ih"), ("wh", "hh")):
            sd[f"{prefix}weight_{torch_w}_{suffix}"] = _t(
                np.asarray(params[f"{flax_dir}_{flax_w}"]).T)
        for flax_b, torch_b in (("bi", "ih"), ("bh", "hh")):
            sd[f"{prefix}bias_{torch_b}_{suffix}"] = _t(
                params[f"{flax_dir}_{flax_b}"])
    return sd


def _text_gru_branch(params: Mapping, prefix: str) -> Dict[str, torch.Tensor]:
    """embed + rnn + pie_net, shared by TextEncoderGRU and TextClientNet."""
    sd = {f"{prefix}embed.weight": _t(params["embed"]["embedding"])}
    sd.update(flax_bigru_to_torch(params["rnn"], f"{prefix}rnn."))
    sd.update(flax_pie_to_torch(params["pie_net"], f"{prefix}pie_net."))
    return sd


def flax_text_client_to_torch(params: Mapping, batch_stats: Mapping
                              ) -> Dict[str, torch.Tensor]:
    """TextClientNet (Flax) -> ``state_dict`` of the port's
    ``models.clients.TextClientNet``, with ``head_proj`` (--mlp_local)
    where the tree has it."""
    sd = _text_gru_branch(params, "")
    for head in ("class_fc", "class_fc_2"):
        _linear(sd, head, params[head])
    if "head_proj" in params:
        _mlp_head(sd, "head_proj", params["head_proj"],
                  batch_stats["head_proj"])
    return sd


def flax_pcme_to_torch(params: Mapping, batch_stats: Mapping
                       ) -> Dict[str, torch.Tensor]:
    """PCME (Flax, BERT or GRU text branch) params + batch_stats ->
    ``state_dict`` of the port's ``models.pcme.PCME``. Standard and fused
    trunks share their trees, so this serves both."""
    img, img_stats = params["img_enc"], batch_stats.get("img_enc", {})
    sd = {f"img_enc.cnn.{k}": v for k, v in flax_resnet_to_torch(
        img["cnn"], img_stats["cnn"]).items()}
    _linear(sd, "img_enc.fc", img["fc"])
    sd.update(flax_pie_to_torch(img["pie_net"], "img_enc.pie_net."))
    if "head_proj" in img:
        _mlp_head(sd, "img_enc.head_proj", img["head_proj"],
                  img_stats["head_proj"])
    txt = params["txt_enc"]
    if "bert" not in txt:
        sd.update(_text_gru_branch(txt, "txt_enc."))
        if "head_proj" in txt:
            _mlp_head(sd, "txt_enc.head_proj", txt["head_proj"],
                      batch_stats["txt_enc"]["head_proj"])
        return sd
    sd.update({f"txt_enc.bert.{k}": v
               for k, v in flax_bert_to_torch(txt["bert"]).items()})
    _linear(sd, "txt_enc.linear", txt["linear"])
    return sd


def flax_server_state_to_torch(params: Mapping, batch_stats: Mapping
                               ) -> Dict[str, torch.Tensor]:
    """The JAX server's (or mm client's) ``{'model', 'criterion'}`` params
    and its batch_stats -> the ``model.*`` / ``criterion.*`` state dict that
    the port's ``ServerEngine.init_state`` and ``MMClientEngine.init_state``
    take (criterion: ``shift`` and ``negative_scale``, [1] each)."""
    sd = {f"model.{k}": v for k, v in flax_pcme_to_torch(
        params["model"], batch_stats).items()}
    for name, val in params["criterion"].items():
        sd[f"criterion.{name}"] = _t(val)
    return sd


# ---------------------------------------------------------------------------
# Pretrained weights from local files
# ---------------------------------------------------------------------------

def load_state_dict(path: str) -> Dict[str, torch.Tensor]:
    """A torch checkpoint's state dict (unwrapping a ``state_dict`` entry),
    every tensor on the CPU."""
    sd = torch.load(path, map_location="cpu", weights_only=True)
    if isinstance(sd, dict) and "state_dict" in sd:
        sd = sd["state_dict"]
    return {k: torch.as_tensor(v) for k, v in sd.items()}


def load_torchvision_trunk(path: str) -> Dict[str, torch.Tensor]:
    """A torchvision ResNet checkpoint without its classifier (``fc.*``):
    the state dict of ``models.resnet.ResNetBackbone``."""
    return {k: v for k, v in load_state_dict(path).items()
            if not k.startswith("fc.")}


def load_glove_embeddings(path: str, vocab, word_dim: int = 300,
                          init: Optional[np.ndarray] = None
                          ) -> Tuple[np.ndarray, int]:
    """Text-format GloVe file -> [V, word_dim] matrix.

    Reproduces the reference's hit-rate trick
    (caption_encoder.py:77-85): on a miss, retry after stripping
    '-', '.', "'" and taking the pre-'/' part. Returns (matrix, n_missing).
    """
    table: Dict[str, np.ndarray] = {}
    wanted = set(vocab.word2idx.keys())
    variants = set()
    for w in wanted:
        v = w.replace("-", "").replace(".", "").replace("'", "")
        if "/" in v:
            v = v.split("/")[0]
        variants.add(v)
    with open(path, encoding="utf-8") as f:
        for line in f:
            parts = line.rstrip().split(" ")
            word = parts[0]
            if word in wanted or word in variants:
                table[word] = np.asarray(parts[1:], np.float32)

    if init is None:
        rng = np.random.default_rng(0)
        mat = rng.normal(0, 0.02,
                         (len(vocab), word_dim)).astype(np.float32)
    else:
        mat = np.array(init, np.float32, copy=True)
    missing = 0
    for word, idx in vocab.word2idx.items():
        key = word
        if key not in table:
            key = word.replace("-", "").replace(".", "").replace("'", "")
            if "/" in key:
                key = key.split("/")[0]
        if key in table:
            mat[idx] = table[key]
        else:
            missing += 1
    return mat, missing

"""Reference (PyTorch) checkpoint importer (the port's own copy of
``wavenet_autoencoders_tpu/utils/torch_import.py``).

Maps a reference ``state_dict`` (``vqwae_train.py:878-890`` torch pickles)
onto the JAX params tree — nested dicts and lists of numpy arrays, which
``utils.params.load_jax_params`` puts into a port model. Handles:

- name mapping (``wavenet.conv_layers.3.conv1x1c`` -> layers[3]['cproj']…)
- layout: torch conv (Cout, Cin, K) -> lax 'WIO' (K, Cin, Cout);
  torch linear (Cout, Cin) -> (Cin, Cout)
- weight norm: torch weight_g (Cout,1,1) -> g (Cout,); weight_v transposed
  like a conv weight

Loading the .pth itself uses torch on the CPU (``load_torch_state_dict``;
``torch.load``'s defaults, so under torch >= 2.6 only tensors and plain
containers unpickle); everything downstream is numpy, so tests exercise the
mapping with synthetic numpy state dicts. ``reference_state_dict`` is the
inverse mapping, from a port model to the reference's names and layouts.
"""
from __future__ import annotations

import numpy as np


def load_torch_state_dict(path: str) -> dict:
    import torch

    ckpt = torch.load(path, map_location="cpu")
    sd = ckpt.get("state_dict", ckpt)
    return {k: v.detach().cpu().numpy() for k, v in sd.items()}


def _conv_w(w: np.ndarray) -> np.ndarray:
    """(Cout, Cin, K) -> (K, Cin, Cout)."""
    return np.ascontiguousarray(np.transpose(w, (2, 1, 0)))


def _lin_w(w: np.ndarray) -> np.ndarray:
    return np.ascontiguousarray(w.T)


def _wn_conv(sd: dict, prefix: str) -> dict:
    """Weight-normed conv params from torch weight_g/weight_v[/bias]."""
    out = {
        "g": sd[f"{prefix}.weight_g"].reshape(-1).astype(np.float32),
        "v": _conv_w(sd[f"{prefix}.weight_v"]).astype(np.float32),
    }
    if f"{prefix}.bias" in sd:
        out["b"] = sd[f"{prefix}.bias"].astype(np.float32)
    return out


def _plain_conv(sd: dict, prefix: str) -> dict:
    out = {"w": _conv_w(sd[f"{prefix}.weight"]).astype(np.float32)}
    if f"{prefix}.bias" in sd:
        out["b"] = sd[f"{prefix}.bias"].astype(np.float32)
    return out


def import_wavenet(sd: dict, n_layers: int, prefix: str = "wavenet.") -> dict:
    """WaveNet params from reference names (``wavenet.py:98-156``)."""
    p = {
        "first": _wn_conv(sd, f"{prefix}first_conv"),
        "layers": [],
        # last_conv_layers = [ReLU, conv, ReLU, conv] (wavenet.py:136-141)
        "post1": _wn_conv(sd, f"{prefix}last_conv_layers.1"),
        "post2": _wn_conv(sd, f"{prefix}last_conv_layers.3"),
    }
    for i in range(n_layers):
        lp = f"{prefix}conv_layers.{i}."
        layer = {
            "conv": _wn_conv(sd, lp + "conv"),
            "out": _wn_conv(sd, lp + "conv1x1_out"),
            "skip": _wn_conv(sd, lp + "conv1x1_skip"),
        }
        if lp + "conv1x1c.weight_v" in sd:
            layer["cproj"] = _wn_conv(sd, lp + "conv1x1c")
        if lp + "conv1x1g.weight_v" in sd:
            layer["gproj"] = _wn_conv(sd, lp + "conv1x1g")
        p["layers"].append(layer)

    if f"{prefix}embed_speakers.weight" in sd:
        p["embed"] = {"table": sd[f"{prefix}embed_speakers.weight"].astype(np.float32)}

    if f"{prefix}upsample_net.conv_in.weight" in sd:
        # ConvInUpsampleNetwork (upsample.py:69-85)
        convs = []
        i = 1  # up_layers = [stretch, conv, stretch, conv, ...]
        while f"{prefix}upsample_net.upsample.up_layers.{i}.weight_v" in sd:
            g = sd[f"{prefix}upsample_net.upsample.up_layers.{i}.weight_g"]
            v = sd[f"{prefix}upsample_net.upsample.up_layers.{i}.weight_v"]
            convs.append({"g": np.float32(g.reshape(())), "v": v.astype(np.float32)})
            i += 2
        p["upsample"] = {
            "conv_in": _plain_conv(sd, f"{prefix}upsample_net.conv_in"),
            "upsample": {"convs": convs},
        }
    elif f"{prefix}upsample_net.up_layers.1.weight_v" in sd:
        convs = []
        i = 1
        while f"{prefix}upsample_net.up_layers.{i}.weight_v" in sd:
            g = sd[f"{prefix}upsample_net.up_layers.{i}.weight_g"]
            v = sd[f"{prefix}upsample_net.up_layers.{i}.weight_v"]
            convs.append({"g": np.float32(g.reshape(())), "v": v.astype(np.float32)})
            i += 2
        p["upsample"] = {"convs": convs}
    return p


def import_encoder(sd: dict, n_blocks: int = 10, prefix: str = "encoder.") -> dict:
    """Committed Encoder (``vqvae_model.py:27-51``): net.{i}.conv + lin."""
    blocks = [_plain_conv(sd, f"{prefix}net.{i}.conv") for i in range(n_blocks)]
    return {
        "blocks": blocks,
        "lin": {
            "w": _lin_w(sd[f"{prefix}lin.weight"]).astype(np.float32),
            "b": sd[f"{prefix}lin.bias"].astype(np.float32),
        },
    }


def import_vqvae(sd: dict, n_layers: int = 20) -> dict:
    """Committed VQVAE (``vqvae_model.py:52-84``): encoder + vq + wavenet."""
    p = {
        "encoder": import_encoder(sd),
        "wavenet": import_wavenet(sd, n_layers),
    }
    if "vq.embedding.weight" in sd:
        p["vq"] = {"codebook": sd["vq.embedding.weight"].astype(np.float32)}
    elif "vq.embedding1.weight" in sd:
        books = [sd["vq.embedding1.weight"].astype(np.float32)]
        i = 2
        while f"vq.embedding{i}.weight" in sd:
            books.append(sd[f"vq.embedding{i}.weight"].astype(np.float32))
            i += 1
        p["vq"] = {"codebooks": books}
    return p


def import_checkpoint(path: str, cfg) -> dict:
    """Load a reference .pth and convert per the model family."""
    sd = load_torch_state_dict(path)
    name = cfg.name.lower()
    if name in ("vqvae", "wvae", "inae", "inae1", "catae", "new_inae"):
        return import_vqvae(sd, n_layers=cfg.layers)
    if name == "wavenet_vocoder":
        return {"wavenet": import_wavenet(sd, cfg.layers, prefix="")}
    raise ValueError(f"no torch import rule for model {cfg.name}")


def reference_state_dict(model, prefix: str = "wavenet.") -> dict:
    """The inverse of the import: a port model's parameters under the
    reference's names and layouts (numpy; weight-normed convs as
    weight_g/weight_v), as the reference's ``state_dict()`` holds them.
    ``prefix`` is the decoder's ("" for the plain vocoder, whose decoder is
    the whole model). Covers what ``import_vqvae`` / ``import_wavenet``
    read: the encoder, the codebooks and the decoder."""
    flat = {k: p.detach().cpu().numpy() for k, p in model.named_parameters()}
    sd = {}

    def wn(dst, src):
        v = flat[f"{src}.v"]
        sd[f"{dst}.weight_g"] = flat[f"{src}.g"].reshape(-1, 1, 1)
        sd[f"{dst}.weight_v"] = np.ascontiguousarray(np.transpose(v, (2, 1, 0)))
        if f"{src}.b" in flat:
            sd[f"{dst}.bias"] = flat[f"{src}.b"]

    def plain(dst, src):
        sd[f"{dst}.weight"] = np.ascontiguousarray(np.transpose(flat[f"{src}.w"], (2, 1, 0)))
        if f"{src}.b" in flat:
            sd[f"{dst}.bias"] = flat[f"{src}.b"]

    net = model.wavenet
    wn(f"{prefix}first_conv", "wavenet.first")
    for i, lp in enumerate(net.layers):
        src, dst = f"wavenet.layers.{i}", f"{prefix}conv_layers.{i}"
        for a, b in (("conv", "conv"), ("out", "conv1x1_out"), ("skip", "conv1x1_skip"),
                     ("cproj", "conv1x1c"), ("gproj", "conv1x1g")):
            if getattr(lp, a) is not None:
                wn(f"{dst}.{b}", f"{src}.{a}")
    wn(f"{prefix}last_conv_layers.1", "wavenet.post1")
    wn(f"{prefix}last_conv_layers.3", "wavenet.post2")
    if net.embed is not None:
        sd[f"{prefix}embed_speakers.weight"] = flat["wavenet.embed.table"]
    if net.upsample is not None:
        if "wavenet.upsample.conv_in.w" in flat:
            plain(f"{prefix}upsample_net.conv_in", "wavenet.upsample.conv_in")
            up, src = "upsample_net.upsample.up_layers", "wavenet.upsample.upsample.convs"
        else:
            up, src = "upsample_net.up_layers", "wavenet.upsample.convs"
        j = 0
        while f"{src}.{j}.v" in flat:
            sd[f"{prefix}{up}.{2 * j + 1}.weight_g"] = flat[f"{src}.{j}.g"].reshape(1, 1, 1, 1)
            sd[f"{prefix}{up}.{2 * j + 1}.weight_v"] = flat[f"{src}.{j}.v"]
            j += 1
    if "encoder.lin.w" in flat:
        for i in range(len(model.encoder.blocks)):
            plain(f"encoder.net.{i}.conv", f"encoder.blocks.{i}")
        sd["encoder.lin.weight"] = np.ascontiguousarray(flat["encoder.lin.w"].T)
        sd["encoder.lin.bias"] = flat["encoder.lin.b"]
    if "vq.codebook" in flat:
        sd["vq.embedding.weight"] = flat["vq.codebook"]
    i = 0
    while f"vq.codebooks.{i}" in flat:
        sd[f"vq.embedding{i + 1}.weight"] = flat[f"vq.codebooks.{i}"]
        i += 1
    return sd

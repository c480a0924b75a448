"""Seeded random weights of the model, made on the device.

The benchmark makes the weights itself and hands the same tensors to the
program (as a ``Multiverse`` parameter tree) and to the reference. One
uniform draw of every weight at once, from a ``torch.Generator`` on the
device, is cut into the leaves and scaled per leaf: the ConvLSTM kernels
glorot-uniform, the other convs uniform at the variance of the
program's He init (2 / fan in); biases zero. The layout (names, shapes)
is the program's parameter tree at the configuration's sizes.
"""

from __future__ import annotations

import math
from typing import Dict, List, Tuple

import torch


def leaf_shapes(model: dict) -> List[Tuple[str, tuple, str]]:
    """(dotted name, shape, init) of every leaf; init is "conv",
    "lstm" or "zeros"."""
    k = model["convlstm_kernel"]
    D = model["enc_hidden_size"]
    E = model["emb_size"]
    Cs = model["scene_conv_dim"]
    ks = model["scene_conv_kernel"]
    out = []

    def conv(name, cin, cout, kernel=3, bias=True):
        out.append((name + ".w", (kernel, kernel, cin, cout), "conv"))
        if bias:
            out.append((name + ".b", (cout,), "zeros"))

    def lstm(name, cin):
        out.append((name + ".kernel", (k, k, cin + D, 4 * D), "lstm"))
        out.append((name + ".bias", (4 * D,), "zeros"))

    if model["use_scene_enc"]:
        cin = model["scene_class"]
        for i in range(len(model["scene_grid_strides"])):
            conv("scene_conv%d" % (i + 1), cin, Cs, ks)
            cin = Cs
    for i, used in enumerate(model["use_grids"]):
        if not used:
            continue
        p = "scales.%d." % i
        lstm(p + "enc_class", Cs if model["use_scene_enc"] else E)
        lstm(p + "enc_reg", 2)
        lstm(p + "dec_class", E)
        conv(p + "dec_class_emb", 1, E)
        conv(p + "h2g_class", D, 1, bias=False)
        if not model["use_scene_enc"]:
            conv(p + "enc_grid_emb", 1, E)
        if model["use_single_decoder"]:
            conv(p + "h2g_single", D, 2, bias=False)
        else:
            lstm(p + "dec_reg", E)
            conv(p + "dec_reg_emb", 2, E)
            conv(p + "h2g_reg", D, 2, bias=False)
    return out


def make_weights(model: dict, seed: int, device) -> Dict[str, torch.Tensor]:
    """{dotted name: f32 tensor on ``device``}, from ``seed``."""
    leaves = leaf_shapes(model)
    total = sum(math.prod(s) for _, s, init in leaves if init != "zeros")
    gen = torch.Generator(device=device).manual_seed(int(seed))
    u = torch.rand(total, generator=gen, device=device) * 2.0 - 1.0
    out, at = {}, 0
    for name, shape, init in leaves:
        if init == "zeros":
            out[name] = torch.zeros(shape, device=device)
            continue
        n = math.prod(shape)
        kh, kw, cin, cout = shape
        if init == "lstm":
            limit = math.sqrt(6.0 / (kh * kw * cin + kh * kw * cout))
        else:
            limit = math.sqrt(6.0 / (kh * kw * cin))
        out[name] = (u[at:at + n] * limit).reshape(shape)
        at += n
    return out


def nest(flat: Dict[str, torch.Tensor]) -> dict:
    """{"a.b.c": t} -> {"a": {"b": {"c": t}}}."""
    tree: dict = {}
    for name, t in flat.items():
        node = tree
        parts = name.split(".")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = t
    return tree

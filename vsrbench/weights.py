"""Weights made on the device from the run's seed, in a few large draws.

Each model's leaves are listed here from the reference's module names and
torch layouts (`reference/`), with their initialisers' laws: the captioner
xavier-normal with zero biases (reference controllable_captioning.py:72-107;
the recurrent matrices, orthogonal there, are drawn normal with std
1/sqrt(R) here, the scale of an orthogonal matrix's entries, so that no QR
runs), the S-SSP planner xavier-uniform with torch Linear's uniform biases
and unit layer norms (sort_model.py), the Sinkhorn network xavier-normal
with zero biases (sinkhorn_network.py:18-28). All normal leaves of a model
come from one `torch.randn` and all uniform ones from one `torch.rand`, on
the card's generator.
"""
from __future__ import annotations

import math

import numpy as np
import torch


def _xn(o, i):
    return ("normal", (o, i), math.sqrt(2.0 / (i + o)))


def _xu(o, i):
    return ("uniform", (o, i), math.sqrt(6.0 / (i + o)))


def _const(n, value):
    return ("const", (n,), value)


def captioner_leaves(c):
    r, e, d, a, v = (c["rnn_size"], c["input_encoding_size"],
                     c["det_feat_size"], c["att_size"], c["vocab_size"])
    in1 = d + r + e if c["h2_first_lstm"] else d + e
    in2 = r + d + d if c["img_second_lstm"] else r + d

    def lin(name, i, o, bias=True):
        out = {name + ".weight": _xn(o, i)}
        if bias:
            out[name + ".bias"] = _const(o, 0.0)
        return out

    def lstm(name, i):
        return {name + ".weight_ih": _xn(4 * r, i),
                name + ".weight_hh": ("normal", (4 * r, r), 1 / math.sqrt(r)),
                name + ".bias_ih": _const(4 * r, 0.0),
                name + ".bias_hh": _const(4 * r, 0.0)}

    leaves = {"embed.weight": _xn(v, e)}
    leaves.update(lin("W1_is", in1, r))
    leaves.update(lin("W1_hs", r, r))
    leaves.update(lin("att_va", d, a, False))
    leaves.update(lin("att_ha", r, a, False))
    leaves.update(lin("att_a", a, 1, False))
    leaves.update(lin("att_sa", r, a, False))
    leaves.update(lin("att_s", a, 1, False))
    leaves.update(lstm("lstm_cell_1", in1))
    leaves.update(lstm("lstm_cell_2", in2))
    leaves.update(lin("out_fc", r, v))
    leaves.update(lin("s_fc", r, d))
    leaves.update(lin("W1_ig", in1, r))
    leaves.update(lin("W1_hg", r, r))
    leaves.update(lin("att_ga", r, a, False))
    leaves.update(lin("att_g", a, 1, False))
    return leaves


def planner_leaves(p, n_verbs, n_roles=26):
    h, ff, emb = p["hidden_size"], 4 * p["hidden_size"], p["embed_size"]
    leaves = {"sr_embed_layer.weight": _xu(n_roles, emb),
              "v_embed_layer.weight": _xu(n_verbs + 1, emb)}

    def lin(name, i, o):
        leaves[name + ".weight"] = _xu(o, i)
        leaves[name + ".bias"] = ("uniform", (o,), 1 / math.sqrt(i))

    def norm(name, n):
        leaves[name + ".weight"] = _const(n, 1.0)
        leaves[name + ".bias"] = _const(n, 0.0)

    def attention(name):
        for part in ("linear_Q", "linear_K", "linear_V", "linear_O"):
            lin("%s.%s" % (name, part), h, h)

    for side, n_layers in (("encoder", p["encoder_layers"]),
                           ("decoder", p["decoder_layers"])):
        norm(side + ".layer_norm", h)
        for i in range(n_layers):
            base = "%s.encoder_layers.%d" % (side, i)
            attention(base + ".attention")
            if side == "decoder":
                attention(base + ".cross_attention")
            lin(base + ".ff_layer.w_1", h, ff)
            lin(base + ".ff_layer.w_2", ff, h)
            for j in ((1, 2, 3) if side == "decoder" else (1, 2)):
                norm("%s.layer_norm%d" % (base, j), h)
    if p["add_fc"]:
        lin("encoder.fc_feat", h, h)
    lin("expander_nn", h, n_roles)
    return leaves


def sinkhorn_leaves(s):
    leaves = {}
    for name, i, o in (("W1_txt", s["txt_dim"], 128),
                       ("W1_vis", s["vis_dim"], 512), ("W2_vis", 512, 128),
                       ("W_fc_pos", 256 + s["pos_dim"], 256),
                       ("W_fc", 256, s["n"])):
        leaves[name + ".weight"] = _xn(o, i)
        leaves[name + ".bias"] = _const(o, 0.0)
    return leaves


def make(leaves, gen, device):
    """Nested dict of float32 tensors on `device` from the leaves' laws,
    drawn in one randn and one rand call from `gen`."""
    sizes = {kind: sum(int(np.prod(shape)) for k, shape, _ in leaves.values()
                       if k == kind) for kind in ("normal", "uniform")}
    pools = {"normal": torch.randn(sizes["normal"], generator=gen,
                                   device=device),
             "uniform": torch.rand(sizes["uniform"], generator=gen,
                                   device=device) * 2 - 1}
    taken = {"normal": 0, "uniform": 0}
    tree = {}
    for name, (kind, shape, scale) in leaves.items():
        if kind == "const":
            val = torch.full(shape, float(scale), device=device)
        else:
            n = int(np.prod(shape))
            val = pools[kind][taken[kind]:taken[kind] + n].view(shape) * scale
            taken[kind] += n
        node = tree
        *path, leaf = name.split(".")
        for key in path:
            node = node.setdefault(key, {})
        node[leaf] = val.contiguous()
    return tree


def clone(tree):
    """A copy of a nested dict of tensors that shares no storage."""
    return {k: clone(v) if isinstance(v, dict) else v.clone()
            for k, v in tree.items()}


def tense_table(n_verbs, vocab, tenses, rng):
    """The verb -> tense map, {str(verb): [word ids]} for verbs 1..n_verbs,
    `tenses` distinct words each above the four specials, and the same as
    a dense (n_verbs + 1, tenses) id table, -1 padded."""
    ids = np.full((n_verbs + 1, tenses), -1, np.int64)
    for verb in range(1, n_verbs + 1):
        ids[verb] = 4 + rng.choice(vocab - 4, tenses, replace=False)
    return {str(v): ids[v].tolist() for v in range(1, n_verbs + 1)}, ids

"""Seeded weights of a configuration, made on the device in one draw.

The leaves, their shapes and their scales follow the configuration's
sizes (the layouts of ``reference/model.py``); the biases get small
random values so that they count in every product.  One
``torch.randn`` over all leaves on a generator of the device makes
them, in float32, the type the parameters are kept in, so the same seed
on the same device gives the same bits.
"""

from __future__ import annotations

import math
from typing import Dict, List, Tuple

import torch

BIAS_SCALE = 0.1


def leaves(m: dict) -> List[Tuple[str, tuple, float]]:
    """(name, shape, scale) of every leaf, in draw order."""
    R, S, d, mu = (m["residual_channels"], m["skip_channels"], m["d"],
                   m["mu"])
    L = m["n_loop"] * m["n_layer"]
    C, k, g = m["enc_channels"], m["enc_kernel"], m["speaker_embed_dim"]
    hop = m["enc_stride"] ** m["enc_layers"]
    ku = hop * m["upsample_kernel_mult"]
    out = []
    cin = 1
    for i in range(m["enc_layers"]):
        out += [(f"encoder/layers/{i}/w", (k, cin, C), 1 / math.sqrt(k * cin)),
                (f"encoder/layers/{i}/b", (C,), BIAS_SCALE)]
        cin = C
    out += [("encoder/proj/w", (C, d), 1 / math.sqrt(C)),
            ("encoder/proj/b", (d,), BIAS_SCALE),
            ("vq/codebook", (m["K"], d), 1.0),
            ("decoder/emb/w", (2, mu, R), 1 / math.sqrt(2)),
            ("decoder/emb/b", (R,), BIAS_SCALE),
            ("decoder/layers/wf", (L, 2, R, 2 * R), 1 / math.sqrt(2 * R)),
            ("decoder/layers/bf", (L, 2 * R), BIAS_SCALE),
            ("decoder/layers/vc", (L, d, 2 * R), 1 / math.sqrt(d)),
            ("decoder/layers/vg", (L, g, 2 * R), 1 / math.sqrt(g)),
            ("decoder/layers/wr", (L, R, R), 1 / math.sqrt(R)),
            ("decoder/layers/br", (L, R), BIAS_SCALE),
            ("decoder/layers/ws", (L, R, S), 1 / math.sqrt(R)),
            ("decoder/layers/bs", (L, S), BIAS_SCALE),
            ("decoder/head/h1/w", (S, S), 1 / math.sqrt(S)),
            ("decoder/head/h1/b", (S,), BIAS_SCALE),
            ("decoder/head/h2/w", (S, mu), 1 / math.sqrt(S)),
            ("decoder/head/h2/b", (mu,), BIAS_SCALE),
            ("decoder/upsample/w", (ku, d, d), 1 / math.sqrt(ku * d)),
            ("decoder/upsample/b", (d,), BIAS_SCALE),
            ("decoder/speaker/w", (max(m["n_speakers"], 1), g), 1.0)]
    return out


def make(m: dict, seed: int, device) -> Dict[str, torch.Tensor]:
    """Flat dict of float32 leaves on ``device`` from ``seed``."""
    spec = leaves(m)
    sizes = [math.prod(shape) for _, shape, _ in spec]
    gen = torch.Generator(device=device).manual_seed(seed)
    flat = torch.randn(sum(sizes), generator=gen, device=device,
                       dtype=torch.float32)
    out, at = {}, 0
    for (name, shape, scale), n in zip(spec, sizes):
        out[name] = (flat[at:at + n] * scale).reshape(shape)
        at += n
    return out


def nest(flat: Dict[str, torch.Tensor]) -> dict:
    """The flat dict as the nested tree of dicts and lists the program's
    parameter tree is built from (a digit key is a list index)."""
    tree: dict = {}
    for key, v in flat.items():
        node = tree
        parts = key.split("/")
        for part in parts[:-1]:
            node = node.setdefault(part, {})
        node[parts[-1]] = v

    def lists(node):
        if not isinstance(node, dict):
            return node
        node = {k: lists(v) for k, v in node.items()}
        if node and all(k.isdigit() for k in node):
            return [node[str(i)] for i in range(len(node))]
        return node
    return lists(tree)

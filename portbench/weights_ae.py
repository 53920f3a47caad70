"""Seeded weights of the WaveNet autoencoder's configuration, made on the
device in one draw, as ``weights.py`` makes the VQ-VAE's: the leaves
and layouts of ``reference/wavenet_ae.py``, weights at ``1/sqrt(fan
in)``, biases at ``weights.BIAS_SCALE`` so that they count in every
product, one ``torch.randn`` over all leaves in float32.
"""

from __future__ import annotations

import math
from typing import Dict, List, Tuple

import torch

from portbench.weights import BIAS_SCALE


def leaves(m: dict) -> List[Tuple[str, tuple, float]]:
    """(name, shape, scale) of every leaf, in draw order."""
    R, S, mu, k, L = (m["width"], m["skip_width"], m["mu"],
                      m["filter_length"], m["num_layers"])
    C, e, ka, La = (m["ae_width"], m["ae_bottleneck_width"],
                    m["ae_filter_length"], m["ae_num_layers"])
    return [
        ("encoder/start/w", (ka, 1, C), 1 / math.sqrt(ka)),
        ("encoder/start/b", (C,), BIAS_SCALE),
        ("encoder/layers/wd", (La, ka, C, C), 1 / math.sqrt(ka * C)),
        ("encoder/layers/bd", (La, C), BIAS_SCALE),
        ("encoder/layers/wr", (La, C, C), 1 / math.sqrt(C)),
        ("encoder/layers/br", (La, C), BIAS_SCALE),
        ("encoder/bottleneck/w", (C, e), 1 / math.sqrt(C)),
        ("encoder/bottleneck/b", (e,), BIAS_SCALE),
        ("decoder/start/w", (k, 1, R), 1 / math.sqrt(k)),
        ("decoder/start/b", (R,), BIAS_SCALE),
        ("decoder/skip_start/w", (R, S), 1 / math.sqrt(R)),
        ("decoder/skip_start/b", (S,), BIAS_SCALE),
        ("decoder/layers/wf", (L, k, R, 2 * R), 1 / math.sqrt(k * R)),
        ("decoder/layers/bf", (L, 2 * R), BIAS_SCALE),
        ("decoder/layers/wc", (L, e, 2 * R), 1 / math.sqrt(e)),
        ("decoder/layers/bc", (L, 2 * R), BIAS_SCALE),
        ("decoder/layers/wr", (L, R, R), 1 / math.sqrt(R)),
        ("decoder/layers/br", (L, R), BIAS_SCALE),
        ("decoder/layers/ws", (L, R, S), 1 / math.sqrt(R)),
        ("decoder/layers/bs", (L, S), BIAS_SCALE),
        ("decoder/head/out1/w", (S, S), 1 / math.sqrt(S)),
        ("decoder/head/out1/b", (S,), BIAS_SCALE),
        ("decoder/head/cond/w", (e, S), 1 / math.sqrt(e)),
        ("decoder/head/cond/b", (S,), BIAS_SCALE),
        ("decoder/head/logits/w", (S, mu), 1 / math.sqrt(S)),
        ("decoder/head/logits/b", (mu,), BIAS_SCALE),
    ]


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

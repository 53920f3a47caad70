"""The reference's reading of served audio: teacher-forced logits over
the ids a session returned, and the gap by which each served id's logit
lies below the best one.

A decode step t reads the previous output id (``mu // 2``, digital
silence, before the first) and the condition sample t, so the
teacher-forced decoder over the input ids ``[mu // 2, s_0, ..., s_{n-2}]``
gives at each position the logits that the served id ``s_t`` was drawn
from.  For a greedy session the served id should be the best one, up to
the rounding of the compute dtype.
"""

from __future__ import annotations

import numpy as np
import torch

from portbench.reference import model as ref


def pcm16_ids(pcm: np.ndarray, mu: int) -> np.ndarray:
    """Served int16 PCM (``round(x * 32767)``) back to mu-law ids: the
    PCM step is far below the narrowest mu-law bin, so the ids come back
    exactly."""
    x = torch.from_numpy(pcm.astype(np.float32) / 32767.0)
    return ref.mu_law_encode(x, mu).numpy()


@torch.no_grad()
def logits_for(p, m: dict, codes: np.ndarray, speaker: int,
               served: np.ndarray, prec: ref.Prec = ref.F32) -> torch.Tensor:
    """``[n, mu]`` teacher-forced logits for the ``n`` served ids of a
    session that pushed ``codes`` for ``speaker``."""
    dev = p["vq/codebook"].device
    e = p["vq/codebook"][torch.as_tensor(codes, device=dev).long()][None]
    cond = ref.upsample(p, m, e, prec)[:, :len(served)]
    ids = torch.as_tensor(served, device=dev).long()
    ids_in = torch.cat([torch.full((1,), m["mu"] // 2, device=dev,
                                   dtype=torch.long), ids[:-1]])[None]
    spk = torch.tensor([speaker], device=dev)
    return ref.logits(p, ref.skips(p, m, ids_in, cond, spk, prec), prec)[0]


@torch.no_grad()
def widest_gap(lg: torch.Tensor, picked: torch.Tensor) -> float:
    """Largest ``max(logits) - logits[picked]`` over the positions."""
    best = lg.max(-1).values
    got = lg.gather(-1, picked.long()[:, None])[:, 0]
    return float((best - got).max())

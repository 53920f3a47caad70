"""A synthetic speech corpus in the VCTK layout, made from the seed:
``<root>/wav48/p<NNN>/p<NNN>_<UUU>.wav``, 48 kHz mono int16.

Each utterance is a voiced tone (a fundamental drawn per speaker, three
harmonics under a syllable-rate envelope, a little noise) between
stretches of near-silence that the loader's trim removes.  Every seed
gives the same set of lengths in another order, so the work a run does
is the same from seed to seed.
"""

from __future__ import annotations

import os

import numpy as np
from scipy.io import wavfile

SR = 48000


def make_tree(root: str, seed: int, spec: dict) -> str:
    """Write the corpus under ``root``; returns ``root``.  ``spec``:
    ``speakers``, ``utterances_per_speaker``, ``seconds`` ([shortest,
    longest] voiced length) and ``silence_s`` at each end."""
    rng = np.random.default_rng(np.random.SeedSequence([seed, 7]))
    n_spk, n_utt = spec["speakers"], spec["utterances_per_speaker"]
    lo, hi = spec["seconds"]
    n = n_spk * n_utt
    lengths = rng.permutation(np.linspace(lo, hi, n))
    f0 = rng.uniform(90.0, 260.0, n_spk)
    pad = int(spec["silence_s"] * SR)
    for s in range(n_spk):
        d = os.path.join(root, "wav48", f"p{s + 225:03d}")
        os.makedirs(d, exist_ok=True)
        for u in range(n_utt):
            k = s * n_utt + u
            t = np.arange(int(lengths[k] * SR)) / SR
            ph = rng.uniform(0, 2 * np.pi, 3)
            amp = rng.uniform(0.2, 0.5, 3)
            x = sum(a * np.sin(2 * np.pi * f0[s] * (h + 1) * t + p)
                    for h, (a, p) in enumerate(zip(amp, ph)))
            x *= 0.55 + 0.45 * np.sin(2 * np.pi * rng.uniform(3, 6) * t)
            x += 0.01 * rng.standard_normal(len(t))
            quiet = 0.002 * rng.standard_normal(2 * pad)
            x = np.concatenate([quiet[:pad], x / 1.5, quiet[pad:]])
            pcm = np.clip(x, -1.0, 1.0) * 32767.0
            wavfile.write(os.path.join(d, f"p{s + 225:03d}_{u + 1:03d}.wav"),
                          SR, pcm.astype(np.int16))
    return root

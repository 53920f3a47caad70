"""Synthetic training data (port of ``SineDataset`` in
``vqvae_tpu/audio/datasets.py``).

A jax-free copy: importing anything under ``vqvae_tpu`` imports JAX.
The same ``np.random.Generator`` gives the same samples as the JAX
package's class, bit for bit (``tests/test_torch_train_data.py``).
VCTK file datasets are not ported yet: the repository holds no corpus.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

from vqvae_tpu_torch.configs import DataConfig


class SineDataset:
    """Multi-'speaker' sine/harmonic data: speaker s has fundamental
    ``f0 * (s + 1)`` and a random phase."""

    def __init__(self, cfg: DataConfig, f0: float = 110.0):
        self.cfg = cfg
        self.f0 = f0

    def sample(self, rng: np.random.Generator) -> Tuple[np.ndarray, int]:
        need = self.cfg.length + 1
        spk = int(rng.integers(max(1, self.cfg.n_speakers)))
        f = self.f0 * (spk + 1)
        phase = rng.uniform(0, 2 * np.pi)
        t = np.arange(need, dtype=np.float32) / self.cfg.sr
        wav = (0.6 * np.sin(2 * np.pi * f * t + phase)
               + 0.3 * np.sin(4 * np.pi * f * t + 1.7 * phase))
        return wav.astype(np.float32), spk

    def full(self, i: int) -> Tuple[np.ndarray, int]:
        return self.sample(np.random.default_rng(i))

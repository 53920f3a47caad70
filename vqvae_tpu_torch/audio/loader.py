"""Deterministic batch stream (port of ``vqvae_tpu/audio/loader.py``).

Batch ``i`` is a pure function of ``(seed, i)``: its rows are drawn
from ``np.random.default_rng(SeedSequence([seed, i]))``, exactly the
JAX package's stream, so a run started at ``start_batch=N`` continues
where a straight run would be.  The iterator is synchronous: prefetch
threads wait until a profile shows the host holding the card back.
"""

from __future__ import annotations

from typing import Iterator, Tuple

import numpy as np


class BatchLoader:
    """Iterator of (wav ``[B, length+1]`` float32, speaker ``[B]`` int32)."""

    def __init__(self, dataset, batch_size: int, seed: int = 0,
                 start_batch: int = 0):
        self.dataset = dataset
        self.batch_size = batch_size
        self.seed = seed
        self.index = start_batch

    def make_batch(self, index: int) -> Tuple[np.ndarray, np.ndarray]:
        rng = np.random.default_rng(np.random.SeedSequence([self.seed,
                                                            index]))
        wavs, spks = zip(*(self.dataset.sample(rng)
                           for _ in range(self.batch_size)))
        return np.stack(wavs), np.asarray(spks, dtype=np.int32)

    def __iter__(self) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
        return self

    def __next__(self) -> Tuple[np.ndarray, np.ndarray]:
        batch = self.make_batch(self.index)
        self.index += 1
        return batch

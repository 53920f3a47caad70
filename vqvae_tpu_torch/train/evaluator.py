"""Deterministic validation (port of ``vqvae_tpu/train/evaluator.py``).

Validation is a reproducible function of the split, not of a random
stream: a fixed utterance list (dataset order), one centre crop per
utterance, iterated in fixed batches.  Two evaluations at different
steps score exactly the same windows.  On a mesh each rank scores its
rows of every batch (and its time slice under 'seq'), and the metrics
are the global batch's, as the JAX package shards its eval batches.
"""

from __future__ import annotations

import numpy as np
import torch

from vqvae_tpu_torch.configs import Config

# ceiling on the fixed windows when eval_batches == 0 asks for the whole
# split (a [n, length+1] float32 stack is held for the run)
MAX_EVAL_WINDOWS = 16384


def eval_windows(dataset, cfg: Config) -> tuple[np.ndarray, np.ndarray]:
    """The fixed eval set: one centre crop of ``length+1`` samples per
    utterance, in dataset order, the count rounded down to a whole
    number of batches (a split smaller than a batch cycles to fill
    one)."""
    B = cfg.train.batch_size
    cap = (cfg.train.eval_batches * B if cfg.train.eval_batches > 0
           else MAX_EVAL_WINDOWS)
    n = min(len(dataset), cap)
    n = max(B, (n // B) * B)
    need = cfg.data.length + 1
    wavs, spks = [], []
    for j in range(n):
        wav, spk = dataset.full(j % len(dataset))
        if len(wav) < need:
            wav = np.pad(wav, (0, need - len(wav)))
        start = (len(wav) - need) // 2
        wavs.append(wav[start:start + need].astype(np.float32))
        spks.append(spk)
    return np.stack(wavs), np.asarray(spks, np.int32)


class Evaluator:
    """Runs the fixed eval set through ``eval_step`` on ``device`` and
    returns ``val_*`` metric means over the whole set (every batch is
    full, so the mean of batch means is the per-window mean)."""

    def __init__(self, dataset, cfg: Config, device="cpu",
                 impl: str = "lax", mesh=None):
        self.cfg = cfg
        self.device = torch.device(device)
        self.impl = impl
        self.mesh = mesh
        self._dataset = dataset
        self._windows = None      # built at first use (decodes the split)

    @property
    def n_windows(self) -> int:
        """Size of the fixed eval set (built on first access)."""
        return len(self._eval_set()[0])

    def _eval_set(self):
        if self._windows is None:
            self._windows = eval_windows(self._dataset, self.cfg)
        return self._windows

    def __call__(self, params) -> dict:
        from vqvae_tpu_torch.parallel.distributed import put_global_batch
        from vqvae_tpu_torch.parallel.mesh import batch_sharding
        from vqvae_tpu_torch.train.step import eval_step
        wavs, spks = self._eval_set()
        B = self.cfg.train.batch_size
        rows = batch_sharding(self.mesh).rows(B)
        n_batches = len(wavs) // B
        acc: dict = {}
        for i in range(n_batches):
            wav, spk = put_global_batch(
                self.mesh, wavs[i * B:(i + 1) * B][rows],
                spks[i * B:(i + 1) * B][rows], device=self.device)
            m = eval_step(params, wav, spk, self.cfg, self.impl, self.mesh)
            for k, v in m.items():
                acc[k] = acc.get(k, 0.0) + float(v)
        return {f"val_{k}": v / n_batches for k, v in acc.items()}

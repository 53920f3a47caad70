"""Datasets (port of ``vqvae_tpu/audio/datasets.py``): the VCTK file
tree with per-utterance decoding, and a synthetic sine set.

A jax-free copy: importing anything under ``vqvae_tpu`` imports JAX.
The same ``np.random.Generator`` gives the same samples as the JAX
package's classes (``tests/test_torch_train_data.py``,
``tests/test_torch_vctk.py``).  The host side decodes, trims and crops
float audio; companding and framing happen on the device
(``audio/framing.py``).
"""

from __future__ import annotations

import os
import threading
from typing import List, Sequence, Tuple

import numpy as np

from vqvae_tpu_torch.audio.wav_io import load_wav, trim_silence
from vqvae_tpu_torch.configs import DataConfig


def scan_vctk(root: str, speaker: str | None = None
              ) -> Tuple[List[str], List[int], dict]:
    """(paths, speaker ids, speaker dict) of a VCTK-style tree:
    ``<root>/wav48/<speaker>/<utt>.wav`` (also ``wav16``, ``wav`` or
    speaker folders straight under the root; loose ``.wav`` files there
    belong to the speaker ``single``)."""
    wav_dirs = [os.path.join(root, d) for d in ("wav48", "wav16", "wav")
                if os.path.isdir(os.path.join(root, d))]
    if not wav_dirs:
        wav_dirs = [root]
    paths, spk_names = [], []
    for wd in wav_dirs:
        for entry in sorted(os.listdir(wd)):
            sub = os.path.join(wd, entry)
            if os.path.isdir(sub):
                if speaker is not None and entry != speaker:
                    continue
                for f in sorted(os.listdir(sub)):
                    if f.endswith(".wav"):
                        paths.append(os.path.join(sub, f))
                        spk_names.append(entry)
            elif entry.endswith(".wav"):
                paths.append(sub)
                spk_names.append("single")
    speakers = sorted(set(spk_names))
    spk_dict = {s: i for i, s in enumerate(speakers)}
    ids = [spk_dict[s] for s in spk_names]
    return paths, ids, spk_dict


class WavDataset:
    """Random crops of decoded, trimmed utterances.

    ``sample(rng)`` -> (float32 ``[length+1]``, speaker id).  Decoded
    audio is kept in a bounded cache (oldest entry out first) under a
    lock, since the loader's worker threads share the dataset."""

    def __init__(self, paths: Sequence[str], speaker_ids: Sequence[int],
                 cfg: DataConfig, cache_size: int = 4096):
        if len(paths) != len(speaker_ids) or not paths:
            raise ValueError("WavDataset needs one speaker id per path and "
                             "at least one path")
        self.paths = list(paths)
        self.speaker_ids = list(speaker_ids)
        self.cfg = cfg
        self._cache: dict = {}
        self._cache_size = cache_size
        self._cache_lock = threading.Lock()

    def __len__(self) -> int:
        return len(self.paths)

    def _decoded(self, i: int) -> np.ndarray:
        with self._cache_lock:
            wav = self._cache.get(i)
        if wav is None:
            wav = load_wav(self.paths[i], self.cfg.sr)
            wav = trim_silence(wav, self.cfg.top_db)
            with self._cache_lock:
                if len(self._cache) >= self._cache_size:
                    self._cache.pop(next(iter(self._cache)))
                self._cache[i] = wav
        return wav

    def sample(self, rng: np.random.Generator) -> Tuple[np.ndarray, int]:
        i = int(rng.integers(len(self.paths)))
        wav = self._decoded(i)
        need = self.cfg.length + 1
        if len(wav) < need:
            wav = np.pad(wav, (0, need - len(wav)))
        start = int(rng.integers(len(wav) - need + 1))
        return wav[start:start + need].astype(np.float32), \
            self.speaker_ids[i]

    def full(self, i: int) -> Tuple[np.ndarray, int]:
        """The whole trimmed utterance (the evaluator's path)."""
        return self._decoded(i), self.speaker_ids[i]


class SineDataset:
    """Multi-'speaker' sine/harmonic data: speaker s has fundamental
    ``f0 * (s + 1)`` and a random phase."""

    def __init__(self, cfg: DataConfig, f0: float = 110.0):
        self.cfg = cfg
        self.f0 = f0

    def __len__(self) -> int:
        # a nominal split size for the evaluator (training never asks)
        return 256

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


def train_valid_split(paths: Sequence[str], speaker_ids: Sequence[int],
                      valid_fraction: float, seed: int = 0):
    """Deterministic train/valid file split: ((train paths, ids),
    (valid paths, ids)), the first ``max(1, n·fraction)`` of a seeded
    permutation going to valid (none when the fraction is 0)."""
    n = len(paths)
    idx = np.random.default_rng(seed).permutation(n)
    n_valid = max(1, int(n * valid_fraction)) if valid_fraction > 0 else 0
    vset = set(idx[:n_valid].tolist())
    tr = [(paths[i], speaker_ids[i]) for i in range(n) if i not in vset]
    va = [(paths[i], speaker_ids[i]) for i in range(n) if i in vset]

    def unzip(ps):
        return [p[0] for p in ps], [p[1] for p in ps]
    return unzip(tr), unzip(va)

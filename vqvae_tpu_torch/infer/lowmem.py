"""Low-memory batched decode (port of ``vqvae_tpu/infer/lowmem.py``):
the audio-rate condition ``[B, T, d]`` is never held whole.

The JAX version computes each chunk's condition from a static window of
latent frames inside a nested scan.  Here the code frames go through a
``StreamingSynthesizer`` ``chunk_samples / hop`` frames at a time: the
upsampler's overlap-add carry makes each chunk's condition, and each
chunk is one resumable decode kernel call.  The noise is indexed by
absolute step, so the waveform equals one-shot ``decode_from_codes``
bit for bit, greedy and sampled.
"""

from __future__ import annotations

import torch

from vqvae_tpu_torch.configs import ModelConfig
from vqvae_tpu_torch.infer.streaming import StreamingSynthesizer


def decode_from_codes_lowmem(params, cfg: ModelConfig, codes: torch.Tensor,
                             speaker: torch.Tensor, seed: int = 0,
                             temperature: float = 1.0, greedy: bool = False,
                             chunk_samples: int = 1024, row0: int = 0
                             ) -> torch.Tensor:
    """Code ids ``[B, T_lat]`` -> float32 waveform ``[B, T_lat*hop]``,
    holding the condition of ``chunk_samples`` samples at a time;
    ``row0`` the global row of row 0."""
    if chunk_samples <= 0 or chunk_samples % cfg.hop:
        raise ValueError(f"chunk_samples {chunk_samples} must be a positive "
                         f"multiple of the hop {cfg.hop}")
    syn = StreamingSynthesizer(params, cfg, speaker, seed, temperature,
                               greedy, row0)
    step = chunk_samples // cfg.hop
    pieces = [syn.push(codes[:, i:i + step])
              for i in range(0, codes.shape[1], step)]
    pieces.append(syn.flush())
    return torch.cat(pieces, dim=1)

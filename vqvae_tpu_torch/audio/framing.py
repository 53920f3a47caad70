"""Input framing (port of ``vqvae_tpu/audio/framing.py``).

A raw float slice of ``length + 1`` samples becomes the encoder's
mu-law round-tripped waveform over samples ``[0, length)``, the
decoder's int class ids over the same samples, and the next-sample
targets ``[1, length]``.  The decoder consumes the ids directly (its
input layer is two embedding gathers), so no one-hot is built.

The WaveNet autoencoder (``models/wavenet_ae.py``) reads a scalar input
instead: magenta's mu-law (``mu_law_floor``) scaled to ``q / (mu/2)``.
Its encoder and its targets take samples ``[1, length]``, and its
decoder the sample before each target: magenta's ``shift_right`` of the
same crop, with the slice's own first sample in place of the zero.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from vqvae_tpu_torch.audio.mu_law import (
    mu_law_decode,
    mu_law_encode,
    mu_law_floor,
)


class Batch(NamedTuple):
    """One training batch, on the training device."""

    wav: torch.Tensor       # [B, T] float32 mu-law round trip
    ids_in: torch.Tensor    # [B, T] int32 ids x[0:T]
    targets: torch.Tensor   # [B, T] int32 ids x[1:T+1]
    speaker: torch.Tensor   # [B]    int64 speaker ids


def frame_batch(wav_slices: torch.Tensor, speaker: torch.Tensor,
                mu: int = 256, mulaw_mode: str = "round") -> Batch:
    """Raw float slices ``[B, length+1]`` -> a training ``Batch``."""
    ids = mu_law_encode(wav_slices, mu, mulaw_mode)
    wav_q = mu_law_decode(ids, mu, mode=mulaw_mode)
    return Batch(wav=wav_q[:, :-1], ids_in=ids[:, :-1], targets=ids[:, 1:],
                 speaker=speaker.long())


class ScalarBatch(NamedTuple):
    """One training batch of the WaveNet autoencoder, on the device."""

    xs_prev: torch.Tensor   # [B, T] float32 scaled input x[0:T]
    xs: torch.Tensor        # [B, T] float32 scaled input x[1:T+1]
    targets: torch.Tensor   # [B, T] int32 ids x[1:T+1]


def frame_scalar(wav_slices: torch.Tensor, mu: int = 256) -> ScalarBatch:
    """Raw float slices ``[B, length+1]`` -> a ``ScalarBatch``."""
    ids = mu_law_floor(wav_slices, mu)
    xs = (ids - mu // 2).to(torch.float32) / (mu // 2)
    return ScalarBatch(xs_prev=xs[:, :-1], xs=xs[:, 1:], targets=ids[:, 1:])

"""Mu-law companding (port of ``vqvae_tpu/audio/mu_law.py``).

Two binning modes, as in the JAX package: ``"round"`` (symmetric
rounding with a (mu-1) companding constant; decode is a fixed point of
encode) and ``"chainer"`` (the reference's digitize-style bins).  The
WaveNet autoencoder's input takes magenta's binning instead
(``mu_law_floor``).  Every function is elementwise, so any chunking of
a stream gives the same bits as the whole stream.
"""

from __future__ import annotations

import torch

MODES = ("round", "chainer")


def _check_mode(mode: str) -> None:
    if mode not in MODES:
        raise ValueError(f"mu-law mode must be one of {MODES}, got {mode!r}")


def mu_law_encode(x: torch.Tensor, mu: int = 256,
                  mode: str = "round") -> torch.Tensor:
    """Float waveform in [-1, 1] -> int32 mu-law class ids in [0, mu)."""
    _check_mode(mode)
    x = torch.clamp(x, -1.0, 1.0)
    if mode == "chainer":
        m = torch.tensor(float(mu), dtype=x.dtype, device=x.device)
        y = torch.sign(x) * torch.log1p(m * torch.abs(x)) / torch.log1p(m)
        ids = torch.floor((y + 1.0) * (mu / 2.0))
        return torch.clamp(ids.to(torch.int32), 0, mu - 1)
    m = torch.tensor(float(mu - 1), dtype=x.dtype, device=x.device)
    y = torch.sign(x) * torch.log1p(m * torch.abs(x)) / torch.log1p(m)
    return torch.round((y + 1.0) * 0.5 * m).to(torch.int32)


def mu_law_decode(ids: torch.Tensor, mu: int = 256,
                  dtype: torch.dtype = torch.float32,
                  mode: str = "round") -> torch.Tensor:
    """Integer class ids in [0, mu) -> float waveform in [-1, 1]."""
    _check_mode(mode)
    if mode == "chainer":
        m = torch.tensor(float(mu), dtype=dtype, device=ids.device)
        y = ids.to(dtype) * (2.0 / m) - 1.0
        x = torch.sign(y) / m * torch.expm1(torch.abs(y) * torch.log1p(m))
    else:
        m = torch.tensor(float(mu - 1), dtype=dtype, device=ids.device)
        y = ids.to(dtype) * (2.0 / m) - 1.0
        x = torch.sign(y) * torch.expm1(torch.abs(y) * torch.log1p(m)) / m
    # the ideal-math range is exactly [-1, 1]; rounding in expm1/log1p
    # can land the extreme ids 1 ulp outside it
    return torch.clamp(x, -1.0, 1.0)


def mu_law_round_trip(x: torch.Tensor, mu: int = 256,
                      mode: str = "round") -> torch.Tensor:
    """Quantize-dequantize: the input distribution every encode path
    sees (training framing, one-shot encode, streaming encode)."""
    return mu_law_decode(mu_law_encode(x, mu, mode), mu, mode=mode)


def mu_law_floor(x: torch.Tensor, mu: int = 256) -> torch.Tensor:
    """magenta's ``utils.mu_law`` (NSynth): ``q = floor(mu/2 * sign(x)
    ln(1 + (mu-1)|x|) / ln(mu))``, clipped to ``[-mu/2, mu/2 - 1]`` (it
    reaches ``mu/2`` at ``|x| = 1`` exactly), returned as int32 class
    ids ``q + mu/2`` in ``[0, mu)``."""
    half = mu // 2
    x = torch.clamp(x, -1.0, 1.0)
    m = torch.tensor(float(mu - 1), dtype=x.dtype, device=x.device)
    y = torch.sign(x) * torch.log1p(m * torch.abs(x)) / torch.log1p(m)
    q = torch.clamp(torch.floor(y * half), -half, half - 1)
    return (q + half).to(torch.int32)

"""Autoregressive synthesis (port of ``vqvae_tpu/infer/fastgen.py``).

Where the JAX package runs a ``lax.scan`` of ``decoder_step`` (or the
Pallas kernel), the port runs the fused decode kernel
(``kernels/decode_cuda``); on CPU tensors that is the kernel's plain
version, a loop of ``decoder_step``.  The scan's counterpart is that
plain version, not a second sampler.
"""

from __future__ import annotations

from typing import Tuple

import torch

from vqvae_tpu_torch.audio.mu_law import mu_law_decode, mu_law_round_trip
from vqvae_tpu_torch.configs import ModelConfig
from vqvae_tpu_torch.infer.streaming import CondUpsampler
from vqvae_tpu_torch.kernels import decode_cuda
from vqvae_tpu_torch.models.vqvae import encode
from vqvae_tpu_torch.models.wavenet import global_cond, make_gen_params


def generate_ids(params, cfg: ModelConfig, cond: torch.Tensor,
                 speaker: torch.Tensor, seed: int = 0,
                 temperature: float = 1.0, greedy: bool = False,
                 row0: int = 0) -> torch.Tensor:
    """Sample ``[B, T]`` int32 mu-law ids given cond ``[B, T, d]``;
    ``row0`` is the global row of row 0 (the noise's row)."""
    dec = params["decoder"]
    gp = make_gen_params(dec, cfg)
    gcond = global_cond(dec, cfg, speaker)
    return decode_cuda.generate_ids(gp, cfg, cond, gcond, seed,
                                    temperature, greedy, row0)


def teacher_forced_scan_logits(params, cfg: ModelConfig,
                               ids_in: torch.Tensor, cond: torch.Tensor,
                               speaker: torch.Tensor) -> torch.Tensor:
    """The generation step run on *given* inputs: logits
    ``[B, T, mu]``, which must equal ``apply_decoder``'s."""
    dec = params["decoder"]
    gp = make_gen_params(dec, cfg)
    gcond = global_cond(dec, cfg, speaker)
    return decode_cuda.teacher_logits(gp, cfg, ids_in, cond, gcond)


def encode_to_codes(params, cfg: ModelConfig, wav: torch.Tensor
                    ) -> torch.Tensor:
    """Waveform ``[B, T]`` -> code ids ``[B, T/hop]`` (int64)."""
    return encode(params, cfg, wav)


IMPLS = ("lax", "pallas", "lowmem")


def decode_from_codes(params, cfg: ModelConfig, codes: torch.Tensor,
                      speaker: torch.Tensor, seed: int = 0,
                      temperature: float = 1.0, greedy: bool = False,
                      impl: str = "lax", row0: int = 0) -> torch.Tensor:
    """Code ids ``[B, T_lat]`` -> float32 waveform ``[B, T_lat*hop]``.
    Ids must already be validated (``[0, K)``).  ``row0``: these are
    rows ``row0 ..`` of a larger batch, whose sampling noise they take
    (``infer/parallel.py``)."""
    if impl not in IMPLS:
        raise ValueError(f"unknown decode impl {impl!r} ({', '.join(IMPLS)})")
    if impl == "lowmem":
        from vqvae_tpu_torch.infer.lowmem import decode_from_codes_lowmem
        return decode_from_codes_lowmem(params, cfg, codes, speaker, seed,
                                        temperature, greedy, row0=row0)
    cond = CondUpsampler(params, cfg)(codes)
    ids = generate_ids(params, cfg, cond, speaker, seed, temperature,
                       greedy, row0)
    return mu_law_decode(ids, cfg.mu, mode=cfg.mulaw_mode)


def synthesize(params, cfg: ModelConfig, wav: torch.Tensor,
               speaker: torch.Tensor, seed: int = 0,
               temperature: float = 1.0, greedy: bool = False,
               impl: str = "lax") -> Tuple[torch.Tensor, torch.Tensor]:
    """waveform -> codes -> waveform.  Returns (wav ``[B, T']``, codes
    ``[B, T'/hop]``), T' = T rounded down to a multiple of the hop."""
    T = wav.shape[1] - (wav.shape[1] % cfg.hop)
    wav = mu_law_round_trip(wav[:, :T], cfg.mu, cfg.mulaw_mode)
    codes = encode_to_codes(params, cfg, wav)
    out = decode_from_codes(params, cfg, codes, speaker, seed, temperature,
                            greedy, impl)
    return out, codes

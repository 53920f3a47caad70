"""Serving decode through the fused kernel: the daemon's engine.

Counterpart of ``vqvae_tpu/infer/pallas_stream.py``
(``PallasStreamDecoder`` / ``PallasStreamSession``).
``KernelStreamDecoder`` is built once per daemon — weight repack
(``make_gen_params``) and the upsampler's per-code table happen in the
constructor — and answers a request with one resumable kernel call over
its whole condition.  ``KernelStreamSession`` decodes incrementally, for
live streams: each push runs the kernel over all the condition that push
finalized, carrying the decode state.

Exactness: the condition stream composes bit for bit under any slicing
(``infer/streaming.CondUpsampler``), the kernel's noise is indexed by
absolute step and the mu-law decode is elementwise, so a session's
concatenated output equals ``decode`` of the concatenated codes, greedy
and sampled.  The kernel takes any width, so unlike the TPU engine
nothing is cut into fixed slices or padded.
"""

from __future__ import annotations

import numpy as np
import torch

from vqvae_tpu_torch.audio.mu_law import mu_law_decode
from vqvae_tpu_torch.configs import ModelConfig
from vqvae_tpu_torch.infer.streaming import (
    CondUpsampler,
    StreamingSynthesizer,
)
from vqvae_tpu_torch.kernels import decode_cuda
from vqvae_tpu_torch.models.wavenet import global_cond, make_gen_params
from vqvae_tpu_torch.utils.profiling import span


def _check_codes(codes: np.ndarray, K: int) -> np.ndarray:
    """Host-side id validation, before any device indexing: an
    out-of-range gather on the card is a device assert that poisons
    the CUDA context (every later request would fail)."""
    codes = np.asarray(codes)
    if codes.ndim != 2:
        raise ValueError("codes must be [B, n]")
    if codes.size and (codes.min() < 0 or codes.max() >= K):
        raise ValueError(f"code ids must be in [0, {K})")
    return codes.astype(np.int64)


class KernelStreamDecoder:
    """Decode full code-id requests through the resumable kernel.  Build
    once, ``decode`` per request."""

    def __init__(self, params, cfg: ModelConfig):
        self.cfg = cfg
        self._dec = params["decoder"]
        self.device = params["vq"]["codebook"].device
        with torch.no_grad():
            self.gp = make_gen_params(self._dec, cfg)    # repack ONCE
            self._ups = CondUpsampler(params, cfg)       # table ONCE

    def _speaker(self, speaker) -> torch.Tensor:
        spk = np.asarray(speaker, np.int64).reshape(-1)
        n = max(self.cfg.n_speakers, 1)
        if spk.size and (spk.min() < 0 or spk.max() >= n):
            raise ValueError(f"speaker ids must be in [0, {n})")
        return torch.from_numpy(spk).to(self.device)

    def _prep(self, speaker):
        with torch.no_grad():
            return global_cond(self._dec, self.cfg, self._speaker(speaker))

    def _run(self, cond, gcond, seed, temperature, greedy, state):
        """One kernel call over ``cond`` -> (waveform [B, T] in host
        memory, state)."""
        with span("stream.decode"):
            ids, state = decode_cuda.generate_ids_resume(
                self.gp, self.cfg, cond, gcond, seed, temperature, state,
                greedy)
        with span("stream.readback"):      # the host waits for the kernel
            wav = mu_law_decode(ids, self.cfg.mu, mode=self.cfg.mulaw_mode)
            return wav.cpu(), state

    def decode(self, codes: np.ndarray, speaker, seed: int = 0,
               temperature: float = 1.0, greedy: bool = False) -> np.ndarray:
        """codes ``[B, n]``, speaker ``[B]`` -> ``[B, n*hop]`` float32."""
        with span("stream.upload"):
            codes = _check_codes(codes, self.cfg.K)
            gcond = self._prep(speaker)
            if codes.shape[0] != gcond.shape[1]:
                raise ValueError("codes must be [B, n] with B matching the "
                                 f"speakers' {gcond.shape[1]}")
            ids = torch.from_numpy(codes).to(self.device)
        with torch.no_grad():
            with span("stream.upsample"):
                cond = self._ups(ids)
            state = decode_cuda.init_decode_state(
                self.cfg, codes.shape[0], self.gp.wff.dtype, self.device)
            wav, _ = self._run(cond, gcond, seed, temperature, greedy, state)
        return wav.numpy()

    def session(self, speaker, seed: int = 0, temperature: float = 1.0,
                greedy: bool = False) -> "KernelStreamSession":
        """An incremental decode session sharing this decoder's weights."""
        return KernelStreamSession(self, speaker, seed, temperature, greedy)


class KernelStreamSession:
    """Incremental decode: ``push`` code frames of any size as they
    arrive and get the waveform each push finalizes; ``close`` flushes
    the tail.  A ``StreamingSynthesizer`` on the decoder's packed
    weights, with host-side id validation and numpy in and out."""

    def __init__(self, dec: KernelStreamDecoder, speaker, seed: int = 0,
                 temperature: float = 1.0, greedy: bool = False):
        self.dec = dec
        # a private stream on the shared table: the decoder's own
        # upsampler is reset per request
        self._syn = StreamingSynthesizer.from_parts(
            dec.cfg, dec.gp, dec._prep(speaker), dec._ups.fork(), seed,
            temperature, greedy)
        self._closed = False

    def push(self, codes: np.ndarray) -> np.ndarray:
        """codes ``[B, n]`` -> the newly finalized ``[B, m]`` waveform
        (``n*hop`` samples, ``hop//2`` fewer on the first push)."""
        if self._closed:
            raise ValueError("session is closed")
        with span("stream.upload"):
            codes = _check_codes(codes, self.dec.cfg.K)
            ids = torch.from_numpy(codes).to(self.dec.device)
        return self._syn.push(ids, host=True).numpy()

    def close(self) -> np.ndarray:
        """Flush the upsampler tail; the session is then unusable."""
        if self._closed:
            raise ValueError("session is closed")
        self._closed = True
        return self._syn.flush(host=True).numpy()

"""Chunked local-condition upsampling and streaming synthesis (port of
``vqvae_tpu/infer/streaming.py``: ``CondUpsampler``,
``StreamingSynthesizer``).

The upsampler is a stride-``hop`` transposed conv with a ``2*hop``-tap
kernel: the VALID output is ``v[p*hop + r] += e[p] @ wf[r]`` (``wf``
the time-flipped kernel, as ``lax.conv_transpose`` applies it), and
SAME crops ``hop//2`` samples from the front.  The latents are codebook
rows, so the taps of code k are a per-code table
``P[k] = cdt(codebook[k] @ wf)`` of shape ``[K, 2*hop, d]``, built once
in the constructor.  A push is then a gather plus an overlap-add in the
compute dtype: each output sample is one add of two table entries (from
frames p and p-1), whatever the push width.  A matrix product per push
would not give that: oneDNN and cuBLAS choose their blocking by shape,
so the condition samples, and the decode after them, would depend on
how a stream was cut.  So chunked output equals the one-shot output
bit for bit.

``StreamingSynthesizer`` feeds that condition to resumable decode
kernel calls (``kernels/decode_cuda.generate_ids_resume``), whose noise
is indexed by absolute step, so any split of a stream into pushes gives
the waveform of one-shot ``infer/fastgen.decode_from_codes``, greedy
and sampled.  What it holds is the decode state and the upsampler's
one-hop carry, whatever the stream's length.
"""

from __future__ import annotations

import torch

from vqvae_tpu_torch.audio.mu_law import mu_law_decode
from vqvae_tpu_torch.configs import ModelConfig
from vqvae_tpu_torch.kernels import decode_cuda
from vqvae_tpu_torch.models.wavenet import global_cond, make_gen_params
from vqvae_tpu_torch.ops.conv import matmul
from vqvae_tpu_torch.utils.profiling import span


class CondUpsampler:
    """Push code frames, get the condition samples each push finalizes.
    Shared by the kernel serving decoder (``infer/kernel_stream``)."""

    def __init__(self, params, cfg: ModelConfig):
        # the carry is one hop and the SAME crop hop/2 only for a kernel
        # of exactly 2*hop taps
        if cfg.upsample_kernel_mult != 2:
            raise ValueError("CondUpsampler needs upsample_kernel_mult == 2, "
                             f"got {cfg.upsample_kernel_mult}")
        self.cfg = cfg
        up = params["decoder"]["upsample"]
        self.up_b = up["b"].detach().to(cfg.cdtype)
        w = up["w"].detach()                              # [2hop, d, d]
        K2, cin, cout = w.shape
        wf = torch.flip(w, (0,)).permute(1, 0, 2).reshape(cin, K2 * cout)
        cb = params["vq"]["codebook"].detach()
        self.table = matmul(cb, wf, cfg.cdtype).reshape(-1, K2, cout)
        self._carry = None                                # [B, hop, d]
        self._first = True

    def fork(self) -> "CondUpsampler":
        """A fresh stream sharing this one's table (no rebuild)."""
        up = CondUpsampler.__new__(CondUpsampler)
        up.cfg, up.up_b, up.table = self.cfg, self.up_b, self.table
        up._carry, up._first = None, True
        return up

    def reset(self) -> None:
        """Back to stream start (a new request on a reused instance)."""
        self._carry, self._first = None, True

    @property
    def started(self) -> bool:
        return not self._first

    def push(self, codes: torch.Tensor) -> torch.Tensor:
        """codes ``[B, C]`` (validated ids) -> ``[B, C*hop, d]`` condition
        samples (``hop//2`` fewer on the first push)."""
        hop = self.cfg.hop
        B, C = codes.shape
        taps = self.table[codes.long()]                   # [B, C, 2hop, d]
        head, tail = taps[:, :, :hop], taps[:, :, hop:]
        if C == 0:
            return head.reshape(B, 0, head.shape[-1])
        prev = tail[:, :-1]
        if self._carry is not None:
            prev = torch.cat([self._carry[:, None], prev], dim=1)
            v = head + prev
        else:
            v = torch.cat([head[:, :1], head[:, 1:] + prev], dim=1)
        self._carry = tail[:, -1]
        out = v.reshape(B, C * hop, -1)
        if self._first:
            out = out[:, hop // 2:]
            self._first = False
        return out + self.up_b

    def flush(self) -> torch.Tensor:
        """The final ``hop - hop//2`` samples (the SAME-crop tail)."""
        hop = self.cfg.hop
        assert self._carry is not None, "flush before any push"
        cond = self._carry[:, :hop - hop // 2] + self.up_b
        self._carry = None
        return cond

    def __call__(self, codes: torch.Tensor) -> torch.Tensor:
        """One-shot: a whole code sequence ``[B, n]`` -> ``[B, n*hop, d]``
        (== pushing it in any slices, then flushing)."""
        self.reset()
        out = torch.cat([self.push(codes), self.flush()], dim=1)
        self.reset()
        return out


class StreamingSynthesizer:
    """Push VQ code frames, pull waveform.

    >>> s = StreamingSynthesizer(params, cfg, speaker, seed)
    >>> pieces = [s.push(codes_chunk) for codes_chunk in chunks]
    >>> pieces.append(s.flush())

    ``speaker`` is ``[B]`` on the parameters' device; codes must be
    valid ids (``[0, K)``); ``row0`` is the global row of row 0 (the
    sampling noise's row, for a shard of a larger batch).  Each push returns the float32 waveform
    ``[B, m]`` it finalized (``n*hop`` samples for n frames, ``hop//2``
    fewer on the first push); ``flush`` the last ``hop - hop//2``."""

    def __init__(self, params, cfg: ModelConfig, speaker: torch.Tensor,
                 seed: int = 0, temperature: float = 1.0,
                 greedy: bool = False, row0: int = 0):
        dec = params["decoder"]
        with torch.no_grad():
            self._setup(cfg, make_gen_params(dec, cfg),
                        global_cond(dec, cfg, speaker),
                        CondUpsampler(params, cfg), seed, temperature,
                        greedy, row0)

    @classmethod
    def from_parts(cls, cfg: ModelConfig, gp, gcond: torch.Tensor,
                   upsampler: CondUpsampler, seed: int = 0,
                   temperature: float = 1.0, greedy: bool = False,
                   row0: int = 0) -> "StreamingSynthesizer":
        """A stream on weights packed once elsewhere (the serving
        decoder's): ``gp``, ``gcond`` ``[L, B, 2R]`` and a fresh
        upsampler stream."""
        syn = cls.__new__(cls)
        syn._setup(cfg, gp, gcond, upsampler, seed, temperature, greedy,
                   row0)
        return syn

    def _setup(self, cfg, gp, gcond, upsampler, seed, temperature, greedy,
               row0):
        self.cfg, self.gp, self.gcond, self._ups = cfg, gp, gcond, upsampler
        self.seed, self.temperature, self.greedy = seed, temperature, greedy
        self.row0 = row0
        self.state = decode_cuda.init_decode_state(
            cfg, gcond.shape[1], gp.wff.dtype, gcond.device)

    def _decode(self, cond: torch.Tensor, host: bool) -> torch.Tensor:
        with torch.no_grad(), span("stream.decode"):
            ids, self.state = decode_cuda.generate_ids_resume(
                self.gp, self.cfg, cond, self.gcond, self.seed,
                self.temperature, self.state, self.greedy, self.row0)
        with span("stream.readback"):      # the host waits for the kernel
            wav = mu_law_decode(ids, self.cfg.mu, mode=self.cfg.mulaw_mode)
            return wav.cpu() if host else wav

    def push(self, codes: torch.Tensor, host: bool = False) -> torch.Tensor:
        """codes ``[B, n]`` -> the waveform this push finalized (in host
        memory with ``host``)."""
        with torch.no_grad(), span("stream.upsample"):
            cond = self._ups.push(codes)
        return self._decode(cond, host)

    def flush(self, host: bool = False) -> torch.Tensor:
        """The final ``hop - hop//2`` samples (the SAME-crop tail); empty
        when nothing was pushed."""
        if not self._ups.started:
            return torch.zeros((self.gcond.shape[1], 0),
                               device="cpu" if host else self.gcond.device)
        with torch.no_grad(), span("stream.upsample"):
            cond = self._ups.flush()
        return self._decode(cond, host)

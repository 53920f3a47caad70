"""Top-level VQ-VAE (port of ``vqvae_tpu/models/vqvae.py``): init,
encode and the training forward.

loss1 = softmax cross-entropy of the decoder logits vs next-sample ids
loss2 = ||sg(z_e) - e||^2                      (codebook, off under EMA)
loss3 = ||z_e - sg(e)||^2, weighted by beta     (commitment)
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch

from vqvae_tpu_torch.audio.framing import Batch
from vqvae_tpu_torch.configs import ModelConfig
from vqvae_tpu_torch.models import vq as vq_mod
from vqvae_tpu_torch.models.encoder import apply_encoder, init_encoder
from vqvae_tpu_torch.models.params import ParamTree
from vqvae_tpu_torch.models.vq import init_vq, nearest_code, quantize, \
    vq_losses
from vqvae_tpu_torch.models.wavenet import (
    _head,
    decoder_skips,
    init_decoder,
    upsample_cond,
)


def init_model(cfg: ModelConfig, generator: torch.Generator | None = None,
               device="cpu", trainable: bool = False) -> ParamTree:
    """Random weights with the JAX package's shapes and scales (not its
    bits).  Draws on ``generator``'s device, then moves to ``device``;
    ``device="meta"`` gives a shape-only template.  ``trainable`` makes
    every leaf require grad (training); serving keeps them frozen."""
    if str(device) == "meta":
        generator = None
    return ParamTree({
        "encoder": init_encoder(cfg, generator, device),
        "vq": init_vq(cfg, generator, device),
        "decoder": init_decoder(cfg, generator, device),
    }, trainable)


def init_vq_state(params) -> vq_mod.VQState:
    return vq_mod.init_vq_state(params["vq"])


def encode(params, cfg: ModelConfig, wav: torch.Tensor,
           impl: str = "lax") -> torch.Tensor:
    """Waveform ``[B, T]`` -> code ids ``[B, T/hop]``; ``impl`` picks
    the search (``models/vq.py::nearest_code``)."""
    z = apply_encoder(params["encoder"], cfg, wav)
    return nearest_code(z, params["vq"]["codebook"].to(z.dtype), impl)


def forward(params, cfg: ModelConfig, batch: Batch, impl: str = "lax"
            ) -> Tuple[torch.Tensor, Tuple[Dict, Dict]]:
    """Training forward: (total loss, (metrics, aux)).  Metric names
    follow the reference's reports (loss1/loss2/loss3); ``impl`` picks
    the VQ search.  The JAX package's sequence-parallel branch is not
    ported (ROADMAP A8)."""
    z = apply_encoder(params["encoder"], cfg, batch.wav)   # [B, Tl, d] f32
    e_st, e, idx = quantize(params["vq"], z, impl)
    loss2, loss3 = vq_losses(z, e)
    cond = upsample_cond(params["decoder"], cfg, e_st)     # [B, T, d]
    skips = decoder_skips(params["decoder"], cfg, batch.ids_in, cond,
                          batch.speaker)
    if cfg.head_kernel == "pallas":
        from vqvae_tpu_torch.kernels.head_ce_cuda import head_ce_loss
        loss1 = head_ce_loss(params["decoder"], cfg, skips, batch.targets)
    elif cfg.head_kernel == "xla":
        logits = _head(params["decoder"], cfg, skips)      # [B, T, mu] f32
        logz = torch.logsumexp(logits, dim=-1)
        picked = logits.gather(-1, batch.targets.long()[..., None])[..., 0]
        loss1 = torch.mean(logz - picked)
    else:
        raise ValueError(f"unknown head_kernel {cfg.head_kernel!r}")
    if cfg.ema:
        loss = loss1 + cfg.beta * loss3
    else:
        loss = loss1 + loss2 + cfg.beta * loss3
    with torch.no_grad():
        used = torch.zeros(cfg.K, dtype=torch.float32, device=idx.device)
        used[idx.reshape(-1)] = 1.0
        metrics = {"loss": loss.detach(), "loss1": loss1.detach(),
                   "loss2": loss2.detach(), "loss3": loss3.detach(),
                   "codebook_usage": used.mean(),
                   "code_perplexity": vq_mod.code_perplexity(idx, cfg.K)}
    return loss, (metrics, {"indices": idx, "z": z.detach()})

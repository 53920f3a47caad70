"""Strided-conv encoder (port of ``vqvae_tpu/models/encoder.py``):
stride-2 kernel-4 SAME convs with ReLU, then a 1x1 projection to the
latent dim ``d``.  ``encoder_kernel="pallas"`` runs layers 2..L and the
projection through the fused encoder kernel
(``kernels/encoder_cuda.py``)."""

from __future__ import annotations

from typing import Dict

import torch

from vqvae_tpu_torch.configs import ModelConfig
from vqvae_tpu_torch.ops.conv import (
    conv1d_init,
    dense_init,
    matmul,
    strided_conv_apply,
)


def init_encoder(cfg: ModelConfig, generator=None, device="cpu") -> Dict:
    layers, in_ch = [], 1
    for _ in range(cfg.enc_layers):
        layers.append(conv1d_init(in_ch, cfg.enc_channels, cfg.enc_kernel,
                                  cfg.pdtype, generator, device))
        in_ch = cfg.enc_channels
    proj = dense_init(cfg.enc_channels, cfg.d, cfg.pdtype, generator, device)
    return {"layers": layers, "proj": proj}


def apply_encoder(params, cfg: ModelConfig, wav: torch.Tensor
                  ) -> torch.Tensor:
    """``[B, T]`` waveform -> z_e ``[B, T/hop, d]`` in float32."""
    if cfg.encoder_kernel == "pallas":
        from vqvae_tpu_torch.kernels.encoder_cuda import encoder_fused
        return encoder_fused(params, cfg, wav)
    if cfg.encoder_kernel != "xla":
        raise ValueError(f"unknown encoder_kernel {cfg.encoder_kernel!r} "
                         "(xla or pallas)")
    cdt = cfg.cdtype
    x = wav[..., None].to(cdt)
    for layer in params["layers"]:
        x = torch.relu(strided_conv_apply(layer, x, cfg.enc_stride, cdt))
    z = matmul(x, params["proj"]["w"], cdt) + params["proj"]["b"].to(cdt)
    # z_e in float32: distances are taken in full precision whatever
    # the conv compute dtype
    return z.to(torch.float32)

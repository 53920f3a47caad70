"""Strided-conv encoder (port of ``vqvae_tpu/models/encoder.py``, the
``encoder_kernel="xla"`` path): stride-2 kernel-4 SAME convs with ReLU,
then a 1x1 projection to the latent dim ``d``."""

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
    if cfg.encoder_kernel != "xla":
        raise NotImplementedError(
            f"encoder_kernel={cfg.encoder_kernel!r} (the fused encoder) is "
            "not ported yet (ROADMAP B11); use 'xla'")
    cdt = cfg.cdtype
    x = wav[..., None].to(cdt)
    for layer in params["layers"]:
        x = torch.relu(strided_conv_apply(layer, x, cfg.enc_stride, cdt))
    z = matmul(x, params["proj"]["w"], cdt) + params["proj"]["b"].to(cdt)
    # z_e in float32: distances are taken in full precision whatever
    # the conv compute dtype
    return z.to(torch.float32)

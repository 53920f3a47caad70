"""Analytic FLOP count of the training step (port of
``vqvae_tpu/utils/flops.py``).

A profiler sees only the kernels' time, not their work, so the share of
a step that reaches the card's peak (MFU) is taken against this count.

The card's peaks live here, once, for every bound and share of peak the
port prints (``chip_smoke.py``, ``measure/``): NVIDIA's data sheet for
the H100 SXM, dense rates, at the full 700 W power limit.
"""

from __future__ import annotations

from vqvae_tpu_torch.configs import Config

PEAK_FLOPS = 989e12     # H100 SXM dense bf16 tensor-core rate
PEAK_F32 = 67e12        # H100 SXM float32 rate outside the tensor cores
PEAK_F64_TC = 67e12     # H100 SXM float64 tensor-core rate (DMMA)
PEAK_BYTES = 3.35e12    # H100 SXM HBM3 bytes/s


def train_step_flops(cfg: Config, batch: int) -> float:
    """FLOPs of one train step (forward + ~2x backward) at ``batch``."""
    m = cfg.model
    T = cfg.data.length
    R, S, d, mu = (m.residual_channels, m.skip_channels, m.d, m.mu)
    L = m.n_layers_total
    # decoder per sample per layer: 2-tap dilated conv (2*R*2R MACs),
    # local cond (d*2R), residual (R*R), skip (R*S)
    dec = L * (2 * R * 2 * R + d * 2 * R + R * R + R * S)
    head = S * S + S * mu
    emb = 2 * R  # gathers, negligible
    # encoder: stride-2 convs at geometrically decreasing T + 1x1 proj
    enc = 0.0
    ch_in = 1
    t = T
    for _ in range(m.enc_layers):
        t //= m.enc_stride
        enc += t * m.enc_kernel * ch_in * m.enc_channels / T
        ch_in = m.enc_channels
    enc += (T // m.hop) * m.enc_channels * d / T
    # upsample: kernel 2*hop, stride hop -> 2 taps per output sample
    ups = 2 * d * d
    # VQ distance matmul at latent rate
    vq = (m.K * d) / m.hop
    macs_per_sample = dec + head + emb + enc + ups + vq
    fwd = 2.0 * macs_per_sample * batch * T  # 2 FLOPs per MAC
    return 3.0 * fwd

"""One training update (port of ``vqvae_tpu/train/step.py``).

Order, as in the JAX package: framing -> forward and backward -> Adam
-> EMA codebook update -> dead-code restart.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional

import torch

from vqvae_tpu_torch.audio.framing import frame_batch
from vqvae_tpu_torch.configs import Config
from vqvae_tpu_torch.models import forward
from vqvae_tpu_torch.models.vq import (
    ema_update,
    restart_dead_codes,
    restart_picks,
    usage_update,
)
from vqvae_tpu_torch.train.state import TrainState

# picks(step, n_rows, K, device) -> the K rows restart_dead_codes draws
PicksFn = Callable[[int, int, int, torch.device], torch.Tensor]


def train_step(state: TrainState, wav: torch.Tensor, speaker: torch.Tensor,
               cfg: Config, picks: Optional[PicksFn] = None,
               impl: str = "lax") -> Dict[str, torch.Tensor]:
    """One update in place.  wav ``[B, length+1]`` raw float slices,
    speaker ``[B]``, both on the training device; ``impl`` picks the VQ
    search.  Returns the metrics as 0-d tensors (reading them
    synchronises with the device)."""
    mcfg = cfg.model
    batch = frame_batch(wav, speaker, mcfg.mu, mcfg.mulaw_mode)
    state.opt.zero_grad(set_to_none=True)
    loss, (metrics, aux) = forward(state.params, mcfg, batch, impl)
    loss.backward()
    state.opt.step()
    thr = mcfg.code_restart_threshold
    if mcfg.ema or thr > 0:
        z, idx = aux["z"], aux["indices"]
        vq = state.params["vq"]
        if mcfg.ema:
            new, vq_state = ema_update(vq, state.vq_state, z, idx, mcfg)
        else:
            new, vq_state = {"codebook": vq["codebook"]}, usage_update(
                state.vq_state, idx, mcfg)
        if thr > 0:
            n_rows = z.reshape(-1, z.shape[-1]).shape[0]
            rows = (picks or _default_picks(cfg))(state.step, n_rows,
                                                  mcfg.K, z.device)
            new, vq_state = restart_dead_codes(new, vq_state, z, rows, mcfg)
        with torch.no_grad():
            vq["codebook"].copy_(new["codebook"])
        state.vq_state = vq_state
    state.step += 1
    return metrics


def _default_picks(cfg: Config) -> PicksFn:
    def picks(step, n_rows, K, device):
        return restart_picks(cfg.train.seed, step, n_rows, K, device)
    return picks


@torch.no_grad()
def eval_step(params, wav: torch.Tensor, speaker: torch.Tensor,
              cfg: Config, impl: str = "lax") -> Dict[str, torch.Tensor]:
    """Validation forward: the same forward, no update."""
    batch = frame_batch(wav, speaker, cfg.model.mu, cfg.model.mulaw_mode)
    _, (metrics, _) = forward(params, cfg.model, batch, impl)
    return metrics

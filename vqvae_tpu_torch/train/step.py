"""One training update (port of ``vqvae_tpu/train/step.py``).

Order, as in the JAX package: framing -> forward and backward -> Adam
-> EMA codebook update -> dead-code restart; each phase is a span of
``train.step`` (``utils/profiling.py``).  On a mesh
(``state.par``, ``parallel/step.py``) the gradients are averaged over
the ranks before Adam, the EMA and the restart see the global batch, the
updated shards are gathered into the full weights, and the metrics are
the global batch's; the decoder stack runs sequence-parallel when the
mesh has a 'seq' axis.

A config whose model is the WaveNet autoencoder's
(``configs/wavenet_ae.py``) takes ``_wavenet_ae_step``: the same phases
and spans with its own framing and forward, and no codebook.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional

import torch

from vqvae_tpu_torch.audio.framing import frame_batch, frame_scalar
from vqvae_tpu_torch.configs import Config, WaveNetAEConfig
from vqvae_tpu_torch.models import forward, wavenet_ae
from vqvae_tpu_torch.models.vq import (
    ema_update,
    restart_dead_codes,
    restart_picks,
    usage_update,
)
from vqvae_tpu_torch.train.state import TrainState
from vqvae_tpu_torch.utils.profiling import span

# picks(step, n_rows, K, device) -> the K rows restart_dead_codes draws
PicksFn = Callable[[int, int, int, torch.device], torch.Tensor]


def train_step(state: TrainState, wav: torch.Tensor, speaker: torch.Tensor,
               cfg: Config, picks: Optional[PicksFn] = None,
               impl: str = "lax") -> Dict[str, torch.Tensor]:
    """One update in place.  wav ``[B, length+1]`` raw float slices,
    speaker ``[B]``, both on the training device (on a mesh: this rank's
    rows); ``impl`` picks the VQ search.  Returns the metrics as 0-d
    tensors, the autoencoder's with ``crop_loss`` besides (reading them
    synchronises with the device)."""
    if isinstance(cfg.model, WaveNetAEConfig):
        return _wavenet_ae_step(state, wav, cfg)
    mcfg = cfg.model
    par = state.par
    mesh = None if par is None else par.mesh
    with span("train.step"):
        with span("train.frame"):
            batch = frame_batch(wav, speaker, mcfg.mu, mcfg.mulaw_mode)
        with span("train.zero_grad"):
            state.opt.zero_grad(set_to_none=True)
        with span("train.forward"):
            loss, (metrics, aux) = forward(state.params, mcfg, batch, impl,
                                           mesh)
        with span("train.backward"):
            loss.backward()
            if par is not None:
                par.reduce_grads()
        with span("train.optimizer"):
            state.opt.step()
        thr = mcfg.code_restart_threshold
        if mcfg.ema or thr > 0:
            with span("train.codebook"):
                _codebook_update(state, aux, cfg, picks)
        if par is not None:
            par.gather_params()
            from vqvae_tpu_torch.parallel.step import global_metrics
            metrics = global_metrics(mesh, metrics, aux["indices"], mcfg.K)
    state.step += 1
    return metrics


def _wavenet_ae_step(state: TrainState, wav: torch.Tensor, cfg: Config
                     ) -> Dict[str, torch.Tensor]:
    """One update of the WaveNet autoencoder (speaker ids unread); its
    metrics also hold each crop's loss, ``crop_loss [B]``."""
    with span("train.step"):
        with span("train.frame"):
            batch = frame_scalar(wav, cfg.model.mu)
        with span("train.zero_grad"):
            state.opt.zero_grad(set_to_none=True)
        with span("train.forward"):
            loss, metrics = wavenet_ae.forward(state.params, cfg.model,
                                               batch)
        with span("train.backward"):
            loss.backward()
        with span("train.optimizer"):
            state.opt.step()
    state.step += 1
    return metrics


def _codebook_update(state: TrainState, aux: Dict, cfg: Config,
                     picks: Optional[PicksFn]) -> None:
    """The EMA codebook update or usage count, then the dead-code
    restart, written into the codebook (this rank's shard on a mesh)."""
    mcfg, par = cfg.model, state.par
    thr = mcfg.code_restart_threshold
    z, idx = aux["z"], aux["indices"]
    cb = (state.params["vq"]["codebook"] if par is None
          else par.codebook_shard())
    if mcfg.ema:
        new, vq_state = ema_update({"codebook": cb}, state.vq_state, z, idx,
                                   mcfg, par)
    else:
        new, vq_state = {"codebook": cb}, usage_update(
            state.vq_state, idx, mcfg, par)
    if thr > 0:
        n_rows = z.reshape(-1, z.shape[-1]).shape[0]
        if par is not None:
            n_rows = par.global_rows(n_rows)
        rows = (picks or _default_picks(cfg))(state.step, n_rows, mcfg.K,
                                              z.device)
        new, vq_state = restart_dead_codes(new, vq_state, z, rows, mcfg, par)
    with torch.no_grad():
        cb.copy_(new["codebook"])
    state.vq_state = vq_state


def _default_picks(cfg: Config) -> PicksFn:
    def picks(step, n_rows, K, device):
        return restart_picks(cfg.train.seed, step, n_rows, K, device)
    return picks


@torch.no_grad()
def eval_step(params, wav: torch.Tensor, speaker: torch.Tensor,
              cfg: Config, impl: str = "lax", mesh=None
              ) -> Dict[str, torch.Tensor]:
    """Validation forward: the same forward, no update; on a ``mesh``
    (this rank's rows) the global batch's metrics."""
    if isinstance(cfg.model, WaveNetAEConfig):
        loss, _ = wavenet_ae.forward(params, cfg.model,
                                     frame_scalar(wav, cfg.model.mu))
        return {"loss": loss}
    batch = frame_batch(wav, speaker, cfg.model.mu, cfg.model.mulaw_mode)
    _, (metrics, aux) = forward(params, cfg.model, batch, impl, mesh)
    if mesh is not None:
        from vqvae_tpu_torch.parallel.step import global_metrics
        metrics = global_metrics(mesh, metrics, aux["indices"], cfg.model.K)
    return metrics

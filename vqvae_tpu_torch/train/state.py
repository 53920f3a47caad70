"""Train state (port of ``vqvae_tpu/train/state.py``): parameters, the
Adam optimizer, the step counter and the EMA-codebook accumulators.

optax's ``adam`` and ``torch.optim.Adam`` compute the same update (bias
correction on both moments, eps added outside the square root).  The
JAX package scales the codebook's Adam update by ``codebook_lr_mult``;
here the codebook is its own parameter group at ``lr * mult``, which is
the same update.  Under EMA the codebook receives no gradient, so Adam
leaves it alone.  Adam's moments start at zero (they are not carried
across frameworks).
"""

from __future__ import annotations

import dataclasses

import torch

from vqvae_tpu_torch.configs import Config
from vqvae_tpu_torch.models import init_model, init_vq_state
from vqvae_tpu_torch.models.vq import VQState


@dataclasses.dataclass
class TrainState:
    step: int
    params: torch.nn.Module
    opt: torch.optim.Optimizer
    vq_state: VQState


def make_optimizer(cfg: Config, params: torch.nn.Module) -> torch.optim.Adam:
    t = cfg.train
    cb = params["vq"]["codebook"]
    rest = [p for p in params.parameters() if p is not cb]
    return torch.optim.Adam(
        [{"params": rest}, {"params": [cb], "lr": t.lr * t.codebook_lr_mult}],
        lr=t.lr, betas=(t.adam_b1, t.adam_b2), eps=t.adam_eps)


def create_train_state(cfg: Config, device="cpu", params=None) -> TrainState:
    """Fresh state; ``params`` (a trainable ``ParamTree``) defaults to
    the port's seeded init on the CPU generator ``cfg.train.seed``."""
    if params is None:
        params = init_model(cfg.model,
                            torch.Generator().manual_seed(cfg.train.seed),
                            device, trainable=True)
    return TrainState(step=0, params=params,
                      opt=make_optimizer(cfg, params),
                      vq_state=init_vq_state(params))

"""Training loop on one device (port of ``vqvae_tpu/train/loop.py``).

Per step: the next batch of the deterministic stream (batch ``i`` is a
pure function of ``(seed, i)``), moved to the device, one
``train_step``.  Logs at ``log_every`` (and the first step), exports
the weights to ``<out>/weights.npz`` at ``checkpoint_every`` and at the
end.  Interval rates are read on the host clock after a
``torch.cuda.synchronize()``.  Resume, the evaluator and meshes wait
for ROADMAP A6 and A8.
"""

from __future__ import annotations

import os
import time
from typing import Optional

import torch

from vqvae_tpu_torch.audio.loader import BatchLoader
from vqvae_tpu_torch.configs import Config
from vqvae_tpu_torch.configs.presets import config_to_json
from vqvae_tpu_torch.train.checkpoint import export_weights
from vqvae_tpu_torch.train.metrics import MetricsLogger
from vqvae_tpu_torch.train.state import TrainState, create_train_state
from vqvae_tpu_torch.train.step import train_step


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def train(cfg: Config, dataset, out_dir: Optional[str] = None,
          num_steps: Optional[int] = None, device="cuda",
          echo: bool = True) -> TrainState:
    """Run training from the seeded init; returns the final state."""
    device = torch.device(device)
    out_dir = out_dir or cfg.train.out_dir
    num_steps = cfg.train.num_steps if num_steps is None else num_steps
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, "config.json"), "w") as f:
        f.write(config_to_json(cfg))
    state = create_train_state(cfg, device)
    loader = BatchLoader(dataset, cfg.train.batch_size, seed=cfg.train.seed,
                         start_batch=state.step)
    logger = MetricsLogger(out_dir)
    weights = os.path.join(out_dir, "weights.npz")
    _sync(device)
    start = state.step
    t_last, step_last = time.perf_counter(), start
    try:
        while state.step < num_steps:
            wav, spk = next(loader)
            metrics = train_step(state, torch.from_numpy(wav).to(device),
                                 torch.from_numpy(spk).to(device), cfg)
            step = state.step
            if step % cfg.train.log_every == 0 or step == start + 1:
                rec = {k: float(v) for k, v in metrics.items()}
                _sync(device)
                now = time.perf_counter()
                rec["steps_per_sec"] = (step - step_last) / (now - t_last)
                logger.log(step, rec, echo)
                t_last, step_last = time.perf_counter(), step
            if step % cfg.train.checkpoint_every == 0:
                export_weights(weights, state.params)
        export_weights(weights, state.params)
    finally:
        logger.close()
    return state

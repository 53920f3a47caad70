"""Training loop on one device (port of ``vqvae_tpu/train/loop.py``).

Per step: the next batch of the deterministic stream (batch ``i`` is a
pure function of ``(seed, i)``), moved to the device, one
``train_step``.  Logs at ``log_every`` (and the first step); validates
at ``eval_every`` on its own schedule, closing the rate interval first
so that evaluation never counts against the training rate; checkpoints
the whole train state under ``<out>/checkpoints/`` and exports the
weights to ``<out>/weights.npz`` at ``checkpoint_every`` and at the end.
``resume`` continues from the newest checkpoint, data stream included,
under either loader (``train.loader``: ``threads`` or ``grain``, one
stream).  Interval rates are read on the host clock after a
``torch.cuda.synchronize()``.  ``train.tensorboard`` adds TensorBoard
scalars in ``<out>/tb``; the loss curves go to ``<out>/loss.png`` at the
end.  Meshes wait for ROADMAP A8: a run that asks for one is refused
before it writes anything.
"""

from __future__ import annotations

import os
from typing import Optional

import torch

from vqvae_tpu_torch.audio.grain_loader import make_loader
from vqvae_tpu_torch.configs import Config
from vqvae_tpu_torch.configs.presets import config_to_json
from vqvae_tpu_torch.train.checkpoint import (
    export_weights,
    latest_step,
    restore_checkpoint,
    save_checkpoint,
)
from vqvae_tpu_torch.train.evaluator import Evaluator
from vqvae_tpu_torch.train.metrics import MetricsLogger
from vqvae_tpu_torch.train.state import TrainState, create_train_state
from vqvae_tpu_torch.train.step import train_step
from vqvae_tpu_torch.utils.profiling import StepTimer, profile_trace


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def train(cfg: Config, dataset, out_dir: Optional[str] = None,
          num_steps: Optional[int] = None, device="cuda",
          echo: bool = True, resume: bool = False, impl: str = "lax",
          valid_dataset=None) -> TrainState:
    """Run training from the seeded init (or, with ``resume``, from the
    newest checkpoint in ``<out>/checkpoints``); returns the final
    state.  ``impl`` picks the VQ search."""
    device = torch.device(device)
    out_dir = out_dir or cfg.train.out_dir
    num_steps = cfg.train.num_steps if num_steps is None else num_steps
    if cfg.train.loader not in ("threads", "grain"):
        raise ValueError(f"unknown loader kind: {cfg.train.loader!r}")
    # settings the one-device trainer would otherwise ignore in silence
    for name in ("mesh_model", "mesh_seq", "mesh_slices"):
        if getattr(cfg.train, name) != 1:
            raise ValueError(f"train.{name}={getattr(cfg.train, name)} is "
                             "not ported (the port trains on one device)")
    if cfg.train.mesh_data > 1:
        raise ValueError(f"train.mesh_data={cfg.train.mesh_data} is not "
                         "ported (the port trains on one device)")
    ckpt_dir = os.path.join(out_dir, "checkpoints")
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, "config.json"), "w") as f:
        f.write(config_to_json(cfg))
    state = create_train_state(cfg, device)
    if resume and latest_step(ckpt_dir) is not None:
        restore_checkpoint(ckpt_dir, state)
    start = state.step
    evaluator = None
    if valid_dataset is not None and cfg.train.eval_every > 0:
        evaluator = Evaluator(valid_dataset, cfg, device, impl)
    # batch i is a pure function of (seed, i) under either loader kind, so
    # a resumed run sees what a straight run would have
    loader = make_loader(cfg.train.loader, dataset, cfg.train.batch_size,
                         seed=cfg.train.seed, start_batch=start)
    logger = MetricsLogger(out_dir, tensorboard=cfg.train.tensorboard)
    weights = os.path.join(out_dir, "weights.npz")
    every = cfg.train.checkpoint_every
    # trace steps [prof_at, prof_at + prof): from the tenth step after the
    # start, as the JAX loop does, or earlier if the run ends before that
    prof = cfg.train.profile_steps
    prof_at = start + min(10, max(0, num_steps - start - prof))
    prof_ctx = None
    timer = StepTimer()
    timed_to = start          # last step covered by a timer interval
    try:
        while state.step < num_steps:
            if prof and state.step == prof_at:
                prof_ctx = profile_trace(os.path.join(out_dir, "profile"),
                                         device)
                prof_ctx.__enter__()
            wav, spk = next(loader)
            metrics = train_step(state, torch.from_numpy(wav).to(device),
                                 torch.from_numpy(spk).to(device), cfg,
                                 impl=impl)
            step = state.step
            if prof_ctx is not None and step == prof_at + prof:
                prof_ctx.__exit__(None, None, None)
                prof_ctx, prof = None, 0
            do_log = step % cfg.train.log_every == 0 or step == start + 1
            do_eval = (evaluator is not None
                       and step % cfg.train.eval_every == 0)
            if do_log or do_eval:
                rec = {k: float(v) for k, v in metrics.items()}
                _sync(device)
                # closed before the evaluator runs, so validation never
                # deflates the training rate
                sps = timer.tick(step - timed_to)
                timed_to = step
                if sps is not None:
                    rec["steps_per_sec"] = sps
                if do_eval:
                    rec.update(evaluator(state.params))
                    timer.reset()
                logger.log(step, rec, echo)
            if step % every == 0:
                save_checkpoint(ckpt_dir, state, cfg.train.keep_checkpoints)
                export_weights(weights, state.params)
        if num_steps > start and num_steps % every:
            save_checkpoint(ckpt_dir, state, cfg.train.keep_checkpoints)
            export_weights(weights, state.params)
        logger.plot()
    finally:
        if prof_ctx is not None:
            prof_ctx.__exit__(None, None, None)
        loader.close()
        logger.close()
    return state

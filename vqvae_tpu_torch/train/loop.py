"""Training loop (port of ``vqvae_tpu/train/loop.py``).

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
end.

Under ``torchrun`` (``parallel/distributed.py::initialize_from_env``)
the loop runs on every rank: it builds the mesh ``cfg.train.mesh_*``
over the world, every rank draws the same batch stream and trains on
its rows (``batch_sharding(mesh).rows``), the step averages and gathers
over the mesh (``parallel/step.py``), checkpoints are collective, and
rank 0 alone writes ``config.json``, ``log.jsonl``, TensorBoard,
``loss.png`` and ``weights.npz``.  A mesh larger than the world (say
``mesh_model=2`` in a one-process run) is refused before anything is
written.
"""

from __future__ import annotations

import os
from typing import Optional

import torch
import torch.distributed as dist

from vqvae_tpu_torch.audio.grain_loader import make_loader
from vqvae_tpu_torch.configs import Config
from vqvae_tpu_torch.configs.presets import config_to_json
from vqvae_tpu_torch.parallel.distributed import (
    put_global_batch,
    rank_device,
    warmup_collectives,
)
from vqvae_tpu_torch.parallel.mesh import batch_sharding, mesh_from_config
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
    device = rank_device(device)
    out_dir = out_dir or cfg.train.out_dir
    num_steps = cfg.train.num_steps if num_steps is None else num_steps
    if cfg.train.loader not in ("threads", "grain"):
        raise ValueError(f"unknown loader kind: {cfg.train.loader!r}")
    mesh = mesh_from_config(cfg.train, device.type)
    bsh = batch_sharding(mesh)
    if cfg.train.batch_size % bsh.count:
        raise ValueError(
            f"global batch {cfg.train.batch_size} must divide the "
            f"batch-sharding axes ({bsh.count} ranks)")
    rows = bsh.rows(cfg.train.batch_size)
    lead = mesh is None or dist.get_rank() == 0   # writes the run's files
    warmup_collectives(mesh)
    ckpt_dir = os.path.join(out_dir, "checkpoints")
    os.makedirs(out_dir, exist_ok=True)
    if lead:
        with open(os.path.join(out_dir, "config.json"), "w") as f:
            f.write(config_to_json(cfg))
    state = create_train_state(cfg, device, mesh=mesh)
    if resume and latest_step(ckpt_dir) is not None:
        restore_checkpoint(ckpt_dir, state)
    start = state.step
    evaluator = None
    if valid_dataset is not None and cfg.train.eval_every > 0:
        evaluator = Evaluator(valid_dataset, cfg, device, impl, mesh)
    # batch i is a pure function of (seed, i) under either loader kind, so
    # a resumed run sees what a straight run would have, and every rank
    # draws the same global batch
    loader = make_loader(cfg.train.loader, dataset, cfg.train.batch_size,
                         seed=cfg.train.seed, start_batch=start)
    logger = (MetricsLogger(out_dir, tensorboard=cfg.train.tensorboard)
              if lead else None)
    weights = os.path.join(out_dir, "weights.npz")
    every = cfg.train.checkpoint_every
    # trace steps [prof_at, prof_at + prof): from the tenth step after the
    # start, as the JAX loop does, or earlier if the run ends before that
    prof = cfg.train.profile_steps if lead else 0
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
            wav, spk = put_global_batch(mesh, wav[rows], spk[rows],
                                        device=device)
            metrics = train_step(state, wav, spk, cfg, impl=impl)
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
                if do_eval:   # collective: every rank evaluates
                    rec.update(evaluator(state.params))
                    timer.reset()
                if lead:
                    logger.log(step, rec, echo)
            if step % every == 0:
                _save(ckpt_dir, state, cfg, weights, lead)
        if num_steps > start and num_steps % every:
            _save(ckpt_dir, state, cfg, weights, lead)
        if lead:
            logger.plot()
    finally:
        if prof_ctx is not None:
            prof_ctx.__exit__(None, None, None)
        loader.close()
        if logger is not None:
            logger.close()
    return state


def _save(ckpt_dir: str, state: TrainState, cfg: Config, weights: str,
          lead: bool) -> None:
    # collective on a mesh; the weights are whole on every rank
    save_checkpoint(ckpt_dir, state, cfg.train.keep_checkpoints)
    if lead:
        export_weights(weights, state.params)

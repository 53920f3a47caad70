"""The shipped training step (``stretch``: save-gates chunk kernels,
head + CE kernels, the in-kernel input embedding) at B=64: the best of
``reps`` runs of ``runs`` steps, on the card (port of
``scripts/step_bench.py``).  The one-configuration twin of
``embed_kernel_bench``, for a quick A/B of a change to the step.

    python -m vqvae_tpu_torch.measure.step_bench [batch] [runs] [reps]

Prints the JAX script's line (``B=64: ... ms/step, ... utt/s,
loss=...``), then one JSON line: ``ms_per_step``, ``utt_per_s``,
``loss0`` (after 3 warm-up steps) and ``peak_gib`` (the card memory the
timed steps held at most; null on the CPU).
"""

from __future__ import annotations

import argparse

import torch

from vqvae_tpu_torch.cli.common import add_device_arg, resolve_device
from vqvae_tpu_torch.configs import get_config
from vqvae_tpu_torch.measure import _common as mc
from vqvae_tpu_torch.measure.train_roofline import WARMUP, batch_step


def bench(cfg, B: int, runs: int, reps: int, dev) -> dict:
    state, step = batch_step(cfg, B, dev)
    for _ in range(WARMUP):
        metrics = step()
    loss0 = float(metrics["loss"])
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    ms = mc.best_ms(step, runs, reps, dev)
    peak = (torch.cuda.max_memory_allocated(dev) / 2 ** 30
            if dev.type == "cuda" else None)
    del state
    return {"preset": cfg.name, "batch": B, "runs": runs, "reps": reps,
            "ms_per_step": ms, "utt_per_s": B / (ms / 1e3), "loss0": loss0,
            "peak_gib": peak}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("batch", type=int, nargs="?", default=64)
    ap.add_argument("runs", type=int, nargs="?", default=10)
    ap.add_argument("reps", type=int, nargs="?", default=3)
    ap.add_argument("--preset", default="stretch")
    add_device_arg(ap)
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    rec = bench(get_config(args.preset), args.batch, args.runs, args.reps,
                dev)
    print(f"B={rec['batch']}: {rec['ms_per_step']:.2f} ms/step, "
          f"{rec['utt_per_s']:.1f} utt/s, loss={rec['loss0']:.6f}",
          flush=True)
    return mc.emit(rec, dev)


if __name__ == "__main__":
    main()

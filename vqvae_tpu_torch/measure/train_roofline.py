"""Training-path roofline sweep (port of ``scripts/train_roofline.py``).

For each batch size: the training step's wall time on the card (host
clock around synchronised steps), utterances a second, the analytic
FLOP count of ``utils/flops.py::train_step_flops`` and the share of the
card's bf16 peak it reaches (``mfu``, against ``utils/flops.py::
PEAK_FLOPS``), the FLOPs PyTorch counts over one step, and the most
card memory the timed steps held.  The flagship by default
(``vctk-multi``, T=7680, bf16), on seeded weights and one seeded batch.

What the JAX script printed and this one does not, and why:

* its TPU constants (the TPU's bf16 peak and memory rate, and the
  matrix-unit tile factor behind ``mfu_vs_k64_achievable``) describe
  another chip; the card's peaks are in ``utils/flops.py``;
* ``xla_step_tflops`` becomes ``counted_step_tflops``:
  ``torch.utils.flop_counter.FlopCounterMode`` over one step.  Like
  XLA's count it cannot see inside the hand kernels (they are called
  through ctypes, outside PyTorch's dispatcher), so it counts only the
  products PyTorch itself runs;
* ``xla_bytes_gb``, ``hbm_bound_ms`` and ``mxu_bound_ms`` need a count
  of the bytes the step moves, which PyTorch does not give: left out;
* ``temp_mb`` (XLA's temporary buffers) becomes ``peak_gib``
  (``torch.cuda.max_memory_allocated`` over the timed steps).

Every training tool searches the codebook with the VQ kernel
(``impl="pallas"``, ``IMPL``), as the flagship trains on the card; the
JAX scripts took the plain search (their ``lax`` default).

On ``--device cpu`` the times are the CPU's, and ``mfu`` and
``peak_gib`` are null.

    python -m vqvae_tpu_torch.measure.train_roofline \\
        [--batches 8,16,24,32,48,64] [--decoder-kernel pallas_sg] \\
        [--head-kernel pallas] [--embed-in-kernel] [--remat] \\
        [--steps 10] [--profile-batch N] [--out DIR]

``--profile-batch N`` wraps that batch's timed steps in
``utils/profiling.py::profile_trace`` (a Chrome trace under ``--out``).
Prints one JSON line a batch, then a markdown table.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os

import torch

from vqvae_tpu_torch.cli.common import resolve_device
from vqvae_tpu_torch.configs import Config
from vqvae_tpu_torch.measure import _common as mc
from vqvae_tpu_torch.utils.flops import PEAK_FLOPS, train_step_flops
from vqvae_tpu_torch.utils.profiling import profile_trace

WARMUP = 3
IMPL = "pallas"     # the VQ search of every training tool


def analytic_step_tflops(cfg: Config, batch: int) -> float:
    """The hand-derived FLOP count of one step (forward + ~2x backward),
    in TFLOP."""
    return train_step_flops(cfg, batch) / 1e12


def batch_step(cfg: Config, B: int, device, seed: int = 0):
    """(state, step): seeded train state at batch ``B`` and a closure
    that runs one training update on the seeded batch and returns its
    metrics.  The batch function every training tool times."""
    from vqvae_tpu_torch.train.step import train_step
    cfg = mc.with_batch(cfg, B)
    state = mc.make_state(cfg, device, seed)
    wav, spk = mc.make_batch(cfg, B, device)

    def step():
        return train_step(state, wav, spk, cfg, impl=IMPL)
    return state, step


def counted_step_tflops(step) -> float:
    """TFLOP that ``FlopCounterMode`` counts over one call of ``step``
    (the products PyTorch dispatches; the hand kernels are invisible)."""
    from torch.utils.flop_counter import FlopCounterMode
    with FlopCounterMode(display=False) as fc:
        step()
    return fc.get_total_flops() / 1e12


def bench_batch(cfg: Config, B: int, steps: int, device,
                trace_dir: str | None = None) -> dict:
    """One row of the sweep (see the module docstring)."""
    dev = torch.device(device)
    state, step = batch_step(cfg, B, dev)
    for _ in range(WARMUP):
        metrics = step()
    loss = float(metrics["loss"])
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    trace = (contextlib.nullcontext() if trace_dir is None else
             profile_trace(trace_dir, dev))
    with trace:
        ms = mc.wall_ms(step, steps, dev)
    peak = (torch.cuda.max_memory_allocated(dev) / 2 ** 30
            if dev.type == "cuda" else None)
    counted = counted_step_tflops(step)
    ana = analytic_step_tflops(cfg, B)
    del state
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    return {
        "batch": B,
        "preset": cfg.name,
        "remat": cfg.model.remat,
        "decoder_kernel": cfg.model.decoder_kernel,
        "head_kernel": cfg.model.head_kernel,
        "encoder_kernel": cfg.model.encoder_kernel,
        "embed_in_kernel": cfg.model.embed_in_kernel,
        "ms_per_step": ms,
        "utt_per_s": B / (ms / 1e3),
        "loss": loss,
        "analytic_step_tflops": ana,
        "counted_step_tflops": counted,
        "mfu": (ana * 1e12 / (ms / 1e3) / PEAK_FLOPS
                if dev.type == "cuda" else None),
        "peak_gib": peak,
    }


def main(argv=None) -> list:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--batches", default="8,16,24,32,48,64")
    mc.add_train_args(ap)
    ap.add_argument("--remat", action="store_true")
    ap.add_argument("--steps", type=int, default=10)
    ap.add_argument("--profile-batch", type=int, default=0)
    ap.add_argument("--out", default=os.path.join("build", "measure",
                                                  "roofline_profile"))
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    cfg = mc.train_config(args, remat=args.remat or None)
    print(f"device: {mc.card(dev)['device']}, {cfg.name} "
          f"T={cfg.data.length}, remat={cfg.model.remat}", flush=True)
    rows = []
    for B in [int(b) for b in args.batches.split(",")]:
        r = bench_batch(cfg, B, args.steps, dev,
                        args.out if B == args.profile_batch else None)
        rows.append(mc.emit(r, dev))
    keys = list(rows[0].keys())
    print("\n| " + " | ".join(keys) + " |")
    print("|" + "---|" * len(keys))
    for r in rows:
        print("| " + " | ".join(json.dumps(r[k]) for k in keys) + " |")
    return rows


if __name__ == "__main__":
    main()

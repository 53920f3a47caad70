"""``embed_in_kernel`` on against off at the flagship's B=64 training
configuration (``vctk-multi`` with the save-gates chunk kernels and the
head + CE kernels): the loss and the parameter norm after 3 steps from
the same seeded state (the parity of the in-kernel input embedding with
the embedding outside the kernels, ``ops/embed.py``), then the best of
``reps`` runs of ``runs`` steps for each (port of
``scripts/embed_kernel_bench.py``).

    python -m vqvae_tpu_torch.measure.embed_kernel_bench [--batch 64]
        [--runs 10] [--reps 3]

Prints the JAX script's three lines, then one JSON line: per setting
(``off``, ``on``) ``ms_per_step``, ``utt_per_s``, ``loss3`` and
``param_norm3``, and ``delta_ms``, ``delta_utt_per_s``,
``loss3_rel_delta`` and ``param_norm3_rel_delta``.
"""

from __future__ import annotations

import argparse

import torch

from vqvae_tpu_torch.cli.common import add_device_arg, resolve_device
from vqvae_tpu_torch.configs import get_config
from vqvae_tpu_torch.measure import _common as mc
from vqvae_tpu_torch.measure.train_roofline import WARMUP, batch_step


def param_norm(params) -> float:
    """sqrt of the sum of squares of every parameter, in float32."""
    with torch.no_grad():
        return float(torch.sqrt(sum(
            torch.sum(torch.square(p.float())) for p in params.parameters())))


def run(cfg, B: int, embed: bool, runs: int, reps: int, dev) -> dict:
    cfg = mc.with_model(cfg, decoder_kernel="pallas_sg", head_kernel="pallas",
                        embed_in_kernel=embed)
    state, step = batch_step(cfg, B, dev)
    for _ in range(WARMUP):
        metrics = step()
    loss3 = float(metrics["loss"])
    pn = param_norm(state.params)
    ms = mc.best_ms(step, runs, reps, dev)
    del state
    return {"ms_per_step": ms, "utt_per_s": B / (ms / 1e3), "loss3": loss3,
            "param_norm3": pn}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--batch", type=int, default=64)
    ap.add_argument("--runs", type=int, default=10)
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--preset", default="vctk-multi")
    add_device_arg(ap)
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    cfg, B = get_config(args.preset), args.batch
    rows = {}
    for tag, embed in (("off", False), ("on", True)):
        r = rows[tag] = run(cfg, B, embed, args.runs, args.reps, dev)
        print(f"embed={str(embed):5s}: {r['ms_per_step']:.1f} ms/step, "
              f"{r['utt_per_s']:.1f} utt/s, loss3={r['loss3']:.6f}, "
              f"|params|3={r['param_norm3']:.4f}", flush=True)
    off, on = rows["off"], rows["on"]
    rec = {"preset": cfg.name, "batch": B, "runs": args.runs,
           "reps": args.reps, **rows,
           "delta_ms": off["ms_per_step"] - on["ms_per_step"],
           "delta_utt_per_s": on["utt_per_s"] - off["utt_per_s"],
           "loss3_rel_delta": abs(on["loss3"] - off["loss3"])
           / (abs(off["loss3"]) + 1e-9),
           "param_norm3_rel_delta": abs(on["param_norm3"]
                                        - off["param_norm3"])
           / (off["param_norm3"] + 1e-9)}
    print(f"delta: {rec['delta_ms']:+.2f} ms "
          f"({rec['delta_utt_per_s']:+.1f} utt/s), loss rel delta "
          f"{rec['loss3_rel_delta']:.2e}, param-norm rel delta "
          f"{rec['param_norm3_rel_delta']:.2e}", flush=True)
    return mc.emit(rec, dev)


if __name__ == "__main__":
    main()

"""Training CLI (port of ``vqvae_tpu/cli/train.py``; console script
``vqvae-torch-train``).

    vqvae-torch-train --preset vctk-multi --dataset vctk --root VCTK \\
        [--impl pallas] [--bwd-windows N] [--eval-every K] [-r] --out run

trains on one device and writes ``<out>/config.json``,
``<out>/log.jsonl`` (with ``val_*`` rows at ``eval_every``),
``<out>/checkpoints/`` (the whole train state, for ``--resume``) and
``<out>/weights.npz`` (which ``vqvae-torch-serve -m`` loads).
``--device cuda`` (the default) fails without a GPU; ``--device cpu``
runs the kernels' plain versions.  At exit it prints the kernels'
launch counts as one JSON line.  ``--decoder-kernel`` picks
the decoder stack (``pallas`` recompute, ``pallas_sg`` saved gates,
``xla`` the plain layer loop), ``--impl`` the VQ search; any other
field goes through ``--set``.  ``--profile N`` traces N steps with
``torch.profiler`` into ``<out>/profile`` (a Chrome trace).  Not ported
yet: the mesh flags (ROADMAP A8), ``--loader grain`` and
``--tensorboard``.
"""

from __future__ import annotations

import argparse
import dataclasses

from vqvae_tpu_torch.cli.common import (
    add_config_args,
    add_device_arg,
    make_dataset,
    print_launch_counts,
    resolve_config,
    resolve_device,
)


def main(argv=None) -> None:
    p = argparse.ArgumentParser(
        description="Train a VQ-VAE (PyTorch / CUDA port)")
    add_config_args(p)
    p.add_argument("--dataset", default="vctk", choices=["vctk", "sine"])
    p.add_argument("--root", default=None, help="VCTK root directory")
    p.add_argument("-r", "--resume", action="store_true",
                   help="resume from the newest checkpoint in --out")
    p.add_argument("--steps", type=int, default=None)
    p.add_argument("--out", default=None, help="output directory")
    p.add_argument("--batch-size", type=int, default=None)
    p.add_argument("--impl", default="lax", choices=["lax", "pallas"],
                   help="VQ search: float64 plain search (lax) or the "
                        "float32 VQ kernel (pallas)")
    p.add_argument("--decoder-kernel", default=None,
                   choices=["xla", "pallas", "pallas_sg"],
                   help="decoder stack: plain layer loop (xla), fused "
                        "chunk kernels with the recompute backward "
                        "(pallas) or with saved gates (pallas_sg)")
    p.add_argument("--bwd-windows", type=int, default=None,
                   help="pallas decoder kernel: run the recompute "
                        "backward over N time windows")
    p.add_argument("--loader", default=None, choices=["threads"],
                   help="host input pipeline (worker threads)")
    p.add_argument("--eval-every", type=int, default=None,
                   help="validation interval in steps (0: off)")
    p.add_argument("--profile", type=int, default=None, metavar="N",
                   help="torch.profiler-trace N steps to <out>/profile")
    add_device_arg(p)
    args = p.parse_args(argv)

    cfg = resolve_config(args)
    tr = {k: v for k, v in (("num_steps", args.steps),
                            ("batch_size", args.batch_size),
                            ("out_dir", args.out),
                            ("loader", args.loader),
                            ("eval_every", args.eval_every),
                            ("profile_steps", args.profile))
          if v is not None}
    if tr:
        cfg = cfg.replace(train=dataclasses.replace(cfg.train, **tr))
    mo = {k: v for k, v in (("decoder_kernel", args.decoder_kernel),
                            ("bwd_time_windows", args.bwd_windows))
          if v is not None}
    if mo:
        cfg = cfg.replace(model=dataclasses.replace(cfg.model, **mo))
    dataset, valid = make_dataset(cfg, args.dataset, args.root)
    device = resolve_device(args.device)

    from vqvae_tpu_torch.train.loop import train
    train(cfg, dataset, out_dir=cfg.train.out_dir, device=device,
          resume=args.resume, impl=args.impl, valid_dataset=valid)
    print_launch_counts()


if __name__ == "__main__":
    main()

"""Training CLI (port of ``vqvae_tpu/cli/train.py``; console script
``vqvae-torch-train``).

    vqvae-torch-train --preset stretch --dataset sine --steps 3 --out run

trains on one device and writes ``<out>/config.json``,
``<out>/log.jsonl`` and ``<out>/weights.npz`` (which
``vqvae-torch-serve -m`` loads).  ``--device cuda`` (the default) fails
without a GPU; ``--device cpu`` runs the kernels' plain versions.  At
exit it prints the training kernels' launch counts as one JSON line.
Kernel switches go through ``--set`` (``--set model.decoder_kernel=xla``
runs the plain layer loop).  Not ported yet: ``--dataset vctk`` and
``--resume`` (ROADMAP A6), the mesh flags (A8), ``--impl pallas`` (B10).
"""

from __future__ import annotations

import argparse
import dataclasses
import json

from vqvae_tpu_torch.cli.common import (
    add_config_args,
    make_dataset,
    resolve_config,
    resolve_device,
)


def launch_counts() -> dict:
    """Kernel launches of the training kernels in this process."""
    from vqvae_tpu_torch.kernels import head_ce_cuda, wavenet_train_cuda
    return {"chunk_fwd": wavenet_train_cuda.launches_fwd,
            "chunk_bwd": wavenet_train_cuda.launches_bwd,
            "head_ce_fwd": head_ce_cuda.launches_fwd,
            "head_ce_bwd": head_ce_cuda.launches_bwd}


def main(argv=None) -> None:
    p = argparse.ArgumentParser(
        description="Train a VQ-VAE (PyTorch / CUDA port)")
    add_config_args(p)
    p.add_argument("--dataset", default="vctk", choices=["vctk", "sine"])
    p.add_argument("--steps", type=int, default=None)
    p.add_argument("--out", default=None, help="output directory")
    p.add_argument("--batch-size", type=int, default=None)
    p.add_argument("--device", default="cuda",
                   help="cuda (default; fails without a GPU) or cpu")
    args = p.parse_args(argv)

    cfg = resolve_config(args)
    tr = {k: v for k, v in (("num_steps", args.steps),
                            ("batch_size", args.batch_size),
                            ("out_dir", args.out)) if v is not None}
    if tr:
        cfg = cfg.replace(train=dataclasses.replace(cfg.train, **tr))
    dataset, _ = make_dataset(cfg, args.dataset)
    device = resolve_device(args.device)

    from vqvae_tpu_torch.train.loop import train
    train(cfg, dataset, out_dir=cfg.train.out_dir, device=device)
    print("kernel launches: " + json.dumps(launch_counts()), flush=True)


if __name__ == "__main__":
    main()

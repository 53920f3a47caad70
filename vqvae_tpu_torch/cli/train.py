"""Training CLI (port of ``vqvae_tpu/cli/train.py``; console script
``vqvae-torch-train``).

    vqvae-torch-train --preset vctk-multi --dataset vctk --root VCTK \\
        [--impl pallas] [--bwd-windows N] [--eval-every K] [-r] --out run

trains on one device, or on a mesh of ranks under ``torchrun``:

    torchrun --nproc-per-node N -m vqvae_tpu_torch.cli.train ... \\
        [--mesh-model M] [--mesh-seq S] [--mesh-slices L]

(data parallelism over the ranks left over; NCCL with a card a rank,
gloo on the CPU or for ranks that share a card).  It writes ``<out>/config.json``,
``<out>/log.jsonl`` (with ``val_*`` rows at ``eval_every``),
``<out>/checkpoints/`` (the whole train state, for ``--resume``) and
``<out>/weights.npz`` (which ``vqvae-torch-serve -m`` loads).
``--device cuda`` (the default) fails without a GPU; ``--device cpu``
runs the kernels' plain versions.  At exit it prints the kernels'
launch counts as one JSON line.  ``--decoder-kernel`` picks
the decoder stack (``pallas`` recompute, ``pallas_sg`` saved gates,
``xla`` the plain layer loop), ``--impl`` the VQ search; any other
field goes through ``--set``.  ``--loader grain`` builds batches in
worker processes (the same stream as ``threads``), ``--tensorboard``
adds TensorBoard scalars in ``<out>/tb``, and ``<out>/loss.png`` holds
the loss curves when matplotlib is installed.  ``--profile N`` traces N
steps with ``torch.profiler`` into ``<out>/profile`` (a Chrome trace that
holds the program's spans, ``utils/profiling.py``).
A mesh larger than the world (``--mesh-model 2`` in one process) is
refused before anything is written.  ``--preset nsynth-h512`` trains
NSynth's WaveNet autoencoder (``models/wavenet_ae.py``) on one device
through the same step, loader and checkpoints; the kernel switches are
the VQ-VAE's and refused for it.
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
    vqvae_only,
)
from vqvae_tpu_torch.parallel.distributed import initialize_from_env, \
    shutdown


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
    p.add_argument("--mesh-model", type=int, default=None,
                   help="'model' (tensor-parallel) mesh axis size")
    p.add_argument("--mesh-slices", type=int, default=None,
                   help="outer 'slice' mesh axis size (joins the batch "
                        "axes)")
    p.add_argument("--mesh-seq", type=int, default=None,
                   help="sequence-parallel mesh axis size: decoder "
                        "activations time-sharded with halo exchange "
                        "(needs max dilation <= length/mesh_seq)")
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
    p.add_argument("--loader", default=None, choices=["threads", "grain"],
                   help="host input pipeline (one stream: worker threads, "
                        "or grain's worker processes)")
    p.add_argument("--eval-every", type=int, default=None,
                   help="validation interval in steps (0: off)")
    p.add_argument("--tensorboard", action="store_true",
                   help="also write TensorBoard scalars to <out>/tb")
    p.add_argument("--profile", type=int, default=None, metavar="N",
                   help="torch.profiler-trace N steps to <out>/profile")
    add_device_arg(p)
    args = p.parse_args(argv)
    device = resolve_device(args.device)
    # under torchrun: join the world before anything touches the card
    initialize_from_env(device)

    cfg = resolve_config(args)
    tr = {k: v for k, v in (("num_steps", args.steps),
                            ("batch_size", args.batch_size),
                            ("mesh_model", args.mesh_model),
                            ("mesh_slices", args.mesh_slices),
                            ("mesh_seq", args.mesh_seq),
                            ("out_dir", args.out),
                            ("loader", args.loader),
                            ("eval_every", args.eval_every),
                            ("tensorboard", args.tensorboard or None),
                            ("profile_steps", args.profile))
          if v is not None}
    if tr:
        cfg = cfg.replace(train=dataclasses.replace(cfg.train, **tr))
    mo = {k: v for k, v in (("decoder_kernel", args.decoder_kernel),
                            ("bwd_time_windows", args.bwd_windows))
          if v is not None}
    if mo:
        vqvae_only(cfg, "--decoder-kernel, --bwd-windows")
        cfg = cfg.replace(model=dataclasses.replace(cfg.model, **mo))
    dataset, valid = make_dataset(cfg, args.dataset, args.root)

    from vqvae_tpu_torch.train.loop import train
    train(cfg, dataset, out_dir=cfg.train.out_dir, device=device,
          resume=args.resume, impl=args.impl, valid_dataset=valid)
    print_launch_counts()
    shutdown()


if __name__ == "__main__":
    main()

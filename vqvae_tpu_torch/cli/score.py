"""Scoring CLI (port of ``vqvae_tpu/cli/score.py``; console script
``vqvae-torch-score``): deterministic evaluation of a model over a
dataset split, through ``train/evaluator.py`` (the same fixed windows
and ``eval_step`` as training's validation).

    vqvae-torch-score -m <run dir or weights.npz> --dataset vctk \\
        --root VCTK --split valid [--json]

Scores are a reproducible function of (weights, split).  Under
``torchrun`` the evaluation shards over the mesh ``--mesh-model`` and
``--mesh-seq`` ask for (data parallelism over the ranks left over; the
sequence-parallel decoder with ``--mesh-seq``), as training's validation
does; a mesh larger than the world is refused.  Runs on the card unless
given ``--device cpu``; the last line is the kernels' launch counts (on
every rank).
"""

from __future__ import annotations

import argparse
import dataclasses
import json

import torch.distributed as dist

from vqvae_tpu_torch.cli.common import (
    add_config_args,
    add_device_arg,
    codec_config,
    load_params,
    make_dataset,
    print_launch_counts,
    resolve_device,
)
from vqvae_tpu_torch.parallel.distributed import (
    initialize_from_env,
    rank_device,
    shutdown,
)
from vqvae_tpu_torch.parallel.mesh import mesh_from_config
from vqvae_tpu_torch.train.evaluator import Evaluator


def main(argv=None) -> None:
    p = argparse.ArgumentParser(
        description="Score a trained VQ-VAE over a dataset split "
                    "(deterministic val_loss1/2/3)")
    add_config_args(p)
    add_device_arg(p)
    p.add_argument("-m", "--model", required=True,
                   help="port training run dir (or weights .npz)")
    p.add_argument("--dataset", default="vctk", choices=["vctk", "sine"])
    p.add_argument("--root", default=None, help="VCTK root directory")
    p.add_argument("--split", default="valid", choices=["valid", "train"])
    p.add_argument("--batch-size", type=int, default=None)
    p.add_argument("--eval-batches", type=int, default=None,
                   help="cap the eval set (batches); default = config "
                        "(0 = the whole split)")
    p.add_argument("--mesh-model", type=int, default=None,
                   help="'model' mesh axis size (under torchrun)")
    p.add_argument("--mesh-seq", type=int, default=None,
                   help="sequence-parallel mesh axis size (under torchrun; "
                        "needs max dilation <= length/mesh_seq)")
    p.add_argument("--json", action="store_true",
                   help="print one JSON line instead of a table")
    args = p.parse_args(argv)

    device = resolve_device(args.device)
    initialize_from_env(device)
    device = rank_device(device)
    cfg = codec_config(args, "vqvae-torch-score")
    tr = {k: v for k, v in (("batch_size", args.batch_size),
                            ("eval_batches", args.eval_batches),
                            ("mesh_model", args.mesh_model),
                            ("mesh_seq", args.mesh_seq))
          if v is not None}
    if tr:
        cfg = cfg.replace(train=dataclasses.replace(cfg.train, **tr))
    try:
        mesh = mesh_from_config(cfg.train, device.type)
    except ValueError as exc:
        raise SystemExit(str(exc).replace("train.mesh_", "--mesh-"))
    params = load_params(args.model, cfg, device)
    train_ds, valid_ds = make_dataset(cfg, args.dataset, args.root)
    ds = valid_ds if args.split == "valid" else train_ds
    if ds is None:
        p.error(f"no '{args.split}' split in this dataset")

    evaluator = Evaluator(ds, cfg, device, mesh=mesh)
    metrics = evaluator(params)
    rec = {"split": args.split, "windows": evaluator.n_windows,
           **{k: round(float(v), 6) for k, v in metrics.items()}}
    if mesh is None or dist.get_rank() == 0:    # rank 0 reports
        if args.json:
            print(json.dumps(rec))
        else:
            print(f"{args.split} split: {rec['windows']} windows "
                  f"(length {cfg.data.length})")
            for k, v in rec.items():
                if k.startswith("val_"):
                    print(f"  {k:24s} {v:.6f}")
    print_launch_counts()
    shutdown()


if __name__ == "__main__":
    main()

"""Export CLI (port of ``vqvae_tpu/cli/export.py``; console script
``vqvae-torch-export``): a port training run -> the weights-only
``.npz`` that ``vqvae-torch-serve`` and the other CLIs load.

    vqvae-torch-export -m <run dir> -o weights.npz [--device cpu]

reads the run's newest train-state checkpoint
(``<run>/checkpoints/step_N.pt``, written by ``vqvae-torch-train``) and
writes its parameters under the JAX package's keys, so the file also
loads into the JAX package.  A JAX run directory holds orbax
checkpoints: export it with the JAX package's ``vqvae-export``.
"""

from __future__ import annotations

import argparse
import os

from vqvae_tpu_torch.cli.common import (
    add_config_args,
    add_device_arg,
    load_params,
    print_launch_counts,
    resolve_config,
    resolve_device,
)
from vqvae_tpu_torch.train.checkpoint import export_weights


def main(argv=None) -> None:
    p = argparse.ArgumentParser(
        description="Export a weights-only .npz from a training run")
    add_config_args(p)
    add_device_arg(p)
    p.add_argument("-m", "--model", required=True,
                   help="port training run dir (or its checkpoints/)")
    p.add_argument("-o", "--output", default="weights.npz")
    args = p.parse_args(argv)

    device = resolve_device(args.device)
    cfg = resolve_config(args)
    params = load_params(args.model, cfg, device)
    export_weights(args.output, params)
    n = sum(v.numel() for v in params.state_dict().values())
    print(f"wrote {args.output}: {n:,} params "
          f"({os.path.getsize(args.output) / 1e6:.1f} MB)")
    print_launch_counts()


if __name__ == "__main__":
    main()

#!/usr/bin/env python3
"""Time the port's chunk kernels of one source tree on the card, for an
A/B of two commits in one call.

    python3 scripts/torch_kernel_ab.py <tree> <tag>

``<tree>`` is a checkout of the repository (for the other commit: a
``git archive`` unpacked into a directory that ``.gitignore`` lists,
such as ``build/parent``).  The script builds that tree's kernels into
``<tree>/build/ab_<tag>`` and prints one line ``AB <tag> {...}``: the
mean milliseconds of the chunk forward (``fwd<mode>``) and the
save-gates backward (``bwd<mode>``) at stretch width, B=64, T=7680,
bfloat16, for the chained (mode 1) and embed (mode 2) chunks (CUDA
events, five calls after one warm-up; ``chip_smoke.py``'s inputs).
Run the two trees in turns in one call (parent, change, change,
parent) so that both are timed on one card.  Needs one GPU; no JAX.
"""

import json
import os
import sys


def main():
    tree, tag = os.path.abspath(sys.argv[1]), sys.argv[2]
    os.environ["VQVAE_TORCH_BUILD_DIR"] = os.path.join(tree, "build",
                                                       "ab_" + tag)
    sys.path.insert(0, tree)
    import torch
    if not torch.cuda.is_available():
        sys.exit("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    import chip_smoke as cs
    from vqvae_tpu_torch.configs import get_config
    from vqvae_tpu_torch.kernels import wavenet_train_cuda as wt
    if not wt.__file__.startswith(tree):
        sys.exit(f"imported {wt.__file__}, not the tree {tree}")
    dev = torch.device("cuda")
    mc = get_config("stretch").model
    res = {}
    for mode in (wt.ACC, wt.EMBED):
        args, cots = cs.chunk_inputs(mode, torch.bfloat16, dev, 64, 7680, mc)
        gall = wt.fwd_kernel(*args)[2]
        res[f"fwd{mode}"] = cs.cuda_ms(lambda: wt.fwd_kernel(*args), reps=5)
        res[f"bwd{mode}"] = cs.cuda_ms(
            lambda: wt.bwd_kernel(*args[:-1], gall, *cots), reps=5)
        del args, cots, gall
        torch.cuda.empty_cache()
    print("AB", tag, json.dumps({k: round(v, 3) for k, v in res.items()}),
          flush=True)


if __name__ == "__main__":
    main()

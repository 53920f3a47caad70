#!/usr/bin/env python3
"""Time the decoder-input embedding's backward and the vctk-multi steps
it sits in, for one source tree on the card: the A/B companion of
``scripts/torch_kernel_ab.py`` (run both in one call, the two trees in
turns: parent, change, change, parent).

    python3 vqvae_tpu_torch/probes/embed_ab.py <tree> <tag>

``<tree>`` is a checkout of the repository (the other commit: a ``git
archive`` unpacked under ``build/``, which ``.gitignore`` lists).  The
tree's kernels are built into ``<tree>/build/ab_<tag>``.  Prints one line
``EMBED_AB <tag> {...}``, every time in milliseconds on the card:

- ``vctk_step``: the ``vctk-multi`` training step at its preset's B=16,
  T=7680, bf16, recompute decoder, VQ kernel (median of 3 synchronised
  steps after one warm-up, ``torch_kernel_ab.step_ms``);
  ``vctk_plain_step``: the same with the plain decoder;
- ``vctk_busy``, ``vctk_scatter``, ``vctk_take_rows``: a step's
  device-busy time, and the card time of its ``indexing_backward_kernel``
  and ``take_rows`` launches, over two steps under ``torch.profiler``
  (``chip_smoke.profile_step``), a step each;
- ``embed_fwd_bwd``: ``models/wavenet.py::embed_inputs`` forward and
  backward at that step's shape (20 calls between CUDA events);
- ``compose_call``, ``compose_graph``, ``einsum_compose_call``,
  ``einsum_compose_graph``: the reshape probe's composition through
  ``upsample_cuda.compose`` and one ``einsum``, per call (50 calls
  between CUDA events) and by CUDA-graph replay (the card's time alone).

Needs one GPU; no JAX.
"""

import json
import os
import sys


def vctk_profile(cs, cfg, dev):
    """(device-busy ms, scatter ms, take_rows ms) a step."""
    import torch
    from vqvae_tpu_torch.audio.datasets import SineDataset
    from vqvae_tpu_torch.audio.loader import BatchLoader
    from vqvae_tpu_torch.train.state import create_train_state
    from vqvae_tpu_torch.train.step import train_step
    loader = BatchLoader(SineDataset(cfg.data), cfg.train.batch_size, seed=0)
    wav, spk = (torch.from_numpy(a).to(dev) for a in next(loader))
    loader.close()
    state = create_train_state(cfg, dev)

    def step():
        return train_step(state, wav, spk, cfg, impl="pallas")
    step()
    _, busy, rows = cs.profile_step(step, 2)
    scatter = sum(ms for ms, k, _ in rows if "indexing_backward" in k)
    taps = sum(ms for ms, k, _ in rows if "take_rows" in k)
    del state
    torch.cuda.empty_cache()
    return busy / 2, scatter / 2, taps / 2


def embed_ms(cs, cfg, dev):
    """ms of embed_inputs forward + backward at cfg's training shape."""
    import torch
    from vqvae_tpu_torch.models.wavenet import embed_inputs
    mc = cfg.model
    g = torch.Generator().manual_seed(0)
    B, T, R = cfg.train.batch_size, cfg.data.length, mc.residual_channels
    w = torch.randn(2, mc.mu, R, generator=g).to(dev).requires_grad_(True)
    b = torch.zeros(R, device=dev)
    ids = torch.randint(0, mc.mu, (B, T), generator=g,
                        dtype=torch.int32).to(dev)
    cot = torch.randn(B, T, R, generator=g).to(dev, mc.cdtype)

    def fwd_bwd():
        w.grad = None
        embed_inputs({"emb": {"w": w, "b": b}}, mc, ids).backward(cot)
    return cs.cuda_ms(fwd_bwd, reps=20)


def compose_ms(cs, ab, dev):
    """The composition (the reshape probe's data, numpy seed 1) through
    ``uc.compose`` and one einsum, per call and by graph replay."""
    import numpy as np
    import torch
    from vqvae_tpu_torch.kernels import upsample_cuda as uc
    rng = np.random.default_rng(1)
    N, hop, d, E = 32, 64, 64, 128
    x = torch.from_numpy(rng.standard_normal((N, d))).float().to(dev)
    w = torch.from_numpy(rng.standard_normal((d, hop * d)) * 0.1).float().to(
        dev)
    v = torch.from_numpy(rng.standard_normal((d, E)) * 0.1).float().to(dev)
    res = {}
    for name, fn in (
            ("compose", lambda: uc.compose(x, w, v, hop)),
            ("einsum_compose", lambda: torch.einsum(
                "ni,irc,cj->nrj", x, w.view(d, hop, d), v).reshape(
                    N * hop, E))):
        res[name + "_call"] = cs.cuda_ms(fn, reps=50)
        res[name + "_graph"] = ab.graph_ms(fn)
    return res


def main():
    import argparse
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("tree")
    ap.add_argument("tag")
    args = ap.parse_args()
    tree, tag = os.path.abspath(args.tree), args.tag
    os.environ["VQVAE_TORCH_BUILD_DIR"] = os.path.join(tree, "build",
                                                       "ab_" + tag)
    sys.path.insert(0, os.path.join(tree, "scripts"))
    sys.path.insert(0, tree)
    import dataclasses
    import torch
    if not torch.cuda.is_available():
        sys.exit("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    import chip_smoke as cs
    import torch_kernel_ab as ab
    from vqvae_tpu_torch.configs import get_config
    from vqvae_tpu_torch.models import wavenet
    if not wavenet.__file__.startswith(tree):
        sys.exit(f"imported {wavenet.__file__}, not the tree {tree}")
    dev = torch.device("cuda")
    res = compose_ms(cs, ab, dev)
    vctk = get_config("vctk-multi")
    rec = vctk.replace(model=dataclasses.replace(vctk.model,
                                                 decoder_kernel="pallas"))
    res["embed_fwd_bwd"] = embed_ms(cs, rec, dev)
    res["vctk_step"], _ = ab.step_ms(rec, dev, impl="pallas")
    res["vctk_plain_step"], _ = ab.step_ms(vctk.replace(
        model=dataclasses.replace(vctk.model, decoder_kernel="xla")), dev,
        impl="pallas")
    res["vctk_busy"], res["vctk_scatter"], res["vctk_take_rows"] = \
        vctk_profile(cs, rec, dev)
    print("EMBED_AB", tag, json.dumps({k: round(v, 6)
                                       for k, v in res.items()}),
          flush=True)


if __name__ == "__main__":
    main()

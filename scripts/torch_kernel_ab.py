#!/usr/bin/env python3
"""Time the port's training kernels and the stretch step of one source
tree on the card, for an A/B of two commits in one call.

    python3 scripts/torch_kernel_ab.py <tree> <tag> [--only probes]

``<tree>`` is a checkout of the repository (for the other commit: a
``git archive`` unpacked into a directory that ``.gitignore`` lists,
such as ``build/parent``).  The script builds that tree's kernels into
``<tree>/build/ab_<tag>`` and prints one line ``AB <tag> {...}``: the
mean milliseconds of the chunk forward (``fwd<mode>``) and the
save-gates backward (``bwd<mode>``) at stretch width, B=64, T=7680,
bfloat16, for the chained (mode 1) and embed (mode 2) chunks, and of
the head + CE forward and backward (``head_fwd``, ``head_bwd``) at
N = 64 x 7680 rows, and of the fused encoder's forward at vctk-multi
width, bfloat16, B=16, T=7680 and at a 1 s encode, B=1 (``enc_fwd16``,
``enc_fwd1``) and its backward at B=16 (``enc_bwd16``) (CUDA events,
five calls after one warm-up, twenty for the encoder; ``chip_smoke.py``'s
inputs), then the
``stretch`` training step at B=64 (``step``: median of 3 synchronised
steps after one warm-up, ``peak_gib``: the card memory those steps
allocated at most), the same step with the plain decoder and head
(``plain_step``), and the ``vctk-multi`` step at B=16 with the VQ
kernel and the fused encoder (``vctk_enc_step``).  First, the probe
kernels the training path does not run: the reshape probe's five
layouts through ``upsample_cuda.relayout`` and through ``clone``, in all,
per call (``relayout_call``, ``clone_call``: 50 calls between CUDA
events, the host's enqueue included) and by CUDA-graph replay
(``relayout_graph``, ``clone_graph``: the same calls captured once, the
median of 5 replays), and the decode chains at L=30, STEPS=128 on the
probe's data (``chain_bf16``, ``chain_int8``: ten chains), and the
upsampler's forward and backward at vctk-multi width on the cond probe's
inputs, B=16 and B=64, bfloat16 and float32 (``cond_fwd_bf16_16`` ...:
20 calls between CUDA events, the host's enqueue included, and
``..._graph``: by CUDA-graph replay, the card's time alone; null where
that tree's kernels cannot be captured), the VQ search at K=512, d=64,
N = 1920 and 7680 (``vq_1920_call``, ``vq_1920_graph``, ...: 50 calls
between CUDA events and by graph replay; ``chip_smoke.py``'s seeded
inputs), and the dot probe's three contractions and its overlap-add on
the probe's data (``dot_nre_call``, ``dot_nre_graph``, ... for ``nre``,
``ne``, ``dre``, ``ola``; ``einsum_nre_call`` ... beside the three
contractions); ``--only probes`` stops there.  Run the two trees in turns in one call (parent,
change, change, parent) so that both are timed on one card.  Needs one
GPU; no JAX.
"""

import json
import os
import statistics
import sys
import time


def step_ms(cfg, dev, n=3, **kw):
    """(median ms of n training steps, peak GiB) after one warm-up step,
    on SineDataset batches as chip_smoke.py's train-time phases; kw goes
    to train_step."""
    import torch
    from vqvae_tpu_torch.audio.datasets import SineDataset
    from vqvae_tpu_torch.audio.loader import BatchLoader
    from vqvae_tpu_torch.train.state import create_train_state
    from vqvae_tpu_torch.train.step import train_step
    loader = BatchLoader(SineDataset(cfg.data), cfg.train.batch_size, seed=0)
    batches = [tuple(torch.from_numpy(a).to(dev) for a in next(loader))
               for _ in range(2)]
    loader.close()
    state = create_train_state(cfg, dev)
    train_step(state, *batches[0], cfg, **kw)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    times = []
    for i in range(n):
        t0 = time.perf_counter()
        train_step(state, *batches[(i + 1) % 2], cfg, **kw)
        torch.cuda.synchronize()
        times.append(1e3 * (time.perf_counter() - t0))
    peak = torch.cuda.max_memory_allocated(dev) / 2 ** 30
    del state, batches
    torch.cuda.empty_cache()
    return statistics.median(times), peak


def graph_ms(fn, reps=50, replays=5):
    """Device ms per call of fn: reps calls captured in one CUDA graph,
    the median of `replays` replays (the probes' own ``graph_ms``, which
    an older tree lacks)."""
    import torch
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    times = []
    for _ in range(replays):
        e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        e0.record()
        graph.replay()
        e1.record()
        torch.cuda.synchronize()
        times.append(e0.elapsed_time(e1) / reps)
    return statistics.median(times)


def probe_ms(cs, dev):
    """The relayout's and the decode chains' times (see the docstring),
    through APIs every tree since the probes' port has."""
    import numpy as np
    import torch
    from vqvae_tpu_torch.kernels import decode_chain_cuda as chn
    from vqvae_tpu_torch.kernels import upsample_cuda as uc
    from vqvae_tpu_torch.probes import decode_int8_micro as dim
    from vqvae_tpu_torch.probes import reshape as rp
    res = dict.fromkeys(("relayout_call", "clone_call", "relayout_graph",
                         "clone_graph"), 0.0)
    for _, src, dst in rp.CASES:
        x = torch.from_numpy(np.random.default_rng(0).standard_normal(
            src)).float().to(dev)
        for key, fn in (("relayout", lambda: uc.relayout(x, dst)),
                        ("clone", lambda: x.reshape(dst).clone())):
            res[key + "_call"] += cs.cuda_ms(fn, reps=50)
            res[key + "_graph"] += graph_ms(fn)
    x, w16, w8, sc = dim.script_data(dim.L, dev)
    res["chain_bf16"] = cs.cuda_ms(lambda: chn.chain(x, w16, dim.STEPS),
                                   reps=10)
    res["chain_int8"] = cs.cuda_ms(lambda: chn.chain(x, w8, dim.STEPS, sc),
                                   reps=10)
    res.update(cond_ms(cs, dev))
    res.update(vq_dot_ms(cs, dev))
    return res


def vq_dot_ms(cs, dev):
    """The VQ search's and the dot probe bodies' times (see the
    docstring) through ``vq_cuda.vq_argmin_kernel`` and
    ``probes/dot.py::bodies``, which every tree since the probes' port
    has."""
    import numpy as np
    import torch
    from vqvae_tpu_torch.kernels import vq_cuda
    from vqvae_tpu_torch.probes import dot as dprobe

    def both(name, fn):
        res[name + "_call"] = cs.cuda_ms(fn, reps=50)
        try:
            res[name + "_graph"] = graph_ms(fn)
        except RuntimeError:
            res[name + "_graph"] = None

    res = {}
    for N in (1920, 7680):
        g = torch.Generator().manual_seed(N)
        z = torch.randn(N, 64, generator=g).to(dev)
        cb = torch.randn(512, 64, generator=g).to(dev)
        both(f"vq_{N}", lambda: vq_cuda.vq_argmin_kernel(z, cb))
    rng = np.random.default_rng(0)
    N, hop, d = dprobe.N, dprobe.HOP, dprobe.D
    ef = torch.from_numpy(rng.standard_normal((N, d))).float().to(dev)
    W = torch.from_numpy(rng.standard_normal((hop, d, d)) * 0.1).float().to(
        dev)
    dp = torch.from_numpy(rng.standard_normal((N, hop, d))).float().to(dev)
    big = torch.from_numpy(rng.standard_normal((N * hop, d))).float().to(dev)
    tags = {"nd,rde->nre": "nre", "nrd,rde->ne": "ne", "nd,nre->dre": "dre",
            "pad/add/slice": "ola"}
    for name, kern, _, lib, _ in dprobe.bodies(ef, W, dp, big, hop):
        if name not in tags:
            continue
        both(f"dot_{tags[name]}", kern)
        if lib is not None:
            both(f"einsum_{tags[name]}", lib)
    return res


def cond_ms(cs, dev):
    """The upsampler pair's times (see the docstring) through
    ``uc.cond_forward`` and ``uc.cond_backward``, which every tree since
    the probes' port has; the inputs are the cond probe's
    (``probes/cond_inkernel.py::full_width``, seed 0)."""
    import torch
    from vqvae_tpu_torch.configs import get_config
    from vqvae_tpu_torch.kernels import upsample_cuda as uc
    mc = get_config("vctk-multi")
    hop, d, T = mc.model.hop, mc.model.d, mc.data.length
    res = {}
    for B in (16, 64):
        for cdt, tag in ((torch.bfloat16, "bf16"), (torch.float32, "f32")):
            g = torch.Generator().manual_seed(0)
            w = torch.randn(2 * hop, d, d, generator=g) * (2 * hop * d) ** -0.5
            bb = torch.randn(d, generator=g) * 0.1
            uwk, ub = uc.pack_upsampler(w, bb)
            e = torch.randn(B, T // hop, d, generator=g).to(dev, cdt)
            dcond = (torch.randn(B, T, d, generator=g) * 0.01).to(dev)
            uwk, ub = uwk.to(dev, cdt), ub.to(dev)
            for key, fn in (
                    ("cond_fwd", lambda: uc.cond_forward(e, uwk, ub, hop)),
                    ("cond_bwd", lambda: uc.cond_backward(dcond, e, uwk,
                                                          hop))):
                name = f"{key}_{tag}_{B}"
                res[name] = cs.cuda_ms(fn, reps=20)
                try:
                    res[name + "_graph"] = graph_ms(fn, reps=20)
                except RuntimeError:
                    res[name + "_graph"] = None
            del e, dcond
            torch.cuda.empty_cache()
    return res


def main():
    import argparse
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("tree")
    ap.add_argument("tag")
    ap.add_argument("--only", choices=("probes",), default=None,
                    help="time the probe kernels alone")
    args = ap.parse_args()
    tree, tag = os.path.abspath(args.tree), args.tag
    os.environ["VQVAE_TORCH_BUILD_DIR"] = os.path.join(tree, "build",
                                                       "ab_" + tag)
    sys.path.insert(0, tree)
    import dataclasses
    import torch
    if not torch.cuda.is_available():
        sys.exit("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    import chip_smoke as cs
    from vqvae_tpu_torch.configs import get_config
    from vqvae_tpu_torch.kernels import encoder_cuda as ec
    from vqvae_tpu_torch.kernels import head_ce_cuda as hc
    from vqvae_tpu_torch.kernels import wavenet_train_cuda as wt
    if not wt.__file__.startswith(tree):
        sys.exit(f"imported {wt.__file__}, not the tree {tree}")
    dev = torch.device("cuda")
    res = probe_ms(cs, dev)
    if args.only == "probes":
        print("AB", tag, json.dumps({k: None if v is None else round(v, 6)
                                     for k, v in res.items()}), flush=True)
        return
    cfg = get_config("stretch")
    mc = cfg.model
    for mode in (wt.ACC, wt.EMBED):
        args, cots = cs.chunk_inputs(mode, torch.bfloat16, dev, 64, 7680, mc)
        gall = wt.fwd_kernel(*args)[2]
        res[f"fwd{mode}"] = cs.cuda_ms(lambda: wt.fwd_kernel(*args), reps=5)
        res[f"bwd{mode}"] = cs.cuda_ms(
            lambda: wt.bwd_kernel(*args[:-1], gall, *cots), reps=5)
        del args, cots, gall
        torch.cuda.empty_cache()
    args = cs.head_inputs(torch.bfloat16, dev, 64 * 7680, mc)
    g = torch.tensor(1.0, device=dev)
    res["head_fwd"] = cs.cuda_ms(lambda: hc.fwd_kernel(*args), reps=5)
    res["head_bwd"] = cs.cuda_ms(lambda: hc.bwd_kernel(*args, g), reps=5)
    del args
    torch.cuda.empty_cache()
    vctk = get_config("vctk-multi")
    s = vctk.model.enc_stride
    for B, M, names in ((16, vctk.data.length // s, ("enc_fwd16",
                                                     "enc_bwd16")),
                        (1, vctk.data.sr // s, ("enc_fwd1",))):
        h, w, dz = cs.enc_inputs(torch.bfloat16, dev, B, M, vctk.model)
        # 20 calls: a B=1 call is short enough that 5 would time the host
        res[names[0]] = cs.cuda_ms(lambda: ec.fwd_kernel(h, *w), reps=20)
        if len(names) > 1:
            res[names[1]] = cs.cuda_ms(lambda: ec.bwd_kernel(h, *w, dz),
                                       reps=20)
        del h, w, dz
    torch.cuda.empty_cache()
    res["step"], res["peak_gib"] = step_ms(cfg, dev)
    res["plain_step"], _ = step_ms(cfg.replace(model=dataclasses.replace(
        mc, decoder_kernel="xla", head_kernel="xla", embed_in_kernel=False)),
        dev)
    res["vctk_enc_step"], _ = step_ms(vctk.replace(model=dataclasses.replace(
        vctk.model, decoder_kernel="pallas", encoder_kernel="pallas")), dev,
        impl="pallas")
    print("AB", tag, json.dumps({k: None if v is None else round(v, 6)
                                 for k, v in res.items()}), flush=True)


if __name__ == "__main__":
    main()

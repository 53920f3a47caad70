"""Decode CLI (port of ``vqvae_tpu/cli/decode.py``; console script
``vqvae-torch-decode``): VQ code ids (.npy) -> wav.

    vqvae-torch-decode -i codes.npy -m weights.npz -o out.wav

The input may be ``[T_lat]`` (one stream -> one wav) or ``[B, T_lat]``
(a batch -> a directory of wavs, decoded as one batch; ``-s`` gives one
speaker per row or one for all).  ``--gen-impl`` ``lax`` and ``pallas``
both run the decode kernel (the JAX package's scan has no counterpart
of its own here), ``lowmem`` decodes chunk by chunk with the same
waveform.  ``--mesh-data N`` splits a batch's rows over N devices of
the ``--device`` type (``infer/parallel.py``; the same waveform, bit for
bit); on the card N may not pass the cards there are, on the CPU the N
shards share it.  Runs on the card unless given ``--device cpu``; the
last line is the kernels' launch counts.
"""

from __future__ import annotations

import argparse
import os

import numpy as np
import torch

from vqvae_tpu_torch.audio.wav_io import save_wav
from vqvae_tpu_torch.cli.common import (
    add_config_args,
    add_device_arg,
    codec_config,
    load_params,
    print_launch_counts,
    resolve_device,
    speaker_ids,
)
from vqvae_tpu_torch.infer.fastgen import IMPLS, decode_from_codes
from vqvae_tpu_torch.infer.parallel import decode_from_codes_sharded


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description="Decode VQ code ids to wav")
    add_config_args(p)
    add_device_arg(p)
    p.add_argument("-i", "--input", required=True,
                   help="codes .npy: [T_lat] one stream, or [B, T_lat] a "
                        "batch of streams")
    p.add_argument("-o", "--output", default=None,
                   help="output wav (1-D input; default out.wav) or output "
                        "directory (2-D input; default dec_out/)")
    p.add_argument("-m", "--model", required=True,
                   help="weights .npz or port training run dir")
    p.add_argument("-s", "--speaker", type=int, nargs="+", default=[0],
                   help="speaker id(s): one per row, or a single id "
                        "broadcast to all rows")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--temperature", type=float, default=1.0)
    p.add_argument("--gen-impl", default="lax", choices=IMPLS,
                   help="lax / pallas: the decode kernel; lowmem: chunked "
                        "condition, the same waveform")
    p.add_argument("--greedy", action="store_true")
    p.add_argument("--mesh-data", type=int, default=0,
                   help="shard a batched decode's rows over N devices")
    args = p.parse_args(argv)

    device = resolve_device(args.device)
    if args.mesh_data and device.type == "cuda":
        have = torch.cuda.device_count()
        if args.mesh_data > have:
            raise SystemExit(f"--mesh-data {args.mesh_data}: only {have} "
                             f"CUDA device{'s' if have > 1 else ''} here "
                             "(--device cpu splits the rows on the CPU)")
    cfg = codec_config(args, "vqvae-torch-decode")
    raw = np.load(args.input)
    if raw.ndim not in (1, 2):   # p.error, not assert: python -O
        p.error(f"codes must be 1-D or 2-D, got {raw.shape}")
    batched = raw.ndim == 2
    codes = raw.astype(np.int64).reshape(-1 if batched else 1, raw.shape[-1])
    K = cfg.model.K
    if codes.size and (codes.min() < 0 or codes.max() >= K):
        p.error(f"code ids must be in [0, {K})")
    B = codes.shape[0]
    if args.mesh_data and B % args.mesh_data:
        p.error(f"batch {B} must divide over --mesh-data {args.mesh_data}")
    spk = speaker_ids(args.speaker, B, cfg, device)
    params = load_params(args.model, cfg, device)
    codes_t = torch.from_numpy(codes).to(device)
    if args.mesh_data:
        devices = ([torch.device("cuda", i) for i in range(args.mesh_data)]
                   if device.type == "cuda" else [device] * args.mesh_data)
        wav = decode_from_codes_sharded(
            params, cfg.model, codes_t, spk, args.seed, devices,
            args.temperature, args.greedy, args.gen_impl)
    else:
        wav = decode_from_codes(params, cfg.model, codes_t, spk, args.seed,
                                args.temperature, args.greedy,
                                args.gen_impl)
    wav = wav.cpu().numpy()

    if not batched:
        dest = args.output or "out.wav"
        save_wav(dest, wav[0], cfg.data.sr)
        print(f"wrote {dest}: {wav.shape[1]} samples")
    else:
        outdir = args.output or "dec_out"
        os.makedirs(outdir, exist_ok=True)
        stem = os.path.splitext(os.path.basename(args.input))[0]
        for i, row in enumerate(wav):
            save_wav(os.path.join(outdir, f"{stem}_{i:03d}.wav"), row,
                     cfg.data.sr)
        shard = (f" over {args.mesh_data} devices" if args.mesh_data
                 else "")
        print(f"wrote {B} files to {outdir}/: {wav.shape[1]} samples each "
              f"in one batch-{B} decode{shard}")
    print_launch_counts()


if __name__ == "__main__":
    main()

"""Generation CLI (port of ``vqvae_tpu/cli/generate.py``; console script
``vqvae-torch-generate``): wav -> encoder -> VQ codes -> decode -> wav.

    vqvae-torch-generate -i in.wav -m weights.npz -s 3 -o out.wav

Several inputs run as one batched decode (padded to the longest, each
output cut back to its own length).  ``--gen-impl`` as in
``vqvae-torch-decode``.  Runs on the card unless given ``--device
cpu``; the last line is the kernels' launch counts.
"""

from __future__ import annotations

import argparse
import os

import numpy as np
import torch

from vqvae_tpu_torch.audio.wav_io import load_wav, save_wav, trim_silence
from vqvae_tpu_torch.cli.common import (
    add_config_args,
    add_device_arg,
    codec_config,
    load_params,
    output_names,
    print_launch_counts,
    resolve_device,
    speaker_ids,
)
from vqvae_tpu_torch.infer.fastgen import IMPLS, synthesize


def batch_waveforms(wavs, hop):
    """Pad a ragged list of waveforms into one ``[B, T_pad]`` batch.

    Each file's usable length is rounded down to a hop multiple (whole
    latent frames); T_pad is the longest such length.  Returns (batch,
    lengths).  For a shorter file the zero padding can reach its last
    few latent frames through the encoder's receptive field, so its
    final samples may differ slightly from a solo run."""
    lengths = [len(w) - len(w) % hop for w in wavs]
    for i, n in enumerate(lengths):
        if n <= 0:   # not assert: must also fire under python -O
            raise SystemExit(f"input {i} is shorter than one latent frame "
                             f"({hop} samples) after trimming")
    batch = np.zeros((len(wavs), max(lengths)), np.float32)
    for i, (w, n) in enumerate(zip(wavs, lengths)):
        batch[i, :n] = w[:n]
    return batch, lengths


def _output_names(paths):
    """<stem>_gen.wav per input, de-duplicated across directories."""
    return output_names(paths, "_gen.wav")


def main(argv=None) -> None:
    p = argparse.ArgumentParser(
        description="Reconstruct audio through the VQ-VAE codec")
    add_config_args(p)
    add_device_arg(p)
    p.add_argument("-i", "--input", required=True, nargs="+",
                   help="input wav file(s); several run as one batch")
    p.add_argument("-o", "--output", default=None,
                   help="output wav (one input; default out.wav) or output "
                        "directory (several inputs; default gen_out/)")
    p.add_argument("-m", "--model", required=True,
                   help="weights .npz or port training run dir")
    p.add_argument("-s", "--speaker", type=int, nargs="+", default=[0],
                   help="speaker id(s): one per input, or a single id "
                        "broadcast to all")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--temperature", type=float, default=1.0)
    p.add_argument("--gen-impl", default="lax", choices=IMPLS)
    p.add_argument("--greedy", action="store_true",
                   help="argmax decoding instead of sampling")
    p.add_argument("--no-trim", action="store_true")
    args = p.parse_args(argv)

    device = resolve_device(args.device)
    cfg = codec_config(args, "vqvae-torch-generate")
    wavs = []
    for path in args.input:
        w = load_wav(path, cfg.data.sr)
        if not args.no_trim:
            w = trim_silence(w, cfg.data.top_db)
        wavs.append(w)
    spk = speaker_ids(args.speaker, len(wavs), cfg, device)
    batch, lengths = batch_waveforms(wavs, cfg.model.hop)
    params = load_params(args.model, cfg, device)
    with torch.no_grad():
        out, codes = synthesize(params, cfg.model,
                                torch.from_numpy(batch).to(device), spk,
                                args.seed, args.temperature, args.greedy,
                                args.gen_impl)
    out, codes = out.cpu().numpy(), codes.cpu().numpy()

    if len(wavs) == 1:
        dest = args.output or "out.wav"
        save_wav(dest, out[0, :lengths[0]], cfg.data.sr)
        print(f"wrote {dest}: {lengths[0]} samples "
              f"({lengths[0] / cfg.data.sr:.2f}s), "
              f"{len(np.unique(codes))} distinct codes")
    else:
        outdir = args.output or "gen_out"
        os.makedirs(outdir, exist_ok=True)
        for name, row, n in zip(_output_names(args.input), out, lengths):
            save_wav(os.path.join(outdir, name), row[:n], cfg.data.sr)
        total = sum(lengths)
        print(f"wrote {len(wavs)} files to {outdir}/: {total} samples "
              f"({total / cfg.data.sr:.2f}s) in one batch-{len(wavs)} "
              f"decode, {len(np.unique(codes))} distinct codes")
    print_launch_counts()


if __name__ == "__main__":
    main()

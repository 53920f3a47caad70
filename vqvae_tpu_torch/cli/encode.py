"""Encode CLI (port of ``vqvae_tpu/cli/encode.py``; console script
``vqvae-torch-encode``): wav -> discrete VQ code ids (.npy, int32).

    vqvae-torch-encode -i in.wav -m weights.npz -o codes.npy

Several ``-i`` inputs write one .npy per file into a directory (stems
de-duplicated across directories); with ``--stack`` equal-length files
land in one ``[B, T_lat]`` array, ``vqvae-torch-decode``'s batched
input.  Files are encoded one by one, each exactly as alone.  The audio
is mu-law round-tripped on the host before encoding, as every encode
path does.  ``--set model.encoder_kernel=pallas`` runs the fused
encoder kernel.  Runs on the card unless given ``--device cpu``; the
last line is the kernels' launch counts.
"""

from __future__ import annotations

import argparse
import os

import numpy as np
import torch

from vqvae_tpu_torch.audio.mu_law import mu_law_round_trip
from vqvae_tpu_torch.audio.wav_io import load_wav, trim_silence
from vqvae_tpu_torch.cli.common import (
    add_config_args,
    add_device_arg,
    codec_config,
    load_params,
    output_names,
    print_launch_counts,
    resolve_device,
)
from vqvae_tpu_torch.infer.fastgen import encode_to_codes


def encode_wav(params, cfg, wav: np.ndarray, device) -> np.ndarray:
    """int32 codes of one waveform, cut to whole latent frames."""
    m = cfg.model
    T = len(wav) - len(wav) % m.hop
    x = mu_law_round_trip(torch.from_numpy(
        np.ascontiguousarray(wav[:T], np.float32))[None], m.mu,
        m.mulaw_mode)
    with torch.no_grad():
        codes = encode_to_codes(params, m, x.to(device))
    return codes[0].to(torch.int32).cpu().numpy()


def _encode_one(params, cfg, path: str, no_trim: bool, device) -> np.ndarray:
    wav = load_wav(path, cfg.data.sr)
    if not no_trim:
        wav = trim_silence(wav, cfg.data.top_db)
    if len(wav) < cfg.model.hop:   # not assert: must also fire under -O
        raise SystemExit(f"{path} is shorter than one latent frame "
                         f"({cfg.model.hop} samples) after trimming")
    return encode_wav(params, cfg, wav, device)


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description="Encode wav to VQ code ids")
    add_config_args(p)
    add_device_arg(p)
    p.add_argument("-i", "--input", required=True, nargs="+",
                   help="input wav file(s)")
    p.add_argument("-o", "--output", default=None,
                   help="codes .npy (one input; default codes.npy), "
                        "output directory (several inputs; default "
                        "codes_out/), or a .npy path with --stack")
    p.add_argument("-m", "--model", required=True,
                   help="weights .npz or port training run dir")
    p.add_argument("--no-trim", action="store_true")
    p.add_argument("--stack", action="store_true",
                   help="several equal-length inputs -> one [B, T_lat] "
                        ".npy (vqvae-torch-decode's batched input)")
    args = p.parse_args(argv)

    device = resolve_device(args.device)
    cfg = codec_config(args, "vqvae-torch-encode")
    params = load_params(args.model, cfg, device)
    all_codes = [_encode_one(params, cfg, path, args.no_trim, device)
                 for path in args.input]
    rate = f"{cfg.data.sr / cfg.model.hop:.1f} Hz latent rate"

    if len(all_codes) == 1 and not args.stack:
        dest = args.output or "codes.npy"
        np.save(dest, all_codes[0])
        print(f"wrote {dest}: {len(all_codes[0])} codes "
              f"({rate}, K={cfg.model.K})")
    elif args.stack:
        lens = {len(c) for c in all_codes}
        if len(lens) != 1:
            p.error(f"--stack needs equal-length inputs, got code "
                    f"lengths {sorted(len(c) for c in all_codes)}")
        dest = args.output or "codes.npy"
        np.save(dest, np.stack(all_codes))
        print(f"wrote {dest}: [{len(all_codes)}, {lens.pop()}] codes "
              f"({rate}, K={cfg.model.K})")
    else:
        outdir = args.output or "codes_out"
        os.makedirs(outdir, exist_ok=True)
        for name, c in zip(output_names(args.input, ".npy"), all_codes):
            np.save(os.path.join(outdir, name), c)
        print(f"wrote {len(all_codes)} files to {outdir}/ "
              f"({rate}, K={cfg.model.K})")
    print_launch_counts()


if __name__ == "__main__":
    main()

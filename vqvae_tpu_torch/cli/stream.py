"""Streaming CLI (port of ``vqvae_tpu/cli/stream.py``; console script
``vqvae-torch-stream``): decode VQ codes to wav push by push, reporting
each push's latency and realtime factor.

    vqvae-torch-stream -i codes.npy -m weights.npz --chunk-frames 16

The input is code ids (.npy, as for ``vqvae-torch-decode``) or a wav
(encoded first, as by ``vqvae-torch-generate``).  With
``--encode-chunk N`` a wav is stream-encoded too: N samples per push
through ``infer/enc_streaming.StreamingEncoder``, the codes feeding the
decoder as they finalize (the live full-duplex codec).  The output
equals ``vqvae-torch-decode``'s for the same codes and seed, greedy and
sampled (``infer/streaming.StreamingSynthesizer``), and the streamed
codes equal the one-shot encode's.  Runs on the card unless given
``--device cpu``; the last line is the kernels' launch counts.
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from vqvae_tpu_torch.audio.wav_io import load_wav, save_wav
from vqvae_tpu_torch.cli.common import (
    add_config_args,
    add_device_arg,
    codec_config,
    load_params,
    print_launch_counts,
    resolve_device,
    speaker_ids,
)
from vqvae_tpu_torch.cli.encode import encode_wav
from vqvae_tpu_torch.infer.enc_streaming import StreamingEncoder
from vqvae_tpu_torch.infer.streaming import StreamingSynthesizer


def main(argv=None) -> None:
    p = argparse.ArgumentParser(
        description="Streaming decode: codes/wav -> wav push by push")
    add_config_args(p)
    add_device_arg(p)
    p.add_argument("-i", "--input", required=True,
                   help="codes .npy (int ids) or input .wav")
    p.add_argument("-o", "--output", default="out.wav")
    p.add_argument("-m", "--model", required=True,
                   help="weights .npz or port training run dir")
    p.add_argument("-s", "--speaker", type=int, default=0)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--temperature", type=float, default=1.0)
    p.add_argument("--greedy", action="store_true")
    p.add_argument("--chunk-frames", type=int, default=16,
                   help="code frames per push (chunk latency = "
                        "frames*hop samples)")
    p.add_argument("--encode-chunk", type=int, default=0,
                   help="wav input only: stream-encode the audio too, this "
                        "many samples per push; 0 = one-shot encode")
    args = p.parse_args(argv)

    device = resolve_device(args.device)
    cfg = codec_config(args, "vqvae-torch-stream")
    m, sr = cfg.model, cfg.data.sr
    spk = speaker_ids([args.speaker], 1, cfg, device)
    params = load_params(args.model, cfg, device)

    wav = codes = None
    if args.input.endswith(".npy"):
        if args.encode_chunk:
            p.error("--encode-chunk needs a wav input")
        codes = np.load(args.input).astype(np.int64).reshape(1, -1)
        if codes.size and (codes.min() < 0 or codes.max() >= m.K):
            p.error(f"code ids must be in [0, {m.K})")
        n_frames = codes.shape[1]
    else:
        wav = load_wav(args.input, sr)
        if args.encode_chunk:
            n_frames = len(wav) // m.hop   # what the stream will emit
        else:
            codes = encode_wav(params, cfg, wav, device)[None].astype(
                np.int64)
            n_frames = codes.shape[1]
    if n_frames == 0:
        raise SystemExit("input contains no code frames (wav shorter than "
                         "one hop, or empty codes file)")
    C = max(1, args.chunk_frames)
    lens = [C] * (n_frames // C) + ([n_frames % C] if n_frames % C else [])

    def make_syn():
        return StreamingSynthesizer(params, m, spk, args.seed,
                                    args.temperature, args.greedy)

    # the first kernel call of the process builds the kernels: warm up
    # on a throwaway synthesizer so the per-push times are serving times
    t0 = time.perf_counter()
    warm = make_syn()
    warm.push(torch.zeros((1, lens[0]), dtype=torch.long, device=device))
    warm.flush().cpu()
    print(f"warmup: {time.perf_counter() - t0:.1f}s", flush=True)

    syn = make_syn()
    pieces = []

    def push_timed(chunk_codes, i):
        t0 = time.perf_counter()
        piece = syn.push(torch.from_numpy(chunk_codes).to(device))
        piece = piece.cpu().numpy()[0]          # waits for the card
        dt = time.perf_counter() - t0
        pieces.append(piece)
        rt = len(piece) / sr / dt if dt > 0 else float("inf")
        print(f"chunk {i}: {len(piece)} samples in {dt * 1e3:.1f} ms "
              f"({rt:.1f}x realtime)", flush=True)

    if args.encode_chunk:
        enc = StreamingEncoder(params, m, device)
        print(f"live encode: {args.encode_chunk} samples/push, encoder "
              f"lookahead {enc.lookahead} samples", flush=True)
        buf = np.zeros((1, 0), np.int64)
        idx = 0

        def drain(final=False):
            nonlocal buf, idx
            while idx < len(lens) and (buf.shape[1] >= lens[idx] or final):
                push_timed(buf[:, :lens[idx]], idx)
                buf = buf[:, lens[idx]:]
                idx += 1

        for a in range(0, len(wav), args.encode_chunk):
            buf = np.concatenate(
                [buf, enc.push(wav[None, a:a + args.encode_chunk])], axis=1)
            drain()
        buf = np.concatenate([buf, enc.flush()], axis=1)
        drain(final=True)
        if idx != len(lens) or buf.shape[1]:
            raise RuntimeError(f"the streaming encoder did not emit the "
                               f"stream's {n_frames} frames")
    else:
        lo = 0
        for i, L in enumerate(lens):
            push_timed(codes[:, lo:lo + L], i)
            lo += L
    pieces.append(syn.flush().cpu().numpy()[0])
    out = np.concatenate(pieces)
    save_wav(args.output, out, sr)
    print(f"wrote {args.output}: {len(out)} samples ({len(out) / sr:.2f} s) "
          f"from {n_frames} code frames")
    print_launch_counts()


if __name__ == "__main__":
    main()

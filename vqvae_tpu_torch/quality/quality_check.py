"""Reproducible reconstruction-quality check (port of
``scripts/quality_check.py``).

Trains the tiny preset (EMA codebook + dead-code restart) on the
synthetic harmonic dataset, reconstructs a held-out tone through the
full codec (encode -> VQ -> AR decode, sampled at temperature 0.8), and
reports:

  band_spectral_correlation — Pearson correlation of band-averaged
      power spectra (64 log-spaced bands, 50 Hz–8 kHz) between the
      mu-law-256 round-tripped input (the model's fidelity ceiling) and
      the reconstruction; the log-power variant is reported too.
  harmonic_energy_ratio — fraction of reconstruction power within
      +-8 Hz of the clip's harmonics (110/220 Hz), vs the ceiling's.
  train_codebook_usage — codebook usage fraction at the last training
      log step (usage on the single-tone eval clip is naturally low).

``--engine`` picks the decode path the metrics witness, with the JAX
script's names:

  lax           — one-shot ``infer/fastgen.decode_from_codes``
                  (``impl="lax"``)
  pallas        — the same with ``impl="pallas"``; both run the fused
                  decode kernel (``kernels/decode_cuda.generate_ids``), so
                  the two give the same waveform bit for bit
  pallas-stream — ``infer/kernel_stream.KernelStreamDecoder``, the object
                  ``vqvae-torch-serve --engine kernel`` decodes through
                  (one resumable kernel call a request)

Repeat ``--engine`` to evaluate several paths from ONE training run;
the top-level metrics mirror the first.

``--speaker-matrix`` adds the multi-speaker conditioning witness: for
each speaker s, a held-out tone at the speaker's fundamental f0*(s+1)
(the ``SineDataset`` contract) is encoded once and decoded as EVERY
speaker s'.  ``harmonic_ratio[s][s']`` is the fraction of the
reconstruction's power at the SOURCE speaker's partials;
``target_ratio[s][s']`` the same at the DECODING speaker's partials.
Conditioning steers synthesis iff the diagonal dominates.

``quality_gate`` holds a record to the thresholds of
``tests/test_quality.py`` (the converged 6000-step point):

    python -m vqvae_tpu_torch.quality.quality_check --steps 6000 \\
        --engine lax --engine pallas-stream --speaker-matrix

``--device cuda`` (the default) fails without a GPU; ``--device cpu``
runs the kernels' plain versions.  It prints the record as one JSON
line and, last, the kernel launches (``kernel launches: {...}``, as the
port's CLIs do); on stderr the run directory (``make_demo -m`` takes
it) and what of the gate it fails (``quality gate: ...``; only a
6000-step run with 'pallas-stream' and the matrix can pass).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import tempfile

import numpy as np
import torch

from vqvae_tpu_torch.audio.mu_law import (
    mu_law_decode,
    mu_law_encode,
    mu_law_round_trip,
)
from vqvae_tpu_torch.cli.common import (
    add_device_arg,
    print_launch_counts,
    resolve_device,
)

ENGINES = ("lax", "pallas", "pallas-stream")


def band_power(wav: np.ndarray, sr: int, n_bands: int = 64,
               fmin: float = 50.0, fmax: float = 8000.0,
               log: bool = False) -> np.ndarray:
    f = np.fft.rfftfreq(len(wav), 1.0 / sr)
    p = np.abs(np.fft.rfft(wav)) ** 2
    edges = np.geomspace(fmin, fmax, n_bands + 1)
    out = np.empty(n_bands)
    for i in range(n_bands):
        sel = (f >= edges[i]) & (f < edges[i + 1])
        out[i] = p[sel].mean()
    return 10.0 * np.log10(out + 1e-12) if log else out


def harmonic_ratio(wav: np.ndarray, sr: int, f0: float,
                   n_harm: int = 4, width: float = 8.0) -> float:
    f = np.fft.rfftfreq(len(wav), 1.0 / sr)
    p = np.abs(np.fft.rfft(wav)) ** 2
    sel = np.zeros(len(f), bool)
    for k in range(1, n_harm + 1):
        sel |= np.abs(f - k * f0) <= width
    return float(p[sel].sum() / (p.sum() + 1e-12))


def _held_out_tone(sr: int, f0: float, phase: float = 1.234,
                   seconds: float = 0.5) -> np.ndarray:
    """A fresh-phase harmonic clip in a speaker's timbre (fundamental
    + one octave, the SineDataset recipe with unseen phases)."""
    t = np.arange(int(sr * seconds), dtype=np.float32) / sr
    return (0.6 * np.sin(2 * np.pi * f0 * t + phase)
            + 0.3 * np.sin(4 * np.pi * f0 * t + 1.7 * phase)
            ).astype(np.float32)


def _device(params) -> torch.device:
    return params["vq"]["codebook"].device


def _decode(params, cfg, codes, speakers, seed: int, temperature: float,
            engine: str) -> np.ndarray:
    """Decode ``[B, n]`` code ids as ``speakers`` through ``engine``;
    'pallas-stream' is the daemon's path (``cli/serve.Codec`` builds
    exactly this decoder for its ``kernel`` engine)."""
    if engine == "pallas-stream":
        from vqvae_tpu_torch.infer.kernel_stream import KernelStreamDecoder
        dec = KernelStreamDecoder(params, cfg.model)
        return dec.decode(np.asarray(codes), speakers, seed, temperature)
    from vqvae_tpu_torch.infer.fastgen import decode_from_codes
    dev = _device(params)
    with torch.no_grad():
        wav = decode_from_codes(
            params, cfg.model, torch.as_tensor(np.asarray(codes),
                                               device=dev),
            torch.as_tensor(np.asarray(speakers, np.int64), device=dev),
            seed, temperature=temperature, impl=engine)
    return wav.cpu().numpy()


def _encode(params, cfg, wav: np.ndarray) -> np.ndarray:
    """Hop-trim + mu-law round trip + encode — the front half of
    infer/fastgen.synthesize, shared by every engine here."""
    from vqvae_tpu_torch.infer.fastgen import encode_to_codes
    T = wav.shape[-1] - wav.shape[-1] % cfg.model.hop
    x = torch.from_numpy(wav[None, :T]).to(_device(params))
    x = mu_law_round_trip(x, cfg.model.mu, cfg.model.mulaw_mode)
    with torch.no_grad():
        return encode_to_codes(params, cfg.model, x).cpu().numpy()


def _reconstruct(params, cfg, f0: float, seed: int, temperature: float,
                 engine: str):
    """Speaker 0's held-out tone at ``f0`` through one engine:
    (input tone, codes, reconstruction, mu-law-256 ceiling), the
    ceiling cut to the reconstruction's length."""
    wav = _held_out_tone(cfg.data.sr, f0)
    codes = _encode(params, cfg, wav)
    recon = _decode(params, cfg, codes, [0], seed, temperature, engine)[0]
    # fidelity ceiling: the mu-law-256 round trip of the input
    T = len(recon)
    ceiling = mu_law_decode(mu_law_encode(torch.from_numpy(wav[:T]),
                                          cfg.model.mu),
                            cfg.model.mu).numpy()
    return wav, codes, recon, ceiling


def eval_quality(params, cfg, engine: str = "lax", f0: float = 110.0,
                 seed: int = 0, temperature: float = 0.8) -> dict:
    """Reconstruction metrics for speaker 0's held-out tone through one
    decode engine."""
    sr = cfg.data.sr
    _, codes, recon, ceiling = _reconstruct(params, cfg, f0, seed,
                                            temperature, engine)
    # linear-power band correlation: where the signal's energy lives
    # (peak-dominated, the perceptually meaningful comparison for
    # harmonic content). The log-domain variant is reported too but is
    # dominated by the sampling-noise floor of the empty bands.
    corr = float(np.corrcoef(band_power(ceiling, sr),
                             band_power(recon, sr))[0, 1])
    corr_log = float(np.corrcoef(band_power(ceiling, sr, log=True),
                                 band_power(recon, sr, log=True))[0, 1])
    return {"engine": engine,
            "band_spectral_correlation": round(corr, 4),
            "band_spectral_correlation_log": round(corr_log, 4),
            "harmonic_energy_ratio": round(
                harmonic_ratio(recon, sr, f0), 4),
            "harmonic_energy_ratio_ceiling": round(
                harmonic_ratio(ceiling, sr, f0), 4),
            "eval_distinct_codes": int(len(np.unique(codes)))}


def eval_speaker_matrix(params, cfg, engine: str = "lax",
                        f0: float = 110.0, seed: int = 0,
                        temperature: float = 0.8) -> dict:
    """The conditioning witness: encode speaker s's held-out tone once,
    decode it as every speaker s'.  Partials are measured with
    ``n_harm=2`` at each speaker's OWN fundamental so the bands don't
    alias (110's 4th harmonic is 440 — speaker 3's fundamental)."""
    S = cfg.model.n_speakers
    sr = cfg.data.sr
    hr = np.zeros((S, S))       # power at the SOURCE speaker's partials
    tr = np.zeros((S, S))       # power at the DECODING speaker's
    for s in range(S):
        fs = f0 * (s + 1)
        wav = _held_out_tone(sr, fs, phase=0.4 + 0.3 * s)
        codes = _encode(params, cfg, wav)
        recon = _decode(params, cfg, np.repeat(codes, S, axis=0),
                        list(range(S)), seed + s, temperature, engine)
        for sp in range(S):
            hr[s, sp] = harmonic_ratio(recon[sp], sr, fs, n_harm=2)
            tr[s, sp] = harmonic_ratio(recon[sp], sr, f0 * (sp + 1),
                                       n_harm=2)
    off = ~np.eye(S, dtype=bool)
    rnd = lambda a: np.round(a, 4).tolist()  # noqa: E731
    return {"engine": engine, "f0": f0, "n_speakers": S,
            "harmonic_ratio": rnd(hr),
            "target_ratio": rnd(tr),
            "diag_mean": round(float(np.diag(hr).mean()), 4),
            "offdiag_mean": round(float(hr[off].mean()), 4),
            "target_diag_mean": round(float(np.diag(tr).mean()), 4),
            "target_offdiag_mean": round(float(tr[off].mean()), 4)}


def tiny_config(steps: int = 3000, batch_size: int = 16, vq: str = "ema",
                codebook_lr_mult: float = 1.0):
    """The tiny preset as ``train_tiny`` trains it."""
    from vqvae_tpu_torch.configs import get_config

    # vq modes: "ema" (EMA codebook + restart), "plain-restart"
    # (gradient codebook + usage-EMA restart), "plain" (the reference's
    # bare gradient codebook, which the JAX package measured collapsing
    # to 1/K codes on this dataset)
    ema = vq == "ema"
    restart = 0.0 if vq == "plain" else 1e-3
    cfg = get_config("tiny")
    return cfg.replace(
        model=dataclasses.replace(cfg.model, ema=ema,
                                  code_restart_threshold=restart),
        train=dataclasses.replace(
            cfg.train, num_steps=steps, batch_size=batch_size,
            codebook_lr_mult=codebook_lr_mult,
            log_every=max(1, steps // 10), checkpoint_every=steps))


def train_tiny(steps: int = 3000, batch_size: int = 16,
               out_dir: str | None = None, echo: bool = False,
               vq: str = "ema", codebook_lr_mult: float = 1.0,
               device="cuda"):
    """Train the tiny preset on the synthetic harmonic dataset; returns
    (params, cfg, last_log_line)."""
    from vqvae_tpu_torch.audio.datasets import SineDataset
    from vqvae_tpu_torch.train.loop import train

    cfg = tiny_config(steps, batch_size, vq, codebook_lr_mult)
    out_dir = out_dir or tempfile.mkdtemp(prefix="vqvae_quality_")
    state = train(cfg, SineDataset(cfg.data), out_dir, device=device,
                  echo=echo)
    with open(os.path.join(out_dir, "log.jsonl")) as f:
        last_log = [json.loads(line) for line in f][-1]
    return state.params, cfg, last_log


def run_quality_check(steps: int = 3000, batch_size: int = 16,
                      out_dir: str | None = None,
                      echo: bool = False, vq: str = "ema",
                      codebook_lr_mult: float = 1.0,
                      engines: tuple = ("lax",),
                      speaker_matrix: bool = False,
                      device="cuda") -> dict:
    params, cfg, last_log = train_tiny(steps, batch_size, out_dir,
                                       echo, vq, codebook_lr_mult, device)
    result = {"steps": steps, "batch_size": batch_size,
              "train_codebook_usage": round(
                  float(last_log["codebook_usage"]), 4),
              "final_loss1": round(float(last_log["loss1"]), 4),
              "vq": vq, "codebook_lr_mult": codebook_lr_mult,
              "K": cfg.model.K,
              "engines": {e: eval_quality(params, cfg, e)
                          for e in engines}}
    # top-level metrics mirror the first engine
    result.update({k: v for k, v in result["engines"][engines[0]].items()
                   if k != "engine"})
    if speaker_matrix:
        # witness the SERVED engine when it's requested — the matrix
        # then covers the path users actually hit
        eng = ("pallas-stream" if "pallas-stream" in engines
               else engines[0])
        result["speaker_matrix"] = eval_speaker_matrix(params, cfg, eng)
    return result


def quality_gate(rec: dict) -> list[str]:
    """The conditions of ``tests/test_quality.py`` that ``rec`` (a
    ``run_quality_check`` record) fails; empty when it passes.  The
    served engine ('pallas-stream') and the speaker matrix through it
    must be in the record."""
    nan = float("nan")
    served = rec.get("engines", {}).get("pallas-stream", {})
    m = rec.get("speaker_matrix", {})

    def at(d, k):
        return d.get(k, nan)

    checks = [
        (at(rec, "band_spectral_correlation") >= 0.9,
         f"band_spectral_correlation {at(rec, 'band_spectral_correlation')}"
         " < 0.9"),
        (at(rec, "harmonic_energy_ratio") >= 0.5,
         f"harmonic_energy_ratio {at(rec, 'harmonic_energy_ratio')} < 0.5"),
        (at(rec, "train_codebook_usage") >= 0.5,
         f"train_codebook_usage {at(rec, 'train_codebook_usage')} < 0.5"),
        (at(served, "band_spectral_correlation") >= 0.9,
         "pallas-stream band_spectral_correlation "
         f"{at(served, 'band_spectral_correlation')} < 0.9"),
        (at(served, "harmonic_energy_ratio") >= 0.5,
         "pallas-stream harmonic_energy_ratio "
         f"{at(served, 'harmonic_energy_ratio')} < 0.5"),
        (m.get("engine") == "pallas-stream",
         f"speaker_matrix engine {m.get('engine')!r} != 'pallas-stream'"),
        (at(m, "diag_mean") >= 0.5,
         f"speaker_matrix diag_mean {at(m, 'diag_mean')} < 0.5"),
        (at(m, "diag_mean") >= 2.0 * at(m, "offdiag_mean"),
         f"speaker_matrix diag_mean {at(m, 'diag_mean')} < 2 x "
         f"offdiag_mean {at(m, 'offdiag_mean')}"),
        (at(m, "target_offdiag_mean") >= 0.4,
         "speaker_matrix target_offdiag_mean "
         f"{at(m, 'target_offdiag_mean')} < 0.4"),
    ]
    return [msg for ok, msg in checks if not ok]


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(
        description="train tiny and witness its reconstructions")
    ap.add_argument("--steps", type=int, default=3000)
    ap.add_argument("--batch-size", type=int, default=16)
    ap.add_argument("--echo", action="store_true")
    ap.add_argument("--vq", default="ema",
                    choices=["ema", "plain-restart", "plain"])
    ap.add_argument("--codebook-lr-mult", type=float, default=1.0,
                    help="non-EMA modes: scale the codebook leaf's "
                         "Adam update (train/state.py)")
    ap.add_argument("--engine", action="append", choices=list(ENGINES),
                    help="decode engine(s) to witness (repeatable; "
                         "default lax). 'pallas-stream' is the "
                         "daemon's serving path")
    ap.add_argument("--speaker-matrix", action="store_true",
                    help="add the per-speaker conditioning matrix "
                         "(decoded through 'pallas-stream' when it is "
                         "an --engine, else the first)")
    add_device_arg(ap)
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    out_dir = tempfile.mkdtemp(prefix="vqvae_quality_")
    print(f"run directory: {out_dir}", file=sys.stderr, flush=True)
    rec = run_quality_check(
        args.steps, args.batch_size, out_dir, echo=args.echo, vq=args.vq,
        codebook_lr_mult=args.codebook_lr_mult,
        engines=tuple(args.engine or ("lax",)),
        speaker_matrix=args.speaker_matrix, device=device)
    failed = quality_gate(rec)
    print("quality gate: " + ("; ".join(failed) if failed else "passed"),
          file=sys.stderr, flush=True)
    print(json.dumps(rec))
    print_launch_counts()


if __name__ == "__main__":
    main()

"""The audio demo (port of ``scripts/make_demo.py``): a synthetic
before/after of the codec — the held-out input tone, its mu-law-256
round trip (the model's fidelity ceiling: the best ANY mu-law codec can
reconstruct) and the codec's reconstruction (encode -> VQ -> AR decode
through the one-shot ``lax`` engine, sampled at temperature 0.8) as
wav files, ``metrics.json`` with the JAX script's keys, and, where
matplotlib imports, a log-spectrogram triptych PNG.

    python -m vqvae_tpu_torch.quality.quality_check --steps 6000  # train
    python -m vqvae_tpu_torch.quality.make_demo -m <run_dir> [-o DIR]

or let it train its own tiny model first:

    python -m vqvae_tpu_torch.quality.make_demo --steps 6000

``-m`` is a port training run (``config.json`` + ``checkpoints/``; tiny
when it has no ``config.json``) or a weights ``.npz``.  ``-o`` defaults
to ``demo/`` inside the run directory; ``docs/demo`` is refused, since
it holds the JAX package's committed demo.  ``--device cuda`` (the
default) fails without a GPU; ``--device cpu`` runs the kernels' plain
versions.
"""

from __future__ import annotations

import argparse
import json
import os
import tempfile

import numpy as np

from vqvae_tpu_torch.cli.common import (
    add_device_arg,
    load_params,
    resolve_config,
    resolve_device,
)
from vqvae_tpu_torch.quality.quality_check import (
    _reconstruct,
    band_power,
    harmonic_ratio,
    train_tiny,
)


def _spectrogram(wav: np.ndarray, sr: int, nfft: int = 512):
    """Log-power STFT via numpy (no librosa in this environment)."""
    hop = nfft // 4
    n = 1 + (len(wav) - nfft) // hop
    frames = np.stack([wav[i * hop:i * hop + nfft] for i in range(n)])
    spec = np.abs(np.fft.rfft(frames * np.hanning(nfft), axis=1)) ** 2
    return 10.0 * np.log10(spec.T + 1e-10)


def _in_docs_demo(path: str) -> bool:
    parts = os.path.realpath(path).split(os.sep)
    return any(parts[i:i + 2] == ["docs", "demo"]
               for i in range(len(parts) - 1))


def _triptych(clips: dict, sr: int, out: str) -> None:
    """``spectrogram_triptych.png`` in ``out``; one line and nothing
    else without matplotlib."""
    try:
        import matplotlib
        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
    except ImportError:
        print("matplotlib is not installed: no spectrogram_triptych.png")
        return
    fig, axes = plt.subplots(1, 3, figsize=(12, 3.2), sharey=True)
    for ax, (name, wav) in zip(axes, clips.items()):
        s = _spectrogram(np.asarray(wav, np.float64), sr)
        ax.imshow(s, origin="lower", aspect="auto", cmap="magma",
                  extent=[0, len(wav) / sr, 0, sr / 2 / 1000],
                  vmin=s.max() - 80, vmax=s.max())
        ax.set_title(name)
        ax.set_xlabel("s")
        ax.set_ylim(0, 2)       # the harmonics live below 2 kHz
    axes[0].set_ylabel("kHz")
    fig.tight_layout()
    fig.savefig(os.path.join(out, "spectrogram_triptych.png"), dpi=110)
    plt.close(fig)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description="write the codec's audio demo")
    ap.add_argument("-m", "--model",
                    help="run dir (config.json + checkpoints) or weights "
                         ".npz; trains a fresh tiny model when omitted")
    ap.add_argument("-o", "--out", default=None,
                    help="output directory (default: demo/ in the run "
                         "directory; never docs/demo)")
    ap.add_argument("--steps", type=int, default=6000,
                    help="training steps when -m is omitted")
    ap.add_argument("--seed", type=int, default=0)
    add_device_arg(ap)
    args = ap.parse_args(argv)
    if args.out is not None and _in_docs_demo(args.out):
        raise SystemExit(f"-o {args.out}: docs/demo holds the JAX "
                         "package's committed demo; write the port's "
                         "elsewhere")
    device = resolve_device(args.device)

    if args.model:
        run_dir = (args.model if os.path.isdir(args.model)
                   else os.path.dirname(os.path.abspath(args.model)))
        has_cfg = os.path.isfile(os.path.join(args.model, "config.json"))
        cfg = resolve_config(argparse.Namespace(
            preset=None if has_cfg else "tiny", model=args.model))
        params = load_params(args.model, cfg, device)
    else:
        run_dir = tempfile.mkdtemp(prefix="vqvae_quality_")
        params, cfg, _ = train_tiny(steps=args.steps, out_dir=run_dir,
                                    device=device)
    out = args.out or os.path.join(run_dir, "demo")

    sr = cfg.data.sr
    tone, _, recon, ceiling = _reconstruct(params, cfg, 110.0, args.seed,
                                           0.8, "lax")
    T = len(recon)
    os.makedirs(out, exist_ok=True)
    clips = {"input": tone[:T], "mulaw_ceiling": ceiling,
             "reconstruction": recon}
    from vqvae_tpu_torch.audio.wav_io import save_wav
    for name, wav in clips.items():
        save_wav(os.path.join(out, f"{name}.wav"),
                 np.asarray(wav, np.float32), sr)
    _triptych(clips, sr, out)

    metrics = {
        "band_spectral_correlation": round(float(np.corrcoef(
            band_power(ceiling, sr), band_power(recon, sr))[0, 1]), 4),
        "harmonic_energy_ratio": round(
            harmonic_ratio(recon, sr, 110.0), 4),
        "harmonic_energy_ratio_ceiling": round(
            harmonic_ratio(ceiling, sr, 110.0), 4),
        "sr": sr, "samples": int(T),
        "files": sorted(os.listdir(out)),
    }
    with open(os.path.join(out, "metrics.json"), "w") as f:
        json.dump(metrics, f, indent=1)
    print(json.dumps(metrics))


if __name__ == "__main__":
    main()

"""What the measurement tools share: the card line, synchronised wall
timing and best of reps, percentiles, the seeded batch and train state
every training tool starts from, and the JSON line.  It imports torch
only inside the functions that need it, so the serve bench, a client
like the JAX script's, starts without it."""

from __future__ import annotations

import argparse
import dataclasses
import json
import subprocess
import time

import numpy as np


def smi_rows() -> list[tuple[str, str]]:
    """(name, power limit) of each GPU as ``nvidia-smi --query-gpu=
    name,power.limit --format=csv,noheader`` prints them; empty where
    nvidia-smi cannot run."""
    try:
        r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                            "--format=csv,noheader"], capture_output=True,
                           text=True, timeout=60)
    except (OSError, subprocess.TimeoutExpired):
        return []
    rows = []
    for line in r.stdout.strip().splitlines():
        name, _, power = line.rpartition(",")
        rows.append((name.strip(), power.strip()))
    return rows


def _watts(power: str) -> float | None:
    try:
        return float(power.split()[0])
    except (IndexError, ValueError):
        return None


def card(device) -> dict:
    """``{"device": the card's name, "power_limit_w": its limit}`` as
    nvidia-smi prints them (the name is ``torch.cuda.get_device_name``'s);
    on the CPU ``{"device": "cpu", "power_limit_w": None}``.  ``device``
    is a torch device or its name (``cuda:1``)."""
    dev = str(device)
    if not dev.startswith("cuda"):
        return {"device": "cpu", "power_limit_w": None}
    idx = int(dev.split(":")[1]) if ":" in dev else 0
    rows = smi_rows()
    if idx < len(rows):
        return {"device": rows[idx][0], "power_limit_w": _watts(rows[idx][1])}
    import torch
    return {"device": torch.cuda.get_device_name(idx), "power_limit_w": None}


def sync(dev) -> None:
    """Wait for the card (nothing to wait for on the CPU)."""
    if dev.type == "cuda":
        import torch
        torch.cuda.synchronize(dev)


def wall_ms(fn, n: int, dev) -> float:
    """Host milliseconds per call over ``n`` calls of fn, between two
    synchronisations: the card's work is inside the interval."""
    sync(dev)
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    sync(dev)
    return 1e3 * (time.perf_counter() - t0) / n


def best_ms(fn, runs: int, reps: int, dev) -> float:
    """The best of ``reps`` ``wall_ms(fn, runs)``."""
    return min(wall_ms(fn, runs, dev) for _ in range(reps))


def percentile(xs, q: float) -> float:
    """numpy's linear-interpolation percentile, as the JAX scripts take
    it."""
    return float(np.percentile(np.asarray(xs, np.float64), q))


def make_batch(cfg, B: int, device, seed: int = 0):
    """The scripts' seeded batch: wav ``uniform(-0.9, 0.9, (B, T+1))``
    float32 and speaker ``arange(B) % n_speakers``, on ``device``."""
    import torch
    rng = np.random.default_rng(seed)
    wav = rng.uniform(-0.9, 0.9, (B, cfg.data.length + 1)).astype(np.float32)
    spk = np.arange(B) % max(cfg.model.n_speakers, 1)
    return (torch.from_numpy(wav).to(device),
            torch.from_numpy(spk).to(device))


def make_state(cfg, device, seed: int = 0):
    """``train/state.py::create_train_state`` with its init seeded by
    ``seed``."""
    from vqvae_tpu_torch.train.state import create_train_state
    cfg = cfg.replace(train=dataclasses.replace(cfg.train, seed=seed))
    return create_train_state(cfg, device)


def with_model(cfg, **kw):
    """``cfg`` with model fields replaced (None values left alone)."""
    kw = {k: v for k, v in kw.items() if v is not None}
    return cfg.replace(model=dataclasses.replace(cfg.model, **kw))


def with_batch(cfg, B: int):
    """``cfg`` at batch size ``B``."""
    return cfg.replace(train=dataclasses.replace(cfg.train, batch_size=B))


def add_train_args(p: argparse.ArgumentParser, preset: str = "vctk-multi",
                   decoder_kernel=None) -> None:
    """The model flags the JAX training scripts share (None keeps the
    preset's value), with ``--preset`` and ``--device``."""
    p.add_argument("--preset", default=preset,
                   help=f"config preset (default {preset})")
    p.add_argument("--decoder-kernel", default=decoder_kernel,
                   choices=["xla", "pallas", "pallas_sg"])
    p.add_argument("--head-kernel", default=None, choices=["xla", "pallas"])
    p.add_argument("--embed-in-kernel", action="store_true")
    from vqvae_tpu_torch.cli.common import add_device_arg
    add_device_arg(p)


def train_config(args, **model):
    """The preset with the flags of ``add_train_args`` and the model
    fields ``model`` applied."""
    from vqvae_tpu_torch.configs import get_config
    return with_model(get_config(args.preset),
                      decoder_kernel=args.decoder_kernel,
                      head_kernel=args.head_kernel,
                      embed_in_kernel=args.embed_in_kernel or None, **model)


def emit(record: dict, dev) -> dict:
    """Print ``record`` as one JSON line with the card's name and power
    limit; returns the line's object."""
    line = {**record, **card(dev)}
    print(json.dumps(line), flush=True)
    return line

"""Shared CLI plumbing: config resolution and weight loading (port of
``vqvae_tpu/cli/common.py``)."""

from __future__ import annotations

import argparse
import dataclasses
import json
import os

from vqvae_tpu_torch.configs import Config, get_config, load_config
from vqvae_tpu_torch.models import init_model
from vqvae_tpu_torch.train.checkpoint import (
    latest_step,
    load_checkpoint_params,
    load_weights_npz,
)
from vqvae_tpu_torch.utils import profiling


def add_config_args(p: argparse.ArgumentParser) -> None:
    p.add_argument("--preset", default=None,
                   help="config preset (tiny/vctk-single/vctk-multi/"
                        "fastgen/stretch); when omitted, the config "
                        "recorded by a training run (-m dir/config.json), "
                        "else vctk-multi")
    p.add_argument("--mulaw-mode", default=None,
                   choices=["round", "chainer"],
                   help="mu-law binning: 'round' (default) or 'chainer' "
                        "(the reference's digitize-style bins)")
    p.add_argument("--set", action="append", default=[],
                   metavar="SECTION.FIELD=VALUE", dest="set_overrides",
                   help="typed override of any config field, e.g. "
                        "--set model.compute_dtype=float32 (repeatable; "
                        "applied after --preset/config.json resolution)")


def _parse_override(cfg: Config, spec: str) -> Config:
    """Apply one ``section.field=value`` override, casting ``value``
    via the dataclass field's declared type."""
    try:
        key, raw = spec.split("=", 1)
        section, field = key.split(".", 1)
    except ValueError:
        raise SystemExit(f"--set expects SECTION.FIELD=VALUE, got {spec!r}")
    if section not in ("data", "model", "train"):
        raise SystemExit(
            f"--set: unknown section {section!r} (data/model/train)")
    sub = getattr(cfg, section)
    fields = {f.name for f in dataclasses.fields(sub)}
    if field not in fields:
        raise SystemExit(
            f"--set: no field {field!r} in {section} config "
            f"(have: {', '.join(sorted(fields))})")
    cur = getattr(sub, field)
    base = type(cur) if cur is not None else str
    if base is bool:
        if raw.lower() not in ("true", "false", "1", "0"):
            raise SystemExit(f"--set: {key} expects a bool, got {raw!r}")
        val = raw.lower() in ("true", "1")
    elif base in (int, float, str):
        try:
            val = base(raw)
        except ValueError:
            raise SystemExit(f"--set: {key} expects {base.__name__}, "
                             f"got {raw!r}")
    else:
        raise SystemExit(
            f"--set: field {key} has unsupported type {base.__name__}")
    return cfg.replace(**{section: dataclasses.replace(sub, **{field: val})})


def resolve_config(args) -> Config:
    """--preset if given; else a training run's recorded config.json
    (when -m is a run dir); else the flagship.  ``--mulaw-mode`` and
    ``--set`` apply on top."""
    cfg = None
    if args.preset is not None:
        cfg = get_config(args.preset)
    else:
        model = getattr(args, "model", None)
        if model and os.path.isdir(model):
            cfg = load_config(model)
            if cfg is not None:
                print(f"config: loaded {os.path.join(model, 'config.json')}"
                      f" (preset '{cfg.name}')")
    cfg = cfg or get_config("vctk-multi")
    if getattr(args, "mulaw_mode", None):
        cfg = cfg.replace(model=dataclasses.replace(
            cfg.model, mulaw_mode=args.mulaw_mode))
    for spec in getattr(args, "set_overrides", []) or []:
        cfg = _parse_override(cfg, spec)
    return cfg


def checkpoint_dir(model_path: str) -> str:
    """Accept either a run's out_dir or its checkpoints/ subdir."""
    sub = os.path.join(model_path, "checkpoints")
    return sub if os.path.isdir(sub) else model_path


def load_params(model_path: str, cfg: Config, device="cpu"):
    """Weights from a weights-only ``.npz`` (``export_weights`` of
    either package), or from a port training run directory (its newest
    ``checkpoints/step_N.pt``).  JAX run directories hold orbax
    checkpoints, which need JAX: convert them once with
    ``vqvae-export``."""
    template = init_model(cfg.model, device="meta")
    if model_path.endswith(".npz"):
        params = load_weights_npz(model_path, template, device)
        print(f"loaded weights-only snapshot {model_path}")
        return params
    ckpt = checkpoint_dir(model_path)
    if latest_step(ckpt) is None:
        raise SystemExit(
            f"{model_path}: the port loads weights-only .npz files; "
            "export with `vqvae-export` first")
    params, step = load_checkpoint_params(ckpt, template, device)
    print(f"restored step {step} from {ckpt}")
    return params


def make_dataset(cfg: Config, kind: str, root: str | None = None):
    """(train dataset, valid dataset or None): the synthetic ``sine``
    set, or the VCTK tree under ``root`` (default
    ``cfg.data.dataset_root``) split by ``cfg.data.valid_fraction``."""
    if kind == "sine":
        from vqvae_tpu_torch.audio.datasets import SineDataset
        return SineDataset(cfg.data), SineDataset(cfg.data, f0=137.0)
    if kind != "vctk":
        raise SystemExit(f"unknown --dataset {kind!r} (vctk or sine)")
    from vqvae_tpu_torch.audio.datasets import (
        WavDataset,
        scan_vctk,
        train_valid_split,
    )
    root = root or cfg.data.dataset_root
    if not os.path.isdir(root):
        raise SystemExit(f"--root {root}: no such directory (a VCTK-style "
                         "tree: <root>/wav48/<speaker>/<utt>.wav)")
    paths, ids, spk_dict = scan_vctk(root, cfg.data.speaker)
    if not paths:
        raise SystemExit(f"--root {root}: no .wav files found")
    (tp, ti), (vp, vi) = train_valid_split(
        paths, ids, cfg.data.valid_fraction, cfg.data.seed)
    if not tp:
        raise SystemExit(f"--root {root}: every file went to the "
                         "validation split")
    print(f"dataset: {len(paths)} files ({len(tp)} train / {len(vp)} "
          f"valid), {len(spk_dict)} speakers")
    valid = WavDataset(vp, vi, cfg.data) if vp else None
    return WavDataset(tp, ti, cfg.data), valid


def add_device_arg(p: argparse.ArgumentParser) -> None:
    p.add_argument("--device", default="cuda",
                   help="torch device (default cuda; fails without a GPU; "
                        "cpu runs the kernels' plain versions)")


def resolve_device(device: str):
    """The run's device; a CUDA device without a GPU is an error (the
    port never moves to the CPU by itself)."""
    import torch
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"--device {device}: no CUDA device is available "
                           "(use --device cpu to run on the CPU)")
    return dev


def output_names(paths, suffix: str) -> list[str]:
    """``<stem><suffix>`` per input path, de-duplicated across
    directories (a/x.wav and b/x.wav must not overwrite each other)."""
    names, seen = [], set()
    for i, path in enumerate(paths):
        stem = os.path.splitext(os.path.basename(path))[0]
        name = f"{stem}{suffix}"
        if name in seen:
            name = f"{stem}_{i}{suffix}"
        seen.add(name)
        names.append(name)
    return names


def speaker_ids(ids, B: int, cfg: Config, device):
    """``[B]`` speaker ids from ``-s``: one per row, or one broadcast to
    every row; checked against the speaker table on the host (an
    out-of-range gather on the card poisons the CUDA context)."""
    import torch
    ids = list(ids) if len(ids) > 1 else list(ids) * B
    if len(ids) != B:
        raise SystemExit(f"got {len(ids)} speaker ids for {B} rows")
    n = max(cfg.model.n_speakers, 1)
    if any(not 0 <= i < n for i in ids):
        raise SystemExit(f"speaker ids must be in [0, {n}), got {ids}")
    return torch.tensor(ids, dtype=torch.long, device=device)


def _kernel_launches() -> dict:
    from vqvae_tpu_torch.kernels import (
        decode_cuda,
        embed_cuda,
        encoder_cuda,
        head_ce_cuda,
        vq_cuda,
    )
    from vqvae_tpu_torch.kernels import wavenet_train_cuda as wt
    return {"decode": decode_cuda.launches,
            "encoder_fwd": encoder_cuda.launches_fwd,
            "encoder_bwd": encoder_cuda.launches_bwd,
            "chunk_fwd": wt.launches_fwd,
            "chunk_bwd": wt.launches_bwd,
            "chunk_bwd_rec": wt.launches_bwd_rec,
            "chunk_bwd_win": wt.launches_bwd_win,
            "head_ce_fwd": head_ce_cuda.launches_fwd,
            "head_ce_bwd": head_ce_cuda.launches_bwd,
            "vq_argmin": vq_cuda.launches,
            "take_rows_bwd": embed_cuda.launches["take_rows_bwd"]}


# the kernels' launch counts join the program's counters (``counters()``)
profiling.register_counters("launches", _kernel_launches)


def launch_counts() -> dict:
    """Kernel launches in this process, by kernel (the ``launches``
    group of ``utils/profiling.py``'s counters)."""
    return profiling.read_counters("launches")


def print_launch_counts() -> None:
    """The last line a CLI prints: its process's kernel launches."""
    print("kernel launches: " + json.dumps(launch_counts()), flush=True)

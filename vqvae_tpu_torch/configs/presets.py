"""Typed, frozen configuration: a jax-free mirror of
``vqvae_tpu/configs/presets.py``.

``vqvae_tpu.configs`` imports ``jax.numpy`` (and importing anything
under ``vqvae_tpu`` runs the package ``__init__``, which imports JAX),
so the port carries its own copy of the dataclasses and the preset
table.  Field names, defaults and presets are identical; only
``cdtype`` / ``pdtype`` return torch dtypes.  ``tests/test_torch_configs.py``
pins every field of every preset equal to the JAX table, so the two
cannot drift apart.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Tuple

import torch

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
           "float16": torch.float16}


@dataclasses.dataclass(frozen=True)
class DataConfig:
    """Audio front-end (reference: ``opt.py`` + ``utils.py::Preprocess``)."""

    sr: int = 16000
    mu: int = 256
    top_db: float = 20.0
    length: int = 7680
    dataset_root: str = "VCTK-Corpus"
    n_speakers: int = 109
    speaker: str | None = None
    valid_fraction: float = 0.01
    seed: int = 0


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """Model shape (reference: ``opt.py`` globals consumed by ``net.py``).
    Kernel switches: ``decoder_kernel`` ``xla`` (plain layer loop),
    ``pallas`` (the CUDA chunk kernels with the recompute backward,
    time-windowed with ``bwd_time_windows > 1``) or ``pallas_sg`` (the
    CUDA chunk kernels with saved gates); ``head_kernel`` ``xla`` or
    ``pallas`` (the CUDA head+CE kernels); ``embed_in_kernel``;
    ``remat``; ``encoder_kernel`` ``xla`` (plain layer loop) or
    ``pallas`` (the CUDA encoder kernels after the first layer)."""

    mu: int = 256
    mulaw_mode: str = "round"
    enc_channels: int = 128
    enc_layers: int = 6
    enc_kernel: int = 4
    enc_stride: int = 2
    K: int = 512
    d: int = 64
    beta: float = 0.25
    ema: bool = False
    ema_decay: float = 0.99
    ema_eps: float = 1e-5
    code_restart_threshold: float = 0.0
    n_loop: int = 3
    n_layer: int = 10
    residual_channels: int = 64
    skip_channels: int = 256
    filter_size: int = 2
    n_speakers: int = 109
    speaker_embed_dim: int = 64
    upsample_kernel_mult: int = 2
    compute_dtype: str = "bfloat16"
    param_dtype: str = "float32"
    decoder_kernel: str = "xla"
    encoder_kernel: str = "xla"
    head_kernel: str = "xla"
    embed_in_kernel: bool = False
    bwd_time_windows: int = 0
    remat: bool = False

    @property
    def dilations(self) -> Tuple[int, ...]:
        return tuple(2 ** i for i in range(self.n_layer)) * self.n_loop

    @property
    def n_layers_total(self) -> int:
        return self.n_loop * self.n_layer

    @property
    def receptive_field(self) -> int:
        return 2 + (self.filter_size - 1) * sum(self.dilations)

    @property
    def hop(self) -> int:
        """Total encoder downsampling factor (latent hop in samples)."""
        return self.enc_stride ** self.enc_layers

    @property
    def cdtype(self) -> torch.dtype:
        return _DTYPES[self.compute_dtype]

    @property
    def pdtype(self) -> torch.dtype:
        return _DTYPES[self.param_dtype]


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    """Training engine settings.  The port's one-device trainer reads
    the optimizer, batch, step, logging, eval, checkpoint, loader
    (``threads`` only) and seed fields; the mesh, TensorBoard and
    profiling fields are carried so a run's config.json loads whole."""

    batch_size: int = 16
    lr: float = 2e-4
    adam_b1: float = 0.9
    adam_b2: float = 0.999
    adam_eps: float = 1e-8
    codebook_lr_mult: float = 1.0
    num_steps: int = 200_000
    log_every: int = 100
    eval_every: int = 0
    eval_batches: int = 0
    checkpoint_every: int = 2000
    keep_checkpoints: int = 5
    tensorboard: bool = False
    loader: str = "threads"
    profile_steps: int = 0
    out_dir: str = "result"
    seed: int = 0
    mesh_data: int = -1
    mesh_model: int = 1
    mesh_slices: int = 1
    mesh_seq: int = 1


@dataclasses.dataclass(frozen=True)
class Config:
    data: DataConfig = dataclasses.field(default_factory=DataConfig)
    model: ModelConfig = dataclasses.field(default_factory=ModelConfig)
    train: TrainConfig = dataclasses.field(default_factory=TrainConfig)
    name: str = "default"

    def replace(self, **kw) -> "Config":
        return dataclasses.replace(self, **kw)


def _tiny() -> Config:
    model = ModelConfig(
        enc_channels=32, K=128, d=16,
        n_loop=1, n_layer=10,
        residual_channels=32, skip_channels=64,
        n_speakers=4, speaker_embed_dim=8,
        compute_dtype="float32",
    )
    data = DataConfig(length=1024, n_speakers=4)
    train = TrainConfig(batch_size=4, num_steps=100, log_every=10,
                        checkpoint_every=50)
    return Config(data=data, model=model, train=train, name="tiny")


def _vctk_single() -> Config:
    model = ModelConfig(n_speakers=1, speaker_embed_dim=16,
                        decoder_kernel="pallas")
    data = DataConfig(speaker="p225", n_speakers=1)
    return Config(data=data, model=model,
                  train=TrainConfig(eval_every=1000),
                  name="vctk-single")


def _vctk_multi() -> Config:
    return Config(model=ModelConfig(decoder_kernel="pallas"),
                  train=TrainConfig(eval_every=1000), name="vctk-multi")


def _fastgen() -> Config:
    return Config(name="fastgen")


def _stretch() -> Config:
    model = ModelConfig(ema=True, code_restart_threshold=1e-3,
                        decoder_kernel="pallas_sg",
                        head_kernel="pallas",
                        embed_in_kernel=True)
    train = TrainConfig(batch_size=64, eval_every=1000)
    return Config(model=model, train=train, name="stretch")


PRESETS = {
    "tiny": _tiny,
    "vctk-single": _vctk_single,
    "vctk-multi": _vctk_multi,
    "fastgen": _fastgen,
    "stretch": _stretch,
    "default": Config,
}


def get_config(name: str = "default", **overrides) -> Config:
    cfg = PRESETS[name]()
    if overrides:
        cfg = dataclasses.replace(cfg, **overrides)
    return cfg


def config_to_json(cfg: Config) -> str:
    return json.dumps(dataclasses.asdict(cfg), indent=2, sort_keys=True)


def _from_dict(cls, d: dict):
    fields = {f.name for f in dataclasses.fields(cls)}
    return cls(**{k: v for k, v in d.items() if k in fields})


def config_from_json(text: str) -> Config:
    d = json.loads(text)
    return Config(
        data=_from_dict(DataConfig, d.get("data", {})),
        model=_from_dict(ModelConfig, d.get("model", {})),
        train=_from_dict(TrainConfig, d.get("train", {})),
        name=d.get("name", "default"),
    )


def load_config(run_dir: str) -> Config | None:
    """The config recorded by a training run (``config.json``), or None."""
    path = os.path.join(run_dir, "config.json")
    if not os.path.isfile(path):
        return None
    with open(path) as f:
        return config_from_json(f.read())

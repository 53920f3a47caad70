"""The WaveNet autoencoder of NSynth (Engel et al. 2017,
arXiv:1704.01279), as magenta's ``nsynth/wavenet/h512_bo16.py``
configures it: a non-causal dilated residual encoder, a continuous
bottleneck pooled to one frame a ``ae_hop_length`` samples, and a
filter-3 WaveNet decoder conditioned on the frames
(``models/wavenet_ae.py``).

Its own frozen dataclass, with magenta's names: the VQ-VAE's
``ModelConfig`` mirrors the JAX package's field for field, and this
model has no VQ, no upsampler, no speaker and no kernel switch.  A
``Config`` whose ``model`` is a ``WaveNetAEConfig`` selects this model
in ``train/state.py::create_train_state`` and ``train/step.py::
train_step``; a saved config names it ``"arch": "wavenet_ae"``
(``presets.py::arch``).
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import torch

from vqvae_tpu_torch.configs.presets import (
    _DTYPES,
    Config,
    DataConfig,
    TrainConfig,
)


@dataclasses.dataclass(frozen=True)
class WaveNetAEConfig:
    """Model shape (magenta ``h512_bo16.py``): decoder ``num_layers``
    layers of ``width`` residual and ``skip_width`` skip channels, taps
    of ``filter_length``, dilations ``2^(i mod num_stages)``; encoder
    ``ae_num_layers`` layers of ``ae_width``, ``ae_filter_length`` taps,
    dilations ``2^(i mod ae_num_stages)``; bottleneck
    ``ae_bottleneck_width`` channels pooled over ``ae_hop_length``
    samples; ``mu`` mu-law classes."""

    mu: int = 256
    num_stages: int = 10
    num_layers: int = 30
    filter_length: int = 3
    width: int = 512
    skip_width: int = 256
    ae_num_stages: int = 10
    ae_num_layers: int = 30
    ae_filter_length: int = 3
    ae_width: int = 128
    ae_bottleneck_width: int = 16
    ae_hop_length: int = 512
    compute_dtype: str = "bfloat16"
    param_dtype: str = "float32"

    @property
    def dilations(self) -> Tuple[int, ...]:
        return tuple(2 ** (i % self.num_stages)
                     for i in range(self.num_layers))

    @property
    def ae_dilations(self) -> Tuple[int, ...]:
        return tuple(2 ** (i % self.ae_num_stages)
                     for i in range(self.ae_num_layers))

    @property
    def hop(self) -> int:
        """Samples a latent frame."""
        return self.ae_hop_length

    @property
    def cdtype(self) -> torch.dtype:
        return _DTYPES[self.compute_dtype]

    @property
    def pdtype(self) -> torch.dtype:
        return _DTYPES[self.param_dtype]


def _nsynth_h512() -> Config:
    # magenta trains on 6144-sample crops of 4 s, 16 kHz notes
    # (12 frames of 512); the batch of 48 is this port's choice
    data = DataConfig(length=6144, n_speakers=1)
    train = TrainConfig(batch_size=48, eval_every=0)
    return Config(data=data, model=WaveNetAEConfig(), train=train,
                  name="nsynth-h512")


AE_PRESETS = {"nsynth-h512": _nsynth_h512}

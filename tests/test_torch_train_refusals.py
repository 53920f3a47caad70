"""The port's trainer refuses the settings it cannot carry out.

``vqvae-torch-train`` trains on a mesh of ranks under ``torchrun``; in
one process there is one rank, so a mesh larger than that (any mesh
axis above 1) must stop before the run writes anything, naming the
setting and how to launch it, not train on without it.  (Meshes are
tested in tests/test_torch_parallel_*.py; TensorBoard and
``--loader grain`` in tests/test_torch_metrics.py,
tests/test_torch_grain_loader.py.)
"""

import dataclasses

import pytest
import torch

from vqvae_tpu_torch.audio.datasets import SineDataset
from vqvae_tpu_torch.configs import get_config
from vqvae_tpu_torch.train.loop import train

torch.set_num_threads(1)


@pytest.mark.parametrize("setting,value", [
    ("mesh_model", 2),
    ("mesh_seq", 2),
    ("mesh_slices", 2),
    ("mesh_data", 2),
])
def test_train_refuses_an_unported_setting(tmp_path, setting, value):
    cfg = get_config("tiny")
    cfg = cfg.replace(train=dataclasses.replace(cfg.train, **{setting: value}))
    out = tmp_path / "run"
    with pytest.raises(ValueError, match=f"train.{setting}={value} asks for "
                       "a mesh of 2 ranks, but the world has 1 process: .* "
                       "torchrun --nproc-per-node 2"):
        train(cfg, SineDataset(cfg.data), out_dir=str(out), num_steps=1,
              device="cpu", echo=False)
    assert not out.exists()


def test_train_takes_the_settings_it_runs(tmp_path):
    # the defaults (mesh_data=-1: every device, here one) and an explicit
    # one-device mesh still train
    cfg = get_config("tiny")
    cfg = cfg.replace(train=dataclasses.replace(
        cfg.train, batch_size=2, mesh_data=1, log_every=1))
    state = train(cfg, SineDataset(cfg.data), out_dir=str(tmp_path / "run"),
                  num_steps=1, device="cpu", echo=False)
    assert state.step == 1

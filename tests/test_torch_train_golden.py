"""The port's plain train step reproduces the JAX package's three
frozen 50-step training trajectories (``tests/fixtures/
golden_trajectory{,_chainer,_ema}.json``) from JAX-initialised
parameters on the same data stream, at the fixture's tolerance
(``test_golden_trajectory.py``).  The EMA run's dead-code restarts use
the JAX package's random rows, injected."""

import dataclasses
import json
import os

import jax
import numpy as np
import pytest
import torch

from vqvae_tpu.configs import get_config as jax_config
from vqvae_tpu.models import init_model as jax_init
from vqvae_tpu_torch.audio.datasets import SineDataset
from vqvae_tpu_torch.configs import get_config
from vqvae_tpu_torch.convert import flatten, from_numpy_tree
from vqvae_tpu_torch.train.state import create_train_state
from vqvae_tpu_torch.train.step import train_step

torch.set_num_threads(1)

FIXTURES = os.path.join(os.path.dirname(__file__), "fixtures")
NAMES = {"round": "golden_trajectory.json",
         "chainer": "golden_trajectory_chainer.json",
         "ema": "golden_trajectory_ema.json"}


def _jax_picks(seed):
    def picks(step, n_rows, K, device):
        key = jax.random.fold_in(jax.random.PRNGKey(seed + 101), step)
        return torch.from_numpy(np.array(
            jax.random.randint(key, (K,), 0, n_rows))).to(device)
    return picks


@pytest.mark.parametrize("mode", ["round", "chainer", "ema"])
def test_port_reproduces_golden_trajectory(mode):
    mkw = ({"ema": True, "code_restart_threshold": 1e-3} if mode == "ema"
           else {"mulaw_mode": mode})
    cfg = get_config("tiny")
    cfg = cfg.replace(train=dataclasses.replace(cfg.train, batch_size=8),
                      model=dataclasses.replace(cfg.model, **mkw))
    jparams = jax_init(jax.random.PRNGKey(0), jax_config("tiny").model)
    params = from_numpy_tree(flatten(jax.tree_util.tree_map(np.asarray,
                                                            jparams)),
                             trainable=True)
    state = create_train_state(cfg, params=params)
    with open(os.path.join(FIXTURES, NAMES[mode])) as f:
        golden = json.load(f)
    ds = SineDataset(cfg.data)
    rng = np.random.default_rng(0)
    picks = _jax_picks(cfg.train.seed)
    for step in range(1, max(map(int, golden)) + 1):
        wavs, spks = zip(*[ds.sample(rng) for _ in range(8)])
        metrics = train_step(state, torch.from_numpy(np.stack(wavs)),
                             torch.tensor(spks), cfg, picks)
        if str(step) not in golden:
            continue
        for k, v in golden[str(step)].items():
            tol = 1e-3 if step <= 10 else 5e-3
            np.testing.assert_allclose(
                float(metrics[k]), v, rtol=tol, atol=tol * abs(v) + 1e-5,
                err_msg=f"trajectory drifted at step {step} {k}")

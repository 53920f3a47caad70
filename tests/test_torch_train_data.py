"""The training slice's host side against the JAX package: framing,
the synthetic dataset and the batch stream are equal; and the
``vqvae-torch-train`` CLI runs on the CPU and refuses what it cannot
run (no GPU, no corpus)."""

import json
import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vqvae_tpu.audio.datasets import SineDataset as JaxSine
from vqvae_tpu.audio.framing import frame_batch as jax_frame_batch
from vqvae_tpu.audio.loader import BatchLoader as JaxLoader
from vqvae_tpu.configs import get_config as jax_config
from vqvae_tpu_torch.audio.datasets import SineDataset
from vqvae_tpu_torch.audio.framing import frame_batch
from vqvae_tpu_torch.audio.loader import BatchLoader
from vqvae_tpu_torch.configs import get_config

torch.set_num_threads(1)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.parametrize("mode", ["round", "chainer"])
def test_frame_batch_matches_jax(mode):
    rng = np.random.default_rng(0)
    wav = rng.uniform(-1.1, 1.1, (3, 257)).astype(np.float32)
    spk = np.array([0, 2, 1], np.int32)
    want = jax_frame_batch(jnp.asarray(wav), jnp.asarray(spk), 256, mode)
    got = frame_batch(torch.from_numpy(wav), torch.from_numpy(spk), 256,
                      mode)
    np.testing.assert_array_equal(got.ids_in.numpy(),
                                  np.asarray(want.ids_in))
    np.testing.assert_array_equal(got.targets.numpy(),
                                  np.asarray(want.targets))
    np.testing.assert_array_equal(got.speaker.numpy(),
                                  np.asarray(want.speaker))
    np.testing.assert_allclose(got.wav.numpy(), np.asarray(want.wav),
                               rtol=1e-6, atol=1e-7)
    assert got.targets.shape == got.ids_in.shape == (3, 256)


def test_sine_dataset_same_samples_as_jax():
    cfg, jcfg = get_config("tiny").data, jax_config("tiny").data
    ours, theirs = SineDataset(cfg), JaxSine(jcfg)
    r1, r2 = np.random.default_rng(5), np.random.default_rng(5)
    for _ in range(6):
        (w1, s1), (w2, s2) = ours.sample(r1), theirs.sample(r2)
        assert s1 == s2 and w1.dtype == w2.dtype == np.float32
        np.testing.assert_array_equal(w1, w2)
    np.testing.assert_array_equal(ours.full(3)[0], theirs.full(3)[0])


def test_batch_stream_same_as_jax_loader():
    cfg, jcfg = get_config("tiny").data, jax_config("tiny").data
    ours = BatchLoader(SineDataset(cfg), 4, seed=7, start_batch=2)
    theirs = JaxLoader(JaxSine(jcfg), 4, seed=7)
    try:
        for i in (2, 3, 4):
            wav, spk = next(ours)
            jw, js = theirs._make_batch(i)
            np.testing.assert_array_equal(wav, jw)
            np.testing.assert_array_equal(spk, js)
            assert spk.dtype == np.int32
    finally:
        ours.close()
        theirs.close()


def _cli(*args, timeout=300):
    return subprocess.run(
        [sys.executable, "-m", "vqvae_tpu_torch.cli.train", *args],
        cwd=ROOT, capture_output=True, text=True, timeout=timeout,
        env=dict(os.environ, CUDA_VISIBLE_DEVICES=""))


def test_train_cli_on_cpu_writes_log_config_and_weights(tmp_path):
    out = str(tmp_path / "run")
    r = _cli("--preset", "tiny", "--dataset", "sine", "--steps", "3",
             "--batch-size", "2", "--device", "cpu", "--out", out)
    assert r.returncode == 0, r.stdout + r.stderr
    recs = [json.loads(line) for line in open(os.path.join(out,
                                                           "log.jsonl"))]
    assert recs and all(np.isfinite(recs[0][k])
                        for k in ("loss", "loss1", "loss2", "loss3"))
    cfg = json.load(open(os.path.join(out, "config.json")))
    assert cfg["name"] == "tiny" and cfg["train"]["num_steps"] == 3
    from vqvae_tpu_torch.cli.common import load_params
    params = load_params(os.path.join(out, "weights.npz"), get_config("tiny"))
    assert params["vq"]["codebook"].shape == (128, 16)
    line = [ln for ln in r.stdout.splitlines()
            if ln.startswith("kernel launches: ")]
    assert json.loads(line[0].split(": ", 1)[1]) == {
        "decode": 0, "encoder_fwd": 0, "encoder_bwd": 0,
        "chunk_fwd": 0, "chunk_bwd": 0, "chunk_bwd_rec": 0,
        "chunk_bwd_win": 0, "head_ce_fwd": 0, "head_ce_bwd": 0,
        "vq_argmin": 0}


@pytest.mark.parametrize("args,needle", [
    (("--device", "cuda"), "CUDA"),
    (("--device", "cpu", "--dataset", "vctk", "--root", "no-such-corpus"),
     "no such directory"),
])
def test_train_cli_refuses_what_it_cannot_run(tmp_path, args, needle):
    base = ["--preset", "tiny", "--steps", "1", "--out", str(tmp_path)]
    if "--dataset" not in args:
        base += ["--dataset", "sine"]
    r = _cli(*base, *args)
    assert r.returncode != 0
    assert needle in r.stdout + r.stderr

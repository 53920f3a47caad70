"""The VCTK host side, the evaluator and resume against the JAX package:
file scanning and the split, WAV decode and trim, the dataset, the
threaded batch stream, the fixed eval set and ``val_*`` metrics, the
train-state checkpoint (resume equals a straight run; old checkpoints
are pruned) and ``vqvae-torch-train --dataset vctk`` on the CPU.

The VCTK-layout trees are synthetic: harmonic tones with silent
padding, written here at 48 kHz (so the loader resamples) and 16 kHz.
The JAX package may decode through its native library, which
``tests/test_native.py`` holds within 2e-4 of scipy's decode, so
decoded audio is compared at 2e-4 and everything computed from the same
arrays exactly."""

import dataclasses
import json
import os
import subprocess
import sys
import threading

import numpy as np
import pytest
import torch
from scipy.io import wavfile

from vqvae_tpu.audio import datasets as jds
from vqvae_tpu.audio import wav_io as jwav
from vqvae_tpu.audio.loader import BatchLoader as JaxLoader
from vqvae_tpu.configs import get_config as jax_config
from vqvae_tpu.train.evaluator import eval_windows as jax_eval_windows
from vqvae_tpu_torch.audio import datasets as tds
from vqvae_tpu_torch.audio import wav_io as twav
from vqvae_tpu_torch.audio.loader import BatchLoader
from vqvae_tpu_torch.configs import get_config
from vqvae_tpu_torch.train.evaluator import Evaluator, eval_windows

torch.set_num_threads(1)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DECODE_TOL = 2e-4


def write_tree(root, sr, speakers=3, utts=4):
    """``<root>/wav48/p<N>/p<N>_<k>.wav``: int16 tones of 0.3-0.6 s
    between 0.2 s of near-silence on each side."""
    rng = np.random.default_rng(sr)
    for s in range(speakers):
        spk = f"p{225 + s}"
        d = os.path.join(root, "wav48", spk)
        os.makedirs(d, exist_ok=True)
        for u in range(utts):
            n = int(sr * (0.3 + 0.1 * u))
            t = np.arange(n) / sr
            f = 110.0 * (s + 1) * (1 + 0.1 * u)
            tone = 0.5 * np.sin(2 * np.pi * f * t) + 0.2 * np.sin(
                4 * np.pi * f * t)
            pad = np.zeros(int(0.2 * sr))
            x = np.concatenate([pad, tone, pad])
            x += 1e-4 * rng.standard_normal(x.shape)
            wavfile.write(os.path.join(d, f"{spk}_{u:03d}.wav"), sr,
                          (x * 32767).astype(np.int16))
    return str(root)


@pytest.fixture(scope="module", params=[48000, 16000], ids=["48k", "16k"])
def tree(request, tmp_path_factory):
    return write_tree(tmp_path_factory.mktemp(f"vctk{request.param}"),
                      request.param)


@pytest.fixture(scope="module")
def tree48(tmp_path_factory):
    return write_tree(tmp_path_factory.mktemp("vctk48"), 48000)


def _datasets(root, cfg, jcfg):
    paths, ids, _ = tds.scan_vctk(root)
    return (tds.WavDataset(paths, ids, cfg.data),
            jds.WavDataset(paths, ids, jcfg.data))


def test_scan_and_split_match_jax(tree):
    for speaker in (None, "p226"):
        assert tds.scan_vctk(tree, speaker) == jds.scan_vctk(tree, speaker)
    paths, ids, spk = tds.scan_vctk(tree)
    assert len(paths) == 12 and spk == {"p225": 0, "p226": 1, "p227": 2}
    for frac, seed in ((0.01, 0), (0.25, 3), (0.0, 1)):
        assert tds.train_valid_split(paths, ids, frac, seed) == \
            jds.train_valid_split(paths, ids, frac, seed)


def test_load_wav_and_trim_match_jax(tree):
    paths, _, _ = tds.scan_vctk(tree)
    for p in paths[:4]:
        ours, theirs = twav.load_wav(p, 16000), jwav.load_wav(p, 16000)
        assert ours.dtype == np.float32 and ours.shape == theirs.shape
        np.testing.assert_allclose(ours, theirs, rtol=0, atol=DECODE_TOL)
        for top_db in (20.0, 40.0):
            np.testing.assert_array_equal(twav.trim_silence(ours, top_db),
                                          jwav.trim_silence(ours, top_db))
        trimmed = twav.trim_silence(ours, 20.0)
        assert 0.25 * 16000 < len(trimmed) < len(ours)     # pads trimmed


def test_save_wav_round_trip(tmp_path):
    x = (0.4 * np.sin(np.arange(800) / 7.0)).astype(np.float32)
    twav.save_wav(str(tmp_path / "a.wav"), x, 16000)
    jwav.save_wav(str(tmp_path / "b.wav"), x, 16000)
    a = wavfile.read(str(tmp_path / "a.wav"))[1]
    np.testing.assert_array_equal(a, wavfile.read(str(tmp_path / "b.wav"))[1])
    np.testing.assert_allclose(twav.load_wav(str(tmp_path / "a.wav")), x,
                               atol=1e-4)


def test_wav_dataset_matches_jax(tree):
    cfg, jcfg = get_config("tiny"), jax_config("tiny")
    ours, theirs = _datasets(tree, cfg, jcfg)
    assert len(ours) == len(theirs) == 12
    r1, r2 = np.random.default_rng(9), np.random.default_rng(9)
    for _ in range(6):
        (w1, s1), (w2, s2) = ours.sample(r1), theirs.sample(r2)
        assert s1 == s2 and w1.shape == w2.shape == (cfg.data.length + 1,)
        np.testing.assert_allclose(w1, w2, rtol=0, atol=DECODE_TOL)
    for i in (0, 5, 11):
        (w1, s1), (w2, s2) = ours.full(i), theirs.full(i)
        assert s1 == s2
        np.testing.assert_allclose(w1, w2, rtol=0, atol=DECODE_TOL)


def test_threaded_loader_matches_jax_stream(tree48):
    """The same batches as the JAX loader's for the same (seed, i),
    from ``start_batch`` on."""
    cfg, jcfg = get_config("tiny"), jax_config("tiny")
    ours, theirs = _datasets(tree48, cfg, jcfg)
    loader = BatchLoader(ours, 3, seed=5, start_batch=4)
    jloader = JaxLoader(theirs, 3, seed=5)
    try:
        for i in range(4, 8):
            wav, spk = next(loader)
            jw, js = jloader._make_batch(i)
            assert wav.dtype == np.float32 and spk.dtype == np.int32
            np.testing.assert_array_equal(spk, js)
            np.testing.assert_allclose(wav, jw, rtol=0, atol=DECODE_TOL)
    finally:
        loader.close()
        jloader.close()


def test_threaded_loader_order_under_thread_stress():
    """Many more workers than cores and a tiny switch interval: the
    stream still equals ``make_batch(i)`` in order, and close() stops
    every thread."""
    cfg = get_config("tiny").data
    ds = tds.SineDataset(cfg)
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    loader = BatchLoader(ds, 2, seed=3, start_batch=7, num_threads=16)
    try:
        got = [next(loader) for _ in range(24)]
    finally:
        sys.setswitchinterval(old)
        loader.close()
    for i, (wav, spk) in enumerate(got):
        w, s = loader.make_batch(7 + i)
        np.testing.assert_array_equal(wav, w)
        np.testing.assert_array_equal(spk, s)
    assert not any(t.is_alive() for t in loader._threads)
    assert threading.active_count() < 16


def test_loader_raises_a_failed_batch():
    class Broken:
        def sample(self, rng):
            raise OSError("unreadable file")
    loader = BatchLoader(Broken(), 2)
    try:
        with pytest.raises(OSError, match="unreadable"):
            next(loader)
    finally:
        loader.close()


# ---- the evaluator ---------------------------------------------------------


def test_eval_windows_match_jax(tree48):
    cfg = get_config("tiny")
    cfg = cfg.replace(train=dataclasses.replace(cfg.train, batch_size=4))
    jcfg = jax_config("tiny")
    jcfg = jcfg.replace(train=dataclasses.replace(jcfg.train, batch_size=4))
    sine, jsine = tds.SineDataset(cfg.data), jds.SineDataset(jcfg.data)
    for a, b in zip(eval_windows(sine, cfg), jax_eval_windows(jsine, jcfg)):
        np.testing.assert_array_equal(a, b)
    ours, theirs = _datasets(tree48, cfg, jcfg)
    # the same function of the same split: exact
    for a, b in zip(eval_windows(ours, cfg), jax_eval_windows(ours, jcfg)):
        np.testing.assert_array_equal(a, b)
    # and of the JAX package's decode of it: within the decode tolerance
    wavs, spks = eval_windows(ours, cfg)
    jw, js = jax_eval_windows(theirs, jcfg)
    assert wavs.shape == (12, cfg.data.length + 1)
    np.testing.assert_array_equal(spks, js)
    np.testing.assert_allclose(wavs, jw, rtol=0, atol=DECODE_TOL)


def test_evaluator_matches_jax_eval_step():
    """``val_*`` of the port's evaluator against the JAX package's on
    the same (converted) parameters: rtol 1e-5; two calls are equal."""
    import jax
    from vqvae_tpu.models import init_model as jax_init
    from vqvae_tpu.parallel.mesh import make_mesh
    from vqvae_tpu.train.evaluator import Evaluator as JaxEvaluator
    from vqvae_tpu_torch.convert import flatten, from_numpy_tree
    kw = dict(batch_size=8, eval_batches=2)
    cfg = get_config("tiny")
    cfg = cfg.replace(train=dataclasses.replace(cfg.train, **kw))
    jcfg = jax_config("tiny")
    jcfg = jcfg.replace(train=dataclasses.replace(jcfg.train, **kw))
    jparams = jax_init(jax.random.PRNGKey(1), jcfg.model)
    params = from_numpy_tree(flatten(jax.tree_util.tree_map(np.asarray,
                                                            jparams)))
    ds = tds.SineDataset(cfg.data, f0=137.0)
    ev = Evaluator(ds, cfg)
    got = ev(params)
    assert ev.n_windows == 16 and got == ev(params)
    want = JaxEvaluator(jds.SineDataset(jcfg.data, f0=137.0), jcfg,
                        make_mesh())(jparams)
    assert set(got) == set(want) and "val_loss1" in got
    for k, v in want.items():
        np.testing.assert_allclose(got[k], float(v), rtol=1e-5, err_msg=k)


def _tiny(**train):
    cfg = get_config("tiny")
    return cfg.replace(train=dataclasses.replace(
        cfg.train, **{"batch_size": 2, **train}),
        data=dataclasses.replace(cfg.data, length=256))


def test_eval_fires_on_its_own_schedule(tmp_path):
    """eval_every independent of log_every: validation rows at steps 3
    and 6 although no log step falls there."""
    from vqvae_tpu_torch.train.loop import train
    cfg = _tiny(num_steps=6, eval_every=3, eval_batches=1, log_every=100,
                checkpoint_every=100)
    train(cfg, tds.SineDataset(cfg.data), out_dir=str(tmp_path),
          device="cpu", echo=False,
          valid_dataset=tds.SineDataset(cfg.data, f0=137.0))
    rows = [json.loads(line) for line in open(tmp_path / "log.jsonl")]
    assert [r["iteration"] for r in rows if "val_loss1" in r] == [3, 6]
    assert [r["iteration"] for r in rows] == [1, 3, 6]


# ---- checkpoints and resume ------------------------------------------------


def test_resume_equals_a_straight_run(tmp_path):
    """4 straight steps against 2 steps, a checkpoint, and a resume to 4:
    parameters, Adam state and EMA state at rtol 1e-6, and the resumed
    steps see the straight run's batches (equal losses at steps 3, 4)."""
    from vqvae_tpu_torch.train.loop import train
    cfg = _tiny(num_steps=4, log_every=1, checkpoint_every=2)
    cfg = cfg.replace(model=dataclasses.replace(
        cfg.model, ema=True, code_restart_threshold=1e-3))
    ds = tds.SineDataset(cfg.data)
    a = train(cfg, ds, out_dir=str(tmp_path / "a"), device="cpu",
              echo=False)
    train(cfg, ds, out_dir=str(tmp_path / "b"), num_steps=2, device="cpu",
          echo=False)
    b = train(cfg, ds, out_dir=str(tmp_path / "b"), device="cpu",
              echo=False, resume=True)
    assert a.step == b.step == 4
    sa, sb = a.params.state_dict(), b.params.state_dict()
    for k in sa:
        np.testing.assert_allclose(sb[k].numpy(), sa[k].numpy(), rtol=1e-6,
                                   atol=1e-7, err_msg=k)
    for x, y in zip(a.vq_state, b.vq_state):
        np.testing.assert_allclose(y.numpy(), x.numpy(), rtol=1e-6)
    oa, ob = a.opt.state_dict()["state"], b.opt.state_dict()["state"]
    for i in oa:
        for k in ("exp_avg", "exp_avg_sq"):
            np.testing.assert_allclose(ob[i][k].numpy(), oa[i][k].numpy(),
                                       rtol=1e-6, atol=1e-12)
    rows = {}
    for run in ("a", "b"):
        for line in open(tmp_path / run / "log.jsonl"):
            r = json.loads(line)
            rows.setdefault(run, {})[r["iteration"]] = r["loss"]
    for step in (3, 4):
        np.testing.assert_allclose(rows["b"][step], rows["a"][step],
                                   rtol=1e-6)


def test_checkpoints_are_pruned_and_restore(tmp_path):
    from vqvae_tpu_torch.train.checkpoint import latest_step, \
        restore_checkpoint
    from vqvae_tpu_torch.train.loop import train
    from vqvae_tpu_torch.train.state import create_train_state
    cfg = _tiny(num_steps=5, log_every=100, checkpoint_every=2,
                keep_checkpoints=2)
    state = train(cfg, tds.SineDataset(cfg.data), out_dir=str(tmp_path),
                  device="cpu", echo=False)
    ckpt = tmp_path / "checkpoints"
    assert sorted(os.listdir(ckpt)) == ["step_4.pt", "step_5.pt"]
    assert latest_step(str(ckpt)) == 5
    fresh = restore_checkpoint(str(ckpt), create_train_state(cfg))
    assert fresh.step == 5
    for k, v in state.params.state_dict().items():
        assert torch.equal(fresh.params.state_dict()[k], v), k
    back4 = restore_checkpoint(str(ckpt), create_train_state(cfg), step=4)
    assert back4.step == 4
    with pytest.raises(FileNotFoundError):
        restore_checkpoint(str(tmp_path / "none"), create_train_state(cfg))


# ---- the CLI ---------------------------------------------------------------


def _cli(*args):
    return subprocess.run(
        [sys.executable, "-m", "vqvae_tpu_torch.cli.train", *args],
        cwd=ROOT, capture_output=True, text=True, timeout=300,
        env=dict(os.environ, CUDA_VISIBLE_DEVICES=""))


def test_train_cli_vctk_evaluates_and_resumes(tree48, tmp_path):
    out = str(tmp_path / "run")
    base = ["--preset", "tiny", "--dataset", "vctk", "--root", tree48,
            "--eval-every", "1", "--device", "cpu", "--out", out,
            "--batch-size", "2", "--set", "data.valid_fraction=0.2",
            "--set", "train.checkpoint_every=1"]
    r = _cli(*base, "--steps", "2")
    assert r.returncode == 0, r.stdout + r.stderr
    assert "dataset: 12 files (10 train / 2 valid), 3 speakers" in r.stdout
    rows = [json.loads(line) for line in open(os.path.join(out,
                                                           "log.jsonl"))]
    assert [row["iteration"] for row in rows] == [1, 2]
    assert all(np.isfinite(row["val_loss1"]) for row in rows)
    r = _cli(*base, "--steps", "3", "--resume")
    assert r.returncode == 0, r.stdout + r.stderr
    rows = [json.loads(line) for line in open(os.path.join(out,
                                                           "log.jsonl"))]
    assert [row["iteration"] for row in rows] == [1, 2, 3]
    assert "val_loss" in rows[-1]
    assert os.path.isfile(os.path.join(out, "checkpoints", "step_3.pt"))
    assert os.path.isfile(os.path.join(out, "weights.npz"))

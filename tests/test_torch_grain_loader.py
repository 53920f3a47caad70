"""The port's worker-process loader (vqvae_tpu_torch/audio/grain_loader.py,
``--loader grain``): its stream equals the port's threaded BatchLoader's
and the JAX package's BatchLoader's bit for bit, in the calling process
and from worker processes; ``start_batch`` resumes it and a run resumes
across loader kinds; ``close()`` reaps the workers; WavDataset crosses
into a worker by pickle."""

import dataclasses
import json
import multiprocessing
import os
import pickle

import numpy as np
import pytest
import torch
from scipy.io import wavfile

from vqvae_tpu.audio.datasets import SineDataset as JaxSine
from vqvae_tpu.audio.loader import BatchLoader as JaxBatchLoader
from vqvae_tpu.configs.presets import DataConfig as JaxDataConfig
from vqvae_tpu_torch.audio.datasets import SineDataset, WavDataset
from vqvae_tpu_torch.audio.grain_loader import GrainBatchLoader, make_loader
from vqvae_tpu_torch.audio.loader import BatchLoader
from vqvae_tpu_torch.configs import DataConfig, get_config
from vqvae_tpu_torch.train.loop import train

torch.set_num_threads(1)


def _take(loader, n):
    try:
        return [next(loader) for _ in range(n)]
    finally:
        loader.close()


def _same(a, b):
    assert len(a) == len(b)
    for (wa, sa), (wb, sb) in zip(a, b):
        assert wa.dtype == wb.dtype == np.float32
        assert sa.dtype == sb.dtype == np.int32
        np.testing.assert_array_equal(wa, wb)
        np.testing.assert_array_equal(sa, sb)


def _children():
    return {p.pid for p in multiprocessing.active_children()}


@pytest.mark.parametrize("num_workers", [0, 2])
def test_stream_matches_both_thread_loaders(num_workers):
    cfg = DataConfig(length=128, n_speakers=4)
    jcfg = JaxDataConfig(length=128, n_speakers=4)
    port = _take(BatchLoader(SineDataset(cfg), 4, seed=7), 6)
    jax = _take(JaxBatchLoader(JaxSine(jcfg), 4, seed=7), 6)
    before = _children()
    grain = _take(GrainBatchLoader(SineDataset(cfg), 4, seed=7,
                                   num_workers=num_workers), 6)
    assert _children() <= before
    wav, spk = grain[0]
    assert wav.shape == (4, 129) and spk.shape == (4,)
    _same(grain, port)
    _same(grain, jax)


def test_start_batch_resumes_the_stream():
    ds = SineDataset(DataConfig(length=256, n_speakers=4))
    straight = _take(GrainBatchLoader(ds, 4, seed=3), 6)
    _same(_take(GrainBatchLoader(ds, 4, seed=3, start_batch=2), 4),
          straight[2:])
    _same(_take(BatchLoader(ds, 4, seed=3, start_batch=2), 4), straight[2:])


def _wav_tree(root, n=6, sr=24000):
    rng = np.random.default_rng(0)
    paths = []
    for i in range(n):
        t = np.arange(int(sr * (0.3 + 0.05 * i))) / sr
        x = np.concatenate([np.zeros(2000), 0.5 * np.sin(
            2 * np.pi * 140 * (i + 1) * t), np.zeros(2000)])
        x += 1e-4 * rng.standard_normal(x.shape)
        p = os.path.join(root, f"u{i}.wav")
        wavfile.write(p, sr, (x * 32767).astype(np.int16))
        paths.append(p)
    return paths, [i % 3 for i in range(n)]


def test_wav_dataset_pickles_without_lock_or_cache(tmp_path):
    paths, spk = _wav_tree(str(tmp_path))
    cfg = DataConfig(length=512, n_speakers=3)
    ds = WavDataset(paths, spk, cfg, cache_size=8)
    want = ds.sample(np.random.default_rng(5))
    assert ds._cache                                 # something decoded
    ds2 = pickle.loads(pickle.dumps(ds))
    assert ds2._cache == {} and ds2._cache is not ds._cache
    assert ds2._cache_lock is not ds._cache_lock
    assert ds2.paths == ds.paths and ds2.speaker_ids == ds.speaker_ids
    got = ds2.sample(np.random.default_rng(5))
    np.testing.assert_array_equal(got[0], want[0])
    assert got[1] == want[1]
    with ds2._cache_lock:     # a working lock of its own
        pass


def test_wav_dataset_through_worker_processes(tmp_path):
    """Batches built from WAV files in two spawned workers, from batch 3,
    equal the threaded loader's straight stream."""
    paths, spk = _wav_tree(str(tmp_path))
    ds = WavDataset(paths, spk, DataConfig(length=512, n_speakers=3))
    straight = _take(BatchLoader(ds, 3, seed=11), 7)
    _same(_take(GrainBatchLoader(ds, 3, seed=11, num_workers=2,
                                 start_batch=3), 4), straight[3:])


def test_close_reaps_the_workers():
    before = _children()
    ld = GrainBatchLoader(SineDataset(DataConfig(length=64)), 2, seed=0,
                          num_workers=2, prefetch=2)
    next(ld)
    assert len(_children() - before) == 2
    ld.close()
    assert _children() <= before      # joined, none left behind
    with pytest.raises(StopIteration):
        next(ld)
    ld.close()                        # a second close is harmless


def test_make_loader_factory():
    ds = SineDataset(DataConfig(length=128, n_speakers=2))
    for kind, typ in (("threads", BatchLoader), ("grain", GrainBatchLoader)):
        ld = make_loader(kind, ds, 2, seed=1, start_batch=1)
        assert isinstance(ld, typ)
        wav, spk = next(ld)
        assert wav.shape == (2, 129) and spk.shape == (2,)
        ld.close()
    ld = make_loader("grain", ds, 2, num_threads=3)   # accepted, ignored
    ld.close()
    with pytest.raises(ValueError, match="loader kind"):
        make_loader("nope", ds, 2)


def _cfg(loader):
    cfg = get_config("tiny")
    return cfg.replace(train=dataclasses.replace(
        cfg.train, batch_size=4, log_every=1, checkpoint_every=2,
        loader=loader))


def _losses(out):
    with open(os.path.join(out, "log.jsonl")) as f:
        return [json.loads(ln)["loss"] for ln in f]


def test_train_grain_equals_threads(tmp_path):
    runs = {}
    for kind in ("threads", "grain"):
        cfg = _cfg(kind)
        out = str(tmp_path / kind)
        train(cfg, SineDataset(cfg.data), out_dir=out, num_steps=2,
              device="cpu", echo=False)
        runs[kind] = _losses(out)
    assert len(runs["grain"]) == 2
    assert runs["grain"] == runs["threads"]


def test_resume_across_loader_kinds(tmp_path):
    """A run checkpointed under the thread loader and resumed under grain
    equals the straight thread-loader run (tests/test_grain_loader.py's
    contract, through the port's trainer)."""
    ds = SineDataset(_cfg("threads").data)
    straight = train(_cfg("threads"), ds, out_dir=str(tmp_path / "a"),
                     num_steps=4, device="cpu", echo=False)
    train(_cfg("threads"), ds, out_dir=str(tmp_path / "b"), num_steps=2,
          device="cpu", echo=False)
    resumed = train(_cfg("grain"), ds, out_dir=str(tmp_path / "b"),
                    num_steps=4, device="cpu", echo=False, resume=True)
    assert resumed.step == 4
    a, b = straight.params.state_dict(), resumed.params.state_dict()
    assert a.keys() == b.keys()
    for k in a:
        torch.testing.assert_close(b[k], a[k], rtol=1e-6, atol=1e-7)
    assert _losses(str(tmp_path / "b"))[2:] == \
        _losses(str(tmp_path / "a"))[2:]


def test_train_refuses_an_unknown_loader_before_writing(tmp_path):
    cfg = _cfg("nope")
    out = tmp_path / "run"
    with pytest.raises(ValueError, match="loader kind"):
        train(cfg, SineDataset(cfg.data), out_dir=str(out), num_steps=1,
              device="cpu", echo=False)
    assert not out.exists()


class _Recording(SineDataset):
    """SineDataset that notes the thread each sample was built on, and
    fails from the sample number ``fail_at`` on."""

    def __init__(self, cfg, fail_at=None):
        super().__init__(cfg)
        self.threads, self.fail_at = [], fail_at

    def sample(self, rng):
        import threading
        if self.fail_at is not None and len(self.threads) >= self.fail_at:
            raise RuntimeError("reader failed")
        self.threads.append(threading.current_thread().name)
        return super().sample(rng)


def test_in_process_loader_reads_ahead_on_a_thread():
    """num_workers=0 builds batches ahead of the consumer on one
    background thread (the JAX package's ReadOptions(num_threads=1,
    prefetch_buffer_size=prefetch)), keeps BatchLoader's stream, and
    close() joins the thread."""
    import threading
    import time
    cfg = DataConfig(length=128, n_speakers=4)
    ds = _Recording(cfg)
    loader = GrainBatchLoader(ds, 2, seed=5, prefetch=3)
    first = next(loader)
    deadline = time.monotonic() + 10
    while len(ds.threads) < 2 * 3 and time.monotonic() < deadline:
        time.sleep(0.01)
    assert len(ds.threads) > 2            # more than one batch built
    assert "MainThread" not in ds.threads
    assert set(ds.threads) == {"grain-read-ahead"}
    rest = [next(loader) for _ in range(4)]
    loader.close()
    assert not any(t.name == "grain-read-ahead" and t.is_alive()
                   for t in threading.enumerate())
    _same([first] + rest, _take(BatchLoader(SineDataset(cfg), 2, seed=5), 5))


def test_in_process_loader_raises_the_readers_error():
    cfg = DataConfig(length=128, n_speakers=4)
    loader = GrainBatchLoader(_Recording(cfg, fail_at=4), 2, seed=0,
                              prefetch=2)
    next(loader), next(loader)
    for _ in range(2):   # at the next next(), and at every one after it
        with pytest.raises(RuntimeError, match="reader failed"):
            next(loader)
    loader.close()

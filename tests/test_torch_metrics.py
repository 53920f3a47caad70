"""The port's training log (vqvae_tpu_torch/train/metrics.py) against the
JAX package's MetricsLogger: the same log.jsonl records (``elapsed``,
the ``steps_per_sec`` fallback) and console table on the same clock, the
same TensorBoard scalars (tags, steps, float32 values; the JAX side
written through tf.summary), the event file's framing and CRC32C, the
loss plot, and ``vqvae-torch-train --tensorboard``."""

import dataclasses
import glob
import json
import os
import struct
import subprocess
import sys

import numpy as np
import pytest
import torch

import vqvae_tpu.train.metrics as jax_metrics
import vqvae_tpu_torch.train.metrics as metrics
from vqvae_tpu_torch.audio.datasets import SineDataset
from vqvae_tpu_torch.configs import get_config
from vqvae_tpu_torch.train.loop import train

torch.set_num_threads(1)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# (clock at the log call, step, metrics): a first row, a row without a
# timer (steps_per_sec from the interval), an eval row with val_* keys
# and a timer's rate, a row at the same clock (no fallback rate)
RECORDS = [
    (1000.25, 1, {"loss": 6.1, "loss1": 5.5, "loss2": 0.25, "loss3": 0.1}),
    (1002.75, 5, {"loss": 4.0, "loss1": 3.5, "loss2": 0.125,
                  "loss3": 0.0625, "codebook_usage": 0.75}),
    (1003.5, 10, {"loss": 3.0, "loss1": 2.5, "loss2": 0.5, "loss3": 0.25,
                  "steps_per_sec": 6.5, "val_loss1": 2.75,
                  "val_loss": 3.25}),
    (1003.5, 11, {"loss": 1e-3, "loss1": 1e-3, "loss2": 0.0, "loss3": 0.0}),
]


class Clock:
    now = 1000.0

    def time(self):
        return self.now


def _run_logger(module, out, monkeypatch, tensorboard=False):
    clock = Clock()
    monkeypatch.setattr(module, "time", clock)
    log = module.MetricsLogger(str(out), tensorboard=tensorboard)
    for t, step, rec in RECORDS:
        clock.now = t
        log.log(step, rec)
    log.close()
    with open(os.path.join(str(out), "log.jsonl")) as f:
        return [json.loads(ln) for ln in f]


def test_crc32c_known_answer():
    assert metrics.crc32c(b"123456789") == 0xE3069283    # RFC 3720
    assert metrics.crc32c(b"") == 0
    assert metrics.crc32c(bytes(32)) == 0x8A9136AA       # RFC 3720 B.4


def test_framing_reads_back_and_checks_its_crcs(tmp_path):
    events = [metrics.encode_event(12.5, file_version="brain.Event:2"),
              metrics.encode_event(13.0, 7, scalars={"loss": 1.5,
                                                     "big": 1e40}),
              metrics.encode_event(14.0, 2 ** 40, scalars={"a/b": -0.1})]
    p = tmp_path / "events"
    p.write_bytes(b"".join(metrics.frame_record(e) for e in events))
    got = metrics.read_events(str(p))
    assert [e["file_version"] for e in got] == ["brain.Event:2", None, None]
    assert [e["step"] for e in got] == [0, 7, 2 ** 40]
    assert [e["wall_time"] for e in got] == [12.5, 13.0, 14.0]
    assert got[1]["scalars"] == [("loss", 1.5), ("big", float("inf"))]
    assert got[2]["scalars"] == [("a/b", float(np.float32(-0.1)))]
    # the frame: length, its masked CRC, the data, the data's masked CRC
    raw = p.read_bytes()
    (n,) = struct.unpack("<Q", raw[:8])
    assert n == len(events[0])
    assert struct.unpack("<I", raw[8:12])[0] == metrics.masked_crc(raw[:8])
    bad = bytearray(raw)
    bad[20] ^= 1
    p.write_bytes(bytes(bad))
    with pytest.raises(ValueError, match="CRC"):
        metrics.read_events(str(p))
    p.write_bytes(raw[:-3])
    with pytest.raises(ValueError, match="truncated"):
        metrics.read_events(str(p))


def test_log_records_and_table_match_jax(tmp_path, monkeypatch, capsys):
    want = _run_logger(jax_metrics, tmp_path / "jax", monkeypatch)
    jax_out = capsys.readouterr().out
    got = _run_logger(metrics, tmp_path / "port", monkeypatch)
    assert got == want
    assert capsys.readouterr().out == jax_out
    assert [r["elapsed"] for r in got] == [0.25, 2.5, 0.75, 0.0]
    assert got[1]["steps_per_sec"] == 4 / 2.5
    assert got[2]["steps_per_sec"] == 6.5 and "steps_per_sec" not in got[3]
    # the header again when the columns change (val_loss1 joins, leaves)
    assert jax_out.count("iteration") == 4


def _triples_of_port(path):
    return [(ev["step"], tag, value) for ev in metrics.read_events(path)
            for tag, value in ev["scalars"]]


def test_tensorboard_scalars_match_jax(tmp_path, monkeypatch):
    tf = pytest.importorskip("tensorflow")
    _run_logger(jax_metrics, tmp_path / "jax", monkeypatch, tensorboard=True)
    recs = _run_logger(metrics, tmp_path / "port", monkeypatch,
                       tensorboard=True)
    [jax_file] = glob.glob(str(tmp_path / "jax" / "tb" / "*tfevents*"))
    [port_file] = glob.glob(str(tmp_path / "port" / "tb" / "*tfevents*"))
    want, got, port_first = [], [], []
    for e in tf.compat.v1.train.summary_iterator(jax_file):
        for v in e.summary.value:
            want.append((e.step, v.tag, float(tf.make_ndarray(v.tensor))))
    for e in tf.compat.v1.train.summary_iterator(port_file):
        port_first.append(e.file_version)
        for v in e.summary.value:
            got.append((e.step, v.tag, v.simple_value))
    assert port_first[0] == "brain.Event:2"
    assert sorted(got) == sorted(want)
    assert _triples_of_port(port_file) == got
    # and the same triples as log.jsonl's, in float32
    assert got == [(r["iteration"], k, float(np.float32(v)))
                   for r in recs for k, v in r.items() if k != "iteration"]


def test_tensorboard_that_cannot_open_raises(tmp_path):
    out = tmp_path / "run"
    out.mkdir()
    (out / "tb").write_text("a file where the directory should be")
    with pytest.raises(OSError):
        metrics.MetricsLogger(str(out), tensorboard=True)


def test_plot_returns_quietly_without_matplotlib(tmp_path, monkeypatch):
    log = metrics.MetricsLogger(str(tmp_path))
    log.log(1, {"loss1": 1.0}, echo=False)
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    log.plot()
    log.close()
    assert not (tmp_path / "loss.png").exists()


def test_two_step_run_plots_the_losses(tmp_path):
    pytest.importorskip("matplotlib")
    cfg = get_config("tiny")
    cfg = cfg.replace(train=dataclasses.replace(cfg.train, batch_size=2,
                                                log_every=1))
    out = tmp_path / "run"
    train(cfg, SineDataset(cfg.data), out_dir=str(out), num_steps=2,
          device="cpu", echo=False)
    png = (out / "loss.png").read_bytes()
    assert png[:8] == b"\x89PNG\r\n\x1a\n"
    assert not (out / "tb").exists()      # tensorboard is off by default


def test_train_cli_tensorboard_writes_tb(tmp_path):
    out = tmp_path / "run"
    r = subprocess.run(
        [sys.executable, "-m", "vqvae_tpu_torch.cli.train", "--preset",
         "tiny", "--dataset", "sine", "--steps", "2", "--batch-size", "2",
         "--device", "cpu", "--out", str(out), "--tensorboard", "--loader",
         "grain", "--set", "train.log_every=1"],
        capture_output=True, text=True, cwd=ROOT, timeout=300,
        env=dict(os.environ, OMP_NUM_THREADS="1"))
    assert r.returncode == 0, r.stdout[-2000:] + r.stderr[-2000:]
    cfg = json.loads((out / "config.json").read_text())
    assert cfg["train"]["tensorboard"] is True
    assert cfg["train"]["loader"] == "grain"
    [events] = glob.glob(str(out / "tb" / "events.out.tfevents.*"))
    with open(out / "log.jsonl") as f:
        recs = [json.loads(ln) for ln in f]
    assert [r["iteration"] for r in recs] == [1, 2]
    assert _triples_of_port(events) == [
        (r["iteration"], k, float(np.float32(v)))
        for r in recs for k, v in r.items() if k != "iteration"]

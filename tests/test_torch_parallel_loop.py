"""``vqvae-torch-train`` and ``vqvae-torch-score`` as worlds of CPU
processes (gloo), launched by torchrun: two processes over a
shared run directory train as one process does, rank 0 alone writes the
run's files, a resumed mesh run keeps the data stream, a run on a
'model' mesh trains on past a checkpoint and resumes on one device and
on a 'model' mesh, and a 'seq' mesh scores as one process does (tests/test_distributed.py's two-process check, for the
port)."""

import dataclasses
import json
import os
import shutil

import numpy as np
import pytest
import torch

from _torch_world import run_world
from vqvae_tpu_torch.audio.datasets import SineDataset
from vqvae_tpu_torch.cli import score
from vqvae_tpu_torch.cli import train as train_cli
from vqvae_tpu_torch.configs import get_config
from vqvae_tpu_torch.train.loop import train

torch.set_num_threads(1)
ARGS = ["--preset", "tiny", "--dataset", "sine", "--device", "cpu",
        "--batch-size", "8", "--set", "train.log_every=1",
        "--set", "train.checkpoint_every=2"]


def _cli(n, tmp_path, out, *extra):
    return run_world(n, ["-m", "vqvae_tpu_torch.cli.train",
                         *ARGS, "--out", str(out), *extra], tmp_path)


def _log(out):
    with open(os.path.join(out, "log.jsonl")) as f:
        return [json.loads(line) for line in f]


def _weights(out):
    with np.load(os.path.join(out, "weights.npz")) as z:
        return {k: z[k] for k in z.files}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("loop")
    cfg = get_config("tiny")
    cfg = cfg.replace(train=dataclasses.replace(
        cfg.train, batch_size=8, log_every=1, checkpoint_every=2))
    train(cfg, SineDataset(cfg.data), out_dir=str(tmp / "one"),
          num_steps=4, device="cpu", echo=False)
    outs = {"dp": _cli(2, tmp, tmp / "dp", "--steps", "4")}
    _cli(2, tmp, tmp / "dp_resumed", "--steps", "2")
    outs["dp_resumed"] = _cli(2, tmp, tmp / "dp_resumed", "--steps", "4",
                              "--resume")
    _cli(2, tmp, tmp / "tp", "--steps", "2", "--mesh-model", "2")
    shutil.copytree(tmp / "tp", tmp / "tp_resumed")
    _cli(2, tmp, tmp / "tp_resumed", "--steps", "4", "--mesh-model", "2",
         "--resume")
    # checkpoints at steps 2 and 4: the run goes on after the first
    _cli(2, tmp, tmp / "tp4", "--steps", "4", "--mesh-model", "2")
    train_cli.main(ARGS + ["--out", str(tmp / "tp"), "--steps", "4",
                           "--resume"])
    return tmp, outs


def test_two_processes_train_as_one(runs):
    tmp, outs = runs
    one, dp = _log(tmp / "one"), _log(tmp / "dp")
    assert [r["iteration"] for r in dp] == [1, 2, 3, 4]   # one writer
    for a, b in zip(one, dp):
        for k in ("loss", "loss1", "loss2", "loss3"):
            np.testing.assert_allclose(b[k], a[k], rtol=1e-5, err_msg=k)
    w1, wd = _weights(tmp / "one"), _weights(tmp / "dp")
    np.testing.assert_allclose(wd["vq/codebook"], w1["vq/codebook"],
                               rtol=2e-5, atol=2e-6)
    np.testing.assert_allclose(wd["vq/codebook"].sum(),
                               w1["vq/codebook"].sum(), rtol=1e-5)


def test_rank_zero_alone_writes_the_run(runs):
    tmp, outs = runs
    for name in ("config.json", "log.jsonl", "weights.npz", "checkpoints"):
        assert os.path.exists(tmp / "dp" / name), name
    rank0, rank1 = outs["dp"]
    assert "iteration" in rank0 and "iteration" not in rank1
    # both ranks ran the kernels' plain versions on the CPU
    for out in (rank0, rank1):
        assert out.strip().splitlines()[-1].startswith("kernel launches")


def test_a_resumed_mesh_run_keeps_the_stream(runs):
    tmp, _ = runs
    straight, resumed = _log(tmp / "dp"), _log(tmp / "dp_resumed")
    assert [r["iteration"] for r in resumed] == [1, 2, 3, 4]
    for a, b in zip(straight, resumed):
        for k in ("loss", "loss1"):
            assert a[k] == b[k], (a["iteration"], k)
    w, wr = _weights(tmp / "dp"), _weights(tmp / "dp_resumed")
    for k in w:
        np.testing.assert_array_equal(wr[k], w[k], err_msg=k)


def test_a_model_mesh_run_resumes_on_one_device(runs):
    """Checkpoints hold the one-device layout: Adam's moments and the
    EMA state sharded over 'model' were gathered, and one process takes
    them up."""
    tmp, _ = runs
    one, tp = _log(tmp / "one"), _log(tmp / "tp")
    assert [r["iteration"] for r in tp] == [1, 2, 3, 4]
    for a, b in zip(one, tp):
        np.testing.assert_allclose(b["loss"], a["loss"], rtol=1e-5)
    w1, wt = _weights(tmp / "one"), _weights(tmp / "tp")
    for k in w1:
        np.testing.assert_allclose(wt[k], w1[k], rtol=2e-5, atol=2e-6,
                                   err_msg=k)


def test_a_model_mesh_run_trains_past_a_checkpoint(runs):
    """Writing a checkpoint gathers Adam's sharded moments without
    touching the optimizer's own: the steps after it go on as one
    device's."""
    tmp, _ = runs
    one, tp = _log(tmp / "one"), _log(tmp / "tp4")
    assert [r["iteration"] for r in tp] == [1, 2, 3, 4]
    for a, b in zip(one, tp):
        np.testing.assert_allclose(b["loss"], a["loss"], rtol=1e-5)
    w1, wt = _weights(tmp / "one"), _weights(tmp / "tp4")
    for k in w1:
        np.testing.assert_allclose(wt[k], w1[k], rtol=2e-5, atol=2e-6,
                                   err_msg=k)


def test_a_model_mesh_run_resumes_on_a_model_mesh(runs):
    """A 'model' mesh takes up its own checkpoint (the one-device
    layout cut into shards again) and goes on as the straight run."""
    tmp, _ = runs
    straight, resumed = _log(tmp / "tp4"), _log(tmp / "tp_resumed")
    assert [r["iteration"] for r in resumed] == [1, 2, 3, 4]
    for a, b in zip(straight, resumed):
        for k in ("loss", "loss1"):
            assert a[k] == b[k], (a["iteration"], k)
    w, wr = _weights(tmp / "tp4"), _weights(tmp / "tp_resumed")
    for k in w:
        np.testing.assert_array_equal(wr[k], w[k], err_msg=k)


def test_score_on_a_seq_mesh_equals_one_process(runs, capsys):
    tmp, _ = runs
    args = ["--preset", "tiny", "--dataset", "sine", "--device", "cpu",
            "-m", str(tmp / "one" / "weights.npz"), "--batch-size", "4",
            "--eval-batches", "2", "--json"]
    score.main(args)
    one = json.loads([ln for ln in capsys.readouterr().out.splitlines()
                      if ln.startswith("{")][0])
    outs = run_world(2, ["-m", "vqvae_tpu_torch.cli.score",
                         *args, "--mesh-seq", "2"], tmp)
    lines = [[ln for ln in o.splitlines() if ln.startswith("{")]
             for o in outs]
    assert len(lines[0]) == 1 and lines[1] == []       # rank 0 reports
    sp = json.loads(lines[0][0])
    assert sp["windows"] == one["windows"]
    for k in ("val_loss", "val_loss1", "val_loss2", "val_loss3"):
        assert abs(sp[k] - one[k]) < 1e-4, k

"""``measure/serve_bench.py`` against the JAX ``scripts/serve_bench.py``
(whose client is numpy-only), both against one port daemon on the CPU
at ``tiny``: the same record, plus the engine and the card line."""

import json
import os
import subprocess
import sys
import time

import pytest

from vqvae_tpu_torch.client import CodecClient
from vqvae_tpu_torch.configs import get_config
from vqvae_tpu_torch.measure import serve_bench
from vqvae_tpu_torch.models import init_model
from vqvae_tpu_torch.train.checkpoint import export_weights

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARGS = ["--seconds", "0.05", "--requests", "2", "--greedy"]


@pytest.fixture(scope="module")
def daemon(tmp_path_factory):
    import torch
    root = tmp_path_factory.mktemp("measure_serve")
    npz = str(root / "tiny.npz")
    export_weights(npz, init_model(get_config("tiny").model,
                                   torch.Generator().manual_seed(0)))
    sock = str(root / "codec.sock")
    log_path = str(root / "server.log")
    env = dict(os.environ, OMP_NUM_THREADS="1")
    with open(log_path, "w") as log:
        proc = subprocess.Popen(
            [sys.executable, "-m", "vqvae_tpu_torch.cli.serve", "--preset",
             "tiny", "-m", npz, "--socket", sock, "--device", "cpu",
             "--chunk", "4"], stdout=log, stderr=subprocess.STDOUT,
            env=env, cwd=ROOT)
    deadline = time.time() + 300
    while not os.path.exists(sock):
        assert proc.poll() is None, open(log_path).read()[-3000:]
        assert time.time() < deadline, "daemon did not come up"
        time.sleep(0.2)
    yield sock
    try:
        with CodecClient(socket_path=sock) as c:
            c.shutdown()
        proc.wait(timeout=60)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()


def _last_json(stdout):
    return json.loads([ln for ln in stdout.splitlines()
                       if ln.startswith("{")][-1])


def test_port_bench_matches_the_jax_script(daemon, capsys):
    env = dict(os.environ, PYTHONPATH=ROOT, JAX_PLATFORMS="cpu")
    r = subprocess.run([sys.executable, "scripts/serve_bench.py",
                        "--socket", daemon, *ARGS], cwd=ROOT, env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-3000:]
    want = _last_json(r.stdout)
    got = serve_bench.main(["--socket", daemon, *ARGS])
    assert _last_json(capsys.readouterr().out) == got
    assert set(got) - set(want) == {"engine", "device", "power_limit_w"}
    assert set(want) <= set(got)
    for key in ("op", "n", "audio_s", "preset", "chunk", "greedy",
                "daemon_errors"):
        assert got[key] == want[key], key
    assert (got["engine"], got["device"], got["power_limit_w"]) == \
        ("kernel", "cpu", None)
    assert got["n"] == 2 and got["preset"] == "tiny" and got["chunk"] == 4
    assert got["realtime_x"] > 0 and got["p95_ms"] >= got["p50_ms"] > 0
    assert set(got["daemon_ms"]) == {"p50", "p90", "p99", "max"}


def test_port_bench_encode_op(daemon):
    got = serve_bench.main(["--socket", daemon, "--op", "encode",
                            "--seconds", "0.05", "--requests", "2"])
    assert got["op"] == "encode" and got["daemon_errors"] == 0


def test_exactly_one_address():
    with pytest.raises(SystemExit):
        serve_bench.main(["--requests", "1"])


def test_serve_bench_starts_without_torch():
    """A client like the JAX script's: no torch import (nor JAX)."""
    code = ("import sys, vqvae_tpu_torch.measure.serve_bench\n"
            "bad = [m for m in ('torch', 'jax', 'vqvae_tpu') if m in "
            "sys.modules]\n"
            "assert not bad, bad\n")
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr[-2000:]

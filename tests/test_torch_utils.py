"""The port's measurement tools (``vqvae_tpu_torch/utils``) against the
JAX package's: the analytic FLOP count, the step timer, and the
trainer's ``--profile`` trace."""

import json
import os

import pytest

from vqvae_tpu import configs as jcfg
from vqvae_tpu.utils.flops import train_step_flops as jax_flops
from vqvae_tpu.utils.profiling import StepTimer as JaxStepTimer
from vqvae_tpu_torch import configs as tcfg
from vqvae_tpu_torch.utils import profiling
from vqvae_tpu_torch.utils.flops import train_step_flops

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.parametrize("name", sorted(tcfg.PRESETS))
def test_train_step_flops_equal_jax(name):
    cfg = tcfg.get_config(name)
    for batch in (1, cfg.train.batch_size):
        assert train_step_flops(cfg, batch) == jax_flops(
            jcfg.get_config(name), batch)


def test_step_timer_matches_jax(monkeypatch):
    """The same ticks on the same clock give the JAX timer's rates: the
    first two intervals discarded, then an EMA; reset restarts the
    interval without recording it."""
    import time as time_mod
    clock = [0.0]
    monkeypatch.setattr(time_mod, "perf_counter", lambda: clock[0])
    timers = (profiling.StepTimer(), JaxStepTimer())
    seq = [(0.0, 1), (5.0, 2), (1.0, 4), (0.5, 1), ("reset", 0), (2.0, 8)]
    rates = ([], [])
    for dt, n in seq:
        if dt == "reset":
            clock[0] += 100.0
            for t in timers:
                t.reset()
            continue
        clock[0] += dt
        for t, out in zip(timers, rates):
            out.append(t.tick(n))
    assert rates[0] == rates[1]
    assert rates[0][:2] == [None, None] and rates[0][2] == 4.0


def test_profile_trace_writes_a_chrome_trace(tmp_path):
    import torch
    with profiling.profile_trace(str(tmp_path / "p"), "cpu"):
        torch.ones(64, 64) @ torch.ones(64, 64)
    files = os.listdir(tmp_path / "p")
    assert len(files) == 1 and files[0].startswith("trace_")
    with open(tmp_path / "p" / files[0]) as f:
        events = json.load(f)["traceEvents"]
    assert any(ev.get("cat") == "cpu_op" for ev in events)


def test_train_profile_writes_a_trace(tmp_path):
    """``vqvae-torch-train --profile 1`` on a tiny CPU run traces one
    step into <out>/profile (the tenth step, or earlier in a short
    run); the log keeps its rows."""
    import subprocess
    import sys
    out = tmp_path / "run"
    r = subprocess.run(
        [sys.executable, "-m", "vqvae_tpu_torch.cli.train", "--preset",
         "tiny", "--dataset", "sine", "--steps", "2", "--device", "cpu",
         "--out", str(out), "--profile", "1"],
        cwd=ROOT, capture_output=True, text=True, timeout=300,
        env=dict(os.environ, OMP_NUM_THREADS="1"))
    assert r.returncode == 0, r.stdout[-2000:] + r.stderr[-2000:]
    traces = os.listdir(out / "profile")
    assert len(traces) == 1 and (out / "profile" / traces[0]).stat().st_size
    with open(out / "profile" / traces[0]) as f:
        names = {ev.get("name", "") for ev in json.load(f)["traceEvents"]}
    assert any("mm" in n for n in names)   # the step's products are in it
    rows = [json.loads(ln) for ln in open(out / "log.jsonl")]
    assert [row["iteration"] for row in rows] == [1]

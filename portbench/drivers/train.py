"""Training traffic: the program's ``train/step.py::train_step`` on the
threaded ``BatchLoader``'s batches from a synthetic VCTK-layout corpus,
called as ``train/loop.py`` calls it, with no evaluation, log or
checkpoint in the window.

Set-up builds one train state from the seeded weights, drives it
through its first steps (the checked ones, then a few more to warm every
shape) and hands the same state to the window.  The reference follows
the checked steps afterwards, from the same weights and raw batches.
"""

from __future__ import annotations

import dataclasses
import os
import shutil
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor
from types import SimpleNamespace

import numpy as np

from portbench import compare, corpus, harness, trace, weights

CHECKED = 3     # steps the reference follows


def program_config(conf: dict, batch: int):
    """The program's ``Config`` holding exactly the file's groups."""
    from vqvae_tpu_torch.configs import (
        Config,
        DataConfig,
        ModelConfig,
        TrainConfig,
    )
    return Config(data=DataConfig(**conf["data"]),
                  model=ModelConfig(**conf["model"]),
                  train=dataclasses.replace(TrainConfig(**conf["train"]),
                                            batch_size=batch),
                  name=conf["preset"])


def restart_rows(seed: int):
    """The rows a dead-code restart draws at each step, from the seed:
    the same for the program and the reference."""
    import torch

    def picks(step, n_rows, K, device="cpu"):
        g = torch.Generator().manual_seed((seed * 1_000_003 + step)
                                          % (1 << 63))
        return torch.randint(0, n_rows, (K,), generator=g).to(device)
    return picks


def build(conf: dict, traffic: dict, seed: int, device: str, tmp: str):
    """The corpus, the loader and the train state, from the seed."""
    import torch

    from vqvae_tpu_torch.audio.datasets import WavDataset, scan_vctk
    from vqvae_tpu_torch.audio.grain_loader import make_loader
    from vqvae_tpu_torch.models.params import ParamTree
    from vqvae_tpu_torch.train.state import create_train_state

    B = traffic["batch"]
    cfg = program_config(conf, B)
    root = corpus.make_tree(os.path.join(tmp, "corpus"), seed,
                            traffic["corpus"])
    paths, ids, _ = scan_vctk(root)
    ds = WavDataset(paths, ids, cfg.data)
    with ThreadPoolExecutor(4) as ex:           # decoded once, in set-up
        list(ex.map(ds.full, range(len(ds))))
    loader = make_loader("threads", ds, B, seed=seed)
    dev = torch.device(device)
    p0 = weights.make(conf["model"], seed, dev)
    params = ParamTree(weights.nest({k: v.clone() for k, v in p0.items()}),
                       trainable=True)
    state = create_train_state(cfg, dev, params=params)
    return SimpleNamespace(cfg=cfg, loader=loader, state=state, p0=p0,
                           dev=dev, picks=restart_rows(seed),
                           impl=conf["vq_impl"], batch=B, kept=[],
                           cfg_model=dataclasses.asdict(cfg.model),
                           cfg_train=dataclasses.asdict(cfg.train))


def step(s, keep: bool = False):
    """One step as the training loop takes it: the next batch, to the
    device, ``train_step``.  Returns (metrics, seconds waited on the
    loader)."""
    from vqvae_tpu_torch.parallel.distributed import put_global_batch
    from vqvae_tpu_torch.train.step import train_step

    t = time.perf_counter()
    wav, spk = next(s.loader)
    wait = time.perf_counter() - t
    if keep:
        s.kept.append((wav.copy(), spk.copy()))
    wav, spk = put_global_batch(None, wav, spk, device=s.dev)
    return train_step(s.state, wav, spk, s.cfg, picks=s.picks,
                      impl=s.impl), wait


def names(s) -> dict:
    return {k.replace(".", "/"): p
            for k, p in s.state.params.named_parameters()}


def checked_steps(s) -> dict:
    """The program's readings over the first ``CHECKED`` steps: each
    loss, each leaf's first gradient as Adam holds it after one step
    (``exp_avg / (1 - beta1)``), each leaf's change after the last."""
    opt = s.state.opt
    b1 = s.cfg.train.adam_b1
    losses, grad1 = [], {}
    for i in range(CHECKED):
        met, _ = step(s, keep=True)
        losses.append(float(met["loss"]))
        if i == 0:
            grad1 = {k: float((opt.state[p]["exp_avg"] / (1 - b1))
                              .double().norm())
                     for k, p in names(s).items() if p in opt.state}
    change = {k: float((p.detach() - s.p0[k]).double().norm())
              for k, p in names(s).items()}
    return {"loss": losses, "grad1": grad1, "change": change}


def reference_readings(s, p0, prec=None) -> dict:
    """The reference over the kept batches, on the run's device."""
    import torch

    from portbench.reference import model as ref
    from portbench.reference.train import first_steps

    ref.strict_float32()
    batches = [(torch.from_numpy(w).to(s.dev), torch.from_numpy(k).to(s.dev))
               for w, k in s.kept]
    picks = s.picks
    return first_steps(p0, s.cfg_model, s.cfg_train, batches,
                       lambda st, n, K: picks(st, n, K, s.dev),
                       prec or ref.F32)


def audio_rate(steps: int, batch: int, T: int, sr: int,
               window_s: float) -> float:
    """Seconds of training audio consumed (B·T / sr a step, every step
    finished in the window) over the window's seconds."""
    return steps * batch * T / sr / window_s


def _sync(dev) -> None:
    import torch
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def run(ctx) -> dict:
    import torch

    tr = ctx.traffic
    tmp = tempfile.mkdtemp(prefix="portbench-train-", dir=ctx.tmp)
    try:
        s = build(ctx.config, tr, ctx.seed, ctx.device, tmp)
        p0 = {k: v.clone() for k, v in s.p0.items()}
        prog = checked_steps(s)
        for _ in range(tr["warm_steps"]):
            step(s)
        _sync(s.dev)
        cuda = s.dev.type == "cuda"
        if cuda:
            torch.cuda.reset_peak_memory_stats(s.dev)
        n, waits = 0, []
        t0 = time.perf_counter()
        setup_s = time.monotonic() - ctx.t_start
        while True:
            _, w = step(s)
            waits.append(w)
            n += 1
            if time.perf_counter() - t0 >= ctx.seconds:
                break
        _sync(s.dev)
        window = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated(s.dev) if cuda else 0
        B, T = s.batch, s.cfg.data.length
        obs = {"kind": "train", "model": s.cfg_model, "batch": B, "T": T,
               "step_s": window / n, "batch_wait_s": float(np.mean(waits)),
               "peak_bytes": peak}
        capture = None
        if ctx.trace:
            capture = _capture(s, tr["trace_steps"], tmp)
            obs["capture"] = capture
        s.loader.close()
        del s.state
        if cuda:
            torch.cuda.empty_cache()
        ref = reference_readings(s, p0)
        numbers = compare.train_numbers(prog, ref)
        checks = compare.checks(numbers, ctx.limits)
        return {"correct": harness.checks_pass(checks),
                "attempted": n, "failed": 0,
                "e2e": {"train_audio_s_per_s": audio_rate(
                    n, B, T, s.cfg.data.sr, window),
                        "setup_s": setup_s},
                "obs": obs, "peak_bytes": peak,
                "capture": capture, "checks": checks,
                "readings": {"program": prog, "reference": ref}}
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def _capture(s, steps: int, tmp: str) -> dict:
    """``steps`` steps under ``torch.profiler`` (host and device), the
    loader's wait and each step in a span of their own; returns the
    capture's window, the device's busy time, each source file's kernel
    seconds and the breakdown."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    acts = [ProfilerActivity.CPU]
    if s.dev.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    from vqvae_tpu_torch.parallel.distributed import put_global_batch
    from vqvae_tpu_torch.train.step import train_step

    step(s)                      # the profiler's first step runs slow
    _sync(s.dev)
    with profile(activities=acts) as prof:
        with record_function(trace.CAPTURE):
            for _ in range(steps):
                with record_function("portbench.batch_wait"):
                    wav, spk = next(s.loader)
                with record_function("portbench.train_step"):
                    wav, spk = put_global_batch(None, wav, spk,
                                                device=s.dev)
                    train_step(s.state, wav, spk, s.cfg, picks=s.picks,
                               impl=s.impl)
            _sync(s.dev)
    path = os.path.join(tmp, "trace.json")
    prof.export_chrome_trace(path)
    return summarize(trace.load(path), steps)


def summarize(tr: dict, steps: int) -> dict:
    """Window, busy time, kernel seconds by source file and the
    breakdown of one capture."""
    (lo, hi), = trace.spans(tr, trace.CAPTURE)
    ks = trace.kernels(tr, lo, hi)
    src = trace.Sources(harness.program_csrc())
    by_file: dict = {}
    for k, f in zip(ks, src.owners(ks)):
        by_file[f or "other"] = by_file.get(f or "other", 0.0) + \
            k.get("dur", 0) / 1e6
    busy = trace.union_s([(k["ts"], k["ts"] + k.get("dur", 0)) for k in ks],
                         lo, hi)
    return {"steps": steps, "window_s": (hi - lo) / 1e6, "busy_s": busy,
            "by_file": by_file, "breakdown": trace.breakdown(tr, ks, lo, hi)}

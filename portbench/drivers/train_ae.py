"""Training traffic of NSynth's WaveNet autoencoder: the program's
``train/step.py::train_step`` on the threaded ``BatchLoader``'s crops of
a synthetic corpus of notes, back to back, as ``drivers/train.py`` runs
the VQ-VAE's (whose loader step and capture summary it reuses).

The configuration's ``model`` group is the program's
``WaveNetAEConfig``; a program without it fails here at once, before
any set-up.  Set-up builds one train state from the seeded weights
(``weights_ae.py``), drives its first steps (the checked ones, then the
warm ones) and hands it to the window.  The reference
(``reference/wavenet_ae.py``) follows the checked steps afterwards from
the same weights and raw crops.  With ``--trace 1`` the capture turns
the program's spans on, writes them into the profiler's trace, and
reads the device time of the kernels each ``model.*`` span launched.

``correct`` holds four numbers: ``compare.train_numbers``'s loss gap
and change gap; ``grad_vec_gap``, the worst leaf's distance between the
program's first gradient and the reference's, whole vectors, against
the reference leaf's norm or the median leaf's, whichever is larger;
and ``crop_gap``, the worst crop's relative gap between the first
step's losses crop by crop (the program's ``crop_loss``).  The first
gradient's leaf norms (``grad_gap``) are left out: nothing that a check
must catch reads far above the program's own gaps there (``PERF.md``
§4).  Norms and a batch's mean hardly see half of a batch of 48 crops
left out; its crops' own losses do.
"""

from __future__ import annotations

import dataclasses
import os
import shutil
import statistics
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor
from types import SimpleNamespace

import numpy as np

from portbench import compare, corpus, harness, spans, trace, weights, \
    weights_ae
from portbench.drivers import train as base

def program_config(conf: dict, batch: int):
    """The program's ``Config`` holding exactly the file's groups."""
    from vqvae_tpu_torch.configs import (
        Config,
        DataConfig,
        TrainConfig,
        WaveNetAEConfig,
    )
    return Config(data=DataConfig(**conf["data"]),
                  model=WaveNetAEConfig(**conf["model"]),
                  train=dataclasses.replace(TrainConfig(**conf["train"]),
                                            batch_size=batch),
                  name=conf["preset"])


def build(conf: dict, traffic: dict, seed: int, device: str, tmp: str):
    """The corpus, the loader and the train state, from the seed."""
    B = traffic["batch"]
    cfg = program_config(conf, B)
    import torch

    from vqvae_tpu_torch.audio.datasets import WavDataset, scan_vctk
    from vqvae_tpu_torch.audio.grain_loader import make_loader
    from vqvae_tpu_torch.models.params import ParamTree
    from vqvae_tpu_torch.train.state import create_train_state

    root = corpus.make_tree(os.path.join(tmp, "corpus"), seed,
                            traffic["corpus"])
    paths, ids, _ = scan_vctk(root)
    ds = WavDataset(paths, ids, cfg.data)
    with ThreadPoolExecutor(4) as ex:           # decoded once, in set-up
        list(ex.map(ds.full, range(len(ds))))
    loader = make_loader("threads", ds, B, seed=seed)
    dev = torch.device(device)
    p0 = weights_ae.make(conf["model"], seed, dev)
    params = ParamTree(weights.nest({k: v.clone() for k, v in p0.items()}),
                       trainable=True)
    state = create_train_state(cfg, dev, params=params)
    return SimpleNamespace(cfg=cfg, loader=loader, state=state, p0=p0,
                           dev=dev, picks=None, impl="lax", batch=B, kept=[],
                           cfg_model=dataclasses.asdict(cfg.model),
                           cfg_train=dataclasses.asdict(cfg.train))


def checked_steps(s) -> dict:
    """``drivers/train.py::checked_steps``, keeping besides each leaf's
    first gradient whole (``grad1_vec``, on the host) and each crop's
    first loss (``crop_loss1``)."""
    opt, b1 = s.state.opt, s.cfg.train.adam_b1
    losses, grad1, vec, crops = [], {}, {}, []
    for i in range(base.CHECKED):
        met, _ = base.step(s, keep=True)
        losses.append(float(met["loss"]))
        if i == 0 and "crop_loss" in met:     # else every crop reads 0
            crops = met["crop_loss"].float().cpu().tolist()
            for k, p in base.names(s).items():
                if p in opt.state:
                    g = opt.state[p]["exp_avg"] / (1 - b1)
                    grad1[k] = float(g.double().norm())
                    vec[k] = g.float().cpu()
    change = {k: float((p.detach() - s.p0[k]).double().norm())
              for k, p in base.names(s).items()}
    return {"loss": losses, "crop_loss1": crops, "grad1": grad1,
            "change": change, "grad1_vec": vec}


def reference_readings(s, p0, prec=None) -> dict:
    """The reference over the kept crops, on the run's device, with its
    first gradient whole (``grad1_vec``)."""
    import torch

    from portbench.reference import model as ref
    from portbench.reference.wavenet_ae import first_steps

    ref.strict_float32()
    batches = [(torch.from_numpy(w).to(s.dev), None) for w, _ in s.kept]
    return first_steps(p0, s.cfg_model, s.cfg_train, batches,
                       prec or ref.F32, vectors=True)


def grad_vec_gap(vec: dict, ref_vec: dict) -> float:
    """The worst leaf's ``|g - g_ref| / max(|g_ref|, median leaf's)``
    (a leaf the program has no gradient for counts as zeros)."""
    norms = {k: float(v.double().norm()) for k, v in ref_vec.items()}
    med = statistics.median(norms.values())
    return max(float(((vec[k].to(v.device).double() if k in vec else 0.0)
                      - v.double()).norm()) / max(norms[k], med, 1e-30)
               for k, v in ref_vec.items())


def crop_gap(prog: list, ref: list) -> float:
    """The worst crop's ``|l - l_ref| / |l_ref|`` over the reference's
    crops (a crop the program has no loss for counts as 0)."""
    return max(abs((prog[i] if i < len(prog) else 0.0) - r)
               / max(abs(r), 1e-30) for i, r in enumerate(ref))


def numbers(prog: dict, ref: dict) -> dict:
    """The compared numbers of two readings that hold ``grad1_vec`` and
    ``crop_loss1``."""
    n = compare.train_numbers(prog, ref)
    return {"loss_gap": n["loss_gap"], "change_gap": n["change_gap"],
            "grad_vec_gap": grad_vec_gap(prog["grad1_vec"],
                                         ref["grad1_vec"]),
            "crop_gap": crop_gap(prog["crop_loss1"], ref["crop_loss1"])}


def run(ctx) -> dict:
    import torch

    tr = ctx.traffic
    tmp = tempfile.mkdtemp(prefix="portbench-train-ae-", dir=ctx.tmp)
    try:
        s = build(ctx.config, tr, ctx.seed, ctx.device, tmp)
        p0 = {k: v.clone() for k, v in s.p0.items()}
        prog = checked_steps(s)
        for _ in range(tr["warm_steps"]):
            base.step(s)
        base._sync(s.dev)
        cuda = s.dev.type == "cuda"
        if cuda:
            torch.cuda.reset_peak_memory_stats(s.dev)
        n, waits = 0, []
        t0 = time.perf_counter()
        setup_s = time.monotonic() - ctx.t_start
        while True:
            _, w = base.step(s)
            waits.append(w)
            n += 1
            if time.perf_counter() - t0 >= ctx.seconds:
                break
        base._sync(s.dev)
        window = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated(s.dev) if cuda else 0
        B, T = s.batch, s.cfg.data.length
        obs = {"kind": "train", "arch": "wavenet_ae", "model": s.cfg_model,
               "batch": B, "T": T, "step_s": window / n,
               "batch_wait_s": float(np.mean(waits)), "peak_bytes": peak}
        capture = None
        if ctx.trace:
            capture = _capture(s, tr["trace_steps"], tmp)
            obs["capture"] = capture
        s.loader.close()
        del s.state
        if cuda:
            torch.cuda.empty_cache()
        ref = reference_readings(s, p0)
        checks = compare.checks(numbers(prog, ref), ctx.limits)
        for r in (prog, ref):
            del r["grad1_vec"]
        return {"correct": harness.checks_pass(checks),
                "attempted": n, "failed": 0,
                "e2e": {"train_audio_s_per_s": base.audio_rate(
                    n, B, T, s.cfg.data.sr, window),
                        "setup_s": setup_s},
                "obs": obs, "peak_bytes": peak,
                "capture": capture, "checks": checks,
                "readings": {"program": prog, "reference": ref}}
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def kernel_s_by_span(tr: dict) -> dict:
    """Device seconds of the capture's kernels by the program span that
    launched each (``spans.Launchers``; ``no span`` where none)."""
    (lo, hi), = trace.spans(tr, trace.CAPTURE)
    who = spans.Launchers(tr)
    out: dict = {}
    for k in trace.kernels(tr, lo, hi):
        sp = who.of(k)
        name = sp["name"] if sp else "no span"
        out[name] = out.get(name, 0.0) + k.get("dur", 0) / 1e6
    return dict(sorted(out.items(), key=lambda x: -x[1]))


def _capture(s, steps: int, tmp: str) -> dict:
    """``steps`` steps under ``torch.profiler`` with the program's spans
    on: ``drivers/train.py::summarize`` of the trace, the device seconds
    of the stack's forward (``stack_fwd_s``), the kernels' seconds by
    launching span, the idle time a step by phase and the program's
    counters over the capture."""
    from torch.profiler import ProfilerActivity, profile, record_function

    from vqvae_tpu_torch.parallel.distributed import put_global_batch
    from vqvae_tpu_torch.train.step import train_step
    from vqvae_tpu_torch.utils import profiling

    acts = [ProfilerActivity.CPU]
    if s.dev.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    base.step(s)                 # the profiler's first step runs slow
    base._sync(s.dev)
    profiling.reset()
    with profile(activities=acts) as prof:
        profiling.set_tracing(True)
        with record_function(trace.CAPTURE):
            for _ in range(steps):
                with record_function("portbench.batch_wait"):
                    wav, spk = next(s.loader)
                with record_function("portbench.train_step"):
                    wav, spk = put_global_batch(None, wav, spk,
                                                device=s.dev)
                    train_step(s.state, wav, spk, s.cfg)
            base._sync(s.dev)
        profiling.set_tracing(False)
    path = os.path.join(tmp, "trace.json")
    prof.export_chrome_trace(path)
    counts = profiling.export(path)["counters"]
    tr = trace.load(path)
    cap = base.summarize(tr, steps)
    cap["stack_fwd_s"] = spans.span_kernel_s(tr, "model.decoder_stack")
    cap["kernel_s_by_span"] = kernel_s_by_span(tr)
    cap["idle_ms"] = spans.idle_by_phase(tr, steps)
    cap["counters"] = {k: counts.get(k) for k in ("ae.samples", "ae.frames")}
    return cap

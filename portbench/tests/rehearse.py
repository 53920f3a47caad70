"""A CPU rehearsal of one cell: the harness's run without its look for a
card, on the program's plain versions of the kernels, at a size the CPU
holds.  Prints the result line, then the loaded modules that are JAX's
or the JAX package's (``forbidden: [...]``).

    python -m portbench.tests.rehearse --workload CELL --seed N \
        --seconds S --trace 0|1

Tests run it in a copy of the benchmark that holds the cells of
``tiny_cells``; a fault planted by a ``sitecustomize`` module in that
copy reaches both the harness and the daemon's process.
"""

from __future__ import annotations

import argparse
import json
import shutil
import sys
from pathlib import Path

TINY_MODEL = {
    "mu": 256, "mulaw_mode": "round", "enc_channels": 32, "enc_layers": 6,
    "enc_kernel": 4, "enc_stride": 2, "K": 128, "d": 16, "beta": 0.25,
    "ema": False, "ema_decay": 0.99, "ema_eps": 1e-05,
    "code_restart_threshold": 0.0, "n_loop": 1, "n_layer": 10,
    "residual_channels": 32, "skip_channels": 64, "filter_size": 2,
    "n_speakers": 4, "speaker_embed_dim": 8, "upsample_kernel_mult": 2,
    "compute_dtype": "bfloat16", "param_dtype": "float32",
    "decoder_kernel": "pallas", "encoder_kernel": "xla",
    "head_kernel": "xla", "embed_in_kernel": False,
    "bwd_time_windows": 0, "remat": False}


def tiny_cells(root: Path) -> None:
    """Add a tiny configuration (two of its variants) and tiny training
    and serving cells to the benchmark under ``root``, by new files and
    new ``BENCHMARK.json`` entries alone."""
    pb = root / "portbench"
    base = json.loads((pb / "configs" / "vctk-multi.json").read_text())
    data = dict(base["data"], length=1024, n_speakers=4)
    for name, extra in (("tiny", {}),
                        ("tiny-ema", {"ema": True,
                                      "code_restart_threshold": 1e-3,
                                      "decoder_kernel": "pallas_sg",
                                      "head_kernel": "pallas",
                                      "embed_in_kernel": True})):
        conf = dict(base, name=name, preset="tiny", data=data,
                    model=dict(TINY_MODEL, **extra), vq_impl="lax")
        (pb / "configs" / f"{name}.json").write_text(json.dumps(conf))
    (pb / "traffic" / "train.t2.json").write_text(json.dumps({
        "driver": "train", "batch": 2, "warm_steps": 1, "trace_steps": 2,
        "corpus": {"speakers": 4, "utterances_per_speaker": 2,
                   "seconds": [0.3, 0.5], "silence_s": 0.05}}))
    (pb / "traffic" / "serve.t1.json").write_text(json.dumps({
        "driver": "serve_session", "clients": 2, "rate_x": 1.0,
        "push_frames": 2,
        "session_seconds": [0.05, 0.1], "sessions_per_client": 4,
        "greedy_every": 2, "temperature": 1.0, "warm_pushes": 1,
        "trace_seconds": 1}))
    man = json.loads((root / "BENCHMARK.json").read_text())
    for name in ("tiny", "tiny-ema"):
        man["configs"].append({"name": name, "source": "test",
                               "file": f"portbench/configs/{name}.json",
                               "reduced": [], "why": "CPU rehearsal"})
    cells = [("tiny.train.t2", "tiny", "train.t2"),
             ("tiny-ema.train.t2", "tiny-ema", "train.t2"),
             ("tiny.serve.t1", "tiny", "serve.t1")]
    for cell, conf, traffic in cells:
        man["workloads"].append({"name": cell, "config": conf,
                                 "traffic": traffic, "chips": 1,
                                 "why": "CPU rehearsal"})
        kind = "train" if "train" in cell else "serve"
        for m in man["end_to_end"] + man["per_layer"]:
            if "workloads" in m and any(w.split(".")[1] == kind
                                        for w in m["workloads"]):
                m["workloads"].append(cell)
        limits = ({"loss_gap": 2.5e-4, "grad_gap": 0.1, "change_gap": 0.1}
                  if kind == "train" else {"logit_gap": 0.1})
        (pb / "limits" / f"{cell}.json").write_text(json.dumps(limits))
    (root / "BENCHMARK.json").write_text(json.dumps(man, indent=1))


def copy_bench(src: Path, dst: Path) -> Path:
    """The benchmark's files alone (``BENCHMARK.json`` and ``paths``)."""
    shutil.copy(src / "BENCHMARK.json", dst / "BENCHMARK.json")
    for p in json.loads((src / "BENCHMARK.json").read_text())["paths"]:
        shutil.copytree(src / p, dst / p,
                        ignore=shutil.ignore_patterns("__pycache__"))
    return dst


def main(argv=None) -> int:
    import os
    import time
    os.environ.setdefault("OMP_NUM_THREADS", "2")
    from portbench import harness
    from portbench.run import run_cell
    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, default=1.0)
    p.add_argument("--trace", type=int, default=0)
    args = p.parse_args(argv)
    t0 = time.monotonic()
    harness.prepare_env()
    import torch
    torch.set_num_threads(2)
    spec = harness.cell_spec(args.workload)
    res = run_cell(spec, args.seed, args.seconds, bool(args.trace), "cpu",
                   t0)
    harness.emit(res)
    print("forbidden: " + json.dumps(harness.forbidden_modules()))
    return 0


if __name__ == "__main__":
    sys.exit(main())

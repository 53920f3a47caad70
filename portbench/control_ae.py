"""Readings that the WaveNet autoencoder's limits
(``limits/nsynth-h512.train.b48.json``) are set from, as ``control.py``
takes them for the VQ-VAE's training cells: per seed, the program's
first three steps against the reference (the lower reading), in the
four numbers of ``drivers/train_ae.py::numbers`` and the first
gradient's leaf norms (``grad_gap``, read but not compared); on the
first ``--control-seeds`` seeds also the control (the reference with
float8 e4m3 operands in every product and in the gradients reaching
them, in the program's place) and two faults planted in the reference
in the program's place: half of the batch left out (each batch's first
half twice over, so the mean over the rest with the crops' count kept)
and Adam's steps left out (the state unchanged: its change reads 1).
The benchmark's own runs do not run this.

    python3 -m portbench.control_ae --workload CELL --seeds A B C ... \
        [--control-seeds N]

Each seed prints one JSON line.
"""

from __future__ import annotations

import argparse
import json
import shutil
import sys
import tempfile
import time
from types import SimpleNamespace

import numpy as np


def train_seed(spec, seed: int, with_control: bool, device: str) -> dict:
    import torch

    from portbench import compare
    from portbench.drivers import train_ae as drv
    from portbench.reference import model as ref

    tmp = tempfile.mkdtemp(prefix="pb-ctl-ae-")
    try:
        s = drv.build(spec.config, spec.traffic, seed, device, tmp)
        p0 = {k: v.clone() for k, v in s.p0.items()}
        prog = drv.checked_steps(s)
        s.loader.close()
        del s.state
        if torch.device(device).type == "cuda":
            torch.cuda.empty_cache()
        r = drv.reference_readings(s, p0)

        def numbers(x):
            return {**drv.numbers(x, r),
                    "grad_gap": compare.train_numbers(x, r)["grad_gap"],
                    "leaves": compare.leaf_gaps(x, r)}
        out = {"seed": seed, "program": numbers(prog)}
        if with_control:
            out["control"] = numbers(
                drv.reference_readings(s, p0, ref.Prec("fp8")))
            half = SimpleNamespace(**vars(s))
            half.kept = [(np.concatenate([w[:len(w) // 2]] * 2),
                          np.concatenate([k[:len(k) // 2]] * 2))
                         for w, k in s.kept]
            out["half_batch"] = numbers(drv.reference_readings(half, p0))
            still = SimpleNamespace(**vars(s))
            still.cfg_train = dict(s.cfg_train, lr=0.0)
            out["unchanged"] = numbers(drv.reference_readings(still, p0))
        return out
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def main(argv=None) -> int:
    from portbench import harness
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--control-seeds", type=int, default=3)
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    harness.prepare_env()
    spec = harness.cell_spec(args.workload)
    for i, seed in enumerate(args.seeds):
        t0 = time.monotonic()
        out = train_seed(spec, seed, i < args.control_seeds, args.device)
        out["seconds"] = time.monotonic() - t0
        print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

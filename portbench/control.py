"""Readings that the limits of ``limits/<cell>.json`` are set from: the
program's numbers over many seeds (the lower reading), the control's
(the reference in the program's place, in the precision below the
configuration's: float8 e4m3 operands for bf16 compute) and the planted
faults' (the upper reading).  The benchmark's own runs do not run this.

    python3 -m portbench.control --workload CELL --seeds A B C ... \
        [--control-seeds N] [--seconds S]

Training: per seed, the program's first three steps against the
reference; on the first ``--control-seeds`` seeds also the control's and
faults planted in the reference put in the program's place: half of
the batch left out, the mean taken over the rest; Adam's steps left out
(a state left unchanged but for the codebook's moving averages).

Serving: per seed, one run of the cell's traffic for ``--seconds``; the
program's widest gap, the control's (the gap of the id the control puts
first at each position of the same served audio) and a token altered
where it is produced (the gap of the id half the classes away from the
served one, its median over the positions).

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


def train_seed(spec, seed: int, with_control: bool, device: str) -> dict:
    import torch

    from portbench import compare
    from portbench.drivers import train as drv
    from portbench.reference import model as ref

    tmp = tempfile.mkdtemp(prefix="pb-ctl-")
    try:
        s = drv.build(spec.config, spec.traffic, seed, device, tmp)
        p0 = {k: v.clone() for k, v in s.p0.items()}
        prog = drv.checked_steps(s)
        s.loader.close()
        del s.state
        torch.cuda.empty_cache()
        r = drv.reference_readings(s, p0)
        def numbers(x):
            return {**compare.train_numbers(x, r),
                    "leaves": compare.leaf_gaps(x, r)}
        out = {"seed": seed, "program": numbers(prog)}
        if with_control:
            c = drv.reference_readings(s, p0, ref.Prec("fp8"))
            out["control"] = numbers(c)
            half = SimpleNamespace(**vars(s))
            half.kept = [(w[:len(w) // 2], k[:len(k) // 2])
                         for w, k in s.kept]
            out["half_batch"] = numbers(drv.reference_readings(half, p0))
            still = SimpleNamespace(**vars(s))
            still.cfg_train = dict(s.cfg_train, lr=0.0)
            out["unchanged"] = numbers(drv.reference_readings(still, p0))
        return out
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def serve_seed(spec, seed: int, seconds: float, device: str,
               t_start: float) -> dict:
    from portbench.drivers import serve_session as drv

    ctx = SimpleNamespace(cell=spec.name, config=spec.config,
                          traffic=spec.traffic, limits=spec.limits,
                          seed=seed, seconds=seconds, trace=False,
                          device=device, t_start=t_start,
                          tmp=tempfile.gettempdir(), control=True)
    out = drv.run(ctx)
    return {"seed": seed, "program": {"logit_gap": out["checks"]
                                      ["logit_gap"]["value"]},
            "control": {"logit_gap": out["control"]["fp8"]},
            "altered_token": {"logit_gap": out["control"]["altered"]},
            "attempted": out["attempted"], "failed": out["failed"]}


def main(argv=None) -> int:
    from portbench import harness
    t_start = harness.process_start()
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--control-seeds", type=int, default=3)
    p.add_argument("--seconds", type=float, default=10.0)
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    harness.prepare_env()
    spec = harness.cell_spec(args.workload)
    for i, seed in enumerate(args.seeds):
        t0 = time.monotonic()
        if spec.traffic["driver"] == "train":
            out = train_seed(spec, seed, i < args.control_seeds, args.device)
        else:
            out = serve_seed(spec, seed, args.seconds, args.device, t_start)
        out["seconds"] = time.monotonic() - t0
        print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

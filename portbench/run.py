"""Run one cell of the benchmark once and print its result line.

    python3 -m portbench.run --workload <cell> --seed <n> \
        --seconds <s> --trace <0|1>

The cell's configuration, traffic and limits are found by name through
``BENCHMARK.json``; its traffic's driver (``drivers/<driver>.py``) runs
the program on the card.  With ``--trace 0`` the line carries the cell's
end-to-end metrics, with ``--trace 1`` its per-layer metrics, each read
by ``metrics/<name>.py`` from what the traced run observed.  The run
exits with a code other than 0, and prints no result, without enough
cards, or if JAX or the JAX package was loaded.
"""

from __future__ import annotations

import argparse
import sys
import tempfile
from types import SimpleNamespace

from portbench import harness


def run_cell(spec, seed: int, seconds: float, trace: bool, device: str,
             t_start: float) -> dict:
    """Drive the cell on ``device`` and assemble its result (no look for
    a card here: ``main`` makes it)."""
    import torch

    drv = harness.driver(spec.traffic["driver"])
    ctx = SimpleNamespace(cell=spec.name, config=spec.config,
                          traffic=spec.traffic, limits=spec.limits,
                          seed=seed, seconds=seconds, trace=trace,
                          device=device, t_start=t_start,
                          tmp=tempfile.gettempdir())
    out = drv.run(ctx)
    units = {m["name"]: m["unit"] for m in spec.end_to_end + spec.per_layer}
    if trace:
        values = {}
        for m in spec.per_layer:
            v = harness.reader(m["name"])(out["obs"])
            if v is not None:
                values[m["name"]] = v
    else:
        values = {m["name"]: out["e2e"][m["name"]] for m in spec.end_to_end}
    cuda = device.startswith("cuda")
    dev = {"platform": "gpu" if cuda else "cpu",
           "kind": torch.cuda.get_device_name(0) if cuda else "cpu",
           "count": spec.chips, "memory_peak_bytes": int(out["peak_bytes"]),
           "power_limit_w": harness.power_limit_w() if cuda else None}
    result = {"correct": out["correct"], "attempted": out["attempted"],
              "failed": out["failed"],
              "metrics": {k: {"value": v, "unit": units[k]}
                          for k, v in values.items()},
              "device": dev, "checks": out["checks"],
              "readings": out.get("readings")}
    cap = out.get("capture")
    if trace and cap:
        dev["busy_s"] = cap["busy_s"]
        dev["window_s"] = cap["window_s"]
        result["breakdown"] = cap["breakdown"]
    return result


def main(argv=None) -> int:
    t_start = harness.process_start()
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    harness.prepare_env()
    spec = harness.cell_spec(args.workload)
    import torch
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < spec.chips:
        print(f"{args.workload} needs {spec.chips} CUDA device(s); "
              f"found {torch.cuda.device_count()}", file=sys.stderr)
        return 3
    result = run_cell(spec, args.seed, args.seconds, bool(args.trace),
                      "cuda", t_start)
    bad = harness.forbidden_modules()
    if bad:
        print(f"loaded in the measuring process: {', '.join(bad)}",
              file=sys.stderr)
        return 4
    harness.emit(result)
    return 0


if __name__ == "__main__":
    sys.exit(main())

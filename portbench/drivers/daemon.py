"""The serving cells' daemon process: the program's
``vqvae-torch-serve`` (``cli/serve.py::main``) on weights made from the
seed, with a control channel on standard input for the harness.

    python3 -m portbench.drivers.daemon --config FILE --seed N \
        --weights OUT.npz (--socket PATH | --tcp HOST:PORT) [--device D]

The weights are drawn on the device (``weights.py``) and written to
``OUT.npz`` in the program's export layout; the daemon loads them from
there, and so does the reference after the run.  Control lines, each
answered by one ``portbench: ...`` line on standard output:
``reset_mem`` (reset the peak-memory statistics), ``mem`` (the peak
bytes), ``trace_start PATH`` and ``trace_stop`` (a ``torch.profiler``
capture of this process, written to PATH as a Chrome trace).
"""

from __future__ import annotations

import argparse
import sys
import threading

from portbench import harness


def _all_threads() -> dict:
    """The profiler's option to record the host operators of every
    thread (the daemon answers each connection on a thread of its own),
    where this torch has it."""
    try:
        from torch._C._profiler import _ExperimentalConfig
        return {"experimental_config":
                _ExperimentalConfig(profile_all_threads=True)}
    except (ImportError, TypeError):
        return {}


def _control(dev: str) -> None:
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    from portbench import trace

    cuda = dev.startswith("cuda")
    prof = span = path = None
    for line in sys.stdin:
        cmd, _, arg = line.strip().partition(" ")
        if cmd == "reset_mem":
            if cuda:
                torch.cuda.reset_peak_memory_stats()
            reply = "ok"
        elif cmd == "mem":
            reply = str(torch.cuda.max_memory_allocated() if cuda else 0)
        elif cmd == "trace_start":
            acts = [ProfilerActivity.CPU] + \
                ([ProfilerActivity.CUDA] if cuda else [])
            prof, path = profile(activities=acts, **_all_threads()), arg
            prof.start()
            span = record_function(trace.CAPTURE)
            span.__enter__()
            reply = "ok"
        elif cmd == "trace_stop":
            span.__exit__(None, None, None)
            prof.stop()
            prof.export_chrome_trace(path)
            reply = "ok"
        else:
            reply = f"unknown {cmd!r}"
        print(f"portbench: {reply}", flush=True)


def main(argv=None) -> None:
    harness.prepare_env()
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--config", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--weights", required=True)
    p.add_argument("--socket")
    p.add_argument("--tcp")
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)

    import numpy as np
    import torch

    from portbench import weights
    from vqvae_tpu_torch.cli import serve

    conf = harness.load_json(args.config)
    flat = weights.make(conf["model"], args.seed, torch.device(args.device))
    np.savez(args.weights, **{k: v.cpu().numpy() for k, v in flat.items()})
    del flat
    sets = []
    for group in ("data", "model"):
        for k, v in conf[group].items():
            sets += ["--set", f"{group}.{k}={v}"]
    where = ["--socket", args.socket] if args.socket else ["--tcp", args.tcp]
    sys.argv = ["vqvae-torch-serve", "--preset", conf["preset"], *sets,
                "-m", args.weights, *where, "--engine", "kernel",
                "--device", args.device]
    threading.Thread(target=_control, args=(args.device,),
                     daemon=True).start()
    serve.main()


if __name__ == "__main__":
    main()

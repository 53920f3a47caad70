"""What the probes share: the device, CUDA-event timing (per call and
by CUDA-graph replay), errors and the JSON line."""

from __future__ import annotations

import argparse
import json
import statistics

import torch

# the read-cost bound of the probes
from vqvae_tpu_torch.utils.flops import PEAK_BYTES  # noqa: F401


def add_device_arg(p: argparse.ArgumentParser) -> None:
    p.add_argument("--device", default="cuda",
                   help="cuda (default) or cpu (checks only, no times)")


def resolve_device(name: str) -> torch.device:
    """The probe's device; a CUDA device without a GPU is an error."""
    dev = torch.device(name)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise SystemExit(f"--device {name}: no CUDA device is available "
                             "(use --device cpu for the checks alone)")
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    elif dev.type != "cpu":
        raise SystemExit(f"no probe device {name}")
    return dev


def device_name(dev: torch.device) -> str:
    return torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"


def cuda_ms(fn, dev: torch.device, reps: int = 10):
    """Mean milliseconds per call of fn on the card (CUDA events around
    ``reps`` calls after one warm-up call); None off the card."""
    if dev.type != "cuda":
        return None
    fn()
    e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    e0.record()
    for _ in range(reps):
        fn()
    e1.record()
    torch.cuda.synchronize(dev)
    return e0.elapsed_time(e1) / reps


def graph_ms(fn, dev: torch.device, reps: int = 10, replays: int = 5):
    """Device milliseconds per call of fn: ``reps`` calls captured in one
    ``torch.cuda.CUDAGraph`` (after one eager warm-up call), replayed
    ``replays`` times between CUDA events after a warm-up replay; the
    median replay over ``reps``.  A replay launches only the kernels, so
    this is the card's time without the host's.  Capturing runs fn once
    per captured call, so kernel launch counters count the capture, not
    the replays.  None off the card."""
    if dev.type != "cuda":
        return None
    fn()
    torch.cuda.synchronize(dev)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    times = []
    for _ in range(replays):
        e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        e0.record()
        graph.replay()
        e1.record()
        torch.cuda.synchronize(dev)
        times.append(e0.elapsed_time(e1) / reps)
    return statistics.median(times)


def errors(got: torch.Tensor, want: torch.Tensor) -> tuple[float, float]:
    """(max absolute error, that over max |want|)."""
    err = float((got.float() - want.float()).abs().max())
    return err, err / (float(want.float().abs().max()) + 1e-30)


class Checks:
    """Named comparisons against tolerances; ``failed`` lists the ones
    outside theirs."""

    def __init__(self):
        self.rows: dict = {}
        self.failed: list = []

    def close(self, name, got, want, tol) -> float:
        """got within tol·max|want| of want; returns the relative error."""
        ok_finite = bool(torch.isfinite(got.float()).all())
        abs_err, rel = errors(got, want)
        self.rows[name] = {"max_abs_err": abs_err, "max_rel_err": rel,
                           "tol": tol}
        if not ok_finite or not rel <= tol:
            self.failed.append(name)
        return rel

    def exact(self, name, got, want) -> bool:
        """got equal to want, bit for bit."""
        same = (got.shape == want.shape and got.dtype == want.dtype
                and torch.equal(got, want))
        abs_err = (errors(got, want)[0] if got.shape == want.shape
                   else float("inf"))
        self.rows[name] = {"max_abs_err": abs_err, "exact": same}
        if not same:
            self.failed.append(name)
        return same


def emit(record: dict) -> None:
    """The probe's JSON line."""
    print(json.dumps(record), flush=True)


def finish(record: dict, checks: Checks) -> None:
    """Print the JSON line with the checks; exit 1 if any failed."""
    record["checks"] = checks.rows
    record["failed"] = checks.failed
    emit(record)
    if checks.failed:
        raise SystemExit(f"checks outside their tolerance: {checks.failed}")

"""Tracing and step timing (port of ``vqvae_tpu/utils/profiling.py``).

* ``profile_trace(dir, device)``: a context manager around
  ``torch.profiler`` that writes a Chrome trace (``trace_<pid>.json``,
  readable by ``chrome://tracing`` or Perfetto) under ``dir``, with the
  card's kernels when the device is a GPU.
* ``StepTimer``: a smoothed wall-clock step rate, ticked only where the
  host has waited for the device.
"""

from __future__ import annotations

import contextlib
import os
import time

import torch


@contextlib.contextmanager
def profile_trace(log_dir: str, device="cpu"):
    """Trace host and (on a GPU) device activity while the block runs;
    the trace lands in ``<log_dir>/trace_<pid>.json``."""
    from torch.profiler import ProfilerActivity, profile
    device = torch.device(device)
    activities = [ProfilerActivity.CPU]
    if device.type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
        if device.type == "cuda":
            torch.cuda.synchronize(device)
    prof.export_chrome_trace(os.path.join(log_dir,
                                          f"trace_{os.getpid()}.json"))


class StepTimer:
    """Smoothed steps/sec over HOST-SYNCHRONIZED intervals.

    Call ``tick(n)`` only where the device has provably caught up (right
    after a ``torch.cuda.synchronize()`` or a read of the step's
    metrics), passing the number of steps since the previous tick.
    Ticking every step without a sync would measure the host's enqueue
    rate: CUDA launches are asynchronous.
    """

    def __init__(self, alpha: float = 0.5):
        self.alpha = alpha
        self.ema = None          # smoothed seconds per step
        self._last = None
        self._ticks = 0

    def tick(self, n: int = 1) -> float | None:
        """Record an ``n``-step synchronized interval; returns smoothed
        steps/sec (None until a steady-state interval exists).  The
        first interval is discarded: it holds the kernels' first builds
        and launches, which would poison the average for many
        intervals."""
        now = time.perf_counter()
        self._ticks += 1
        if self._last is None:
            self._last = now
            return None
        dt = (now - self._last) / max(1, n)
        self._last = now
        if self._ticks == 2:        # the interval holding the first step
            return None
        self.ema = dt if self.ema is None else \
            (1 - self.alpha) * self.ema + self.alpha * dt
        return 1.0 / self.ema if self.ema else None

    def reset(self) -> None:
        """Restart the current interval without recording it: call after
        non-training work at a tick boundary (a validation pass) so its
        wall time never deflates a training interval."""
        if self._last is not None:
            self._last = time.perf_counter()

"""Tracing and step timing (port of ``vqvae_tpu/utils/profiling.py``).

* ``profile_trace(dir, device)``: a context manager around
  ``torch.profiler`` that writes a Chrome trace (``trace_<pid>.json``,
  readable by ``chrome://tracing`` or Perfetto) under ``dir``, with the
  card's kernels when the device is a GPU, and the program's spans of
  the traced block merged into it.
* ``StepTimer``: a smoothed wall-clock step rate, ticked only where the
  host has waited for the device.
* The program's spans and counters: ``span(name)`` around the work of a
  layer, ``counter(name, n)`` at the same boundaries, ``overlap(name)``
  counting the blocks entered while another thread's was under way, all
  inert until ``set_tracing(True)``.  A span records ``(name, start,
  end, thread, parent, request)`` into a bounded ring; under an active
  ``torch.profiler`` session it also enters ``record_function(name)``.
  ``export(trace_path)`` puts the ring's spans on an exported trace's
  clock (through the anchors ``set_tracing`` records on both clocks) and
  writes them into it, so that spans of threads the profiler does not
  record line up with the card's kernels.

Span names (the ``layer.what`` a span times): ``train.step`` and its
phases ``train.frame``, ``train.zero_grad``, ``train.forward``,
``train.backward``, ``train.optimizer``, ``train.codebook``; the
forward's ``model.encoder``, ``model.vq``, ``model.upsample``,
``model.decoder_stack`` (its chunk kernels' calls
``model.decoder_stack.fwd``), ``model.head`` and, on autograd's thread,
``model.decoder_stack.bwd`` and ``model.head.bwd``; the loader's
``data.wait`` and the batch's copy to the device, ``data.put``; the
daemon's ``serve.recv``, ``serve.parse``,
``serve.lock_wait``, ``serve.handle``, ``serve.respond`` and
``stream.pcm_encode``; the decode engine's ``stream.upload``,
``stream.upsample``, ``stream.decode`` and ``stream.readback``.
"""

from __future__ import annotations

import bisect
import collections
import contextlib
import itertools
import json
import os
import threading
import time
from typing import Callable, Dict, List, Optional

import numpy as np
import torch
from torch.autograd import profiler as _torch_profiler

RING = 1 << 16            # spans kept; the oldest is dropped past this
ANCHOR = "trace.anchor"   # a span on both clocks: ANCHOR.<n>
ANCHORS = 8               # anchors recorded at a time

_on = False               # the one switch: set_tracing()
_ring: collections.deque = collections.deque(maxlen=RING)
_ids = itertools.count(1)
_requests = itertools.count(1)
_anchors = itertools.count(1)
_counts: Dict[str, int] = {}
_groups: Dict[str, Callable[[], dict]] = {}
_inflight: Dict[str, int] = {}   # overlap(): blocks under way, by name
_dropped = 0
_lock = threading.Lock()  # _counts, _inflight, _dropped: threads update all


class _Thread(threading.local):
    def __init__(self):
        self.stack: List["_Span"] = []   # open spans, innermost last
        self.request: Optional[int] = None
        self.id = threading.get_native_id()
        self.name = threading.current_thread().name


_tls = _Thread()


class _NoSpan:
    """The shared context every span is while tracing is off."""
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


NO_SPAN = _NoSpan()


class _Span:
    __slots__ = ("name", "ids", "id", "parent", "rf", "t0")

    def __init__(self, name: str, ids: dict):
        self.name, self.ids = name, ids

    def __enter__(self):
        stack = _tls.stack
        self.parent = stack[-1].id if stack else None
        self.id = next(_ids)
        stack.append(self)
        self.rf = None
        if _profiler_on():      # the profiler's event brackets the span
            self.rf = _torch_profiler.record_function(self.name)
            self.rf.__enter__()
        self.t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        t1 = time.perf_counter_ns()
        if self.rf is not None:
            self.rf.__exit__(None, None, None)
        tls = _tls
        tls.stack.pop()
        _record((self.id, self.name, self.t0, t1, tls.id, tls.name,
                 self.parent, self.ids.get("request", tls.request),
                 self.ids))
        return False


def _profiler_on() -> bool:
    """A ``torch.profiler`` session is active: torch's own flag for
    fast checks (set for a session that records every thread, where the
    thread-local test reads false), else the thread-local test."""
    return (getattr(_torch_profiler, "_is_profiler_enabled", False)
            or torch.autograd._profiler_enabled())


def _record(row: tuple) -> None:
    global _dropped
    with _lock:
        if len(_ring) == _ring.maxlen:
            _dropped += 1
        _ring.append(row)


def span(name: str, **ids):
    """Time the block as the span ``name`` (``ids``, e.g. ``op=...``,
    are kept with it).  With tracing off: the shared no-op context."""
    if not _on:
        return NO_SPAN
    return _Span(name, ids)


def counter(name: str, n: int = 1) -> None:
    """Add ``n`` to the counter ``name`` (nothing with tracing off)."""
    if _on:
        with _lock:
            _counts[name] = _counts.get(name, 0) + n


class _Overlap:
    __slots__ = ("name",)

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        with _lock:
            n = _inflight.get(self.name, 0)
            if n:
                _counts[self.name] = _counts.get(self.name, 0) + 1
            _inflight[self.name] = n + 1
        return self

    def __exit__(self, *exc):
        with _lock:
            _inflight[self.name] -= 1
        return False


def overlap(name: str):
    """The block is under way as ``name`` while it runs: entering it
    while another thread's block of that name is under way adds 1 to
    the counter ``name``.  With tracing off: the shared no-op context."""
    if not _on:
        return NO_SPAN
    return _Overlap(name)


def begin_request() -> Optional[int]:
    """A new request id for this thread's spans from here on (None with
    tracing off): every span of one request shares it."""
    if not _on:
        return None
    _tls.request = next(_requests)
    return _tls.request


def tracing() -> bool:
    return _on


def set_tracing(on: bool) -> None:
    """The one switch.  Under an active profiler it records anchors,
    turning on and (before) turning off, for ``export`` to align by."""
    global _on
    if not on and _on:
        _anchor()
    _on = bool(on)
    if on:
        _anchor()


def reset() -> None:
    """Empty the ring and zero the counters."""
    global _dropped
    with _lock:
        _ring.clear()
        _counts.clear()
        _dropped = 0


def _anchor() -> None:
    """Record ``ANCHORS`` tiny spans named ``trace.anchor.<n>`` in the
    ring and, where a profiler records this thread, in its trace."""
    if not (_on and _profiler_on()):
        return
    for _ in range(ANCHORS):
        with _Span(f"{ANCHOR}.{next(_anchors)}", {}):
            pass


def register_counters(group: str, read: Callable[[], dict]) -> None:
    """Counters kept elsewhere (a kernel module's launch count), read
    as ``counters()[group]``."""
    _groups[group] = read


def read_counters(group: str) -> dict:
    return _groups[group]()


def counters() -> dict:
    """Every counter: the program's, ``spans.dropped``, and each
    registered group."""
    with _lock:
        out: dict = dict(sorted(_counts.items()))
        out["spans.dropped"] = _dropped
    for g, read in _groups.items():
        out[g] = read()
    return out


def spans() -> List[dict]:
    """The ring's spans, oldest first: ``id``, ``name``, ``start_ns`` and
    ``end_ns`` (``time.perf_counter_ns``), ``thread`` (its native id),
    ``thread_name``, ``parent`` (the enclosing span's id on the same
    thread), ``request`` and any ``ids``."""
    with _lock:
        rows = list(_ring)
    return [{"id": i, "name": n, "start_ns": t0, "end_ns": t1, "thread": th,
             "thread_name": tn, "parent": p, "request": r, **ids}
            for i, n, t0, t1, th, tn, p, r, ids in rows]


def span_stats() -> Dict[str, dict]:
    """Per span name over the ring: count, total, p50 and p95 in ms."""
    by: Dict[str, list] = collections.defaultdict(list)
    with _lock:
        rows = list(_ring)
    for row in rows:
        if not row[1].startswith(ANCHOR):
            by[row[1]].append((row[3] - row[2]) / 1e6)
    out = {}
    for name, ms in sorted(by.items()):
        a = np.asarray(ms)
        out[name] = {"count": len(a), "total_ms": round(float(a.sum()), 3),
                     "p50_ms": round(float(np.percentile(a, 50)), 3),
                     "p95_ms": round(float(np.percentile(a, 95)), 3)}
    return out


def _offset_us(events: list, rows: Dict[str, dict]) -> Optional[dict]:
    """Trace µs minus ring µs, the median over the anchors found on
    both clocks (midpoint against midpoint)."""
    offs = []
    for e in events:
        r = rows.get(e.get("name"))
        if r is not None and e.get("ph") == "X":
            mid = (r["start_ns"] + r["end_ns"]) / 2e3
            offs.append(e["ts"] + e.get("dur", 0) / 2 - mid)
    if not offs:
        return None
    a = np.asarray(offs)
    return {"offset_us": float(np.median(a)), "anchors": len(a),
            "spread_us": float(a.max() - a.min())}


def _bracketing(own: tuple, mid: float, slack: float = 50.0):
    """The event of ``own`` (starts, events: sorted by start, of one name
    and thread, so none overlaps another) whose interval holds ``mid``
    µs, within ``slack``, and that no span has claimed yet."""
    starts, evs = own
    i = bisect.bisect_right(starts, mid + slack) - 1
    if i < 0:
        return None
    e = evs[i]
    if e["ts"] + e.get("dur", 0) + slack < mid or "span" in e.get("args", {}):
        return None
    return e


def export(trace_path: Optional[str] = None) -> dict:
    """The ring's spans, the counters and the dropped count.  With
    ``trace_path`` (a Chrome trace of ``torch.profiler``): each span of
    the trace's time range gains ``ts`` and ``dur`` in the trace's µs,
    placed through the anchors recorded in both, and is written into the
    trace as a ``user_annotation`` event on its own thread (a span the
    profiler recorded itself keeps its event, which gains the span's
    ``args``).  ``clock`` is None, and the trace untouched, where the
    trace holds no anchor."""
    rows = spans()
    out = {"spans": rows, "counters": counters(), "dropped": _dropped,
           "clock": None}
    if trace_path is None:
        return out
    with open(trace_path) as f:
        tr = json.load(f)
    events = tr.setdefault("traceEvents", [])
    clock = _offset_us(events, {r["name"]: r for r in rows
                                if r["name"].startswith(ANCHOR)})
    out["clock"] = clock
    if clock is None:
        return out
    off = clock["offset_us"]
    ts = [e["ts"] for e in events if "ts" in e and e.get("ph") == "X"]
    lo, hi = min(ts), max(e["ts"] + e.get("dur", 0) for e in events
                          if "ts" in e and e.get("ph") == "X")
    # the profiler's own copies of spans, by (name, thread), by start
    by: Dict[tuple, list] = collections.defaultdict(list)
    for e in events:
        if e.get("ph") == "X" and e.get("cat") == "user_annotation":
            by[(e["name"], e.get("tid"))].append(e)
    own = {}
    for k, evs in by.items():
        evs.sort(key=lambda e: e["ts"])
        own[k] = ([e["ts"] for e in evs], evs)
    pid = next((e.get("pid") for e in events if e.get("cat") == "cpu_op"),
               os.getpid())
    named = {e.get("tid") for e in events
             if e.get("ph") == "M" and e.get("name") == "thread_name"}
    kept = []
    for r in rows:
        t0, t1 = r["start_ns"] / 1e3 + off, r["end_ns"] / 1e3 + off
        if t1 < lo or t0 > hi:
            continue
        r["ts"], r["dur"] = t0, t1 - t0
        kept.append(r)
        args = {k: v for k, v in r.items()
                if k not in ("id", "name", "start_ns", "end_ns", "thread",
                             "thread_name", "ts", "dur")}
        args["span"] = r["id"]
        e = _bracketing(own.get((r["name"], r["thread"]), ([], [])),
                        (t0 + t1) / 2)
        if e is not None:
            e.setdefault("args", {}).update(args)
            continue
        events.append({"ph": "X", "cat": "user_annotation", "name": r["name"],
                       "pid": pid, "tid": r["thread"], "ts": t0,
                       "dur": t1 - t0, "args": args})
        if r["thread"] not in named:
            named.add(r["thread"])
            events.append({"ph": "M", "name": "thread_name", "pid": pid,
                           "tid": r["thread"],
                           "args": {"name": r["thread_name"]}})
    with open(trace_path, "w") as f:
        json.dump(tr, f)
    out["spans"] = kept
    return out


@contextlib.contextmanager
def profile_trace(log_dir: str, device="cpu"):
    """Trace host and (on a GPU) device activity while the block runs,
    with the program's spans on; the trace, spans merged, lands in
    ``<log_dir>/trace_<pid>.json``."""
    from torch.profiler import ProfilerActivity, profile
    device = torch.device(device)
    activities = [ProfilerActivity.CPU]
    if device.type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    was = _on
    with profile(activities=activities) as prof:
        set_tracing(True)
        try:
            yield prof
            if device.type == "cuda":
                torch.cuda.synchronize(device)
        finally:
            set_tracing(was)      # anchors again, the profiler still on
    path = os.path.join(log_dir, f"trace_{os.getpid()}.json")
    prof.export_chrome_trace(path)
    export(path)


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

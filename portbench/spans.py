"""Reading the program's spans in a capture's Chrome trace, once the
program has written them in (``vqvae_tpu_torch/utils/profiling.py::
export``): ``user_annotation`` events named ``train.*``, ``model.*``,
``data.*``, ``serve.*`` or ``stream.*``, each on the thread that ran it,
with ``args`` ``span``, ``parent``, ``request`` and any ids (``op``).

* ``idle_by_phase``: the device's idle time a step, each gap charged to
  the span that launched the kernel ending it.  The launch is the
  runtime call with the kernel's ``correlation``; its span is the
  innermost program span on the launching thread at the launch, or,
  where that thread has none (autograd's device thread outside a
  ``.bwd`` span), the innermost one of any thread.  A gap no kernel ends
  (the capture's tail) is ``rest``.
* ``span_kernel_s``: the device time of the kernels launched inside
  spans whose names start with a prefix.
* ``push_ms``: the daemon's host time a push, from its spans.

The drivers' captures do not turn the program's tracing on yet, so no
metric of ``BENCHMARK.json`` reads these (``PERF.md`` §7 names the
edits).
"""

from __future__ import annotations

import bisect
from collections import defaultdict
from typing import Dict, List, Optional

from portbench import trace

PREFIXES = ("train.", "model.", "data.", "serve.", "stream.")
UPDATE = ("train.zero_grad", "train.optimizer", "train.codebook")
PHASES = ("forward", "backward", "update", "rest")
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")


def program_spans(tr: dict) -> List[dict]:
    """The trace's program spans, by start."""
    return sorted((e for e in tr.get("traceEvents", [])
                   if e.get("ph") == "X" and e.get("cat") == "user_annotation"
                   and e.get("name", "").startswith(PREFIXES)),
                  key=lambda e: e["ts"])


def phase(name: Optional[str]) -> str:
    """The training phase a span belongs to, by its name: the backward's
    spans (``train.backward``, ``*.bwd``), the forward's
    (``train.forward``, ``model.*``), the update's (zero_grad, Adam, the
    codebook), else the rest (framing, the loader, ``train.step``
    between phases, no span)."""
    if name is None:
        return "rest"
    if name == "train.backward" or name.endswith(".bwd"):
        return "backward"
    if name == "train.forward" or name.startswith("model."):
        return "forward"
    if name in UPDATE:
        return "update"
    return "rest"


class Launchers:
    """The program span that launched each kernel."""

    def __init__(self, tr: dict):
        self.launch: Dict[int, dict] = {}
        for e in tr.get("traceEvents", []):
            corr = e.get("args", {}).get("correlation")
            if e.get("ph") == "X" and e.get("cat") in LAUNCH_CATS and \
                    corr is not None:
                self.launch[corr] = e
        self.spans = program_spans(tr)
        self.by_tid: Dict[object, List[dict]] = defaultdict(list)
        for s in self.spans:
            self.by_tid[s.get("tid")].append(s)

    @staticmethod
    def _innermost(spans: List[dict], ts: float) -> Optional[dict]:
        inside = [s for s in spans if s["ts"] <= ts < s["ts"] + s["dur"]]
        return min(inside, key=lambda s: s["dur"]) if inside else None

    def of(self, kernel: dict) -> Optional[dict]:
        """The innermost span around the kernel's launch: on the
        launching thread, else on any thread; None without a launch."""
        e = self.launch.get(kernel.get("args", {}).get("correlation"))
        if e is None:
            return None
        return (self._innermost(self.by_tid.get(e.get("tid"), []), e["ts"])
                or self._innermost(self.spans, e["ts"]))


def idle_by_phase(tr: dict, steps: int) -> dict:
    """Idle ms a step of the capture (``trace.CAPTURE``) by the phase of
    the span that launched the kernel ending each gap; ``idle`` is their
    sum, the capture's idle time, and ``by_span`` the same per span
    name (``no span`` where none)."""
    (lo, hi), = trace.spans(tr, trace.CAPTURE)
    ks = sorted(trace.kernels(tr, lo, hi), key=lambda k: k["ts"])
    starts = [k["ts"] for k in ks]
    who = Launchers(tr)
    out = dict.fromkeys(PHASES, 0.0)
    by_span: Dict[str, float] = defaultdict(float)
    for a, b in trace.gaps([(k["ts"], k["ts"] + k.get("dur", 0))
                            for k in ks], lo, hi):
        i = bisect.bisect_left(starts, b)
        s = who.of(ks[i]) if i < len(ks) and b < hi else None
        name = s["name"] if s else None
        ms = (b - a) / 1e3 / steps
        out[phase(name)] += ms
        by_span[name or "no span"] += ms
    out["idle"] = sum(out[p] for p in PHASES)
    out["by_span"] = dict(sorted(by_span.items(), key=lambda x: -x[1]))
    return out


def span_kernel_s(tr: dict, prefix) -> float:
    """Device seconds of the capture's kernels whose launching span
    (``Launchers.of``) is named ``prefix...`` (a string or a tuple of
    them)."""
    (lo, hi), = trace.spans(tr, trace.CAPTURE)
    who = Launchers(tr)
    total = 0.0
    for k in trace.kernels(tr, lo, hi):
        s = who.of(k)
        if s is not None and s["name"].startswith(prefix):
            total += k.get("dur", 0) / 1e6
    return total


def push_ms(tr: dict) -> dict:
    """Per ``stream_push`` request of the capture (its ``serve.handle``
    span's ``op``), means in ms: ``host`` = ``serve.handle`` less its
    ``stream.readback`` (the host's time under the lock outside the wait
    for the kernel), ``codec`` = ``serve.parse`` + ``stream.pcm_encode``
    + ``serve.respond`` (the daemon's JSON and PCM work); ``pushes``,
    how many."""
    (lo, hi), = trace.spans(tr, trace.CAPTURE)
    req: Dict[object, Dict[str, float]] = defaultdict(
        lambda: defaultdict(float))
    pushes = set()
    for s in program_spans(tr):
        if not lo <= s["ts"] < hi:
            continue
        args = s.get("args", {})
        rid = args.get("request")
        if rid is None:
            continue
        req[rid][s["name"]] += s["dur"] / 1e3
        if s["name"] == "serve.handle" and args.get("op") == "stream_push" \
                and s["ts"] + s["dur"] <= hi:
            pushes.add(rid)
    pushes = [r for r in pushes if "serve.respond" in req[r]]
    if not pushes:
        return {"pushes": 0, "host": None, "codec": None}
    n = len(pushes)
    host = sum(req[r]["serve.handle"] - req[r]["stream.readback"]
               for r in pushes) / n
    codec = sum(req[r]["serve.parse"] + req[r]["stream.pcm_encode"]
                + req[r]["serve.respond"] for r in pushes) / n
    return {"pushes": n, "host": host, "codec": codec}

"""Reading a ``torch.profiler`` Chrome trace: the device's kernels, the
layer each belongs to, the device's busy time, and the longest idle
gaps by what the host was doing.

A layer's kernels are known by the ``__global__`` functions its CUDA
source defines, read from the checkout at run time.  A kernel defined in
a shared header (``*.cuh``) belongs to the source whose kernel ran just
before it in launch order, provided that source includes the header:
the weight-gradient products of ``train_common.cuh`` follow the kernel
that needs them.  Work moved to a new file would go uncounted; spans
inside the program will replace this.
"""

from __future__ import annotations

import json
import re
from collections import defaultdict
from pathlib import Path
from typing import Dict, Iterable, List, Optional, Tuple

_GLOBAL = re.compile(
    r"__global__\s+(?:void\s+)?(?:__launch_bounds__\s*\([^)]*\)\s*)?"
    r"(?:void\s+)?([A-Za-z_]\w*)\s*[(<]")
_INCLUDE = re.compile(r'#include\s+"([^"]+)"')

CAPTURE = "portbench.capture"   # the span that bounds a capture


def base_name(kernel: str) -> str:
    """``void (anonymous namespace)::fwd_layer<2>(Args)`` ->
    ``fwd_layer``: no return type, namespaces, template or argument
    list."""
    s = kernel.replace("(anonymous namespace)::", "").strip()
    if s.startswith("void "):
        s = s[len("void "):]
    cuts = [i for i in (s.find("<"), s.find("(")) if i >= 0]
    return s[:min(cuts, default=len(s))].rsplit("::", 1)[-1].strip()


class Sources:
    """The ``__global__`` names of every file under a CUDA source
    directory, and which headers each ``.cu`` file includes."""

    def __init__(self, csrc: Path):
        self.defined: Dict[str, List[str]] = defaultdict(list)
        self.includes: Dict[str, set] = {}
        for f in sorted(csrc.iterdir()):
            if f.suffix not in (".cu", ".cuh"):
                continue
            text = f.read_text()
            for name in _GLOBAL.findall(text):
                self.defined[name].append(f.name)
            self.includes[f.name] = set(_INCLUDE.findall(text))

    def owners(self, kernels: List[dict]) -> List[Optional[str]]:
        """The source file of each kernel (in launch order), or None."""
        out, last = [], None
        for k in kernels:
            files = self.defined.get(base_name(k["name"]), [])
            own = [f for f in files if f.endswith(".cu")]
            if len(own) == 1:
                last = own[0]
                out.append(last)
            elif files and all(f.endswith(".cuh") for f in files) and \
                    last is not None and \
                    any(f in self.includes.get(last, ()) for f in files):
                out.append(last)
            else:
                out.append(None)
        return out


def load(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def spans(trace: dict, name: str) -> List[Tuple[float, float]]:
    """(start, end) in µs of every host span called ``name``."""
    return [(e["ts"], e["ts"] + e.get("dur", 0))
            for e in trace.get("traceEvents", [])
            if e.get("ph") == "X" and e.get("name") == name]


def kernels(trace: dict, lo: float = float("-inf"),
            hi: float = float("inf")) -> List[dict]:
    """The device's kernels that start inside ``[lo, hi)`` µs, in launch
    order (by correlation id)."""
    ks = [e for e in trace.get("traceEvents", [])
          if e.get("ph") == "X" and e.get("cat") == "kernel"
          and lo <= e["ts"] < hi]
    ks.sort(key=lambda e: (e.get("args", {}).get("correlation", 0), e["ts"]))
    return ks


def union_s(intervals: Iterable[Tuple[float, float]], lo: float,
            hi: float) -> float:
    """Seconds of ``[lo, hi)`` µs covered by the intervals."""
    total, end = 0.0, lo
    for a, b in sorted(intervals):
        a, b = max(a, end), min(b, hi)
        if b > a:
            total += b - a
            end = b
    return total / 1e6


def gaps(intervals: Iterable[Tuple[float, float]], lo: float,
         hi: float) -> List[Tuple[float, float]]:
    """The idle stretches of ``[lo, hi)`` µs between the intervals."""
    out, end = [], lo
    for a, b in sorted(intervals):
        if a > end:
            out.append((end, min(a, hi)))
        end = max(end, b)
        if end >= hi:
            break
    if end < hi:
        out.append((end, hi))
    return [(a, b) for a, b in out if b > a]


def host_ops(trace: dict) -> List[dict]:
    """Host events (operators, Python-side spans, runtime calls)."""
    return [e for e in trace.get("traceEvents", [])
            if e.get("ph") == "X" and e.get("cat") in
            ("cpu_op", "user_annotation", "cuda_runtime", "cuda_driver",
             "python_function")]


def breakdown(trace: dict, ks: List[dict], lo: float, hi: float,
              top: int = 10) -> dict:
    """The device operations that took most time, and the idle gaps
    summed by the innermost host event running at each gap's middle (on
    any thread), each list as [[name, seconds], ...]."""
    by_op: Dict[str, float] = defaultdict(float)
    for k in ks:
        by_op[base_name(k["name"])] += k.get("dur", 0) / 1e6
    host = sorted((e for e in host_ops(trace) if e.get("name") != CAPTURE),
                  key=lambda e: e["ts"])
    by_gap: Dict[str, float] = defaultdict(float)
    active: List[dict] = []
    i = 0
    for a, b in gaps([(k["ts"], k["ts"] + k.get("dur", 0)) for k in ks],
                     lo, hi):
        mid = (a + b) / 2
        while i < len(host) and host[i]["ts"] <= mid:
            active.append(host[i])
            i += 1
        active = [e for e in active if e["ts"] + e.get("dur", 0) > mid]
        name = (min(active, key=lambda e: e.get("dur", 0))["name"]
                if active else "no host event")
        by_gap[name] += (b - a) / 1e6

    def best(d):
        return [[n, s] for n, s in sorted(d.items(), key=lambda x: -x[1])
                [:top]]
    return {"device_ops": best(by_op), "idle_gaps": best(by_gap)}

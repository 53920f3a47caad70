"""Where a training step's time goes: the card's kernel time by phase,
and the card's idle gaps by what the host was doing across them (port
of ``scripts/train_step_profile.py``).

Profiles N steps of one training step in this process, on the batch
function of ``measure/train_roofline.py``, twice under ``torch.profiler``:
once without Python stacks, which gives every time, and once with them
(``with_stack=True``), which gives the labels; each capture is written
as a Chrome trace and read back.  ``--trace STACKED [PLAIN]`` reads
existing traces instead (the counterpart of JAX's ``--hlo-stats``); a
trace without this tool's window annotation is read over the span of
its events.

Device phases (JAX's names): every kernel, copy and fill on the card is
attributed through its launch: the runtime event with the same
``correlation`` id, then the innermost frame of a port module that
encloses the launch on the launching thread, mapped by module and
function (``PHASE_BY_SOURCE``).  A launch inside an autograd node with
no port frame (a plain op's backward) is followed to the forward op
that made the node (the trace's ``fwdbwd`` flow) and attributed there.
The hand kernels are called through ctypes (``kernels/build.py``), not
through ATen, so no ATen op names them: a kernel whose name is a
``__global__`` function of ``csrc/`` is a hand kernel, the chunk
kernels split into ``fwd_kernel`` and ``bwd_kernel`` by the wrapper
that launched them (by kernel name where no launch was recorded), and
the ATen work around them in ``kernels/wavenet_train_cuda.py`` is
``kernel_glue``.  ``models/vqvae.py::forward``'s own ops (the loss
sums, the code usage, and the plain head's cross-entropy, which JAX
counted in ``head_ce``) are ``loss``.  Kernels that overlap in time share the overlap, so
the phases sum to the busy time, the union of the kernels' intervals.

Idle gaps: every interval of the timed window the card spends with no
kernel, longer than ``--gap-us``, goes to what the host's main thread
was doing across it (the autograd thread while the main thread waits in
``backward``): a CUDA runtime call (``sync``, ``alloc`` or ``launch``),
torch.optim's step (``optimizer``), else the innermost port frame: a
kernel wrapper's launch (``launch``), ``audio/`` (``data``), the
training log (``log``), this harness (``harness``), or the module whose
ops the host was dispatching (``dispatch:<phase>``); else the ATen op;
else ``host_other``.  Shorter gaps sum into ``short_gaps``.  Phases plus
idle buckets equal the window.

The Python tracer stretches the host's time, so the stacked capture's
gaps are longer than the step's.  The sizes therefore come from the
capture without stacks: its window, its kernels (each labelled with the
phase of the same kernel of the stacked capture, which must run the same
kernels in the same order: ``kernels_matched``), its gaps, and the
buckets it sees by itself (runtime calls and the optimizer's
annotation).  The rest of each of its gaps, Python and ATen dispatch,
is split over the labels in proportion to the stacked capture's split of
the same gap (the gap before the same kernel), or, where that gap is all
runtime calls, over the work that made them; ``borrowed_idle_ms_per_
step`` says how much.  ``kernels_by_name`` counts the kernels that no
launch in a port frame named, only their name; ``stacked_*`` are the
stacked capture's window and busy time.  Both captures pay the
profiler's host cost (CUPTI's callback on every launch most), which
stays in the idle buckets, so ``profiled_wall_ms_per_step`` is longer
than ``wall_ms_per_step``, timed with the profiler off, by an amount
that varies between runs: compare buckets within one run.  A process's
first profiler sessions cost more, so one step is captured and dropped
first, and the capture without stacks comes last.  A capture holds the
kernels launched inside its window, matched in launch order.  Where the
two captures of a pair ran different kernels, the pair is taken again
(at most ``PAIRS``); ``pairs_missed`` says where each pair so dropped
parted (``kernels_mismatch``).

On ``--device cpu`` nothing runs on a card: the main thread is the
device, each instant of its window goes to the phase of its innermost
frame (ATen ops by their self time, the Python between them by its
frame), ``idle_by_host`` is empty, and only the stacked capture is
taken.

    python -m vqvae_tpu_torch.measure.train_step_profile [--batch 64]
        [--decoder-kernel pallas_sg] [--steps 10] [--out DIR]
    python -m vqvae_tpu_torch.measure.train_step_profile --trace \\
        STACKED.json [PLAIN.json] --steps N

Prints one JSON line, then the phase table and the idle table.
"""

from __future__ import annotations

import argparse
import bisect
import json
import os
import re
from functools import lru_cache
from pathlib import Path

import torch

from vqvae_tpu_torch.cli.common import resolve_device
from vqvae_tpu_torch.measure import _common as mc

WINDOW = "measure::window"
PAIRS = 3       # capture pairs taken at most, until both run one sequence
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
RUNTIME_CATS = ("cuda_runtime", "cuda_driver")
HOST_CATS = ("cpu_op", "python_function", "user_annotation") + RUNTIME_CATS

# (module under vqvae_tpu_torch/, function or None for any) -> phase, or
# None for a frame that says nothing and is passed through to its
# caller; first match wins, the innermost frame first
PHASE_BY_SOURCE = [
    ("kernels/head_ce_cuda.py", None, "head_ce"),
    ("models/wavenet.py", "_head", "head_ce"),
    # the loss, the plain head's CE (JAX's head_ce) and the code usage
    ("models/vqvae.py", "forward", "loss"),
    ("ops/conv.py", "upsample_apply", "upsampler"),
    ("models/wavenet.py", "upsample_cond", "upsampler"),
    ("kernels/upsample_cuda.py", None, "upsampler"),
    ("ops/conv.py", "matmul", None),                  # shared helpers
    ("ops/conv.py", "shift_right", None),
    ("ops/embed.py", None, "input_embed"),
    ("kernels/embed_cuda.py", None, "input_embed"),
    ("models/wavenet.py", "embed_inputs", "input_embed"),
    ("models/wavenet.py", "global_cond", "input_embed"),  # speaker path
    # the plain layer loop (decoder_kernel="xla"), which JAX left in other
    ("models/wavenet.py", "layer", "plain_stack"),
    ("models/wavenet.py", "decoder_skips", "kernel_glue"),
    ("ops/conv.py", None, "encoder"),                 # strided convs
    ("models/encoder.py", None, "encoder"),
    ("kernels/encoder_cuda.py", None, "encoder"),
    ("models/vq.py", None, "vq"),
    ("kernels/vq_cuda.py", None, "vq"),
    ("parallel/sp_decoder.py", None, "plain_stack"),
    ("parallel/sharded_conv.py", None, "plain_stack"),
    ("train/step.py", None, "adam_ema"),
    ("audio/framing.py", None, "framing"),
    ("audio/mu_law.py", None, "framing"),
]

# the port's custom autograd Functions: their backward node's name ->
# the frame it stands for, where the trace holds no Python frame there
CUSTOM_NODES = {
    "ChunkBackward": ("kernels/wavenet_train_cuda.py", "backward"),
    "_HeadCEBackward": ("kernels/head_ce_cuda.py", "backward"),
    "EncoderStackBackward": ("kernels/encoder_cuda.py", "backward"),
    "CondUpsampleBackward": ("kernels/upsample_cuda.py", "backward"),
    "_TakeRowsBackward": ("ops/embed.py", "backward"),
    "_HaloShiftBackward": ("parallel/sharded_conv.py", "backward"),
    "_TapConvBackward": ("models/wavenet_ae.py", "backward"),
    "GatedStackBackward": ("kernels/wavenet_ae_cuda.py", "backward"),
}

# hand kernels by source, where no launch was recorded
KERNEL_PHASE = {"head_ce.cu": "head_ce", "encoder.cu": "encoder",
                "vq.cu": "vq", "embed.cu": "input_embed",
                "upsample.cu": "upsampler", "decode.cu": "decode",
                "decode_chain.cu": "decode"}
CHUNK_FWD = {"fwd_layer", "skip_sum", "skip_sum_tc", "embed_fwd"}
# the chunk wrapper: its hand kernels are fwd_kernel / bwd_kernel by the
# function that launched them, its plain versions (*_plain, on the CPU)
# the same by name, the ATen work of these functions kernel_glue, and
# its other helpers pass to their caller
CHUNK_MODULE = "kernels/wavenet_train_cuda.py"
CHUNK_GLUE = {"decoder_stack", "chunk", "chunk_forward", "chunk_backward",
              "forward", "backward", "fwd_kernel", "bwd_kernel",
              "bwd_rec_kernel", "bwd_win_kernel", "atb_kernel"}

# host buckets of port frames (module prefix -> bucket)
HOST_BY_SOURCE = [("audio/", "data"), ("train/loop.py", "data"),
                  ("train/metrics.py", "log"),
                  ("utils/profiling.py", "log"),
                  ("train/checkpoint.py", "checkpoint"),
                  ("measure/", "harness")]
HOST_BUCKETS = ("data", "optimizer", "launch", "sync", "log")
# host buckets a capture without Python stacks measures by itself
MEASURED = ("sync", "alloc", "launch", "optimizer")
OPTIMIZER = "Optimizer."         # torch.optim's record_function names
SYNC_RE = re.compile(r"Synchroniz|StreamWait|EventQuery|^cudaMemcpy$")
ALLOC_RE = re.compile(r"Malloc|Free|HostAlloc|HostRegister")
FRAME_RE = re.compile(r"vqvae_tpu_torch/([\w/]+\.py)\(\d+\): (.+)$")
NODE_RE = re.compile(r"Backward\d*$|^autograd::engine::evaluate_function: ")
BACKWARD_WAIT_RE = re.compile(r"run_backward")

CSRC = Path(__file__).resolve().parent.parent / "csrc"


@lru_cache(maxsize=None)
def hand_kernels() -> dict:
    """{name: source file} of every ``__global__`` function in ``csrc/``."""
    pat = re.compile(r"__global__\s+void\s+(?:__launch_bounds__\([^)]*\)\s*)?"
                     r"(\w+)\s*\(")
    out = {}
    for src in sorted(CSRC.glob("*.cu*")):
        for name in pat.findall(src.read_text()):
            out[name] = src.name
    return out


def kernel_base(name: str) -> str:
    """``void (anonymous namespace)::fwd_layer<bf16, 2>(int, ...)`` ->
    ``fwd_layer``; a kernel of PyTorch's own namespaces keeps them
    (``at::native::...``), so that it never passes for a hand kernel."""
    n = re.sub(r"^void\s+", "", name.replace("(anonymous namespace)::", ""))
    m = re.match(r"[\w:]+", n)
    if m is None:
        return name
    base = m.group(0)
    return base if base.startswith(("at::", "c10::")) else \
        base.rsplit("::", 1)[-1]


def port_frame(name: str):
    """A Python frame's (module under vqvae_tpu_torch/, function), or
    None for a frame outside the port."""
    m = FRAME_RE.search(name)
    return (m.group(1), m.group(2)) if m else None


def frame_phase(loc, base: str | None):
    """The phase of port frame ``loc`` for kernel ``base`` (None: not a
    kernel, or not a hand kernel); None passes to the caller."""
    path, func = loc
    if path == CHUNK_MODULE:
        if base in hand_kernels():
            bwd = "bwd" in func or "backward" in func or func.startswith("atb")
            return "bwd_kernel" if bwd else "fwd_kernel"
        if func.endswith("_plain"):
            return "fwd_kernel" if func.startswith("fwd") else "bwd_kernel"
        return "kernel_glue" if func in CHUNK_GLUE else None
    for p, f, phase in PHASE_BY_SOURCE:
        if path == p and (f is None or f == func):
            return phase
    return None


class Ev:
    """One host event: kind 'py', 'op', 'rt' or 'ann'."""
    __slots__ = ("kind", "name", "tid", "ts", "end", "args", "parent")

    def __init__(self, e):
        cat = e.get("cat")
        self.kind = {"python_function": "py", "cpu_op": "op",
                     "user_annotation": "ann"}.get(cat, "rt")
        self.name, self.tid, self.args = e["name"], e["tid"], e.get("args", {})
        self.ts, self.end = float(e["ts"]), float(e["ts"]) + float(e["dur"])
        self.parent = None


class Thread:
    """A host thread's events as a nesting forest, with the innermost
    event of every instant (``segments``)."""

    def __init__(self, events):
        events.sort(key=lambda e: (e.ts, -e.end))
        self.segments = []           # (start, end, event), in order
        stack, cursor = [], None

        def emit(upto):
            if stack and upto > cursor:
                self.segments.append((cursor, upto, stack[-1]))

        for e in events:
            while stack and stack[-1].end <= e.ts:
                emit(stack[-1].end)
                cursor = stack.pop().end
            if stack:
                e.end = min(e.end, stack[-1].end)   # clip a ragged child
                emit(e.ts)
                e.parent = stack[-1]
            stack.append(e)
            cursor = e.ts
        while stack:
            emit(stack[-1].end)
            cursor = stack.pop().end
        self.starts = [s[0] for s in self.segments]

    def pieces(self, a: float, b: float):
        """(start, end, innermost event or None) covering [a, b)."""
        i = max(0, bisect.bisect_right(self.starts, a) - 1)
        t = a
        while t < b and i < len(self.segments):
            s, e, ev = self.segments[i]
            if e <= t:
                i += 1
                continue
            if s > t:
                yield t, min(s, b), None
                t = min(s, b)
                continue
            yield t, min(e, b), ev
            t = min(e, b)
            i += 1
        if t < b:
            yield t, b, None

    def at(self, t: float):
        """The innermost event at time t, or None."""
        i = bisect.bisect_right(self.starts, t) - 1
        if i >= 0 and self.segments[i][1] > t:
            return self.segments[i][2]
        return None


def chain(ev):
    """ev and its enclosing events, innermost first."""
    while ev is not None:
        yield ev
        ev = ev.parent


class Trace:
    """A Chrome trace of ``torch.profiler``, indexed for attribution."""

    def __init__(self, events: list):
        host, device, flows = {}, [], {}
        self.opt = {}                # tid -> [(start, end)] of the optimizer
        for e in events:
            ph, cat = e.get("ph"), e.get("cat")
            if ph == "X" and cat in DEVICE_CATS:
                device.append(e)
            elif ph == "X" and cat in HOST_CATS:
                host.setdefault(e["tid"], []).append(Ev(e))
            elif ph in ("s", "f") and cat == "fwdbwd":
                flows.setdefault(e["id"], {})[ph] = (e["tid"], float(e["ts"]))
        self.device = sorted(device, key=lambda k: float(k["ts"]))
        self.launch, self.window = {}, None
        for evs in host.values():
            for ev in evs:
                if ev.kind == "rt" and "correlation" in ev.args:
                    self.launch[ev.args["correlation"]] = ev
                elif ev.kind == "ann" and ev.name == WINDOW:
                    self.window = ev
                elif ev.kind == "ann" and ev.name.startswith(OPTIMIZER):
                    self.opt.setdefault(ev.tid, []).append((ev.ts, ev.end))
        for spans in self.opt.values():
            spans.sort()
        # annotations open and close inside Python frames of the
        # profiler's own, so they do not nest: they stay out of the forest
        self.threads = {tid: Thread([e for e in evs if e.kind != "ann"])
                        for tid, evs in host.items()}
        # backward node (its thread, sequence number) -> where the
        # forward op that made it started (thread, time)
        self.fwd_of = {}
        for fl in flows.values():
            if "s" not in fl or "f" not in fl:
                continue
            tid, ts = fl["f"]
            node = next((e for e in chain(self.at(tid, ts))
                         if e.kind == "op" and NODE_RE.search(e.name)), None)
            seq = node.args.get("Sequence number") if node else None
            if seq is not None:
                self.fwd_of[(node.tid, seq)] = fl["s"]
        if self.window is not None:
            self.main = self.window.tid
        else:
            self.main = max(self.threads, key=lambda t: sum(
                e.kind == "py" for _, _, e in self.threads[t].segments))

    def span(self):
        """The window: the annotation's, else the device events', else
        the main thread's."""
        if self.window is not None:
            return self.window.ts, self.window.end
        if self.device:
            return (float(self.device[0]["ts"]),
                    max(float(k["ts"]) + float(k["dur"])
                        for k in self.device))
        segs = self.threads[self.main].segments
        return segs[0][0], segs[-1][1]

    def intervals(self, a: float, b: float):
        """(a', b', [(start, end, i)]): the device events launched inside
        [a, b) (by their runtime call, or by their own time where no
        launch was recorded), in the order they start, with the window
        widened to hold them: the card's clock is mapped onto the host's
        only to some tens of microseconds.  i indexes ``self.device``."""
        out = []
        for i, k in enumerate(self.device):
            s = float(k["ts"])
            e = s + float(k["dur"])
            rt = self.launch.get(k.get("args", {}).get("correlation"))
            if (a <= rt.ts < b) if rt is not None else (e > a and s < b):
                out.append((s, e, i))
        if not out:
            return a, b, out
        a = min(a, out[0][0])
        b = max(b, max(e for _, e, _ in out))
        return a, b, [(max(s, a), min(e, b), i) for s, e, i in out]

    def launch_order(self, ivs) -> list:
        """The device indices of ``ivs`` in the order they were launched
        (correlation id; by start where no launch was recorded)."""
        def key(iv):
            c = self.device[iv[2]].get("args", {}).get("correlation")
            return (0, c, 0.0) if c in self.launch else (1, 0, iv[0])
        return [i for _, _, i in sorted(ivs, key=key)]

    def at(self, tid, t: float):
        """The innermost event of thread ``tid`` at time t, or None."""
        return self.threads[tid].at(t) if tid in self.threads else None

    def forward_stack(self, node):
        """The forward op that made autograd node ``node``, or None."""
        key = (node.tid, node.args.get("Sequence number"))
        return self.at(*self.fwd_of[key]) if key in self.fwd_of else None

    def phase(self, ev, base=None, depth=0):
        """Phase of the work done at host event ``ev`` (innermost first
        through its enclosing events); None if nothing says."""
        for e in chain(ev):
            if e.kind == "py":
                loc = port_frame(e.name)
                ph = frame_phase(loc, base) if loc else None
                if ph:
                    return ph
            elif e.kind == "op" and NODE_RE.search(e.name):
                if depth < 4:
                    fwd = self.forward_stack(e)
                    if fwd is not None:
                        ph = self.phase(fwd, base, depth + 1)
                        if ph:
                            return ph
                node = e.name.rsplit(": ", 1)[-1]
                if node in CUSTOM_NODES:
                    return frame_phase(CUSTOM_NODES[node], base)
                if "AccumulateGrad" in node:
                    return "adam_ema"   # gradients handed to the optimizer
        return None

    def kernel_phase(self, k):
        """(phase of device event k, whether only its name said so: no
        launch, or no port frame around its launch)."""
        base = kernel_base(k["name"])
        if base not in hand_kernels():
            base = None
        rt = self.launch.get(k.get("args", {}).get("correlation"))
        ph = self.phase(rt, base) if rt is not None else None
        if ph:
            return ph, False
        if base is not None:
            src = hand_kernels()[base]
            if src in KERNEL_PHASE:
                return KERNEL_PHASE[src], True
            return ("fwd_kernel" if base in CHUNK_FWD else "bwd_kernel"), True
        return "other", False

    def host_bucket(self, ev, runtime: bool = True):
        """(what the host was doing at event ``ev``, innermost first;
        whether a capture without Python stacks sees it: a runtime call
        or the optimizer).  ``runtime=False`` looks through a runtime
        call to the work that made it."""
        aten = None
        for e in chain(ev):
            if e.kind == "rt" and not runtime:
                continue
            if e.kind == "rt":
                return ("sync" if SYNC_RE.search(e.name) else
                        "alloc" if ALLOC_RE.search(e.name) else
                        "launch"), True
            if e.kind == "py":
                if "torch/optim/" in e.name:
                    return "optimizer", True
                loc = port_frame(e.name)
                if loc is None:
                    continue
                path, func = loc
                if path.startswith("kernels/"):
                    if func.endswith(("_kernel", "_call")):
                        return "launch", False
                    if func.startswith("_"):
                        continue
                for prefix, bucket in HOST_BY_SOURCE:
                    if path.startswith(prefix):
                        return bucket, False
                ph = frame_phase(loc, None)
                if ph:
                    return "dispatch:" + ph, False
            elif e.kind == "op":
                if NODE_RE.search(e.name):
                    ph = self.phase(e)
                    if ph:
                        return "dispatch:" + ph, False
                aten = aten or e.name
        return aten or "host_other", False

    def _classify(self, tid, s, e, ev, empty):
        """(duration, bucket, measured, context) of [s, e) on thread
        ``tid`` at event ``ev`` (``empty`` where there is none); time
        inside the optimizer's annotation and outside a runtime call is
        ``optimizer``; ``context`` is the bucket of the work that made a
        runtime call (else the bucket)."""
        bucket, measured = (self.host_bucket(ev) if ev is not None
                            else (empty, False))
        if measured and bucket != "optimizer":
            yield e - s, bucket, True, self.host_bucket(ev, False)[0]
            return
        t = s
        for x, y in self.opt.get(tid, ()):
            x, y = max(x, t), min(y, e)
            if y <= x:
                continue
            if x > t:
                yield x - t, bucket, measured, bucket
            yield y - x, "optimizer", True, "optimizer"
            t = y
        if e > t:
            yield e - t, bucket, measured, bucket

    def host_pieces(self, a: float, b: float):
        """(duration, bucket, measured, context) of [a, b) by what the
        main thread did, or, where it waits in ``backward`` or shows no
        event, the other thread busiest there (the autograd thread)."""
        for s, e, ev in self.threads[self.main].pieces(a, b):
            waits = ev is not None and BACKWARD_WAIT_RE.search(ev.name)
            if ev is not None and not waits:
                yield from self._classify(self.main, s, e, ev, None)
                continue
            busy, worker = max(((sum(y - x for x, y, w in t.pieces(s, e)
                                     if w is not None), tid)
                                for tid, t in self.threads.items()
                                if tid != self.main), default=(0.0, None))
            empty = "autograd" if waits else "host_other"
            if not busy:
                yield from self._classify(self.main, s, e, None, empty)
                continue
            for s2, e2, ev2 in self.threads[worker].pieces(s, e):
                yield from self._classify(worker, s2, e2, ev2, empty)


def load_trace(path: str) -> list:
    with open(path) as f:
        d = json.load(f)
    return d["traceEvents"] if isinstance(d, dict) else d


def _union_split(intervals):
    """Sweep [(start, end, key)]: (busy length, {key: share}), where an
    instant covered by k intervals gives each 1/k of it."""
    pts = sorted([(s, 1, i) for i, (s, e, _) in enumerate(intervals)] +
                 [(e, -1, i) for i, (s, e, _) in enumerate(intervals)])
    active, share, busy, last = set(), {}, 0.0, None
    for t, kind, i in pts:
        if active and t > last:
            dt = t - last
            busy += dt
            for j in active:
                key = intervals[j][2]
                share[key] = share.get(key, 0.0) + dt / len(active)
        last = t
        (active.add if kind == 1 else active.discard)(i)
    return busy, share


def _gaps(intervals, a, b):
    """{i: (start, end)} of the uncovered sub-intervals of [a, b), ``i``
    the device index of the event that ends the gap (``intervals`` are
    in start order), None for the gap that ends the window."""
    out, t = {}, a
    for s, e, i in intervals:
        if s > t:
            out[i] = (t, s)
        t = max(t, e)
    if t < b:
        out[None] = (t, b)
    return out


def _first_mismatch(plain: list, stacked: list) -> dict:
    """Where two captures' kernel sequences part: the counts, the first
    position that differs and the names from there on (a few)."""
    n = next((i for i, (p, s) in enumerate(zip(plain, stacked)) if p != s),
             min(len(plain), len(stacked)))
    return {"plain_n": len(plain), "stacked_n": len(stacked), "at": n,
            "plain": [k[:160] for k in plain[n:n + 3]],
            "stacked": [k[:160] for k in stacked[n:n + 3]]}


def _add(d: dict, key, v: float) -> None:
    d[key] = d.get(key, 0.0) + v


def _table(d: dict, steps: int, total: float) -> dict:
    return {k: {"ms_per_step": v / steps / 1e3,
                "pct": 100.0 * v / total if total else 0.0}
            for k, v in sorted(d.items(), key=lambda kv: -kv[1])}


def decompose(events: list, steps: int, gap_us: float = 20.0,
              plain: list | None = None) -> dict:
    """The JSON record of a trace (see the module docstring); times in
    the trace are microseconds.  ``plain``: the same steps captured
    without Python stacks, which then gives every time and the runtime
    and optimizer buckets, ``events`` the labels."""
    lab = Trace(events)
    siz = lab if plain is None else Trace(plain)
    a, b, ivs = siz.intervals(*siz.span())
    window = b - a
    phases, idle, top = {}, {}, {}
    lab_a, lab_b, lab_ivs = lab.intervals(*lab.span())
    siz_order, lab_order = siz.launch_order(ivs), lab.launch_order(lab_ivs)
    siz_names = [siz.device[i]["name"] for i in siz_order]
    lab_names = [lab.device[i]["name"] for i in lab_order]
    matched = siz_names == lab_names
    # a kernel of the sizing capture -> the same launch of the stacked one
    pair = dict(zip(siz_order, lab_order)) if matched else {}
    by_name, borrowed = 0, 0.0
    if ivs:
        labels = []
        for s, e, i in ivs:
            k = siz.device[i]
            ph, named = (lab.kernel_phase(lab.device[pair[i]])
                         if matched else siz.kernel_phase(k))
            by_name += named
            labels.append((s, e, ph))
            top.setdefault(k["name"], [0.0, 0])
            top[k["name"]][0] += e - s
            top[k["name"]][1] += 1
        busy, phases = _union_split(labels)
        lab_gaps = _gaps(lab_ivs, lab_a, lab_b) if matched else {}
        for n, (g0, g1) in _gaps(ivs, a, b).items():
            n = None if n is None else pair.get(n, "unmatched")
            if g1 - g0 <= gap_us:
                _add(idle, "short_gaps", g1 - g0)
                continue
            rest, own = 0.0, {}
            for dt, bucket, measured, _ in siz.host_pieces(g0, g1):
                if measured:
                    _add(idle, bucket, dt)
                else:
                    rest += dt
                    _add(own, bucket, dt)
            lent = {}            # the stacked capture's labels here
            if siz is not lab and n in lab_gaps:
                pieces = list(lab.host_pieces(*lab_gaps[n]))
                for dt, bucket, measured, _ in pieces:
                    if not measured:
                        _add(lent, bucket, dt)
                if not lent:        # the stacked gap is all runtime calls
                    for dt, _, _, context in pieces:
                        _add(lent, context, dt)
            total = sum(lent.values())
            if total > 0:
                borrowed += rest
                for bucket, v in lent.items():
                    _add(idle, bucket, rest * v / total)
            else:
                for bucket, v in own.items():
                    _add(idle, bucket, v)
        for bucket in HOST_BUCKETS:
            idle.setdefault(bucket, 0.0)
    else:
        busy = window
        for s, e, ev in siz.threads[siz.main].pieces(a, b):
            ph = (siz.phase(ev) if ev is not None else None) or "other"
            _add(phases, ph, e - s)
            if ev is not None and ev.kind == "op":
                top.setdefault(ev.name, [0.0, 0])
                top[ev.name][0] += e - s
                top[ev.name][1] += 1
    lab_busy = _union_split(lab_ivs)[0] if lab_ivs else lab_b - lab_a
    kernels = phases.get("fwd_kernel", 0.0) + phases.get("bwd_kernel", 0.0)
    accounted = sum(phases.values()) + sum(idle.values())
    return {
        "steps": steps,
        "device_busy_ms_per_step": busy / steps / 1e3,
        "profiled_wall_ms_per_step": window / steps / 1e3,
        "busy_share": busy / window if window else 0.0,
        "kernel_share_pct": 100.0 * kernels / busy if busy else 0.0,
        "accounted_pct": 100.0 * accounted / window if window else 0.0,
        "phases": _table(phases, steps, busy),
        "idle_by_host": _table(idle, steps, window - busy),
        "top_kernels": [
            {"name": n, "ms_per_step": v[0] / steps / 1e3, "count": v[1]}
            for n, v in sorted(top.items(), key=lambda kv: -kv[1][0])[:10]],
        "stacked_wall_ms_per_step": (lab_b - lab_a) / steps / 1e3,
        "stacked_busy_ms_per_step": lab_busy / steps / 1e3,
        "kernels_matched": matched,
        "kernels_mismatch": (None if matched else
                             _first_mismatch(siz_names, lab_names)),
        "kernels_by_name": by_name,
        "borrowed_idle_ms_per_step": borrowed / steps / 1e3,
    }


def capture(step, steps: int, dev: torch.device, out_dir: str | None,
            stack: bool = True) -> str | None:
    """Run ``steps`` calls of ``step`` under the profiler (Python stacks
    if ``stack``; the card's activity on a GPU) inside the window
    annotation, and write the Chrome trace under ``out_dir``; returns
    its path (None, and nothing written, without ``out_dir``)."""
    from torch.profiler import ProfilerActivity, profile, record_function
    acts = [ProfilerActivity.CPU]
    if dev.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    mc.sync(dev)
    with profile(activities=acts, with_stack=stack) as prof:
        with record_function(WINDOW):
            for _ in range(steps):
                step()
            mc.sync(dev)
    if out_dir is None:
        return None
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, f"trace_{os.getpid()}_"
                                 f"{'stack' if stack else 'plain'}.json")
    prof.export_chrome_trace(path)
    return path


def profile_batch(cfg, B: int, steps: int, dev, out_dir: str,
                  gap_us: float) -> dict:
    """Warm-up, ``steps`` timed with the profiler off, ``steps`` profiled
    with Python stacks and, on a card, ``steps`` without them: the JSON
    record.  On a card one step under a profiler whose trace is dropped
    comes first, and the capture that sizes the buckets last: a
    process's first profiler sessions run its steps slower."""
    from vqvae_tpu_torch.measure.train_roofline import WARMUP, batch_step
    state, step = batch_step(cfg, B, dev)
    for _ in range(WARMUP):
        step()
    wall = mc.wall_ms(step, steps, dev)
    if dev.type == "cuda":
        capture(step, 1, dev, None, stack=False)
    missed = []
    for _ in range(PAIRS):
        stacked = load_trace(capture(step, steps, dev, out_dir))
        plain = (load_trace(capture(step, steps, dev, out_dir, stack=False))
                 if dev.type == "cuda" else None)
        rec = decompose(stacked, steps, gap_us, plain)
        if rec["kernels_matched"]:
            break
        missed.append(rec["kernels_mismatch"])
    del state
    return {"preset": cfg.name, "batch": B,
            "decoder_kernel": cfg.model.decoder_kernel,
            "head_kernel": cfg.model.head_kernel,
            "encoder_kernel": cfg.model.encoder_kernel,
            "embed_in_kernel": cfg.model.embed_in_kernel,
            "wall_ms_per_step": wall, **rec, "pairs_missed": missed}


def print_tables(rec: dict) -> None:
    print("\n| phase | ms/step | % of device time |")
    print("|---|---|---|")
    for k, v in rec["phases"].items():
        print(f"| {k} | {v['ms_per_step']:.3f} | {v['pct']:.1f} |")
    if rec["idle_by_host"]:
        print("\n| host during the card's idle gaps | ms/step | % of idle |")
        print("|---|---|---|")
        for k, v in rec["idle_by_host"].items():
            print(f"| {k} | {v['ms_per_step']:.3f} | {v['pct']:.1f} |")


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--batch", type=int, default=64)
    mc.add_train_args(ap, decoder_kernel="pallas_sg")
    ap.add_argument("--steps", type=int, default=10)
    ap.add_argument("--gap-us", type=float, default=20.0,
                    help="idle gaps longer than this go to the host's "
                         "buckets (default 20)")
    ap.add_argument("--out", default=os.path.join("build", "measure",
                                                  "train_step_profile"))
    ap.add_argument("--trace", nargs="+", metavar="PATH",
                    help="skip capture; aggregate this Chrome trace (and "
                         "a second one of the same steps without Python "
                         "stacks) over --steps steps")
    args = ap.parse_args(argv)
    if args.trace:
        if len(args.trace) > 2:
            ap.error("--trace takes one or two paths")
        plain = load_trace(args.trace[1]) if len(args.trace) > 1 else None
        rec = decompose(load_trace(args.trace[0]), args.steps, args.gap_us,
                        plain)
        rec = {"trace": args.trace, "wall_ms_per_step": None, **rec,
               "device": None, "power_limit_w": None}
        print(json.dumps(rec), flush=True)
    else:
        dev = resolve_device(args.device)
        rec = mc.emit(profile_batch(mc.train_config(args), args.batch,
                                    args.steps, dev, args.out, args.gap_us),
                      dev)
    print_tables(rec)
    return rec


if __name__ == "__main__":
    main()

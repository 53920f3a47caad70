"""Sustained session throughput against push width (port of
``scripts/session_sweep.py``): a live stream must keep up push by push,
not only request by request.

``vctk-multi`` at seeded weights, greedy, through
``infer/kernel_stream.py::KernelStreamSession.push`` (the daemon's
``kernel`` engine), or with ``--socket`` through a daemon session
(``client.open_stream``).  The width ``w`` is the client's push width:
the code frames one push carries, all of which one resumable decode
kernel call turns into ``w * hop`` samples (``hop // 2`` fewer on the
first push).  The JAX script's width was the Pallas engine's kernel
slice (``--kernel-frames``), which cut and padded every push; the port's
kernel takes any width, so no kernel knob is swept here.

For each width: time to first audio (pushes of ``w`` frames until one
returns audio), the p50 of 24 steady pushes, the audio a push carries
and the sustained factor (audio per push over push p50; below 1 a live
stream stutters).  ``--decompose W`` splits a steady push of W frames with marks taken
inside the session's own ``push`` (its upsampler and decode calls are
wrapped on that one session): ``upload`` (from the push's start to the
upsampler: the ids checked and sent to the device; the condition is
built there, from the per-code table, so no condition is uploaded),
``upsampler`` (the table gather and overlap-add), ``kernel`` (the
decode kernel and the mu-law decode) and ``readback`` (the rest of the
push: the waveform to the host), by CUDA events on the card.  The parts
tile the push, so their sum is a push's time with the marks on; the
chip smoke holds it to the same width's push p50, taken without them.

    python -m vqvae_tpu_torch.measure.session_sweep [--widths 16 32 48 64]
        [--decompose 16] [--socket PATH]

Prints a line a width, then one JSON line.
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from vqvae_tpu_torch.cli.common import add_device_arg, resolve_device
from vqvae_tpu_torch.configs import get_config
from vqvae_tpu_torch.measure import _common as mc

N_PUSH = 24


def make_decoder(cfg, dev, seed: int = 0):
    """The daemon's kernel engine on seeded weights."""
    from vqvae_tpu_torch.infer.kernel_stream import KernelStreamDecoder
    from vqvae_tpu_torch.models import init_model
    params = init_model(cfg.model, torch.Generator().manual_seed(seed), dev)
    return KernelStreamDecoder(params, cfg.model)


def _row(cfg, w, ttfa_ms, i, push_ms) -> dict:
    audio_ms = w * cfg.model.hop / cfg.data.sr * 1e3
    p50 = mc.percentile(push_ms, 50)
    return {"width": w, "ttfa_ms": ttfa_ms, "pushes_to_first_audio": i,
            "push_p50_ms": p50, "audio_ms_per_push": audio_ms,
            "sustained_x": audio_ms / p50}


def _steady(push, codes, n_push):
    """(ttfa ms, pushes to the first audio, [push ms])."""
    t0 = time.perf_counter()
    out, i = push(codes), 1
    while out.size == 0:
        out, i = push(codes), i + 1
    ttfa = (time.perf_counter() - t0) * 1e3
    push_ms = []
    for _ in range(n_push):
        t0 = time.perf_counter()
        push(codes)
        push_ms.append((time.perf_counter() - t0) * 1e3)
    return ttfa, i, push_ms


def sweep_raw(cfg, dec, widths, n_push: int = N_PUSH) -> list:
    rng = np.random.default_rng(0)
    rows = []
    for w in widths:
        codes = rng.integers(0, cfg.model.K, (1, w))
        s = dec.session([0], seed=0, greedy=True)   # warm this width
        s.push(codes)
        s.close()
        s = dec.session([0], seed=1, greedy=True)
        rows.append(_row(cfg, w, *_steady(s.push, codes, n_push)))
        s.close()
    return rows


def sweep_socket(cfg, path: str, widths, n_push: int = N_PUSH) -> list:
    from vqvae_tpu_torch.client import CodecClient
    rng = np.random.default_rng(0)
    rows = []
    with CodecClient(socket_path=path) as c:
        K = c.ping()["K"]
        for w in widths:
            codes = rng.integers(0, K, w)
            with c.open_stream("codes", greedy=True) as s:
                s.push_codes(codes)
            with c.open_stream("codes", seed=1, greedy=True) as s:
                rows.append(_row(cfg, w, *_steady(s.push_codes, codes,
                                                  n_push)))
    return rows


class _Clock:
    """Milliseconds between marks: CUDA events on the card, the host
    clock on the CPU."""

    def __init__(self, dev):
        self.cuda = dev.type == "cuda"

    def mark(self):
        if self.cuda:
            e = torch.cuda.Event(enable_timing=True)
            e.record()
            return e
        return time.perf_counter()

    def ms(self, a, b) -> float:
        return a.elapsed_time(b) if self.cuda else (b - a) * 1e3


def decompose(cfg, dec, w: int, dev, n: int = N_PUSH) -> dict:
    """p50 ms of a steady push's parts at width w (see the module
    docstring), marked inside the session's own ``push``: its upsampler
    and decode calls are wrapped on this session only."""
    rng = np.random.default_rng(0)
    codes = rng.integers(0, cfg.model.K, (1, w))
    s = dec.session([0], seed=0, greedy=True)
    s.push(codes)
    s.push(codes)
    syn, clock, marks = s._syn, _Clock(dev), {}
    ups_push, decode = syn._ups.push, syn._decode

    def marked(fn, before, after):
        def call(*a):
            marks[before] = clock.mark()
            out = fn(*a)
            marks[after] = clock.mark()
            return out
        return call

    syn._ups.push = marked(ups_push, "m0", "m1")
    syn._decode = marked(decode, "m1", "m2")
    parts = {"upload": [], "upsampler": [], "kernel": [], "readback": []}
    for _ in range(n):
        mc.sync(dev)
        first = clock.mark()
        s.push(codes)
        last = clock.mark()
        mc.sync(dev)
        parts["upload"].append(clock.ms(first, marks["m0"]))
        parts["upsampler"].append(clock.ms(marks["m0"], marks["m1"]))
        parts["kernel"].append(clock.ms(marks["m1"], marks["m2"]))
        parts["readback"].append(clock.ms(marks["m2"], last))
    s.close()
    return {"width": w, **{k + "_ms": mc.percentile(v, 50)
                           for k, v in parts.items()}}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--widths", type=int, nargs="*", default=[16, 32, 48, 64])
    ap.add_argument("--decompose", type=int, default=16,
                    help="push width to split (0: none; not with --socket)")
    ap.add_argument("--socket", help="sweep through a daemon's sessions")
    add_device_arg(ap)
    args = ap.parse_args(argv)
    cfg = get_config("vctk-multi")
    if args.socket:
        from vqvae_tpu_torch.client import CodecClient
        with CodecClient(socket_path=args.socket) as c:
            info = c.ping()
        dev, via = info.get("device") or "cpu", f"daemon ({info['engine']})"
        rows = sweep_socket(cfg, args.socket, args.widths)
        split = None
    else:
        dev, via = resolve_device(args.device), "session"
        dec = make_decoder(cfg, dev)
        rows = sweep_raw(cfg, dec, args.widths)
        split = (decompose(cfg, dec, args.decompose, dev)
                 if args.decompose else None)
    for r in rows:
        print(f"width={r['width']:3d}  ttfa={r['ttfa_ms']:7.1f}ms  "
              f"push_p50={r['push_p50_ms']:6.1f}ms  "
              f"audio/push={r['audio_ms_per_push']:6.1f}ms  "
              f"sustained={r['sustained_x']:5.2f}x  "
              f"(pushes to 1st audio: {r['pushes_to_first_audio']})",
              flush=True)
    if split:
        print(f"decomposition at width {split['width']}: " + ", ".join(
            f"{k[:-3]} p50={v:.2f}ms" for k, v in split.items()
            if k.endswith("_ms")), flush=True)
    return mc.emit({"preset": cfg.name, "via": via, "greedy": True,
                    "pushes": N_PUSH, "rows": rows, "decompose": split},
                   dev)


if __name__ == "__main__":
    main()

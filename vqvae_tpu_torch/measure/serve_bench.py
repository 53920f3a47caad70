"""Load test for the serving daemon: the request-latency distribution
through the real socket, warm (port of ``scripts/serve_bench.py``).

Requests go through ``vqvae_tpu_torch.client.CodecClient``, the path an
application uses, one at a time on one connection, after one untimed
warm-rinse request.  ``--op`` picks decode (code ids in, audio out: the
autoregressive path), encode (audio in, ids out) or reconstruct (both).

    python -m vqvae_tpu_torch.cli.serve --preset vctk-multi -m w.npz \\
        --socket /tmp/codec.sock &          # --engine kernel or stream
    python -m vqvae_tpu_torch.measure.serve_bench --socket /tmp/codec.sock \\
        [--op decode] [--seconds 1.0] [--requests 20] [--greedy]

Prints one JSON line with the JAX script's keys (``op``, ``n``,
``audio_s``, ``p50_ms``, ``p95_ms``, ``mean_ms``, ``realtime_x`` (audio
seconds per wall second at p50), ``preset``, ``chunk``, ``greedy``,
``daemon_ms``, ``daemon_errors``: the daemon's own accounting of the op,
so client p50 minus daemon p50 is transport and protocol), and
``engine`` from ``ping`` (``kernel`` or ``stream``), and the card's name
and power limit when the daemon runs on one (null on the CPU).
"""

from __future__ import annotations

import argparse
import time

import numpy as np

from vqvae_tpu_torch.client import CodecClient
from vqvae_tpu_torch.measure import _common as mc


def bench(c: CodecClient, op: str, seconds: float, requests: int,
          greedy: bool):
    """(the JSON record, the daemon's torch device name)."""
    info = c.ping()
    sr, hop, K = info["sr"], info["hop"], info["K"]
    T = int(seconds * sr)
    rng = np.random.default_rng(0)

    def fire(i: int) -> None:
        if op == "decode":
            c.decode(rng.integers(0, K, T // hop), seed=i, greedy=greedy)
            return
        t = np.arange(T) / sr
        wav = (0.5 * np.sin(2 * np.pi * (200 + 10 * i) * t)
               ).astype(np.float32)
        if op == "encode":
            c.encode(wav)
        else:
            c.reconstruct(wav, seed=i, greedy=greedy)

    fire(-1)  # warm rinse, left out of the numbers
    lat = []
    for i in range(requests):
        t0 = time.perf_counter()
        fire(i)
        lat.append(time.perf_counter() - t0)
    daemon = c.stats().get("ops", {}).get(op, {})
    lat_ms = np.sort(np.asarray(lat) * 1e3)
    audio_s = (T // hop) * hop / sr
    p50 = mc.percentile(lat_ms, 50)
    return {"op": op, "n": requests, "audio_s": round(audio_s, 4),
            "p50_ms": p50, "p95_ms": mc.percentile(lat_ms, 95),
            "mean_ms": float(lat_ms.mean()),
            "realtime_x": audio_s / (p50 / 1e3),
            "preset": info.get("preset"), "chunk": info.get("chunk"),
            "greedy": bool(greedy), "daemon_ms": daemon.get("ms"),
            "daemon_errors": daemon.get("errors"),
            "engine": info.get("engine")}, info.get("device") or "cpu"


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--socket", help="daemon UNIX socket path")
    p.add_argument("--tcp", metavar="HOST:PORT",
                   help="daemon TCP address instead of --socket")
    p.add_argument("--op", default="decode",
                   choices=["decode", "encode", "reconstruct"])
    p.add_argument("--seconds", type=float, default=1.0,
                   help="audio length per request")
    p.add_argument("--requests", type=int, default=20)
    p.add_argument("--greedy", action="store_true",
                   help="greedy decode (default: sampled)")
    args = p.parse_args(argv)
    if bool(args.socket) == bool(args.tcp):
        p.error("exactly one of --socket or --tcp is required")
    with CodecClient(socket_path=args.socket, tcp=args.tcp) as c:
        rec, device = bench(c, args.op, args.seconds, args.requests,
                            args.greedy)
    # the card line is that of the daemon's device (cuda:N or cpu)
    return mc.emit(rec, device)


if __name__ == "__main__":
    main()

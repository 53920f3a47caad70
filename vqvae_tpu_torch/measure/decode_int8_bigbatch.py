"""int8 against bf16 in the large-batch synthesis regime (port of
``scripts/decode_int8_bigbatch.py``).

A chain of L=30 dependent ``[B, 2R] x [2R, 4R]`` products (R=64), each
followed by the WaveNet gate ``tanh * sigmoid`` (the per-layer core of
``models/wavenet.py::decoder_step``), 64 chained steps, at B=2048: bf16
weights and activations against int8 weights and activations (int32
accumulation, a float32 rescale, quantised again between layers), and a
bf16 chain without the gate, whose time against the gated one is the
gate's share.

In JAX these chains are plain XLA dots, not a Pallas kernel, so their
faithful counterparts are library products: ``torch.matmul`` in bf16
(cuBLAS accumulates in float32 here, with reduced-precision reductions
off; its output rounds to bf16 where XLA kept float32) and
``torch._int_mm`` for int8 (int32 out).  ``torch._int_mm`` needs more
than 16 rows and widths that are multiples of 8: at B <= 16, or where
the build lacks it, the int8 chain raises with the reason; nothing
falls back to another product.

Each chain is timed two ways on the card: as one CUDA-graph replay of
its 64 steps (the card's time; the JAX script's keys) and as eager
launches (``*_eager_us_per_step``: 64 x 30 x ~3 launches a chain, so
bound by the host's launch rate).  ``bf16_matmul_tflops`` is the
products' rate in the ungated chain's graph replay, beside the card's
bf16 peak (``utils/flops.py::PEAK_FLOPS``).  On the CPU there is no
graph replay: the graph keys and rates are null.

    python -m vqvae_tpu_torch.measure.decode_int8_bigbatch [--batch 2048]
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from vqvae_tpu_torch.cli.common import add_device_arg, resolve_device
from vqvae_tpu_torch.measure import _common as mc
from vqvae_tpu_torch.utils.flops import PEAK_FLOPS

R, L, STEPS = 64, 30, 64   # residual width, layers, chained steps


def script_data(B: int, device, seed: int = 0):
    """The JAX script's draws, in its order: (w16, w8, scale, x16)."""
    rng = np.random.default_rng(seed)
    w16 = rng.normal(size=(L, 2 * R, 4 * R)) / 16
    w8 = rng.integers(-127, 128, (L, 2 * R, 4 * R))
    x16 = rng.normal(size=(B, 2 * R))
    return (torch.from_numpy(w16).to(device, torch.bfloat16),
            torch.from_numpy(w8.astype(np.int8)).to(device),
            torch.full((L, 1, 1), 1 / 127.0 / 16, device=device),
            torch.from_numpy(x16).to(device, torch.bfloat16))


def gate(u: torch.Tensor) -> torch.Tensor:
    return (torch.tanh(u[:, :2 * R]) * torch.sigmoid(u[:, 2 * R:])
            ).to(torch.bfloat16)


def step_bf16(x, w16):
    for li in range(L):
        x = gate(torch.matmul(x, w16[li]).float())
    return x


def step_bf16_nogate(x, w16):
    for li in range(L):
        u = torch.matmul(x, w16[li]).float()
        x = (u[:, :2 * R] * 0.125).to(torch.bfloat16)
    return x


def quantize(x: torch.Tensor) -> torch.Tensor:
    return torch.clamp(x.float() * 127.0, -127, 127).to(torch.int8)


def int8_acc(xi: torch.Tensor, w8_l: torch.Tensor) -> torch.Tensor:
    """int8 ``[B, K] x [K, N]`` -> int32 through ``torch._int_mm``."""
    if not hasattr(torch, "_int_mm"):
        raise RuntimeError("this PyTorch build has no torch._int_mm: the "
                           "int8 chain needs it")
    if xi.shape[0] <= 16 or xi.shape[1] % 8 or w8_l.shape[1] % 8:
        raise ValueError(
            f"torch._int_mm needs more than 16 rows and widths that are "
            f"multiples of 8, got [{xi.shape[0]}, {xi.shape[1]}] x "
            f"[{w8_l.shape[0]}, {w8_l.shape[1]}]")
    return torch._int_mm(xi, w8_l)


def step_int8(x, w8, sc):
    for li in range(L):
        u = int8_acc(quantize(x), w8[li]).float() * sc[li]
        x = gate(u)
    return x


def chain(step, x, steps: int = STEPS):
    for _ in range(steps):
        x = step(x)
    return x


def eager_us(fn, x, dev, n: int = 10) -> float:
    """Host-clock µs per chained step, eager launches."""
    out = [chain(fn, x)]

    def call():
        out[0] = chain(fn, out[0])
    return mc.wall_ms(call, n, dev) * 1e3 / STEPS


def graph_us(fn, x, dev, replays: int = 10):
    """Card µs per chained step: the 64 steps captured as one CUDA graph,
    the median replay between CUDA events; None off the card."""
    if dev.type != "cuda":
        return None
    xs = x.clone()
    side = torch.cuda.Stream(dev)      # warm up off the default stream,
    side.wait_stream(torch.cuda.current_stream(dev))  # as capture wants
    with torch.cuda.stream(side):
        chain(fn, xs)
    torch.cuda.current_stream(dev).wait_stream(side)
    mc.sync(dev)
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        out = chain(fn, xs)
    g.replay()
    times = []
    for _ in range(replays):
        xs.copy_(out)
        e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        e0.record()
        g.replay()
        e1.record()
        mc.sync(dev)
        times.append(e0.elapsed_time(e1) * 1e3 / STEPS)
    return float(np.median(times))


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--batch", type=int, default=2048)
    add_device_arg(ap)
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    B = args.batch
    w16, w8, sc, x16 = script_data(B, dev)
    fns = {"bf16": lambda x: step_bf16(x, w16),
           "bf16_nogate": lambda x: step_bf16_nogate(x, w16),
           "int8": lambda x: step_int8(x, w8, sc)}
    with torch.no_grad():
        eager = {k: eager_us(f, x16, dev) for k, f in fns.items()}
        graph = {k: graph_us(f, x16, dev) for k, f in fns.items()}
    t = graph if dev.type == "cuda" else eager
    flops = 2 * B * (2 * R) * (4 * R) * L   # a chained step's products
    tflops = (flops / (graph["bf16_nogate"] * 1e-6) / 1e12
              if graph["bf16_nogate"] else None)
    rec = {"batch": B,
           **{f"{k}_us_per_step": graph[k] for k in fns},
           "int8_vs_bf16": t["int8"] / t["bf16"],
           "gate_share_of_bf16": (t["bf16"] - t["bf16_nogate"]) / t["bf16"],
           "bf16_matmul_tflops": tflops,
           "bf16_matmul_peak_share": (tflops * 1e12 / PEAK_FLOPS
                                      if tflops else None),
           **{f"{k}_eager_us_per_step": eager[k] for k in fns}}
    return mc.emit(rec, dev)


if __name__ == "__main__":
    main()

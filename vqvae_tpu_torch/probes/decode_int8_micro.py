"""Would int8 weights halve the bytes of the decode kernel's layer chain
without slowing it?  The card-side mirror of
``scripts/decode_int8_micro.py``.

    python -m vqvae_tpu_torch.probes.decode_int8_micro [--device cuda]
        [--decode-us US]

A chain of ``L`` dependent products per step, ``STEPS`` steps, at the
decode kernel's widths (x ``[64, 128]``, w ``[L, 128, 128]``), in bf16
and in int8 with an int32 sum and a float32 rescale
(``kernels/decode_chain_cuda.py``), on the script's data (numpy seed 0).
The checks hold the int8 chain bit-equal to its plain version and the
bf16 chain within 3e-2 of max, on outputs that are not all zero, at L=2
and at the timed L=30, with 1 and 2 steps.  At L=30 the script's int8
scale zeroes the chain within a layer, so there the int8 checks use
``held_scales``, one per layer, which keep its activations near 1; the
bf16 chain keeps the script's data (max about 3e-5 after one step, 1e-10
after two).  Then both are timed at the script's L=30, STEPS=128 (CUDA
events) beside their plain versions, and the script's numbers are
printed: µs per chain step and ns per product, with the decode kernel's
per-layer time for comparison when ``--decode-us`` gives its measured µs
per step; ``per_matmul_ns_*`` is each chain's ns a layer, and
``int8_over_bf16`` the ratio of the two chains' times, the probe's
answer.  The last line is one JSON object.
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from vqvae_tpu_torch.kernels import decode_chain_cuda as chn
from vqvae_tpu_torch.probes._common import (
    Checks,
    add_device_arg,
    cuda_ms,
    device_name,
    emit,
    finish,
    resolve_device,
)

B, R, L, STEPS = 64, 64, 30, 128
REPS = 20   # timed chains per dtype, as the script
CHECKS = ((2, 1), (2, 2), (L, 1), (L, 2))   # (L, STEPS)


def script_data(n_layers: int, dev: torch.device):
    """x, w16, w8, scale as the script draws them (numpy seed 0)."""
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.normal(size=(B, 2 * R))).to(torch.bfloat16)
    w16 = torch.from_numpy(rng.normal(size=(n_layers, 2 * R, 2 * R))
                           / 16).to(torch.bfloat16)
    w8 = torch.from_numpy(rng.integers(-127, 127, (n_layers, 2 * R, 2 * R))
                          ).to(torch.int8)
    sc = torch.full((n_layers, 1, 1), 1 / 127.0 / 16, dtype=torch.float32)
    return x.to(dev), w16.to(dev), w8.to(dev), sc.to(dev)


def held_scales(n_layers: int, dev: torch.device) -> torch.Tensor:
    """int8 scales ``[L, 1, 1]`` that keep the chain's activations near 1
    at any depth, a different one per layer.  The script's weights
    (uniform integers in [-127, 127), rms about 73) over 128 inputs scale
    an activation by about 73·sqrt(128)/128 per unit of scale; layer l's
    scale is the inverse of that times a gain from 1 to 2."""
    gain = torch.linspace(1.0, 2.0, n_layers, dtype=torch.float64)
    sc = gain * 128 / (127 * 73 * 128 ** 0.5)
    return sc.float().reshape(n_layers, 1, 1).to(dev)


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    add_device_arg(p)
    p.add_argument("--decode-us", type=float, default=None,
                   help="the decode kernel's measured µs per step (30 "
                        "layers), printed per layer beside the chains'")
    args = p.parse_args(argv)
    dev = resolve_device(args.device)
    print(f"backend: {device_name(dev)}", flush=True)
    checks = Checks()
    for n_layers, steps in CHECKS:
        x, w16, w8, sc = script_data(n_layers, dev)
        if n_layers > 2:
            sc = held_scales(n_layers, dev)
        tag = f"L{n_layers}_S{steps}"
        want8 = chn.chain_int8_plain(x, w8, sc, steps)
        want16 = chn.chain_bf16_plain(x, w16, steps)
        if not (want8.float().abs().max() > 0 and
                want16.float().abs().max() > 0):
            checks.failed.append(f"zero_output_{tag}")
        checks.exact(f"int8_{tag}", chn.chain(x, w8, steps, sc), want8)
        checks.close(f"bf16_{tag}", chn.chain(x, w16, steps), want16, 3e-2)
    record = {"probe": "decode_int8_micro", "device": device_name(dev),
              "shape": {"B": B, "width": 2 * R, "L": L, "STEPS": STEPS}}
    if dev.type == "cuda":
        x, w16, w8, sc = script_data(L, dev)
        for k in chn.launches:
            chn.launches[k] = 0
        t16 = cuda_ms(lambda: chn.chain(x, w16, STEPS), dev, REPS)
        t8 = cuda_ms(lambda: chn.chain(x, w8, STEPS, sc), dev, REPS)
        record["launches"] = dict(chn.launches)
        p16 = cuda_ms(lambda: chn.chain_bf16_plain(x, w16, STEPS), dev, 1)
        p8 = cuda_ms(lambda: chn.chain_int8_plain(x, w8, sc, STEPS), dev, 1)
        out8 = chn.chain(x, w8, STEPS, sc)
        out16 = chn.chain(x, w16, STEPS)
        record.update({
            "bf16_us_per_chainstep": 1e3 * t16 / STEPS,
            "int8_us_per_chainstep": 1e3 * t8 / STEPS,
            "per_matmul_ns_bf16": 1e6 * t16 / STEPS / L,
            "per_matmul_ns_int8": 1e6 * t8 / STEPS / L,
            "bf16_ms": t16, "int8_ms": t8,
            "plain_bf16_ms": p16, "plain_int8_ms": p8,
            "int8_over_bf16": t8 / t16,
            "bf16_out_max": float(out16.float().abs().max()),
            "int8_out_max": float(out8.float().abs().max())})
        if args.decode_us is not None:
            record["decode_kernel_ns_per_layer"] = 1e3 * args.decode_us / L
        print(f"ns a layer: bf16 {record['per_matmul_ns_bf16']:.1f}, int8 "
              f"{record['per_matmul_ns_int8']:.1f}; int8 / bf16 "
              f"{t8 / t16:.3f}", flush=True)
        emit({k: record[k] for k in (
            "bf16_us_per_chainstep", "int8_us_per_chainstep",
            "per_matmul_ns_bf16", "per_matmul_ns_int8", "int8_over_bf16",
            "decode_kernel_ns_per_layer") if k in record})
    finish(record, checks)


if __name__ == "__main__":
    main()

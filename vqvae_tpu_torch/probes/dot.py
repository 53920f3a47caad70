"""The upsampler's contraction patterns as kernels on the card: the
mirror of ``scripts/mosaic_dot_probe.py``.

    python -m vqvae_tpu_torch.probes.dot [--device cuda]

At the script's shapes (N 32, hop 64, d 64, float32, numpy seed 0) it
runs its five bodies through the kernels of ``csrc/upsample.cu``: the
contractions ``nd,rde->nre`` (the upsampler's tap product),
``nrd,rde->ne`` (its ``de``) and ``nd,nre->dre`` (its ``duw``), each
against ``torch.einsum`` within 1e-4 of max; the leading-dim split
``[N·hop, d] -> [N, hop, d]`` (the relayout kernel) and the pad/add/slice
on the time axis (the upsampler's overlap-add on its own), both bit-equal.
Then it times each body (CUDA events) beside its plain version and, where
one exists, one library call (``einsum``; ``clone`` of the reshape): per
call (``ms``, the host's enqueue included) and by CUDA-graph replay
(``graph_ms``, ``library_graph_ms``: the card's time alone).  The last
line is one JSON object.
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from vqvae_tpu_torch.kernels import upsample_cuda as uc
from vqvae_tpu_torch.probes._common import (
    Checks,
    add_device_arg,
    cuda_ms,
    device_name,
    graph_ms,
    finish,
    resolve_device,
)

TOL = 1e-4
N, HOP, D = 32, 64, 64
REPS = 50   # timed calls per body


def bodies(ef, W, dp, big, hop):
    """(name, kernel call, plain call, library call or None, exact)."""
    N, d = ef.shape
    return [
        ("nd,rde->nre", lambda: uc.tap_product(ef, W),
         lambda: uc.tap_product_plain(ef, W),
         lambda: torch.einsum("nd,rde->nre", ef, W), False),
        ("nrd,rde->ne", lambda: uc.tap_adjoint(dp, W),
         lambda: uc.tap_adjoint_plain(dp, W),
         lambda: torch.einsum("nrd,rde->ne", dp, W), False),
        ("nd,nre->dre", lambda: uc.tap_wgrad(ef, dp),
         lambda: uc.tap_wgrad_plain(ef, dp),
         lambda: torch.einsum("nd,nre->dre", ef, dp), False),
        ("leading split", lambda: (uc.relayout_kernel(big, (N, hop, d),
                                                      "probe_dot")
                                   if big.is_cuda else
                                   uc.relayout_plain(big, (N, hop, d))),
         lambda: uc.relayout_plain(big, (N, hop, d)),
         lambda: big.reshape(N, hop, d).clone(), True),
        ("pad/add/slice", lambda: uc.overlap_add(big, hop),
         lambda: uc.overlap_add_plain(big, hop), None, True),
    ]


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    add_device_arg(p)
    args = p.parse_args(argv)
    dev = resolve_device(args.device)
    print(f"backend: {device_name(dev)}", flush=True)
    rng = np.random.default_rng(0)
    ef = torch.from_numpy(rng.standard_normal((N, D))).float().to(dev)
    W = torch.from_numpy(rng.standard_normal((HOP, D, D)) * 0.1).float().to(
        dev)
    dp = torch.from_numpy(rng.standard_normal((N, HOP, D))).float().to(dev)
    big = torch.from_numpy(rng.standard_normal((N * HOP, D))).float().to(dev)
    checks = Checks()
    rows = bodies(ef, W, dp, big, HOP)
    for name, kern, plain, _, exact in rows:
        got, want = kern(), plain()
        if exact:
            ok = checks.exact(name, got, want)
            print(f"{name}: values {'MATCH' if ok else 'WRONG'}", flush=True)
        else:
            err = checks.close(name, got, want, TOL)
            print(f"einsum {name}: ok, rel err {err:.2e}", flush=True)
    record = {"probe": "dot", "device": device_name(dev),
              "shape": {"N": N, "hop": HOP, "d": D}, "times": {}}
    if dev.type == "cuda":
        for k in uc.launches:
            uc.launches[k] = 0
        for name, kern, *_ in rows:
            record["times"][name] = {"ms": cuda_ms(kern, dev, REPS)}
        record["launches"] = dict(uc.launches)
        for name, kern, plain, lib, _ in rows:
            record["times"][name].update(
                graph_ms=graph_ms(kern, dev, REPS),
                plain_ms=cuda_ms(plain, dev, REPS),
                library_ms=cuda_ms(lib, dev, REPS) if lib else None,
                library_graph_ms=graph_ms(lib, dev, REPS) if lib else None)
        for name, t in record["times"].items():
            print(f"{name}: kernel {1e3 * t['ms']:.2f} us a call, "
                  f"{1e3 * t['graph_ms']:.3f} us by graph replay; plain "
                  f"{1e3 * t['plain_ms']:.2f} us; library "
                  + (f"{1e3 * t['library_ms']:.2f} us a call, "
                     f"{1e3 * t['library_graph_ms']:.3f} us by graph replay"
                     if t["library_ms"] else "none"), flush=True)
    finish(record, checks)


if __name__ == "__main__":
    main()

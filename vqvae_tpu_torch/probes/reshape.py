"""In-kernel layout changes on the card: the mirror of
``scripts/mosaic_reshape_probe.py``.

    python -m vqvae_tpu_torch.probes.reshape [--device cuda]

At the script's shapes (N 32, hop 64, d 64, float32) each of its five
reshapes runs through the relayout kernel of ``csrc/upsample.cu`` (a
row-major reshape keeps the flat order, so on the card it is a flat
16-byte copy) and must equal ``x.reshape`` bit for bit; the composition
``((x @ w).reshape(N·hop, d)) @ v`` runs as one fused kernel whose
``[N, hop·d]`` intermediate never reaches device memory, within 1e-4 of
max of the two plain products.  Then each is timed (CUDA events) beside
its plain version and, for the reshapes, one ``clone`` of the reshaped
view (none exists for the composition, which needs two calls): per call
(``ms``, ``library_ms``: 50 calls between two events, the host's enqueue
included) and, for the reshapes, by CUDA-graph replay (``graph_ms``,
``library_graph_ms``: the same 50 calls captured once and replayed, the
card's time alone).  ``launches`` counts the kernel's calls in the timed
run; the graph capture counts once per captured call, its replays not at
all.  The last line is one JSON object.
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
    finish,
    graph_ms,
    resolve_device,
)

N, HOP, D = 32, 64, 64
CASES = [
    ("2D minor untile  [N, hop*d] -> [N*hop, d]", (N, HOP * D), (N * HOP, D)),
    ("3D collapse      [N, hop, d] -> [N*hop, d]", (N, HOP, D), (N * HOP, D)),
    ("2D minor split   [N, hop*d] -> [N, hop, d]", (N, HOP * D), (N, HOP, D)),
    ("sublane split    [hop*d, N] -> [hop, d, N]", (HOP * D, N), (HOP, D, N)),
    ("sublane collapse [hop, d, N] -> [hop*d, N]", (HOP, D, N), (HOP * D, N)),
]
E = 128   # columns of v
REPS = 50  # timed calls per case


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    add_device_arg(p)
    args = p.parse_args(argv)
    dev = resolve_device(args.device)
    print(f"backend: {device_name(dev)}", flush=True)
    checks = Checks()
    xs = [torch.from_numpy(np.random.default_rng(0).standard_normal(
        src)).float().to(dev) for _, src, _ in CASES]
    for (name, _, dst), x in zip(CASES, xs):
        ok = checks.exact(name, uc.relayout(x, dst), x.reshape(dst))
        print(f"{name}: compiled, values {'MATCH' if ok else 'WRONG'}",
              flush=True)
    rng = np.random.default_rng(1)
    x = torch.from_numpy(rng.standard_normal((N, D))).float().to(dev)
    w = torch.from_numpy(rng.standard_normal((D, HOP * D)) * 0.1).float().to(
        dev)
    v = torch.from_numpy(rng.standard_normal((D, E)) * 0.1).float().to(dev)
    err = checks.close("composition", uc.compose(x, w, v, HOP),
                       uc.compose_plain(x, w, v, HOP), 1e-4)
    print(f"composition matmul->untile->matmul: compiled, rel err {err:.2e}",
          flush=True)
    record = {"probe": "reshape", "device": device_name(dev),
              "shape": {"N": N, "hop": HOP, "d": D, "E": E}, "times": {}}
    if dev.type == "cuda":
        for k in uc.launches:
            uc.launches[k] = 0
        t = record["times"]
        for (name, _, dst), xx in zip(CASES, xs):
            t[name] = {"ms": cuda_ms(lambda: uc.relayout(xx, dst), dev,
                                     REPS),
                       "graph_ms": graph_ms(lambda: uc.relayout(xx, dst),
                                            dev, REPS)}
        t["composition"] = {"ms": cuda_ms(lambda: uc.compose(x, w, v, HOP),
                                          dev, REPS)}
        record["launches"] = dict(uc.launches)
        for (name, _, dst), xx in zip(CASES, xs):
            # the plain version is a reshape and a clone: the library call
            t[name]["plain_ms"] = t[name]["library_ms"] = cuda_ms(
                lambda: uc.relayout_plain(xx, dst), dev, REPS)
            t[name]["library_graph_ms"] = graph_ms(
                lambda: uc.relayout_plain(xx, dst), dev, REPS)
        t["composition"].update(
            plain_ms=cuda_ms(lambda: uc.compose_plain(x, w, v, HOP), dev,
                             REPS), library_ms=None)
        for name, r in t.items():
            print(f"{name}: kernel {1e3 * r['ms']:.2f} us, plain "
                  f"{1e3 * r['plain_ms']:.2f} us a call"
                  + (f"; graph replay: kernel {1e3 * r['graph_ms']:.3f} us,"
                     f" clone {1e3 * r['library_graph_ms']:.3f} us"
                     if "graph_ms" in r else ""), flush=True)
    finish(record, checks)


if __name__ == "__main__":
    main()

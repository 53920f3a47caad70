"""Would building the audio-rate condition from the latent frames inside
a kernel beat reading a materialised ``[B, T, d]`` condition?  The
card-side mirror of ``scripts/cond_inkernel_probe.py``.

    python -m vqvae_tpu_torch.probes.cond_inkernel [--batch 16 64]
        [--device cuda]

At the probe's shapes (hop 64, d 64, Tl 16, B 4, float32, numpy seed 0)
it holds the upsampler's kernels (``kernels/upsample_cuda.py``) against
the port's ``ops/conv.py::upsample_apply`` and its autograd, as the JAX
script holds its Pallas bodies against ``upsample_apply`` and
``jax.vjp``.  With ``--batch`` it runs vctk-multi's upsampler at full
width (``w [2·hop, d, d]``, T = 7680) for each batch, in bf16 and in
float32: the kernels against their plain versions (1e-4 / 3e-2 of max),
then times
(CUDA events) the forward and the backward beside the plain versions,
beside one library call that computes the same function
(``conv_transpose1d`` with stride hop and 2·hop taps, cropped by a view,
and its autograd backward; a yardstick only) and beside the cost of
reading the materialised condition (its bytes at 3.35 TB/s, and a
measured ``copy_``, which reads and writes them).  The last line is one
JSON object.
"""

from __future__ import annotations

import argparse

import numpy as np
import torch
import torch.nn.functional as F

from vqvae_tpu_torch.configs import get_config
from vqvae_tpu_torch.kernels import upsample_cuda as uc
from vqvae_tpu_torch.ops.conv import upsample_apply
from vqvae_tpu_torch.probes._common import (
    PEAK_BYTES,
    Checks,
    add_device_arg,
    cuda_ms,
    device_name,
    finish,
    resolve_device,
)

REPS = 20   # timed calls of each kernel and library call
TOL = {torch.float32: 1e-4, torch.bfloat16: 3e-2}


def unpack_upsampler(uwk: torch.Tensor, d: int, hop: int) -> torch.Tensor:
    """w ``[2·hop, d, d]`` from uwk (the inverse of ``pack_upsampler``)."""
    return torch.flip(uwk.reshape(d, 2 * hop, d).permute(1, 0, 2), (0,))


def probe_shapes(dev: torch.device, checks: Checks) -> None:
    """The JAX script's check, at its shapes and seed."""
    hop, d, Tl, B = 64, 64, 16, 4
    K, T = 2 * hop, Tl * hop
    rng = np.random.default_rng(0)
    w = torch.from_numpy(rng.standard_normal((K, d, d)) * 0.1).float()
    bb = torch.from_numpy(rng.standard_normal((d,)) * 0.1).float()
    e = torch.from_numpy(rng.standard_normal((B, Tl, d))).float()
    dcond = torch.from_numpy(rng.standard_normal((B, T, d))).float()
    uwk, ub = uc.pack_upsampler(w, bb)
    e, uwk, ub, dcond = (t.to(dev) for t in (e, uwk, ub, dcond))
    ref = upsample_apply({"w": w.to(dev), "b": bb.to(dev)}, e, hop)
    out = uc.cond_forward(e, uwk, ub, hop)
    err = checks.close("fwd_vs_upsample_apply", out, ref, TOL[torch.float32])
    print(f"fwd max rel err vs upsample_apply: {err:.2e}", flush=True)

    de, duw, dub = uc.cond_backward(dcond, e, uwk, hop)
    e_, uwk_, ub_ = (t.clone().requires_grad_(True) for t in (e, uwk, ub))
    y = upsample_apply({"w": unpack_upsampler(uwk_, d, hop), "b": ub_}, e_,
                       hop)
    want = torch.autograd.grad(y, (e_, uwk_, ub_), dcond)
    for name, a, r in (("de", de, want[0]), ("duw", duw, want[1]),
                       ("dub", dub, want[2])):
        err = checks.close(f"bwd_{name}_vs_autograd", a, r,
                           TOL[torch.float32])
        print(f"bwd {name} max rel err: {err:.2e}", flush=True)


def full_width(dev, B, cdt, checks, seed=0):
    """vctk-multi's upsampler at batch B: checks, then the timed run.
    Returns the run's record."""
    mc = get_config("vctk-multi")
    hop, d, T = mc.model.hop, mc.model.d, mc.data.length
    Tl = T // hop
    g = torch.Generator().manual_seed(seed)
    w = torch.randn(2 * hop, d, d, generator=g) * (2 * hop * d) ** -0.5
    bb = torch.randn(d, generator=g) * 0.1
    uwk, ub = uc.pack_upsampler(w, bb)
    e = torch.randn(B, Tl, d, generator=g).to(dev, cdt)
    dcond = (torch.randn(B, T, d, generator=g) * 0.01).to(dev)
    uwk, ub = uwk.to(dev, cdt), ub.to(dev)
    tag = f"B{B}_{str(cdt)[6:]}"
    tol = TOL[cdt]

    def fwd():
        return uc.cond_forward(e, uwk, ub, hop)

    def bwd():
        return uc.cond_backward(dcond, e, uwk, hop)

    def plain_fwd():
        return uc.cond_fwd_plain(e, uwk, ub, hop)

    def plain_bwd():
        return uc.cond_bwd_plain(dcond, e, uwk, hop)

    # the library yardstick: channels-first conv_transpose1d, cropped
    wt = uwk.reshape(d, 2 * hop, d).permute(0, 2, 1).contiguous()
    e_cf = e.transpose(1, 2).contiguous()

    def lib_fwd():
        return F.conv_transpose1d(e_cf, wt, ub.to(cdt),
                                  stride=hop)[:, :, hop // 2: hop // 2 + T]

    cond = fwd()
    checks.close(f"fwd_{tag}", cond, plain_fwd(), tol)
    for name, a, r in zip(("de", "duw", "dub"), bwd(), plain_bwd()):
        checks.close(f"bwd_{name}_{tag}", a, r, tol)
    checks.close(f"library_fwd_{tag}", lib_fwd().transpose(1, 2), cond, tol)
    rec = {"batch": B, "dtype": str(cdt)[6:], "hop": hop, "d": d, "T": T,
           "Tl": Tl}
    if dev.type != "cuda":
        return rec
    e_lib, w_lib, b_lib = (t.clone().requires_grad_(True)
                           for t in (e_cf, wt, ub.to(cdt)))
    y_lib = F.conv_transpose1d(e_lib, w_lib, b_lib,
                               stride=hop)[:, :, hop // 2: hop // 2 + T]
    dy_lib = dcond.to(cdt).transpose(1, 2)

    def lib_bwd():
        return torch.autograd.grad(y_lib, (e_lib, w_lib, b_lib), dy_lib,
                                   retain_graph=True)

    copy_dst = torch.empty_like(cond)
    for k in uc.launches:
        uc.launches[k] = 0
    rec.update(
        fwd_ms=cuda_ms(fwd, dev, REPS), bwd_ms=cuda_ms(bwd, dev, REPS),
        launches=dict(uc.launches))
    rec.update(
        plain_fwd_ms=cuda_ms(plain_fwd, dev, 3),
        plain_bwd_ms=cuda_ms(plain_bwd, dev, 3),
        library_fwd_ms=cuda_ms(lib_fwd, dev, REPS),
        library_bwd_ms=cuda_ms(lib_bwd, dev, REPS),
        copy_ms=cuda_ms(lambda: copy_dst.copy_(cond), dev, REPS),
        cond_bytes=cond.numel() * cond.element_size())
    rec["read_bound_ms"] = 1e3 * rec["cond_bytes"] / PEAK_BYTES
    print(f"B={B} {rec['dtype']} cond [{B}, {T}, {d}]: building it from e "
          f"takes {1e3 * rec['fwd_ms']:.1f} us (backward "
          f"{1e3 * rec['bwd_ms']:.1f} us); reading it costs "
          f"{1e3 * rec['read_bound_ms']:.1f} us at 3.35 TB/s (a copy_ that "
          f"reads and writes it: {1e3 * rec['copy_ms']:.1f} us); plain "
          f"{rec['plain_fwd_ms']:.3f} / {rec['plain_bwd_ms']:.3f} ms, "
          f"conv_transpose1d {rec['library_fwd_ms']:.3f} / "
          f"{rec['library_bwd_ms']:.3f} ms", flush=True)
    return rec


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--batch", type=int, nargs="*", default=[],
                   help="full-width batches to check and time (16, 64)")
    add_device_arg(p)
    args = p.parse_args(argv)
    dev = resolve_device(args.device)
    print(f"backend: {device_name(dev)}", flush=True)
    checks = Checks()
    probe_shapes(dev, checks)
    runs = [full_width(dev, B, cdt, checks)
            for B in args.batch for cdt in (torch.bfloat16, torch.float32)]
    finish({"probe": "cond_inkernel", "device": device_name(dev),
            "runs": runs}, checks)


if __name__ == "__main__":
    main()

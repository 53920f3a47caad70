"""The upsampler computed from latent frames, forward and backward: the
CUDA kernels ``csrc/upsample.cu`` and their plain PyTorch versions (port
of ``scripts/cond_inkernel_probe.py``'s ``_cond_fwd_body`` and
``_cond_bwd_body``), with the layout and contraction probes that share
their routines (``scripts/mosaic_dot_probe.py``,
``scripts/mosaic_reshape_probe.py``).

The upsampler is the stride-``hop`` SAME transposed conv of
``ops/conv.py::upsample_apply``, written as the probe writes it: one tap
product ``a = e @ uwk`` (``[B·Tl, d] x [d, 2·hop·d]``, float32 sums), the
overlap-add of each frame's two halves, a crop of ``hop/2`` rows and the
bias, rounded once to e's dtype.  ``uwk`` packs the flipped taps
(``pack_upsampler``).  The backward takes a float32 ``dcond``, rounds its
overlap-add adjoint ``da`` to e's dtype for the products (as the probe's
``da_c``) and returns float32 ``de = da @ uwkᵀ``, ``duw = eᵀ @ da`` and
``dub = Σ dcond``.

``cond_upsample`` is a ``torch.autograd.Function``.  Every wrapper here
runs the plain version for CPU tensors and launches its kernel (or
raises) for CUDA tensors; ``launches`` counts kernel calls by name.  The
probes' functions (``tap_product``, ``tap_adjoint``, ``tap_wgrad``,
``overlap_add``, ``relayout``, ``compose``) keep the JAX probes' shapes:
``W [hop, d, d]``, ``dp [N, hop, d]``.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from vqvae_tpu_torch.kernels.build import build

# kernel calls in this process, by the name chip_smoke.py reports
launches = {"cond_fwd": 0, "cond_bwd": 0, "probe_dot": 0,
            "probe_reshape": 0, "probe_compose": 0}

_CDTYPE = {torch.float32: 0, torch.bfloat16: 1}


def pack_upsampler(w: torch.Tensor, b: torch.Tensor):
    """(uwk ``[d_in, 2·hop·d_out]``, ub ``[d_out]``) from the upsampler's
    ``w [2·hop, d_in, d_out]`` and ``b``: ``uwk[i, r·d + c] =
    w[2·hop-1-r, i, c]``, the probe's packing of the flipped taps."""
    K, din, dout = w.shape
    return torch.flip(w, (0,)).permute(1, 0, 2).reshape(din, K * dout), b


def _mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` with float32 sums (inputs read as float32)."""
    return a.float() @ b.float()


# ---------------------------------------------------------------------------
# plain versions (the probe bodies in torch)
# ---------------------------------------------------------------------------


def cond_fwd_plain(e, uwk, ub, hop: int) -> torch.Tensor:
    """cond ``[B, Tl·hop, d]`` in e's dtype (``_cond_fwd_body``)."""
    B, Tl, din = e.shape
    dout = ub.shape[-1]
    T = Tl * hop
    a = _mm(e.reshape(B * Tl, din), uwk.to(e.dtype)).reshape(
        B, Tl, 2 * hop, dout)
    p0 = a[:, :, :hop].reshape(B, T, dout)
    p1 = a[:, :, hop:].reshape(B, T, dout)
    y = F.pad(p0, (0, 0, 0, hop)) + F.pad(p1, (0, 0, hop, 0))
    cond = y[:, hop // 2: hop // 2 + T] + ub.float().reshape(dout)
    return cond.to(e.dtype)


def _adjoint(dcond, Tl: int, hop: int) -> torch.Tensor:
    """da ``[B·Tl, 2·hop·d]``: the overlap-add's adjoint of dcond."""
    B, T, d = dcond.shape
    dy = F.pad(dcond.float(), (0, 0, hop // 2, hop - hop // 2))
    dp0 = dy[:, :Tl * hop].reshape(B, Tl, hop, d)
    dp1 = dy[:, hop:].reshape(B, Tl, hop, d)
    return torch.cat([dp0, dp1], dim=2).reshape(B * Tl, 2 * hop * d)


def cond_bwd_plain(dcond, e, uwk, hop: int):
    """(de ``[B, Tl, d]``, duw ``[d, 2·hop·d]``, dub ``[d]``), float32
    (``_cond_bwd_body``, its grid's sums taken at once)."""
    B, Tl, din = e.shape
    da = _adjoint(dcond, Tl, hop).to(e.dtype)
    de = _mm(da, uwk.to(e.dtype).T).reshape(B, Tl, din)
    duw = _mm(e.reshape(B * Tl, din).T, da)
    dub = dcond.float().sum((0, 1))
    return de, duw, dub


# ---------------------------------------------------------------------------
# CUDA kernels
# ---------------------------------------------------------------------------

_lib = None


def _library():
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build("vqvae_upsample", ["upsample.cu"])))
        p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        sigs = {
            "vqvae_cond_fwd": [i] * 5 + [p] * 5,
            "vqvae_cond_bwd": [i] * 5 + [p] * 7 + [ll, p],
            "vqvae_dot_nre": [i] * 4 + [p] * 4,
            "vqvae_dot_ne": [i] * 4 + [p] * 4 + [ll, p],
            "vqvae_dot_dre": [i] * 4 + [p] * 4 + [ll, p],
            "vqvae_ola": [i] * 5 + [p] * 3,
            "vqvae_relayout": [i, ctypes.POINTER(i), i, ctypes.POINTER(i),
                               p, p, p],
            "vqvae_compose": [i] * 4 + [p] * 5,
        }
        for name, args in sigs.items():
            fn = getattr(lib, name)
            fn.argtypes = args
            fn.restype = i
        for name, nargs in (("cond_bwd", 4), ("dot_ne", 3), ("dot_dre", 3)):
            fn = getattr(lib, f"vqvae_{name}_scratch")
            fn.argtypes = [i] * nargs
            fn.restype = ll
        _lib = lib
    return _lib


def _stream(t: torch.Tensor):
    return torch.cuda.current_stream(t.device).cuda_stream


def _scratch(name: str, *shape: int, device) -> torch.Tensor:
    """The float32 scratch a split-K entry point needs, sized by the
    kernel library's own split policy (``vqvae_<name>_scratch``)."""
    cap = getattr(_library(), f"vqvae_{name}_scratch")(*shape)
    return torch.empty(cap, dtype=torch.float32, device=device)


def _call(name: str, counter: str, *args) -> None:
    err = getattr(_library(), name)(*args)
    if err != 0:
        raise RuntimeError(f"{name} failed: error {err} (-2: shapes the "
                           f"kernel does not take)")
    launches[counter] += 1


def _check(cdt, *tensors) -> None:
    if cdt not in _CDTYPE:
        raise TypeError(f"upsample kernels have no {cdt} instance")
    dev = tensors[0].device
    for t in tensors:
        if t.device != dev:
            raise ValueError(f"tensors on {t.device} and {dev}")


def _check_width(d: int) -> None:
    if d % 16 or not 16 <= d <= 64:
        raise ValueError(f"upsample kernels take widths 16..64 in steps "
                         f"of 16, got {d}")


def cond_fwd_kernel(e, uwk, ub, hop: int) -> torch.Tensor:
    """The kernel's cond; see ``cond_fwd_plain``."""
    B, Tl, d = e.shape
    _check(e.dtype, e, uwk, ub)
    _check_width(d)
    if tuple(uwk.shape) != (d, 2 * hop * d) or ub.numel() != d or hop % 2:
        raise ValueError(f"uwk must be [{d}, {2 * hop * d}] and ub [{d}] "
                         f"with an even hop, got {tuple(uwk.shape)}, "
                         f"{tuple(ub.shape)}, hop {hop}")
    e = e.contiguous()
    uwk = uwk.to(e.dtype).contiguous()
    ub = ub.float().reshape(d).contiguous()
    cond = torch.empty(B, Tl * hop, d, dtype=e.dtype, device=e.device)
    _call("vqvae_cond_fwd", "cond_fwd", _CDTYPE[e.dtype], B, Tl, hop, d,
          e.data_ptr(), uwk.data_ptr(), ub.data_ptr(), cond.data_ptr(),
          _stream(e))
    return cond


def cond_bwd_kernel(dcond, e, uwk, hop: int):
    """The kernel's (de, duw, dub); see ``cond_bwd_plain``."""
    B, Tl, d = e.shape
    _check(e.dtype, dcond, e, uwk)
    _check_width(d)
    if tuple(dcond.shape) != (B, Tl * hop, d) or hop % 2 or \
            tuple(uwk.shape) != (d, 2 * hop * d):
        raise ValueError(f"dcond must be {(B, Tl * hop, d)} and uwk "
                         f"[{d}, {2 * hop * d}], got {tuple(dcond.shape)}, "
                         f"{tuple(uwk.shape)}")
    f32 = torch.float32
    dcond = dcond.to(f32).contiguous()
    e = e.contiguous()
    uwk = uwk.to(e.dtype).contiguous()
    de = torch.empty(B, Tl, d, dtype=f32, device=e.device)
    duw = torch.empty(d, 2 * hop * d, dtype=f32, device=e.device)
    dub = torch.empty(d, dtype=f32, device=e.device)
    part = _scratch("cond_bwd", B, Tl, hop, d, device=e.device)
    _call("vqvae_cond_bwd", "cond_bwd", _CDTYPE[e.dtype], B, Tl, hop, d,
          dcond.data_ptr(), e.data_ptr(), uwk.data_ptr(), de.data_ptr(),
          duw.data_ptr(), dub.data_ptr(), part.data_ptr(), part.numel(),
          _stream(e))
    return de, duw, dub


def _on_card(t: torch.Tensor) -> bool:
    if t.device.type == "cuda":
        return True
    if t.device.type == "cpu":
        return False
    raise ValueError(f"no upsample kernel for device {t.device}")


def cond_forward(e, uwk, ub, hop: int) -> torch.Tensor:
    if _on_card(e):
        return cond_fwd_kernel(e, uwk, ub, hop)
    return cond_fwd_plain(e, uwk, ub, hop)


def cond_backward(dcond, e, uwk, hop: int):
    if _on_card(e):
        return cond_bwd_kernel(dcond, e, uwk, hop)
    return cond_bwd_plain(dcond, e, uwk, hop)


class CondUpsample(torch.autograd.Function):
    """cond from (e, uwk, ub); the backward is the kernel's too."""

    @staticmethod
    def forward(ctx, e, uwk, ub, hop):
        ctx.hop = hop
        ctx.ub_shape, ctx.ub_dtype = ub.shape, ub.dtype
        ctx.save_for_backward(e, uwk)
        return cond_forward(e, uwk, ub, hop)

    @staticmethod
    def backward(ctx, dcond):
        e, uwk = ctx.saved_tensors
        de, duw, dub = cond_backward(dcond, e, uwk, ctx.hop)
        return (de.to(e.dtype), duw.to(uwk.dtype),
                dub.reshape(ctx.ub_shape).to(ctx.ub_dtype), None)


def cond_upsample(e, uwk, ub, hop: int) -> torch.Tensor:
    """The upsampler's audio-rate condition ``[B, Tl·hop, d]`` from latent
    frames ``e [B, Tl, d]`` (``uwk``, ``ub`` from ``pack_upsampler``)."""
    return CondUpsample.apply(e, uwk, ub, hop)


# ---------------------------------------------------------------------------
# the dot and reshape probes: the three contractions, the time-axis
# overlap-add, the layouts and the composition, through the upsampler's
# routines.  Each has its plain version (``*_plain``), its kernel
# (``*_kernel``) and the dispatch by device.
# ---------------------------------------------------------------------------


def tap_product_plain(e, W) -> torch.Tensor:
    """``einsum("nd,rde->nre")``: e ``[N, d]``, W ``[hop, d, d]`` ->
    ``[N, hop, d]`` in e's dtype, float32 sums (the tap product with the
    overlap-add off)."""
    return torch.einsum("nd,rde->nre", e.float(),
                        W.to(e.dtype).float()).to(e.dtype)


def tap_product_kernel(e, W) -> torch.Tensor:
    N, d = e.shape
    hop = W.shape[0]
    _check(e.dtype, e, W)
    _check_width(d)
    if tuple(W.shape) != (hop, d, d):
        raise ValueError(f"W must be [hop, {d}, {d}], got {tuple(W.shape)}")
    e, W = e.contiguous(), W.to(e.dtype).contiguous()
    out = torch.empty(N, hop, d, dtype=e.dtype, device=e.device)
    _call("vqvae_dot_nre", "probe_dot", _CDTYPE[e.dtype], N, hop, d,
          e.data_ptr(), W.data_ptr(), out.data_ptr(), _stream(e))
    return out


def tap_adjoint_plain(dp, W) -> torch.Tensor:
    """``einsum("nrd,rde->ne")``: dp ``[N, hop, d]`` (rounded to W's
    dtype), W ``[hop, d, d]`` -> float32 ``[N, d]`` (the upsampler's
    de)."""
    return torch.einsum("nrd,rde->ne", dp.to(W.dtype).float(), W.float())


def tap_adjoint_kernel(dp, W) -> torch.Tensor:
    N, hop, d = dp.shape
    _check(W.dtype, dp, W)
    if tuple(W.shape) != (hop, d, d):
        raise ValueError(f"W must be [{hop}, {d}, {d}]")
    dp, W = dp.float().contiguous(), W.contiguous()
    out = torch.empty(N, d, dtype=torch.float32, device=dp.device)
    part = _scratch("dot_ne", N, hop, d, device=dp.device)
    _call("vqvae_dot_ne", "probe_dot", _CDTYPE[W.dtype], N, hop, d,
          dp.data_ptr(), W.data_ptr(), out.data_ptr(), part.data_ptr(),
          part.numel(), _stream(dp))
    return out


def tap_wgrad_plain(e, dp) -> torch.Tensor:
    """``einsum("nd,nre->dre")``: e ``[N, d]``, dp ``[N, hop, d]``
    (rounded to e's dtype) -> float32 ``[d, hop, d]`` (the upsampler's
    duw)."""
    return torch.einsum("nd,nre->dre", e.float(), dp.to(e.dtype).float())


def tap_wgrad_kernel(e, dp) -> torch.Tensor:
    N, hop, d = dp.shape
    _check(e.dtype, e, dp)
    if tuple(e.shape) != (N, d):
        raise ValueError(f"e must be [{N}, {d}]")
    e, dp = e.contiguous(), dp.float().contiguous()
    out = torch.empty(d, hop, d, dtype=torch.float32, device=e.device)
    part = _scratch("dot_dre", N, hop, d, device=e.device)
    _call("vqvae_dot_dre", "probe_dot", _CDTYPE[e.dtype], N, hop, d,
          e.data_ptr(), dp.data_ptr(), out.data_ptr(), part.data_ptr(),
          part.numel(), _stream(e))
    return out


def overlap_add_plain(x, hop: int) -> torch.Tensor:
    """The probe's pad/add/slice on the time axis of x ``[T, d]``:
    ``(pad(x, (0, hop)) + pad(x, (hop, 0)))[hop/2 : hop/2 + T]``, summed
    in float32, in x's dtype (the upsampler's overlap-add with frames of
    ``hop`` rows)."""
    T = x.shape[0]
    y = F.pad(x.float(), (0, 0, 0, hop)) + F.pad(x.float(), (0, 0, hop, 0))
    return y[hop // 2: hop // 2 + T].to(x.dtype)


def overlap_add_kernel(x, hop: int) -> torch.Tensor:
    T, d = x.shape
    _check(x.dtype, x)
    x = x.contiguous()
    y = torch.empty_like(x)
    _call("vqvae_ola", "probe_dot", _CDTYPE[x.dtype], T, hop, hop // 2, d,
          x.data_ptr(), y.data_ptr(), _stream(x))
    return y


def relayout_plain(x, shape) -> torch.Tensor:
    """``x.reshape(shape)`` as a new tensor."""
    return x.reshape(tuple(shape)).clone()


def relayout_kernel(x, shape, counter: str = "probe_reshape"
                    ) -> torch.Tensor:
    """The same, copied through a shared-memory tile read in x's shape
    and written in ``shape`` (float32, rank 2 or 3)."""
    shape = tuple(shape)
    if x.dtype != torch.float32:
        raise TypeError("relayout takes float32")
    if x.dim() not in (2, 3) or len(shape) not in (2, 3) or \
            x.numel() != torch.Size(shape).numel():
        raise ValueError(f"relayout takes rank 2 or 3 of one size, got "
                         f"{tuple(x.shape)} -> {shape}")
    _check(x.dtype, x)
    x = x.contiguous()
    y = torch.empty(shape, dtype=x.dtype, device=x.device)
    dims_in = (ctypes.c_int * 3)(*x.shape)
    dims_out = (ctypes.c_int * 3)(*shape)
    _call("vqvae_relayout", counter, x.dim(), dims_in, len(shape), dims_out,
          x.data_ptr(), y.data_ptr(), _stream(x))
    return y


def compose_plain(x, w, v, hop: int) -> torch.Tensor:
    """``((x @ w).reshape(N·hop, d)) @ v`` in float32: x ``[N, d]``, w
    ``[d, hop·d]``, v ``[d, E]`` -> ``[N·hop, E]``."""
    N, d = x.shape
    return (x.float() @ w.float()).reshape(N * hop, d) @ v.float()


def compose_kernel(x, w, v, hop: int) -> torch.Tensor:
    """The same in one kernel; the ``[N, hop·d]`` intermediate stays in
    shared memory."""
    N, d = x.shape
    E = v.shape[1]
    _check(torch.float32, x, w, v)
    if tuple(w.shape) != (d, hop * d) or v.shape[0] != d:
        raise ValueError(f"w must be [{d}, {hop * d}] and v [{d}, E]")
    x, w, v = (t.float().contiguous() for t in (x, w, v))
    out = torch.empty(N * hop, E, dtype=torch.float32, device=x.device)
    _call("vqvae_compose", "probe_compose", N, hop, d, E, x.data_ptr(),
          w.data_ptr(), v.data_ptr(), out.data_ptr(), _stream(x))
    return out


def tap_product(e, W):
    return (tap_product_kernel if _on_card(e) else tap_product_plain)(e, W)


def tap_adjoint(dp, W):
    return (tap_adjoint_kernel if _on_card(dp) else tap_adjoint_plain)(dp, W)


def tap_wgrad(e, dp):
    return (tap_wgrad_kernel if _on_card(e) else tap_wgrad_plain)(e, dp)


def overlap_add(x, hop: int):
    return (overlap_add_kernel if _on_card(x) else overlap_add_plain)(x, hop)


def relayout(x, shape):
    return (relayout_kernel if _on_card(x) else relayout_plain)(x, shape)


def compose(x, w, v, hop: int):
    return (compose_kernel if _on_card(x) else compose_plain)(x, w, v, hop)

"""The upsampler computed from latent frames, forward and backward: the
CUDA kernels ``csrc/upsample.cu`` and their plain PyTorch versions (port
of ``scripts/cond_inkernel_probe.py``'s ``_cond_fwd_body`` and
``_cond_bwd_body``), with the kernels of the layout and contraction
probes (``scripts/mosaic_dot_probe.py``,
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

The kernels compute one product over output frames (``frame_rows``,
``frame_values``, ``tap_weight``): the forward's blocks each keep a slice
of ``US`` columns of the packed weight in shared memory
(``tap_slices``); the backward splits its frame rows into runs and its
columns into clusters of slices, and adds the partial sums in a fixed
order (``bwd_split``; ``cond_bwd_partitioned`` is that order in plain
PyTorch).

``cond_upsample`` is a ``torch.autograd.Function``.  Every wrapper here
runs the plain version for CPU tensors and launches its kernel (or
raises) for CUDA tensors; ``launches`` counts kernel calls by name.  The
probes' functions (``tap_product``, ``tap_adjoint``, ``tap_wgrad``,
``overlap_add``, ``relayout``, ``compose``) keep the JAX probes' shapes:
``W [hop, d, d]``, ``dp [N, hop, d]``; ``tap_adjoint_split`` is the order
in which its kernel splits and adds ``nrd,rde->ne``, in plain PyTorch.
"""

from __future__ import annotations

import ctypes
import math

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
# the kernels' frame product and partition, in plain PyTorch
# (csrc/upsample.cu, "Frames"; the CPU tests hold these against the plain
# versions above)
# ---------------------------------------------------------------------------

US = 128   # columns of W a kernel block keeps in shared memory
UR = 64    # frame rows a tile; the backward's runs are multiples of it
UCS = 4    # the backward's blocks a cluster


def tap_weight(uwk, hop: int) -> torch.Tensor:
    """W ``[2d, hop·d]`` with ``W[k, n] = uwk[k % d, (k // d)·hop·d + n]``:
    the weight of the frame product (rows k < d meet e[u], the others
    e[u-1])."""
    d = uwk.shape[0]
    return torch.cat([uwk[:, :hop * d], uwk[:, hop * d:]], 0)


def tap_slices(uwk, hop: int) -> torch.Tensor:
    """``[ceil(hop·d / US), 2d, US]``: slice s holds W's columns s·US ...
    (0 past hop·d), what a kernel block keeps in shared memory."""
    W = tap_weight(uwk, hop)
    K2, N = W.shape
    ns = -(-N // US)
    return F.pad(W, (0, ns * US - N)).reshape(K2, ns, US).permute(1, 0, 2)


def frame_rows(e) -> torch.Tensor:
    """A ``[B·(Tl+1), 2d]``: row b·(Tl+1) + u is [e[b, u], e[b, u-1]], a
    frame outside [0, Tl) read as 0."""
    B, Tl, d = e.shape
    z = e.new_zeros(B, 1, d)
    return torch.cat([torch.cat([e, z], 1), torch.cat([z, e], 1)],
                     2).reshape(B * (Tl + 1), 2 * d)


def frame_values(x, hop: int) -> torch.Tensor:
    """D ``[B·(Tl+1), hop·d]`` from x ``[B, Tl·hop, d]``: row b·(Tl+1) + u
    holds rows u·hop - hop/2 + j, j < hop, of x[b] (0 outside it)."""
    B, T, d = x.shape
    return F.pad(x, (0, 0, hop // 2, hop - hop // 2)).reshape(
        B * (T // hop + 1), hop * d)


def cond_fwd_frames(e, uwk, ub, hop: int) -> torch.Tensor:
    """cond as the forward kernel computes it: D = A W + ub (float32
    sums), cropped, rounded once to e's dtype."""
    B, Tl, d = e.shape
    D = _mm(frame_rows(e), tap_weight(uwk.to(e.dtype), hop)) + \
        ub.float().reshape(d).repeat(hop)
    return D.reshape(B, (Tl + 1) * hop, d)[
        :, hop // 2: hop // 2 + Tl * hop].to(e.dtype)


def bwd_split(B: int, Tl: int, hop: int, d: int, sms: int = 132,
              clusters: int | None = None):
    """The backward kernel's split (``csrc/upsample.cu::bwd_split``):
    (blocks a cluster, column groups, runs, frame rows a run) on a card
    of ``sms`` SMs that holds ``clusters`` clusters at once."""
    N, M = hop * d, B * (Tl + 1)
    nslices = -(-N // US)
    cs = min(UCS, nslices)
    ngroups, ntiles = -(-nslices // cs), -(-M // UR)
    clusters = sms if clusters is None else clusters
    nruns = min(max(1, min(clusters, sms // cs) // ngroups), ntiles)
    per = -(-ntiles // nruns)
    return cs, ngroups, -(-ntiles // per), per * UR


def bwd_scratch(B: int, Tl: int, hop: int, d: int, sms: int = 132) -> int:
    """Float32 values of the backward's partials at that split: the runs'
    dW and column sums, the column groups' X."""
    _, ngroups, nruns, _ = bwd_split(B, Tl, hop, d, sms)
    N, K2 = hop * d, 2 * d
    return nruns * K2 * N + ngroups * B * (Tl + 1) * K2 + nruns * N


def cond_bwd_partitioned(dcond, e, uwk, hop: int, sms: int = 132):
    """(de, duw, dub) as the backward kernels split and add them: each
    block (run, slice) the products of its rows and columns, its
    cluster's X added in rank order, then the runs' dW and the groups' X
    in order, the column sums by a warp's lanes and its shuffle tree
    (float32; D rounded to e's dtype once)."""
    B, Tl, d = e.shape
    N, M, K2 = hop * d, B * (Tl + 1), 2 * d
    cs, ngroups, nruns, rpr = bwd_split(B, Tl, hop, d, sms)
    Dr = frame_values(dcond.float(), hop)
    Dc = Dr.to(e.dtype).float()
    A = frame_rows(e).float()
    W = tap_weight(uwk.to(e.dtype), hop).float()
    dwp = Dr.new_zeros(nruns, K2, N)
    dubp = Dr.new_zeros(nruns, N)
    xp = Dr.new_zeros(ngroups, M, K2)
    for run in range(nruns):
        rows = slice(run * rpr, min(M, (run + 1) * rpr))
        for grp in range(ngroups):
            x = None
            for rank in range(cs):
                cols = slice((grp * cs + rank) * US,
                             min(N, (grp * cs + rank + 1) * US))
                if cols.start >= N:
                    continue
                dwp[run, :, cols] = A[rows].T @ Dc[rows, cols]
                dubp[run, cols] = Dr[rows, cols].sum(0)
                part = Dc[rows, cols] @ W[:, cols].T
                x = part if x is None else x + part
            xp[grp, rows] = x
    dw, X = dwp[0], xp[0]
    for run in range(1, nruns):
        dw = dw + dwp[run]
    for grp in range(1, ngroups):
        X = X + xp[grp]
    X = X.reshape(B, Tl + 1, K2)
    de = X[:, :Tl, :d] + X[:, 1:, d:]
    # dub: lane l of a warp sums runs, then hop offsets l, l + 32, ...;
    # then the shuffle tree (xor 16, 8, 4, 2, 1)
    lanes = []
    for lane in range(32):
        s = Dr.new_zeros(d)
        for run in range(nruns):
            for j in range(lane, hop, 32):
                s = s + dubp[run, j * d:(j + 1) * d]
        lanes.append(s)
    for o in (16, 8, 4, 2, 1):
        lanes = [lanes[i] + lanes[i ^ o] for i in range(32)]
    return de, torch.cat([dw[:d], dw[d:]], 1), lanes[0]


# ---------------------------------------------------------------------------
# CUDA kernels
# ---------------------------------------------------------------------------

_lib = None
_fns: dict = {}   # entry points of the library, looked up once each


def _library():
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build("vqvae_upsample", ["upsample.cu"])))
        p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        sigs = {
            "vqvae_cond_fwd": [i] * 5 + [p] * 5,
            "vqvae_cond_bwd": [i] * 5 + [p] * 7 + [ll, p, p],
            "vqvae_dot_nre": [i] * 4 + [p] * 4,
            "vqvae_dot_ne": [i] * 4 + [p] * 4,
            "vqvae_dot_dre": [i] * 4 + [p] * 4,
            "vqvae_ola": [i] * 5 + [p] * 3,
            "vqvae_relayout": [ll, p, p, p],
            "vqvae_compose": [i] * 4 + [p] * 5,
        }
        for name, args in sigs.items():
            fn = getattr(lib, name)
            fn.argtypes = args
            fn.restype = i
        lib.vqvae_cond_bwd_scratch.argtypes = [i] * 4
        lib.vqvae_cond_bwd_scratch.restype = ll
        _lib = lib
    return _lib


def _stream(t: torch.Tensor) -> int:
    return torch._C._cuda_getCurrentRawStream(t.get_device())


def _scratch(name: str, *shape: int, device) -> torch.Tensor:
    """The float32 scratch an entry point needs, sized by the kernel
    library's own split policy (``vqvae_<name>_scratch``)."""
    cap = getattr(_library(), f"vqvae_{name}_scratch")(*shape)
    return torch.empty(cap, dtype=torch.float32, device=device)


def _call(name: str, counter: str, *args) -> None:
    """One ctypes call of an entry point on the current stream, counted
    as one launch of ``counter``; the host path of every probe kernel."""
    fn = _fns.get(name)
    if fn is None:
        fn = _fns[name] = getattr(_library(), name)
    err = fn(*args)
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


def _aligned(t: torch.Tensor) -> torch.Tensor:
    """t contiguous at a 16-byte aligned address (the kernels copy 16
    bytes at a time)."""
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


def cond_fwd_kernel(e, uwk, ub, hop: int) -> torch.Tensor:
    """The kernel's cond; see ``cond_fwd_plain``."""
    B, Tl, d = e.shape
    _check(e.dtype, e, uwk, ub)
    _check_width(d)
    if tuple(uwk.shape) != (d, 2 * hop * d) or ub.numel() != d or hop % 2:
        raise ValueError(f"uwk must be [{d}, {2 * hop * d}] and ub [{d}] "
                         f"with an even hop, got {tuple(uwk.shape)}, "
                         f"{tuple(ub.shape)}, hop {hop}")
    e = _aligned(e)
    uwk = _aligned(uwk.to(e.dtype))
    ub = ub.float().reshape(d).contiguous()
    cond = torch.empty(B, Tl * hop, d, dtype=e.dtype, device=e.device)
    _call("vqvae_cond_fwd", "cond_fwd", _CDTYPE[e.dtype], B, Tl, hop, d,
          e.data_ptr(), uwk.data_ptr(), ub.data_ptr(), cond.data_ptr(),
          _stream(e))
    return cond


def _cond_bwd_call(dcond, e, uwk, hop: int, events=None):
    """One call of the backward's two kernels (``events``: four CUDA
    events recorded around them, see ``cond_bwd_split_ms``)."""
    B, Tl, d = e.shape
    _check(e.dtype, dcond, e, uwk)
    _check_width(d)
    if tuple(dcond.shape) != (B, Tl * hop, d) or hop % 2 or \
            tuple(uwk.shape) != (d, 2 * hop * d):
        raise ValueError(f"dcond must be {(B, Tl * hop, d)} and uwk "
                         f"[{d}, {2 * hop * d}], got {tuple(dcond.shape)}, "
                         f"{tuple(uwk.shape)}")
    f32 = torch.float32
    dcond = _aligned(dcond.to(f32))
    e = _aligned(e)
    uwk = _aligned(uwk.to(e.dtype))
    de = torch.empty(B, Tl, d, dtype=f32, device=e.device)
    duw = torch.empty(d, 2 * hop * d, dtype=f32, device=e.device)
    dub = torch.empty(d, dtype=f32, device=e.device)
    part = _scratch("cond_bwd", B, Tl, hop, d, device=e.device)
    ev = None
    if events is not None:
        ev = (ctypes.c_void_p * len(events))(*(x.cuda_event for x in events))
    err = _library().vqvae_cond_bwd(
        _CDTYPE[e.dtype], B, Tl, hop, d, dcond.data_ptr(), e.data_ptr(),
        uwk.data_ptr(), de.data_ptr(), duw.data_ptr(), dub.data_ptr(),
        part.data_ptr(), part.numel(), _stream(e), ev)
    if err != 0:
        raise RuntimeError(f"vqvae_cond_bwd failed: error {err} (-2: shapes "
                           f"the kernel does not take; -3: no cluster fits)")
    return de, duw, dub


def cond_bwd_kernel(dcond, e, uwk, hop: int):
    """The kernels' (de, duw, dub); see ``cond_bwd_plain``."""
    out = _cond_bwd_call(dcond, e, uwk, hop)
    launches["cond_bwd"] += 1
    return out


def cond_bwd_split_ms(dcond, e, uwk, hop: int) -> dict:
    """Milliseconds of one backward call by launch, from CUDA events
    recorded around them: ``tiles`` (the pass over dcond) and ``reduce``
    (the partial sums added).  A measurement: not counted as a launch."""
    events = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
    for x in events:   # torch creates an event's handle at its first record
        x.record()
    _cond_bwd_call(dcond, e, uwk, hop, events)
    torch.cuda.synchronize(e.device)
    return {"tiles": events[0].elapsed_time(events[1]),
            "reduce": events[2].elapsed_time(events[3])}


def _on_card(t: torch.Tensor) -> bool:
    if t.is_cuda:
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
# overlap-add, the layouts and the composition, each its own kernel of
# csrc/upsample.cu.  Each has its plain version (``*_plain``), its kernel
# (``*_kernel``, one ctypes call after its checks) and the dispatch by
# device.
# ---------------------------------------------------------------------------


def tap_product_plain(e, W) -> torch.Tensor:
    """``einsum("nd,rde->nre")``: e ``[N, d]``, W ``[hop, d, d]`` ->
    ``[N, hop, d]`` in e's dtype, float32 sums (the tap product with the
    overlap-add off)."""
    return torch.einsum("nd,rde->nre", e.float(),
                        W.to(e.dtype).float()).to(e.dtype)


def _check_dot(d: int) -> None:
    if d % 8 or not 8 <= d <= 256:
        raise ValueError(f"the dot probe's kernels take widths 8..256 in "
                         f"steps of 8, got {d}")


def tap_product_kernel(e, W) -> torch.Tensor:
    """The kernel's ``nd,rde->nre`` (one launch); see
    ``tap_product_plain``."""
    N, d = e.shape
    hop = W.shape[0]
    _check(e.dtype, e, W)
    _check_dot(d)
    if tuple(W.shape) != (hop, d, d):
        raise ValueError(f"W must be [hop, {d}, {d}], got {tuple(W.shape)}")
    e, W = _aligned(e), _aligned(W.to(e.dtype))
    out = torch.empty(N, hop, d, dtype=e.dtype, device=e.device)
    _call("vqvae_dot_nre", "probe_dot", _CDTYPE[e.dtype], N, hop, d,
          e.data_ptr(), W.data_ptr(), out.data_ptr(), _stream(e))
    return out


def tap_adjoint_plain(dp, W) -> torch.Tensor:
    """``einsum("nrd,rde->ne")``: dp ``[N, hop, d]`` (rounded to W's
    dtype), W ``[hop, d, d]`` -> float32 ``[N, d]`` (the upsampler's
    de)."""
    return torch.einsum("nrd,rde->ne", dp.to(W.dtype).float(), W.float())


# the nrd,rde->ne kernel's split (csrc/upsample.cu, dot_ne)
NE_CS = 8     # blocks a cluster: K = hop·d in NE_CS ranges
NE_KB = 512   # values of K a block stages at once
NE_KS = 16    # values of K of a stage one thread sums (NE_KB / NE_KS
              # sub-ranges a stage)


def tap_adjoint_split(dp, W) -> torch.Tensor:
    """``nrd,rde->ne`` as the kernel splits and adds it, in plain
    PyTorch: K = hop·d in ``NE_CS`` ranges of ``kc`` (rank q's); in a
    rank, stages of ``NE_KB`` values cut into sub-ranges of ``NE_KS``,
    sub-range s summing its values of every stage; the rank's sum adds
    its sub-ranges in order, and the ranks are added in rank order
    (float32)."""
    N, hop, d = dp.shape
    K = hop * d
    A = dp.to(W.dtype).float().reshape(N, K)
    B = W.float().reshape(K, d)
    kc = -(-(-(-K // NE_CS)) // 8) * 8
    total = None
    for q in range(NE_CS):
        k0, k1 = q * kc, min(K, (q + 1) * kc)
        rank = None
        for s in range(NE_KB // NE_KS):
            ks = [k for kb in range(k0, k1, NE_KB)
                  for k in range(kb + s * NE_KS, kb + (s + 1) * NE_KS)
                  if k < k1]
            part = A[:, ks] @ B[ks] if ks else A.new_zeros(N, d)
            rank = part if rank is None else rank + part
        total = rank if total is None else total + rank
    return total


def tap_adjoint_kernel(dp, W) -> torch.Tensor:
    """The kernel's ``nrd,rde->ne`` (one launch, no scratch); see
    ``tap_adjoint_plain``."""
    N, hop, d = dp.shape
    _check(W.dtype, dp, W)
    _check_dot(d)
    if tuple(W.shape) != (hop, d, d):
        raise ValueError(f"W must be [{hop}, {d}, {d}]")
    dp, W = _aligned(dp.float()), _aligned(W)
    out = torch.empty(N, d, dtype=torch.float32, device=dp.device)
    _call("vqvae_dot_ne", "probe_dot", _CDTYPE[W.dtype], N, hop, d,
          dp.data_ptr(), W.data_ptr(), out.data_ptr(), _stream(dp))
    return out


def tap_wgrad_plain(e, dp) -> torch.Tensor:
    """``einsum("nd,nre->dre")``: e ``[N, d]``, dp ``[N, hop, d]``
    (rounded to e's dtype) -> float32 ``[d, hop, d]`` (the upsampler's
    duw)."""
    return torch.einsum("nd,nre->dre", e.float(), dp.to(e.dtype).float())


def tap_wgrad_kernel(e, dp) -> torch.Tensor:
    """The kernel's ``nd,nre->dre`` (one launch, no scratch, the N rows
    summed in order); see ``tap_wgrad_plain``."""
    N, hop, d = dp.shape
    _check(e.dtype, e, dp)
    _check_dot(d)
    if tuple(e.shape) != (N, d):
        raise ValueError(f"e must be [{N}, {d}]")
    e, dp = _aligned(e), _aligned(dp.float())
    out = torch.empty(d, hop, d, dtype=torch.float32, device=e.device)
    _call("vqvae_dot_dre", "probe_dot", _CDTYPE[e.dtype], N, hop, d,
          e.data_ptr(), dp.data_ptr(), out.data_ptr(), _stream(e))
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
    """The kernel's overlap-add (one launch); float32 is bit-equal to
    ``overlap_add_plain``."""
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
    """The same by the flat 16-byte copy of ``csrc/upsample.cu`` (float32,
    rank 2 or 3 on both sides).  A reshape keeps the flat order, so only
    the sizes cross to the kernel; the host path is kept to one ctypes
    call after these checks."""
    shape = tuple(shape)
    if x.dtype != torch.float32:
        raise TypeError("relayout takes float32")
    n = x.numel()
    if x.dim() not in (2, 3) or len(shape) not in (2, 3) or \
            n != math.prod(shape):
        raise ValueError(f"relayout takes rank 2 or 3 of one size, got "
                         f"{tuple(x.shape)} -> {shape}")
    if not x.is_cuda:
        raise ValueError(f"relayout_kernel takes a CUDA tensor, got "
                         f"{x.device}")
    x = x.contiguous()
    y = x.new_empty(shape)
    _call("vqvae_relayout", counter, n, x.data_ptr(), y.data_ptr(),
          _stream(x))
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

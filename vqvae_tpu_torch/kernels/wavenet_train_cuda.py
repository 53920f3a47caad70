"""Fused gated-residual training chunk: the CUDA kernels
``csrc/wavenet_train.cu`` and their plain PyTorch versions (port of
``vqvae_tpu/kernels/wavenet_train_pallas.py``: the forward and the
save-gates, recompute and time-windowed backwards).

A chunk runs up to ``MAX_CHUNK_LAYERS`` layers of the decoder stack.
Per layer, at the TPU kernel's rounding points (cdt = compute dtype):

* ``u = [h(t-dil) | h(t)] @ wff + cond @ vc + gc``      float32
* ``ta = tanh(u_a)``, ``sb = sigmoid(u_b)``; ``z = cdt(ta·sb)``
* the gate halves ``gall[:, l] = cdt([ta | sb])``
* ``h = (h + cdt(z @ wr)) + br``                        two cdt adds
* ``skips += z @ ws``                                   float32

The skip sum starts from the summed skip bias (the first chunk) or from
the previous chunk's skips (``acc``), and rounds to cdt once, at the
end.  The ``embed`` variant computes the chunk input from the ids:
``h0[t] = cdt(w1[ids[t]] + w0[ids[t-1]] + b)``, one float32 sum and one
cast (``w0[·]`` is 0 at t=0).

Three backwards (``_bwd_kernel`` and ``_bwd_kernel_windowed``):

* save-gates (``decoder_kernel="pallas_sg"``): the forward keeps the
  gate halves; pass 1 replays the residual chain from them, with
  ``z = cdt(g_a·g_b)`` as a product of the two rounded halves (not the
  forward's ``cdt(ta·sb)``).
* recompute (``"pallas"``): the forward keeps only its inputs; pass 1
  recomputes every layer exactly as the forward does (so the layer
  inputs equal the forward's bit for bit) and keeps the rounded gate
  halves for pass 2.
* time-windowed recompute (``bwd_windows > 1``, not for the embed
  chunk): the recompute over right-to-left windows of ``Tc = T / nT``
  steps, each with a halo of ``A = sum(dils)`` (rounded up to 8) steps
  before it, h masked to an exact 0 before the sequence start, and a
  carry of ``dph_a`` from the window to the right.

Pass 2 then walks the layers in reverse from the rounded gate halves
(``z = cdt(g_a·g_b)``); dh stays float32 and every weight gradient sums
over all B·T rows in float32.  The embedding-table gradient is a
gather/scatter of ``cdt(dh)`` by id.  Gradients leave in the input
dtypes, as ``_chunk_grads`` casts them.

``Chunk`` is a ``torch.autograd.Function``: CPU tensors run the plain
versions, CUDA tensors launch the kernels or raise.  Each kernel call
adds one to its count: ``launches_fwd`` (chunk forward),
``launches_bwd`` (save-gates backward), ``launches_bwd_rec`` (recompute
backward), ``launches_bwd_win`` (windowed backward).
"""

from __future__ import annotations

import ctypes
from typing import Sequence

import torch
import torch.utils.checkpoint

from vqvae_tpu_torch.kernels.build import build

MAX_CHUNK_LAYERS = 10
SEED, ACC, EMBED = 0, 1, 2

launches_fwd = 0       # chunk-forward kernel calls in this process
launches_bwd = 0       # save-gates backward kernel calls
launches_bwd_rec = 0   # recompute backward kernel calls
launches_bwd_win = 0   # windowed backward kernel calls

_CDTYPE = {torch.float32: 0, torch.bfloat16: 1}


def _shift_right(x: torch.Tensor, n: int) -> torch.Tensor:
    """``[B, T, C]`` shifted right along T by n, zero-filled."""
    if n == 0:
        return x
    return torch.nn.functional.pad(x, (0, 0, n, 0))[:, :x.shape[1]]


def _shift_left(x: torch.Tensor, n: int) -> torch.Tensor:
    if n == 0:
        return x
    return torch.nn.functional.pad(x, (0, 0, 0, n))[:, n:]


def window_geometry(T: int, n_windows: int, dils: Sequence[int]):
    """(Tc, A, W) of the windowed backward: window length ``T / nT``,
    halo ``sum(dils)`` rounded up to 8, extended window ``Tc + A``.
    Raises ``ValueError`` where the JAX kernel asserts."""
    if n_windows < 2 or T % n_windows:
        raise ValueError(f"bwd_windows={n_windows} must be >= 2 and divide "
                         f"the length T={T}")
    Tc = T // n_windows
    if Tc % 8 or Tc < max(dils):
        raise ValueError(f"bwd_windows={n_windows}: the window length "
                         f"{Tc} must be a multiple of 8 and >= the largest "
                         f"dilation {max(dils)}")
    A = -(-sum(dils) // 8) * 8
    return Tc, A, Tc + A


# ---------------------------------------------------------------------------
# plain version
# ---------------------------------------------------------------------------


def embed_h(ids: torch.Tensor, wemb: torch.Tensor, bemb: torch.Tensor
            ) -> torch.Tensor:
    """``h0 [B, T, R] = cdt(w1[ids[t]] + w0[ids[t-1]] + b)``: one
    float32 sum, one cast."""
    ids = ids.long()
    w = wemb.float()
    h = w[1][ids] + _shift_right(w[0][ids], 1)
    return (h + bemb.float().reshape(-1)).to(wemb.dtype)


def _layer_u(h, condf, gc_l, wff_l, vc_l, dil):
    ph = torch.cat([_shift_right(h, dil), h], -1).float()
    return ph @ wff_l.float() + condf @ vc_l.float() + gc_l.float()[:, None]


def _residual(h, z, wr_l, br_l):
    return (h + (z.float() @ wr_l.float()).to(h.dtype)) + br_l


def _chain(dils, h, cond, gc, wff, vc, wr, br, ws=None, skips=None,
           neg=None):
    """The forward's layer chain from the chunk input h: (every layer's
    input, gate halves ``[B, nl, T, 2R]``, h_out, float32 skips).  The
    skip sum runs when ``skips`` is given; ``neg`` ``[1, T, 1]`` marks
    rows whose h is an exact 0 (before the sequence start)."""
    cdt = h.dtype
    R = h.shape[-1]
    condf = cond.float()
    hall, gall = [], []
    for li, dil in enumerate(dils):
        hall.append(h)
        u = _layer_u(h, condf, gc[:, li], wff[li], vc[li], dil)
        ta, sb = torch.tanh(u[..., :R]), torch.sigmoid(u[..., R:])
        z = (ta * sb).to(cdt)
        gall.append(torch.cat([ta, sb], -1).to(cdt))
        h = _residual(h, z, wr[li], br[li])
        if neg is not None:
            h = h.masked_fill(neg, 0)
        if skips is not None:
            skips = skips + z.float() @ ws[li].float()
    return hall, torch.stack(gall, 1), h, skips


def fwd_plain(dils: Sequence[int], h, cond, gc, wff, vc, wr, br, ws, tail,
              acc: bool):
    """(h_out, skips, gall ``[B, nl, T, 2R]``) of one chunk, from the
    chunk input h ``[B, T, R]``."""
    B, T, _ = h.shape
    skips = (tail.float() if acc else
             tail.float().reshape(1, 1, -1).expand(B, T, -1))
    _, gall, h, skips = _chain(dils, h, cond, gc, wff, vc, wr, br, ws, skips)
    return h, skips.to(h.dtype), gall


def _sweep_plain(dils, hall, cond, wff, vc, wr, ws, gall, dhout, dskips,
                 hoff=0, spill=None):
    """Pass 2, the reverse sweep: float32 (dh, dcond, dgc, dwff, dvc,
    dwr, dbr, dws) over the Tn rows of dhout.  ``hall[li]`` holds layer
    li's input with those rows at offset ``hoff`` (and the rows before
    them that the causal shift reads); ``cond`` and ``gall`` hold just
    the rows.  With ``spill`` (``[nl, B, Dmax, R]``, updated in place)
    the shift takes the last rows' ``dph_a`` from the window to the
    right and leaves this window's first rows for the one to the left."""
    cdt = hall[0].dtype
    B, Tn, R = dhout.shape
    nl = len(dils)
    f = torch.float32
    dev = dhout.device
    dh = dhout.float()
    dsk = dskips.to(cdt).float().reshape(B * Tn, -1)
    condf = cond.float()
    dcond = torch.zeros(condf.shape, dtype=f, device=dev)
    dgc = torch.zeros((B, nl, 2 * R), dtype=f, device=dev)
    dwff, dvc, dwr, dbr, dws = [], [], [], [], []
    for li in reversed(range(nl)):
        dil = dils[li]
        hin = hall[li]
        ph = torch.cat([_shift_right(hin, dil)[:, hoff:], hin[:, hoff:]],
                       -1).float()
        g = gall[:, li]
        ta, sb = g[..., :R].float(), g[..., R:].float()
        z = (ta * sb).to(cdt).float().reshape(B * Tn, R)
        dh_c = dh.to(cdt).float().reshape(B * Tn, R)
        dbr.append(dh.sum((0, 1)))
        dwr.append(z.T @ dh_c)
        dws.append(z.T @ dsk)
        dz = (dh_c @ wr[li].float().T + dsk @ ws[li].float().T
              ).reshape(B, Tn, R)
        du_g = torch.cat([dz * sb * (1.0 - ta * ta),
                          dz * ta * sb * (1.0 - sb)], -1)
        du = du_g.to(cdt).float()
        dgc[:, li] = du_g.sum(1)
        dwff.append(ph.reshape(B * Tn, -1).T @ du.reshape(B * Tn, -1))
        dvc.append(condf.reshape(B * Tn, -1).T @ du.reshape(B * Tn, -1))
        dcond = dcond + du @ vc[li].float().T
        dph = du @ wff[li].float().T
        dph_a = dph[..., :R]
        shifted = _shift_left(dph_a, dil)
        if spill is not None:
            shifted = shifted.clone()
            shifted[:, Tn - dil:] += spill[li, :, :dil]
            spill[li, :, :dil] = dph_a[:, :dil]
        dh = dh + dph[..., R:] + shifted

    def stack(xs):
        return torch.stack(xs[::-1])
    return (dh, dcond, dgc, stack(dwff), stack(dvc), stack(dwr), stack(dbr),
            stack(dws))


def bwd_plain(dils: Sequence[int], h0, cond, gc, wff, vc, wr, br, ws, gall,
              dhout, dskips):
    """Save-gates backward: float32 (dh, dcond, dgc, dwff, dvc, dwr,
    dbr, dws) of one chunk from its input h0 and the saved gates."""
    cdt = h0.dtype
    R = h0.shape[-1]
    hall, h = [], h0
    for li in range(len(dils)):     # pass 1: the residual chain only
        hall.append(h)
        g = gall[:, li]
        z = (g[..., :R].float() * g[..., R:].float()).to(cdt)
        h = _residual(h, z, wr[li], br[li])
    return _sweep_plain(dils, hall, cond, wff, vc, wr, ws, gall, dhout,
                        dskips)


def bwd_rec_plain(dils: Sequence[int], h0, cond, gc, wff, vc, wr, br, ws,
                  dhout, dskips):
    """Recompute backward: the same gradients with no saved gates; pass
    1 recomputes the forward's chain (its own rounding points)."""
    hall, gall, _, _ = _chain(dils, h0, cond, gc, wff, vc, wr, br)
    return _sweep_plain(dils, hall, cond, wff, vc, wr, ws, gall, dhout,
                        dskips)


def bwd_win_plain(dils: Sequence[int], n_windows: int, h0, cond, gc, wff,
                  vc, wr, br, ws, dhout, dskips):
    """Time-windowed recompute backward (port of ``_bwd_kernel_windowed``):
    the recompute over right-to-left windows with a ``sum(dils)`` halo;
    the same float32 gradients as ``bwd_rec_plain`` up to the order in
    which the weight gradients sum."""
    B, T, R = h0.shape
    nl = len(dils)
    Tc, A, W = window_geometry(T, n_windows, dils)
    f, dev = torch.float32, h0.device
    hpad = torch.nn.functional.pad(h0, (0, 0, A, 0))
    condpad = torch.nn.functional.pad(cond, (0, 0, A, 0))
    spill = torch.zeros((nl, B, max(dils), R), dtype=f, device=dev)
    dh = torch.empty((B, T, R), dtype=f, device=dev)
    dcond = torch.empty(cond.shape, dtype=f, device=dev)
    grads = None
    for j in range(n_windows):               # right to left
        t0 = (n_windows - 1 - j) * Tc
        neg = (torch.arange(W, device=dev) + (t0 - A) < 0)[None, :, None]
        hall, gall, _, _ = _chain(dils, hpad[:, t0:t0 + W],
                                  condpad[:, t0:t0 + W], gc, wff, vc, wr, br,
                                  neg=neg)
        out = _sweep_plain(dils, hall, cond[:, t0:t0 + Tc], wff, vc, wr, ws,
                           gall[:, :, A:], dhout[:, t0:t0 + Tc],
                           dskips[:, t0:t0 + Tc], hoff=A, spill=spill)
        dh[:, t0:t0 + Tc], dcond[:, t0:t0 + Tc] = out[0], out[1]
        grads = out[2:] if grads is None else tuple(
            a + b for a, b in zip(grads, out[2:]))
    return (dh, dcond) + grads


def embed_grads_plain(ids, dh, cdt, mu: int):
    """(dwemb ``[2, mu, R]``, dbemb ``[R]``) in float32 from float32
    dh: ``cdt(dh)`` summed by id (tap 1) and by the previous id (tap 0,
    no term at t=0); dbemb sums dh itself."""
    B, T, R = dh.shape
    ids = ids.long()
    dh_c = dh.to(cdt).float()
    taps = []
    for sel_ids, rows in ((ids[:, :-1], dh_c[:, 1:]), (ids, dh_c)):
        acc = torch.zeros((mu, R), dtype=torch.float32, device=dh.device)
        taps.append(acc.index_add_(0, sel_ids.reshape(-1),
                                   rows.reshape(-1, R)))
    return torch.stack(taps), dh.sum((0, 1))


# ---------------------------------------------------------------------------
# CUDA kernel
# ---------------------------------------------------------------------------

_lib = None


def _library():
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build("vqvae_wavenet_train",
                                    ["wavenet_train.cu"])))
        p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.vqvae_chunk_fwd.argtypes = [i] * 9 + [p] * 20
        lib.vqvae_chunk_bwd.argtypes = [i] * 9 + [p] * 23 + [ll] + [p] * 9
        lib.vqvae_chunk_bwd_rec.argtypes = ([i] * 9 + [p] * 26 + [ll]
                                            + [p] * 9)
        lib.vqvae_chunk_bwd_win.argtypes = ([i] * 7 + [p, i] + [p] * 22
                                            + [ll] + [p] * 9)
        for fn in (lib.vqvae_chunk_fwd, lib.vqvae_chunk_bwd,
                   lib.vqvae_chunk_bwd_rec, lib.vqvae_chunk_bwd_win):
            fn.restype = i
        _lib = lib
    return _lib


def _ptr(x):
    return None if x is None else x.data_ptr()


def _stream(dev):
    if dev.type != "cuda":
        return None
    return torch.cuda.current_stream(dev).cuda_stream


def _check(name, x, shape, dtype, dev):
    if (tuple(x.shape) != tuple(shape) or x.dtype != dtype
            or x.device != dev or not x.is_contiguous()):
        raise ValueError(f"chunk kernel: {name} must be {tuple(shape)} "
                         f"{dtype} contiguous on {dev}, got "
                         f"{tuple(x.shape)} {x.dtype} on {x.device}")


class _Shapes:
    """Sizes of one chunk call, checked against every tensor."""

    def __init__(self, dils, mode, x, wemb, cond, ws):
        self.embed = mode == EMBED
        self.cdt = wemb.dtype if self.embed else x.dtype
        if self.cdt not in _CDTYPE:
            raise TypeError(f"chunk kernel has no {self.cdt} instance")
        self.dev = cond.device
        if self.embed:
            (self.B, self.T), self.mu, self.R = x.shape, *wemb.shape[1:]
        else:
            (self.B, self.T, self.R), self.mu = x.shape, 0
        self.nl, self.d, self.S = len(dils), cond.shape[-1], ws.shape[-1]
        if (self.R % 32 or self.R > 64 or self.S > 256 or self.d > 64
                or not 1 <= self.nl <= MAX_CHUNK_LAYERS):
            raise ValueError(
                f"chunk kernel takes R in (32, 64), S <= 256, d <= 64 and "
                f"1..{MAX_CHUNK_LAYERS} layers; got R={self.R} S={self.S} "
                f"d={self.d} layers={self.nl}")
        if self.cdt == torch.bfloat16 and (self.S % 16 or self.d % 16):
            raise ValueError("chunk kernel (bfloat16) takes S and d in "
                             f"multiples of 16, got {self.S}, {self.d}")
        self.dils = (ctypes.c_int * self.nl)(*dils)

    def empty(self, *shape, dtype=None):
        return torch.empty(shape, dtype=dtype or self.cdt, device=self.dev)

    def check_weights(self, cond, gc, wff, vc, wr, br, ws):
        B, T, R, S, d, nl, c = (self.B, self.T, self.R, self.S, self.d,
                                self.nl, self.cdt)
        for name, x, shape in (
                ("cond", cond, (B, T, d)), ("gc", gc, (B, nl, 2 * R)),
                ("wff", wff, (nl, 2 * R, 2 * R)), ("vc", vc, (nl, d, 2 * R)),
                ("wr", wr, (nl, R, R)), ("br", br, (nl, R)),
                ("ws", ws, (nl, R, S))):
            _check(name, x, shape, c, self.dev)

    def ids(self, ids):
        ids = ids.to(self.dev, torch.int32).contiguous()
        _check("ids", ids, (self.B, self.T), torch.int32, self.dev)
        # an id outside the table would read outside it on the card
        if bool(((ids < 0) | (ids >= self.mu)).any()):
            raise ValueError(f"ids must lie in [0, {self.mu})")
        return ids

    def cotangents(self, dhout, dskips):
        dhout = dhout.to(self.cdt).contiguous()
        dskips = dskips.to(self.cdt).contiguous()
        _check("dhout", dhout, (self.B, self.T, self.R), self.cdt, self.dev)
        _check("dskips", dskips, (self.B, self.T, self.S), self.cdt,
               self.dev)
        return dhout, dskips

    def part_cap(self, rows):
        """float32 words of the split-K scratch for ``rows`` rows."""
        return max(1 << 22, (rows // 256 + self.B + 1) * 2 * self.R,
                   2 * self.mu * 16 * self.R)

    def grads(self):
        R, S, d, nl = self.R, self.S, self.d, self.nl
        shapes = dict(dgc=(self.B, nl, 2 * R), dwff=(nl, 2 * R, 2 * R),
                      dvc=(nl, d, 2 * R), dwr=(nl, R, R), dbr=(nl, R),
                      dws=(nl, R, S))
        return {k: self.empty(*v, dtype=torch.float32)
                for k, v in shapes.items()}


def fwd_kernel(dils, mode, x, wemb, bemb, cond, gc, wff, vc, wr, br, ws,
               tail, save_gates=True):
    """The kernel's (h_out, skips, gall); see ``fwd_plain``.  Without
    ``save_gates`` no gates are written and gall is None."""
    global launches_fwd
    sh = _Shapes(dils, mode, x, wemb, cond, ws)
    B, T, R, S, nl = sh.B, sh.T, sh.R, sh.S, sh.nl
    args = [t.contiguous() for t in (cond, gc, wff, vc, wr, br, ws)]
    sh.check_weights(*args)
    h = ids = None
    if sh.embed:
        ids = sh.ids(x)
        _check("wemb", wemb, (2, sh.mu, R), sh.cdt, sh.dev)
        bemb = bemb.reshape(-1).contiguous()
        _check("bemb", bemb, (R,), sh.cdt, sh.dev)
    else:
        h = x.contiguous()
    tail = tail.contiguous() if mode == ACC else tail.reshape(-1).contiguous()
    _check("tail", tail, (B, T, S) if mode == ACC else (S,), sh.cdt, sh.dev)
    h_out, skips = sh.empty(B, T, R), sh.empty(B, T, S)
    gall = sh.empty(B, nl, T, 2 * R) if save_gates else None
    skf = sh.empty(B, T, S if nl > 1 else 0, dtype=torch.float32)
    # every tensor the kernels touch stays referenced until the call ends
    tensors = [h, ids, wemb, bemb, *args, tail, sh.empty(B, T, R),
               sh.empty(B, T, R), skf, h_out, skips, gall]
    err = _library().vqvae_chunk_fwd(
        _CDTYPE[sh.cdt], mode, B, T, R, S, sh.d, sh.mu, nl, sh.dils,
        *map(_ptr, tensors), _stream(sh.dev))
    if err != 0:
        raise RuntimeError(f"chunk forward kernel failed: error {err}")
    launches_fwd += 1
    return h_out, skips, gall


def _lead(sh, x, bemb):
    """(h0, ids, bemb) as the backward kernels take them."""
    if sh.embed:
        return None, sh.ids(x), bemb.reshape(-1).contiguous()
    return x.contiguous(), None, bemb


def bwd_kernel(dils, mode, x, wemb, bemb, cond, gc, wff, vc, wr, br, ws,
               gall, dhout, dskips):
    """The save-gates kernel's float32 (dh, dcond, dgc, dwff, dvc, dwr,
    dbr, dws, dwemb, dbemb); dh is None with ``embed``, dwemb and dbemb
    without."""
    global launches_bwd
    sh = _Shapes(dils, mode, x, wemb, cond, ws)
    B, T, R, S, d, nl, mu = sh.B, sh.T, sh.R, sh.S, sh.d, sh.nl, sh.mu
    args = [t.contiguous() for t in (cond, gc, wff, vc, wr, br, ws)]
    sh.check_weights(*args)
    cond, gc, wff, vc, wr, br, ws = args
    h0, ids, bemb = _lead(sh, x, bemb)
    _check("gall", gall, (B, nl, T, 2 * R), sh.cdt, sh.dev)
    dhout, dskips = sh.cotangents(dhout, dskips)
    f32 = torch.float32
    dh0, dh1 = sh.empty(B, T, R, dtype=f32), sh.empty(B, T, R, dtype=f32)
    dcond = sh.empty(B, T, d, dtype=f32)
    cap = sh.part_cap(B * T)
    grads = sh.grads()
    dwemb = sh.empty(2, mu, R, dtype=f32) if sh.embed else None
    dbemb = sh.empty(R, dtype=f32) if sh.embed else None
    tr = [t.transpose(1, 2).contiguous() for t in (wff, vc, wr, ws)]
    # every tensor the kernels touch stays referenced until the call ends
    tensors = [h0, ids, wemb, bemb, cond, tr[0], tr[1], wr, tr[2], br, tr[3],
               gall, dhout, dskips, sh.empty(nl, B, T, R), dh0, dh1,
               sh.empty(B, T, R, dtype=f32), dcond, sh.empty(B, T, R),
               sh.empty(B, T, 2 * R, dtype=f32), sh.empty(cap, dtype=f32)]
    outs = [*grads.values(), dwemb, dbemb]
    err = _library().vqvae_chunk_bwd(
        _CDTYPE[sh.cdt], int(sh.embed), B, T, R, S, d, mu, nl, sh.dils,
        *map(_ptr, tensors), cap, *map(_ptr, outs), _stream(sh.dev))
    if err != 0:
        raise RuntimeError(f"chunk backward kernel failed: error {err}")
    launches_bwd += 1
    dh = None if sh.embed else (dh1 if nl % 2 else dh0)
    return (dh, dcond, *grads.values(), dwemb, dbemb)


def bwd_rec_kernel(dils, mode, x, wemb, bemb, cond, gc, wff, vc, wr, br, ws,
                   dhout, dskips):
    """The recompute kernel's float32 (dh, dcond, dgc, dwff, dvc, dwr,
    dbr, dws, dwemb, dbemb), as ``bwd_kernel`` returns them; the gates
    live only inside this call."""
    global launches_bwd_rec
    sh = _Shapes(dils, mode, x, wemb, cond, ws)
    B, T, R, S, d, nl, mu = sh.B, sh.T, sh.R, sh.S, sh.d, sh.nl, sh.mu
    args = [t.contiguous() for t in (cond, gc, wff, vc, wr, br, ws)]
    sh.check_weights(*args)
    cond, gc, wff, vc, wr, br, ws = args
    h0, ids, bemb = _lead(sh, x, bemb)
    if sh.embed:
        _check("wemb", wemb, (2, mu, R), sh.cdt, sh.dev)
    dhout, dskips = sh.cotangents(dhout, dskips)
    f32 = torch.float32
    dh0 = sh.empty(B, T, R, dtype=f32)
    dcond = sh.empty(B, T, d, dtype=f32)
    cap = sh.part_cap(B * T)
    grads = sh.grads()
    dwemb = sh.empty(2, mu, R, dtype=f32) if sh.embed else None
    dbemb = sh.empty(R, dtype=f32) if sh.embed else None
    tr = [t.transpose(1, 2).contiguous() for t in (wff, vc, wr, ws)]
    # every tensor the kernels touch stays referenced until the call ends
    tensors = [h0, ids, wemb, bemb, cond, gc, wff, vc, wr, br, *tr, dhout,
               dskips, sh.empty(nl, B, T, R), sh.empty(B, nl, T, 2 * R), dh0,
               sh.empty(B, T, R, dtype=f32), sh.empty(B, T, R, dtype=f32),
               dcond, sh.empty(B, T, R), sh.empty(B, T, 2 * R, dtype=f32),
               sh.empty(cap, dtype=f32)]
    outs = [*grads.values(), dwemb, dbemb]
    err = _library().vqvae_chunk_bwd_rec(
        _CDTYPE[sh.cdt], int(sh.embed), B, T, R, S, d, mu, nl, sh.dils,
        *map(_ptr, tensors), cap, *map(_ptr, outs), _stream(sh.dev))
    if err != 0:
        raise RuntimeError(f"chunk recompute backward kernel failed: error "
                           f"{err}")
    launches_bwd_rec += 1
    return (None if sh.embed else dh0, dcond, *grads.values(), dwemb, dbemb)


def bwd_win_kernel(dils, n_windows, x, cond, gc, wff, vc, wr, br, ws, dhout,
                   dskips):
    """The windowed kernel's float32 (dh, dcond, dgc, dwff, dvc, dwr,
    dbr, dws); x is the chunk input h (no embed variant).  Its scratch
    is window-sized."""
    global launches_bwd_win
    sh = _Shapes(dils, SEED, x, None, cond, ws)
    B, T, R, S, d, nl = sh.B, sh.T, sh.R, sh.S, sh.d, sh.nl
    Tc, _, W = window_geometry(T, n_windows, dils)
    args = [t.contiguous() for t in (cond, gc, wff, vc, wr, br, ws)]
    sh.check_weights(*args)
    cond, gc, wff, vc, wr, br, ws = args
    h0 = x.contiguous()
    dhout, dskips = sh.cotangents(dhout, dskips)
    f32 = torch.float32
    dh = sh.empty(B, T, R, dtype=f32)
    dcond = sh.empty(B, T, d, dtype=f32)
    cap = sh.part_cap(B * Tc)
    grads = sh.grads()
    tr = [t.transpose(1, 2).contiguous() for t in (wff, vc, wr, ws)]
    # every tensor the kernels touch stays referenced until the call ends
    tensors = [h0, cond, gc, wff, vc, wr, br, *tr, dhout, dskips,
               sh.empty(nl, B, W, R), sh.empty(B, nl, Tc, 2 * R),
               sh.empty(nl, B, max(dils), R, dtype=f32),
               sh.empty(B, Tc, R, dtype=f32), sh.empty(B, Tc, R, dtype=f32),
               sh.empty(B, Tc, R, dtype=f32), sh.empty(B, Tc, R),
               sh.empty(B, Tc, 2 * R, dtype=f32), sh.empty(cap, dtype=f32)]
    outs = [dh, dcond, *grads.values()]
    err = _library().vqvae_chunk_bwd_win(
        _CDTYPE[sh.cdt], B, T, R, S, d, nl, sh.dils, n_windows,
        *map(_ptr, tensors), cap, *map(_ptr, outs), _stream(sh.dev))
    if err != 0:
        raise RuntimeError(f"chunk windowed backward kernel failed: error "
                           f"{err}")
    launches_bwd_win += 1
    return (dh, dcond, *grads.values(), None, None)


# ---------------------------------------------------------------------------
# dispatch and autograd
# ---------------------------------------------------------------------------


def _on_card(t: torch.Tensor) -> bool:
    if t.device.type == "cuda":
        return True
    if t.device.type == "cpu":
        return False
    raise ValueError(f"no chunk kernel for device {t.device}")


def chunk_forward(dils, mode, x, wemb, bemb, cond, gc, wff, vc, wr, br, ws,
                  tail, save_gates=True):
    """(h_out, skips, gall): the kernel for CUDA tensors, the plain
    version for CPU tensors; gall is None without ``save_gates``."""
    if _on_card(cond):
        return fwd_kernel(dils, mode, x, wemb, bemb, cond, gc, wff, vc, wr,
                          br, ws, tail, save_gates)
    h = embed_h(x, wemb, bemb) if mode == EMBED else x
    h_out, skips, gall = fwd_plain(dils, h, cond, gc, wff, vc, wr, br, ws,
                                   tail, mode == ACC)
    return h_out, skips, gall if save_gates else None


def chunk_backward(dils, mode, x, wemb, bemb, cond, gc, wff, vc, wr, br, ws,
                   gall, dhout, dskips, windows=0):
    """Float32 (dh, dcond, dgc, dwff, dvc, dwr, dbr, dws, dwemb, dbemb):
    the save-gates backward when ``gall`` is given, else the recompute
    backward, time-windowed when ``windows > 1`` (never for the embed
    chunk, as the JAX package passes 0 there)."""
    windowed = gall is None and windows > 1 and mode != EMBED
    if windowed:
        window_geometry(x.shape[1], windows, dils)   # raises on bad counts
    if _on_card(cond):
        if gall is not None:
            return bwd_kernel(dils, mode, x, wemb, bemb, cond, gc, wff, vc,
                              wr, br, ws, gall, dhout, dskips)
        if windowed:
            return bwd_win_kernel(dils, windows, x, cond, gc, wff, vc, wr,
                                  br, ws, dhout, dskips)
        return bwd_rec_kernel(dils, mode, x, wemb, bemb, cond, gc, wff, vc,
                              wr, br, ws, dhout, dskips)
    h0 = embed_h(x, wemb, bemb) if mode == EMBED else x
    w = (cond, gc, wff, vc, wr, br, ws)
    if gall is not None:
        out = bwd_plain(dils, h0, *w, gall, dhout, dskips)
    elif windowed:
        out = bwd_win_plain(dils, windows, h0, *w, dhout, dskips)
    else:
        out = bwd_rec_plain(dils, h0, *w, dhout, dskips)
    if mode != EMBED:
        return out + (None, None)
    dwemb, dbemb = embed_grads_plain(x, out[0], h0.dtype, wemb.shape[1])
    return (None,) + out[1:] + (dwemb, dbemb)


class Chunk(torch.autograd.Function):
    """One chunk; ``mode`` is SEED (tail = the summed skip bias), ACC
    (tail = the running skips, whose cotangent passes through) or EMBED
    (x = ids, tail = the bias).  With ``save_gates`` (the default) the
    forward keeps the gate halves for the backward; without, it keeps
    only its inputs and the backward recomputes (over ``windows`` time
    windows when > 1)."""

    @staticmethod
    def forward(ctx, dils, mode, x, wemb, bemb, cond, gc, wff, vc, wr, br,
                ws, tail, save_gates=True, windows=0):
        h, skips, gall = chunk_forward(dils, mode, x, wemb, bemb, cond, gc,
                                       wff, vc, wr, br, ws, tail, save_gates)
        ctx.dils, ctx.mode, ctx.windows = dils, mode, windows
        ctx.tail_meta = (tail.shape, tail.dtype)
        ctx.save_for_backward(x, wemb, bemb, cond, gc, wff, vc, wr, br, ws,
                              gall)
        return h, skips

    @staticmethod
    def backward(ctx, dhout, dskips):
        x, wemb, bemb, cond, gc, wff, vc, wr, br, ws, gall = \
            ctx.saved_tensors
        dh, dcond, dgc, dwff, dvc, dwr, dbr, dws, dwemb, dbemb = \
            chunk_backward(ctx.dils, ctx.mode, x, wemb, bemb, cond, gc, wff,
                           vc, wr, br, ws, gall, dhout, dskips, ctx.windows)
        if ctx.mode == ACC:
            dtail = dskips                    # d(skips)/d(skips_in) = 1
        else:
            shape, dtype = ctx.tail_meta
            dtail = dskips.float().sum((0, 1)).reshape(shape).to(dtype)
        if ctx.mode == EMBED:
            lead = (None, dwemb.to(wemb.dtype),
                    dbemb.reshape(bemb.shape).to(bemb.dtype))
        else:
            lead = (dh.to(x.dtype), None, None)
        return (None, None, *lead, dcond.to(cond.dtype), dgc.to(gc.dtype),
                dwff.to(wff.dtype), dvc.to(vc.dtype), dwr.to(wr.dtype),
                dbr.to(br.dtype), dws.to(ws.dtype), dtail, None, None)


def decoder_stack(params, cfg, h, cond: torch.Tensor, gcond: torch.Tensor,
                  ids: torch.Tensor | None = None) -> torch.Tensor:
    """The L-layer gated-residual stack in chained chunks of up to
    ``MAX_CHUNK_LAYERS`` layers (port of ``decoder_stack_pallas``):
    returns skips ``[B, T, S]``.  With ``ids`` (and ``h=None``) the
    first chunk embeds the ids itself; later chunks chain the skip sum
    (ACC).  ``decoder_kernel="pallas_sg"`` saves the gates, ``"pallas"``
    recomputes (time-windowed with ``bwd_time_windows > 1``); ``remat``
    recomputes each chunk's forward in the backward as well
    (``torch.utils.checkpoint``, as the JAX package wraps each chunk in
    ``jax.checkpoint``)."""
    cdt = cfg.cdtype
    save_gates = cfg.decoder_kernel == "pallas_sg"
    windows = 0 if save_gates else cfg.bwd_time_windows
    lay = params["layers"]
    wf = lay["wf"].to(cdt)
    wff = torch.cat([wf[:, 0], wf[:, 1]], dim=1)          # [L, 2R, 2R]
    vc, wr, br, ws = (lay[k].to(cdt) for k in ("vc", "wr", "br", "ws"))
    gct = gcond.transpose(0, 1).to(cdt)                   # [B, L, 2R]
    cond = cond.to(cdt)
    dils = cfg.dilations
    L = len(dils)
    n_chunks = -(-L // MAX_CHUNK_LAYERS)
    per = -(-L // n_chunks)
    skips = lay["bs"].to(cdt).sum(0)                      # [S]

    def chunk(*args):
        if cfg.remat:
            return torch.utils.checkpoint.checkpoint(
                Chunk.apply, *args, use_reentrant=False)
        return Chunk.apply(*args)

    for i, l0 in enumerate(range(0, L, per)):
        s = slice(l0, min(l0 + per, L))
        w = (cond, gct[:, s], wff[s], vc[s], wr[s], br[s], ws[s], skips)
        if i == 0 and ids is not None:
            h, skips = chunk(dils[s], EMBED, ids, params["emb"]["w"].to(cdt),
                             params["emb"]["b"].to(cdt), *w, save_gates, 0)
        else:
            h, skips = chunk(dils[s], SEED if i == 0 else ACC, h, None, None,
                             *w, save_gates, windows)
    return skips

"""Fused strided-conv encoder: the CUDA kernels ``csrc/encoder.cu`` and
their plain PyTorch versions (port of
``vqvae_tpu/kernels/encoder_pallas.py``: the forward and the recompute
backward behind ``encoder_kernel="pallas"``).

The first layer (one input channel) runs outside the kernel, on the
plain ``ops/conv.py::strided_conv_apply`` and a ReLU, as the JAX package
runs it at the XLA level.  The kernel takes its output ``h [B, M0, C]``
(compute dtype, cdt) through the other ``L`` layers and the projection,
at the TPU kernel's rounding points:

* per layer ``h <- cdt(relu(f32(sum_j shift(h)_j @ W_j) + b))``: the
  four taps of a SAME stride-2 kernel-4 conv, the bias added in float32;
* ``z = f32(h @ Wp) + bp``, float32 ``[B, M0 >> L, d]``;

each sum taken in float64 (every product exact) and rounded once to
float32.  The TPU kernel sums in float32; a float64 sum rounds the same
in any order, so the kernel's forward equals the plain version's bit
for bit (but at a tie of roundings), ReLU masks included, and a row's
value depends on neither the batch nor the length (the streaming
encoder's contract).

The weights are rounded to cdt, the biases read as float32.  The
backward recomputes every layer's output, then walks the layers in
reverse: ``dz`` is rounded to cdt for the products while ``dbp`` sums
it in float32; the ReLU mask is ``out > 0`` on the rounded output;
``dy`` stays float32 for the bias sums and is rounded to cdt for the
weight and input gradients; ``dh0`` leaves in ``h``'s dtype, which is
what the first layer's autograd then receives.  Weight gradients come
back float32 in the ``[L, 4, C, C]`` tap layout (the TPU kernel's
packing of the taps into zero-padded blocks does not carry over).

On the card the forward's row products and the projection run on the
FP64 tensor cores (``mma.sync`` m16n8k16 ``.f64``), each output's sum in
one fixed order whatever the batch, the length or the tile.  The
backward's input-gradient products feed no ReLU (the masks come from the
bit-equal recompute): in bfloat16 they run on the bf16 tensor cores and
sum in float32, in float32 on the float64 engine (float64 rounded once,
as in the plain versions); the two agree to float32 rounding.  The
kernels take widths ``C`` that are multiples of 32 and latents ``d``
that are multiples of 8 (every preset's).

``EncoderStack`` is a ``torch.autograd.Function``: CPU tensors run the
plain versions, CUDA tensors launch the kernels or raise.
``launches_fwd`` and ``launches_bwd`` count kernel calls.
"""

from __future__ import annotations

import ctypes
import threading

import torch
import torch.nn.functional as F

from vqvae_tpu_torch.kernels.build import build
from vqvae_tpu_torch.ops.conv import matmul, strided_conv_apply

launches_fwd = 0   # encoder forward kernel calls in this process
launches_bwd = 0   # encoder recompute backward kernel calls
_launches_lock = threading.Lock()   # the daemon's pcm sessions run at once

_CDTYPE = {torch.float32: 0, torch.bfloat16: 1}
MAX_WIDTH = 128    # the kernels' widest layer and latent


# ---------------------------------------------------------------------------
# plain version
# ---------------------------------------------------------------------------


def _mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` summed in float64, rounded once to float32."""
    return (a.double() @ b.double()).float()


def _windows(x: torch.Tensor, k: int, s: int) -> torch.Tensor:
    """``[B, M, C] -> [B, M/s, k*C]``: each output row's k input rows of
    the SAME conv (``(k-s)//2`` rows of zeros on the left)."""
    B, M, C = x.shape
    left = (k - s) // 2
    xp = F.pad(x, (0, 0, left, k - s - left))
    return xp.unfold(1, k, s).transpose(2, 3).reshape(B, M // s, k * C)


def _unwindow(dwin: torch.Tensor, M: int, k: int, s: int) -> torch.Tensor:
    """The adjoint of ``_windows``: ``[B, M/s, k*C] -> [B, M, C]``."""
    B, Mo, kC = dwin.shape
    C = kC // k
    left = (k - s) // 2
    out = torch.zeros((B, M + k - s, C), dtype=dwin.dtype,
                      device=dwin.device)
    for j in range(k):
        out[:, j:j + s * Mo:s] += dwin[:, :, j * C:(j + 1) * C]
    return out[:, left:left + M]


def _layers(h, wr, br, s):
    """Every layer's rounded post-ReLU output, from h (cdt); wr in cdt."""
    L, k, C, Co = wr.shape
    out = []
    for i in range(L):
        y = _mm(_windows(h, k, s), wr[i].reshape(k * C, Co)) + br[i].float()
        h = torch.relu(y).to(h.dtype)
        out.append(h)
    return out


def fwd_plain(h, wr, br, wp, bp, s: int = 2) -> torch.Tensor:
    """z ``[B, M0 / s**L, d]`` float32 from h ``[B, M0, C]``."""
    cdt = h.dtype
    hl = _layers(h, wr.to(cdt), br, s)[-1]
    return _mm(hl, wp.to(cdt)) + bp.float()


def bwd_plain(h, wr, br, wp, bp, dz, s: int = 2):
    """(dh0 in h's dtype, float32 dwr ``[L, k, C, C]``, dbr, dwp, dbp)."""
    cdt = h.dtype
    L, k, C, Co = wr.shape
    wc, wpc = wr.to(cdt), wp.to(cdt)
    hall = _layers(h, wc, br, s)
    d = wp.shape[1]
    dz = dz.float()
    dzc = dz.to(cdt)
    dwp = _mm(hall[-1].reshape(-1, Co).T, dzc.reshape(-1, d))
    dbp = dz.reshape(-1, d).double().sum(0).float()
    dh = _mm(dzc, wpc.T)
    dwr, dbr = [None] * L, [None] * L
    for i in reversed(range(L)):
        dy = torch.where(hall[i].float() > 0, dh, torch.zeros_like(dh))
        dbr[i] = dy.reshape(-1, Co).double().sum(0).float()
        dyc = dy.to(cdt)
        hin = h if i == 0 else hall[i - 1]
        win = _windows(hin, k, s)
        dwr[i] = _mm(win.reshape(-1, k * C).T,
                     dyc.reshape(-1, Co)).reshape(k, C, Co)
        dh = _unwindow(_mm(dyc, wc[i].reshape(k * C, Co).T), hin.shape[1],
                       k, s)
    return dh.to(h.dtype), torch.stack(dwr), torch.stack(dbr), dwp, dbp


# ---------------------------------------------------------------------------
# CUDA kernel
# ---------------------------------------------------------------------------

_lib = None


def _library():
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build("vqvae_encoder", ["encoder.cu"])))
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.vqvae_enc_fwd.argtypes = [i] * 6 + [p] * 9
        lib.vqvae_enc_bwd.argtypes = ([i] * 6 + [p] * 13
                                      + [ctypes.c_longlong] + [p] * 6)
        lib.vqvae_enc_fwd.restype = lib.vqvae_enc_bwd.restype = i
        _lib = lib
    return _lib


class _Args:
    """The kernels' operands from (h, wr, br, wp, bp): checked, in the
    compute dtype (weights) and float32 (biases), contiguous."""

    def __init__(self, s, h, wr, br, wp, bp):
        self.cdt = h.dtype
        if self.cdt not in _CDTYPE:
            raise TypeError(f"encoder kernel has no {self.cdt} instance")
        if h.dim() != 3 or wr.dim() != 4:
            raise ValueError("encoder kernel takes h [B, M0, C] and wr "
                             "[L, 4, C, C]")
        self.B, self.M0, self.C = h.shape
        self.L, k, C_in, C_out = wr.shape
        self.d = wp.shape[-1]
        if s != 2 or k != 4:
            raise ValueError(f"encoder kernel takes stride 2 and kernel 4, "
                             f"got {s} and {k}")
        if (C_in, C_out) != (self.C, self.C) or self.C > MAX_WIDTH \
                or self.d > MAX_WIDTH or self.C % 32 or self.d % 8:
            raise ValueError(f"encoder kernel takes uniform widths C <= "
                             f"{MAX_WIDTH} (a multiple of 32) and d <= "
                             f"{MAX_WIDTH} (a multiple of 8); got h "
                             f"width {self.C}, taps {C_in}->{C_out}, "
                             f"d={self.d}")
        if self.M0 % (1 << self.L) or self.M0 < (1 << self.L):
            raise ValueError(f"encoder kernel: {self.M0} rows do not halve "
                             f"{self.L} times")
        dev = self.dev = h.device
        for name, x in (("wr", wr), ("br", br), ("wp", wp), ("bp", bp)):
            if x.device != dev:
                raise ValueError(f"encoder kernel: {name} on {x.device}, "
                                 f"h on {dev}")
        if tuple(br.shape) != (self.L, self.C) or \
                tuple(wp.shape) != (self.C, self.d) or \
                tuple(bp.shape) != (self.d,):
            raise ValueError("encoder kernel: bias or projection shapes do "
                             "not match the taps")
        self.h = h.contiguous()
        self.wr = wr.to(self.cdt).contiguous()
        self.br = br.float().contiguous()
        self.wp = wp.to(self.cdt).contiguous()
        self.bp = bp.float().contiguous()
        self.Mz = self.M0 >> self.L

    def empty(self, *shape, dtype=None):
        return torch.empty(shape, dtype=dtype or self.cdt, device=self.dev)

    def stream(self):
        return torch.cuda.current_stream(self.dev).cuda_stream


def fwd_kernel(h, wr, br, wp, bp, s: int = 2) -> torch.Tensor:
    """The kernel's z; see ``fwd_plain``."""
    global launches_fwd
    a = _Args(s, h, wr, br, wp, bp)
    z = a.empty(a.B, a.Mz, a.d, dtype=torch.float32)
    bufs = [a.empty(a.B, a.M0 // 2, a.C) for _ in range(2)]
    # every tensor the kernel touches stays referenced until the call ends
    err = _library().vqvae_enc_fwd(
        _CDTYPE[a.cdt], a.B, a.M0, a.C, a.d, a.L,
        *(t.data_ptr() for t in (a.h, a.wr, a.br, a.wp, a.bp, *bufs, z)),
        a.stream())
    if err != 0:
        raise RuntimeError(f"encoder forward kernel failed: error {err}")
    with _launches_lock:
        launches_fwd += 1
    return z


def _bwd_call(a: _Args, dz, events=None):
    """One launch of the recompute backward kernel (``events``: the
    pieces' CUDA events, see ``bwd_split_ms``)."""
    f32 = torch.float32
    dz = dz.to(f32).contiguous()
    if tuple(dz.shape) != (a.B, a.Mz, a.d) or dz.device != a.dev:
        raise ValueError(f"encoder backward: dz must be "
                         f"{(a.B, a.Mz, a.d)} on {a.dev}")
    B, M0, C, d, L = a.B, a.M0, a.C, a.d, a.L
    wrt = a.wr.transpose(-1, -2).contiguous()
    wpt = a.wp.t().contiguous()
    rows = sum(B * (M0 >> (i + 1)) for i in range(L))
    cap = max(1 << 22, 4 * C * C)
    dh0 = a.empty(B, M0, C)
    grads = [a.empty(L, 4, C, C, dtype=f32), a.empty(L, C, dtype=f32),
             a.empty(C, d, dtype=f32), a.empty(d, dtype=f32)]
    # every tensor the kernel touches stays referenced until the call ends
    tensors = [a.h, a.wr, wrt, a.br, a.wp, wpt, a.bp, dz,
               a.empty(rows, C), a.empty(B, M0 // 2, C, dtype=f32),
               a.empty(B, M0 // 2, C, dtype=f32), dh0,
               a.empty(cap, dtype=f32)]
    ev = None
    if events is not None:
        ev = (ctypes.c_void_p * len(events))(*(e.cuda_event
                                                for e in events))
    err = _library().vqvae_enc_bwd(
        _CDTYPE[a.cdt], B, M0, C, d, L, *(t.data_ptr() for t in tensors),
        cap, *(g.data_ptr() for g in grads), a.stream(), ev)
    if err != 0:
        raise RuntimeError(f"encoder backward kernel failed: error {err}")
    return (dh0, *grads)


def bwd_kernel(h, wr, br, wp, bp, dz, s: int = 2):
    """The recompute kernel's (dh0, dwr, dbr, dwp, dbp); see
    ``bwd_plain``.  Every layer's output lives only inside this call."""
    global launches_bwd
    out = _bwd_call(_Args(s, h, wr, br, wp, bp), dz)
    launches_bwd += 1
    return out


def bwd_split_ms(h, wr, br, wp, bp, dz, s: int = 2) -> dict:
    """Milliseconds of one backward kernel call by piece, from CUDA events
    the kernel records around them: ``recompute`` (pass 1),
    ``proj_dx`` (the projection's input gradient), ``dx`` (the layers'
    input gradients), ``dw`` (every weight and bias gradient: the split-K
    products and column sums).  A measurement: not counted as a launch."""
    a = _Args(s, h, wr, br, wp, bp)
    events = [torch.cuda.Event(enable_timing=True)
              for _ in range(6 + 4 * a.L)]
    for e in events:   # torch creates an event's handle at its first record
        e.record()
    _bwd_call(a, dz, events)
    torch.cuda.synchronize(a.dev)
    ms = [events[2 * k].elapsed_time(events[2 * k + 1])
          for k in range(len(events) // 2)]
    # pieces: recompute, projection dW/db, projection dx, then per layer
    # its dW/db and its dx
    return {"recompute": ms[0], "proj_dx": ms[2], "dx": sum(ms[4::2]),
            "dw": ms[1] + sum(ms[3::2])}


# ---------------------------------------------------------------------------
# dispatch and autograd
# ---------------------------------------------------------------------------


def _on_card(t: torch.Tensor) -> bool:
    if t.device.type == "cuda":
        return True
    if t.device.type == "cpu":
        return False
    raise ValueError(f"no encoder kernel for device {t.device}")


def encoder_stack_forward(h, wr, br, wp, bp, s: int = 2) -> torch.Tensor:
    """z: the kernel for CUDA tensors, the plain version for CPU ones."""
    if _on_card(h):
        return fwd_kernel(h, wr, br, wp, bp, s)
    return fwd_plain(h, wr, br, wp, bp, s)


def encoder_stack_backward(h, wr, br, wp, bp, dz, s: int = 2):
    """(dh0, dwr, dbr, dwp, dbp): the kernel for CUDA tensors, the plain
    version for CPU ones."""
    if _on_card(h):
        return bwd_kernel(h, wr, br, wp, bp, dz, s)
    return bwd_plain(h, wr, br, wp, bp, dz, s)


class EncoderStack(torch.autograd.Function):
    """Layers 1..L and the projection; the backward recomputes."""

    @staticmethod
    def forward(ctx, s, h, wr, br, wp, bp):
        ctx.s = s
        ctx.save_for_backward(h, wr, br, wp, bp)
        return encoder_stack_forward(h, wr, br, wp, bp, s)

    @staticmethod
    def backward(ctx, dz):
        h, wr, br, wp, bp = ctx.saved_tensors
        dh0, dwr, dbr, dwp, dbp = encoder_stack_backward(h, wr, br, wp, bp,
                                                         dz, ctx.s)
        return (None, dh0.to(h.dtype), dwr.to(wr.dtype), dbr.to(br.dtype),
                dwp.to(wp.dtype), dbp.to(bp.dtype))


def encoder_fused(params, cfg, wav: torch.Tensor) -> torch.Tensor:
    """``encoder_kernel="pallas"``: ``[B, T]`` waveform -> z_e ``[B,
    T/hop, d]`` float32, on the same parameter tree as the plain
    encoder.  The first layer runs plain; with more than one layer the
    rest run through ``EncoderStack``."""
    s, L, cdt = cfg.enc_stride, cfg.enc_layers, cfg.cdtype
    layers, proj = params["layers"], params["proj"]
    h = torch.relu(strided_conv_apply(layers[0], wav[..., None], s, cdt))
    if L == 1:
        return (matmul(h, proj["w"], cdt) + proj["b"].to(cdt)).to(
            torch.float32)
    if h.shape[1] % s ** (L - 1):
        raise ValueError(f"the fused encoder needs the length to be a "
                         f"multiple of the hop {s ** L}, got {wav.shape[-1]}")
    wr = torch.stack([layer["w"] for layer in layers[1:]])
    br = torch.stack([layer["b"] for layer in layers[1:]])
    return EncoderStack.apply(s, h, wr, br, proj["w"], proj["b"])

"""The WaveNet autoencoder's decoder layers as one autograd Function:
the gate kernels of ``csrc/wavenet_ae.cu``, their plain PyTorch versions,
and ``GatedStack``, which runs the layers' products on cuBLAS around them.

Per layer i, with dilation d, k taps and P = (k-1)d (``models/
wavenet_ae.py``'s ``decoder_stack``; cdt = the compute dtype):

* ``X_i``: the layer input ``l_i`` as rows of a buffer padded once, crop
  b's time t at row ``b*(T+P) + P + t``, its pad rows zero;
* ``u = sum_j X_i[j*d : j*d + n] @ wf[i, j]`` (n = B(T+P) - P rows; crop
  b's time t is row ``b*(T+P) + t``), k cuBLAS products;
* ``z = cdt(sigmoid(u[:R] + c_a) * tanh(u[R:] + c_b))``, the frame-rate
  condition ``cond[i]`` (its biases folded in) added over each frame's
  hop rows: one kernel (``gate_fwd``), float32 inside, one rounding;
* ``s += z @ ws[i]`` in place (the skip biases are in ``s0``);
* ``l_{i+1} = l_i + cdt(z @ wr[i] + br[i])``, written by one add into
  the next layer's padded buffer; the last layer's is not computed.

The backward walks the layers in reverse with the skip gradient ``g_s``
(the same for every layer) and the residual's ``g_l`` side by side in
one buffer ``H = [g_l | g_s]`` (``g_l`` zero at the last layer, whose
residual is not computed), so ``g_z = H @ [wr | ws]^T`` and ``z^T @ H
= [g_wr | g_ws]`` are one product each.  One kernel (``gate_bwd``)
recomputes the gate from the saved ``u`` and writes ``g_u`` in ``u``'s
padded rows (the rows the conv's products read; the straddle rows
zero), ``z`` (for the weight gradients, so the forward keeps only
``X_i`` and ``u`` a layer) and the condition's float32 frame sums; then
come the weight gradients' products, and the conv's input gradient as
k strided batched products (a batch a crop) accumulated into ``g_l`` in
place: no scratch buffer and no add pass (each tap's sum rounds into
``g_l``; on the CPU in bf16 the decoder's gradients were as far from
the float32 reference as with one rounded sum of the taps added once,
the mean of 6 seeds within 1.5%).

CPU tensors run the plain gates (float32 inside, as the kernels); CUDA
tensors launch the kernels or raise.  ``launches_fwd`` and
``launches_bwd`` count the kernel calls (one a layer a step each).
"""

from __future__ import annotations

import ctypes

import torch

from vqvae_tpu_torch.kernels.build import build
from vqvae_tpu_torch.utils.profiling import span

launches_fwd = 0   # gate-forward kernel calls in this process
launches_bwd = 0   # gate-backward kernel calls

_CDTYPE = {torch.float32: 0, torch.bfloat16: 1}


def rows(x: torch.Tensor, B: int, T: int, P: int, lo: int = 0
         ) -> torch.Tensor:
    """The ``[B, T, C]`` view of a padded row buffer ``x [*, C]`` whose
    crop b's time t is row ``b*(T+P) + lo + t``."""
    C = x.shape[-1]
    return x.as_strided((B, T, C), ((T + P) * C, C, 1),
                        x.storage_offset() + lo * C)


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------


def _gate_in(u, cond, B, T, P, hop):
    """The gate's float32 input ``[B, F, hop, 2R]``: u's rows plus the
    frame's condition."""
    F, R2 = cond.shape[1], cond.shape[2]
    return (rows(u, B, T, P).float().view(B, F, hop, R2)
            + cond.float()[:, :, None])


def gate_fwd_plain(u: torch.Tensor, cond: torch.Tensor, B: int, T: int,
                   P: int, hop: int) -> torch.Tensor:
    """``z [B*T, R]`` in u's dtype, from ``u`` (rows ``b*(T+P) + t``,
    ``[B*(T+P) - P, 2R]``) and ``cond [B, T/hop, 2R]``."""
    R = cond.shape[-1] // 2
    v = _gate_in(u, cond, B, T, P, hop)
    z = torch.sigmoid(v[..., :R]) * torch.tanh(v[..., R:])
    return z.to(u.dtype).reshape(B * T, R)


def gate_bwd_plain(gz: torch.Tensor, u: torch.Tensor, cond: torch.Tensor,
                   B: int, T: int, P: int, hop: int):
    """``(G, z, gcond)``: the gate input's gradient in u's rows and dtype,
    ``[B*(T+P), 2R]`` (the P straddle rows after every crop zero), z
    recomputed, and the float32 frame sums of the unrounded gradient
    ``[B, T/hop, 2R]``."""
    R = cond.shape[-1] // 2
    v = _gate_in(u, cond, B, T, P, hop)
    a, h = torch.sigmoid(v[..., :R]), torch.tanh(v[..., R:])
    g = gz.float().view(a.shape)
    gu = torch.cat([g * h * (a * (1 - a)), g * a * (1 - h * h)], -1)
    G = u.new_zeros(B * (T + P), 2 * R)
    rows(G, B, T, P).copy_(gu.view(B, T, 2 * R))
    return G, (a * h).to(u.dtype).reshape(B * T, R), gu.sum(2)


# ---------------------------------------------------------------------------
# kernels
# ---------------------------------------------------------------------------

_lib = None


def _library():
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build("vqvae_wavenet_ae", ["wavenet_ae.cu"])))
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.vqvae_ae_gate_fwd.argtypes = [i] * 6 + [p] * 4
        lib.vqvae_ae_gate_bwd.argtypes = [i] * 6 + [p] * 7
        lib.vqvae_ae_gate_fwd.restype = i
        lib.vqvae_ae_gate_bwd.restype = i
        _lib = lib
    return _lib


def _check(u, cond, B, T, P, hop, *more):
    R2 = cond.shape[-1]
    if u.dtype not in _CDTYPE or any(t.dtype != u.dtype
                                     for t in (cond, *more)):
        raise TypeError(f"the gate kernels take float32 or bfloat16 "
                        f"tensors of one dtype, got u {u.dtype}, cond "
                        f"{cond.dtype}")
    if not all(t.is_cuda and t.device == u.device for t in (cond, *more)):
        raise ValueError("the gate kernels take CUDA tensors on one device")
    vec = 16 // u.element_size()
    if hop < 1 or T % hop or tuple(cond.shape) != (B, T // hop, R2) or \
            R2 % (2 * vec) or tuple(u.shape) != (B * (T + P) - P, R2):
        raise ValueError(f"gate kernels: u {tuple(u.shape)} must be "
                         f"[B*(T+P) - P, 2R] and cond {tuple(cond.shape)} "
                         f"[B, T/hop, 2R] (B={B}, T={T}, P={P}, hop={hop}), "
                         f"R a multiple of {vec}")
    if not all(t.is_contiguous() and t.data_ptr() % 16 == 0
               for t in (u, cond, *more)):
        raise ValueError("the gate kernels take contiguous, 16-byte "
                         "aligned tensors")


def _stream(t):
    return torch._C._cuda_getCurrentRawStream(t.get_device())


def gate_fwd_kernel(u, cond, B, T, P, hop):
    """``gate_fwd_plain`` by ``csrc/wavenet_ae.cu`` (``ae_gate_fwd``)."""
    global launches_fwd
    _check(u, cond, B, T, P, hop)
    R = cond.shape[-1] // 2
    z = torch.empty(B * T, R, dtype=u.dtype, device=u.device)
    err = _library().vqvae_ae_gate_fwd(
        _CDTYPE[u.dtype], B, T, P, hop, R, u.data_ptr(), cond.data_ptr(),
        z.data_ptr(), _stream(u))
    if err != 0:
        raise RuntimeError(f"gate forward kernel failed: error {err}")
    launches_fwd += 1
    return z


def gate_bwd_kernel(gz, u, cond, B, T, P, hop):
    """``gate_bwd_plain`` by ``csrc/wavenet_ae.cu`` (``ae_gate_bwd``)."""
    global launches_bwd
    _check(u, cond, B, T, P, hop, gz)
    R = cond.shape[-1] // 2
    if tuple(gz.shape) != (B * T, R):
        raise ValueError(f"gz {tuple(gz.shape)} must be [B*T, R]")
    G = u.new_empty(B * (T + P), 2 * R)
    z = torch.empty_like(gz)
    gcond = torch.empty(cond.shape, dtype=torch.float32, device=u.device)
    err = _library().vqvae_ae_gate_bwd(
        _CDTYPE[u.dtype], B, T, P, hop, R, gz.data_ptr(), u.data_ptr(),
        cond.data_ptr(), G.data_ptr(), z.data_ptr(), gcond.data_ptr(),
        _stream(u))
    if err != 0:
        raise RuntimeError(f"gate backward kernel failed: error {err}")
    launches_bwd += 1
    return G, z, gcond


def _by_device(x, plain, kernel):
    if x.device.type == "cuda":
        return kernel
    if x.device.type == "cpu":
        return plain
    raise ValueError(f"no gate kernel for device {x.device}")


def gate_fwd(u, cond, B, T, P, hop):
    return _by_device(u, gate_fwd_plain, gate_fwd_kernel)(
        u, cond, B, T, P, hop)


def gate_bwd(gz, u, cond, B, T, P, hop):
    return _by_device(u, gate_bwd_plain, gate_bwd_kernel)(
        gz, u, cond, B, T, P, hop)


# ---------------------------------------------------------------------------
# the layers
# ---------------------------------------------------------------------------


def _padded(l: torch.Tensor, P: int) -> torch.Tensor:
    """A row buffer ``[B*(T+P), R]`` holding ``l [B, T, R]`` after P zero
    rows a crop (the first tap reads them)."""
    B, T, R = l.shape
    X = l.new_empty(B * (T + P), R)
    X.view(B, T + P, R)[:, :P].zero_()
    return X


class GatedStack(torch.autograd.Function):
    """``s = s0 + sum_i z_i @ ws[i]`` over the layers (module doc):
    ``l0 [B, T, R]``, ``s0 [B*T, S]``, ``cond [L, B, F, 2R]``, ``wf [L,
    k, R, 2R]``, ``wr [L, R, R]``, ``br [L, R]``, ``ws [L, R, S]``, all
    in the compute dtype; ``dils`` the L dilations, ``hop`` the frame's
    samples.  Saves each layer's padded input and ``u``."""

    @staticmethod
    def forward(ctx, l0, s0, cond, wf, wr, br, ws, dils, hop):
        B, T, R = l0.shape
        L, k = wf.shape[:2]
        cond = cond.contiguous()
        X = _padded(l0, (k - 1) * dils[0])
        rows(X, B, T, (k - 1) * dils[0], (k - 1) * dils[0]).copy_(l0)
        s, saved = s0, []
        keep = any(ctx.needs_input_grad)     # else nothing to save
        for i, d in enumerate(dils):
            P = (k - 1) * d
            n = X.shape[0] - P
            u = torch.mm(X[:n], wf[i, 0])
            for j in range(1, k):
                u.addmm_(X[j * d:j * d + n], wf[i, j])
            z = gate_fwd(u, cond[i], B, T, P, hop)
            s = torch.addmm(s, z, ws[i]) if i == 0 else s.addmm_(z, ws[i])
            if keep:
                saved += [X, u]
            if i < L - 1:
                r = torch.addmm(br[i], z, wr[i])
                Pn = (k - 1) * dils[i + 1]
                Xn = _padded(l0, Pn)
                torch.add(rows(X, B, T, P, P), r.view(B, T, R),
                          out=rows(Xn, B, T, Pn, Pn))
                X = Xn
        ctx.dils, ctx.hop = tuple(dils), hop
        ctx.save_for_backward(cond, wf, wr, ws, *saved)
        return s

    @staticmethod
    def backward(ctx, gs):
        cond, wf, wr, ws, *saved = ctx.saved_tensors
        dils, hop = ctx.dils, ctx.hop
        L, k, R = wf.shape[:3]
        B, F = cond.shape[1:3]
        T = F * hop
        N = B * T
        with span("model.ae_decoder_stack.bwd"):
            # H = [g_l | g_s]: both products that read them are one each
            H = gs.new_empty(N, R + gs.shape[1])
            H[:, :R].zero_()                # the last layer has no g_l
            H[:, R:] = gs
            gl = H[:, :R]
            wrs = torch.cat([wr, ws], 2)
            g_cond = torch.empty(cond.shape, dtype=torch.float32,
                                 device=gs.device)
            g_wf, g_wrs = torch.empty_like(wf), torch.empty_like(wrs)
            g_br = gs.new_empty(L, R)
            for i in reversed(range(L)):
                d = dils[i]
                P = (k - 1) * d
                X, u = saved[2 * i], saved[2 * i + 1]
                n = u.shape[0]
                G, z, g_cond[i] = gate_bwd(torch.mm(H, wrs[i].t()), u,
                                           cond[i], B, T, P, hop)
                torch.mm(z.t(), H, out=g_wrs[i])
                torch.sum(gl, 0, out=g_br[i])
                del z
                for j in range(k):
                    torch.mm(X[j * d:j * d + n].t(), G[:n], out=g_wf[i, j])
                # g_l[b, t] += G[row(b, t) + (k-1-j)d] @ wf[i, j]^T: one
                # strided batched product a tap, accumulated in place
                for j in range(k):
                    gl.view(B, T, R).baddbmm_(
                        rows(G, B, T, P, (k - 1 - j) * d),
                        wf[i, j].t().expand(B, 2 * R, R))
                del G
        return (gl.view(B, T, R), gs, g_cond.to(cond.dtype), g_wf,
                g_wrs[..., :R], g_br, g_wrs[..., R:], None, None)


def gated_stack(l0, s0, cond, wf, wr, br, ws, dils, hop: int
                ) -> torch.Tensor:
    return GatedStack.apply(l0, s0, cond, wf, wr, br, ws, tuple(dils), hop)

"""Fused head + softmax cross-entropy: the CUDA kernels
``csrc/head_ce.cu`` and their plain PyTorch versions (port of
``vqvae_tpu/kernels/head_ce_pallas.py``).

    x0 = relu(skips); x1 = relu(cdt(x0 @ w1) + b1)      (cdt add)
    logits = x1 @ cdt(w2) + b2                           (float32 sum)
    loss1 = mean over rows of (logsumexp - logits[target])

``w2`` multiplies in the compute dtype here, unlike the plain head of
``models/wavenet.py::_head``, as in the TPU kernel.  The backward
recomputes the forward and gives dskips in the compute dtype and the
head's weight and bias gradients in the parameters' dtype.  CPU tensors
run the plain version, CUDA tensors launch the kernels or raise;
``launches_fwd`` / ``launches_bwd`` count kernel calls.
"""

from __future__ import annotations

import ctypes

import torch

from vqvae_tpu_torch.kernels.build import build

launches_fwd = 0
launches_bwd = 0

_CDTYPE = {torch.float32: 0, torch.bfloat16: 1}


# ---------------------------------------------------------------------------
# plain version
# ---------------------------------------------------------------------------


def _forward_rows(x0, w1, b1, w2, b2):
    cdt = x0.dtype
    x1 = torch.relu((x0.float() @ w1.float()).to(cdt) + b1)
    return x1, x1.float() @ w2.float() + b2.float()


def fwd_plain(skips, targets, w1, b1, w2, b2) -> torch.Tensor:
    """Mean CE over the ``N = B*T`` rows of skips ``[N, S]`` (cdt);
    w1, b1, w2 in cdt, b2 float32."""
    _, logits = _forward_rows(torch.relu(skips), w1, b1, w2, b2)
    m = logits.max(-1, keepdim=True).values
    lz = torch.log(torch.exp(logits - m).sum(-1)) + m[:, 0]
    picked = logits.gather(1, targets.long()[:, None])[:, 0]
    return (lz - picked).sum() / skips.shape[0]


def bwd_plain(skips, targets, w1, b1, w2, b2, g):
    """(dskips cdt, dw1, db1, dw2, db2 float32) for loss cotangent g."""
    cdt, N = skips.dtype, skips.shape[0]
    x0 = torch.relu(skips)
    x1, logits = _forward_rows(x0, w1, b1, w2, b2)
    ez = torch.exp(logits - logits.max(-1, keepdim=True).values)
    p = ez / ez.sum(-1, keepdim=True)
    onehot = torch.nn.functional.one_hot(targets.long(), logits.shape[-1])
    dlogits = (p - onehot.float()) * (g.float() / N)
    dl_c = dlogits.to(cdt).float()
    dx1 = (dl_c @ w2.float().T) * (x1.float() > 0)
    dx1_c = dx1.to(cdt).float()
    dskips = ((dx1_c @ w1.float().T) * (x0.float() > 0)).to(cdt)
    return (dskips, x0.float().T @ dx1_c, dx1.sum(0), x1.float().T @ dl_c,
            dlogits.sum(0))


# ---------------------------------------------------------------------------
# CUDA kernel
# ---------------------------------------------------------------------------

_lib = None


def _library():
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build("vqvae_head_ce", ["head_ce.cu"])))
        p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.vqvae_head_ce_fwd.argtypes = [i] * 4 + [p] * 7 + [ll, p, p]
        lib.vqvae_head_ce_fwd.restype = i
        lib.vqvae_head_ce_bwd.argtypes = ([i] * 4 + [p] * 14 + [ll]
                                          + [p] * 5)
        lib.vqvae_head_ce_bwd.restype = i
        _lib = lib
    return _lib


def _stream(dev):
    return torch.cuda.current_stream(dev).cuda_stream \
        if dev.type == "cuda" else None


def _prepare(skips, targets, w1, b1, w2, b2):
    cdt, dev = skips.dtype, skips.device
    if cdt not in _CDTYPE:
        raise TypeError(f"head kernel has no {cdt} instance")
    N, S = skips.shape
    mu = w2.shape[-1]
    if S > 256 or mu > 256 or (cdt == torch.bfloat16 and (S % 16 or mu % 16)):
        raise ValueError(f"head kernel takes S, mu <= 256 (multiples of 16 "
                         f"in bfloat16), got {S}, {mu}")
    want = ((skips, (N, S), cdt), (targets, (N,), torch.int32),
            (w1, (S, S), cdt), (b1, (S,), cdt), (w2, (S, mu), cdt),
            (b2, (mu,), torch.float32))
    for i, (x, shape, dtype) in enumerate(want):
        if (tuple(x.shape) != shape or x.dtype != dtype or x.device != dev
                or not x.is_contiguous()):
            raise ValueError(f"head kernel: argument {i} must be {shape} "
                             f"{dtype} contiguous on {dev}, got "
                             f"{tuple(x.shape)} {x.dtype} on {x.device}")
    if bool(((targets < 0) | (targets >= mu)).any()):
        raise ValueError(f"targets must lie in [0, {mu})")
    return cdt, dev, N, S, mu


def fwd_kernel(skips, targets, w1, b1, w2, b2) -> torch.Tensor:
    """Loss as a float32 0-d tensor; arguments as ``fwd_plain``."""
    global launches_fwd
    cdt, dev, N, S, mu = _prepare(skips, targets, w1, b1, w2, b2)
    cap = -(-N // 32)
    part = torch.empty(cap, dtype=torch.float32, device=dev)
    loss = torch.empty((), dtype=torch.float32, device=dev)
    tensors = [skips, targets, w1, b1, w2, b2, part]
    err = _library().vqvae_head_ce_fwd(
        _CDTYPE[cdt], N, S, mu, *(t.data_ptr() for t in tensors), cap,
        loss.data_ptr(), _stream(dev))
    if err != 0:
        raise RuntimeError(f"head forward kernel failed: error {err}")
    launches_fwd += 1
    return loss


def bwd_kernel(skips, targets, w1, b1, w2, b2, g):
    """(dskips, dw1, db1, dw2, db2) as ``bwd_plain``."""
    global launches_bwd
    cdt, dev, N, S, mu = _prepare(skips, targets, w1, b1, w2, b2)
    f32 = torch.float32
    cap = max(1 << 22, -(-N // 32) * (S + mu))
    g = g.to(dev, f32).reshape(1).contiguous()
    w1T, w2T = w1.T.contiguous(), w2.T.contiguous()
    dskips = torch.empty((N, S), dtype=cdt, device=dev)
    grads = [torch.empty(s, dtype=f32, device=dev)
             for s in ((S, S), (S,), (S, mu), (mu,))]
    scratch = [torch.empty(s, dtype=cdt, device=dev)
               for s in ((N, S), (N, mu), (N, S))]
    # every tensor the kernels touch stays referenced until the call ends
    tensors = [skips, targets, w1, b1, w2, b2, w1T, w2T, g, *scratch, dskips,
               torch.empty(cap, dtype=f32, device=dev)]
    err = _library().vqvae_head_ce_bwd(
        _CDTYPE[cdt], N, S, mu, *(t.data_ptr() for t in tensors), cap,
        *(t.data_ptr() for t in grads), _stream(dev))
    if err != 0:
        raise RuntimeError(f"head backward kernel failed: error {err}")
    launches_bwd += 1
    return (dskips, *grads)


# ---------------------------------------------------------------------------
# dispatch and autograd
# ---------------------------------------------------------------------------


def _on_card(t: torch.Tensor) -> bool:
    if t.device.type == "cuda":
        return True
    if t.device.type == "cpu":
        return False
    raise ValueError(f"no head kernel for device {t.device}")


class _HeadCE(torch.autograd.Function):
    @staticmethod
    def forward(ctx, skips, targets, w1, b1, w2, b2):
        cdt = skips.dtype
        args = (skips.reshape(-1, skips.shape[-1]).contiguous(),
                targets.reshape(-1).to(torch.int32).contiguous(),
                w1.to(cdt).contiguous(), b1.to(cdt).contiguous(),
                w2.to(cdt).contiguous(), b2.to(torch.float32).contiguous())
        ctx.save_for_backward(*args)
        ctx.meta = (skips.shape, w1.dtype, b1.dtype, w2.dtype, b2.dtype)
        return (fwd_kernel if _on_card(skips) else fwd_plain)(*args)

    @staticmethod
    def backward(ctx, g):
        args = ctx.saved_tensors
        dskips, dw1, db1, dw2, db2 = (
            bwd_kernel if _on_card(args[0]) else bwd_plain)(*args, g)
        shape, t1, tb1, t2, tb2 = ctx.meta
        return (dskips.reshape(shape), None, dw1.to(t1), db1.to(tb1),
                dw2.to(t2), db2.to(tb2))


def head_ce_loss(params, cfg, skips: torch.Tensor, targets: torch.Tensor
                 ) -> torch.Tensor:
    """loss1 through the fused head (``head_kernel="pallas"``): skips
    ``[B, T, S]`` in the compute dtype, targets ``[B, T]``."""
    h1, h2 = params["head"]["h1"], params["head"]["h2"]
    return _HeadCE.apply(skips.to(cfg.cdtype), targets, h1["w"], h1["b"],
                         h2["w"], h2["b"])

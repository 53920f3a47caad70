"""The backward of an embedding's row gather: the CUDA kernel
``csrc/embed.cu`` and its plain PyTorch version.

For a table ``w [V, C]`` gathered as ``w[ids]``, the gradient is
``dw[v, :] = Σ g[m, :]`` over the rows m whose id is v, summed in float32
and rounded once to w's dtype: the backward of
``vqvae_tpu/ops/embed.py::take_rows`` (``_bwd``), which the JAX package
writes as the one-hot contraction ``one_hot(ids, V)ᵀ @ g``.  An id outside
``[0, V)`` adds nothing (its one-hot row is zero).

The kernel is a fixed-order per-id sum with no atomics: a block owns a
part of contiguous rows, streamed in chunks by TMA bulk copies, and
keeps a float32 table ``[V, C]`` in shared memory whose entries each
have one owner (a warp owns a class of ids and a group of 32 columns),
adding its rows in row order; a second launch adds the parts' tables in
a fixed order.  Two calls give the same
bits.  It takes int32 ids (the port's framing makes them) or int64, and
float32 or bfloat16 g.

``take_rows_bwd`` runs the plain version for CPU tensors and launches the
kernel (or raises) for CUDA tensors; ``launches`` counts kernel calls
(one a call; the call's two device launches count once).
"""

from __future__ import annotations

import ctypes

import torch

from vqvae_tpu_torch.kernels.build import build

# kernel calls in this process, by the name chip_smoke.py reports
launches = {"take_rows_bwd": 0}

_CDTYPE = {torch.float32: 0, torch.bfloat16: 1}
_IDS = {torch.int32: 0, torch.int64: 1}
SMEM = 232448   # shared memory a block can have (H100)
STAGES = 4      # chunk stages in a block's ring


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def kernel_smem(V: int, C: int, es: int, isz: int) -> int:
    """Bytes of shared memory a kernel block needs (``csrc/embed.cu``,
    ``eb_shape``): the float32 table ``[V, C]`` (rounded up to 4 floats),
    4 stages of ``rc`` rows (``C`` values of ``es`` bytes and an id of
    ``isz``, each rounded up to 16 bytes), their barriers, a chunk's
    rows sorted by id class (256 pairs of ints) and the sort's counts
    (640 bytes), for the largest ``rc`` of 256, 128, 64, 32 that fits;
    0 where none does."""
    rc = 256
    while rc >= 32:
        need = (4 * _round_up(V * C, 4) + 8 * STAGES + 8 * 256 + 640 +
                STAGES * (_round_up(rc * C * es, 16) +
                          _round_up(rc * isz, 16)))
        if need <= SMEM:
            return need
        rc //= 2
    return 0


def parts(M: int, sms: int) -> int:
    """The parts of contiguous rows a call splits into (``eb_parts``):
    one block an SM, at least 16 rows a part."""
    return max(1, min(sms, -(-M // 16)))


def take_rows_bwd_plain(ids: torch.Tensor, g: torch.Tensor, V: int,
                        dtype: torch.dtype) -> torch.Tensor:
    """``(one_hot(ids, V)ᵀ @ g).to(dtype)`` with float32 sums (JAX's
    ``_bwd``): ids ``[...]``, g ``[..., C]`` -> ``[V, C]``.  An id
    outside ``[0, V)`` has a zero one-hot row."""
    flat = ids.reshape(-1, 1).long()
    onehot = (flat == torch.arange(V, device=ids.device)).float()
    return (onehot.T @ g.reshape(flat.shape[0], -1).float()).to(dtype)


_fn = None   # the bound vqvae_take_rows_bwd, looked up once
_sms: dict = {}   # device index -> its SMs


def _kernel():
    global _fn
    if _fn is None:
        lib = ctypes.CDLL(str(build("vqvae_embed", ["embed.cu"])))
        p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.vqvae_take_rows_bwd.argtypes = [i] * 5 + [p] * 3 + [ll, p, p]
        lib.vqvae_take_rows_bwd.restype = i
        _fn = lib.vqvae_take_rows_bwd
    return _fn


def take_rows_bwd_kernel(ids: torch.Tensor, g: torch.Tensor, V: int,
                         dtype: torch.dtype) -> torch.Tensor:
    """The same by ``csrc/embed.cu`` on the card: g float32 or bfloat16
    in ``dtype`` (the table's, as autograd gives it), ids int32 or int64
    of g's leading shape.  No cast or copy of a contiguous g or ids."""
    if g.dtype not in _CDTYPE or g.dtype != dtype:
        raise TypeError(f"take_rows kernel takes float32 or bfloat16 g in "
                        f"the table's dtype, got {g.dtype} for {dtype}")
    if ids.dtype not in _IDS:
        raise TypeError(f"take_rows kernel takes int32 or int64 ids, got "
                        f"{ids.dtype}")
    if tuple(g.shape[:-1]) != tuple(ids.shape):
        raise ValueError(f"g {tuple(g.shape)} must be ids' shape "
                         f"{tuple(ids.shape)} and a width")
    if not (g.is_cuda and ids.device == g.device):
        raise ValueError(f"take_rows_bwd_kernel takes CUDA tensors on one "
                         f"device, got {ids.device} and {g.device}")
    C = g.shape[-1]
    es, isz = g.element_size(), ids.element_size()
    if V < 1 or C < 1 or kernel_smem(V, C, es, isz) == 0:
        raise ValueError(f"take_rows kernel keeps a [V, C] float32 table "
                         f"and four 32-row stages in shared memory: V={V}, "
                         f"C={C} do not fit in {SMEM} bytes")
    out = torch.empty(V, C, dtype=dtype, device=g.device)
    M = ids.numel()
    if M == 0:
        return out.zero_()
    g, ids = g.contiguous(), ids.contiguous()
    dev = g.get_device()
    sms = _sms.get(dev)
    if sms is None:
        sms = _sms[dev] = torch.cuda.get_device_properties(
            dev).multi_processor_count
    cap = parts(M, sms) * V * C
    part = torch.empty(cap, dtype=torch.float32, device=g.device)
    err = _kernel()(_CDTYPE[g.dtype], _IDS[ids.dtype], M, V, C,
                    ids.data_ptr(), g.data_ptr(), part.data_ptr(), cap,
                    out.data_ptr(), torch._C._cuda_getCurrentRawStream(dev))
    if err != 0:
        raise RuntimeError(f"take_rows kernel failed: error {err}")
    launches["take_rows_bwd"] += 1
    return out


def take_rows_bwd(ids: torch.Tensor, g: torch.Tensor, V: int,
                  dtype: torch.dtype) -> torch.Tensor:
    """``dw [V, C]``: the kernel for CUDA tensors, the plain version for
    CPU tensors."""
    if g.device.type == "cuda":
        return take_rows_bwd_kernel(ids, g, V, dtype)
    if g.device.type == "cpu":
        return take_rows_bwd_plain(ids, g, V, dtype)
    raise ValueError(f"no take_rows kernel for device {g.device}")

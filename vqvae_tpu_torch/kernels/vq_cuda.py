"""VQ nearest-code search: the CUDA kernel ``csrc/vq.cu`` and its plain
PyTorch version (port of ``vqvae_tpu/kernels/vq_pallas.py``,
``vq_argmin_pallas``).

Per row of z ``[N, d]``: ``argmax_k (2·z·cb_kᵀ − ‖cb_k‖²)`` in float32,
the first index on ties; int32 ids ``[N]``.  No ``[N, K]`` score matrix
reaches device memory in the kernel.  The kernel and the plain version
sum in different orders, so their ids may differ where the two best
scores of a row are within float32 rounding of each other.

``vq_argmin`` runs the plain version for CPU tensors and launches the
kernel (or raises) for CUDA tensors; ``launches`` counts kernel calls.
"""

from __future__ import annotations

import ctypes

import torch

from vqvae_tpu_torch.kernels.build import build

launches = 0   # VQ kernel calls in this process


def vq_argmin_plain(z: torch.Tensor, codebook: torch.Tensor) -> torch.Tensor:
    """Float32 scores ``2·(z @ cbᵀ) − ‖cb‖²``, argmax (first index on
    ties), int32."""
    cb = codebook.float()
    scores = 2.0 * (z.float() @ cb.T) - torch.sum(cb * cb, dim=-1)
    return torch.argmax(scores, dim=-1).to(torch.int32)


_lib = None


def _library():
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build("vqvae_vq", ["vq.cu"])))
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.vqvae_vq_argmin.argtypes = [i, i, i, p, p, p, p]
        lib.vqvae_vq_argmin.restype = i
        _lib = lib
    return _lib


def vq_argmin_kernel(z: torch.Tensor, codebook: torch.Tensor
                     ) -> torch.Tensor:
    """The kernel's int32 ids ``[N]`` for float32 z ``[N, d]`` on the
    card; the codebook ``[K, d]`` is read as float32."""
    global launches
    if z.dim() != 2 or z.dtype != torch.float32:
        raise TypeError(f"vq kernel takes float32 z [N, d], got "
                        f"{tuple(z.shape)} {z.dtype}")
    N, d = z.shape
    if codebook.dim() != 2 or codebook.shape[1] != d:
        raise ValueError(f"codebook must be [K, {d}], got "
                         f"{tuple(codebook.shape)}")
    if codebook.device != z.device:
        raise ValueError("z and the codebook must be on one device")
    if N == 0:
        return torch.empty(0, dtype=torch.int32, device=z.device)
    z = z.contiguous()
    cbt = codebook.float().t().contiguous()               # [d, K]
    out = torch.empty(N, dtype=torch.int32, device=z.device)
    stream = (torch.cuda.current_stream(z.device).cuda_stream
              if z.device.type == "cuda" else None)
    err = _library().vqvae_vq_argmin(N, codebook.shape[0], d, z.data_ptr(),
                                     cbt.data_ptr(), out.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"vq kernel failed: error {err}")
    launches += 1
    return out


def vq_argmin(z: torch.Tensor, codebook: torch.Tensor) -> torch.Tensor:
    """int32 ids ``[N]``: the kernel for CUDA tensors, the plain version
    for CPU tensors."""
    if z.device.type == "cuda":
        return vq_argmin_kernel(z, codebook)
    if z.device.type == "cpu":
        return vq_argmin_plain(z, codebook)
    raise ValueError(f"no vq kernel for device {z.device}")

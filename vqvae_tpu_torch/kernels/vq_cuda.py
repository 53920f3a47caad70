"""VQ nearest-code search: the CUDA kernel ``csrc/vq.cu`` and its plain
PyTorch version (port of ``vqvae_tpu/kernels/vq_pallas.py``,
``vq_argmin_pallas``).

Per row of z ``[N, d]``: ``argmax_k (2·z·cb_kᵀ − ‖cb_k‖²)`` in float32,
the first index on ties; int32 ids ``[N]``.  No ``[N, K]`` score matrix
reaches device memory in the kernel.  The kernel and the plain version
sum in different orders, so their ids may differ where the two best
scores of a row are within float32 rounding of each other.

The kernel splits the codebook over the 4 blocks of a thread-block
cluster, each keeping its quarter in shared memory; ``vq_argmin_split``
is that partition and order of comparisons in plain PyTorch, and
``kernel_takes`` the sizes whose quarter fits.

``vq_argmin`` runs the plain version for CPU tensors and launches the
kernel (or raises) for CUDA tensors; ``launches`` counts kernel calls.
"""

from __future__ import annotations

import ctypes

import torch

from vqvae_tpu_torch.kernels.build import build

launches = 0   # VQ kernel calls in this process

VQ_CS = 4      # blocks a cluster: code slices
VQ_LANES = 32  # lanes a warp; lane l takes codes l, l + 32, ... of a slice
VQ_CP = 128    # codes a pass of a warp (4 a lane)
VQ_TR = 64     # rows a tile (8 warps of 8 rows)
VQ_SMEM = 232448   # shared memory a block can have (H100)
VQ_MAX_D = 256


def vq_argmin_plain(z: torch.Tensor, codebook: torch.Tensor) -> torch.Tensor:
    """Float32 scores ``2·(z @ cbᵀ) − ‖cb‖²``, argmax (first index on
    ties), int32."""
    cb = codebook.float()
    scores = 2.0 * (z.float() @ cb.T) - torch.sum(cb * cb, dim=-1)
    return torch.argmax(scores, dim=-1).to(torch.int32)


def _kord_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ bᵀ`` summed in k order in float32: each step adds the exact
    product in float64 and rounds to float32 (a float32 FMA but for a
    rare double rounding)."""
    acc = torch.zeros(a.shape[0], b.shape[0], dtype=torch.float32)
    a64, b64 = a.double(), b.double()
    for k in range(a.shape[1]):
        acc = (acc.double() + a64[:, k:k + 1] * b64[:, k]).float()
    return acc


def _kord_norms(cb: torch.Tensor) -> torch.Tensor:
    """``‖cb_k‖²`` summed in k order as ``_kord_f32``."""
    n = torch.zeros(cb.shape[0], dtype=torch.float32)
    c64 = cb.double()
    for k in range(cb.shape[1]):
        n = (n.double() + c64[:, k] * c64[:, k]).float()
    return n


def vq_argmin_split(z: torch.Tensor, codebook: torch.Tensor) -> torch.Tensor:
    """The kernel's ids in plain PyTorch, in its order: the codebook in
    ``VQ_CS`` slices of ``ceil(K / VQ_CS)`` codes; in a slice, scores
    ``2·s − n`` with s and n summed in k order in float32; each of a
    warp's 32 lanes keeps its best over its codes (lane l: codes l,
    l + 32, ...) in increasing order (a strict ``>``, from the slice's
    first id at −inf); the warp's shuffle tree over its lanes (higher
    score, then lower id); the slices' bests taken in rank order (a
    strict ``>``).  CPU, int32 ``[N]``."""
    z, cb = z.detach().float().cpu(), codebook.detach().float().cpu()
    N, K = z.shape[0], cb.shape[0]
    kr = -(-K // VQ_CS)
    best = bid = None
    for rank in range(VQ_CS):
        c0, nc = rank * kr, max(0, min(K - rank * kr, kr))
        lane_s = torch.full((N, VQ_LANES), -torch.inf)
        lane_i = torch.full((N, VQ_LANES), c0, dtype=torch.int64)
        if nc:
            sl = cb[c0:c0 + nc]
            sc = 2.0 * _kord_f32(z, sl) - _kord_norms(sl)
            for c in range(nc):   # each lane visits its codes in order
                lane = c % VQ_LANES
                take = sc[:, c] > lane_s[:, lane]
                lane_s[take, lane] = sc[take, c]
                lane_i[take, lane] = c0 + c
        s, i = lane_s, lane_i
        for o in (16, 8, 4, 2, 1):   # the shuffle tree
            other = torch.arange(VQ_LANES) ^ o
            so, io = s[:, other], i[:, other]
            take = (so > s) | ((so == s) & (io < i))
            s, i = torch.where(take, so, s), torch.where(take, io, i)
        s, i = s[:, 0], i[:, 0]
        if best is None:
            best, bid = s, i
        else:
            take = s > best
            best, bid = torch.where(take, s, best), torch.where(take, i, bid)
    return bid.to(torch.int32)


def kernel_smem(K: int, d: int) -> int:
    """Bytes of shared memory a kernel block needs at (K, d) with one z
    stage (``csrc/vq.cu``, ``VqShape::bytes``): the slice of
    ``ceil(K/4)`` codes (rounded up to passes of 128) in rows of ``d``
    rounded up to 4, padded to an odd number of 16-byte units, its
    norms, one 64-row z tile of ``d`` rounded up to 4 and two buffers of
    the ranks' bests."""
    dp = -(-d // 4) * 4
    ld = dp + (4 if (dp // 4) % 2 == 0 else 0)
    kp = -(-(-(-K // VQ_CS)) // VQ_CP) * VQ_CP
    return 4 * (kp * ld + kp + VQ_TR * dp + 4 * VQ_CS * VQ_TR)


def kernel_takes(K: int, d: int) -> bool:
    """Whether the kernel takes a codebook ``[K, d]``: d <= 256 and a
    quarter of it in shared memory (``kernel_smem`` <= 227 KB)."""
    return 1 <= d <= VQ_MAX_D and K >= 1 and kernel_smem(K, d) <= VQ_SMEM


_fn = None   # the bound vqvae_vq_argmin, looked up once


def _kernel():
    global _fn
    if _fn is None:
        lib = ctypes.CDLL(str(build("vqvae_vq", ["vq.cu"])))
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.vqvae_vq_argmin.argtypes = [i, i, i, p, p, p, p]
        lib.vqvae_vq_argmin.restype = i
        _fn = lib.vqvae_vq_argmin
    return _fn


def vq_argmin_kernel(z: torch.Tensor, codebook: torch.Tensor
                     ) -> torch.Tensor:
    """The kernel's int32 ids ``[N]`` for float32 z ``[N, d]`` on the
    card; the codebook ``[K, d]`` is read as float32 in its own layout
    (a float32 codebook is not copied).  One launch; the host path is
    one ctypes call after these checks."""
    global launches
    if z.dim() != 2 or z.dtype != torch.float32:
        raise TypeError(f"vq kernel takes float32 z [N, d], got "
                        f"{tuple(z.shape)} {z.dtype}")
    N, d = z.shape
    if codebook.dim() != 2 or codebook.shape[1] != d:
        raise ValueError(f"codebook must be [K, {d}], got "
                         f"{tuple(codebook.shape)}")
    K = codebook.shape[0]
    if not kernel_takes(K, d):
        raise ValueError(
            f"vq kernel takes d <= {VQ_MAX_D} and a quarter of the "
            f"codebook in shared memory: K={K}, d={d} needs "
            f"{kernel_smem(K, d)} bytes a block, the limit is {VQ_SMEM}")
    if codebook.device != z.device:
        raise ValueError("z and the codebook must be on one device")
    if N == 0:
        return torch.empty(0, dtype=torch.int32, device=z.device)
    z = z.contiguous()
    cb = codebook.float().contiguous()
    out = torch.empty(N, dtype=torch.int32, device=z.device)
    stream = (torch._C._cuda_getCurrentRawStream(z.get_device())
              if z.is_cuda else None)
    err = _kernel()(N, K, d, z.data_ptr(), cb.data_ptr(), out.data_ptr(),
                    stream)
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

"""A chain of dependent matrix products at the decode kernel's widths,
bf16 and int8: the CUDA kernel ``csrc/decode_chain.cu`` and its plain
PyTorch versions (port of ``scripts/decode_int8_micro.py``'s
``body_bf16`` and ``body_int8``).

x ``[64, 128]`` bf16 goes through ``steps`` steps of ``L`` products with
w ``[L, 128, 128]``:

* bf16: per layer ``x = bf16(f32(x @ w[l]))``; per step ``x = x·0.125``.
* int8: ``x = f32(x0)``; per layer ``xi = int8(trunc(clip(x·127, ±127)))``,
  ``acc = xi @ w8[l]`` in int32, ``x = f32(acc)·scale[l]·0.0078125`` (in
  that order); the output ``bf16(x)``.

The int8 chain is exact: the kernel equals the plain version bit for
bit.  The plain version sums the integer product in float64, which is
exact here (``|acc| <= 128·127² < 2⁵³``), because ``torch.matmul`` takes
no integers on the card.  The bf16 chain's float32 sums run in another
order in the kernel (tensor cores) than in the plain version.

The kernel keeps x in its warps' registers from layer to layer and reads
the weights as ``pack_weights`` lays them out once per call: each layer
in wgmma's K-major layout without swizzle (core matrices of 8 rows of n
by 16 bytes of k); int8 rows in ``kperm``'s k-order, which turns a
thread's int32 results of one layer straight into its int8 A fragment of
the next (``csrc/decode_chain.cu``).

``chain`` runs the plain version for CPU tensors and launches the kernel
(or raises) for CUDA tensors; ``launches`` counts kernel calls by dtype.
"""

from __future__ import annotations

import ctypes

import torch

from vqvae_tpu_torch.kernels.build import build

launches = {"chain_bf16": 0, "chain_int8": 0}   # kernel calls, by chain

ROWS, WIDTH = 64, 128   # the decode kernel's B and 2R, the kernel's shape


def chain_bf16_plain(x0, w, steps: int) -> torch.Tensor:
    x = x0.to(torch.bfloat16)
    wf = w.float()
    for _ in range(steps):
        for l in range(w.shape[0]):
            x = (x.float() @ wf[l]).to(torch.bfloat16)
        x = x * 0.125
    return x


def chain_int8_plain(x0, w8, scale, steps: int) -> torch.Tensor:
    x = x0.float()
    wd = w8.double()
    sc = scale.float().reshape(-1)
    for _ in range(steps):
        for l in range(w8.shape[0]):
            xi = torch.clamp(x * 127.0, -127.0, 127.0).to(torch.int8)
            acc = (xi.double() @ wd[l]).to(torch.int32)
            x = acc.float() * sc[l]
            x = x * 0.0078125
    return x.to(torch.bfloat16)


def kperm() -> torch.Tensor:
    """``[128]``: the weight row (a column of the previous layer's output)
    that the int8 kernel keeps at each k position of a layer.  Its int8
    wgmma (m64nNk32, fragments as mma.sync m16n8k32's) gives thread t of
    a quad the output columns ``8j + 2t``, ``+1`` of n-tile j, and takes
    its A operand at k positions ``32kb + 16h + 4t + i`` (i < 4): position
    ``32kb + 16h + 4t + i`` holds column ``32kb + 16h + 8(i // 2) + 2t +
    i % 2``, n-tile ``4kb + 2h + i // 2`` of the same thread."""
    p = torch.arange(WIDTH)
    kb, h, t, i = p // 32, p % 32 // 16, p % 16 // 4, p % 4
    return 32 * kb + 16 * h + 8 * (i // 2) + 2 * t + i % 2


_kperm_on: dict = {}   # kperm() by device


def pack_weights(w: torch.Tensor) -> torch.Tensor:
    """The kernel's layers from w ``[L, 128 (k), 128 (n)]``: ``[L, KB,
    16, 2, 8, E]`` with E = 16 bytes of k (8 bf16, 16 int8) and KB =
    128 / 2E k-blocks, ``out[l, kb, nb, h, r, c] = w[l, kperm[k], 8 nb +
    r]`` for ``k = 2E kb + E h + c`` (``kperm[k] = k`` for bf16): k-block
    kb's core matrix of n-rows ``8 nb ..`` and k-half h lies ``4096 kb +
    256 nb + 128 h`` bytes into the layer."""
    int8 = w.dtype == torch.int8
    if int8:
        if w.device not in _kperm_on:   # copied once, before any capture
            _kperm_on[w.device] = kperm().to(w.device)
        w = w.index_select(1, _kperm_on[w.device])
    E = 16 if int8 else 8
    L = w.shape[0]
    return w.transpose(1, 2).reshape(L, WIDTH // 8, 8, WIDTH // (2 * E), 2,
                                     E).permute(0, 3, 1, 4, 2, 5).contiguous()


_lib = None


def _library():
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build("vqvae_decode_chain",
                                    ["decode_chain.cu"])))
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.vqvae_decode_chain.argtypes = [i] * 3 + [p] * 5
        lib.vqvae_decode_chain.restype = i
        lib.vqvae_decode_chain_layer_bytes.argtypes = [i]
        lib.vqvae_decode_chain_layer_bytes.restype = i
        for int8 in (0, 1):
            if lib.vqvae_decode_chain_layer_bytes(int8) != \
                    WIDTH * WIDTH * (2 - int8):
                raise RuntimeError("decode_chain.cu packs its layers "
                                   "otherwise than pack_weights")
        _lib = lib
    return _lib


def chain_kernel(x0, w, steps: int, scale=None) -> torch.Tensor:
    """The kernel's output ``[64, 128]`` bf16: the int8 chain when w is
    int8 (``scale [L]`` or ``[L, 1, 1]`` float32), else the bf16 chain."""
    int8 = w.dtype == torch.int8
    if tuple(x0.shape) != (ROWS, WIDTH) or w.dim() != 3 or \
            tuple(w.shape[1:]) != (WIDTH, WIDTH):
        raise ValueError(f"chain kernel takes x0 [{ROWS}, {WIDTH}] and w "
                         f"[L, {WIDTH}, {WIDTH}], got {tuple(x0.shape)}, "
                         f"{tuple(w.shape)}")
    if steps < 1:
        raise ValueError("chain kernel needs at least one step")
    L = w.shape[0]
    dev = x0.device
    if dev.type != "cuda" or w.device != dev:
        raise ValueError(f"chain kernel takes CUDA tensors on one device, "
                         f"got x0 on {dev}, w on {w.device}")
    x0 = x0.to(torch.bfloat16).contiguous()
    wp = pack_weights(w if int8 else w.to(torch.bfloat16))
    if int8:
        if scale is None or scale.numel() != L or scale.device != dev:
            raise ValueError(f"the int8 chain needs {L} scales on {dev}")
        scale = scale.float().reshape(L).contiguous()
    out = torch.empty(ROWS, WIDTH, dtype=torch.bfloat16, device=dev)
    err = _library().vqvae_decode_chain(
        int(int8), L, steps, x0.data_ptr(), wp.data_ptr(),
        scale.data_ptr() if int8 else None, out.data_ptr(),
        torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"decode chain kernel failed: error {err}")
    launches["chain_int8" if int8 else "chain_bf16"] += 1
    return out


def chain(x0, w, steps: int, scale=None) -> torch.Tensor:
    """The chain's output: the kernel for CUDA tensors, the plain version
    for CPU ones."""
    if x0.device.type == "cuda":
        return chain_kernel(x0, w, steps, scale)
    if x0.device.type != "cpu":
        raise ValueError(f"no chain kernel for device {x0.device}")
    if w.dtype == torch.int8:
        return chain_int8_plain(x0, w, scale, steps)
    return chain_bf16_plain(x0, w, steps)

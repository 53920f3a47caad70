"""The decode-chain kernel's register walk and the relayout's host path,
on the CPU (no card, no nvcc).

``csrc/decode_chain.cu`` keeps x in its warps' registers: a warp's
accumulator fragments of one layer become its A fragments of the next,
with no shuffle, because ``pack_weights`` lays each layer out as the
kernel's wgmma reads it (int8 rows in ``kperm``'s k-order).  The model
below walks that index math lane by lane for the four warps' row strips:
B read from the packed layers through the kernel's descriptor (K-major,
no swizzle), the products on the PTX fragment layouts of A in registers
and of the accumulators (bf16 k16, int8 k32), the epilogue accumulator
-> A per thread, the output stores.  Where the sums are exact (int8
always; bf16 on integer-valued inputs) it must equal the plain version
bit for bit.
"""

import numpy as np
import pytest
import torch

from vqvae_tpu_torch.kernels import decode_chain_cuda as chn
from vqvae_tpu_torch.kernels import upsample_cuda as uc
from vqvae_tpu_torch.probes import decode_int8_micro as dim

CPU = torch.device("cpu")
W = chn.WIDTH
LANE = np.arange(32)
G, T = LANE // 4, LANE % 4          # a lane's group and thread in group


def _bf16_bits(x: torch.Tensor) -> np.ndarray:
    """bf16(x) (round to nearest even) as uint16 bits."""
    return x.to(torch.bfloat16).view(torch.int16).numpy().view(np.uint16)


def _bf16_val(bits: np.ndarray) -> np.ndarray:
    return (bits.astype(np.uint32) << 16).view(np.float32)


def _b_matrix(layer: np.ndarray, kb: int, n0: int, int8: bool
              ) -> np.ndarray:
    """B ``[K, 64]`` of k-block kb and columns n0 .. n0 + 63, read as
    wgmma reads a K-major operand without swizzle from the kernel's
    descriptor: start ``4096 kb + 256 (n0 / 8)``, LBO 128 (the next 16
    bytes of k), SBO 256 (the next 8 rows of n), each core matrix 8 rows
    of n by 16 contiguous bytes of k."""
    es = 1 if int8 else 2
    k = np.arange(32 // es)[:, None]
    n = np.arange(64)[None, :]
    kbyte = k * es
    at = (4096 * kb + 256 * (n0 // 8) + 256 * (n // 8) + 128 * (kbyte // 16)
          + 16 * (n % 8) + kbyte % 16)
    if int8:
        return layer.view(np.int8)[at].astype(np.int64)
    bits = layer[at].astype(np.uint16) | layer[at + 1].astype(np.uint16) << 8
    return _bf16_val(bits).astype(np.float64)


def _a_matrix(a: np.ndarray, int8: bool) -> np.ndarray:
    """A ``[16, K]`` from a warp's A registers ``[32, 4]``: register q of
    lane (g, t) holds row g + 8 (q % 2), k = c (q // 2) + e t + (element),
    with c = 8, e = 2 for bf16 and c = 16, e = 4 for int8."""
    if int8:
        el = a.view(np.int8).reshape(32, 4, 4).astype(np.int64)
        A = np.zeros((16, 32), np.int64)
        for q in range(4):
            for i in range(4):
                A[G + 8 * (q % 2), 16 * (q // 2) + 4 * T + i] = el[:, q, i]
        return A
    el = _bf16_val(a.view(np.uint16).reshape(32, 4, 2)).astype(np.float64)
    A = np.zeros((16, 16))
    for q in range(4):
        for i in range(2):
            A[G + 8 * (q % 2), 8 * (q // 2) + 2 * T + i] = el[:, q, i]
    return A


def _mma(acc: np.ndarray, a, B: np.ndarray, int8: bool) -> None:
    """acc ``[32, 32]`` += A B over one warp's 16 rows and 64 columns
    (half a layer); lane (g, t)'s d[4j + q] = D[g + 8 (q // 2)][8j + 2t +
    q % 2].  The sums are exact (int8, or bf16 on small integers)."""
    D = _a_matrix(a, int8) @ B
    for j in range(8):
        for q in range(4):
            acc[:, 4 * j + q] += D[G + 8 * (q // 2), 8 * j + 2 * T + q % 2]


def _quant(v: np.ndarray) -> np.ndarray:
    """int8(trunc(clip(v * 127, -127, 127))), float32 arithmetic."""
    return np.clip(v * np.float32(127), -127, 127).astype(np.int8)


def _pack_int8_block(v: np.ndarray) -> np.ndarray:
    """A registers ``[32, 4]`` of one int8 k-block from the C values
    ``v [32, 4 (n-tile w), 4 (q)]`` of its four n-tiles: register
    2 (w // 2) + q // 2 holds byte 2 (w % 2) + q % 2."""
    b = np.zeros((32, 4, 4), np.int8)
    for w in range(4):
        for q in range(4):
            b[:, 2 * (w // 2) + q // 2, 2 * (w % 2) + q % 2] = _quant(
                v[:, w, q])
    return b.view(np.uint32).reshape(32, 4)


def _c_values(x: np.ndarray, r0: int, ntiles: int) -> np.ndarray:
    """x's values ``[32, ntiles, 4]`` in C layout for rows r0 .. r0 + 15."""
    v = np.zeros((32, ntiles, 4), x.dtype)
    for j in range(ntiles):
        for q in range(4):
            v[:, j, q] = x[r0 + G + 8 * (q // 2), 8 * j + 2 * T + q % 2]
    return v


def model_chain(x0, w, steps, scale=None) -> torch.Tensor:
    """The kernel's chain, walked lane by lane over its four compute
    warps, on the layers ``chn.pack_weights`` packs for it."""
    int8 = w.dtype == torch.int8
    L = w.shape[0]
    packed = chn.pack_weights(w if int8 else w.to(torch.bfloat16))
    layers = packed.contiguous().view(torch.uint8).numpy().reshape(L, -1)
    sc = (scale.float().reshape(L).numpy() if int8 else None)
    x0f = x0.to(torch.bfloat16).float().numpy()
    x0b = _bf16_bits(x0.float()).reshape(chn.ROWS, W)
    nkb = W // (32 if int8 else 16)
    out = np.zeros((chn.ROWS, W), np.float32)
    for warp in range(4):
        r0 = 16 * warp
        if int8:
            v0 = _c_values(x0f, r0, W // 8)
            a = [_pack_int8_block(v0[:, 4 * kb:4 * kb + 4]) for kb in
                 range(nkb)]
        else:
            a = [np.stack([(x0b[r0 + G + 8 * (q % 2),
                                8 * (q // 2) + 16 * kb + 2 * T + 1]
                            .astype(np.uint32) << 16) |
                           x0b[r0 + G + 8 * (q % 2),
                               8 * (q // 2) + 16 * kb + 2 * T]
                           for q in range(4)], 1) for kb in range(nkb)]
        for i in range(L * steps):
            l = i % L
            acc = np.zeros((2, 32, 32), np.int64 if int8 else np.float64)
            for half in range(2):
                for kb in range(nkb):
                    _mma(acc[half], a[kb],
                         _b_matrix(layers[l], kb, 64 * half, int8), int8)
            # [tile, lane, q] of the whole layer
            acc = acc.reshape(2, 32, 8, 4).transpose(0, 2, 1, 3).reshape(
                16, 32, 4)
            if int8:
                v = (acc.astype(np.float32) * sc[l]) * np.float32(0.0078125)
                v = v.transpose(1, 0, 2)                 # [lane, tile, q]
                if i == L * steps - 1:
                    for j in range(W // 8):
                        for q in range(4):
                            out[r0 + G + 8 * (q // 2),
                                8 * j + 2 * T + q % 2] = v[:, j, q]
                else:
                    a = [_pack_int8_block(v[:, 4 * kb:4 * kb + 4])
                         for kb in range(nkb)]
            else:
                end = l == L - 1
                bits = _bf16_bits(torch.from_numpy(
                    acc.astype(np.float32)))
                if end:
                    bits = _bf16_bits(torch.from_numpy(
                        _bf16_val(bits) * np.float32(0.125)))
                bits = bits.astype(np.uint32)
                # k-block j of x: n-tile 2j's c0|c1, c2|c3, then 2j + 1's
                a = [np.stack([bits[2 * j + q // 2, :, 2 * (q % 2)] |
                               bits[2 * j + q // 2, :, 2 * (q % 2) + 1] << 16
                               for q in range(4)], 1)
                     for j in range(nkb)]
        if not int8:
            for kb in range(nkb):
                for q in range(4):
                    for e in range(2):
                        out[r0 + G + 8 * (q % 2),
                            16 * kb + 8 * (q // 2) + 2 * T + e] = _bf16_val(
                            (a[kb][:, q] >> (16 * e)) & 0xFFFF)
    return torch.from_numpy(out).to(torch.bfloat16)


def _held_or_script(L):
    x, w16, w8, sc = dim.script_data(L, CPU)
    return x, w16, w8, (sc if L <= 2 else dim.held_scales(L, CPU))


def test_kperm_is_a_permutation_within_each_k_block():
    p = chn.kperm()
    assert sorted(p.tolist()) == list(range(W))
    assert torch.equal(p // 32, torch.arange(W) // 32)


@pytest.mark.parametrize("int8", [False, True], ids=["bf16", "int8"])
def test_pack_weights_lays_out_core_matrices(int8):
    """k-block kb's core matrix (8 rows of n from 8 nb, 16 bytes of k from
    half h) is 128 contiguous bytes, at 4096 kb + 256 nb + 128 h; int8
    rows in kperm's order; a layer is one bulk copy of 16-byte pieces."""
    g = torch.Generator().manual_seed(0)
    if int8:
        w = torch.randint(-128, 128, (3, W, W), generator=g, dtype=torch.int8)
    else:
        w = torch.randn(3, W, W, generator=g).to(torch.bfloat16)
    E = 16 if int8 else 8
    p = chn.pack_weights(w)
    assert tuple(p.shape) == (3, W // (2 * E), W // 8, 2, 8, E)
    assert p.dtype == w.dtype and p.is_contiguous()
    kb, nb, h, r, c = np.meshgrid(*(np.arange(s) for s in p.shape[1:]),
                                  indexing="ij")
    k = 2 * E * kb + E * h + c
    rows = chn.kperm().numpy()[k] if int8 else k
    assert torch.equal(p, w[:, torch.from_numpy(rows),
                            torch.from_numpy(8 * nb + r)])
    assert p[0].numel() * p.element_size() == W * 32 * (W // (2 * E))


@pytest.mark.parametrize("L,steps", [(2, 1), (2, 2), (30, 1), (30, 2)])
def test_int8_register_walk_equals_plain_bit_for_bit(L, steps):
    """The script's data at L=2; the held scales at the timed L=30."""
    x, _, w8, sc = _held_or_script(L)
    want = chn.chain_int8_plain(x, w8, sc, steps)
    assert float(want.float().abs().max()) > 0
    assert torch.equal(model_chain(x, w8, steps, sc), want)


@pytest.mark.parametrize("L,steps", [(3, 1), (3, 2), (7, 1)])
def test_bf16_register_walk_equals_plain_on_integer_inputs(L, steps):
    """Integer-valued x0 and w: every float32 sum is exact in any order,
    so the tensor cores' order and the plain version's agree bit for
    bit.  w has ~13 non-zeros (+-1) a column, which keeps the sums far
    below 2^24 at these depths while they pass 256, where bf16 starts to
    round integers."""
    rng = np.random.default_rng(L + steps)
    x = torch.from_numpy(rng.integers(-2, 3, (chn.ROWS, W))).to(
        torch.bfloat16)
    w = torch.from_numpy(rng.choice([-1, 0, 1], (L, W, W),
                                    p=[0.05, 0.9, 0.05])).to(torch.bfloat16)
    top, xs = 0.0, x
    for _ in range(steps):      # the largest sum before its rounding
        for l in range(L):
            y = xs.float() @ w[l].float()
            top, xs = max(top, float(y.abs().max())), y.to(torch.bfloat16)
        xs = xs * 0.125
    assert 256 < top < 2 ** 20
    want = chn.chain_bf16_plain(x, w, steps)
    assert torch.equal(model_chain(x, w, steps), want)


def test_chain_kernel_refuses_what_it_does_not_take():
    x, w16, w8, sc = dim.script_data(2, CPU)
    with pytest.raises(ValueError):
        chn.chain_kernel(x, w16, 1)                 # a CPU tensor
    with pytest.raises(ValueError):
        chn.chain_kernel(x[:32], w16, 1)
    with pytest.raises(ValueError):
        chn.chain_kernel(x, w16, 0)


@pytest.mark.parametrize("x,shape,exc", [
    (torch.zeros(4, 8, dtype=torch.float64), (8, 4), TypeError),
    (torch.zeros(4, 8, dtype=torch.bfloat16), (8, 4), TypeError),
    (torch.zeros(32), (8, 4), ValueError),
    (torch.zeros(2, 2, 2, 4), (8, 4), ValueError),
    (torch.zeros(4, 8), (4, 2, 2, 2), ValueError),
    (torch.zeros(4, 8), (8, 5), ValueError),
    (torch.zeros(4, 8), (8, 4), ValueError),        # not on the card
])
def test_relayout_kernel_refuses_dtype_rank_numel(x, shape, exc):
    """The lean host path keeps its checks: float32, rank 2 or 3 on both
    sides, one numel, a CUDA tensor; each refused before any build."""
    with pytest.raises(exc):
        uc.relayout_kernel(x, shape)

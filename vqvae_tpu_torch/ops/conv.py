"""1-D convolution primitives (port of ``vqvae_tpu/ops/conv.py``).

Layout is ``[B, T, C]`` and weights ``[k, C_in, C_out]``, as in the JAX
package.  Matrix products here accumulate in float64 and round once to
the compute dtype: BLAS libraries (oneDNN/MKL on the CPU, cuBLAS on the
card) choose their blocking, and so their summation order, by the shape
of the call, so a float32 accumulation of one output row can change
with the number of rows in the call.  The streaming encoder re-encodes
windows of varying width and must emit the same codes as one call over
the whole stream; a float64 sum rounded to float32 or bfloat16 does not
depend on the order in any case that matters.
"""

from __future__ import annotations

import math
from typing import Dict

import torch


def _lecun_normal(shape, fan_in, dtype, generator, device):
    gen_dev = generator.device if generator is not None else "cpu"
    w = torch.randn(shape, generator=generator, dtype=dtype,
                    device=gen_dev) / math.sqrt(fan_in)
    return w.to(device)


def dense_init(in_ch: int, out_ch: int, dtype=torch.float32,
               generator=None, device="cpu") -> Dict[str, torch.Tensor]:
    return {"w": _lecun_normal((in_ch, out_ch), in_ch, dtype, generator,
                               device),
            "b": torch.zeros((out_ch,), dtype=dtype, device=device)}


def conv1d_init(in_ch: int, out_ch: int, kernel: int, dtype=torch.float32,
                generator=None, device="cpu") -> Dict[str, torch.Tensor]:
    """Weights for a 1-D conv: w ``[kernel, in_ch, out_ch]``."""
    return {"w": _lecun_normal((kernel, in_ch, out_ch), kernel * in_ch,
                               dtype, generator, device),
            "b": torch.zeros((out_ch,), dtype=dtype, device=device)}


def upsample_init(in_ch: int, out_ch: int, hop: int, kernel_mult: int = 2,
                  dtype=torch.float32, generator=None, device="cpu"
                  ) -> Dict[str, torch.Tensor]:
    return conv1d_init(in_ch, out_ch, hop * kernel_mult, dtype, generator,
                       device)


def matmul(x: torch.Tensor, w: torch.Tensor, dtype) -> torch.Tensor:
    """``x @ w`` in ``dtype``: inputs rounded to ``dtype``, products
    summed in float64, result rounded once (see module note)."""
    return (x.to(dtype).double() @ w.to(dtype).double()).to(dtype)


def shift_right(x: torch.Tensor, n: int) -> torch.Tensor:
    """Shift ``[B, T, C]`` right along T by n, zero-filling (causal pad)."""
    if n == 0:
        return x
    return torch.nn.functional.pad(x, (0, 0, n, 0))[:, :x.shape[1], :]


def causal_conv_apply(params, x: torch.Tensor, dilation: int = 1,
                      dtype=None) -> torch.Tensor:
    """Causal dilated 1-D conv ``[B, T, C_in] -> [B, T, C_out]``: output
    t reads inputs t, t-d, ..., t-(k-1)d, the left context zero-padded;
    as in the JAX package, one dense product a tap over the shifted
    input, the taps added in the JAX package's order, then the bias."""
    w = params["w"]
    dtype = dtype or x.dtype
    x = x.to(dtype)
    k = w.shape[0]
    y = matmul(x, w[k - 1], dtype)
    for j in range(k - 1):
        y = y + matmul(shift_right(x, (k - 1 - j) * dilation), w[j], dtype)
    if "b" in params:
        y = y + params["b"].to(dtype)
    return y


def strided_conv_apply(params, x: torch.Tensor, stride: int,
                       dtype=None) -> torch.Tensor:
    """Strided 'SAME' 1-D conv: ``[B, T, C_in] -> [B, ceil(T/s), C_out]``.

    SAME pads ``max((n_out-1)*s + k - T, 0)`` in total, the smaller half
    on the left — ``(k - s)//2`` when ``T % s == 0`` — exactly as
    ``lax.conv_general_dilated(padding="SAME")`` and the JAX package's
    folded-matmul form.  Each output row is one window of ``k`` input
    rows times the ``[k*C_in, C_out]`` weight.
    """
    w = params["w"]
    dtype = dtype or x.dtype
    B, T, C = x.shape
    k, _, Co = w.shape
    s = stride
    n_out = -(-T // s)
    total = max((n_out - 1) * s + k - T, 0)
    left = total // 2
    xp = torch.nn.functional.pad(x.to(dtype), (0, 0, left, total - left))
    win = xp.unfold(1, k, s)                      # [B, n_out, C, k]
    win = win.transpose(2, 3).reshape(B, n_out, k * C)
    y = matmul(win, w.reshape(k * C, Co), dtype)
    if "b" in params:
        y = y + params["b"].to(dtype)
    return y


def upsample_apply(params, z: torch.Tensor, hop: int,
                   dtype=None) -> torch.Tensor:
    """``[B, T_lat, C_in] -> [B, T_lat*hop, C_out]``: the stride-``hop``
    SAME transposed conv with a kernel of ``2*hop`` taps.

    ``lax.conv_transpose`` applies the kernel flipped along time, so
    with ``wf = w[::-1]`` the VALID output is
    ``v[p*hop + r] += z[p] @ wf[r]`` for ``r < 2*hop``, and SAME crops
    ``hop//2`` samples from its front (and the rest of the last
    frame's tail).  Each audio sample is the sum of two taps, from
    frames ``p`` and ``p-1``.
    """
    w = params["w"]
    dtype = dtype or z.dtype
    K, cin, cout = w.shape
    B, Tl, _ = z.shape
    if K != 2 * hop or hop % 2:
        raise ValueError(f"upsampler kernel must have 2*hop taps with an "
                         f"even hop, got {K} taps for hop {hop}")
    wf = torch.flip(w, (0,))
    wmat = wf.permute(1, 0, 2).reshape(cin, K * cout)
    taps = matmul(z.reshape(B * Tl, cin), wmat, torch.float32)
    taps = taps.reshape(B, Tl, 2, hop, cout)
    head = taps[:, :, 0]                           # frame p, r < hop
    tail = torch.nn.functional.pad(taps[:, :, 1], (0, 0, 0, 0, 1, 0))
    v = (head + tail[:, :-1]).to(dtype).reshape(B, Tl * hop, cout)
    last = tail[:, -1, :hop // 2].to(dtype)        # SAME keeps hop//2 more
    y = torch.cat([v[:, hop // 2:], last], dim=1)
    if "b" in params:
        y = y + params["b"].to(dtype)
    return y

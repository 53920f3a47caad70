"""Frozen work counts: the operations and bytes that ``train_mfu`` and
the rooflines divide by, and the card's peaks.

Each count is the layer's own work, worked out from the configuration's
shapes and independent of how a kernel computes it: the products of the
forward, three times for forward and backward, nothing recomputed, no
saved gates, each input, weight, output and gradient read or written
once.  So a kernel that recomputes or saves more is measured against the
same work as one that does not.

``train_step_flops`` is a copy of the program's analytic count of a
training step (forward plus twice the forward for the backward), frozen
here so that a change to the program cannot change the yardstick.
"""

from __future__ import annotations

# NVIDIA's data sheet for the H100 SXM, dense rates, at 700 W
PEAK_BF16 = 989e12      # bf16 tensor-core operations a second
PEAK_BYTES = 3.35e12    # HBM3 bytes a second


def train_step_flops(m: dict, T: int, batch: int) -> float:
    """Operations of one training step of a model with sizes ``m`` (the
    keys of the configuration's ``model`` group) on ``batch`` slices of
    ``T`` samples."""
    R, S, d, mu = (m["residual_channels"], m["skip_channels"], m["d"],
                   m["mu"])
    L = m["n_loop"] * m["n_layer"]
    hop = m["enc_stride"] ** m["enc_layers"]
    dec = L * (2 * R * 2 * R + d * 2 * R + R * R + R * S)
    head = S * S + S * mu
    emb = 2 * R
    enc, ch_in, t = 0.0, 1, T
    for _ in range(m["enc_layers"]):
        t //= m["enc_stride"]
        enc += t * m["enc_kernel"] * ch_in * m["enc_channels"] / T
        ch_in = m["enc_channels"]
    enc += (T // hop) * m["enc_channels"] * d / T
    ups = 2 * d * d
    vq = (m["K"] * d) / hop
    macs_per_sample = dec + head + emb + enc + ups + vq
    return 3.0 * 2.0 * macs_per_sample * batch * T


def stack_work(m: dict, B: int, T: int, es: int = 2) -> tuple[float, float]:
    """(operations, bytes) of the decoder stack's forward and backward
    for ``B`` rows of ``T`` samples in a compute dtype of ``es`` bytes.

    Operations: per position and layer the dilated conv's two taps
    (2R x 2R), the condition's projection (d x 2R), the residual (R x R)
    and the skip (R x S) products, twice the operations of their
    multiply-adds, and three times that for forward and backward.
    Bytes: the layer input h0 [N, R], the condition [N, d], the speaker
    term [B, L, 2R] and the weights read once; the skips [N, S] written
    once; the skips' gradient read once; the gradients of h0, the
    condition and the speaker term written once in the compute dtype and
    the weights' gradients once in float32."""
    R, S, d = m["residual_channels"], m["skip_channels"], m["d"]
    L = m["n_loop"] * m["n_layer"]
    N = B * T
    flops = 3 * 2 * N * L * (4 * R * R + 2 * d * R + R * R + R * S)
    wcount = L * (4 * R * R + 2 * d * R + R * R + R + R * S + S)
    fwd = es * (N * R + N * d + B * L * 2 * R + wcount + N * S)
    bwd = es * (N * S + N * R + N * d + B * L * 2 * R) + 4 * wcount
    return float(flops), float(fwd + bwd)


def head_work(m: dict, B: int, T: int, es: int = 2) -> tuple[float, float]:
    """(operations, bytes) of the head and its cross-entropy, forward and
    backward: relu(skips) @ w1 (S x S) and the logits' product (S x mu)
    on every position, three times their operations; the skips, the
    targets and the weights read once, the skips' gradient written once
    in the compute dtype and the weights' gradients once in float32."""
    S, mu = m["skip_channels"], m["mu"]
    N = B * T
    flops = 3 * 2 * N * (S * S + S * mu)
    weights = S * S + S + S * mu + mu
    nbytes = es * (N * S + weights) + 4 * N + es * N * S + 4 * weights
    return float(flops), float(nbytes)


def bound_s(flops: float, nbytes: float) -> float:
    """The least time the card could take for this work: the larger of
    the operations at the bf16 rate and the bytes at the memory rate."""
    return max(flops / PEAK_BF16, nbytes / PEAK_BYTES)

"""Work counts of NSynth's WaveNet autoencoder (magenta ``h512_bo16``),
from the configuration's widths alone: the operations of a training
step that ``train_mfu.nsynth`` divides by, and the filter-3 stack's
forward work that ``stack_fwd_roofline.nsynth`` bounds.

Operations are twice the multiply-adds of every product of the
published model that reaches the loss, three times the forward for a
training step (forward and backward), nothing recomputed.  The last
decoder layer's residual product feeds nothing (magenta computes it,
and no output reads it), so it is not counted.  Bias adds, the gates
and the softmax are not operations of a product and are left out.
"""

from __future__ import annotations


def forward_flops(m: dict) -> dict:
    """Forward operations a sample, by part: ``stack`` (the start conv,
    ``skip_start`` and the gated layers), ``encoder`` (its convs and the
    bottleneck's 1x1), ``cond`` (the frame-rate condition maps, a
    sample's share) and ``head``."""
    R, S, mu, k, L = (m["width"], m["skip_width"], m["mu"],
                      m["filter_length"], m["num_layers"])
    C, e, ka, La, hop = (m["ae_width"], m["ae_bottleneck_width"],
                         m["ae_filter_length"], m["ae_num_layers"],
                         m["ae_hop_length"])
    stack = k * R + R * S + L * (k * R * 2 * R + R * S) + (L - 1) * R * R
    encoder = ka * C + La * (ka * C * C + C * C) + C * e
    cond = (L * e * 2 * R + e * S) / hop
    head = S * S + S * mu
    return {"stack": 2.0 * stack, "encoder": 2.0 * encoder,
            "cond": 2.0 * cond, "head": 2.0 * head}


def train_step_flops(m: dict, T: int, batch: int) -> float:
    """Operations of one training step on ``batch`` crops of ``T``."""
    return 3.0 * sum(forward_flops(m).values()) * batch * T


def stack_fwd_work(m: dict, B: int, T: int, es: int = 2
                   ) -> tuple[float, float]:
    """(operations, bytes) of the decoder stack's forward on ``B`` crops
    of ``T`` samples in a compute dtype of ``es`` bytes.  Bytes: the
    float32 input read once, each layer's frame-rate condition ``[B, T /
    hop, 2R]`` and every weight and bias read once, the summed skips
    ``[N, S]`` written once."""
    R, S, k, L = m["width"], m["skip_width"], m["filter_length"], \
        m["num_layers"]
    N = B * T
    flops = forward_flops(m)["stack"] * N
    weights = (k * R + R + R * S + S
               + L * (k * R * 2 * R + 2 * R + R * S + S)
               + (L - 1) * (R * R + R))
    nbytes = 4 * N + es * (L * (N // m["ae_hop_length"]) * 2 * R
                           + weights + N * S)
    return float(flops), float(nbytes)

"""The plain reference: the VQ-VAE of van den Oord et al. (2017) as the
configuration states it, in float32 PyTorch, written from its equations.

It imports nothing of the program.  Weights are a flat dict keyed as the
program exports them (``decoder/layers/wf``, ...), each leaf in the
layout the configuration's shapes give:

* encoder: ``enc_layers`` stride-``enc_stride`` convs of ``enc_kernel``
  taps ('SAME' padding, ReLU), weights ``[k, C_in, C_out]``, then a
  ``[C, d]`` projection;
* VQ: the nearest of ``K`` codebook rows ``[K, d]`` by L2 distance, ties
  to the first; straight-through; loss2 ``mean((sg z - e)^2)``, loss3
  ``mean((z - sg e)^2)``;
* upsampler: the stride-``hop`` transposed conv of ``2 hop`` taps with
  its 'SAME' crop of ``hop // 2`` samples at the front;
* decoder: the input embedding as a two-tap causal conv over the one-hot
  ids ``[2, mu, R]``; ``L`` gated residual layers with dilations
  ``2^i`` repeated ``n_loop`` times: ``u = h(t-dil) wf0 + h(t) wf1 +
  c(t) vc + s vg + bf``, ``z = tanh(u_a) sigmoid(u_b)``,
  ``h += z wr + br``, ``skips += z ws + bs``; head
  ``relu(relu(skips) h1 + b1) h2 + b2``; loss1 the mean cross-entropy
  of the next sample's id.

``Prec`` rounds the operands of every product; the reference runs with
``Prec(None)`` (float32, TF32 off), the control with a lower precision.
"""

from __future__ import annotations

import math
from typing import Dict, Optional

import torch
import torch.nn.functional as F

FP8_MAX = 448.0     # largest finite float8 e4m3 value


def _fp8(x: torch.Tensor) -> torch.Tensor:
    """``x`` rounded to float8 e4m3 with one scale a tensor (its largest
    magnitude to 448), back in float32."""
    scale = x.abs().amax().clamp(min=1e-30) / FP8_MAX
    return (x / scale).to(torch.float8_e4m3fn).float() * scale


class _GradFp8(torch.autograd.Function):
    """Identity forward; the gradient rounded to float8 on its way back,
    so a product's backward takes float8 operands too."""

    @staticmethod
    def forward(ctx, x):
        return x

    @staticmethod
    def backward(ctx, g):
        return _fp8(g)


class Prec:
    """Rounding of a product's operands: ``None`` keeps float32;
    ``"fp8"`` rounds each operand of the forward product, and the
    gradient that reaches its output in the backward, to float8 e4m3
    with one scale a tensor, as an fp8 matmul takes them."""

    def __init__(self, kind: Optional[str] = None):
        if kind not in (None, "fp8"):
            raise ValueError(f"unknown precision {kind!r}")
        self.kind = kind

    def r(self, x: torch.Tensor) -> torch.Tensor:
        """A product's operand, rounded (the rounding's own gradient is
        the identity)."""
        if self.kind is None:
            return x
        with torch.no_grad():
            q = _fp8(x.detach())
        return x + (q - x).detach()

    def out(self, y: torch.Tensor) -> torch.Tensor:
        """A product's output: its gradient rounded in the backward."""
        if self.kind is None or not y.requires_grad:
            return y
        return _GradFp8.apply(y)

    def mm(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        return self.out(self.r(a) @ self.r(b))


F32 = Prec(None)


def strict_float32() -> None:
    """Products in float32 on the card: TF32 off."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


# ---------------------------------------------------------------------------
# framing
# ---------------------------------------------------------------------------


def mu_law_encode(x: torch.Tensor, mu: int) -> torch.Tensor:
    """'round' mu-law binning: ``round((y + 1) / 2 (mu - 1))`` with
    ``y = sign(x) log(1 + (mu-1)|x|) / log(mu)``."""
    m = float(mu - 1)
    x = x.clamp(-1.0, 1.0)
    y = torch.sign(x) * torch.log1p(m * x.abs()) / math.log1p(m)
    return torch.round((y + 1.0) * 0.5 * m).long()


def mu_law_decode(ids: torch.Tensor, mu: int) -> torch.Tensor:
    m = float(mu - 1)
    y = ids.float() * (2.0 / m) - 1.0
    x = torch.sign(y) * torch.expm1(y.abs() * math.log1p(m)) / m
    return x.clamp(-1.0, 1.0)


def frame(slices: torch.Tensor, mu: int):
    """Raw ``[B, T+1]`` float slices -> (encoder input [B, T], input ids
    [B, T], target ids [B, T])."""
    ids = mu_law_encode(slices, mu)
    wav = mu_law_decode(ids, mu)
    return wav[:, :-1], ids[:, :-1], ids[:, 1:]


# ---------------------------------------------------------------------------
# encoder, VQ, upsampler
# ---------------------------------------------------------------------------


def encoder(p: Dict[str, torch.Tensor], m: dict, wav: torch.Tensor,
            prec: Prec = F32) -> torch.Tensor:
    """``[B, T]`` -> z ``[B, T / hop, d]``."""
    x = wav[:, None, :]                                   # [B, C=1, T]
    k, s = m["enc_kernel"], m["enc_stride"]
    for i in range(m["enc_layers"]):
        w, b = p[f"encoder/layers/{i}/w"], p[f"encoder/layers/{i}/b"]
        T = x.shape[-1]
        n_out = -(-T // s)
        total = max((n_out - 1) * s + k - T, 0)
        x = F.pad(x, (total // 2, total - total // 2))
        y = prec.out(F.conv1d(prec.r(x), prec.r(w.permute(2, 1, 0)),
                              stride=s))
        x = torch.relu(y + b[None, :, None])
    x = x.transpose(1, 2)                                 # [B, Tl, C]
    return prec.mm(x, p["encoder/proj/w"]) + p["encoder/proj/b"]


def nearest(z: torch.Tensor, cb: torch.Tensor) -> torch.Tensor:
    """Index of the nearest codebook row (float64 distances), ties to
    the first."""
    zd, cd = z.detach().double(), cb.detach().double()
    score = 2.0 * (zd @ cd.T) - (cd * cd).sum(-1)
    return score.argmax(-1)


def upsample(p: Dict[str, torch.Tensor], m: dict, e: torch.Tensor,
             prec: Prec = F32) -> torch.Tensor:
    """``[B, Tl, d]`` -> ``[B, Tl * hop, d]``: ``out[p hop + r] +=
    e[p] W[2hop - 1 - r]`` for ``r < 2 hop``, then the 'SAME' crop."""
    hop = m["enc_stride"] ** m["enc_layers"]
    w = p["decoder/upsample/w"]                           # [2hop, d, d]
    wt = torch.flip(w, (0,)).permute(1, 2, 0)             # [d_in, d_out, 2hop]
    y = prec.out(F.conv_transpose1d(prec.r(e.transpose(1, 2)), prec.r(wt),
                                    stride=hop))          # [B, d, (Tl+1)hop]
    T = e.shape[1] * hop
    y = y[:, :, hop // 2: hop // 2 + T].transpose(1, 2)
    return y + p["decoder/upsample/b"]


# ---------------------------------------------------------------------------
# decoder
# ---------------------------------------------------------------------------


def dilations(m: dict):
    return [2 ** i for i in range(m["n_layer"])] * m["n_loop"]


def _shift(x: torch.Tensor, n: int) -> torch.Tensor:
    """``x[t - n]`` along axis 1, zero before the start."""
    return F.pad(x, (0, 0, n, 0))[:, :x.shape[1]]


def speaker_term(p, spk: torch.Tensor) -> torch.Tensor:
    """``[L, B, 2R]``: the speaker embedding's projection plus bf."""
    g = p["decoder/speaker/w"][spk]                       # [B, g]
    return torch.einsum("bg,lgr->lbr", g, p["decoder/layers/vg"]) + \
        p["decoder/layers/bf"][:, None, :]


def skips(p, m: dict, ids_in: torch.Tensor, cond: torch.Tensor,
          spk: torch.Tensor, prec: Prec = F32) -> torch.Tensor:
    """Summed skips ``[B, T, S]`` of the gated residual stack over input
    ids ``[B, T]`` and condition ``[B, T, d]``."""
    R = m["residual_channels"]
    emb = p["decoder/emb/w"]                              # [2, mu, R]
    h = emb[1][ids_in] + _shift(emb[0][ids_in], 1) + p["decoder/emb/b"]
    gc = speaker_term(p, spk)
    wf, vc = p["decoder/layers/wf"], p["decoder/layers/vc"]
    wr, br = p["decoder/layers/wr"], p["decoder/layers/br"]
    ws, bs = p["decoder/layers/ws"], p["decoder/layers/bs"]
    out = 0.0
    for i, dil in enumerate(dilations(m)):
        u = (prec.mm(_shift(h, dil), wf[i, 0]) + prec.mm(h, wf[i, 1])
             + prec.mm(cond, vc[i]) + gc[i][:, None, :])
        z = torch.tanh(u[..., :R]) * torch.sigmoid(u[..., R:])
        h = h + prec.mm(z, wr[i]) + br[i]
        out = out + prec.mm(z, ws[i]) + bs[i]
    return out


def logits(p, skip: torch.Tensor, prec: Prec = F32) -> torch.Tensor:
    x = torch.relu(skip)
    x = torch.relu(prec.mm(x, p["decoder/head/h1/w"]) + p["decoder/head/h1/b"])
    return prec.mm(x, p["decoder/head/h2/w"]) + p["decoder/head/h2/b"]


def cross_entropy(lg: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """Mean over positions of ``logsumexp - logit[target]``."""
    lz = torch.logsumexp(lg, -1)
    return (lz - lg.gather(-1, targets[..., None])[..., 0]).mean()

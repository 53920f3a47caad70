"""The WaveNet autoencoder of NSynth (Engel et al. 2017,
arXiv:1704.01279; magenta ``nsynth/wavenet/h512_bo16.py``): init and the
training forward.

With ``xs`` the scaled mu-law input (``audio/framing.py::frame_scalar``),
C = ``ae_width``, R = ``width``, S = ``skip_width``, e =
``ae_bottleneck_width``, k = the filter length and L the layer count:

* encoder, non-causal: ``en = conv_k(xs) -> C``; then, for each
  dilation ``d``, ``en += conv1x1(relu(conv_k,d(relu(en)))) -> C``, the
  ``k`` taps at ``t - d``, ``t``, ``t + d``;
* bottleneck: ``conv1x1(en) -> e`` averaged over each frame of ``hop``
  samples: a continuous latent ``[B, T / hop, e]``.  The average is
  taken before the (linear) 1x1, in float32, which is the same map;
* decoder: ``l = causal_conv_k(xs_prev) -> R``, ``s = conv1x1(l) -> S``;
  for each dilation ``d``: ``u = causal_conv_k,d(l) -> 2R`` (taps
  ``t - 2d``, ``t - d``, ``t``) plus ``conv1x1(latent) -> 2R`` repeated
  over the frame's samples; ``z = sigmoid(u[:R]) tanh(u[R:])``;
  ``l += conv1x1(z) -> R``, ``s += conv1x1(z) -> S``.  The last layer's
  ``l`` is read by nothing, so its residual product is not computed;
* head: ``relu(conv1x1(relu(s)) -> S + conv1x1(latent) -> S)``, then
  the float32 logits ``conv1x1 -> mu``; the loss is the mean softmax
  cross-entropy of the targets, the mean of the crops' means.

Every conv has a bias; a layer's dilated-conv bias is added with its
frame-rate condition.  Activations and products are in the compute
dtype, weights in float32 (cast once a step); the latent and the
frame-rate products are float32.  A k-tap conv is ``k`` products
over row slices of its once-padded input (``_TapConv``), each tap's
added into the compute-dtype output.  The decoder's gated layers are
one Function (``kernels/wavenet_ae_cuda.py::GatedStack``): the same
products, with the gate taken in float32 from the conv's output and the
condition and rounded once, and the skips summed in place.  Weights
keep the port's layout:
conv weights ``[k, C_in, C_out]``, a layer stack's leaves stacked
``[L, ...]``.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from vqvae_tpu_torch.audio.framing import ScalarBatch
from vqvae_tpu_torch.configs.wavenet_ae import WaveNetAEConfig
from vqvae_tpu_torch.kernels.wavenet_ae_cuda import gated_stack
from vqvae_tpu_torch.models.params import ParamTree
from vqvae_tpu_torch.models.wavenet import _normal
from vqvae_tpu_torch.utils import profiling
from vqvae_tpu_torch.utils.profiling import span


def causal_offsets(k: int, dilation: int) -> Tuple[int, ...]:
    """Tap j of a causal conv reads ``x[t + o_j]``: ``-(k-1)d .. 0``."""
    return tuple((j - (k - 1)) * dilation for j in range(k))


def same_offsets(k: int, dilation: int) -> Tuple[int, ...]:
    """Tap j of a centred ('same') conv reads ``x[t + o_j]``."""
    return tuple((j - (k - 1) // 2) * dilation for j in range(k))


class _TapConv(torch.autograd.Function):
    """``y[t] = sum_j x[t + o_j] @ w[j]``: ``x [B, T, C]``, ``w [k, C,
    Co]``, both in the compute dtype.  ``x`` is padded once with the
    zeros the taps reach, to ``[B, T + P, C]``, and flattened to rows;
    tap j is then the row block starting ``s_j = o_j + lo`` further on,
    a plain slice, so the conv is ``k`` products accumulated into one
    output, with no shifted copy.  Rows that straddle two crops land in
    the ``P`` rows past each crop's end, which the returned view
    ``[B, T, Co]`` leaves out (and which the backward zeroes in the
    gradient).  It saves the padded input for the backward."""

    @staticmethod
    def forward(ctx, x, w, offsets):
        B, T, C = x.shape
        k, _, Co = w.shape
        lo = max(-min(offsets), 0)
        P = lo + max(max(offsets), 0)
        X = F.pad(x, (0, 0, lo, P - lo)).view(-1, C)
        n = X.shape[0] - P
        s = [o + lo for o in offsets]
        y = x.new_empty(X.shape[0], Co)
        torch.mm(X[s[0]:s[0] + n], w[0], out=y[:n])
        for j in range(1, k):
            y[:n].addmm_(X[s[j]:s[j] + n], w[j])
        ctx.save_for_backward(X, w)
        ctx.meta = (B, T, lo, P, s)
        return y.view(B, T + P, Co)[:, :T]

    @staticmethod
    def backward(ctx, g):
        X, w = ctx.saved_tensors
        B, T, lo, P, s = ctx.meta
        k, C, Co = w.shape
        G = g.new_zeros(B, T + P, Co)
        G[:, :T] = g
        G = G.view(-1, Co)
        n = G.shape[0] - P
        gx = gw = None
        if ctx.needs_input_grad[0]:
            gX = torch.zeros_like(X)
            for j in range(k):
                gX[s[j]:s[j] + n].addmm_(G[:n], w[j].t())
            gx = gX.view(B, T + P, C)[:, lo:lo + T]
        if ctx.needs_input_grad[1]:
            gw = torch.stack([X[s[j]:s[j] + n].t() @ G[:n]
                              for j in range(k)])
        return gx, gw, None


def tap_conv(x: torch.Tensor, w: torch.Tensor, offsets) -> torch.Tensor:
    return _TapConv.apply(x, w, tuple(offsets))


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------


def init_wavenet_ae(cfg: WaveNetAEConfig,
                    generator: torch.Generator | None = None, device="cpu",
                    trainable: bool = False) -> ParamTree:
    """Random weights (``N(0, 1/fan_in)``, zero biases) in this model's
    layout; ``device="meta"`` gives a shape-only template."""
    if str(device) == "meta":
        generator = None
    R, S, mu = cfg.width, cfg.skip_width, cfg.mu
    C, e = cfg.ae_width, cfg.ae_bottleneck_width
    k, ka = cfg.filter_length, cfg.ae_filter_length
    L, La = cfg.num_layers, cfg.ae_num_layers

    def w(shape, fan_in):
        return _normal(shape, fan_in, cfg.pdtype, generator, device)

    def b(*shape):
        return torch.zeros(shape, dtype=cfg.pdtype, device=device)

    encoder = {
        "start": {"w": w((ka, 1, C), ka), "b": b(C)},
        "layers": {"wd": w((La, ka, C, C), ka * C), "bd": b(La, C),
                   "wr": w((La, C, C), C), "br": b(La, C)},
        "bottleneck": {"w": w((C, e), C), "b": b(e)},
    }
    decoder = {
        "start": {"w": w((k, 1, R), k), "b": b(R)},
        "skip_start": {"w": w((R, S), R), "b": b(S)},
        "layers": {"wf": w((L, k, R, 2 * R), k * R), "bf": b(L, 2 * R),
                   "wc": w((L, e, 2 * R), e), "bc": b(L, 2 * R),
                   "wr": w((L, R, R), R), "br": b(L, R),
                   "ws": w((L, R, S), R), "bs": b(L, S)},
        "head": {"out1": {"w": w((S, S), S), "b": b(S)},
                 "cond": {"w": w((e, S), e), "b": b(S)},
                 "logits": {"w": w((S, mu), S), "b": b(mu)}},
    }
    return ParamTree({"encoder": encoder, "decoder": decoder}, trainable)


# ---------------------------------------------------------------------------
# forward
# ---------------------------------------------------------------------------


def _frames(cfg: WaveNetAEConfig, T: int) -> int:
    if T % cfg.hop:
        raise ValueError(f"the WaveNet autoencoder needs whole frames: "
                         f"length {T} is not a multiple of {cfg.hop}")
    return T // cfg.hop


def encoder(p, cfg: WaveNetAEConfig, xs: torch.Tensor) -> torch.Tensor:
    """Scaled input ``[B, T]`` -> ``[B, T, C]`` in the compute dtype."""
    cdt, C, k = cfg.cdtype, cfg.ae_width, cfg.ae_filter_length
    B, T = xs.shape
    lay = p["layers"]
    en = tap_conv(xs[..., None].to(cdt), p["start"]["w"].to(cdt),
                  same_offsets(k, 1)) + p["start"]["b"].to(cdt)
    wd, bd = lay["wd"].to(cdt).unbind(0), lay["bd"].to(cdt).unbind(0)
    wr, br = lay["wr"].to(cdt).unbind(0), lay["br"].to(cdt).unbind(0)
    for i, dil in enumerate(cfg.ae_dilations):
        d = tap_conv(torch.relu(en), wd[i], same_offsets(k, dil))
        d = torch.relu(d + bd[i])
        en = en + torch.addmm(br[i], d.view(B * T, C), wr[i]).view(B, T, C)
    return en


def bottleneck(p, cfg: WaveNetAEConfig, en: torch.Tensor) -> torch.Tensor:
    """``[B, T, C]`` -> the latent ``[B, T / hop, e]`` in float32."""
    B, T, C = en.shape
    pooled = en.view(B, _frames(cfg, T), cfg.hop, C).mean(
        2, dtype=torch.float32)
    return pooled @ p["w"] + p["b"]


def cond_maps(p, cfg: WaveNetAEConfig, z: torch.Tensor
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The latent ``[B, F, e]`` -> each layer's frame-rate condition with
    its two biases ``[L, B, F, 2R]`` and the head's ``[B, F, S]``, in
    the compute dtype."""
    lay, hc = p["layers"], p["head"]["cond"]
    c = torch.einsum("bfe,lec->lbfc", z, lay["wc"]) + \
        (lay["bc"] + lay["bf"])[:, None, None, :]
    return c.to(cfg.cdtype), (z @ hc["w"] + hc["b"]).to(cfg.cdtype)


def _tile(x: torch.Tensor, c: torch.Tensor, hop: int) -> torch.Tensor:
    """``x [B, T, n]`` plus the frame rows ``c [B, F, n]``, each over its
    ``hop`` samples."""
    B, F, n = c.shape
    return (x.reshape(B, F, hop, n) + c[:, :, None]).view(B, F * hop, n)


def decoder_stack(p, cfg: WaveNetAEConfig, xs_prev: torch.Tensor,
                  cond: torch.Tensor) -> torch.Tensor:
    """Scaled input ``[B, T]`` (the sample before each target) and the
    conditions ``[L, B, F, 2R]`` -> the summed skips ``[B*T, S]`` in the
    compute dtype.  The gated layers are one Function (``kernels/
    wavenet_ae_cuda.py::GatedStack``: cuBLAS products around the gate
    kernels); every skip bias is added once, summed, with
    ``skip_start``'s."""
    cdt, R, k = cfg.cdtype, cfg.width, cfg.filter_length
    B, T = xs_prev.shape
    lay = p["layers"]
    l = tap_conv(xs_prev[..., None].to(cdt), p["start"]["w"].to(cdt),
                 causal_offsets(k, 1)) + p["start"]["b"].to(cdt)
    s = torch.addmm((p["skip_start"]["b"] + lay["bs"].sum(0)).to(cdt),
                    l.view(B * T, R), p["skip_start"]["w"].to(cdt))
    return gated_stack(l, s, cond, *(lay[n].to(cdt) for n in
                                     ("wf", "wr", "br", "ws")),
                       cfg.dilations, cfg.hop)


def head_logits(p, cfg: WaveNetAEConfig, s: torch.Tensor, hc: torch.Tensor
                ) -> torch.Tensor:
    """Skips ``[B*T, S]`` and the head's condition ``[B, F, S]`` ->
    float32 logits ``[B, T, mu]``."""
    cdt = cfg.cdtype
    B, F, S = hc.shape
    x = torch.addmm(p["out1"]["b"].to(cdt), torch.relu(s),
                    p["out1"]["w"].to(cdt))
    x = torch.relu(_tile(x.view(B, F * cfg.hop, S), hc, cfg.hop))
    return x.float() @ p["logits"]["w"].float() + p["logits"]["b"].float()


def apply(params, cfg: WaveNetAEConfig, batch: ScalarBatch) -> torch.Tensor:
    """The teacher-forced forward: float32 logits ``[B, T, mu]``."""
    B, T = batch.xs.shape
    with span("model.encoder"):
        en = encoder(params["encoder"], cfg, batch.xs)
    with span("model.bottleneck"):
        z = bottleneck(params["encoder"]["bottleneck"], cfg, en)
    with span("model.cond"):
        cond, hc = cond_maps(params["decoder"], cfg, z)
    with span("model.decoder_stack"):
        s = decoder_stack(params["decoder"], cfg, batch.xs_prev, cond)
    with span("model.head"):
        logits = head_logits(params["decoder"]["head"], cfg, s, hc)
    profiling.counter("ae.samples", B * T)
    profiling.counter("ae.frames", z.shape[0] * z.shape[1])
    return logits


def forward(params, cfg: WaveNetAEConfig, batch: ScalarBatch
            ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Training forward: (loss, metrics).  The metrics hold the loss and
    each crop's own (``crop_loss [B]``); the loss is their mean."""
    logits = apply(params, cfg, batch)
    picked = logits.gather(-1, batch.targets.long()[..., None])[..., 0]
    crop = (torch.logsumexp(logits, -1) - picked).mean(1)
    loss = crop.mean()
    return loss, {"loss": loss.detach(), "crop_loss": crop.detach()}

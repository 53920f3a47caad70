"""WaveNet decoder (port of ``vqvae_tpu/models/wavenet.py``).

``apply_decoder`` is the teacher-forced decoder: the in-port oracle
that the per-sample ``decoder_step`` is held against, and, split as
``_head(decoder_skips(...))``, the training forward.  Weights keep
the JAX layouts; ``make_gen_params`` repacks them into the fused
generation layout the decode kernel reads:

* ``[past | h] @ [wf0; wf1]`` — one ``[2R, 2R]`` product per layer,
* ``z @ [wr | ws]`` — residual and skip in one ``[R, R+S]`` product,
* ``c_t @ vc_all`` — every layer's local-condition projection in one
  ``[d, L*2R]`` product, off the layer chain.

``decoder_step`` rounds where the fused decode kernel
(``kernels/decode_cuda.py``, after ``decode_pallas._body``) rounds:
``h``, ``pe0``, ``z``, ``rs`` and the running skip sum are in the
compute dtype; the gate pre-activation ``u``, ``cproj`` and the logits
are float32.  So the kernel's plain version is a loop of this step.

Shapes: R = residual_channels, S = skip_channels, d = latent dim,
g = speaker_embed_dim, L = n_loop * n_layer, mu = classes.
"""

from __future__ import annotations

import math
from typing import Dict, List, NamedTuple

import torch
import torch.utils.checkpoint

from vqvae_tpu_torch.configs import ModelConfig
from vqvae_tpu_torch.ops.conv import (
    dense_init,
    shift_right,
    upsample_apply,
    upsample_init,
)
from vqvae_tpu_torch.ops.embed import take_rows


def _normal(shape, fan_in, dtype, generator, device):
    gen_dev = generator.device if generator is not None else "cpu"
    return (torch.randn(shape, generator=generator, dtype=dtype,
                        device=gen_dev) / math.sqrt(fan_in)).to(device)


def init_decoder(cfg: ModelConfig, generator=None, device="cpu") -> Dict:
    R, S, d, mu = (cfg.residual_channels, cfg.skip_channels, cfg.d, cfg.mu)
    g, L, k = cfg.speaker_embed_dim, cfg.n_layers_total, cfg.filter_size
    if k != 2:
        raise ValueError("filter_size must be 2 (the ring buffers and the "
                         f"decode kernel use 2 taps), got {k}")
    pdt = cfg.pdtype

    def zeros(*shape):
        return torch.zeros(shape, dtype=pdt, device=device)

    def normal(shape, fan_in):
        return _normal(shape, fan_in, pdt, generator, device)

    layers = {
        "wf": normal((L, k, R, 2 * R), k * R),
        "bf": zeros(L, 2 * R),
        "vc": normal((L, d, 2 * R), d),
        "vg": normal((L, g, 2 * R), g),
        "wr": normal((L, R, R), R),
        "br": zeros(L, R),
        "ws": normal((L, R, S), R),
        "bs": zeros(L, S),
    }
    return {
        "emb": {"w": normal((2, mu, R), 2), "b": zeros(R)},
        "layers": layers,
        "head": {"h1": dense_init(S, S, pdt, generator, device),
                 "h2": dense_init(S, mu, pdt, generator, device)},
        "upsample": upsample_init(d, d, cfg.hop, cfg.upsample_kernel_mult,
                                  pdt, generator, device),
        "speaker": {"w": normal((max(cfg.n_speakers, 1), g), 1)},
    }


def upsample_cond(params, cfg: ModelConfig, e: torch.Tensor
                  ) -> torch.Tensor:
    """Quantised latents ``[B, T/hop, d]`` -> audio-rate ``[B, T, d]``."""
    return upsample_apply(params["upsample"], e, cfg.hop, cfg.cdtype)


def global_cond(params, cfg: ModelConfig, speaker: torch.Tensor
                ) -> torch.Tensor:
    """Per-layer speaker contribution with the conv bias folded in:
    ``[L, B, 2R]`` in the compute dtype.  ``speaker`` must already be
    validated: an out-of-range index on the card is a device assert."""
    cdt = cfg.cdtype
    gemb = params["speaker"]["w"].to(cdt)[speaker]          # [B, g]
    vg = params["layers"]["vg"].to(cdt)                     # [L, g, 2R]
    bf = params["layers"]["bf"].to(cdt)                     # [L, 2R]
    return torch.einsum("bg,lgr->lbr", gemb, vg) + bf[:, None, :]


def embed_inputs(params, cfg: ModelConfig, ids: torch.Tensor
                 ) -> torch.Tensor:
    """Causal kernel-2 conv over the implicit one-hot, as two gathers
    whose backward is a fixed-order per-id sum (``ops/embed.py``):
    ``[B, T] -> [B, T, R]``."""
    w = params["emb"]["w"].to(cfg.cdtype)
    h = take_rows(w[1], ids) + shift_right(take_rows(w[0], ids), 1)
    return h + params["emb"]["b"].to(cfg.cdtype)


def _gate(u: torch.Tensor, R: int) -> torch.Tensor:
    return torch.tanh(u[..., :R]) * torch.sigmoid(u[..., R:])


def apply_decoder(params, cfg: ModelConfig, ids_in: torch.Tensor,
                  cond: torch.Tensor, speaker: torch.Tensor) -> torch.Tensor:
    """Teacher-forced decode: ids ``[B, T]``, cond ``[B, T, d]``,
    speaker ``[B]`` -> logits ``[B, T, mu]`` (float32)."""
    return _head(params, cfg,
                 decoder_skips(params, cfg, ids_in, cond, speaker))


def decoder_skips(params, cfg: ModelConfig, ids_in: torch.Tensor,
                  cond: torch.Tensor, speaker: torch.Tensor) -> torch.Tensor:
    """The gated-residual stack up to the head: summed skips
    ``[B, T, S]`` in the compute dtype.  ``decoder_kernel`` picks the
    path: ``xla`` the plain layer loop, ``pallas`` the fused chunk
    kernels with the recompute backward (time-windowed with
    ``bwd_time_windows > 1``), ``pallas_sg`` the fused chunk kernels
    with saved gates (``kernels/wavenet_train_cuda.py``).  ``remat``
    recomputes each chunk (kernel paths) or each layer (``xla``) in the
    backward, as the JAX package wraps them in ``jax.checkpoint``."""
    R, cdt = cfg.residual_channels, cfg.cdtype
    lay = params["layers"]
    cond = cond.to(cdt)
    gcond = global_cond(params, cfg, speaker)
    if cfg.decoder_kernel in ("pallas", "pallas_sg"):
        from vqvae_tpu_torch.kernels.wavenet_train_cuda import decoder_stack
        if cfg.embed_in_kernel:
            return decoder_stack(params, cfg, None, cond, gcond, ids=ids_in)
        return decoder_stack(params, cfg, embed_inputs(params, cfg, ids_in),
                             cond, gcond)
    if cfg.decoder_kernel != "xla":
        raise ValueError(f"unknown decoder_kernel {cfg.decoder_kernel!r}")

    def layer(h, skips, wf, vc, gc, wr, br, ws, bs, dil):
        u = shift_right(h, dil) @ wf[0] + h @ wf[1]
        u = u + cond @ vc + gc[:, None, :]
        z = _gate(u, R)
        return h + z @ wr + br, skips + z @ ws + bs

    h = embed_inputs(params, cfg, ids_in)
    skips = torch.zeros(h.shape[0], h.shape[1], cfg.skip_channels,
                        dtype=cdt, device=h.device)
    for li, dil in enumerate(cfg.dilations):
        args = (h, skips, lay["wf"][li].to(cdt), lay["vc"][li].to(cdt),
                gcond[li], lay["wr"][li].to(cdt), lay["br"][li].to(cdt),
                lay["ws"][li].to(cdt), lay["bs"][li].to(cdt), dil)
        if cfg.remat:
            h, skips = torch.utils.checkpoint.checkpoint(
                layer, *args, use_reentrant=False)
        else:
            h, skips = layer(*args)
    return skips


def _head(params, cfg: ModelConfig, skips: torch.Tensor) -> torch.Tensor:
    cdt = cfg.cdtype
    h1, h2 = params["head"]["h1"], params["head"]["h2"]
    x = torch.relu(skips)
    x = torch.relu(x @ h1["w"].to(cdt) + h1["b"].to(cdt))
    return x.float() @ h2["w"].float() + h2["b"].float()


# ---------------------------------------------------------------------------
# Fast generation: per-sample step over ring buffers
# ---------------------------------------------------------------------------


class GenParams(NamedTuple):
    """Generation-time weight repack (all contiguous, on one device)."""

    emb_w: torch.Tensor     # [2, mu, R]    cdt
    emb_b: torch.Tensor     # [R]           cdt
    wff: torch.Tensor       # [L, 2R, 2R]   cdt, vstack(wf0, wf1)
    vc_all: torch.Tensor    # [d, L*2R]     cdt
    wrs: torch.Tensor       # [L, R, R+S]   cdt, hstack(wr, ws)
    brs: torch.Tensor       # [L, R+S]      cdt
    head_h1: torch.Tensor   # [S, S]        cdt
    head_b1: torch.Tensor   # [S]           cdt
    head_h2: torch.Tensor   # [S, mu]       float32
    head_b2: torch.Tensor   # [mu]          float32


def make_gen_params(dec, cfg: ModelConfig) -> GenParams:
    cdt = cfg.cdtype
    lay = dec["layers"]
    wf = lay["wf"].to(cdt)                                  # [L, 2, R, 2R]
    vc = lay["vc"].to(cdt)                                  # [L, d, 2R]
    head = dec["head"]
    parts = GenParams(
        emb_w=dec["emb"]["w"].to(cdt),
        emb_b=dec["emb"]["b"].to(cdt),
        wff=torch.cat([wf[:, 0], wf[:, 1]], dim=1),
        vc_all=vc.permute(1, 0, 2).reshape(cfg.d, -1),
        wrs=torch.cat([lay["wr"].to(cdt), lay["ws"].to(cdt)], dim=2),
        brs=torch.cat([lay["br"].to(cdt), lay["bs"].to(cdt)], dim=1),
        head_h1=head["h1"]["w"].to(cdt),
        head_b1=head["h1"]["b"].to(cdt),
        head_h2=head["h2"]["w"].to(torch.float32),
        head_b2=head["h2"]["b"].to(torch.float32),
    )
    return GenParams(*(p.detach().contiguous() for p in parts))


def ring_offsets(cfg: ModelConfig) -> List[int]:
    """Row offset of each layer's ring buffer in the packed
    ``[sum(dilations), B, R]`` layout."""
    offs, acc = [], 0
    for d in cfg.dilations:
        offs.append(acc)
        acc += d
    return offs


class GenState(NamedTuple):
    """Ring-buffer carry.  ``bufs`` packs every layer's buffer along
    rows (layer l owns rows ``[off_l, off_l + dil_l)``); row
    ``off_l + t % dil_l`` holds h_l[t - dil_l] when step t reads it and
    receives h_l[t] right after.  ``prev_emb0`` is ``emb0[x_{t-1}]``."""

    t: int                    # absolute step
    prev_emb0: torch.Tensor   # [B, R]
    bufs: torch.Tensor        # [sum(dils), B, R]


def init_gen_state(cfg: ModelConfig, batch: int, dtype=None,
                   device="cpu") -> GenState:
    R, dtype = cfg.residual_channels, dtype or cfg.cdtype
    return GenState(
        t=0,
        prev_emb0=torch.zeros((batch, R), dtype=dtype, device=device),
        bufs=torch.zeros((sum(cfg.dilations), batch, R), dtype=dtype,
                         device=device))


class _F32(NamedTuple):
    wff_past: torch.Tensor   # [L, R, 2R]
    wff_h: torch.Tensor      # [L, R, 2R]
    vc_all: torch.Tensor     # [d, L*2R]
    wrs: torch.Tensor        # [L, R, R+S]
    h1: torch.Tensor
    b1: torch.Tensor


def gen_params_f32(gp: GenParams) -> _F32:
    """Float32 views of the compute-dtype weights (exact upcasts): the
    products below take compute-dtype inputs and sum in float32, as
    the kernel does."""
    R = gp.wff.shape[1] // 2
    f = gp.wff.float()
    return _F32(f[:, :R], f[:, R:], gp.vc_all.float(), gp.wrs.float(),
                gp.head_h1.float(), gp.head_b1.float())


def decoder_step(gp: GenParams, cfg: ModelConfig, state: GenState,
                 x_t: torch.Tensor, c_t: torch.Tensor, gcond: torch.Tensor,
                 f32: _F32 | None = None):
    """One autoregressive step; returns (new state, logits ``[B, mu]``
    float32).  x_t ``[B]`` int ids, c_t ``[B, d]``, gcond ``[L, B, 2R]``.

    The ring buffers are updated in place: the returned state shares
    ``state.bufs``."""
    f32 = f32 if f32 is not None else gen_params_f32(gp)
    R, L = cfg.residual_channels, cfg.n_layers_total
    cdt = gp.wff.dtype
    t = state.t
    B = x_t.shape[0]

    x_t = x_t.long()
    h = gp.emb_w[1][x_t] + state.prev_emb0 + gp.emb_b
    new_prev_emb0 = gp.emb_w[0][x_t]

    cproj = (c_t.to(cdt).float() @ f32.vc_all).reshape(B, L, 2 * R)
    rows = [off + t % dil
            for off, dil in zip(ring_offsets(cfg), cfg.dilations)]
    rows_t = torch.tensor(rows, device=state.bufs.device)
    past = state.bufs.index_select(0, rows_t).float()        # [L, B, R]
    # everything off the layer chain first: the past taps, cproj and
    # the speaker term (the order of the kernel's phase 1)
    base = (torch.bmm(past, f32.wff_past) + cproj.transpose(0, 1)
            + gcond.float())                                  # [L, B, 2R]

    bufs = state.bufs
    skips = None
    for li in range(L):
        bufs[rows[li]] = h
        u = h.float() @ f32.wff_h[li] + base[li]
        z = _gate(u, R).to(cdt)
        rs = (z.float() @ f32.wrs[li]).to(cdt) + gp.brs[li]
        h = h + rs[:, :R]
        skips = rs[:, R:] if skips is None else skips + rs[:, R:]

    x = torch.relu(skips)
    x = torch.relu(x.float() @ f32.h1 + f32.b1).to(cdt)
    logits = x.float() @ gp.head_h2 + gp.head_b2
    return GenState(t + 1, new_prev_emb0, bufs), logits

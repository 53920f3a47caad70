"""Sequence-parallel WaveNet decoder (port of
``vqvae_tpu/parallel/sp_decoder.py``): the whole teacher-forced
gated-residual stack over a time-sharded activation.

Each rank of the axis holds a contiguous time slice of its batch rows.
Every dilated causal conv takes a ``dilation``-frame halo from the rank
to its left (``sharded_conv.halo_shift_right``), the input embedding a
1-frame one; everything else in the stack (gates, the 1x1 residual and
skip products, the conditioning, the head) is pointwise in time and
needs no communication.  Rank 0's halo is zeros, the causal padding, so
the slices equal ``models/wavenet.py::apply_decoder``'s plain layer
loop on the gathered sequence.

As in the JAX package, the body is the plain layer loop (the fused chunk
kernels take whole sequences) and the head is the plain head, whatever
``decoder_kernel`` and ``head_kernel`` say.  Every dilation must fit in
one slice (``max(dilations) <= T / n``), so halos come from the
neighbour only.
"""

from __future__ import annotations

from typing import Dict

import torch

from vqvae_tpu_torch.configs import ModelConfig
from vqvae_tpu_torch.models.wavenet import _gate, _head, global_cond
from vqvae_tpu_torch.ops.embed import take_rows
from vqvae_tpu_torch.parallel import collectives as col
from vqvae_tpu_torch.parallel.mesh import axis_size
from vqvae_tpu_torch.parallel.sharded_conv import axis_group, \
    halo_shift_right


_noted = False


def note_model_axis(mesh) -> None:
    """Say once, as the JAX package does, that with 'model' ranks the
    SP stack runs whole on each of them (every rank holds the full
    weights)."""
    global _noted
    if not _noted and axis_size(mesh, "model") > 1:
        _noted = True
        print("vqvae_tpu_torch: note: mesh_seq>1 with mesh_model>1 — "
              "decoder weights are replicated across 'model' inside the "
              "sequence-parallel stack", flush=True)


def time_slice(mesh, T: int, axis: str = "data") -> slice:
    """This rank's frames of a length-``T`` sequence sharded over
    ``mesh[axis]``."""
    g = axis_group(mesh, axis)
    n, r = col.size(g), col.rank(g)
    return slice(r * (T // n), (r + 1) * (T // n))


def apply_decoder_sp(params: Dict, cfg: ModelConfig, ids_in: torch.Tensor,
                     cond: torch.Tensor, speaker: torch.Tensor, mesh,
                     axis: str = "data") -> torch.Tensor:
    """Teacher-forced decode with T sharded over ``mesh[axis]``.

    ids_in ``[B, T]``, cond ``[B, T, d]`` and speaker ``[B]`` are this
    rank's batch rows over the whole sequence; returns the logits of
    this rank's time slice ``time_slice(mesh, T, axis)``, ``[B, T/n,
    mu]`` float32.  (The JAX version takes and returns global arrays,
    its ``batch_axes`` splitting the batch too; here each rank already
    holds only its batch rows.)"""
    group = axis_group(mesh, axis)
    n = col.size(group)
    T = ids_in.shape[1]
    R, cdt = cfg.residual_channels, cfg.cdtype
    assert T % n == 0, (T, n)
    assert max(cfg.dilations) <= T // n, (
        "every dilation must fit in one time shard: "
        f"max dil {max(cfg.dilations)} > {T // n}")
    sl = time_slice(mesh, T, axis)
    dec = params["decoder"]
    lay = dec["layers"]
    ids = ids_in[:, sl]
    c = cond[:, sl].to(cdt)
    gcond = global_cond(dec, cfg, speaker)                 # [L, B, 2R]
    w = dec["emb"]["w"].to(cdt)
    # input causal conv over the implicit one-hot: the w0 gather of the
    # previous sample crosses the slice boundary (1-frame halo)
    h = (take_rows(w[1], ids) + halo_shift_right(take_rows(w[0], ids), 1,
                                                 group)
         + dec["emb"]["b"].to(cdt))
    skips = torch.zeros(h.shape[0], h.shape[1], cfg.skip_channels,
                        dtype=cdt, device=h.device)
    for li, dil in enumerate(cfg.dilations):
        wf = lay["wf"][li].to(cdt)
        u = halo_shift_right(h, dil, group) @ wf[0] + h @ wf[1]
        u = u + c @ lay["vc"][li].to(cdt) + gcond[li][:, None, :]
        z = _gate(u, R)
        h = h + z @ lay["wr"][li].to(cdt) + lay["br"][li].to(cdt)
        skips = skips + z @ lay["ws"][li].to(cdt) + lay["bs"][li].to(cdt)
    return _head(dec, cfg, skips)

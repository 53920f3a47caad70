"""Sequence-parallel causal convolution with a halo exchange (port of
``vqvae_tpu/parallel/sharded_conv.py``).

Each rank of a mesh axis holds a contiguous time slice of ``[B, T, C]``.
A causal conv of dilation ``d`` at the start of a slice reads the last
``d`` frames of the slice to its left, so those frames (the halo) travel
one rank to the right; rank 0 of the axis receives zeros, which is the
causal zero padding, so the sharded op equals
``ops/conv.py::causal_conv_apply`` on the gathered sequence.

The JAX package builds this on ``shard_map`` and ``lax.ppermute``; here
``halo_shift_right`` is an autograd function over
``batch_isend_irecv``: its forward sends each slice's last frames right,
its backward sends the halo's gradient left, to the rank whose frames
it was.
"""

from __future__ import annotations

from typing import Dict

import torch

from vqvae_tpu_torch.ops.conv import matmul
from vqvae_tpu_torch.parallel import collectives as col
from vqvae_tpu_torch.parallel.mesh import axis_size, groups


def axis_group(mesh, axis: str):
    """The process group along one mesh axis (None: one rank)."""
    if axis not in mesh.mesh_dim_names:
        return None
    return getattr(groups(mesh), axis, None) if axis in ("seq", "model") \
        else mesh.get_group(axis)


class _HaloShift(torch.autograd.Function):

    @staticmethod
    def forward(ctx, x, n, group):
        ctx.n, ctx.group = n, group
        r, size = col.rank(group), col.size(group)
        left = torch.zeros_like(x[:, :n])
        col.exchange(group,
                     [(x[:, -n:], r + 1)] if r + 1 < size else [],
                     [(left, r - 1)] if r > 0 else [])
        return torch.cat([left, x[:, :-n]], dim=1) if n < x.shape[1] \
            else left

    @staticmethod
    def backward(ctx, g):
        n, group = ctx.n, ctx.group
        r, size = col.rank(group), col.size(group)
        tail = torch.zeros_like(g[:, :n])
        col.exchange(group,
                     [(g[:, :n], r - 1)] if r > 0 else [],
                     [(tail, r + 1)] if r + 1 < size else [])
        dx = torch.cat([g[:, n:], tail], dim=1) if n < g.shape[1] else tail
        return dx, None, None


def halo_shift_right(x: torch.Tensor, n: int, group) -> torch.Tensor:
    """``shift_right`` of a time-sharded ``[B, T/k, C]`` by ``n`` frames
    along ``group``: each slice's last ``n`` frames move one rank right,
    rank 0 receives zeros.  Needs ``n <= T/k``."""
    assert 0 < n <= x.shape[1], (n, x.shape[1])
    return _HaloShift.apply(x.contiguous(), n, group)


def sharded_causal_conv(params: Dict, x: torch.Tensor, dilation: int,
                        mesh, axis: str = "data", dtype=None
                        ) -> torch.Tensor:
    """Causal 2-tap dilated conv over this rank's time slice
    ``[B, T/n, C]`` of a sequence sharded over ``mesh[axis]``; returns
    the output's slice.  Requires ``dilation <= T / n`` (the halo comes
    from the neighbour only).  Computed as ``causal_conv_apply`` is, so
    the gathered slices equal it."""
    w = params["w"]
    assert w.shape[0] == 2, "sharded path specialised to 2-tap filters"
    dtype = dtype or x.dtype
    x = x.to(dtype)
    n = axis_size(mesh, axis)
    assert dilation <= x.shape[1], (x.shape[1] * n, n, dilation)
    past = halo_shift_right(x, dilation, axis_group(mesh, axis))
    y = matmul(x, w[1], dtype) + matmul(past, w[0], dtype)
    if "b" in params:
        y = y + params["b"].to(dtype)
    return y

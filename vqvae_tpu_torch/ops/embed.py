"""Embedding gather with a fixed-order backward (port of
``vqvae_tpu/ops/embed.py``).

The forward is a plain row gather.  PyTorch's backward of ``w[ids]`` is
a scatter-add (``indexing_backward_kernel``, floating-point atomics); here
the backward is the per-id sum of ``kernels/embed_cuda.py``: on the card
the fixed-order kernel of ``csrc/embed.cu``, on the CPU JAX's one-hot
contraction ``one_hot(ids, V)ᵀ @ g`` in float32, cast to w's dtype.

Used by the decoder's input embedding (``models/wavenet.py::
embed_inputs``); the codebook and speaker gathers stay plain, as in the
JAX package.
"""

from __future__ import annotations

import torch

from vqvae_tpu_torch.kernels.embed_cuda import take_rows_bwd


class _TakeRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, w, ids):
        ctx.save_for_backward(ids)
        ctx.table = (w.shape[0], w.dtype)
        return w[ids]

    @staticmethod
    def backward(ctx, g):
        (ids,) = ctx.saved_tensors
        V, dtype = ctx.table
        return take_rows_bwd(ids, g, V, dtype), None


def take_rows(w: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """``w[ids]``: w ``[V, C]``, ids int ``[...]`` -> ``[..., C]``; no
    gradient for ids."""
    return _TakeRows.apply(w, ids)

"""The collectives the port's parallel layer runs, over
``torch.distributed`` process groups.

Each helper takes a process group, or None for a group of one rank,
and runs no collective when the group has one rank: a world of one
goes through the same code as a mesh and communicates nothing.

Two ranks that share one card cannot form an NCCL group (NCCL refuses
two ranks on one GPU), but they can form a gloo group, and gloo takes
host tensors.  So a CUDA tensor in a gloo group is staged through host
memory here: copied to the host, sent, copied back.  That is by design,
for a gloo group only, and ``staged_bytes`` counts the bytes it copies
each way; an NCCL group never stages.  A CUDA group of ranks on
separate cards uses NCCL (``parallel/distributed.py``).
"""

from __future__ import annotations

import warnings
from typing import List, Tuple

import torch
import torch.distributed as dist

staged_bytes = 0   # bytes copied between card and host for gloo groups


def size(group) -> int:
    """Ranks in ``group`` (None: one)."""
    return 1 if group is None else dist.get_world_size(group)


def rank(group) -> int:
    """This rank's index in ``group`` (None: 0)."""
    return 0 if group is None else dist.get_rank(group)


def _staged(t: torch.Tensor, group) -> bool:
    return t.is_cuda and dist.get_backend(group) == "gloo"


def _to_host(t: torch.Tensor) -> torch.Tensor:
    global staged_bytes
    staged_bytes += t.numel() * t.element_size()
    return t.detach().cpu()


def _from_host(dst: torch.Tensor, host: torch.Tensor) -> None:
    global staged_bytes
    staged_bytes += host.numel() * host.element_size()
    dst.copy_(host)


def all_reduce_(t: torch.Tensor, group, mean: bool = False) -> torch.Tensor:
    """Sum (or mean) ``t`` over ``group`` in place; returns ``t``.  The
    mean divides the sum by the group's size, so every rank holds the
    same bits."""
    n = size(group)
    if n == 1:
        return t
    if _staged(t, group):
        host = _to_host(t)
        dist.all_reduce(host, group=group)
        _from_host(t, host)
    else:
        dist.all_reduce(t, group=group)
    if mean:
        t.div_(n)
    return t


def _gather_into(out: torch.Tensor, t: torch.Tensor, group) -> None:
    with warnings.catch_warnings():
        # newer torch names it all_gather_single; both take these calls
        warnings.simplefilter("ignore", FutureWarning)
        dist.all_gather_into_tensor(out, t, group=group)


def all_gather(t: torch.Tensor, group) -> torch.Tensor:
    """``[n, t.numel()]``: row r is rank r's ``t``, flattened."""
    n = size(group)
    flat = t.detach().reshape(-1).contiguous()
    if n == 1:
        return flat[None]
    out = torch.empty(n * flat.numel(), dtype=flat.dtype, device=flat.device)
    if _staged(flat, group):
        host = torch.empty(out.shape, dtype=out.dtype)
        _gather_into(host, _to_host(flat), group)
        _from_host(out, host)
    else:
        _gather_into(out, flat, group)
    return out.view(n, -1)


def _wire(t: torch.Tensor) -> torch.Tensor:
    # point-to-point moves bytes: send every dtype as its raw bytes
    return t.contiguous().view(torch.uint8)


def exchange(group, sends: List[Tuple[torch.Tensor, int]],
             recvs: List[Tuple[torch.Tensor, int]]) -> None:
    """Send each ``(tensor, peer)`` of ``sends`` and fill each
    ``(tensor, peer)`` of ``recvs`` in one ``batch_isend_irecv``; peers
    are ranks within ``group``, received tensors contiguous."""
    if not sends and not recvs:
        return
    staged = _staged((sends or recvs)[0][0], group)
    ops, back = [], []
    for t, peer in sends:
        w = _wire(_to_host(t) if staged else t)
        ops.append(dist.P2POp(dist.isend, w,
                              dist.get_global_rank(group, peer), group))
    for t, peer in recvs:
        w = (torch.empty(t.shape, dtype=t.dtype) if staged else t)
        back.append((t, w))
        ops.append(dist.P2POp(dist.irecv, _wire(w),
                              dist.get_global_rank(group, peer), group))
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    if staged:
        for t, w in back:
            _from_host(t, w)


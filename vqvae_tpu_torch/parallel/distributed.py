"""Multi-process scaffolding (port of ``vqvae_tpu/parallel/distributed.py``).

The JAX package runs one controller a host over many devices; the port
runs one process a device, as ``torchrun`` starts them, every process
the same program:

* ``initialize_from_env()`` — joins the world ``torchrun`` describes in
  ``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR`` and
  ``MASTER_PORT``: NCCL for ranks on cards of their own, gloo on the CPU
  and for ranks that share a card (with a warning: their collectives
  go through host memory).  Without those variables it is a no-op that
  returns False, so a one-process run stays one process.
* ``rank_device(device)`` — the rank's device: ``cuda:LOCAL_RANK``
  unless the caller asks for the CPU.
* ``local_batch_slice(B)`` — the contiguous rows of the global batch a
  rank owns.  Every rank draws the same ``(seed, index)`` batch stream
  and keeps its own rows: no data crosses between ranks.
* ``put_global_batch(mesh, *arrays)`` — this rank's rows, on its device.
* ``warmup_collectives(mesh)`` — one all-reduce while the ranks are in
  lockstep, right after the mesh is built.
"""

from __future__ import annotations

import datetime
import os
import warnings
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from vqvae_tpu_torch.parallel import collectives
from vqvae_tpu_torch.utils.profiling import span

# seconds a collective may wait for its peers before the process fails
TIMEOUT_S = 300


def initialize_from_env(device: str = "cuda") -> bool:
    """Join the ``torchrun`` world if the environment describes one;
    returns whether a world of more than one process is active (a no-op
    returning False without ``WORLD_SIZE``; a process group that already
    exists is kept).

    The backend is NCCL for ranks on the card, one card a rank, and gloo
    on the CPU or where the host's ranks (``LOCAL_WORLD_SIZE``) outnumber
    its cards: NCCL refuses two ranks on one card, and
    ``parallel/collectives.py`` stages a gloo group's CUDA tensors
    through the host.  That last case warns on local rank 0, since its
    collectives run at the host's speed."""
    if dist.is_initialized():
        return dist.get_world_size() > 1
    if "WORLD_SIZE" not in os.environ:
        return False
    rank = int(os.environ["RANK"])
    world = int(os.environ["WORLD_SIZE"])
    local = int(os.environ.get("LOCAL_WORLD_SIZE", world))
    cuda = torch.device(device).type == "cuda"
    if cuda:
        torch.cuda.set_device(rank_device(device))
    cards = torch.cuda.device_count() if cuda else 0
    nccl = cuda and local <= cards
    if cuda and not nccl and int(os.environ.get("LOCAL_RANK", "0")) == 0:
        warnings.warn(
            f"{local} ranks share {cards} card(s) on this host: the "
            "backend is gloo, and every collective is staged through "
            "host memory; launch one rank a card for NCCL",
            RuntimeWarning, stacklevel=2)
    dist.init_process_group(
        backend="nccl" if nccl else "gloo", init_method="env://",
        rank=rank, world_size=world,
        timeout=datetime.timedelta(seconds=TIMEOUT_S))
    return world > 1


def shutdown() -> None:
    """Leave the world (a no-op without one): every rank, at its end."""
    if dist.is_initialized():
        dist.destroy_process_group()


def rank_device(device="cuda") -> torch.device:
    """The rank's device: ``device`` as given when it names an index or
    the CPU, else ``cuda:LOCAL_RANK`` (ranks past the card count share
    cards in turn: two gloo ranks on one card)."""
    device = torch.device(device)
    if device.type != "cuda" or device.index is not None:
        return device
    local = int(os.environ.get("LOCAL_RANK", "0"))
    return torch.device("cuda", local % max(1, torch.cuda.device_count()))


def local_batch_slice(global_batch: int,
                      process_index: Optional[int] = None,
                      process_count: Optional[int] = None) -> slice:
    """Rows of the global batch owned by rank ``process_index`` of
    ``process_count`` (default: this process of the world)."""
    world = dist.is_initialized()
    pi = (dist.get_rank() if world else 0) if process_index is None \
        else process_index
    pc = (dist.get_world_size() if world else 1) if process_count is None \
        else process_count
    if global_batch % pc:
        raise ValueError(
            f"global batch {global_batch} not divisible by "
            f"{pc} processes")
    per = global_batch // pc
    return slice(pi * per, (pi + 1) * per)


def put_global_batch(mesh, *host_arrays, device=None):
    """This rank's rows (each array already cut to
    ``batch_sharding(mesh).rows(B)``, as the JAX package's multi-process
    branch takes them) as tensors on ``device`` (default: the rank's
    device for the mesh's device type).  One array in, one tensor out."""
    if device is None:
        device = rank_device("cpu" if mesh is None else mesh.device_type)
    with span("data.put"):
        out = tuple(torch.from_numpy(np.ascontiguousarray(a)).to(device)
                    for a in host_arrays)
    return out if len(out) > 1 else out[0]


def warmup_collectives(mesh) -> None:
    """Build the world's communicators (gloo's TCP pairs, NCCL's rings)
    with one all-reduce while every rank is in lockstep, right after the
    mesh is built, so that no rank meets the first collective of a step
    long after its peers.  No-op for a world of one."""
    if not dist.is_initialized() or dist.get_world_size() == 1:
        return
    device = rank_device("cpu" if mesh is None else mesh.device_type)
    ones = torch.ones((1,), device=device)
    collectives.all_reduce_(ones, dist.group.WORLD)
    n = dist.get_world_size()
    assert float(ones) == n, (float(ones), n)

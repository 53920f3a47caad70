"""Batched synthesis split over devices (port of
``vqvae_tpu/infer/parallel.py``).

AR decoding is batch-parallel: no state crosses between rows.  So the
rows of a decode are split into contiguous shards, one a device, each
decoded on its own CUDA stream with no collective, and gathered back in
row order.  Each shard passes its first row as ``row0``, so its sampling
noise is that of its rows in one call over the whole batch (the decode
kernel's counter is the global row), and the result equals
``infer/fastgen.py::decode_from_codes`` bit for bit, greedy and sampled,
as the JAX package's SPMD decode equals its one-device decode.

Devices may repeat (two shards on one card, or several on the CPU, as
the JAX package's tests use virtual CPU devices).
"""

from __future__ import annotations

import copy
from typing import Dict, Sequence

import torch

from vqvae_tpu_torch.configs import ModelConfig
from vqvae_tpu_torch.infer.fastgen import decode_from_codes


def _device(d) -> torch.device:
    d = torch.device(d)
    if d.type == "cuda" and d.index is None:
        d = torch.device("cuda", torch.cuda.current_device())
    return d


def _params_on(params, device: torch.device, cache: Dict):
    """``params`` on ``device``: itself if it lies there, else one copy
    a device."""
    if device not in cache:
        here = next(params.parameters()).device
        cache[device] = params if _device(here) == device else \
            copy.deepcopy(params).to(device)
    return cache[device]


def decode_from_codes_sharded(params, cfg: ModelConfig,
                              codes: torch.Tensor, speaker: torch.Tensor,
                              seed: int = 0,
                              devices: Sequence = ("cuda",),
                              temperature: float = 1.0,
                              greedy: bool = False,
                              impl: str = "lowmem") -> torch.Tensor:
    """``decode_from_codes`` with the rows of ``codes`` ``[B, T_lat]``
    (and ``speaker`` ``[B]``) split over ``devices``, the weights
    copied to each; returns ``[B, T_lat*hop]`` float32 on the device of
    ``codes``.  Ids must already be validated (``[0, K)``)."""
    devices = [_device(d) for d in devices]
    if not devices:
        raise ValueError("decode_from_codes_sharded needs a device")
    B = codes.shape[0]
    bounds = [B * i // len(devices) for i in range(len(devices) + 1)]
    cache: Dict = {}
    outs = []
    for dev, r0, r1 in zip(devices, bounds, bounds[1:]):
        if r1 == r0:
            continue
        w = _params_on(params, dev, cache)
        stream = (torch.cuda.Stream(dev) if dev.type == "cuda" else None)
        c, s = codes[r0:r1].to(dev), speaker[r0:r1].to(dev)
        if stream is not None:
            stream.wait_stream(torch.cuda.current_stream(dev))
            with torch.cuda.stream(stream):
                y = decode_from_codes(w, cfg, c, s, seed, temperature,
                                      greedy, impl, row0=r0)
        else:
            y = decode_from_codes(w, cfg, c, s, seed, temperature, greedy,
                                  impl, row0=r0)
        outs.append((y, stream))
    pieces = []
    for y, stream in outs:
        if stream is not None:
            stream.synchronize()
        pieces.append(y.to(codes.device))
    return torch.cat(pieces, dim=0)

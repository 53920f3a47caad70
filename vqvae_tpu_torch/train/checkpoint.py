"""Train-state checkpoints and the weights-only ``.npz`` (port of
``vqvae_tpu/train/checkpoint.py``).

A checkpoint holds the whole train state: the parameters (under the
``export_weights`` keys), the Adam state, the step and the EMA
codebook state.  It is the port's own format, one ``torch.save`` file
``<directory>/step_<N>.pt`` per step, written to a temporary file and
renamed, so a crash mid-write never leaves a partial checkpoint (as
orbax does for the JAX package); the newest ``keep`` are kept.  It
loads with ``torch.load(weights_only=True)``.  The ``.npz`` keys are
the JAX package's, so an ``.npz`` written by either side loads into the
other.

A checkpoint always holds the one-device layout.  On a mesh
(``state.par``) saving is collective: the sharded Adam moments and EMA
rows are gathered, rank 0 writes, and every rank waits for the write;
restoring reads the whole file on every rank and keeps each rank's
shards, then waits for every rank's read, so no write of a later step
(and its pruning) can race it.  A run on any mesh resumes on any other,
and on one device.
"""

from __future__ import annotations

import os
import re

import numpy as np
import torch
import torch.distributed as dist

from vqvae_tpu_torch.convert import nest, to_numpy_tree
from vqvae_tpu_torch.models.params import ParamTree, flat_state
from vqvae_tpu_torch.models.vq import VQState
from vqvae_tpu_torch.parallel.step import barrier

_NAME = re.compile(r"^step_(\d+)\.pt$")


def _steps(directory: str) -> list[int]:
    if not os.path.isdir(directory):
        return []
    return sorted(int(m.group(1)) for m in map(_NAME.match,
                                               os.listdir(directory)) if m)


def _path(directory: str, step: int) -> str:
    return os.path.join(directory, f"step_{step}.pt")


def save_checkpoint(directory: str, state, keep: int = 5) -> None:
    """Write ``state`` (a ``train.state.TrainState``) as
    ``step_<step>.pt`` and delete all but the newest ``keep``
    checkpoints."""
    par = state.par
    opt = state.opt.state_dict() if par is None else \
        par.full_opt_state(state.opt)
    vq = state.vq_state if par is None else par.full_vq(state.vq_state)
    if par is None or dist.get_rank() == 0:
        os.makedirs(directory, exist_ok=True)
        path = _path(directory, state.step)
        tmp = f"{path}.{os.getpid()}.tmp"
        torch.save({"step": state.step,
                    "params": {k: v.detach() for k, v in
                               flat_state(state.params).items()},
                    "opt": opt,
                    "vq_state": None if vq is None else
                    {"count": vq.count, "sum": vq.sum}}, tmp)
        os.replace(tmp, path)
        for step in _steps(directory)[:-max(1, keep)]:
            os.remove(_path(directory, step))
    if par is not None:
        barrier(par.mesh)


def latest_step(directory: str) -> int | None:
    """The newest checkpoint's step under ``directory``, or None."""
    steps = _steps(directory)
    return steps[-1] if steps else None


def restore_checkpoint(directory: str, state, step: int | None = None):
    """Load a checkpoint (the newest by default) into ``state`` in
    place (parameters, Adam state, step, EMA state) and return it."""
    step = latest_step(directory) if step is None else step
    if step is None:
        raise FileNotFoundError(f"no checkpoint under {directory}")
    dev = next(state.params.parameters()).device
    ck = torch.load(_path(directory, step), map_location=dev,
                    weights_only=True)
    params = flat_state(state.params)
    if ck["params"].keys() != params.keys():
        raise ValueError(f"checkpoint step {step} under {directory} holds "
                         "another parameter tree")
    with torch.no_grad():
        for k, t in params.items():
            t.copy_(ck["params"][k])
    vq = None if ck["vq_state"] is None else VQState(
        count=ck["vq_state"]["count"].to(dev),
        sum=ck["vq_state"]["sum"].to(dev))
    par = state.par
    if par is None:
        state.opt.load_state_dict(ck["opt"])
        state.vq_state = vq
    else:
        state.opt.load_state_dict(par.shard_opt_state(ck["opt"]))
        state.vq_state = par.shard_vq(vq)
        # with the shards of the full weights just read
        par.reload_shards()
        barrier(par.mesh)
    state.step = int(ck["step"])
    return state


def export_weights(path: str, params: torch.nn.Module) -> None:
    """Weights-only .npz (reference ``snapshot_object``)."""
    np.savez(path, **to_numpy_tree(params))


def _tree_like(arrays, template: torch.nn.Module, device, source: str
               ) -> ParamTree:
    """``arrays`` (``key -> array``) in the structure, shapes and dtypes
    of ``template`` (a ``meta``-device template allocates nothing)."""
    flat = {}
    for key, t in flat_state(template).items():
        if key not in arrays:
            raise ValueError(f"missing weight {key} in {source}")
        a = torch.as_tensor(arrays[key])
        if tuple(a.shape) != tuple(t.shape):
            raise ValueError(f"{key}: shape {tuple(a.shape)} in {source}, "
                             f"model wants {tuple(t.shape)}")
        flat[key] = a.to(device=device, dtype=t.dtype)
    return ParamTree(nest(flat))


def load_weights_npz(path: str, template: torch.nn.Module,
                     device="cpu") -> ParamTree:
    """Load a weights-only .npz in the structure of ``template``."""
    with np.load(path) as z:
        return _tree_like({k: z[k] for k in z.files}, template, device, path)


def load_checkpoint_params(directory: str, template: torch.nn.Module,
                           device="cpu", step: int | None = None
                           ) -> tuple[ParamTree, int]:
    """(parameters, step) of a train-state checkpoint (the newest by
    default) in the structure of ``template``; the optimizer and EMA
    state are not read."""
    step = latest_step(directory) if step is None else step
    if step is None:
        raise FileNotFoundError(f"no checkpoint under {directory}")
    ck = torch.load(_path(directory, step), map_location="cpu",
                    weights_only=True)
    return _tree_like(ck["params"], template, device,
                      _path(directory, step)), step

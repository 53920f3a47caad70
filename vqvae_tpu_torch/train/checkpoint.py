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
"""

from __future__ import annotations

import os
import re

import numpy as np
import torch

from vqvae_tpu_torch.convert import nest, to_numpy_tree
from vqvae_tpu_torch.models.params import ParamTree, flat_state
from vqvae_tpu_torch.models.vq import VQState

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
    os.makedirs(directory, exist_ok=True)
    path = _path(directory, state.step)
    tmp = f"{path}.{os.getpid()}.tmp"
    torch.save({"step": state.step,
                "params": {k: v.detach() for k, v in
                           flat_state(state.params).items()},
                "opt": state.opt.state_dict(),
                "vq_state": {"count": state.vq_state.count,
                             "sum": state.vq_state.sum}}, tmp)
    os.replace(tmp, path)
    for step in _steps(directory)[:-max(1, keep)]:
        os.remove(_path(directory, step))


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
    dev = state.vq_state.count.device
    ck = torch.load(_path(directory, step), map_location=dev,
                    weights_only=True)
    params = flat_state(state.params)
    if ck["params"].keys() != params.keys():
        raise ValueError(f"checkpoint step {step} under {directory} holds "
                         "another parameter tree")
    with torch.no_grad():
        for k, t in params.items():
            t.copy_(ck["params"][k])
    state.opt.load_state_dict(ck["opt"])
    state.vq_state = VQState(count=ck["vq_state"]["count"].to(dev),
                             sum=ck["vq_state"]["sum"].to(dev))
    state.step = int(ck["step"])
    return state


def export_weights(path: str, params: torch.nn.Module) -> None:
    """Weights-only .npz (reference ``snapshot_object``)."""
    np.savez(path, **to_numpy_tree(params))


def load_weights_npz(path: str, template: torch.nn.Module,
                     device="cpu") -> ParamTree:
    """Load a weights-only .npz in the structure, shapes and dtypes of
    ``template`` (a ``meta``-device template allocates nothing)."""
    with np.load(path) as z:
        flat = {}
        for key, t in flat_state(template).items():
            if key not in z.files:
                raise ValueError(f"missing weight {key} in {path}")
            a = z[key]
            if tuple(a.shape) != tuple(t.shape):
                raise ValueError(f"{key}: shape {a.shape} in {path}, "
                                 f"model wants {tuple(t.shape)}")
            flat[key] = torch.from_numpy(a).to(device=device, dtype=t.dtype)
    return ParamTree(nest(flat))

"""Parameters and decode state between the JAX package and the port.

Both sides key parameters the way ``train/checkpoint.py::export_weights``
does: the tree path joined with ``/`` (``decoder/layers/wf``,
``encoder/layers/0/w``, ``vq/codebook``).  ``from_numpy_tree`` builds
the port's ``ParamTree`` from such a flat dict of numpy arrays (a JAX
``export_weights`` ``.npz`` loads straight into it), and
``to_numpy_tree`` is the inverse; ``nest`` turns a flat dict back into
the nested dict/list tree the JAX package uses.  The EMA codebook
state (JAX ``VQState(count [K], sum [K, d])``) crosses with
``vq_state_from_numpy`` / ``vq_state_to_numpy``; optimizer moments are
not carried.
"""

from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch

from vqvae_tpu_torch.models.params import ParamTree, flat_state
from vqvae_tpu_torch.models.vq import VQState


def flatten(tree, prefix: str = "") -> Dict[str, np.ndarray]:
    """Nested dicts / lists of arrays -> ``{"a/b/0/w": array}``."""
    if isinstance(tree, Mapping):
        items = tree.items()
    elif isinstance(tree, (list, tuple)):
        items = enumerate(tree)
    else:
        return {prefix: np.asarray(tree)}
    out: Dict[str, np.ndarray] = {}
    for k, v in items:
        out.update(flatten(v, f"{prefix}/{k}" if prefix else str(k)))
    return out


def nest(flat: Mapping[str, np.ndarray]):
    """Inverse of ``flatten``: path segments that are all digits under
    one node become a list (the encoder layers)."""
    root: dict = {}
    for key, v in flat.items():
        node = root
        *path, leaf = key.split("/")
        for seg in path:
            node = node.setdefault(seg, {})
        node[leaf] = v

    def listify(node):
        if not isinstance(node, dict):
            return node
        node = {k: listify(v) for k, v in node.items()}
        if node and all(k.isdigit() for k in node):
            return [node[str(i)] for i in range(len(node))]
        return node

    return listify(root)


def from_numpy_tree(flat: Mapping[str, np.ndarray], device="cpu",
                    dtype: torch.dtype | None = None,
                    trainable: bool = False) -> ParamTree:
    """Flat ``{"decoder/layers/wf": array, ...}`` -> the port's params
    (exact copies, or cast to ``dtype``); ``trainable`` for training
    from a JAX-initialised state."""
    def tensor(a):
        t = torch.from_numpy(np.array(a, copy=True))
        return t.to(device=device, dtype=dtype or t.dtype)
    return ParamTree(nest({k: tensor(v) for k, v in flat.items()}),
                     trainable)


def to_numpy_tree(params: torch.nn.Module) -> Dict[str, np.ndarray]:
    """The port's params -> flat ``{"decoder/layers/wf": array, ...}``."""
    return {k: v.detach().cpu().numpy() for k, v in flat_state(params).items()}


def xoh_to_x_last(xoh: np.ndarray) -> np.ndarray:
    """JAX ``DecodeState.xoh`` (one-hot of the last id, ``[B, mu]``) ->
    the port's ``x_last`` ``[B]`` int32."""
    return np.asarray(xoh, np.float32).argmax(-1).astype(np.int32)


def x_last_to_xoh(x_last: np.ndarray, mu: int, dtype=np.float32
                  ) -> np.ndarray:
    """The port's ``x_last`` -> JAX's one-hot ``xoh`` ``[B, mu]``."""
    return (np.arange(mu)[None, :] == np.asarray(x_last)[:, None]
            ).astype(dtype)


def vq_state_from_numpy(count: np.ndarray, total: np.ndarray,
                        device="cpu") -> VQState:
    """JAX ``VQState`` fields (``count [K]``, ``sum [K, d]``) -> the
    port's ``VQState`` (float32 copies)."""
    def tensor(a):
        return torch.from_numpy(np.array(a, np.float32, copy=True)).to(device)
    return VQState(count=tensor(count), sum=tensor(total))


def vq_state_to_numpy(state: VQState) -> Dict[str, np.ndarray]:
    """The port's ``VQState`` -> ``{"count": [K], "sum": [K, d]}``."""
    return {"count": state.count.detach().cpu().numpy(),
            "sum": state.sum.detach().cpu().numpy()}

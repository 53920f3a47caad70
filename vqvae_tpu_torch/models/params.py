"""Parameters as ``nn.Module`` trees in the JAX package's layout.

The JAX package keeps its parameters as nested dicts (and one list, the
encoder layers) of arrays.  ``ParamTree`` holds the same tree as
modules: dicts become submodules, lists ``nn.ModuleList``s, arrays
``nn.Parameter``s in their JAX shapes (``decoder.layers.wf`` is
``[L, 2, R, 2R]``, conv weights ``[k, C_in, C_out]``).  So
``state_dict()`` keys with ``.`` -> ``/`` are exactly the keys
``vqvae_tpu/train/checkpoint.py::export_weights`` writes.

Nodes index like the JAX dicts (``tree["decoder"]["emb"]["w"]``) as
well as by attribute (``tree.decoder.emb.w``).
"""

from __future__ import annotations

from typing import Dict, Mapping

import torch
from torch import nn


class ParamTree(nn.Module):
    """``trainable=False`` (serving) freezes every leaf; training builds
    the tree with ``trainable=True``."""

    def __init__(self, tree: Mapping, trainable: bool = False):
        super().__init__()
        for k, v in tree.items():
            if isinstance(v, Mapping):
                self.add_module(k, ParamTree(v, trainable))
            elif isinstance(v, (list, tuple)):
                self.add_module(k, nn.ModuleList(
                    [ParamTree(x, trainable) for x in v]))
            else:
                self.register_parameter(
                    k, nn.Parameter(torch.as_tensor(v).detach(),
                                    requires_grad=trainable))

    def __getitem__(self, key: str):
        return getattr(self, key)

    def __contains__(self, key: str) -> bool:
        return key in self._parameters or key in self._modules


def flat_state(tree: nn.Module) -> Dict[str, torch.Tensor]:
    """``{"decoder/layers/wf": tensor, ...}`` — the export key space."""
    return {k.replace(".", "/"): v for k, v in tree.state_dict().items()}

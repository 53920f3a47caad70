"""Device mesh and sharding rules (port of ``vqvae_tpu/parallel/mesh.py``).

The JAX package lays its devices out as a ``Mesh`` over the axes
('slice', 'data', 'seq', 'model') and lets XLA insert the collectives.
Here each rank of the ``torch.distributed`` world is one device, the
mesh is a ``torch.distributed.device_mesh.DeviceMesh`` over the ranks in
the same axis order, and the parallel layer runs the collectives itself
(``parallel/collectives.py``) over the process groups ``groups(mesh)``
names:

* ``batch`` — the ranks that split the batch, over ('slice', 'data'):
  the outer 'slice' axis joins the batch group, as the JAX package
  shards the batch over both;
* ``grad``  — the batch group and the 'seq' axis: the ranks whose
  gradients are averaged;
* ``seq``   — the sequence-parallel axis (halo exchanges);
* ``model`` — the tensor-parallel axis (shards of the weights).

'slice' is the outermost axis and 'model' the innermost, so ranks that
differ only in their 'model' or 'seq' coordinate are neighbours, as the
JAX package keeps them on the tightest links.
"""

from __future__ import annotations

import math
from typing import Any, Dict, NamedTuple, Optional

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

AXES = ("slice", "data", "seq", "model")
_GROUPS: Dict[DeviceMesh, "Groups"] = {}


class Groups(NamedTuple):
    """Process groups of this rank (None: a group of one)."""

    batch: Any
    grad: Any
    seq: Any
    model: Any


def make_mesh(data: int = -1, model: int = 1, slices: int = 1,
              seq: int = 1, device_type: Optional[str] = None
              ) -> DeviceMesh:
    """A mesh over every rank of the initialised world, of shape
    ('slice', 'data', 'seq', 'model'), axes of size 1 dropped except
    'data' and 'model'; ``data=-1`` means all the ranks left over.
    Collective: every rank calls it with the same arguments.
    ``device_type`` defaults to ``cuda`` for an NCCL world and ``cpu``
    otherwise."""
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs an initialised process group "
                           "(parallel/distributed.py::initialize_from_env)")
    n = dist.get_world_size()
    if data == -1:
        assert n % (model * slices * seq) == 0, (n, model, slices, seq)
        data = n // (model * slices * seq)
    assert slices * data * seq * model == n, \
        (slices, data, seq, model, n)
    shape = {"slice": slices, "data": data, "seq": seq, "model": model}
    keep = {k: v for k, v in shape.items()
            if v > 1 or k in ("data", "model")}
    if device_type is None:
        device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    mesh = init_device_mesh(device_type, tuple(keep.values()),
                            mesh_dim_names=tuple(keep))
    _GROUPS[mesh] = Groups(
        batch=_flat_group(mesh, ("slice", "data")),
        grad=_flat_group(mesh, ("slice", "data", "seq")),
        seq=_flat_group(mesh, ("seq",)),
        model=_flat_group(mesh, ("model",)))
    return mesh


def mesh_from_config(tcfg, device_type: str = "cuda"):
    """The mesh a ``TrainConfig``'s ``mesh_*`` fields ask for over the
    world, or None for one process that asks for none.  Raises
    ValueError, naming the setting, for a mesh larger than the world."""
    world = dist.get_world_size() if dist.is_initialized() else 1
    sizes = {"mesh_data": max(tcfg.mesh_data, 1),
             "mesh_model": tcfg.mesh_model, "mesh_seq": tcfg.mesh_seq,
             "mesh_slices": tcfg.mesh_slices}
    want = sizes["mesh_data"] * tcfg.mesh_model * tcfg.mesh_seq \
        * tcfg.mesh_slices
    if want > world:
        name = next(k for k, v in sizes.items() if v > 1)
        raise ValueError(
            f"train.{name}={getattr(tcfg, name)} asks for a mesh of {want} "
            f"ranks, but the world has {world} process"
            f"{'es' if world > 1 else ''}: launch one process a rank, "
            f"under torchrun --nproc-per-node {want}")
    if not dist.is_initialized():
        return None
    return make_mesh(tcfg.mesh_data, tcfg.mesh_model, tcfg.mesh_slices,
                     tcfg.mesh_seq, device_type=device_type)


def _flat_group(mesh: DeviceMesh, axes):
    """The group of ranks that differ only along ``axes`` (None when
    that is one rank).  Every rank creates every such group, in one
    order, as ``new_group`` requires."""
    names = list(mesh.mesh_dim_names)
    inner = [names.index(a) for a in axes if a in names]
    n = math.prod(mesh.mesh.shape[i] for i in inner) if inner else 1
    if n == 1:
        return None
    outer = [i for i in range(len(names)) if i not in inner]
    table = mesh.mesh.permute(*outer, *inner).reshape(-1, n).tolist()
    me, mine = dist.get_rank(), None
    for ranks in table:
        g = dist.new_group(ranks)
        if me in ranks:
            mine = g
    return mine


def groups(mesh: Optional[DeviceMesh]) -> Groups:
    """The process groups of ``mesh`` (all None without a mesh)."""
    if mesh is None:
        return Groups(None, None, None, None)
    return _GROUPS[mesh]


def mesh_shape(mesh: DeviceMesh) -> Dict[str, int]:
    """``{'data': 4, 'model': 2}``: the axes in order, with their sizes
    (JAX's ``Mesh.shape``)."""
    return dict(zip(mesh.mesh_dim_names, mesh.mesh.shape))


def axis_size(mesh: Optional[DeviceMesh], axis: str) -> int:
    """The size of ``axis`` (1 when the mesh drops it, or no mesh)."""
    if mesh is None:
        return 1
    return mesh_shape(mesh).get(axis, 1)


def _data_axes(mesh: DeviceMesh):
    """Batch-sharding axes: ('slice', 'data') on a mesh with 'slice'."""
    return ("slice", "data") if "slice" in mesh.mesh_dim_names \
        else ("data",)


class BatchSharding(NamedTuple):
    """The batch axes and this rank's place along them: it holds rows
    ``rows(B)`` of a global batch of B."""

    axes: tuple
    index: int
    count: int

    def rows(self, batch: int) -> slice:
        from vqvae_tpu_torch.parallel.distributed import local_batch_slice
        return local_batch_slice(batch, self.index, self.count)


def batch_sharding(mesh: Optional[DeviceMesh]) -> BatchSharding:
    """The leading (batch) axis split over the data axes, 'slice'
    included, majormost first."""
    if mesh is None:
        return BatchSharding(("data",), 0, 1)
    g = groups(mesh).batch
    return BatchSharding(_data_axes(mesh), 0 if g is None
                         else dist.get_rank(g), 1 if g is None
                         else dist.get_world_size(g))


class Shard(NamedTuple):
    """One leaf's layout: split along ``dim`` into ``count`` equal
    shards over the 'model' axis, or replicated (``dim`` None)."""

    dim: Optional[int]
    count: int

    def shard_shape(self, shape) -> tuple:
        shape = tuple(shape)
        if self.dim is None:
            return shape
        return (shape[:self.dim] + (shape[self.dim] // self.count,)
                + shape[self.dim + 1:])


def replicated(mesh: Optional[DeviceMesh] = None) -> Shard:
    return Shard(None, 1)


def spec_for(path: str, x: Any, model_size: int) -> Shard:
    """Channel-sharding rule for one parameter leaf (the JAX package's
    ``_spec_for``): stacked WaveNet weights ``[L, ..., C_out]`` and
    dense or conv kernels ``[..., C_out]`` split along the trailing
    (output-channel) axis when 'model' divides it; the VQ codebook
    ``[K, d]`` and the EMA ``VQState`` leaves (``sum`` ``[K, d]``,
    ``count`` ``[K]``) along K; biases and small leaves replicate."""
    if model_size == 1 or not hasattr(x, "ndim") or x.ndim == 0:
        return replicated()
    leaf = path.rsplit("/", 1)[-1]
    if "codebook" in path or leaf in ("sum", "count"):
        return Shard(0, model_size) if x.shape[0] % model_size == 0 \
            else replicated()
    if x.ndim >= 2 and x.shape[-1] % model_size == 0:
        return Shard(x.ndim - 1, model_size)
    return replicated()


def param_shardings(mesh: Optional[DeviceMesh], params) -> Dict[str, Shard]:
    """``{path: Shard}`` for each leaf of ``params``: a ``ParamTree``
    (paths as ``export_weights`` writes them, ``decoder/layers/wf``), a
    ``VQState`` (``count``, ``sum``) or a dict of tensors."""
    m = axis_size(mesh, "model")
    if isinstance(params, torch.nn.Module):
        from vqvae_tpu_torch.models.params import flat_state
        leaves = flat_state(params)
    elif hasattr(params, "_asdict"):
        leaves = params._asdict()
    else:
        leaves = dict(params)
    return {k: spec_for(k, v, m) for k, v in leaves.items()}

"""What a train step does on a mesh (the port's counterpart of the
collectives XLA inserts into the JAX package's sharded step).

Every rank holds the full weights for its forward and computes the
gradient of its own rows.  ``MeshStep`` then:

* averages the gradients over the ``grad`` group (the batch axes and
  'seq': each rank's loss is already a mean over its rows and time
  slice, so the mean of the ranks' gradients is the global batch's);
* gives Adam only the shards this rank owns under
  ``mesh.param_shardings`` (the 'model' axis): Adam's moments, and the
  EMA ``VQState``, exist on a rank only for its shards;
* all-gathers the updated shards over 'model' into the full weights
  for the next forward, as the JAX package gathers its model-sharded
  weights around its custom calls;
* makes global what the JAX step computes over the global batch: the
  reported losses, the code histogram behind ``codebook_usage`` and
  ``code_perplexity``, the EMA's per-code sums (through ``comm``
  arguments to ``models/vq.py``) and the dead-code restart's candidate
  rows.

The compute itself is not split over 'model': the fused chunk kernels
take whole layers, and a channel split of them would be a redesign;
XLA does not split the compute around a custom call either.  'model'
shards the optimizer's state and its update.

On a world of one every group has one rank, every shard is the whole
tensor and no collective runs, so the step is the one-device step bit
for bit.
"""

from __future__ import annotations

from typing import Dict, List, NamedTuple, Optional, Tuple

import torch
import torch.distributed as dist

from vqvae_tpu_torch.models.vq import VQState
from vqvae_tpu_torch.parallel import collectives as col
from vqvae_tpu_torch.parallel.mesh import Shard, groups, spec_for

_LOSSES = ("loss", "loss1", "loss2", "loss3")


class _Leaf(NamedTuple):
    path: str
    param: torch.nn.Parameter
    shard: Shard
    tensor: torch.Tensor      # what Adam updates: the shard, or the param


def _narrow(t: torch.Tensor, shard: Shard, index: int) -> torch.Tensor:
    if shard.dim is None:
        return t
    n = t.shape[shard.dim] // shard.count
    return t.narrow(shard.dim, index * n, n)


class MeshStep:
    """The mesh's side of one training run over ``params`` (a
    ``ParamTree``); ``train/state.py`` builds it and ``train/step.py``
    calls it.  Also the ``comm`` of ``models/vq.py``'s updates."""

    def __init__(self, mesh, params: torch.nn.Module):
        self.mesh = mesh
        self.groups = groups(mesh)
        self.m = col.size(self.groups.model)
        self.r = col.rank(self.groups.model)
        self.leaves: List[_Leaf] = []
        for name, p in params.named_parameters():
            path = name.replace(".", "/")
            shard = spec_for(path, p, self.m)
            t = p if shard.dim is None else (
                _narrow(p.detach(), shard, self.r).clone()
                .requires_grad_(True))
            self.leaves.append(_Leaf(path, p, shard, t))
        cb = [x for x in self.leaves if x.path == "vq/codebook"]
        assert len(cb) == 1, "a VQ-VAE ParamTree has one vq/codebook"
        self._cb = cb[0]

    # -- the optimizer's tensors -------------------------------------------

    def opt_tensors(self) -> Tuple[List[torch.Tensor], torch.Tensor]:
        """(every tensor Adam updates but the codebook's, the codebook's),
        in ``params.parameters()`` order (``state_dict`` indices match
        the one-device optimizer's)."""
        return ([x.tensor for x in self.leaves if x is not self._cb],
                self._cb.tensor)

    def _opt_leaves(self) -> List[_Leaf]:
        return [x for x in self.leaves if x is not self._cb] + [self._cb]

    def codebook_shard(self) -> torch.Tensor:
        """The codebook rows this rank updates (the whole codebook when
        it is not sharded)."""
        return self._cb.tensor

    def reduce_grads(self) -> None:
        """After ``backward``: each tensor Adam updates gets the mean of
        its gradient over the ``grad`` group (one all-reduce a dtype)."""
        work = []
        for x in self.leaves:
            g = x.param.grad
            if g is None:
                continue
            if x.shard.dim is not None:
                x.param.grad = None
                g = _narrow(g, x.shard, self.r).contiguous()
                x.tensor.grad = g
            work.append(x.tensor)
        if col.size(self.groups.grad) == 1:
            return
        # one order on every rank: the collectives must pair up
        for dtype in sorted({t.grad.dtype for t in work}, key=str):
            ts = [t for t in work if t.grad.dtype == dtype]
            flat = torch.cat([t.grad.reshape(-1) for t in ts])
            col.all_reduce_(flat, self.groups.grad, mean=True)
            o = 0
            for t in ts:
                n = t.grad.numel()
                t.grad = flat[o:o + n].view_as(t.grad)
                o += n

    def gather_params(self) -> None:
        """After the update: every sharded weight all-gathered over
        'model' into the full parameter."""
        sharded = [x for x in self.leaves if x.shard.dim is not None]
        full = self._gather([(x.tensor, x.shard.dim) for x in sharded])
        with torch.no_grad():
            for x, f in zip(sharded, full):
                x.param.copy_(f)

    def full_grads(self) -> Dict[str, torch.Tensor]:
        """``{path: gradient}`` as Adam saw it in the last update (after
        the mean), each whole (collective over 'model')."""
        with_grad = [x for x in self.leaves if x.tensor.grad is not None]
        sharded = [x for x in with_grad if x.shard.dim is not None]
        full = dict(zip((x.path for x in sharded), self._gather(
            [(x.tensor.grad, x.shard.dim) for x in sharded])))
        return {x.path: full.get(x.path, x.tensor.grad) for x in with_grad}

    def reload_shards(self) -> None:
        """The shards Adam updates cut anew from the full weights (after
        a checkpoint wrote them)."""
        with torch.no_grad():
            for x in self.leaves:
                if x.shard.dim is not None:
                    x.tensor.copy_(_narrow(x.param, x.shard, self.r))

    def _gather(self, shards: List[Tuple[torch.Tensor, int]]
                ) -> List[torch.Tensor]:
        """Full tensors from this rank's shards ``(tensor, dim)``, by one
        all-gather over 'model' a dtype."""
        out: List[Optional[torch.Tensor]] = [None] * len(shards)
        for dtype in sorted({t.dtype for t, _ in shards}, key=str):
            pick = [i for i, (t, _) in enumerate(shards) if t.dtype == dtype]
            rows = col.all_gather(
                torch.cat([shards[i][0].detach().reshape(-1) for i in pick]),
                self.groups.model)
            o = 0
            for i in pick:
                t, dim = shards[i]
                n = t.numel()
                out[i] = torch.cat([rows[q, o:o + n].view(t.shape)
                                    for q in range(rows.shape[0])], dim=dim)
                o += n
        return out

    # -- models/vq.py's comm ---------------------------------------------

    def batch_sum_(self, t: torch.Tensor) -> torch.Tensor:
        """Sum over the ranks that split the batch, in place."""
        return col.all_reduce_(t, self.groups.batch)

    def _k_shard(self, t: torch.Tensor) -> Shard:
        return spec_for("count", t, self.m)

    def k_slice(self, t: torch.Tensor) -> torch.Tensor:
        """The K rows of ``t`` (``[K, ...]``) this rank's VQ state holds."""
        return _narrow(t, self._k_shard(t), self.r)

    def k_total_(self, n: torch.Tensor) -> torch.Tensor:
        """A sum over this rank's K rows made the sum over all K."""
        if self._cb.shard.dim is None:
            return n
        return col.all_reduce_(n, self.groups.model)

    def global_rows(self, n_local: int) -> int:
        """Rows of the global batch, from this rank's ``n_local``."""
        return n_local * col.size(self.groups.batch)

    def candidates(self, z: torch.Tensor, picks: torch.Tensor
                   ) -> torch.Tensor:
        """``z_global[picks]`` for ``z`` this rank's rows ``[N, d]`` of
        the global ``[N * ranks, d]``: each rank fills the picks it
        holds and zeros elsewhere, and the batch group sums them (one
        nonzero term a place, so the sum is exact)."""
        n = z.shape[0]
        local = picks - col.rank(self.groups.batch) * n
        own = (local >= 0) & (local < n)
        cand = torch.where(own[:, None], z[local.clamp(0, n - 1)],
                           torch.zeros((), dtype=z.dtype, device=z.device))
        return self.batch_sum_(cand.contiguous())

    # -- checkpoints: the one-device layout ------------------------------

    def shard_vq(self, vq: VQState) -> VQState:
        """This rank's K rows of a full ``VQState``."""
        return VQState(count=self.k_slice(vq.count).contiguous(),
                       sum=self.k_slice(vq.sum).contiguous())

    def full_vq(self, vq: VQState) -> VQState:
        """The full ``VQState`` from every rank's K rows (collective)."""
        if self._k_shard(vq.count).dim is None:
            return vq
        count, total = self._gather([(vq.count, 0), (vq.sum, 0)])
        return VQState(count=count, sum=total)

    def full_opt_state(self, opt: torch.optim.Optimizer) -> Dict:
        """``opt.state_dict()`` in the one-device layout: every sharded
        moment all-gathered (collective).  The optimizer's live state is
        left as it is: ``state_dict()`` hands out its per-tensor dicts
        themselves, so each is copied before a gathered tensor goes in."""
        sd = opt.state_dict()
        sd["state"] = {i: dict(st) for i, st in sd["state"].items()}
        work = []
        for i, x in enumerate(self._opt_leaves()):
            st = sd["state"].get(i)
            if st is None or x.shard.dim is None:
                continue
            for k, v in st.items():
                if torch.is_tensor(v) and tuple(v.shape) == tuple(
                        x.tensor.shape):
                    work.append((st, k, v, x.shard.dim))
        full = self._gather([(v, d) for _, _, v, d in work])
        for (st, k, _, _), f in zip(work, full):
            st[k] = f
        return sd

    def shard_opt_state(self, sd: Dict) -> Dict:
        """A one-device ``state_dict`` cut to this rank's shards."""
        state = {}
        for i, x in enumerate(self._opt_leaves()):
            st = sd["state"].get(i)
            if st is None:
                continue
            state[i] = {
                k: (_narrow(v, x.shard, self.r).contiguous()
                    if torch.is_tensor(v) and x.shard.dim is not None
                    and tuple(v.shape) == tuple(x.param.shape) else v)
                for k, v in st.items()}
        return {"state": state, "param_groups": sd["param_groups"]}


def global_metrics(mesh, metrics: Dict[str, torch.Tensor],
                   idx: torch.Tensor, K: int) -> Dict[str, torch.Tensor]:
    """The step's metrics over the global batch: the losses averaged
    over the ``grad`` group; ``codebook_usage`` and ``code_perplexity``
    from the code histogram summed over the batch group.  Unchanged
    where those groups have one rank."""
    g = groups(mesh)
    out = dict(metrics)
    if col.size(g.grad) > 1:
        v = torch.stack([metrics[k].float() for k in _LOSSES])
        col.all_reduce_(v, g.grad, mean=True)
        out.update(zip(_LOSSES, v.unbind()))
    if col.size(g.batch) > 1:
        hist = torch.bincount(idx.reshape(-1), minlength=K).float()
        col.all_reduce_(hist, g.batch)
        p = hist / hist.sum()
        out["codebook_usage"] = (hist > 0).float().mean()
        out["code_perplexity"] = torch.exp(-torch.sum(p * torch.log(
            p + 1e-10)))
    return out


def barrier(mesh) -> None:
    """Every rank of the world waits here (no-op without a mesh)."""
    if mesh is not None and dist.get_world_size() > 1:
        dist.barrier()

"""Vector quantizer with straight-through gradients and the EMA
codebook (port of ``vqvae_tpu/models/vq.py``).

``e_st = z + (e - z).detach()`` carries dL/de into z_e verbatim; the
codebook learns only through loss2, or, under ``cfg.ema``, through the
exponential moving averages of ``ema_update`` (van den Oord et al.,
App. A).  ``restart_dead_codes`` takes its random row picks as an
argument: the port draws them from a ``torch.Generator``, and tests
inject the JAX package's ``jax.random`` picks.

On a mesh the updates take ``comm``, the mesh's view of the batch and of
the codebook's shards (``parallel/step.py::MeshStep``): the per-code
counts and sums are summed over the ranks that split the batch before
the decay, each rank keeps the K rows of the EMA state it owns, the
smoothing's total count is summed over those shards, and the restart's
candidate rows are taken from the global batch.  ``comm=None`` is one
device, and no collective runs.
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Tuple

import torch

from vqvae_tpu_torch.configs import ModelConfig


class VQState(NamedTuple):
    """EMA accumulators (unused when ``cfg.ema`` is False and no
    restart threshold is set)."""

    count: torch.Tensor   # [K]    EMA of assignment counts
    sum: torch.Tensor     # [K, d] EMA of assigned-vector sums


def init_vq(cfg: ModelConfig, generator=None, device="cpu") -> Dict:
    # N(0, 1) rows, as the JAX package (Chainer EmbedID's default)
    gen_dev = generator.device if generator is not None else "cpu"
    cb = torch.randn((cfg.K, cfg.d), generator=generator, dtype=cfg.pdtype,
                     device=gen_dev)
    return {"codebook": cb.to(device)}


def init_vq_state(params) -> VQState:
    cb = params["codebook"].detach()
    return VQState(count=torch.zeros(cb.shape[0], dtype=torch.float32,
                                     device=cb.device),
                   sum=cb.to(torch.float32).clone())


def nearest_code(z: torch.Tensor, codebook: torch.Tensor,
                 impl: str = "lax") -> torch.Tensor:
    """Indices ``[...]`` (int64) of the L2-nearest codebook row for each
    z vector: ``argmax(2·z·cbᵀ − ‖cb‖²)``, ties to the first index.
    ``impl="lax"`` sums the scores in float64, so a row's code does not
    depend on how many rows share the call (see ``ops/conv.py``; the
    streaming encoder's exactness rests on it).  ``impl="pallas"`` is
    the float32 search of the VQ kernel (``kernels/vq_cuda.py``)."""
    if impl == "pallas":
        from vqvae_tpu_torch.kernels.vq_cuda import vq_argmin
        flat = z.detach().reshape(-1, z.shape[-1])
        return vq_argmin(flat, codebook.detach()).long().reshape(
            z.shape[:-1])
    if impl != "lax":
        raise ValueError(f"unknown VQ impl {impl!r} (lax or pallas)")
    zd, cbd = z.detach().double(), codebook.detach().double()
    scores = (zd @ cbd.T) * 2.0 - torch.sum(cbd * cbd, dim=-1)
    return torch.argmax(scores, dim=-1)


def quantize(params, z: torch.Tensor, impl: str = "lax"
             ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """z_e ``[..., d]`` -> (e straight-through, e raw, indices).  The
    search runs on detached inputs; ``e`` keeps the codebook's graph
    (loss2), ``e_st`` passes its cotangent to z unchanged."""
    codebook = params["codebook"].to(z.dtype)
    idx = nearest_code(z, codebook, impl)
    e = codebook[idx]
    e_st = z + (e - z).detach()
    return e_st, e, idx


def vq_losses(z: torch.Tensor, e: torch.Tensor
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(loss2 codebook, loss3 commitment): means over all elements."""
    loss2 = torch.mean((z.detach() - e) ** 2)
    loss3 = torch.mean((z - e.detach()) ** 2)
    return loss2, loss3


def _one_hot(idx: torch.Tensor, K: int) -> torch.Tensor:
    return torch.nn.functional.one_hot(idx.reshape(-1).long(), K).to(
        torch.float32)


@torch.no_grad()
def ema_update(params, state: VQState, z: torch.Tensor, idx: torch.Tensor,
               cfg: ModelConfig, comm=None) -> Tuple[Dict, VQState]:
    """One EMA codebook update from a batch of assignments.  The
    per-code sums are a one-hot product, as in the JAX package, so they
    sum in a fixed order on any device.  With ``comm`` the state and the
    codebook are this rank's K shard (see module note)."""
    z = z.detach().reshape(-1, z.shape[-1]).to(torch.float32)
    onehot = _one_hot(idx, cfg.K)
    batch_count = onehot.sum(0)                          # [K]
    batch_sum = onehot.T @ z                             # [K, d]
    if comm is not None:
        batch_count = comm.k_slice(comm.batch_sum_(batch_count))
        batch_sum = comm.k_slice(comm.batch_sum_(batch_sum))
    decay = cfg.ema_decay
    count = state.count * decay + batch_count * (1 - decay)
    total = state.sum * decay + batch_sum * (1 - decay)
    # Laplace-smoothed counts avoid a divide-by-zero on dead codes
    n = count.sum()
    if comm is not None:
        n = comm.k_total_(n)
    stable = (count + cfg.ema_eps) / (n + cfg.K * cfg.ema_eps) * n
    codebook = (total / stable[:, None]).to(params["codebook"].dtype)
    return {"codebook": codebook}, VQState(count=count, sum=total)


@torch.no_grad()
def usage_update(state: VQState, idx: torch.Tensor, cfg: ModelConfig,
                 comm=None) -> VQState:
    """Assignment-count EMA without touching the codebook (the
    gradient-trained codebook's usage signal for dead-code restart)."""
    batch_count = _one_hot(idx, cfg.K).sum(0)
    if comm is not None:
        batch_count = comm.k_slice(comm.batch_sum_(batch_count))
    count = state.count * cfg.ema_decay + batch_count * (1 - cfg.ema_decay)
    return VQState(count=count, sum=state.sum)


def restart_picks(seed: int, step: int, n_rows: int, K: int,
                  device="cpu") -> torch.Tensor:
    """The port's random rows for ``restart_dead_codes`` at ``step``:
    ``K`` draws in ``[0, n_rows)`` from a CPU generator keyed by
    (seed + 101, step).  (The JAX package draws
    ``randint(fold_in(PRNGKey(seed + 101), step))``, which torch cannot
    reproduce.)"""
    g = torch.Generator().manual_seed((seed + 101) * 1_000_003 + step)
    return torch.randint(0, n_rows, (K,), generator=g).to(device)


@torch.no_grad()
def restart_dead_codes(params, state: VQState, z: torch.Tensor,
                       picks: torch.Tensor, cfg: ModelConfig, comm=None
                       ) -> Tuple[Dict, VQState]:
    """Re-seed codebook rows whose EMA usage dropped below
    ``cfg.code_restart_threshold`` with the encoder outputs
    ``z[picks]`` of the current batch, and reset their EMA stats.  With
    ``comm``, ``picks`` index the rows of the global batch."""
    thr = cfg.code_restart_threshold
    z = z.detach().reshape(-1, z.shape[-1]).to(torch.float32)
    picks = picks.to(z.device).long()
    candidates = (z[picks] if comm is None                # [K, d]
                  else comm.k_slice(comm.candidates(z, picks)))
    dead = state.count < thr                             # [K]
    cb = params["codebook"]
    codebook = torch.where(dead[:, None], candidates.to(cb.dtype), cb)
    count = torch.where(dead, torch.full_like(state.count, thr),
                        state.count)
    total = torch.where(dead[:, None], candidates * thr, state.sum)
    return {"codebook": codebook}, VQState(count=count, sum=total)


def code_perplexity(idx: torch.Tensor, K: int) -> torch.Tensor:
    """exp(entropy) of the batch code-usage distribution."""
    p = _one_hot(idx, K).mean(0)
    return torch.exp(-torch.sum(p * torch.log(p + 1e-10)))

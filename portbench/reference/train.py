"""The reference's first training steps: forward, backward, Adam and,
under EMA, the codebook's moving averages and dead-code restarts, from
the weights and batches the benchmark hands to both sides.

The batch runs in blocks of rows so that float32 activations fit; the
loss is a mean over the batch, so the blocks' gradients, each weighted
by its share of the rows, add up to the batch's.  Only the losses, the
first step's gradient norms and the norms of the weights' change are
kept.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Sequence, Tuple

import torch

from portbench.reference import model as ref

# picks(step, n_rows, K) -> the K rows a dead-code restart draws from
Picks = Callable[[int, int, int], torch.Tensor]


def _adam(p: Dict[str, torch.Tensor], mom: dict, t: int, tr: dict) -> None:
    """One Adam update (bias correction on both moments, eps outside the
    root) of every leaf that has a gradient; the codebook at
    ``lr * codebook_lr_mult``."""
    b1, b2, eps = tr["adam_b1"], tr["adam_b2"], tr["adam_eps"]
    for k, w in p.items():
        g = w.grad
        if g is None:
            continue
        m1, m2 = mom.setdefault(k, (torch.zeros_like(w), torch.zeros_like(w)))
        m1.mul_(b1).add_(g, alpha=1 - b1)
        m2.mul_(b2).addcmul_(g, g, value=1 - b2)
        lr = tr["lr"] * (tr["codebook_lr_mult"] if k == "vq/codebook" else 1)
        denom = (m2.sqrt() / (1 - b2 ** t) ** 0.5).add_(eps)
        with torch.no_grad():
            w.addcdiv_(m1, denom, value=-lr / (1 - b1 ** t))


def _codebook_update(cb: torch.Tensor, vq: dict, z: torch.Tensor,
                     idx: torch.Tensor, rows: torch.Tensor, m: dict) -> None:
    """The EMA update of the codebook from this batch's assignments, then
    the restart of rows whose usage fell under the threshold with the
    encoder outputs ``z[rows]`` (van den Oord et al., App. A)."""
    K, thr, decay = m["K"], m["code_restart_threshold"], m["ema_decay"]
    onehot = torch.nn.functional.one_hot(idx, K).float()
    count = vq["count"] * decay + onehot.sum(0) * (1 - decay)
    new = cb.detach().clone()
    if m["ema"]:
        total = vq["sum"] * decay + (onehot.T @ z) * (1 - decay)
        n = count.sum()
        stable = (count + m["ema_eps"]) / (n + K * m["ema_eps"]) * n
        new = total / stable[:, None]
        vq["sum"] = total
    if thr > 0:
        cand = z[rows.to(z.device)]
        dead = count < thr
        new = torch.where(dead[:, None], cand, new)
        count = torch.where(dead, torch.full_like(count, thr), count)
        vq["sum"] = torch.where(dead[:, None], cand * thr, vq["sum"])
    vq["count"] = count
    with torch.no_grad():
        cb.copy_(new)


def first_steps(p0: Dict[str, torch.Tensor], m: dict, tr: dict,
                batches: Sequence[Tuple[torch.Tensor, torch.Tensor]],
                picks: Picks, prec: ref.Prec = ref.F32,
                block: int = 16) -> dict:
    """Follow ``len(batches)`` steps from the weights ``p0``.  A batch is
    (raw slices ``[B, T+1]`` float32, speaker ids ``[B]``), on the
    device the reference runs on.  Returns ``{"loss": [...],
    "grad1": {leaf: norm}, "change": {leaf: norm}}``: each step's loss,
    the norm of each leaf's first gradient, and the norm of each leaf's
    change after the last step."""
    p = {k: v.detach().clone().float().requires_grad_(True)
         for k, v in p0.items()}
    mom: dict = {}
    cb = p["vq/codebook"]
    vq = {"count": torch.zeros(m["K"], device=cb.device),
          "sum": cb.detach().clone()}
    ema, beta, mu = m["ema"], m["beta"], m["mu"]
    losses: List[float] = []
    grad1: Dict[str, float] = {}
    for step, (slices, spk) in enumerate(batches):
        B = slices.shape[0]
        total, zs, idxs = 0.0, [], []
        for r0 in range(0, B, block):
            s, sp = slices[r0:r0 + block], spk[r0:r0 + block].long()
            wav, ids_in, targets = ref.frame(s, mu)
            z = ref.encoder(p, m, wav, prec)
            idx = ref.nearest(z, cb)
            e = cb[idx]
            e_st = z + (e - z).detach()
            loss2 = ((z.detach() - e) ** 2).mean()
            loss3 = ((z - e.detach()) ** 2).mean()
            cond = ref.upsample(p, m, e_st, prec)
            lg = ref.logits(p, ref.skips(p, m, ids_in, cond, sp, prec), prec)
            loss1 = ref.cross_entropy(lg, targets)
            loss = loss1 + beta * loss3 + (0.0 if ema else loss2)
            (loss * (s.shape[0] / B)).backward()
            total += float(loss.detach()) * s.shape[0] / B
            zs.append(z.detach().reshape(-1, z.shape[-1]))
            idxs.append(idx.reshape(-1))
            del z, e, e_st, cond, lg, loss, loss1, loss2, loss3
        losses.append(total)
        if step == 0:
            grad1 = {k: float(w.grad.double().norm())
                     for k, w in p.items() if w.grad is not None}
        _adam(p, mom, step + 1, tr)
        for w in p.values():
            w.grad = None
        if ema or m["code_restart_threshold"] > 0:
            z = torch.cat(zs)
            _codebook_update(cb, vq, z, torch.cat(idxs),
                             picks(step, z.shape[0], m["K"]), m)
    change = {k: float((p[k].detach() - p0[k].float()).double().norm())
              for k in p}
    return {"loss": losses, "grad1": grad1, "change": change}

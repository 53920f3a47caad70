"""The plain reference of NSynth's WaveNet autoencoder (Engel et al.
2017, arXiv:1704.01279), as magenta's ``nsynth/wavenet/h512_bo16.py``
builds it, in float32 PyTorch written from its equations: the forward,
the loss, the gradients through autograd, and the first training steps.

It imports nothing of the program.  Weights are a flat dict keyed as
the program exports them (``decoder/layers/wf``, ...): conv weights
``[k, C_in, C_out]``, 1x1 weights ``[C_in, C_out]``, a stack's leaves
stacked ``[L, ...]``.  With the configuration's ``model`` group ``m``,
C = ``ae_width``, R = ``width``, S = ``skip_width``:

* input: magenta's ``utils.mu_law``: ``q = floor(128 sign(x) ln(1 +
  255|x|) / ln 256)``, clipped to ``[-128, 127]``; ``xs = q / 128``;
  targets ``q + 128``;
* encoder (non-causal, taps ``t - d``, ``t``, ``t + d``):
  ``en = conv3(xs)``; 30 times ``en += conv1(relu(conv3_d(relu(en))))``;
  then ``conv1(en) -> 16`` and the mean over each 512-sample frame;
* decoder (causal, taps ``t - 2d``, ``t - d``, ``t``):
  ``l = conv3(shift_right(xs))``, ``s = conv1(l) -> S``; 30 times
  ``u = conv3_d(l) -> 2R + tile(conv1(en) -> 2R)``,
  ``z = sigmoid(u[:R]) tanh(u[R:])``, ``l += conv1(z) -> R``,
  ``s += conv1(z) -> S``;
* head: ``relu(conv1(relu(s)) -> S + tile(conv1(en) -> S))``, then
  ``conv1 -> 256`` logits; the loss the mean softmax cross-entropy.
  Every conv has a bias; ``tile`` repeats a frame's row over its 512
  samples.

Departures from magenta, each stated in the configuration's
``assumed``: ``shift_right``'s zero at the first position is the
slice's previous sample (the slice holds ``T + 1`` samples; the targets
are its last ``T``); the clip of ``q`` at 127 (magenta's floor reaches
128 at ``x = 1``).  Products are taken one a tap, in ``[B, T, C]``,
with ``Prec`` rounding their operands for the control.
"""

from __future__ import annotations

import math
from typing import Dict, List, Sequence, Tuple

import torch

from portbench.reference.model import F32, Prec
from portbench.reference.train import _adam


def mu_law(x: torch.Tensor, mu: int) -> torch.Tensor:
    """magenta's mu-law: ``q`` in ``[-mu/2, mu/2 - 1]`` (long)."""
    half = mu // 2
    x = x.clamp(-1.0, 1.0)
    y = torch.sign(x) * torch.log1p((mu - 1) * x.abs()) / math.log(mu)
    return torch.floor(half * y).clamp(-half, half - 1).long()


def frame(slices: torch.Tensor, mu: int):
    """Raw ``[B, T+1]`` float slices -> (the decoder's input ``[B, T]``
    (each target's previous sample), the encoder's input ``[B, T]``,
    the target ids ``[B, T]``)."""
    q = mu_law(slices, mu)
    xs = q.float() / (mu // 2)
    return xs[:, :-1], xs[:, 1:], q[:, 1:] + mu // 2


def _shifted(x: torch.Tensor, o: int) -> torch.Tensor:
    """``x[:, t + o]`` along axis 1 of ``[B, T, C]``, zero outside."""
    T = x.shape[1]
    if abs(o) >= T:
        return torch.zeros_like(x)
    if o >= 0:
        return torch.nn.functional.pad(x[:, o:], (0, 0, 0, o))
    return torch.nn.functional.pad(x[:, :T + o], (0, 0, -o, 0))


def conv(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor, dil: int = 1,
         causal: bool = True, prec: Prec = F32) -> torch.Tensor:
    """A conv of ``k`` taps (``w [k, C_in, C_out]``) or a 1x1 (``w
    [C_in, C_out]``) over ``x [B, T, C_in]``, one product a tap."""
    if w.dim() == 2:
        return prec.mm(x, w) + b
    k = w.shape[0]
    first = -(k - 1) * dil if causal else -((k - 1) // 2) * dil
    y = 0.0
    for j in range(k):
        y = y + prec.mm(_shifted(x, first + j * dil), w[j])
    return y + b


def _tile(c: torch.Tensor, hop: int) -> torch.Tensor:
    return c.repeat_interleave(hop, dim=1)


def dilations(layers: int, stages: int) -> List[int]:
    return [2 ** (i % stages) for i in range(layers)]


def latent(p: Dict[str, torch.Tensor], m: dict, xs: torch.Tensor,
           prec: Prec = F32) -> torch.Tensor:
    """Encoder input ``[B, T]`` -> the latent ``[B, T / hop, e]``."""
    en = conv(xs[..., None], p["encoder/start/w"], p["encoder/start/b"],
              causal=False, prec=prec)
    for i, d in enumerate(dilations(m["ae_num_layers"], m["ae_num_stages"])):
        h = conv(torch.relu(en), p["encoder/layers/wd"][i],
                 p["encoder/layers/bd"][i], d, causal=False, prec=prec)
        en = en + conv(torch.relu(h), p["encoder/layers/wr"][i],
                       p["encoder/layers/br"][i], prec=prec)
    en = conv(en, p["encoder/bottleneck/w"], p["encoder/bottleneck/b"],
              prec=prec)
    B, T, e = en.shape
    hop = m["ae_hop_length"]
    return en.reshape(B, T // hop, hop, e).mean(2)


def logits(p: Dict[str, torch.Tensor], m: dict, xs_prev: torch.Tensor,
           xs: torch.Tensor, prec: Prec = F32) -> torch.Tensor:
    """Float32 logits ``[B, T, mu]``."""
    R, hop = m["width"], m["ae_hop_length"]
    z = latent(p, m, xs, prec)
    lay = {k: p[f"decoder/layers/{k}"] for k in
           ("wf", "bf", "wc", "bc", "wr", "br", "ws", "bs")}
    l = conv(xs_prev[..., None], p["decoder/start/w"], p["decoder/start/b"],
             prec=prec)
    s = conv(l, p["decoder/skip_start/w"], p["decoder/skip_start/b"],
             prec=prec)
    for i, d in enumerate(dilations(m["num_layers"], m["num_stages"])):
        u = conv(l, lay["wf"][i], lay["bf"][i], d, prec=prec) + \
            _tile(conv(z, lay["wc"][i], lay["bc"][i], prec=prec), hop)
        g = torch.sigmoid(u[..., :R]) * torch.tanh(u[..., R:])
        l = l + conv(g, lay["wr"][i], lay["br"][i], prec=prec)
        s = s + conv(g, lay["ws"][i], lay["bs"][i], prec=prec)
    h = conv(torch.relu(s), p["decoder/head/out1/w"],
             p["decoder/head/out1/b"], prec=prec)
    h = torch.relu(h + _tile(conv(z, p["decoder/head/cond/w"],
                                  p["decoder/head/cond/b"], prec=prec), hop))
    return conv(h, p["decoder/head/logits/w"], p["decoder/head/logits/b"],
                prec=prec)


def crop_losses(p: Dict[str, torch.Tensor], m: dict, slices: torch.Tensor,
                prec: Prec = F32) -> torch.Tensor:
    """Each crop's mean softmax cross-entropy ``[B]``."""
    xs_prev, xs, targets = frame(slices, m["mu"])
    lg = logits(p, m, xs_prev, xs, prec)
    picked = lg.gather(-1, targets[..., None])[..., 0]
    return (torch.logsumexp(lg, -1) - picked).mean(1)


def loss(p: Dict[str, torch.Tensor], m: dict, slices: torch.Tensor,
         prec: Prec = F32) -> torch.Tensor:
    return crop_losses(p, m, slices, prec).mean()


def first_steps(p0: Dict[str, torch.Tensor], m: dict, tr: dict,
                batches: Sequence[Tuple[torch.Tensor, torch.Tensor]],
                prec: Prec = F32, block: int = 8,
                vectors: bool = False) -> dict:
    """Follow ``len(batches)`` Adam steps from the weights ``p0``, as
    ``reference/train.py::first_steps`` does for the VQ-VAE (a batch is
    raw slices ``[B, T+1]`` and the speaker ids, which this model does
    not read), the batch in blocks of ``block`` rows.  Returns each
    step's loss, each crop's loss in the first step (``crop_loss1``),
    the norm of each leaf's first gradient, and the norm of each leaf's
    change after the last step; with ``vectors``, also each leaf's
    first gradient whole (``grad1_vec``)."""
    p = {k: v.detach().clone().float().requires_grad_(True)
         for k, v in p0.items()}
    mom: dict = {}
    losses: List[float] = []
    crops: List[float] = []
    grad1: Dict[str, float] = {}
    vec: Dict[str, torch.Tensor] = {}
    for step, (slices, _) in enumerate(batches):
        B = slices.shape[0]
        total = 0.0
        for r0 in range(0, B, block):
            s = slices[r0:r0 + block]
            cl = crop_losses(p, m, s, prec)
            if step == 0:
                crops += cl.tolist()
            lo = cl.mean()
            (lo * (s.shape[0] / B)).backward()
            total += float(lo.detach()) * s.shape[0] / B
            del lo, cl
        losses.append(total)
        if step == 0:
            grad1 = {k: float(w.grad.double().norm())
                     for k, w in p.items() if w.grad is not None}
            if vectors:
                vec = {k: w.grad.detach().clone() for k, w in p.items()
                       if w.grad is not None}
        _adam(p, mom, step + 1, tr)
        for w in p.values():
            w.grad = None
    change = {k: float((p[k].detach() - p0[k].float()).double().norm())
              for k in p}
    out = {"loss": losses, "crop_loss1": crops, "grad1": grad1,
           "change": change}
    if vectors:
        out["grad1_vec"] = vec
    return out

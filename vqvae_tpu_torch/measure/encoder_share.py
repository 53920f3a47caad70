"""The encoder's share of the training step (port of
``scripts/encoder_share.py``).

At the flagship's shapes (``vctk-multi``, T=7680, bf16), times

1. the encoder alone, forward and backward: ``sum(z * cos(z))`` of
   ``models/encoder.py::apply_encoder`` on the step's own parameters and
   input (``z * cos(z)`` touches every output), its gradient with
   respect to the encoder's parameters; timed before the step runs, as
   the JAX script must (its step donates the state);
2. the whole training step (forward, backward, Adam, EMA);

and prints both and their ratio as one JSON line: ``step_ms``,
``encoder_fwd_bwd_ms``, ``encoder_share``.  A kernel for the encoder
can at best win its share.  ``--encoder-kernel pallas`` runs the fused
encoder (``kernels/encoder_cuda.py``: its forward and recompute backward
kernels) in both.

    python -m vqvae_tpu_torch.measure.encoder_share [--batch 32]
        [--decoder-kernel pallas] [--encoder-kernel xla|pallas]
"""

from __future__ import annotations

import argparse

import torch

from vqvae_tpu_torch.cli.common import add_device_arg, resolve_device
from vqvae_tpu_torch.configs import get_config
from vqvae_tpu_torch.measure import _common as mc
from vqvae_tpu_torch.measure.train_roofline import WARMUP, batch_step
from vqvae_tpu_torch.models.encoder import apply_encoder

ITERS = 20


def enc_fwd_bwd(enc_params, cfg, wav: torch.Tensor):
    """(``sum(z * cos(z))``, its gradients by parameter name, ``layers/
    0/w`` ...); ``enc_params`` must require grad."""
    names, params = zip(*enc_params.named_parameters())
    z = apply_encoder(enc_params, cfg, wav)
    obj = torch.sum(z * torch.cos(z))
    grads = torch.autograd.grad(obj, params)
    return obj.detach(), {n.replace(".", "/"): g
                          for n, g in zip(names, grads)}


def measure(cfg, B: int, dev) -> dict:
    state, step = batch_step(cfg, B, dev)
    wav = mc.make_batch(mc.with_batch(cfg, B), B, dev)[0][:, :cfg.data.length]
    enc = state.params["encoder"]
    call = lambda: enc_fwd_bwd(enc, cfg.model, wav)  # noqa: E731
    call()
    enc_ms = mc.wall_ms(call, ITERS, dev)
    for _ in range(WARMUP):
        step()
    step_ms = mc.wall_ms(step, ITERS, dev)
    del state
    return {"batch": B, "preset": cfg.name,
            "decoder_kernel": cfg.model.decoder_kernel,
            "encoder_kernel": cfg.model.encoder_kernel,
            "step_ms": step_ms, "encoder_fwd_bwd_ms": enc_ms,
            "encoder_share": enc_ms / step_ms}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--batch", type=int, default=32)
    ap.add_argument("--decoder-kernel", default="pallas",
                    choices=["xla", "pallas", "pallas_sg"])
    ap.add_argument("--encoder-kernel", default="xla",
                    choices=["xla", "pallas"])
    add_device_arg(ap)
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    cfg = mc.with_model(get_config("vctk-multi"),
                        decoder_kernel=args.decoder_kernel,
                        encoder_kernel=args.encoder_kernel)
    return mc.emit(measure(cfg, args.batch, dev), dev)


if __name__ == "__main__":
    main()

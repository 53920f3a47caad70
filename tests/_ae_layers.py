"""The WaveNet autoencoder's decoder layers as separate ops, the plain
version that ``kernels/wavenet_ae_cuda.py::GatedStack`` is tested
against on the CPU (``test_torch_wavenet_ae.py``) and on the card
(``test_torch_cuda.py``)."""

import torch

from vqvae_tpu_torch.models import wavenet_ae as W


def per_op_layers(l, s, cond, wf, wr, br, ws, bs, dils, hop):
    """The gated layers as separate ops (the stack before ``GatedStack``):
    the tap conv, the condition tiled over each frame, the gate, then one
    product for residual and skip with their biases, added out of
    place.  ``l [B, T, R]``, ``s [B*T, S]``."""
    B, T, R = l.shape
    S, L, k = ws.shape[-1], len(dils), wf.shape[1]
    wrs = torch.cat([wr, ws], 2).unbind(0)
    brs = torch.cat([br, bs], 1).unbind(0)
    for i, dil in enumerate(dils):
        u = W._tile(W.tap_conv(l, wf[i], W.causal_offsets(k, dil)),
                    cond[i], hop)
        ua, ub = u.split(R, -1)
        z = (torch.sigmoid(ua) * torch.tanh(ub)).view(B * T, R)
        if i < L - 1:
            r, sk = torch.addmm(brs[i], z, wrs[i]).split([R, S], -1)
            l = l + r.view(B, T, R)
        else:
            sk = torch.addmm(brs[i][R:], z, wrs[i][:, R:])
        s = s + sk
    return s

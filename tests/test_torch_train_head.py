"""The fused head + softmax-CE's plain PyTorch version
(``kernels/head_ce_cuda.py`` on CPU tensors) against the JAX package's
Pallas kernel in interpret mode: loss and every gradient, with a row
count that is not a multiple of the kernel's row tile.  The CUDA
kernels are held against this plain version on the card."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vqvae_tpu.kernels import head_ce_pallas as hk
from vqvae_tpu_torch.kernels import head_ce_cuda as hc

torch.set_num_threads(1)


def _inputs(B=2, T=100, S=64, mu=256, seed=0):
    rng = np.random.default_rng(seed)

    def rn(*shape, scale=1.0):
        return (rng.standard_normal(shape) * scale).astype(np.float32)
    return (rn(B, T, S), rng.integers(0, mu, (B, T)).astype(np.int32),
            rn(S, S, scale=S ** -0.5), rn(S, scale=0.1),
            rn(S, mu, scale=S ** -0.5), rn(mu, scale=0.1))


# S = 64, and the widths the card runs (stretch: S = mu = 256); the ids
# of the S = 64 cases are the ones this test had before it took S
@pytest.mark.parametrize("cdt, S", [
    pytest.param(torch.float32, 64, id="cdt0"),
    pytest.param(torch.bfloat16, 64, id="cdt1"),
    pytest.param(torch.float32, 256, id="cdt0-S256"),
    pytest.param(torch.bfloat16, 256, id="cdt1-S256")])
def test_plain_head_ce_matches_jax(cdt, S, monkeypatch):
    # a 96-row tile: 200 rows (not a multiple of the card kernels' 32-row
    # tile, nor of 64) pad to 288 in the JAX kernel
    monkeypatch.setattr(hk, "TILE", 96)
    skips, tgt, w1, b1, w2, b2 = _inputs(S=S)
    jd = jnp.float32 if cdt == torch.float32 else jnp.bfloat16
    g = 1.7

    def jloss(s, a, b, c, d):
        return hk.head_ce_pallas(True, s, jnp.asarray(tgt), a, b, c, d)
    jl, vjp = jax.vjp(jloss, jnp.asarray(skips, jd), *map(jnp.asarray,
                                                          (w1, b1, w2, b2)))
    jg = vjp(jnp.float32(g))

    ts = torch.tensor(skips).to(cdt).requires_grad_()
    tw = [torch.tensor(v, requires_grad=True) for v in (w1, b1, w2, b2)]
    loss = hc._HeadCE.apply(ts, torch.from_numpy(tgt), *tw)
    loss.backward(torch.tensor(g))
    if cdt == torch.float32:
        rtol, atol, lrtol = 1e-3, 1e-4, 1e-5
    else:                       # test_kernels.py's bf16 head tolerances
        rtol, atol, lrtol = 5e-2, 2e-2, 1e-2
    np.testing.assert_allclose(float(loss.detach()), float(jl), rtol=lrtol)
    for a, b in zip([ts.grad] + [t.grad for t in tw], jg):
        b = np.asarray(b, np.float32)
        assert a.dtype == (cdt if a is ts.grad else torch.float32)
        np.testing.assert_allclose(a.float().numpy(), b, rtol=rtol,
                                   atol=atol * np.abs(b).max() + 1e-8)

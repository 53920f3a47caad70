"""The fused training chunk's plain PyTorch version
(``kernels/wavenet_train_cuda.py`` on CPU tensors) against the JAX
package's Pallas chunk kernels with saved gates, run in interpret mode
as ``tests/test_kernels.py`` runs them: forward values and the VJP of
every input, for the three variants (bias-seeded, chained ``acc``,
in-kernel ``embed``).  The CUDA kernels are held against this plain
version on the card (``chip_smoke.py``, ``tests/test_torch_cuda.py``)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vqvae_tpu.kernels import wavenet_train_pallas as jwt
from vqvae_tpu_torch.kernels import wavenet_train_cuda as wt

torch.set_num_threads(1)

JAX_DT = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}


def _inputs(mode, B, T, R=32, S=64, d=16, mu=256, dils=(1, 2, 4),
            seed=0):
    """numpy float32 inputs (non-zero biases) and cotangents."""
    rng = np.random.default_rng(seed)
    nl = len(dils)

    def rn(*shape, scale=1.0):
        return (rng.standard_normal(shape) * scale).astype(np.float32)
    x = {"cond": rn(B, T, d), "gc": rn(B, nl, 2 * R, scale=0.3),
         "wff": rn(nl, 2 * R, 2 * R, scale=0.15),
         "vc": rn(nl, d, 2 * R, scale=0.2), "wr": rn(nl, R, R, scale=0.2),
         "br": rn(nl, R, scale=0.1), "ws": rn(nl, R, S, scale=0.2)}
    if mode == wt.EMBED:
        lead = {"ids": rng.integers(0, mu, (B, T)).astype(np.int32),
                "wemb": rn(2, mu, R, scale=0.5), "bemb": rn(1, R, scale=0.1)}
        tail = rn(1, S, scale=0.1)
    else:
        lead = {"h": rn(B, T, R, scale=0.5)}
        tail = rn(B, T, S, scale=0.3) if mode == wt.ACC else rn(1, S,
                                                                  scale=0.1)
    cots = (rn(B, T, R, scale=0.1), rn(B, T, S, scale=0.1))
    return dils, lead, x, tail, cots


def _jax(mode, dils, lead, x, tail, cots, cdt):
    fn = {wt.SEED: jwt.fused_stack_chunk, wt.ACC: jwt.fused_stack_chunk_acc,
          wt.EMBED: jwt.fused_stack_chunk_embed}[mode]
    jd = JAX_DT[cdt]
    cast = {k: jnp.asarray(v) if k == "ids" else jnp.asarray(v, jd)
            for k, v in lead.items()}
    args = list(cast.values()) + [jnp.asarray(v, jd) for v in x.values()]
    args.append(jnp.asarray(tail, jd))
    first = 1 if mode == wt.EMBED else 0     # ids get no cotangent

    def f(*diff):
        full = args[:first] + list(diff) if first else list(diff)
        return fn(tuple(dils), True, True, 0, *full)
    out, vjp = jax.vjp(f, *args[first:])
    grads = vjp(tuple(jnp.asarray(c, jd) for c in cots))
    return out, grads


def _port(mode, dils, lead, x, tail, cots, cdt):
    def t(v):
        return torch.tensor(v).to(cdt).requires_grad_()
    if mode == wt.EMBED:
        lead_t = [torch.tensor(lead["ids"]), t(lead["wemb"]),
                  t(lead["bemb"][0])]
        diff = lead_t[1:]
    else:
        lead_t = [t(lead["h"]), None, None]
        diff = lead_t[:1]
    rest = [t(v) for v in x.values()]
    tail_t = t(tail)
    h, skips = wt.Chunk.apply(dils, mode, *lead_t, *rest, tail_t)
    inputs = diff + rest + [tail_t]
    grads = torch.autograd.grad((h, skips), inputs, tuple(
        torch.tensor(c).to(cdt) for c in cots))
    return (h, skips), grads


def _close(got, want, rtol, atol_scale):
    want = np.asarray(want, np.float32).reshape(-1)
    got = got.detach().float().numpy().reshape(-1)
    scale = float(np.abs(want).max()) + 1e-9
    np.testing.assert_allclose(got, want, rtol=rtol,
                               atol=atol_scale * scale + 1e-8)


@pytest.mark.parametrize("mode", [wt.SEED, wt.ACC, wt.EMBED])
def test_plain_chunk_matches_jax_f32(mode):
    case = _inputs(mode, B=2, T=128)
    (jh, js), jg = _jax(mode, *case, torch.float32)
    (h, s), g = _port(mode, *case, torch.float32)
    np.testing.assert_allclose(h.detach().numpy(), np.asarray(jh),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(s.detach().numpy(), np.asarray(js),
                               rtol=1e-5, atol=1e-6)
    assert len(g) == len(jg)
    for a, b in zip(g, jg):
        _close(a, b, rtol=1e-3, atol_scale=1e-4)


def test_plain_chunk_matches_jax_bf16_embed():
    """The shipped combination (embed first chunk) in bfloat16: every
    output and gradient within 3e-2 of its max."""
    case = _inputs(wt.EMBED, B=1, T=128, seed=3)
    (jh, js), jg = _jax(wt.EMBED, *case, torch.bfloat16)
    (h, s), g = _port(wt.EMBED, *case, torch.bfloat16)
    for a, b in zip((h, s) + tuple(g), (jh, js) + tuple(jg)):
        b = np.asarray(b, np.float32)
        err = np.abs(a.detach().float().numpy().reshape(b.shape) - b).max()
        assert err <= 3e-2 * np.abs(b).max(), err


def test_decoder_stack_chains_chunks_like_jax():
    """Two chained chunks (L=16) with the first embedding in-kernel,
    through ``decoder_stack``: skips equal JAX's
    ``decoder_stack_pallas`` in float32."""
    import dataclasses
    from vqvae_tpu.configs import get_config as jax_config
    from vqvae_tpu.models import init_model as jax_init
    from vqvae_tpu.models.wavenet import global_cond as jax_gcond
    from vqvae_tpu_torch.configs import get_config
    from vqvae_tpu_torch.convert import flatten, from_numpy_tree
    from vqvae_tpu_torch.models.wavenet import global_cond
    kw = dict(n_loop=2, n_layer=8, decoder_kernel="pallas_sg",
              embed_in_kernel=True)
    jcfg = dataclasses.replace(jax_config("tiny").model, **kw)
    cfg = dataclasses.replace(get_config("tiny").model, **kw)
    jparams = jax_init(jax.random.PRNGKey(2), jcfg)["decoder"]
    params = from_numpy_tree(flatten(jax.tree_util.tree_map(np.asarray,
                                                            jparams)))
    rng = np.random.default_rng(0)
    ids = rng.integers(0, cfg.mu, (2, 128)).astype(np.int32)
    cond = rng.standard_normal((2, 128, cfg.d)).astype(np.float32)
    spk = np.array([0, 3])
    want = jwt.decoder_stack_pallas(
        jparams, jcfg, None, jnp.asarray(cond),
        jax_gcond(jparams, jcfg, jnp.asarray(spk)), interpret=True,
        ids=jnp.asarray(ids))
    got = wt.decoder_stack(params, cfg, None, torch.from_numpy(cond),
                           global_cond(params, cfg, torch.from_numpy(spk)),
                           ids=torch.from_numpy(ids))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)

"""The VQ search's plain version (``kernels/vq_cuda.py`` on CPU
tensors) against the JAX package's Pallas VQ kernel in interpret mode,
``quantize(impl="pallas")`` against JAX's, and three train steps with
``impl="pallas"`` and ``vctk-multi``'s switches against JAX's steps.
The CUDA kernel is held against the plain version on the card
(``chip_smoke.py``, ``tests/test_torch_cuda.py``)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vqvae_tpu.configs import get_config as jax_config
from vqvae_tpu.kernels.vq_pallas import vq_argmin_pallas
from vqvae_tpu.models import init_model as jax_init
from vqvae_tpu.models.vq import quantize as jax_quantize
from vqvae_tpu.train.state import create_train_state as jax_state
from vqvae_tpu.train.step import train_step as jax_train_step
from vqvae_tpu_torch.configs import get_config
from vqvae_tpu_torch.convert import flatten, from_numpy_tree
from vqvae_tpu_torch.kernels import vq_cuda
from vqvae_tpu_torch.models.vq import nearest_code, quantize
from vqvae_tpu_torch.train.state import create_train_state
from vqvae_tpu_torch.train.step import train_step

torch.set_num_threads(1)


def _margin_rows(z, cb, rel=1e-4):
    """Rows whose two best float64 scores differ by more than
    ``rel`` of the largest score magnitude (an id may flip below it)."""
    s = 2.0 * (z.astype(np.float64) @ cb.astype(np.float64).T) - (
        cb.astype(np.float64) ** 2).sum(-1)
    top = np.sort(s, -1)[:, -2:]
    return (top[:, 1] - top[:, 0]) > rel * np.abs(s).max()


@pytest.mark.parametrize("N", [700, 1920])
def test_vq_argmin_plain_matches_jax_pallas(N):
    """K=512, d=64 (vctk-multi), N not a multiple of JAX's 512-row tile:
    ids equal on every row above the near-tie margin."""
    rng = np.random.default_rng(N)
    z = rng.standard_normal((N, 64)).astype(np.float32)
    cb = rng.standard_normal((512, 64)).astype(np.float32)
    want = np.asarray(vq_argmin_pallas(jnp.asarray(z), jnp.asarray(cb),
                                       interpret=True))
    got = vq_cuda.vq_argmin(torch.from_numpy(z), torch.from_numpy(cb))
    assert got.dtype == torch.int32 and got.shape == (N,)
    far = _margin_rows(z, cb)
    print(f"N={N}: {int((~far).sum())} near-tie rows left out")
    assert far.sum() >= 0.9 * N
    np.testing.assert_array_equal(got.numpy()[far], want[far])


def test_vq_argmin_ties_go_to_the_first_index():
    z = torch.randn(9, 8, generator=torch.Generator().manual_seed(0))
    cb = torch.randn(5, 8, generator=torch.Generator().manual_seed(1))
    got = vq_cuda.vq_argmin(z, torch.cat([cb, cb]))
    assert int(got.max()) < 5
    assert torch.equal(got.long(), nearest_code(z, cb))


def test_quantize_pallas_matches_jax():
    """e, e_st and the ids of ``quantize(impl="pallas")`` against
    JAX's; e_st's gradient passes to z unchanged."""
    rng = np.random.default_rng(4)
    z = rng.standard_normal((3, 40, 64)).astype(np.float32)
    cb = rng.standard_normal((512, 64)).astype(np.float32)
    je_st, je, jidx = jax_quantize({"codebook": jnp.asarray(cb)},
                                   jnp.asarray(z), "pallas")
    zt = torch.from_numpy(z).requires_grad_()
    e_st, e, idx = quantize({"codebook": torch.from_numpy(cb)}, zt, "pallas")
    far = _margin_rows(z.reshape(-1, 64), cb).reshape(idx.shape)
    np.testing.assert_array_equal(idx.numpy()[far], np.asarray(jidx)[far])
    np.testing.assert_array_equal(e.detach().numpy()[far],
                                  np.asarray(je)[far])
    np.testing.assert_allclose(e_st.detach().numpy()[far],
                               np.asarray(je_st)[far], rtol=1e-6, atol=1e-6)
    e_st.sum().backward()
    assert torch.equal(zt.grad, torch.ones_like(zt))


def test_unknown_vq_impl_raises():
    with pytest.raises(ValueError, match="impl"):
        nearest_code(torch.zeros(2, 4), torch.zeros(3, 4), "fast")


def test_three_pallas_train_steps_match_jax():
    """vctk-multi's switches (recompute chunk kernels, gradient
    codebook, plain head) at tiny widths with ``impl="pallas"``, from
    JAX-initialised parameters on the same batches: every step's loss
    and metrics at rtol 1e-4 (Adam amplifies float32 differences in
    the gradients from step to step)."""
    switches = dict(decoder_kernel="pallas", head_kernel="xla", ema=False,
                    n_loop=2, n_layer=6)
    cfg = get_config("tiny")
    cfg = cfg.replace(model=dataclasses.replace(cfg.model, **switches),
                      train=dataclasses.replace(cfg.train, batch_size=2))
    jcfg = jax_config("tiny")
    jcfg = jcfg.replace(model=dataclasses.replace(jcfg.model, **switches),
                        train=dataclasses.replace(jcfg.train, batch_size=2))
    jst = jax_state(jax.random.PRNGKey(0), jcfg)
    params = from_numpy_tree(flatten(jax.tree_util.tree_map(
        np.asarray, jst.params)), trainable=True)
    state = create_train_state(cfg, params=params)
    step = jax.jit(jax_train_step, static_argnames=("cfg", "impl"))
    rng = np.random.default_rng(0)
    for i in range(3):
        wav = rng.uniform(-0.9, 0.9, (2, 129)).astype(np.float32)
        spk = np.array([i % 4, 3], np.int32)
        jst, jm = step(jst, jnp.asarray(wav), jnp.asarray(spk), jcfg,
                       impl="pallas")
        m = train_step(state, torch.from_numpy(wav), torch.from_numpy(spk),
                       cfg, impl="pallas")
        for k in ("loss", "loss1", "loss2", "loss3", "codebook_usage"):
            np.testing.assert_allclose(float(m[k]), float(jm[k]), rtol=1e-4,
                                       err_msg=f"step {i + 1} {k}")

"""The vector quantizer's training half against the JAX package: the
straight-through gradients, loss2/loss3, the EMA update, dead-code
restart (with JAX's random picks injected) and the code perplexity."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vqvae_tpu.configs import get_config as jax_config
from vqvae_tpu.models import vq as jvq
from vqvae_tpu_torch.configs import get_config
from vqvae_tpu_torch.convert import vq_state_from_numpy, vq_state_to_numpy
from vqvae_tpu_torch.models import vq

torch.set_num_threads(1)


def _setup(seed=0, n=40):
    jcfg = jax_config("tiny").model
    jcfg = jcfg.replace(ema=True) if hasattr(jcfg, "replace") else jcfg
    rng = np.random.default_rng(seed)
    cb = rng.standard_normal((jcfg.K, jcfg.d)).astype(np.float32)
    z = rng.standard_normal((2, n // 2, jcfg.d)).astype(np.float32)
    return jcfg, cb, z


def test_quantize_ste_gradients_and_losses_match_jax():
    jcfg, cb, z = _setup()
    w = np.random.default_rng(1).standard_normal(z.shape).astype(np.float32)

    def jloss(cbk, zz):
        e_st, e, _ = jvq.quantize({"codebook": cbk}, zz)
        l2, l3 = jvq.vq_losses(zz, e)
        return jnp.sum(e_st * w) + 3.0 * l2 + 0.25 * l3, (l2, l3)

    (jl, (jl2, jl3)), (jg_cb, jg_z) = jax.value_and_grad(
        jloss, argnums=(0, 1), has_aux=True)(jnp.asarray(cb), jnp.asarray(z))
    tcb = torch.tensor(cb, requires_grad=True)
    tz = torch.tensor(z, requires_grad=True)
    e_st, e, idx = vq.quantize({"codebook": tcb}, tz)
    l2, l3 = vq.vq_losses(tz, e)
    loss = torch.sum(e_st * torch.from_numpy(w)) + 3.0 * l2 + 0.25 * l3
    loss.backward()
    np.testing.assert_array_equal(
        idx.numpy(), np.asarray(jvq.nearest_code(jnp.asarray(z),
                                                 jnp.asarray(cb))))
    for a, b in ((loss, jl), (l2, jl2), (l3, jl3)):
        np.testing.assert_allclose(float(a.detach()), float(b), rtol=1e-5)
    for a, b in ((tcb.grad, jg_cb), (tz.grad, jg_z)):
        b = np.asarray(b)
        np.testing.assert_allclose(a.numpy(), b, rtol=1e-3,
                                   atol=1e-4 * np.abs(b).max() + 1e-8)


def test_ema_update_and_restart_match_jax():
    jcfg, cb, z = _setup(3, n=64)
    cfg = get_config("tiny").model
    import dataclasses
    jcfg = dataclasses.replace(jcfg, ema=True, code_restart_threshold=0.02)
    cfg = dataclasses.replace(cfg, ema=True, code_restart_threshold=0.02)
    idx = np.array(jvq.nearest_code(jnp.asarray(z), jnp.asarray(cb)))
    jst = jvq.init_vq_state({"codebook": jnp.asarray(cb)})
    st = vq.init_vq_state({"codebook": torch.from_numpy(cb)})
    np.testing.assert_array_equal(vq_state_to_numpy(st)["sum"],
                                  np.asarray(jst.sum))
    jp, tp = {"codebook": jnp.asarray(cb)}, {"codebook": torch.from_numpy(cb)}
    for step in range(3):
        jp, jst = jvq.ema_update(jp, jst, jnp.asarray(z), jnp.asarray(idx),
                                 jcfg)
        tp, st = vq.ema_update(tp, st, torch.from_numpy(z),
                               torch.from_numpy(idx), cfg)
        key = jax.random.fold_in(jax.random.PRNGKey(101), step)
        picks = np.asarray(jax.random.randint(key, (jcfg.K,), 0,
                                              z.size // jcfg.d))
        jp, jst = jvq.restart_dead_codes(jp, jst, jnp.asarray(z), key, jcfg)
        tp, st = vq.restart_dead_codes(tp, st, torch.from_numpy(z),
                                       torch.from_numpy(picks), cfg)
        assert bool((st.count == 0.02).any())   # some codes restarted
        for a, b in ((tp["codebook"], jp["codebook"]), (st.count, jst.count),
                     (st.sum, jst.sum)):
            b = np.asarray(b)
            np.testing.assert_allclose(a.numpy(), b, rtol=1e-5,
                                       atol=1e-6 * np.abs(b).max())
    # the state crosses to and from the JAX layout
    back = vq_state_from_numpy(np.asarray(jst.count), np.asarray(jst.sum))
    np.testing.assert_array_equal(back.sum.numpy(), np.asarray(jst.sum))


def test_usage_update_and_perplexity_match_jax():
    jcfg, cb, z = _setup(4)
    idx = np.random.default_rng(2).integers(0, jcfg.K, 50)
    jst = jvq.VQState(count=jnp.full((jcfg.K,), 0.5), sum=jnp.asarray(cb))
    st = vq.VQState(count=torch.full((jcfg.K,), 0.5), sum=torch.tensor(cb))
    want = jvq.usage_update(jst, jnp.asarray(idx), jcfg)
    got = vq.usage_update(st, torch.from_numpy(idx), get_config("tiny").model)
    np.testing.assert_allclose(got.count.numpy(), np.asarray(want.count),
                               rtol=1e-6)
    np.testing.assert_allclose(
        float(vq.code_perplexity(torch.from_numpy(idx), jcfg.K)),
        float(jvq.code_perplexity(jnp.asarray(idx), jcfg.K)), rtol=1e-5)


@pytest.mark.parametrize("seed", [0, 1])
def test_restart_picks_are_seeded_and_in_range(seed):
    a = vq.restart_picks(seed, 5, 37, 128)
    assert torch.equal(a, vq.restart_picks(seed, 5, 37, 128))
    assert not torch.equal(a, vq.restart_picks(seed, 6, 37, 128))
    assert int(a.min()) >= 0 and int(a.max()) < 37

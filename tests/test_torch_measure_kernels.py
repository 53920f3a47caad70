"""The measurement tools' functions against the JAX scripts on the CPU:
``measure/decode_int8_bigbatch.py``'s three chained steps against the
chain ``scripts/decode_int8_bigbatch.py`` builds (its step functions are
local to its ``main``, so the test writes them as the script does), and
``measure/encoder_share.py``'s encoder-only objective and gradients
against ``vqvae_tpu.models.encoder.apply_encoder``."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vqvae_tpu.configs import get_config as jax_config
from vqvae_tpu.models import init_model as jax_init
from vqvae_tpu.models.encoder import apply_encoder as jax_apply_encoder
from vqvae_tpu_torch.configs import get_config
from vqvae_tpu_torch.convert import flatten, from_numpy_tree
from vqvae_tpu_torch.measure import decode_int8_bigbatch as d8
from vqvae_tpu_torch.measure.encoder_share import enc_fwd_bwd

torch.set_num_threads(1)

B = 24
R, L = d8.R, d8.L


def _jax_steps(w16, w8, sc):
    """The script's step functions, as its main writes them."""
    def gate(u):
        return (jnp.tanh(u[:, : 2 * R]) *
                jax.nn.sigmoid(u[:, 2 * R:])).astype(jnp.bfloat16)

    def step_bf16(x):
        for li in range(L):
            x = gate(jnp.dot(x, w16[li], preferred_element_type=jnp.float32))
        return x

    def step_bf16_nogate(x):
        for li in range(L):
            u = jnp.dot(x, w16[li], preferred_element_type=jnp.float32)
            x = (u[:, : 2 * R] * 0.125).astype(jnp.bfloat16)
        return x

    def step_int8(x):
        for li in range(L):
            xi = jnp.clip(x.astype(jnp.float32) * 127.0,
                          -127, 127).astype(jnp.int8)
            acc = jnp.dot(xi, w8[li], preferred_element_type=jnp.int32)
            x = gate(acc.astype(jnp.float32) * sc[li])
        return x
    return {"bf16": jax.jit(step_bf16), "bf16_nogate": jax.jit(
        step_bf16_nogate), "int8": jax.jit(step_int8)}


@pytest.fixture(scope="module")
def chains():
    """The script's draws (seed 0, its order) on both sides."""
    rng = np.random.default_rng(0)
    w16 = jnp.asarray(rng.normal(size=(L, 2 * R, 4 * R)) / 16, jnp.bfloat16)
    w8 = jnp.asarray(rng.integers(-127, 128, (L, 2 * R, 4 * R)), jnp.int8)
    sc = jnp.full((L, 1, 1), 1 / 127.0 / 16, jnp.float32)
    x16 = jnp.asarray(rng.normal(size=(B, 2 * R)), jnp.bfloat16)
    tw16, tw8, tsc, tx16 = d8.script_data(B, "cpu")
    return (_jax_steps(w16, w8, sc), (w8, x16),
            {"bf16": lambda x: d8.step_bf16(x, tw16),
             "bf16_nogate": lambda x: d8.step_bf16_nogate(x, tw16),
             "int8": lambda x: d8.step_int8(x, tw8, tsc)}, (tw8, tx16))


def _t2n(x):
    return x.float().numpy()


def test_script_data_is_the_scripts(chains):
    _, (w8, x16), _, (tw8, tx16) = chains
    np.testing.assert_array_equal(tw8.numpy(), np.asarray(w8))
    np.testing.assert_array_equal(_t2n(tx16),
                                  np.asarray(x16.astype(jnp.float32)))


@pytest.mark.parametrize("name", ["bf16", "bf16_nogate", "int8"])
def test_chained_step_matches_jax(chains, name):
    jsteps, (_, x16), tsteps, (_, tx16) = chains
    want = np.asarray(jsteps[name](x16).astype(jnp.float32))
    got = _t2n(tsteps[name](tx16))
    assert got.shape == want.shape == (B, 2 * R)
    assert np.abs(got - want).max() <= 3e-2 * np.abs(want).max()
    assert np.abs(want).max() > 0


def test_int8_accumulation_is_exact(chains):
    _, (w8, x16), _, (tw8, tx16) = chains
    xi = jnp.clip(x16.astype(jnp.float32) * 127.0, -127, 127).astype(
        jnp.int8)
    txi = d8.quantize(tx16)
    np.testing.assert_array_equal(txi.numpy(), np.asarray(xi))
    for li in (0, L - 1):
        want = np.asarray(jnp.dot(xi, w8[li],
                                  preferred_element_type=jnp.int32))
        got = d8.int8_acc(txi, tw8[li])
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("rows", [1, 16])
def test_int8_refuses_small_batches(rows):
    xi = torch.zeros(rows, 2 * R, dtype=torch.int8)
    with pytest.raises(ValueError, match="more than 16 rows"):
        d8.int8_acc(xi, torch.zeros(2 * R, 4 * R, dtype=torch.int8))


@pytest.fixture(scope="module")
def encoder():
    jcfg = jax_config("tiny").model
    jparams = jax_init(jax.random.PRNGKey(3), jcfg)
    rng = np.random.default_rng(5)
    for layer in jparams["encoder"]["layers"] + [jparams["encoder"]["proj"]]:
        layer["b"] = jnp.asarray(rng.normal(0, 0.3, layer["b"].shape),
                                 jnp.float32)
    params = from_numpy_tree(flatten(jax.tree_util.tree_map(
        np.asarray, jparams)), trainable=True)
    wav = rng.uniform(-0.9, 0.9, (2, 8 * jcfg.hop)).astype(np.float32)
    return jcfg, jparams, params, wav


@pytest.mark.parametrize("kernel", ["xla", "pallas"])
def test_encoder_objective_and_grads_match_jax(encoder, kernel):
    """sum(z * cos(z)) and its encoder gradients, float32 (tiny), the
    port's plain encoder and its fused encoder's plain versions against
    JAX's apply_encoder."""
    jcfg, jparams, params, wav = encoder

    def f(p):
        z = jax_apply_encoder(p, jcfg, jnp.asarray(wav))
        return jnp.sum(z * jnp.cos(z))
    want, jgrads = jax.value_and_grad(f)(jparams["encoder"])
    cfg = dataclasses.replace(get_config("tiny").model,
                              encoder_kernel=kernel)
    got, grads = enc_fwd_bwd(params["encoder"], cfg, torch.from_numpy(wav))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5)
    jflat = flatten(jax.tree_util.tree_map(np.asarray, jgrads))
    assert set(grads) == set(jflat)
    for name, g in grads.items():
        scale = np.abs(jflat[name]).max()
        np.testing.assert_allclose(g.numpy(), jflat[name], rtol=1e-5,
                                   atol=1e-5 * scale, err_msg=name)

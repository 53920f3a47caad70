"""The port's sequence parallelism (vqvae_tpu_torch/parallel/sharded_conv.py,
parallel/sp_decoder.py) in a gloo world of 4 CPU ranks, against the JAX
package's own sharded functions on the same inputs (8 virtual CPU
devices here, 4 used) and against the port's unsharded functions,
gradients included.  One world runs every check (tests/_torch_mesh_worker.py
job ``sp``)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from _torch_world import run_job
from vqvae_tpu.configs import get_config
from vqvae_tpu.models import init_model
from vqvae_tpu.models.wavenet import upsample_cond
from vqvae_tpu.ops.conv import conv1d_init
from vqvae_tpu.parallel.mesh import make_mesh
from vqvae_tpu.parallel.sharded_conv import sharded_causal_conv, \
    time_sharding
from vqvae_tpu.parallel.sp_decoder import apply_decoder_sp
from vqvae_tpu_torch.convert import flatten

DILS = (1, 4, 64, 256)    # up to T/n = 1024/4


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("sp")
    out = tmp / "job-sp"
    out.mkdir()
    rng = np.random.default_rng(0)
    # the causal conv: JAX's sharded op over 4 devices
    B, T, C = 2, 1024, 16
    cp = conv1d_init(jax.random.PRNGKey(0), C, C, 2)
    cp = dict(cp, b=jax.random.normal(jax.random.PRNGKey(3), (C,)) * 0.1)
    x = rng.standard_normal((B, T, C)).astype(np.float32)
    mesh = make_mesh(devices=jax.devices()[:4])
    xs = jax.device_put(jnp.asarray(x), time_sharding(mesh))
    conv = {d: np.asarray(jax.jit(sharded_causal_conv, static_argnums=(2, 3))(
        cp, xs, d, mesh)) for d in DILS}
    # the decoder stack: JAX's SP decoder over 2 and 4 devices
    cfg = get_config("tiny").model          # max dilation 512
    params = init_model(jax.random.PRNGKey(0), cfg)
    Td = 4096
    ids = rng.integers(0, cfg.mu, (2, Td)).astype(np.int32)
    e = rng.standard_normal((2, Td // cfg.hop, cfg.d)).astype(np.float32)
    cond = np.asarray(upsample_cond(params["decoder"], cfg, jnp.asarray(e)),
                      np.float32)
    spk = (np.arange(2) % cfg.n_speakers).astype(np.int32)
    sp = jax.jit(apply_decoder_sp, static_argnums=(1, 5))
    dec = {n: np.asarray(sp(
        params, cfg, jnp.asarray(ids), jnp.asarray(cond), jnp.asarray(spk),
        make_mesh(data=n, model=1, devices=jax.devices()[:n])))
        for n in (2, 4)}
    flat = flatten(jax.tree_util.tree_map(np.asarray, params))
    np.savez(out / "inputs.npz", conv_x=x,
             conv_w=np.asarray(cp["w"]), conv_b=np.asarray(cp["b"]),
             conv_dils=np.asarray(DILS),
             conv_cot=rng.standard_normal((B, T, C)).astype(np.float32),
             ids=ids, cond=cond, spk=spk,
             dec_cot=rng.standard_normal((2, Td, cfg.mu)).astype(np.float32),
             **{f"p/{k}": v for k, v in flat.items()})
    ranks = run_job(4, "sp", tmp)
    return {"ranks": ranks, "conv": conv, "dec": dec}


def _gathered(ranks, key, field, group):
    """The time slices of ``field`` from ``group``'s ranks, in order."""
    parts = sorted(((r[key]["rows"].start, r[key][field].numpy())
                    for r in (ranks[i] for i in group)),
                   key=lambda t: t[0])
    return np.concatenate([p for _, p in parts], axis=1)


@pytest.mark.parametrize("dil", DILS)
def test_sharded_causal_conv_matches_jax_and_unsharded(world, dil):
    ranks = world["ranks"]
    key = f"conv/{dil}"
    got = _gathered(ranks, key, "y", range(4))
    np.testing.assert_allclose(got, world["conv"][dil], rtol=1e-5, atol=1e-6)
    one = ranks[0][f"{key}/one"]
    np.testing.assert_allclose(got, one["y"].numpy(), rtol=1e-6, atol=1e-6)
    # the backward: the halo's gradient travels left
    np.testing.assert_allclose(_gathered(ranks, key, "dx", range(4)),
                               one["dx"].numpy(), rtol=1e-5, atol=1e-6)
    for r in ranks:
        np.testing.assert_allclose(r[key]["dw"].numpy(), one["dw"].numpy(),
                                   rtol=1e-4, atol=1e-4)
        np.testing.assert_allclose(r[key]["db"].numpy(), one["db"].numpy(),
                                   rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("n", [2, 4])
def test_sp_decoder_matches_jax_and_unsharded(world, n):
    """JAX's SP decoder and the port's on the same weights and inputs
    (the ranks of one 'seq' group: 0..n-1, as the mesh lays 'seq' inside
    'data'); the slices equal the port's apply_decoder to float32
    rounding, and JAX's within the port's float32 agreement with JAX."""
    ranks = world["ranks"]
    got = _gathered(ranks, f"dec/{n}", "logits", range(n))
    np.testing.assert_allclose(got, world["dec"][n], rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(got, ranks[0]["dec/one"]["logits"].numpy(),
                               rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("n", [2, 4])
def test_sp_decoder_grads_match_unsharded(world, n):
    """Each weight's gradient summed over the 'seq' group equals the
    unsharded stack's: the halos' gradients reach the ranks they came
    from."""
    ranks = world["ranks"]
    one = ranks[0]["dec/one"]["grads"]
    for r in ranks:
        grads = r[f"dec/{n}"]["grads"]
        assert set(grads) == set(one)
        for k, g in grads.items():
            want = one[k].numpy()
            scale = max(np.abs(want).max(), 1e-6)
            np.testing.assert_allclose(g.numpy() / scale, want / scale,
                                       atol=2e-5, err_msg=k)


def test_sp_decoder_refuses_an_oversized_dilation(world):
    for r in world["ranks"]:
        assert r["refused"] is not None
        assert "every dilation must fit in one time shard: max dil 512 " \
               "> 256" in r["refused"]

"""The whole training forward against the JAX package: loss, metrics
and the gradient of every parameter leaf, with ``stretch``'s switches
(EMA codebook, save-gates chunk kernels, in-kernel embedding, fused
head) at tiny widths over two chained chunks, and on the plain path;
and the path the port refuses (the fused encoder).  ``vctk-multi``'s
switches are in ``test_torch_train_recompute.py``."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vqvae_tpu.audio.framing import frame_batch as jax_frame_batch
from vqvae_tpu.configs import get_config as jax_config
from vqvae_tpu.models import forward as jax_forward
from vqvae_tpu.models import init_model as jax_init
from vqvae_tpu_torch.audio.framing import frame_batch
from vqvae_tpu_torch.configs import get_config
from vqvae_tpu_torch.convert import flatten, from_numpy_tree
from vqvae_tpu_torch.models import forward

torch.set_num_threads(1)

STRETCH = dict(ema=True, code_restart_threshold=1e-3,
               decoder_kernel="pallas_sg", head_kernel="pallas",
               embed_in_kernel=True, n_loop=2, n_layer=8)


def _run_both(switches, T=256, seed=0):
    jcfg = dataclasses.replace(jax_config("tiny").model, **switches)
    cfg = dataclasses.replace(get_config("tiny").model, **switches)
    jparams = jax_init(jax.random.PRNGKey(seed), jcfg)
    flat = flatten(jax.tree_util.tree_map(np.asarray, jparams))
    rng = np.random.default_rng(seed)
    wav = rng.uniform(-0.9, 0.9, (2, T + 1)).astype(np.float32)
    spk = np.array([0, 3], np.int32)

    def jloss(p):
        batch = jax_frame_batch(jnp.asarray(wav), jnp.asarray(spk), jcfg.mu)
        loss, (metrics, _) = jax_forward(p, jcfg, batch)
        return loss, metrics
    (jl, jm), jg = jax.value_and_grad(jloss, has_aux=True)(jparams)

    params = from_numpy_tree(flat, trainable=True)
    batch = frame_batch(torch.from_numpy(wav), torch.from_numpy(spk), cfg.mu)
    loss, (metrics, _) = forward(params, cfg, batch)
    loss.backward()
    grads = {k.replace(".", "/"): p.grad
             for k, p in params.named_parameters()}
    return (jl, jm, flatten(jax.tree_util.tree_map(np.asarray, jg)),
            loss, metrics, grads)


@pytest.mark.parametrize("switches", [STRETCH, dict(n_loop=2, n_layer=8)],
                         ids=["stretch-switches", "plain"])
def test_forward_loss_and_every_grad_match_jax(switches):
    jl, jm, jg, loss, metrics, grads = _run_both(switches)
    np.testing.assert_allclose(float(loss.detach()), float(jl), rtol=1e-5)
    for k in ("loss1", "loss2", "loss3", "codebook_usage",
              "code_perplexity"):
        np.testing.assert_allclose(float(metrics[k]), float(jm[k]),
                                   rtol=1e-5, err_msg=k)
    assert grads.keys() == jg.keys()
    for k, want in jg.items():
        got = grads[k]
        got = np.zeros_like(want) if got is None else got.numpy()
        scale = float(np.abs(want).max()) + 1e-9
        np.testing.assert_allclose(got, want, rtol=1e-3,
                                   atol=1e-4 * scale + 1e-8, err_msg=k)
    if switches.get("ema"):          # under EMA the codebook has no grad
        assert not np.abs(jg["vq/codebook"]).any()


@pytest.mark.parametrize("change,needle", [
    (dict(encoder_kernel="pallas"), "B11"),
])
def test_unported_paths_raise(change, needle):
    cfg = dataclasses.replace(get_config("tiny").model, **change)
    params = from_numpy_tree(flatten(jax.tree_util.tree_map(
        np.asarray, jax_init(jax.random.PRNGKey(0),
                             jax_config("tiny").model))))
    batch = frame_batch(torch.zeros(1, 129), torch.zeros(1, dtype=int),
                        cfg.mu)
    with pytest.raises(NotImplementedError, match=needle):
        forward(params, cfg, batch)


def test_eval_step_is_the_forward_without_an_update():
    from vqvae_tpu_torch.train.state import create_train_state
    from vqvae_tpu_torch.train.step import eval_step
    cfg = get_config("tiny")
    state = create_train_state(cfg)
    before = {k: v.clone() for k, v in state.params.state_dict().items()}
    rng = np.random.default_rng(1)
    wav = torch.from_numpy(rng.uniform(-0.9, 0.9, (2, 257)).astype(
        np.float32))
    spk = torch.tensor([0, 1])
    metrics = eval_step(state.params, wav, spk, cfg)
    loss, (want, _) = forward(state.params, cfg.model,
                              frame_batch(wav, spk, cfg.model.mu))
    assert float(metrics["loss"]) == float(loss)
    assert all(torch.equal(v, before[k])
               for k, v in state.params.state_dict().items())

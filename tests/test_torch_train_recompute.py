"""The recompute and time-windowed chunk backwards and the model with
``vctk-multi``'s switches, against the JAX package.

The port's plain versions (``kernels/wavenet_train_cuda.py`` on CPU
tensors) run beside the JAX package's Pallas chunk kernels in interpret
mode, as ``tests/test_kernels.py`` runs them: the recompute backward
(``save_gates=False``) in the three variants, the windowed backward at
the cases of ``tests/test_kernels.py``, and the whole training forward
with ``decoder_kernel="pallas"`` (recompute, windowed, remat).  The CUDA
kernels are held against these plain versions on the card
(``chip_smoke.py``, ``tests/test_torch_cuda.py``)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vqvae_tpu.audio.framing import frame_batch as jax_frame_batch
from vqvae_tpu.configs import get_config as jax_config
from vqvae_tpu.kernels import wavenet_train_pallas as jwt
from vqvae_tpu.models import forward as jax_forward
from vqvae_tpu.models import init_model as jax_init
from vqvae_tpu_torch.audio.framing import frame_batch
from vqvae_tpu_torch.configs import get_config
from vqvae_tpu_torch.convert import flatten, from_numpy_tree
from vqvae_tpu_torch.kernels import wavenet_train_cuda as wt
from vqvae_tpu_torch.models import forward

torch.set_num_threads(1)

JAX_DT = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}


def _inputs(mode, B, T, dils, R=32, S=64, d=16, mu=256, seed=0):
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
    return tuple(dils), lead, x, tail, cots


def _jax(mode, windows, dils, lead, x, tail, cots, cdt):
    """JAX outputs and VJPs of the recompute chunk (save_gates=False)."""
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
        return fn(dils, True, False, windows, *full)
    out, vjp = jax.vjp(f, *args[first:])
    return out, vjp(tuple(jnp.asarray(c, jd) for c in cots))


def _port(mode, windows, dils, lead, x, tail, cots, cdt):
    """The port's outputs and gradients through ``Chunk`` with the
    recompute backward (CPU: the plain versions)."""
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
    h, skips = wt.Chunk.apply(dils, mode, *lead_t, *rest, tail_t, False,
                              windows)
    grads = torch.autograd.grad((h, skips), diff + rest + [tail_t], tuple(
        torch.tensor(c).to(cdt) for c in cots))
    return (h, skips), grads


def _close(got, want, rtol, atol_scale):
    want = np.asarray(want, np.float32).reshape(-1)
    got = got.detach().float().numpy().reshape(-1)
    scale = float(np.abs(want).max()) + 1e-9
    np.testing.assert_allclose(got, want, rtol=rtol,
                               atol=atol_scale * scale + 1e-8)


# ---- B3: the recompute backward -------------------------------------------


@pytest.mark.parametrize("mode", [wt.SEED, wt.ACC, wt.EMBED])
def test_recompute_chunk_matches_jax_f32(mode):
    """Outputs at rtol 1e-5, every VJP at rtol 1e-3 / 1e-4 of its max
    (the tolerances of ``test_torch_train_chunk.py``)."""
    case = _inputs(mode, B=2, T=128, dils=(1, 2, 4))
    (jh, js), jg = _jax(mode, 0, *case, torch.float32)
    (h, s), g = _port(mode, 0, *case, torch.float32)
    np.testing.assert_allclose(h.detach().numpy(), np.asarray(jh),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(s.detach().numpy(), np.asarray(js),
                               rtol=1e-5, atol=1e-6)
    assert len(g) == len(jg)
    for a, b in zip(g, jg):
        _close(a, b, rtol=1e-3, atol_scale=1e-4)


def test_recompute_chunk_matches_jax_bf16_acc():
    """bfloat16: every output and gradient within 3e-2 of its max."""
    case = _inputs(wt.ACC, B=1, T=128, dils=(1, 2, 4), seed=3)
    (jh, js), jg = _jax(wt.ACC, 0, *case, torch.bfloat16)
    (h, s), g = _port(wt.ACC, 0, *case, torch.bfloat16)
    for a, b in zip((h, s) + tuple(g), (jh, js) + tuple(jg)):
        b = np.asarray(b, np.float32)
        err = np.abs(a.detach().float().numpy().reshape(b.shape) - b).max()
        assert err <= 3e-2 * np.abs(b).max(), err


def test_recompute_equals_save_gates_in_f32():
    """In float32 the rounded gate halves are the gates themselves, so
    the recompute and save-gates plain backwards give the same numbers."""
    dils, lead, x, tail, cots = _inputs(wt.SEED, B=2, T=96, dils=(1, 2, 4))
    h0 = torch.tensor(lead["h"])
    w = [torch.tensor(v) for v in x.values()]
    dh, dsk = (torch.tensor(c) for c in cots)
    gall = wt.fwd_plain(dils, h0, *w, torch.tensor(tail), False)[2]
    rec = wt.bwd_rec_plain(dils, h0, *w, dh, dsk)
    sg = wt.bwd_plain(dils, h0, *w, gall, dh, dsk)
    for a, b in zip(rec, sg):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


# ---- B12: the time-windowed backward --------------------------------------


@pytest.mark.parametrize("mode,windows,dils,B,T", [
    # the tiny config's full dilation spread: max dil 512, Tc = 512
    (wt.SEED, 2, tuple(2 ** i for i in range(10)), 1, 1024),
    # dils 1..32 over four windows: the carry crosses three boundaries
    (wt.ACC, 4, tuple(2 ** i for i in range(6)), 3, 256),
], ids=["full-spread-2", "dils32-4"])
def test_windowed_chunk_matches_jax(mode, windows, dils, B, T):
    """JAX's windowed backward and the port's: outputs at rtol 1e-5 /
    1e-6 of their max (up to ten float32 layers deep), every VJP at rtol
    1e-3 / 1e-4 of its max."""
    case = _inputs(mode, B=B, T=T, dils=dils, seed=windows)
    (jh, js), jg = _jax(mode, windows, *case, torch.float32)
    (h, s), g = _port(mode, windows, *case, torch.float32)
    _close(h, jh, rtol=1e-5, atol_scale=1e-6)
    _close(s, js, rtol=1e-5, atol_scale=1e-6)
    for a, b in zip(g, jg):
        _close(a, b, rtol=1e-3, atol_scale=1e-4)


@pytest.mark.parametrize("windows", [2, 4, 8])
def test_windowed_equals_full_recompute(windows):
    """The port's windowed backward against its full-T recompute: the
    same gradients up to summation order (atol 1e-5 of max, rtol 1e-4,
    as ``tests/test_kernels.py`` holds JAX's two)."""
    dils = tuple(2 ** i for i in range(6))
    _, lead, x, tail, cots = _inputs(wt.SEED, B=2, T=512, dils=dils,
                                     seed=11)
    h0 = torch.tensor(lead["h"])
    w = [torch.tensor(v) for v in x.values()]
    dh, dsk = (torch.tensor(c) for c in cots)
    full = wt.bwd_rec_plain(dils, h0, *w, dh, dsk)
    win = wt.bwd_win_plain(dils, windows, h0, *w, dh, dsk)
    for a, b in zip(win, full):
        _close(a, b.numpy(), rtol=1e-4, atol_scale=1e-5)


@pytest.mark.parametrize("T,windows", [(256, 3), (256, 16), (260, 2)],
                         ids=["T-not-divisible", "window-below-max-dil",
                              "window-not-multiple-of-8"])
def test_bad_window_counts_raise(T, windows):
    dils = tuple(2 ** i for i in range(6))          # max dil 32
    _, lead, x, tail, cots = _inputs(wt.SEED, B=1, T=T, dils=dils)
    t = {k: torch.tensor(v).requires_grad_() for k, v in x.items()}
    h = torch.tensor(lead["h"]).requires_grad_()
    out = wt.Chunk.apply(dils, wt.SEED, h, None, None, *t.values(),
                         torch.tensor(tail), False, windows)
    with pytest.raises(ValueError, match="bwd_windows"):
        torch.autograd.grad(out, [h], tuple(torch.tensor(c) for c in cots))


# ---- the model with vctk-multi's switches ---------------------------------

# two chained chunks of dilations 1..32 at the tiny widths
VCTK_MULTI = dict(decoder_kernel="pallas", head_kernel="xla", ema=False,
                  n_loop=2, n_layer=6)


def _forward_both(switches, T=128, seed=0, jax_too=True):
    cfg = dataclasses.replace(get_config("tiny").model, **switches)
    jcfg = dataclasses.replace(jax_config("tiny").model, **switches)
    jparams = jax_init(jax.random.PRNGKey(seed), jcfg)
    flat = flatten(jax.tree_util.tree_map(np.asarray, jparams))
    rng = np.random.default_rng(seed)
    wav = rng.uniform(-0.9, 0.9, (2, T + 1)).astype(np.float32)
    spk = np.array([3, 1], np.int32)
    params = from_numpy_tree(flat, trainable=True)
    batch = frame_batch(torch.from_numpy(wav), torch.from_numpy(spk), cfg.mu)
    loss, (metrics, _) = forward(params, cfg, batch)
    loss.backward()
    grads = {k.replace(".", "/"): p.grad
             for k, p in params.named_parameters()}
    if not jax_too:
        return loss, metrics, grads

    def jloss(p):
        b = jax_frame_batch(jnp.asarray(wav), jnp.asarray(spk), jcfg.mu)
        lj, (mj, _) = jax_forward(p, jcfg, b)
        return lj, mj
    (jl, jm), jg = jax.jit(jax.value_and_grad(jloss, has_aux=True))(jparams)
    return (loss, metrics, grads, jl, jm,
            flatten(jax.tree_util.tree_map(np.asarray, jg)))


@pytest.mark.parametrize("extra", [{}, {"bwd_time_windows": 2}],
                         ids=["recompute", "windowed-2"])
def test_vctk_multi_switches_loss_and_every_grad_match_jax(extra):
    """Loss and metrics at rtol 1e-5, every gradient leaf at rtol 1e-3 /
    1e-4 of its max (``test_torch_train_model.py``'s tolerances)."""
    loss, metrics, grads, jl, jm, jg = _forward_both({**VCTK_MULTI, **extra})
    np.testing.assert_allclose(float(loss.detach()), float(jl), rtol=1e-5)
    for k in ("loss1", "loss2", "loss3", "codebook_usage",
              "code_perplexity"):
        np.testing.assert_allclose(float(metrics[k]), float(jm[k]),
                                   rtol=1e-5, err_msg=k)
    assert grads.keys() == jg.keys()
    assert np.abs(jg["vq/codebook"]).any()      # a gradient codebook
    for k, want in jg.items():
        got = grads[k]
        got = np.zeros_like(want) if got is None else got.numpy()
        scale = float(np.abs(want).max()) + 1e-9
        np.testing.assert_allclose(got, want, rtol=1e-3,
                                   atol=1e-4 * scale + 1e-8, err_msg=k)


@pytest.mark.parametrize("decoder_kernel,windows", [
    ("pallas", 0), ("pallas", 2), ("pallas_sg", 0), ("xla", 0)])
def test_remat_changes_no_value(decoder_kernel, windows):
    """``remat`` recomputes in the backward without changing values:
    loss at rtol 1e-6, gradients at rtol 1e-4 / atol 1e-6, as
    ``tests/test_kernels.py::test_train_stack_pallas_remat`` requires."""
    sw = dict(VCTK_MULTI, decoder_kernel=decoder_kernel,
              bwd_time_windows=windows)
    lp, _, gp = _forward_both(sw, jax_too=False)
    lr, _, gr = _forward_both(dict(sw, remat=True), jax_too=False)
    np.testing.assert_allclose(float(lr.detach()), float(lp.detach()),
                               rtol=1e-6)
    for k, a in gp.items():
        b = gr[k]
        if a is None:
            assert b is None, k
            continue
        np.testing.assert_allclose(b.numpy(), a.numpy(), rtol=1e-4,
                                   atol=1e-6, err_msg=k)
